"""Run the port's SLAM engine on a TUM RGBD sequence (port of
`apps/run_tum.py`, the same flags and one more, `--device`).

The CLI counterpart of the reference's ROS apps (`ros_test/app/
ros_rgbd.cpp` / `ros_rgbd_imu.cpp` and message_flow): reads a TUM dataset
directory (rgb.txt / depth.txt, associated by nearest timestamp), offline
YOLO detection files (`<ts>.txt` rows `class x y w h score`) and a
groundtruth.txt for the world alignment (ConstraintType 1) and the final
ATE, tracks every frame, and writes TUM / KITTI trajectories
(`System::SaveTrajectoryTUM/KITTI` formats). Frames are decoded by the
native prefetcher (`io/native_loader.py`), built at first use; a frame
that fails to decode stops the run.

Usage:
  python -m eao_fusion_tpu_torch.apps.run_tum DATASET_DIR [--boxes DIR]
      [--gt FILE] [--out traj.txt] [--mono | --stereo] [--no-planes]
      [--no-objects] [--no-loop] [--checkpoint out.npz] [--resume in.npz]
      [--localization-only] [--imu accelerometer.txt] [--chunk N]
      [--online] [--max-frames N] [--mode Full|NA|IoU|NP]
      [--device cuda|cpu] [--spans trace.json]

`--spans FILE` records the port's host spans and host syncs over the run
(`utils/profiling.py`) and writes them at its end as a Chrome trace
(chrome://tracing, Perfetto: unix-µs timestamps, one track a thread),
then prints each span's totals.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import List, Optional

import numpy as np
import torch


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dataset")
    ap.add_argument("--boxes", default=None,
                    help="directory of per-timestamp detection txts")
    ap.add_argument("--gt", default=None)
    ap.add_argument("--out", default="trajectory_tum.txt")
    ap.add_argument("--kitti", default=None)
    ap.add_argument("--kf-out", default=None,
                    help="also write the keyframe-only trajectory "
                         "(System::SaveKeyFrameTrajectoryTUM)")
    ap.add_argument("--log-jsonl", default=None,
                    help="write one JSON line per frame (timestamp, "
                         "inliers, keyframe decision), the lifecycle events "
                         "and a summary with the run's frame rate")
    ap.add_argument("--viz-dir", default=None,
                    help="write the map top view and the last frame's "
                         "quadric-projection overlay (needs matplotlib)")
    ap.add_argument("--mono", action="store_true")
    ap.add_argument("--stereo", action="store_true",
                    help="rectified stereo: the dataset must also have "
                         "right.txt + right/ images; depth comes from "
                         "epipolar matching, planes are unavailable")
    ap.add_argument("--no-planes", action="store_true")
    ap.add_argument("--no-objects", action="store_true")
    ap.add_argument("--no-loop", action="store_true")
    ap.add_argument("--mode", default="Full",
                    help="association ablation flag (Full/NA/IoU/NP/None)")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--localization-only", action="store_true",
                    help="track against the (resumed) map without mapping "
                         "(System::ActivateLocalizationMode)")
    ap.add_argument("--imu", default=None,
                    help="accelerometer.txt for the IMU-gravity world "
                         "alignment at init (ConstraintType 2)")
    ap.add_argument("--gravity-axis", type=int, default=3, choices=(2, 3),
                    help="world axis anti-parallel to gravity")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--depth-factor", type=float, default=5000.0)
    ap.add_argument("--chunk", type=int, default=0,
                    help="after the warm-up (3 keyframes), run the steady "
                         "chunked loop in chunks of N frames "
                         "(pipeline/steady.py); loop detection runs at "
                         "chunk boundaries. RGBD only.")
    ap.add_argument("--online", action="store_true",
                    help="run the online YOLOX detector lane instead of "
                         "offline --boxes files (weights from "
                         "$EAO_YOLOX_WEIGHTS or data/yolox_synth.npz)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu runs "
                         "the kernels' plain PyTorch versions)")
    ap.add_argument("--spans", default=None,
                    help="record the host spans and syncs and write them "
                         "to this file as a Chrome trace")
    return ap.parse_args(argv)


def _gray_png(path: str) -> np.ndarray:
    """An 8-bit grey or RGB PNG as grey float32 in [0, 1], by the native
    decoder and the prefetcher's weights."""
    from eao_fusion_tpu_torch.io import native_loader
    with open(path, "rb") as fh:
        a, c, bd = native_loader.decode_png(fh.read())
    if bd != 8:
        raise ValueError(f"{path}: expected an 8-bit image, got {bd} bits")
    a = a.astype(np.float32)
    if c == 3:
        a = 0.299 * a[..., 0] + 0.587 * a[..., 1] + 0.114 * a[..., 2]
    return a / 255.0


def main(argv=None):
    """Run the CLI; returns the System (its trajectory, map and counts)."""
    args = parse_args(argv)

    from eao_fusion_tpu_torch import resolve_device
    from eao_fusion_tpu_torch.config import tum_fr3_config
    from eao_fusion_tpu_torch.io import imu as imu_io
    from eao_fusion_tpu_torch.io import native_loader, tum
    from eao_fusion_tpu_torch.ops import lie
    from eao_fusion_tpu_torch.pipeline import steady
    from eao_fusion_tpu_torch.pipeline.system import System
    from eao_fusion_tpu_torch.utils import profiling

    device = resolve_device(None if args.device == "cuda" else args.device)
    sensor = "mono" if args.mono else ("stereo" if args.stereo else "rgbd")
    cfg = tum_fr3_config(
        sensor=sensor,
        use_planes=not args.no_planes and sensor == "rgbd",
        use_objects=not args.no_objects,
        use_loop_closing=not args.no_loop,
        semantic_online=args.online)
    cfg = cfg.replace(objects=dataclasses.replace(cfg.objects,
                                                  mode=args.mode))

    rgb_txt = os.path.join(args.dataset, "rgb.txt")
    if not os.path.exists(rgb_txt):
        sys.exit(f"error: {rgb_txt} not found — expected a TUM dataset "
                 f"directory (rgb.txt [+ depth.txt])")
    rgb_list = tum.read_image_list(rgb_txt)
    depth_list = [] if (args.mono or args.stereo) else tum.read_image_list(
        os.path.join(args.dataset, "depth.txt"))
    right_list = tum.read_image_list(
        os.path.join(args.dataset, "right.txt")) if args.stereo else []
    rgb_ts = np.array([t for t, _ in rgb_list])
    pairs = (tum.associate_timestamps(
        rgb_ts, np.array([t for t, _ in depth_list])) if depth_list
        else [(i, -1) for i in range(len(rgb_list))])
    right_of = None
    if args.stereo:
        right_of = dict(tum.associate_timestamps(
            rgb_ts, np.array([t for t, _ in right_list])))
        # left frames with no right frame within max_dt are dropped
        pairs = [(ri, di) for ri, di in pairs if ri in right_of]
    if args.max_frames:
        pairs = pairs[:args.max_frames]

    chunk = 0
    if args.chunk:
        if sensor != "rgbd":
            sys.exit("error: --chunk requires the RGBD pipeline")
        if args.localization_only:
            sys.exit("error: --chunk is a mapping mode")
        chunk = max(2, args.chunk)

    if args.gt:
        gt_ts, gt_twc = tum.read_groundtruth(args.gt)

    s = System(cfg, device=device)
    if args.spans:
        profiling.enable()
    if args.resume:
        from eao_fusion_tpu_torch.io import checkpoint
        checkpoint.load_state(args.resume, s)
    if args.localization_only:
        s.activate_localization_mode()
    n_restored = len(s.trajectory)

    def initial_pose(ts_img: float) -> Optional[np.ndarray]:
        if args.gt:
            j = int(np.argmin(np.abs(gt_ts - ts_img)))
            return lie.se3_inverse(torch.from_numpy(gt_twc[j])).numpy()
        if args.imu:
            # ConstraintType 2: a gravity-aligned world at init
            # (`src/Tracking.cc:1276-1308` consuming INIT_POSE)
            s0 = imu_io.sync_imu(tum.read_accelerometer(args.imu), ts_img)
            if s0 is not None:
                return imu_io.gravity_init_pose(
                    s0.accel, gravity_axis=args.gravity_axis)
            print("warning: no IMU sample within the staleness window of "
                  "the first frame; starting unaligned", flush=True)
        return None

    def pad_boxes(b):
        out = np.zeros((cfg.objects.max_objects_2d, 6), np.float32)
        if b is not None and len(b):
            out[:min(len(b), len(out))] = b[:len(out)]
        return out

    st = None
    kf_before = 0

    def run_chunk(frames: List) -> None:
        """The steady chunked loop over `frames` [(ts, gray, depth,
        boxes)], then the chunk-boundary protocol (System.chunk_epilogue):
        loop closing, the async-GBA merge, compaction, relocalization."""
        nonlocal st, kf_before
        if st is None:
            st = steady.init_steady_state(s)
            kf_before = int(st.m.next_kf)
        grays = torch.as_tensor(np.stack([f[1] for f in frames]),
                                device=device)
        depths = torch.as_tensor(np.stack([f[2] for f in frames]),
                                 device=device)
        bxs = torch.as_tensor(np.stack([pad_boxes(f[3]) for f in frames]),
                              device=device)
        tss = [float(f[0]) for f in frames]
        st, diag = steady.slam_chunk(st, grays, depths, bxs, tss, cfg=cfg)
        s.record_chunk(st, diag, tss)
        st = s.chunk_epilogue(st, kf_before)
        kf_before = s.next_kf_hint

    rgbs = [os.path.join(args.dataset, rgb_list[ri][1]) for ri, _ in pairs]
    deps = ([os.path.join(args.dataset, depth_list[di][1])
             for _, di in pairs] if depth_list else None)
    tss = [rgb_list[ri][0] for ri, _ in pairs]
    pending: List = []        # frames of the chunk being filled
    last_gray = None
    t0 = time.perf_counter()
    t_first = None
    with native_loader.FramePrefetcher(
            rgbs, deps, tss, width=cfg.camera.width,
            height=cfg.camera.height,
            depth_factor=args.depth_factor) as frames:
        for n, ts_img, gray, depth in frames:
            last_gray = gray
            boxes = (tum.read_yolo_boxes(os.path.join(
                args.boxes, f"{ts_img:.6f}.txt")) if args.boxes else None)
            if chunk and s.n_keyframes >= 3:
                pending.append((ts_img, gray, depth, boxes))
                if len(pending) == chunk:
                    run_chunk(pending)
                    pending = []
            else:
                right = None
                if right_of is not None:
                    right = _gray_png(os.path.join(
                        args.dataset, right_list[right_of[pairs[n][0]]][1]))
                s.process_frame(gray, depth, ts_img, boxes=boxes,
                                initial_pose=(initial_pose(ts_img)
                                              if n == 0 else None),
                                right=right)
            if n == 1:
                t_first = time.perf_counter()   # the first two frames off
            if n % 50 == 0:
                d = s.diags[-1] if s.diags else {}
                print(f"frame {n}/{len(pairs)} kf={s.n_keyframes} "
                      f"inl={d.get('n_inliers', '-')}", flush=True)
        if pending:
            run_chunk(pending)
    t_end = time.perf_counter()
    if args.spans:
        profiling.disable()
        rec = profiling.drain()
        with open(args.spans, "w") as fh:
            json.dump(profiling.chrome_trace(rec, pid=os.getpid()), fh)
        print(f"wrote {args.spans} ({len(rec['spans'])} spans)\n"
              + profiling.report(rec), flush=True)
    n_run = len(s.trajectory) - n_restored
    timing = {"frames": n_run, "seconds": t_end - t0,
              "fps_after_first": ((n_run - 2) / (t_end - t_first)
                                  if t_first is not None and n_run > 2
                                  else None)}
    print(f"tracked {n_run} frames in {timing['seconds']:.2f} s"
          + (f" ({timing['fps_after_first']:.2f} fps after the first two)"
             if timing["fps_after_first"] else ""), flush=True)

    tum.write_trajectory_tum(args.out, s.timestamps, s.trajectory_tcw())
    print(f"wrote {args.out} ({len(s.trajectory)} poses, "
          f"{s.n_keyframes} keyframes, loops={s.n_loops_closed}, "
          f"relocs={s.n_relocalizations})")
    if (s.n_kf_evictions or s.n_kf_compactions or s.n_pt_compactions
            or s.n_gba_merges):
        print(f"map lifecycle: evicted_kfs={s.n_kf_evictions} "
              f"kf_compactions={s.n_kf_compactions} "
              f"pt_compactions={s.n_pt_compactions} "
              f"gba_merges={s.n_gba_merges}")
    if args.kitti:
        tum.write_trajectory_kitti(args.kitti, s.trajectory_tcw())
    if args.kf_out:
        kf_ts, kf_tcw = s.keyframe_trajectory()
        tum.write_trajectory_tum(args.kf_out, kf_ts, kf_tcw)
        print(f"wrote {args.kf_out} ({len(kf_ts)} keyframes)")
    if args.log_jsonl:
        off = len(s.timestamps) - len(s.diags)   # init frames have no diag
        with open(args.log_jsonl, "w") as fh:
            for i, d in enumerate(s.diags):
                fh.write(json.dumps(
                    {"frame": i + off,
                     "t": round(s.timestamps[i + off], 6), **d}) + "\n")
            for ev in s.events:     # eviction / compaction records
                fh.write(json.dumps(ev) + "\n")
            fh.write(json.dumps(
                {"event": "summary", "loops": s.n_loops_closed,
                 "relocs": s.n_relocalizations,
                 "evicted_kfs": s.n_kf_evictions,
                 "kf_compactions": s.n_kf_compactions,
                 "pt_compactions": s.n_pt_compactions,
                 "gba_merges": s.n_gba_merges, "device": str(device),
                 **timing}) + "\n")
        print(f"wrote {args.log_jsonl} ({len(s.diags)} frame records)")
    if args.viz_dir:
        from eao_fusion_tpu_torch.utils import viz
        gt_for_viz = (lie.se3_inverse(torch.from_numpy(gt_twc)).numpy()
                      if args.gt else None)
        viz.draw_map_topview(os.path.join(args.viz_dir, "map_topview.png"),
                             s, gt_for_viz)
        if not (args.mono or args.stereo):
            viz.draw_quadric_overlay(
                os.path.join(args.viz_dir, "quadric_overlay.png"),
                last_gray, s, title=f"frame {len(s.trajectory) - 1}")
        print(f"viz -> {args.viz_dir}", flush=True)
    if args.checkpoint:
        from eao_fusion_tpu_torch.io import checkpoint
        checkpoint.save_state(args.checkpoint, s)
        print(f"checkpoint -> {args.checkpoint}")

    if args.gt:
        # the frames this run tracked (a resumed map's restored frames are
        # left out: they may repeat this run's timestamps)
        est = s.trajectory_tcw()[n_restored:]
        prs = tum.associate_timestamps(np.array(s.timestamps[n_restored:]),
                                       gt_ts)
        if len(prs) > 3:
            ei = [a for a, _ in prs]
            gi = [b for _, b in prs]
            gt_tcw = lie.se3_inverse(torch.from_numpy(gt_twc[gi])).numpy()
            err = tum.evaluate_ate_rpe(est[ei], gt_tcw, align=True,
                                       with_scale=args.mono)
            print(f"ATE RMSE {err.ate_rmse*100:.2f} cm  "
                  f"median {err.ate_median*100:.2f} cm  "
                  f"RPE {err.rpe_trans_rmse*100:.2f} cm")
    return s


if __name__ == "__main__":
    main()
