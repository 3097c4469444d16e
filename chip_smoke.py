#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (`eao_fusion_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. the device: name, count, `nvidia-smi` name and power limit;
  2. build every CUDA kernel of the main path from `eao_fusion_tpu_torch/csrc`
     (one `nvcc` per source, all started together);
  3. the pose kernel (K1) against its plain PyTorch version, M = 1024,
     with no planes, two planes, and the eight plane slots (three
     unmatched) that the main path's second solve of a frame gets; timed
     at Q = 0 and Q = 8, and held to one device kernel per call;
  4. the BA edge kernels against their plain versions at E = 8192, C = 32,
     Pw = 2048, with the edges in random and in camera order, through the
     binding local BA makes once per call: K2 (the full pass with its
     [C, 42] / [Pw, 12] segment sums, and Y; the same bits over 10 calls),
     K3's chi2 sum (also the same bits over 10 calls) and K3's per-edge
     chi2; each held to one device kernel per call and no memset;
  5. the Cholesky kernel (K4) against its plain version and a float64
     solve at D = 192: local BA's reduced camera system of one LM
     iteration on phase 4's window, and a random SPD matrix; at D = 72 (the
     compaction phase's window); at the ragged and edge sizes D = 1, 5,
     31, 33, 190 and 256; and on an indefinite matrix, whose clamped pivot
     gives a huge finite step; its time at D = 192 and 72 beside
     `torch.linalg.solve`, the call it replaces;
  6. RGBD tracking with keyframe-rate local BA at full width
     (`tum_fr3_config` with planes, objects and loop closing off: 640x480,
     1024 keypoint slots, 256 keyframes, 16384 points) on the port's own
     20-frame synthetic arc;
  7. the slice's main path, the default RGBD configuration with planes on
     (objects and loop closing off), on the same arc: plane segmentation
     every frame, plane factors in K1 and in local BA, K4 solving local
     BA's reduced camera system; run twice, which must give the same
     launch counts and the same ATE bits;
  8. keyframe compaction: the 24-frame arc into a 12-slot keyframe table,
     its corrected ATE held to the JAX System's on the same cell
     (`dev/compaction_jax_ate.json`) plus 0.5 cm;
  9. objects, the new main path: the JAX package's default RGBD
     configuration with planes and objects on (`tum_fr3_config(
     use_loop_closing=False)`) on the 20-frame arc, the renderer's boxes
     passed as offline boxes; the object lane's ms per stage;
 10. the detector: the port's YOLOX lane with the shipped
     `data/yolox_synth.npz` on six frames of the class-textured 24-frame
     arc, on the card against the same module on the CPU, its recall, and
     the forward and decode + NMS ms beside the forward's bound;
 11. online: the objects configuration with `semantic_online=True` on the
     first 20 frames of the class-textured arc and no boxes;
 12. loop closing: `tum_fr3_config(use_objects=False)` (planes and loop
     closing on, the global BA on its side thread) with th_depth 70 on the
     144-frame seed-11 `spin15` sequence (1.5 turns, aperiodic texture);
     a loop must close and its GBA merge, the corrected trajectory must not
     be worse than the raw one by more than 0.5 cm (the bounds of
     tests/test_loop_e2e.py); ms of detection, Sim3, correction (fusion,
     essential graph), each GBA stage and the whole GBA, and the median
     tracking frame with a GBA in flight and without;
 13. relocalization: the 20-frame arc with the automatic reset off; 12
     frames, 3 noise frames without depth, then frame 8 again (the bounds
     of tests/test_reloc_e2e.py); a far revisit on the spin sequence that
     only BoW relocalization can recover; then localization-only mode
     over the rest of the arc, which must leave every map tensor
     bit-identical and insert no keyframe;
 14. the steady chunked loop, `tum_fr3_config()` (planes, objects with
     offline boxes, loop closing): `process_frame` on 8 frames of the arc,
     then `slam_chunk` over the other 12 in chunks of 6, each followed by
     `chunk_epilogue` (the bounds of tests/test_steady.py and
     tests/test_chunk_epilogue.py); the sustained rate of the chunked
     part, the epilogue's ms, the keyframe-trigger histogram;
 14b. loop closing in chunks: the spin15 sequence through `slam_chunk` and
     `chunk_epilogue` in chunks of 8: a loop closed at a boundary that
     harvested the detection dispatched at the one before, corrected ATE
     < 10 cm (tests/test_async_detect.py);
 15. monocular input, `tum_fr3_config(sensor="mono", use_planes=False)`,
     on the arc: two-view init, >= 3 keyframes, > 250 points,
     scale-aligned ATE < 4 cm (tests/test_mono_e2e.py); the run's first K1
     launch and first local-BA edge pass, only mono edges, against their
     plain versions;
 16. stereo input with the port's own right renders: frame 0's stereo
     depths (tests/test_stereo.py:27-45) and stereo tracking over the arc
     (ATE < 5 cm, >= 2 keyframes);
 17. I/O and the CLI: the port's dataset writer puts the 20-frame arc on
     disk (PNGs of its own encoder, box files, ground truth, the
     accelerometer); the native frame loader is built and decodes an RGB
     and a depth PNG to exactly the arrays written; then the port's CLI
     (`eao_fusion_tpu_torch.apps.run_tum.main`) runs three times
     in-process on the card with `tum_fr3_config()`: (a) with every
     output and a checkpoint (ATE < 1.5 cm, every file parses back),
     (b) resumed from that checkpoint in localization-only mode over the
     same frames (no keyframe, every map tensor bit-identical to the
     checkpoint, ATE < 3 cm), (c) gravity-aligned from the
     accelerometer file and in chunks of 6 (the first pose's world z
     along the measured acceleration within 1e-5, > 30 inliers a frame,
     >= 2 keyframes in the chunks, aligned ATE < 5 cm); each run's fps
     beside the objects cell's;
 18. detector training: width 0.25, batch 8, on two class-textured
     scenes (phase 10's 24-frame arc and 8 frames of the second training
     scene): three steps on the card and on the CPU from the same
     parameters and draws (loss within 1e-4 relative, parameters within
     0.05 of the steps' summed learning rate), 200 steps on the card
     (the mean loss of the last 20 at most half that of the first 20;
     the median ms per step after step 20 and the peak memory), and
     `evaluate` with the shipped weights on phase 10's six frames, the
     same recall and class accuracy on the card as on the CPU;
 20. the distributed GBA: phase 12's problem at its first closure (256
     keyframe slots x 1024 keypoint slots, 16384 points, free planes)
     under the production two-phase schedule, (a) on two gloo ranks that
     share the card against the single-card `ba.bundle_adjust` (camera
     RMSE < 2e-3, median point difference < 5e-3 m, plane normals within
     1e-3), (b) on a one-rank NCCL group against (a) within 1e-5; ms per
     LM iteration of the three, the all-reduce's ms and bytes;
 21. the loop cell with `gba_mesh_devices=2`: two processes on the card,
     rank 0 the System over phase 12's frames (handed over in an npz),
     rank 1 `serve_gba`; phase 12's bounds and launch counts, every GBA
     stage served, the GBA's ms beside phase 12's;
 22. data-parallel evaluation: `evaluate_sequences` over three short
     sequences (tests/test_parallel_eval.py's) in threads on the card
     against a serial run (the same keyframes, ATE within 1e-6, < 2 cm);
 23. the vocabulary trainer: one style x two seeds x 8 frames, 1024 words,
     15 iterations; the card's words equal the CPU's on the same
     descriptors, the idf within 1e-6; then its command line;
 24. the map-sharded steady step (`parallel/sharded_step.py`): the
     steady cell's `tum_fr3_config()` at full width; a System warmed with
     `process_frame` on 8 frames of the arc hands its state over in an
     npz (`io/checkpoint` and the generator's state), then the other 12
     frames run (a) through the unsharded `steady.slam_step`, (b) through
     `make_sharded_slam_step` on 2 gloo ranks sharing the card (mesh
     2 x 1), (c) on 4 gloo ranks (2 x 2), (d) on a 1-rank NCCL group
     (1 x 1); (b)-(d) give (a)'s bits in every frame's pose, keyframe
     decision and inliers and in the gathered final map and object
     table, the replicated state is checked across the ranks after every
     frame, every rank launches (a)'s counts and holds P / n_lm point
     rows, K / n_kf keyframe rows and the [K / n_kf, P / n_lm] block of
     obs_ind; the ms per frame (tracked and keyframe medians), the
     collectives' calls, bytes and ms, each rank's resident and peak
     bytes;
 25-29. the JAX package's long-run and sensor-robustness contracts, each
     with its JAX test's configuration, input and bounds
     (tests/torch_contracts.py). Their noiseless inputs are rendered first,
     in one pool of 8 spawned processes (`synthetic.render_sequences`, kept
     under build/synth_cache; three tour frames held to a serial render):
 25. lifecycle, loop closing on: (a) endurance, frames 0-505 of the
     625-frame seed-0 tour into 24 keyframe and 3072 point slots, 512
     keypoint slots (tests/test_endurance.py: <= 10 weak frames, no reset,
     live points <= 3072, 0 < live keyframes <= 24, corrected ATE < 5 cm,
     the second half's < 3x the first's); (b) exploration, the 240-frame
     seed-5 corridor at 320x240 (tests/test_kf_lifecycle.py:185-215:
     lifetime keyframes > 24, next_kf <= 24, no reset, <= 10 weak frames,
     corrected ATE < 10 cm); the occupancy every 50 frames, the loop
     closer's bow rows after the run's remaps, the median tracking and
     keyframe frame ms, the peak memory after frame 100 and at the end;
 26. point compaction inside `process_frame`, objects on with boxes, 64
     keyframe and 1024 point slots, on the 20-frame arc
     (tests/test_compaction.py:15-37: a compaction, ATE < 3 cm, > 60
     inliers on the last frame); `cull_keyframes` on the card against the
     CPU on the redundant map of tests/test_compaction.py:74-118;
 27. the nuisance suite (tests/test_nuisance_e2e.py): RGBD under each of
     five profiles (their ATE floors, <= 2 weak frames), mono under
     `combo` (scale-aligned ATE < 8 cm), BoW retrieval of `combo` views
     against the clean map (covisible top-1 >= 80%), the detector's recall
     under `combo` (>= max(0.4, half the clean recall));
 28. crowded-map retrieval: the 256-keyframe BoW database over 8 spin
     scenes through tests/torch_retrieval_harness.py on the card, its
     whole dict and the floors of tests/test_retrieval_stress.py;
 29. odometry (tests/test_tracking_e2e.py:15-53): the 15-frame seed-3
     forward run (ATE < 3 cm) and the 12-frame seed-5 arc with 1 cm depth
     noise (ATE < 5 cm); each of 25-29 prints its wall seconds;
 30. the JAX package's fr3-scale production run (dev/run_fr3_scale.py)
     through dev/torch_run_fr3_scale.py's `run_scale`: 2 replays of the
     whole 625-frame tour, planes, objects (the renderer's boxes) and
     loop closing on, 256 keyframe and 16384 point slots, 12
     `process_frame` frames then chunks of 8 through `slam_chunk` and
     `chunk_epilogue`: no reset, >= 1 loop and GBA merge, >= 1 keyframe
     and point compaction, > 256 lifetime keyframe insertions, the live
     tables within their slots, a loop closed at a chunk boundary after
     the first keyframe compaction (else 3 laps), raw ATE < 5 cm,
     corrected <= raw + 0.5 cm, no live keyframe over 50 cm from its
     ground truth, the bow rows after the remaps; the JAX script's record
     (the ATE printed beside the JAX record) and the port's event log,
     the determinism line (the chunk of the first GBA launch, a digest of
     the raw poses up to it), the median chunk and epilogue ms;
 31. the kidnap (tests/torch_contracts.py): the pass over the seed-5
     corridor, its frames 0-23 again, then 48 frames from `back` in the
     live map, nothing rendered anew. 31a continues phase 25b's System
     through `process_frame` (back 192) and asserts the premise (an
     eviction, the kidnap 2 m from every live keyframe, each return
     frame within 0.5 m of one, a jump of >= 1 m into the return); 31b
     runs full width (`kidnap_cfg()`, 64 keyframe and 8192 point slots)
     in chunks of 8 (back 120) and prints its premise. Each: BoW
     relocalization of the return's first frame against the map within 5
     cm and 0.05 rad; no reset, no OK frame over 5 cm or 0.05 rad from
     its truth after the pass alignment, every relocalization within
     that, nothing inserted and kf_valid, kf_pose, pt_valid and pt_xyz
     bit-identical while lost, the track back in the return with its
     last 24 frames OK (31b: > 80 inliers), the return's raw ATE < 5 cm,
     the bow rows after the return; a relocalization in the return
     (31a, 31b) and 31b's 5 cm bound are printed when missed, not
     raised: the JAX package misses them from the same state; the ms of
     a lost frame or a relocalizing epilogue, the recovery point, the
     live objects before and after the kidnap;
 19. last, one JSON line with every kernel's numbers (launches from phase
     7), the `nvidia-smi` line, and as the last line {"ok": true,
     "device": {...}}.
Phases 6-9, 11-13, 14-17, 21, 24 and 25-31 each set the launch counts to 0 just
before they drive the System or the steady step (in 14, 14b and 30: the
chunks; in 31a: the kidnap and the return; in 17: each CLI run; in 22:
the threaded runs; in 24: the 12 frames, in each rank) and read them
just after; each holds K1 to two
launches per tracked frame plus one per relocalization pose solve and K4
to K2's count. No phase falls back to the CPU or to random weights, a
failure of the GBA thread fails the run, and so does a child rank that
fails or outlives its time limit (phases 20-21 and 24 run ranks in
spawned processes grouped through a file store in a temporary
directory).

All times are measured on the card in this run (CUDA events for kernels,
the host clock around synchronized work for frames). `bound_ms` is the
larger of the bytes the function must move over 3.35 TB/s and its
operations over 67 TFLOP/s (H100 SXM float32 without tensor cores).
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_FLOP_PER_S = 67e12        # H100 SXM float32, outside the tensor cores

N_FRAMES = 20
SEED = 0

# flops of the pose kernel per observation: one GN iteration (projection,
# residual, Huber weight, 3x6 Jacobian, 21 H + 6 b sums) and one chi2 pass
POSE_FLOPS_PER_OBS_ITER = 320
POSE_FLOPS_PER_OBS_CHI2 = 40
# and per plane slot: rotate the normal, 4 residuals, a 4x6 Jacobian, 21 H
# + 6 b sums; its chi2
POSE_FLOPS_PER_PLANE_ITER = 200
POSE_FLOPS_PER_PLANE_CHI2 = 30
# flops of the edge kernels per edge (camera rotation, projection, Huber,
# 3x9 Jacobian; the full pass adds the 63 Gram entries and 9 rhs sums, and
# its segment sums one add for each of the 54 summed channels)
EDGE_FLOPS_FULL = 600
EDGE_FLOPS_SUMS = 54
EDGE_FLOPS_CHI2 = 90


def log(*a) -> None:
    print(*a, flush=True)


def _us(v) -> str:
    return "not measured" if v is None else f"{v:.2f} us"


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device time of fn() over `reps` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# a pause at each end of a profiler trace: traced back to back with the
# profiler's start and stop, 4 of 200 traces of K1 and K2 came back one
# kernel short or empty; with the pauses, none of 400
# (dev/torch_profiler_loss.py)
TRACE_MARGIN_S = 0.02


def traced(fn, reps: int):
    """Profiles `reps` calls of fn(), after one untraced call, inside the
    margins above; returns the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_MARGIN_S)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(TRACE_MARGIN_S)
    return prof


def device_events(fn, reps: int):
    """(name, device µs) of every device event (kernels and memsets) that
    `reps` calls of fn() ran, from the profiler's CUPTI trace."""
    from torch.autograd import DeviceType
    return [(e.name, e.device_time_total) for e in traced(fn, reps).events()
            if e.device_type == DeviceType.CUDA]


def device_us(fn, reps: int, kernel: str):
    """Mean device time (µs) of the CUDA kernel named `kernel` over `reps`
    calls of fn(), from the profiler's CUPTI trace; None if the trace
    shows no such kernel. Unlike `cuda_ms`, this leaves out the host time
    between launches."""
    for evt in traced(fn, reps).key_averages():
        if kernel in evt.key and evt.count:
            total = getattr(evt, "device_time_total", None)
            if total is None:
                total = getattr(evt, "cuda_time_total", None)
            if total:
                return total / evt.count
    return None


# five planes of the scene (floor, back wall, side walls, ceiling) and the
# eight plane slots of the second solve of track_frame (Q =
# max_planes_per_frame): -1 marks an unmatched slot (valid False), whose
# landmark is slot 0's, as build_plane_obs clamps the index
PLANES_W = np.array([[0, -1, 0, 1.2], [0, 0, -1, 4.5], [1, 0, 0, 2.5],
                     [-1, 0, 0, 2.5], [0, 1, 0, 1.5]], np.float32)
SLOTS8 = [0, 1, -1, 2, -1, 3, 4, -1]


def pose_problem(rng, dev, n=1024, noise=0.3, outlier_frac=0.2):
    """The problem of tests/test_pose_opt.py: points in front of a perturbed
    camera, 20% gross outliers, every 3rd edge mono, every 17th invalid;
    plane factors measured under the true pose, as {name: PlaneObs}: the
    two planes of that test, and eight slots as the main path's second
    solve gets them, three of them unmatched. The unmatched slots hold
    wrong measurements inside the plane chi2 gate, so that a solve that
    used them would move."""
    import torch
    from eao_fusion_tpu_torch.ops import lie
    from eao_fusion_tpu_torch.solvers import pose_opt

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    fx, fy, cx, cy, bf = CAM
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                    rng.uniform(2, 6, n)], axis=1).astype(np.float32)
    tau = np.concatenate([rng.uniform(-0.1, 0.1, 3),
                          rng.uniform(-0.3, 0.3, 3)]).astype(np.float32)
    pose_gt = lie.se3_exp(t(tau))
    xc = lie.se3_apply(pose_gt, t(pts)).cpu().numpy()
    uv = np.stack([fx * xc[:, 0] / xc[:, 2] + cx,
                   fy * xc[:, 1] / xc[:, 2] + cy], axis=1)
    ur = uv[:, 0] - bf / xc[:, 2] + rng.normal(0, noise, n)
    uv += rng.normal(0, noise, uv.shape)
    sel = rng.choice(n, int(outlier_frac * n), replace=False)
    uv[sel] += rng.uniform(20, 80, (len(sel), 2)) * rng.choice([-1, 1],
                                                               (len(sel), 2))
    ur[::3] = -1.0
    valid = np.ones(n, bool)
    valid[::17] = False
    obs = pose_opt.PoseObs(pts_w=t(pts), uv=t(uv), uright=t(ur),
                           inv_sigma2=t(np.ones(n)),
                           valid=torch.as_tensor(valid, device=dev))
    R = lie.quat_to_rotmat(pose_gt[:4]).cpu().numpy()
    tr = pose_gt[4:7].cpu().numpy()
    n_c = PLANES_W[:, :3] @ R.T
    d_c = PLANES_W[:, 3] - n_c @ tr
    meas = np.concatenate([n_c, d_c[:, None]], 1).astype(np.float32)
    # unmatched slots: the back wall 15 cm off, the floor 15 cm off, a side
    # wall's normal tilted by 0.25 rad
    tilt = np.r_[meas[2, :3] + [0, 0.25, 0], meas[2, 3]]
    wrong = np.stack([meas[1] + [0, 0, 0, 0.15], meas[0] + [0, 0, 0, 0.15],
                      tilt / np.r_[np.linalg.norm(tilt[:3]).repeat(3), 1]])
    pobs = {}
    for name, slots in (("2 planes", [0, 1]),
                        ("8 slots, 3 unmatched", SLOTS8)):
        idx = np.maximum(slots, 0)
        bad = np.asarray(slots) < 0
        meas_c = meas[idx]
        meas_c[bad] = wrong[:int(bad.sum())]
        pobs[name] = pose_opt.PlaneObs(
            plane_w=t(PLANES_W[idx]), meas_c=t(meas_c),
            valid=torch.as_tensor(~bad, device=dev))
    pose0 = lie.se3_retract(pose_gt, t([0.02, -0.01, 0.02, 0.06, -0.04, 0.05]))
    return pose0, obs, pobs


def pose_err(a, b) -> float:
    import torch
    from eao_fusion_tpu_torch.ops import lie
    d = lie.se3_compose(lie.se3_inverse(a.cpu()), b.cpu())
    return float(torch.linalg.norm(lie.se3_log(d)))


def phase_pose(dev, cfg):
    """K1 against optimize_pose_plain with no planes, two planes and the
    main path's eight plane slots; timed at both shapes the main path
    launches it with (Q = 0 for the first solve of a frame, Q = 8 for the
    second). Returns the kernel's numbers: per shape, and as the mean over
    the main path's launches, half of them at each shape."""
    from eao_fusion_tpu_torch.solvers import pose_opt
    rng = np.random.default_rng(7)
    pose0, obs, pobs = pose_problem(rng, dev)
    cam5 = CAM
    max_err = 0.0
    for tag, planes in (("no planes", None), *pobs.items()):
        ref = pose_opt.optimize_pose_plain(pose0, obs, planes, cam=cam5,
                                           cfg=cfg)
        ker = pose_opt.optimize_pose_cuda(pose0, obs, planes, cam=cam5,
                                          cfg=cfg)
        err = pose_err(ref.pose, ker.pose)
        agree = float((ref.inliers == ker.inliers).float().mean())
        dn = abs(int(ref.n_inliers) - int(ker.n_inliers))
        log(f"K1 pose_opt ({tag}): pose err {err:.3g} (< 1e-3), inlier "
            f"agreement {agree:.4f} (> 0.995), n_inliers {int(ref.n_inliers)}"
            f" vs {int(ker.n_inliers)} (within 5)")
        if not (err < 1e-3 and agree > 0.995 and dn <= 5):
            raise AssertionError(f"K1 disagrees with its plain version "
                                 f"({tag})")
        if planes is not None and not bool(planes.valid.all()):
            # the unmatched slots must change nothing: the kernel with them
            # left out gives the same pose
            keep = planes.valid
            only = pose_opt.PlaneObs(*[x[keep] for x in planes])
            ker5 = pose_opt.optimize_pose_cuda(pose0, obs, only, cam=cam5,
                                               cfg=cfg)
            e5 = pose_err(ker5.pose, ker.pose)
            log(f"K1 pose_opt ({tag}): the unmatched slots left out, pose "
                f"err {e5:.3g} (< 1e-4)")
            if not e5 < 1e-4:
                raise AssertionError("K1 uses unmatched plane slots")
        max_err = max(max_err, float((ref.pose - ker.pose).abs().max()))
    M = obs.valid.shape[0]
    shapes = {}
    for Q, planes in ((0, None), (8, pobs["8 slots, 3 unmatched"])):
        stats = {}
        pose_opt.optimize_pose_plain(pose0, obs, planes, cam=cam5, cfg=cfg,
                                     stats=stats)
        ms = cuda_ms(lambda: pose_opt.optimize_pose_cuda(
            pose0, obs, planes, cam=cam5, cfg=cfg), 50)
        plain_ms = cuda_ms(lambda: pose_opt.optimize_pose_plain(
            pose0, obs, planes, cam=cam5, cfg=cfg), 5, warmup=1)
        dev_us = device_us(lambda: pose_opt.optimize_pose_cuda(
            pose0, obs, planes, cam=cam5, cfg=cfg), 20, "pose_opt_kernel")
        n1, m1, _, _ = _stage_device(lambda: pose_opt.optimize_pose_cuda(
            pose0, obs, planes, cam=cam5, cfg=cfg), "pose_opt_kernel", 10)
        log(f"K1 (Q = {Q}): {n1:g} device kernel(s) and {m1:g} memset(s) "
            f"per call (1 and 0)")
        if n1 != 1 or m1 != 0:
            raise AssertionError("K1 is not one device kernel per call")
        # in: the pose; per observation pts_w, uv, uright, inv_sigma2 (7
        # floats) and valid (1 byte); per plane slot plane_w, meas_c (8
        # floats) and valid; out: the pose, the inlier bytes, n_inliers and
        # the chi2
        nbytes = 7 * 4 + M * 29 + Q * 33 + 7 * 4 + M + 8
        n_iter = stats["gn_iters"]
        flops = (M * (POSE_FLOPS_PER_OBS_ITER * n_iter
                      + POSE_FLOPS_PER_OBS_CHI2 * (cfg.pose_rounds + 1))
                 + Q * (POSE_FLOPS_PER_PLANE_ITER * n_iter
                        + POSE_FLOPS_PER_PLANE_CHI2 * (cfg.pose_rounds + 1)))
        b_ms, b_by = bound(nbytes, flops)
        log(f"K1 timing (M = {M}, Q = {Q}): kernel {ms:.4f} ms per call, "
            f"device time {_us(dev_us)}, plain {plain_ms:.3f} ms, bound "
            f"{b_ms:.6f} ms ({b_by}; {n_iter} GN iterations)")
        shapes[f"Q={Q}"] = dict(ms=ms, device_us=dev_us, plain_ms=plain_ms,
                                bound_ms=b_ms, bound_by=b_by)
    a, b = shapes.values()
    return dict(max_abs_err=max_err, ms=(a["ms"] + b["ms"]) / 2,
                plain_ms=(a["plain_ms"] + b["plain_ms"]) / 2,
                bound_ms=(a["bound_ms"] + b["bound_ms"]) / 2,
                bound_by=b["bound_by"], per_shape=shapes)


def edge_problem(rng, dev, C=32, Pw=2048, E=8192):
    """A local-BA window: C cameras on an arc, Pw points in front, E edges
    (the last 5% empty padding), a third mono, a quarter of the cameras
    fixed."""
    import torch
    from eao_fusion_tpu_torch.ops import lie
    from eao_fusion_tpu_torch.solvers import ba_edge

    def t(a, dt=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

    s = np.linspace(0, 1, C)
    tau = np.stack([0.02 * s, -0.25 * s, 0 * s, 0.4 * s, 0.02 * s, 0.1 * s], 1)
    cams = lie.se3_exp(t(tau.astype(np.float32)))
    pts = np.stack([rng.uniform(-2, 2, Pw), rng.uniform(-1.5, 1.5, Pw),
                    rng.uniform(3, 7, Pw)], 1).astype(np.float32)
    obs_cam = rng.integers(0, C, E).astype(np.int32)
    obs_pt = rng.integers(0, Pw, E).astype(np.int32)
    n_pad = E // 20
    obs_pt[-n_pad:] = -1
    xc = lie.se3_apply(cams[t(obs_cam, torch.long)],
                       t(pts)[t(np.clip(obs_pt, 0, None), torch.long)])
    xc = xc.cpu().numpy()
    fx, fy, cx, cy, bf = CAM
    uv = np.stack([fx * xc[:, 0] / xc[:, 2] + cx,
                   fy * xc[:, 1] / xc[:, 2] + cy], 1) + rng.normal(0, 1.0,
                                                                  (E, 2))
    ur = uv[:, 0] - bf / xc[:, 2] + rng.normal(0, 1.0, E)
    ur[::3] = -1.0
    uv[::50] += 40.0                                 # a few gross outliers
    lvl = rng.integers(0, 8, E)
    free = np.ones(C, np.float32)
    free[-(C // 4):] = 0.0
    x = ba_edge.EdgeInputs(
        cam_pose=cams.contiguous(), pt_xyz=t(pts), obs_cam=t(obs_cam,
                                                             torch.int32),
        obs_pt=t(np.clip(obs_pt, 0, None), torch.int32),
        obs_uv=t(uv.astype(np.float32)), obs_ur=t(ur.astype(np.float32)),
        obs_inv_sigma2=t((1.2 ** (-2.0 * lvl)).astype(np.float32)),
        free_cam=t(free))
    active = t((obs_pt >= 0).astype(np.float32))
    return x, active


def edge_orders(x, active):
    """The phase-4 window in two edge orders: random camera order, as
    `edge_problem` draws it, and camera order (a stable sort by camera),
    as local mapping hands the edges to local BA."""
    import torch
    perm = torch.argsort(x.obs_cam.long(), stable=True)
    by_cam = x._replace(**{k: getattr(x, k)[perm].contiguous() for k in (
        "obs_cam", "obs_pt", "obs_uv", "obs_ur", "obs_inv_sigma2")})
    return {"random": (x, active),
            "camera": (by_cam, active[perm].contiguous())}


def _stage_device(fn, kernel: str, reps: int = 20):
    """Device kernels per call of fn() other than memsets, memsets per
    call, and the device µs per call of the kernel named `kernel` and of
    all the call's device work, from the profiler's CUPTI trace."""
    for _ in range(5):
        ev = device_events(fn, reps)
        kern = [n for n, _ in ev if "memset" not in n.lower()]
        if not all(kernel in n for n in kern):
            raise AssertionError(f"{kernel}: other device kernels in its "
                                 f"call: {sorted(set(kern))}")
        if len(kern) >= reps:
            break
        # fewer kernels than calls: the profiler's trace lost an event
        log(f"{kernel}: {len(kern)} kernels traced in {reps} calls; again")
    return (len(kern) / reps, (len(ev) - len(kern)) / reps,
            sum(us for n, us in ev if kernel in n) / reps,
            sum(us for _, us in ev) / reps)


def phase_edges(dev, cfg):
    """K2 (the full pass with its segment sums) and K3 (the chi2 sum and
    the per-edge chi2) against their plain versions, on the window in
    random and in camera order, through the binding local BA uses
    (`ba_edge.EdgePass`); each held to one device kernel per call (K2 may
    add its memset). Returns their numbers: camera order, the main path's,
    at the top level, both orders under "per_order"."""
    import torch
    from eao_fusion_tpu_torch.solvers import ba_edge
    x0, active0 = edge_problem(np.random.default_rng(11), dev)
    kw = dict(cam=CAM, chi2_mono=cfg.chi2_mono, chi2_stereo=cfg.chi2_stereo)
    C, Pw, E = x0.cam_pose.shape[0], x0.pt_xyz.shape[0], x0.obs_cam.shape[0]
    orders2, orders3 = {}, {}
    for order, (x, active) in edge_orders(x0, active0).items():
        tgt = torch.where(active > 0, x.obs_pt, Pw).to(torch.int32)
        edges = ba_edge.EdgePass(x, tgt, **kw)
        args = (x.cam_pose, x.pt_xyz, active)

        # K2: the sums per channel over their rows, Y per channel over E
        ref = ba_edge.edge_sums_plain(x, active, tgt, **kw)
        ker = edges.full(*args)
        err2 = 0.0
        for name, a, b, dim in zip(("acc_c", "acc_p", "Y"), ref, ker,
                                   (0, 0, 1)):
            scale = a.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
            rel = float(((a - b).abs() / scale).max())
            err2 = max(err2, float((a - b).abs().max()))
            log(f"K2 ba_edge_full ({order} order) {name}: max err / channel"
                f" max {rel:.3g} (< 1e-4)")
            if not rel < 1e-4:
                raise AssertionError(f"K2 disagrees with its plain version "
                                     f"({name}, {order} order)")

        # K2 sums in the fixed order of the bind-time layout: the same bits
        # on every call
        outs = [[t.clone() for t in edges.full(*args)] for _ in range(10)]
        same = all(torch.equal(a, b) for o in outs[1:]
                   for a, b in zip(outs[0], o))
        log(f"K2 ba_edge_full ({order} order): acc_c, acc_p and Y "
            f"bit-identical over 10 calls: {same}")
        if not same:
            raise AssertionError(f"K2 is not bit-identical over repeats "
                                 f"({order} order)")

        # K3's sum: within 1e-5 of Σ|terms| (a float32 sum of E terms in
        # another order), and the same bits on every call
        terms = ba_edge.edge_pass_chi2_plain(x, active, **kw)[0]
        sums = [edges.chi2_sum(*args).item() for _ in range(10)]
        d = abs(sums[0] - terms.sum().item())
        lim = 1e-5 * terms.abs().sum().item()
        log(f"K3 ba_edge_chi2 sum ({order} order): {sums[0]!r} against "
            f"{terms.sum().item()!r}, |diff| {d:.3g} (<= {lim:.3g}); "
            f"{len(set(sums))} distinct value(s) in 10 calls (1)")
        if not d <= lim:
            raise AssertionError(f"K3's sum disagrees ({order} order)")
        if len(set(sums)) != 1:
            raise AssertionError(f"K3's sum is not bit-identical over "
                                 f"repeats ({order} order)")

        # K3 per edge. Tolerance: a residual is the difference of two pixel
        # coordinates of size ~600, which float32 resolves to ~6e-5 px; the
        # kernel's fused multiply-adds move it by that much, so chi2 =
        # r²/σ² moves by about 2|r|·6e-5 — relative 1e-3 of max(chi2, 1)
        # covers it
        ref3 = ba_edge.edge_pass_chi2_plain(x, active, **kw)
        ker3 = edges.chi2_edges(*args)
        err3e = 0.0
        for name, a, b in zip(("robust", "raw"), ref3[:2], ker3[:2]):
            rel = float(((a - b).abs() / a.abs().clamp(min=1.0)).max())
            err3e = max(err3e, float((a - b).abs().max()))
            log(f"K3 ba_edge_chi2 per edge ({order} order) {name} chi2: max "
                f"err / max(chi2, 1) {rel:.3g} (< 1e-3)")
            if not rel < 1e-3:
                raise AssertionError(f"K3 disagrees with its plain version "
                                     f"({name}, {order} order)")
        if not bool((ref3[2] == ker3[2]).all()):
            raise AssertionError("K3 behind flags differ from the plain "
                                 "version")
        log(f"K3 ba_edge_chi2 per edge ({order} order) behind flags: "
            f"identical")

        n2, m2, us2, all2 = _stage_device(lambda: edges.full(*args),
                                          "ba_edge_full_kernel")
        n3, m3, us3, _ = _stage_device(lambda: edges.chi2_sum(*args),
                                       "ba_edge_chi2_kernel")
        n3e, _, us3e, _ = _stage_device(lambda: edges.chi2_edges(*args),
                                        "ba_edge_chi2_kernel")
        log(f"K2 ({order} order): {n2:g} device kernel(s) and {m2:g} "
            f"memset(s) per call (1 and 0); K3 sum: {n3:g} kernel(s), "
            f"{m3:g} memset(s) (1 and 0); K3 per edge: {n3e:g} kernel(s)")
        if n2 != 1 or m2 != 0 or n3 != 1 or m3 != 0 or n3e != 1:
            raise AssertionError("K2 or K3 is not one device kernel per call")

        ms2 = cuda_ms(lambda: edges.full(*args), 200)
        plain2 = cuda_ms(lambda: ba_edge.edge_sums_plain(x, active, tgt,
                                                          **kw), 20)
        ms3 = cuda_ms(lambda: edges.chi2_sum(*args), 200)
        plain3 = cuda_ms(lambda: ba_edge.chi2_sum_plain(x, active, **kw), 20)
        ms3e = cuda_ms(lambda: edges.chi2_edges(*args), 200)
        plain3e = cuda_ms(lambda: ba_edge.edge_pass_chi2_plain(x, active,
                                                                **kw), 20)
        # bytes: each input the function needs read once, each output
        # written once; K3 needs no free-camera flags and no point targets.
        # K2's bind-time layouts are a permutation of the camera ids and
        # point targets counted here, so the bound leaves them out
        cams, pts = C * 7 * 4, Pw * 3 * 4
        edge_in = 4 + 4 + 8 + 4 + 4 + 4        # cam, pt, uv, ur, 1/σ², active
        b2 = bound(cams + pts + C * 4 + E * (edge_in + 4 + 18 * 4)
                   + (C * 42 + Pw * 12) * 4,
                   E * (EDGE_FLOPS_FULL + EDGE_FLOPS_SUMS))
        b3 = bound(cams + pts + E * edge_in + 4, E * (EDGE_FLOPS_CHI2 + 1))
        b3e = bound(cams + pts + E * (edge_in + 3 * 4), E * EDGE_FLOPS_CHI2)
        log(f"K2 timing ({order} order): {ms2:.4f} ms per call, device "
            f"{_us(us2)} kernel, {_us(all2)} all device work, plain "
            f"{plain2:.3f} ms, bound {b2[0]:.6f} ms ({b2[1]})")
        log(f"K3 timing ({order} order): sum {ms3:.4f} ms per call, device "
            f"{_us(us3)}, plain {plain3:.3f} ms, bound {b3[0]:.6f} ms "
            f"({b3[1]}); per edge {ms3e:.4f} ms per call, device "
            f"{_us(us3e)}, plain {plain3e:.3f} ms, bound {b3e[0]:.6f} ms "
            f"({b3e[1]})")
        orders2[order] = dict(max_abs_err=err2, ms=ms2, device_us=us2,
                              device_us_all=all2, plain_ms=plain2,
                              bound_ms=b2[0], bound_by=b2[1])
        orders3[order] = dict(max_abs_err=max(d, err3e), ms=ms3,
                              device_us=us3, plain_ms=plain3,
                              bound_ms=b3[0], bound_by=b3[1],
                              per_edge=dict(max_abs_err=err3e, ms=ms3e,
                                            device_us=us3e, plain_ms=plain3e,
                                            bound_ms=b3e[0],
                                            bound_by=b3e[1]))
    # the rows: camera order's numbers (K3's of its sum variant), and the
    # largest error of any order and variant
    k2 = dict(orders2["camera"], per_order=orders2)
    k3 = dict(orders3["camera"], per_order=orders3)
    for k in (k2, k3):
        k["max_abs_err"] = max(o["max_abs_err"] for o in k["per_order"].values())
    return k2, k3


def schur_system(dev, C=32):
    """The reduced camera system (M [6C, 6C], rhs [6C]) of the first LM
    iteration of local BA on phase 4's window (C = 32 cameras, 8 fixed;
    C = 12 is the window of the compaction phase), taken where
    `bundle_adjust_coo` hands it to the Cholesky solve."""
    import torch
    from eao_fusion_tpu_torch.config import SolverConfig
    from eao_fusion_tpu_torch.solvers import ba, chol
    x, active = edge_problem(np.random.default_rng(11), dev, C=C)
    C, Pw = x.cam_pose.shape[0], x.pt_xyz.shape[0]
    ok = active > 0
    prob = ba.BACooProblem(
        cam_pose=x.cam_pose, cam_valid=torch.ones(C, dtype=torch.bool,
                                                  device=dev),
        cam_fixed=x.free_cam == 0, pt_xyz=x.pt_xyz,
        pt_valid=torch.ones(Pw, dtype=torch.bool, device=dev),
        obs_cam=x.obs_cam, obs_pt=torch.where(ok, x.obs_pt, -1),
        obs_uv=x.obs_uv, obs_ur=x.obs_ur, obs_inv_sigma2=x.obs_inv_sigma2,
        obs_valid=ok)
    taken = []
    solve = chol.cholesky_solve

    def take(M, rhs):
        taken.append((M.clone(), rhs.clone()))
        return solve(M, rhs)

    chol.cholesky_solve = take
    try:
        ba.bundle_adjust_coo(prob, cam=CAM, cfg=SolverConfig(), n_iters1=1,
                             n_iters2=0)
    finally:
        chol.cholesky_solve = solve
    return taken[0]


def _rel(a, ref) -> float:
    import torch
    a = a.detach().cpu().to(torch.float64)
    ref = ref.detach().cpu().to(torch.float64)
    return float(torch.linalg.norm(a - ref) / torch.linalg.norm(ref))


def _chol_check(name, Mi, bi) -> float:
    """K4 on (Mi, bi) against its plain version and a float64 solve;
    returns the largest absolute difference from the plain version."""
    import torch
    from eao_fusion_tpu_torch.solvers import chol
    D = Mi.shape[0]
    xk = chol.cholesky_solve(Mi, bi)
    xp = chol.cholesky_solve_plain(Mi, bi)
    # K4 solves the SPD system of M's lower triangle; the Schur matrix is
    # symmetric only up to the rounding of its float32 products
    M64 = torch.tril(Mi.cpu().double())
    M64 = M64 + torch.tril(M64, -1).T
    b64 = bi.cpu().double()
    x64 = torch.linalg.solve(M64, b64)
    e_plain, e64, e64p = _rel(xk, xp), _rel(xk, x64), _rel(xp, x64)
    d = torch.sqrt(torch.diagonal(M64))
    cond = float(torch.linalg.cond(M64 / d[:, None] / d[None, :]))
    asym = float((Mi - Mi.T).abs().max() / Mi.abs().max())
    e_lu = _rel(xk, torch.linalg.solve(Mi.cpu().double(), b64))
    log(f"K4 chol_solve ({name}, D = {D}, cond {cond:.3g} after "
        f"diagonal scaling): relative error {e_plain:.3g} against the "
        f"plain version, {e64:.3g} against float64 (plain: {e64p:.3g}); "
        f"both < 1e-4. M's asymmetry {asym:.3g} of its largest entry "
        f"moves the solution by {e_lu:.3g} from the float64 LU of all "
        f"of M (the solve K4 replaces)")
    if not (e_plain < 1e-4 and e64 < 1e-4):
        raise AssertionError(f"K4 disagrees ({name}, D = {D})")
    return float((xk - xp).abs().max())


def spd_problem(D, seed, cond, dev):
    """SPD [D, D] float32 with eigenvalues log-spaced over `cond`, and a
    right-hand side (as tests/test_torch_chol.py makes them)."""
    import torch
    r = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(r.normal(size=(D, D)))
    A = (Q * np.logspace(0, np.log10(cond), D)) @ Q.T
    A = (0.5 * (A + A.T)).astype(np.float32)
    b = r.normal(size=D).astype(np.float32)
    return (torch.as_tensor(A, device=dev), torch.as_tensor(b, device=dev))


def _chol_indefinite(dev):
    """The indefinite case of tests/test_torch_chol.py: the last pivot of
    an SPD matrix negated. The clamp sqrt(max(dsq, 1e-20)) makes the step
    huge but finite; K4 must agree with its plain version within rtol
    1e-3 (the step is ~1e20·b, so float32 rounding of the last pivot's
    sum moves it relatively, not absolutely)."""
    import torch
    from eao_fusion_tpu_torch.solvers import chol
    A, b = spd_problem(24, seed=3, cond=10.0, dev=dev)
    A[-1, -1] = -A[-1, -1]
    xk = chol.cholesky_solve(A, b).cpu()
    xp = chol.cholesky_solve_plain(A, b).cpu()
    rel = float(((xk - xp).abs() / xp.abs().clamp(min=1e-30)).max())
    log(f"K4 chol_solve (indefinite, D = 24): finite "
        f"{bool(torch.isfinite(xk).all())}, max |x| {float(xk.abs().max()):.3g}"
        f" (> 1e6), relative difference from the plain version {rel:.3g} "
        f"(< 1e-3)")
    if not (bool(torch.isfinite(xk).all()) and float(xk.abs().max()) > 1e6
            and rel < 1e-3):
        raise AssertionError("K4 mishandles an indefinite pivot")


def phase_chol(dev):
    """K4 against its plain version and a float64 solve at the two sizes
    the System phases give it: D = 192 (local BA's 32-keyframe window) and
    D = 72 (the 12-keyframe window of the compaction phase); then at the
    sizes that leave the kernel's last 32-wide panel ragged or that reach
    the TPU kernel's limit of 256, and on an indefinite matrix. Returns
    its numbers at D = 192, the size of the main path, with D = 72 beside
    them."""
    import torch
    from eao_fusion_tpu_torch.solvers import chol
    M, rhs = schur_system(dev)
    D = M.shape[0]
    A, b = spd_problem(D, seed=5, cond=1e3, dev=dev)
    M72, rhs72 = schur_system(dev, C=12)
    max_err = max(_chol_check("Schur system", M, rhs),
                  _chol_check("random SPD, cond 1e3", A, b))
    err72 = _chol_check("Schur system", M72, rhs72)
    # the ragged and edge sizes: the kernel's panels are 32 wide
    for Di in (1, 5, 31, 33, 190, 256):
        Ai, bi = spd_problem(Di, seed=Di, cond=1e3, dev=dev)
        _chol_check("random SPD, cond 1e3", Ai, bi)
    _chol_indefinite(dev)

    shapes = {}
    for Mi, bi in ((M, rhs), (M72, rhs72)):
        Di = Mi.shape[0]
        ms = cuda_ms(lambda: chol.cholesky_solve(Mi, bi), 200)
        dev_us = device_us(lambda: chol.cholesky_solve(Mi, bi), 50,
                           "chol_solve_kernel")
        plain_ms = cuda_ms(lambda: chol.cholesky_solve_plain(Mi, bi), 3,
                           warmup=1)
        lib_ms = cuda_ms(lambda: torch.linalg.solve(Mi, bi), 50)
        lib_us = device_us(lambda: torch.linalg.solve(Mi, bi), 20, "getrf")
        # the kernel reads M's lower triangle and b, and writes x
        nbytes = 4 * (Di * (Di + 1) // 2 + 2 * Di)
        flops = Di ** 3 / 3 + 2 * Di * Di
        b_ms, b_by = bound(nbytes, flops)
        log(f"K4 timing (D = {Di}): kernel {ms:.4f} ms per call, device "
            f"time {_us(dev_us)}, plain {plain_ms:.3f} ms, "
            f"torch.linalg.solve {lib_ms:.4f} ms per call (its getrf "
            f"{_us(lib_us)}), bound {b_ms:.6f} ms ({b_by}); like K1 it is "
            f"latency-bound: a chain of {-(-Di // 32)} dependent panels "
            f"and {2 * -(-Di // 32)} substitution tiles")
        shapes[f"D={Di}"] = dict(ms=ms, device_us=dev_us, plain_ms=plain_ms,
                                 bound_ms=b_ms, bound_by=b_by,
                                 library_ms=lib_ms, library_getrf_us=lib_us)
    main = shapes[f"D={D}"]
    shapes["D=72"]["max_abs_err"] = err72
    return dict(max_abs_err=max_err, ms=main["ms"],
                plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"], library_ms=main["library_ms"],
                per_shape=shapes)


# the object lane's stages, as the System calls them: (module, function)
LANE_STAGES = {
    "build": ("eao_fusion_tpu_torch.objects.object_map",
              "build_frame_objects"),
    "merge_frame": ("eao_fusion_tpu_torch.objects.object_map",
                    "merge_frame_objects"),
    "associate": ("eao_fusion_tpu_torch.objects.association",
                  "ensemble_associate"),
    "update": ("eao_fusion_tpu_torch.objects.update", "object_update"),
    "merge_and_overlap": ("eao_fusion_tpu_torch.objects.merge",
                          "merge_and_overlap"),
}


@contextlib.contextmanager
def lane_timers(frame_of):
    """Time every call of the object lane's stages on the host clock, with
    the card synchronized before and after: yields a list of (frame id,
    stage, ms), the frame id read from `frame_of()` at the call."""
    import importlib

    import torch
    calls, saved = [], []

    def timed(stage, fn):
        @functools.wraps(fn)
        def run(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            calls.append((frame_of(), stage, (time.perf_counter() - t) * 1e3))
            return out
        return run

    for stage, (mod, name) in LANE_STAGES.items():
        m = importlib.import_module(mod)
        saved.append((m, name, getattr(m, name)))
        setattr(m, name, timed(stage, getattr(m, name)))
    try:
        yield calls
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


def lane_summary(calls):
    """Median ms per tracked frame that ran the lane: build + merge_frame,
    associate, update; and merge_and_overlap per keyframe."""
    per = {}
    for fid, stage, ms in calls:
        key = "merge_and_overlap" if stage == "merge_and_overlap" else fid
        per.setdefault(key, {}).setdefault(stage, []).append(ms)
    mao = per.pop("merge_and_overlap", {}).get("merge_and_overlap", [])
    frames = list(per.values())

    def med(stages):
        v = [sum(sum(f.get(st, [])) for st in stages) for f in frames]
        return float(np.median(v)) if v else None

    out = {"lane_frames": len(frames),
           "build_and_merge_frame_ms": med(("build", "merge_frame")),
           "associate_ms": med(("associate",)),
           "update_ms": med(("update",)),
           "lane_total_ms": med(("build", "merge_frame", "associate",
                                 "update")),
           "merge_and_overlap_calls": len(mao),
           "merge_and_overlap_ms": float(np.median(mao)) if mao else None}
    return out


def run_system(cfg, seq, tag: str, corrected: bool = False,
               boxes: bool = False, timers: bool = False, on_system=None,
               mono: bool = False, rights=None, on_frame=None,
               frame_log: bool = True):
    """Drive `System(cfg)` on the card over `seq`, the launch counts set to
    0 just before and read just after; `on_system(s)` is called on the new
    System before its first frame, `on_frame(s, i)` after frame i (outside
    the frame's time); `frame_log` prints every frame's ms; `boxes` passes each frame's
    rendered boxes as offline boxes, `timers` times the object lane's
    stages; `mono` passes no depth, `rights` passes right images and no
    depth. Returns the System, its summary (ATE of the raw or, with
    `corrected`, the keyframe-corrected trajectory; with `mono`,
    scale-aligned from the first initialized frame on) and the counts."""
    import torch
    from eao_fusion_tpu_torch import kernels
    from eao_fusion_tpu_torch.io import tum
    from eao_fusion_tpu_torch.pipeline.system import System

    s = System(cfg)
    if s.device.type != "cuda":
        raise AssertionError(f"System runs on {s.device}, not on the card")
    if on_system is not None:
        on_system(s)
    kf_ms = []
    on_keyframe = s._on_keyframe

    def timed_on_keyframe(slot):
        t = time.perf_counter()
        on_keyframe(slot)
        torch.cuda.synchronize()
        kf_ms.append((time.perf_counter() - t) * 1e3)

    s._on_keyframe = timed_on_keyframe
    torch.cuda.reset_peak_memory_stats()
    frame_ms, is_kf = [], []
    timing = (lane_timers(lambda: s.frame_id) if timers
              else contextlib.nullcontext([]))
    lc = s.loop_closer
    gba = []                       # a GBA was in flight when the frame began
    with timing as calls:
        torch.cuda.synchronize()
        kernels.reset_launches()
        for i, f in enumerate(seq.frames):
            n_kf = s.n_keyframes
            gba.append(lc is not None and lc.gba_inflight())
            t = time.perf_counter()
            s.process_frame(f.gray, None if mono or rights is not None
                            else f.depth, f.timestamp,
                            boxes=f.boxes if boxes else None,
                            right=None if rights is None else rights[i])
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t) * 1e3)
            is_kf.append(s.n_keyframes > n_kf)
            if on_frame is not None:
                on_frame(s, i)
        counts = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated()

    n = len(seq.frames)
    i0 = 0
    if mono:
        i0 = next((i for i, p in enumerate(s.trajectory)
                   if not np.allclose(p, [1, 0, 0, 0, 0, 0, 0])), n - 1)
    err = tum.evaluate_ate_rpe(s.trajectory_tcw(corrected=corrected)[i0:],
                               seq.gt_tcw()[i0:], with_scale=mono)
    n_ba = len(kf_ms) - 2 if len(kf_ms) >= 2 else 0   # from the 3rd KF on
    track_ms = [m for m, k in zip(frame_ms[1:], is_kf[1:]) if not k]
    kf_frame_ms = [m for m, k in zip(frame_ms[1:], is_kf[1:]) if k]
    track_gba = [m for m, k, g in zip(frame_ms[1:], is_kf[1:], gba[1:])
                 if g and not k]
    summary = {
        "frames": n, "tracked_frames": len(s.diags),
        "keyframes": s.n_keyframes, "local_ba_runs": n_ba,
        "resets": s.n_resets, "ate_cm": err.ate_rmse * 100.0,
        "median_frame_ms": float(np.median(frame_ms[1:])),
        "median_tracking_frame_ms": float(np.median(track_ms))
        if track_ms else None,
        "median_keyframe_frame_ms": float(np.median(kf_frame_ms))
        if kf_frame_ms else None,
        "mean_local_mapping_ms": float(np.mean(kf_ms[2:]))
        if len(kf_ms) > 2 else None,
        "first_tracked_frame_ms": frame_ms[1],
        "fps_after_first": (n - 2) / (sum(frame_ms[2:]) / 1e3),
        "max_memory_allocated_mb": peak / 2 ** 20,
        "map_planes": int(s.map.pl_valid.sum()),
        "kf_compactions": s.n_kf_compactions,
        "kf_evictions": s.n_kf_evictions,
        "map_objects": int(s.objects.valid.sum()),
        "object_keyframes": s.n_obj_keyframes,
        "launches": counts,
    }
    if mono:
        summary["init_frame"] = i0
    if lc is not None:
        no_gba = [m for m, k, g in zip(frame_ms[1:], is_kf[1:], gba[1:])
                  if not (g or k)]
        summary.update(
            loops_closed=s.n_loops_closed, gba_merges=s.n_gba_merges,
            relocalizations=s.n_relocalizations,
            reloc_pose_solves=s.reloc_stats.get("pose_solves", 0),
            tracking_frames_gba_inflight=len(track_gba),
            median_tracking_frame_ms_gba_inflight=float(
                np.median(track_gba)) if track_gba else None,
            median_tracking_frame_ms_no_gba=float(np.median(no_gba))
            if no_gba else None)
    if timers:
        summary["object_lane"] = lane_summary(calls)
    log(f"{tag}: " + json.dumps(summary))
    if frame_log:
        log(f"{tag} per-frame ms: "
            + json.dumps([round(m, 2) for m in frame_ms]))
    return s, summary, counts


def _arc(n_frames, cfg, class_textures: bool = False):
    return _render(n_frames, cfg.camera, class_textures)


@functools.lru_cache(maxsize=None)
def _render(n_frames, camera, class_textures):
    """The seed-0 arc, rendered once per run for each length (and texture
    set) the phases ask for."""
    from eao_fusion_tpu_torch.io import synthetic
    t0 = time.perf_counter()
    seq = synthetic.generate_sequence(n_frames=n_frames, seed=SEED,
                                      style="arc", camera=camera,
                                      class_textures=class_textures)
    log(f"rendered {n_frames} frames of the seed-{SEED} arc"
        f"{' (class textures)' if class_textures else ''} in "
        f"{time.perf_counter() - t0:.1f} s (host)")
    return seq


def _check_launches(counts, tracked: int, solves: int) -> None:
    """K1 twice per tracked frame and once per relocalization pose solve,
    the BA edge kernels launched, K4 once per LM iteration (as often as
    K2)."""
    if counts["pose_opt"] != 2 * tracked + solves:
        raise AssertionError(f"pose kernel launched {counts['pose_opt']} "
                             f"times for {tracked} tracked frames and "
                             f"{solves} relocalization solves")
    if counts["ba_edge_full"] < 1 or counts["ba_edge_chi2"] < 1:
        raise AssertionError(f"BA edge kernels not launched: {counts}")
    if counts["chol_solve"] != counts["ba_edge_full"]:
        raise AssertionError(f"K4 launched {counts['chol_solve']} times for "
                             f"{counts['ba_edge_full']} LM iterations")


def _check_tracking(summary, counts, ate_cm):
    """ATE below `ate_cm`, local BA ran, no reset, and the launch counts of
    the run (`_check_launches`)."""
    if not summary["ate_cm"] < ate_cm:
        raise AssertionError(f"ATE {summary['ate_cm']:.2f} cm >= {ate_cm} cm")
    if summary["keyframes"] < 3 or summary["local_ba_runs"] < 1:
        raise AssertionError("local BA did not run")
    if summary["resets"]:
        raise AssertionError("tracking was lost and reset")
    _check_launches(counts, summary["tracked_frames"],
                    summary.get("reloc_pose_solves", 0))


def phase_main_path():
    """The port's System on the card at full width, planes off; returns
    its summary and the launch counts of the run."""
    from eao_fusion_tpu_torch.config import tum_fr3_config
    cfg = tum_fr3_config(use_planes=False, use_objects=False,
                         use_loop_closing=False)
    seq = _arc(N_FRAMES, cfg)
    _, summary, counts = run_system(cfg, seq, "main path, planes off")
    _check_tracking(summary, counts, ate_cm=2.0)
    return summary, counts


def phase_planes_path():
    """The slice's main path: the default RGBD configuration with planes
    on (`tum_fr3_config(use_objects=False, use_loop_closing=False)`) at
    full width on the 20-frame arc. Holds it to the JAX package's
    full-config bound (ATE < 1.5 cm), finds the floor (y = 1.2 m) and the
    back wall (z = 4.5 m) among the map planes, and checks that planes
    were matched on most tracked frames and that every LM iteration of
    local BA went through K4."""
    from eao_fusion_tpu_torch.config import tum_fr3_config
    cfg = tum_fr3_config(use_objects=False, use_loop_closing=False)
    if not cfg.use_planes:
        raise AssertionError("the default configuration has planes off")
    seq = _arc(N_FRAMES, cfg)
    s, summary, counts = run_system(cfg, seq, "main path, planes on")
    _check_tracking(summary, counts, ate_cm=1.5)
    if counts["chol_solve"] < 1:
        raise AssertionError("K4 was not launched")
    pl = s.map.pl_coeff[s.map.pl_valid].cpu().numpy()
    if len(pl) < 2:
        raise AssertionError(f"{len(pl)} map planes, expected >= 2")
    for name, g in (("back wall", [0, 0, 1, -4.5]),
                    ("floor", [0, 1, 0, -1.2])):
        g = np.asarray(g, np.float32)
        e = min(min(np.linalg.norm(p - g), np.linalg.norm(p + g)) for p in pl)
        log(f"map plane nearest the {name}: coefficient error {e:.4f} "
            f"(< 0.02)")
        if not e < 0.02:
            raise AssertionError(f"no map plane at the {name}")
    matched = [d["n_planes_matched"] > 0 for d in s.diags]
    log(f"planes matched on {sum(matched)} of {len(matched)} tracked frames")
    if sum(matched) < 0.8 * len(matched):
        raise AssertionError("planes matched on too few tracked frames")
    return summary, counts


def phase_compaction():
    """Keyframe compaction at full image width and 1024 keypoint slots,
    planes on: the 24-frame arc with a keyframe allowed every frame into a
    12-slot keyframe table (local-BA window 12, so K4 runs at D = 72). The
    capacity is cut from 256 only so that compaction fires within 24
    frames; the bounds are those of tests/test_kf_lifecycle.py (lifetime
    keyframes > 12, next_kf <= 12, no reset), the corrected-trajectory ATE
    within 0.5 cm of the JAX System's on the same cell
    (`dev/compaction_jax_ate.json`, made by `dev/compaction_jax_ate.py`:
    the drift of this cell is the reference's own), and the launch counts
    are held as in the other System phases."""
    import dataclasses
    import os

    import torch
    from eao_fusion_tpu_torch.config import tum_fr3_config
    from eao_fusion_tpu_torch.ops import lie
    ref_path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "dev",
                            "compaction_jax_ate.json")
    with open(ref_path) as fh:
        jax_ate_cm = json.load(fh)["corrected_ate_cm"]
    base = tum_fr3_config(use_objects=False, use_loop_closing=False)
    cfg = dataclasses.replace(
        base,
        capacity=dataclasses.replace(base.capacity, max_keyframes=12,
                                     max_local_ba_kfs=12),
        tracking=dataclasses.replace(base.tracking, max_frames_between_kf=1))
    seq = _arc(24, cfg)
    s, summary, counts = run_system(cfg, seq, "keyframe compaction",
                                    corrected=True)
    if not (s.n_keyframes > 12 and int(s.map.next_kf) <= 12
            and s.n_kf_compactions >= 1):
        raise AssertionError(f"compaction did not fire: {s.n_keyframes} "
                             f"keyframes, next_kf {int(s.map.next_kf)}")
    log(f"keyframe compaction: corrected ATE {summary['ate_cm']:.3f} cm "
        f"against the JAX System's {jax_ate_cm:.3f} cm (bound + 0.5 cm)")
    _check_tracking(summary, counts, ate_cm=jax_ate_cm + 0.5)
    log("keyframe events: " + json.dumps(s.events))
    # the first frame's true pose is the identity, so the System's world
    # is the true world: camera-centre error per frame, unaligned
    centre = [lie.se3_inverse(torch.as_tensor(t))[:, 4:7].numpy()
              for t in (s.trajectory_tcw(corrected=True), seq.gt_tcw())]
    err_cm = np.linalg.norm(centre[0] - centre[1], axis=1) * 100.0
    log("keyframe compaction per-frame position error cm: "
        + json.dumps([round(float(e), 2) for e in err_cm]))
    return summary, counts


def check_objects(s, seq):
    """The JAX package's bounds on the map objects (tests/test_objects.py:
    51-71, 89-97): 3 to 6 valid objects, each centre within 40 cm of a
    scene box's centre and seen in >= max(3, frames / 4) frames, at least 3
    scene classes matched, and every cuboid holding its centre."""
    ot = s.objects
    valid = ot.valid.cpu().numpy()
    cen = ot.center.cpu().numpy()[valid]
    cls = ot.cls.cpu().numpy()[valid]
    lo, hi = ot.cub_min.cpu().numpy()[valid], ot.cub_max.cpu().numpy()[valid]
    nfr = ot.n_frames.cpu().numpy()[valid]
    gt_c = np.stack([(b.lo + b.hi) / 2 for b in seq.scene.boxes])
    gt_cls = {b.class_id for b in seq.scene.boxes}
    err = [float(np.linalg.norm(gt_c - c, axis=1).min()) for c in cen]
    log(f"map objects: {len(cen)} (3 to 6), classes {sorted(cls.tolist())}"
        f" (scene {sorted(gt_cls)}), centre error cm "
        f"{[round(e * 100, 1) for e in err]} (< 40), frames seen "
        f"{nfr.tolist()} (>= {max(3, len(seq.frames) // 4)})")
    if not 3 <= len(cen) <= 6:
        raise AssertionError(f"{len(cen)} map objects")
    if not all(e < 0.4 for e in err):
        raise AssertionError("a map object is far from every scene box")
    if not (nfr >= max(3, len(seq.frames) // 4)).all():
        raise AssertionError("a map object was seen in too few frames")
    if len(set(cls.tolist()) & gt_cls) < 3:
        raise AssertionError("fewer than 3 scene classes matched")
    if not (np.all(lo <= cen + 1e-5) and np.all(cen <= hi + 1e-5)
            and np.all(hi - lo < 1.5)):
        raise AssertionError("a cuboid does not hold its centre")


def phase_objects():
    """The new main path: the JAX package's default RGBD configuration
    with planes and objects on, at full width on the 20-frame arc, the
    renderer's boxes passed as offline boxes. Held to ATE < 1.5 cm, local
    BA, no reset, the launch counts, and the object bounds of
    `check_objects`; the object lane is timed by stage."""
    from eao_fusion_tpu_torch.config import tum_fr3_config
    cfg = tum_fr3_config(use_loop_closing=False)
    if not (cfg.use_planes and cfg.use_objects):
        raise AssertionError("the default configuration has planes or "
                             "objects off")
    seq = _arc(N_FRAMES, cfg)
    s, summary, counts = run_system(cfg, seq, "objects (main path)",
                                    boxes=True, timers=True)
    _check_tracking(summary, counts, ate_cm=1.5)
    check_objects(s, seq)
    summary["object_lane_device"] = lane_device_profile(s, seq.frames[-1],
                                                        cfg)
    lane = summary["object_lane"]
    log(f"objects: {s.n_obj_keyframes} keyframe(s) triggered by a new "
        f"object; object lane per tracked frame (median of "
        f"{lane['lane_frames']}, host clock, synchronized): build + "
        f"merge_frame {lane['build_and_merge_frame_ms']:.2f} ms, associate "
        f"{lane['associate_ms']:.2f} ms, update {lane['update_ms']:.2f} ms,"
        f" total {lane['lane_total_ms']:.2f} ms; merge_and_overlap "
        f"{lane['merge_and_overlap_ms']:.2f} ms per keyframe "
        f"({lane['merge_and_overlap_calls']} calls)")
    return summary, counts


def device_per_call(fn, reps: int = 3):
    """(device events, device µs) per call of fn(), from the profiler's
    CUPTI trace (kernels and memsets, all streams)."""
    ev = device_events(fn, reps)
    return len(ev) / reps, sum(us for _, us in ev) / reps


def lane_device_profile(s, frame, cfg):
    """Each stage of the object lane once more on the System's final state
    and its last frame (pure functions: the System is not changed): device
    events and device µs per call from the profiler, and ms per call over
    back-to-back calls (CUDA events). Says how far the lane is from its
    device time, i.e. how much of it is launching."""
    import torch
    from eao_fusion_tpu_torch.objects import association, merge
    from eao_fusion_tpu_torch.objects import object_map as om
    from eao_fusion_tpu_torch.objects import update
    m, ts = s.map, s.track
    boxes = om.boxes_tensor(frame.boxes, s.device)
    g = torch.Generator(device=s.device)
    g.manual_seed(0)
    fo = om.build_frame_objects(boxes, ts.last_feats, ts.kp_pt, m.pt_xyz,
                                m.pt_valid, ts.pose, cfg=cfg)
    assoc = association.ensemble_associate(s.objects, fo, m.pt_xyz, ts.pose,
                                           s.frame_id, cfg=cfg)
    stages = {
        "build": lambda: om.build_frame_objects(
            boxes, ts.last_feats, ts.kp_pt, m.pt_xyz, m.pt_valid, ts.pose,
            cfg=cfg),
        "merge_frame": lambda: om.merge_frame_objects(fo, fo, m.pt_valid,
                                                      cfg=cfg),
        "associate": lambda: association.ensemble_associate(
            s.objects, fo, m.pt_xyz, ts.pose, s.frame_id, cfg=cfg),
        "update": lambda: update.object_update(
            s.objects, fo, assoc, m.pt_xyz, ts.pose, s.frame_id, g, cfg=cfg),
        "merge_and_overlap": lambda: merge.merge_and_overlap(
            s.objects, m.pt_xyz, g, cfg=cfg),
    }
    out = {}
    for name, fn in stages.items():
        n, us = device_per_call(fn)
        ms = cuda_ms(fn, 10, warmup=2)
        out[name] = dict(device_events=n, device_us=us, ms=ms)
        log(f"object lane {name}: {n:g} device events, device {us:.1f} us, "
            f"{ms:.3f} ms per call back to back")
    return out


def _box_iou(det, b):
    """IoU of detections [n, 6] against one (class, x, y, w, h) box."""
    ix0 = np.maximum(det[:, 1], b[1])
    iy0 = np.maximum(det[:, 2], b[2])
    ix1 = np.minimum(det[:, 1] + det[:, 3], b[1] + b[3])
    iy1 = np.minimum(det[:, 2] + det[:, 4], b[2] + b[4])
    inter = np.maximum(ix1 - ix0, 0) * np.maximum(iy1 - iy0, 0)
    return inter / np.maximum(det[:, 3] * det[:, 4] + b[3] * b[4] - inter,
                              1e-9)


DETECTOR_FRAMES = (0, 4, 8, 12, 16, 20)


def phase_detector():
    """The port's YOLOX lane with the shipped weights on the card: the raw
    head outputs against the same module on the CPU (within 1e-4 of their
    largest value: float32 convolutions, TF32 off, in other orders), the
    decoded detections (same kept rows and classes, boxes within 0.5 px),
    recall >= 0.6 at IoU 0.4 and class accuracy >= 0.8 on hits over six
    frames (tests/test_yolox_train.py:80-109), and the forward and decode +
    NMS times beside the forward's bound."""
    import torch
    from eao_fusion_tpu_torch.config import tum_fr3_config
    from eao_fusion_tpu_torch.frontend import yolox
    from eao_fusion_tpu_torch.pipeline.system import REPO_ROOT
    path = f"{REPO_ROOT}/data/yolox_synth.npz"
    pg = yolox.load_params(path, "cuda")
    pc = yolox.load_params(path, "cpu")
    depth_mult, n_classes = yolox.infer_arch(pg)
    seq = _arc(24, tum_fr3_config(), class_textures=True)
    det_lane = yolox.Detector(pg, depth_mult=depth_mult, n_classes=n_classes)
    n_gt = hits = cls_hits = 0
    rel_max = box_max = 0.0
    for i in DETECTOR_FRAMES:
        f = seq.frames[i]
        rgb = np.repeat(np.asarray(f.gray, np.float32)[..., None], 3, -1)
        xc, scale = yolox.letterbox(torch.from_numpy(rgb))
        rc = yolox.yolox_forward(pc, xc, depth_mult)
        rg = yolox.yolox_forward(pg, xc.cuda(), depth_mult)
        rel = float((rg.cpu() - rc).abs().max() / rc.abs().max())
        dc = yolox.decode_and_nms(rc, scale, n_classes).numpy()
        dg = yolox.decode_and_nms(rg, scale, n_classes).cpu().numpy()
        if not (rel < 1e-4 and np.array_equal(dg[:, 5] > 0, dc[:, 5] > 0)
                and np.array_equal(dg[:, 0], dc[:, 0])):
            raise AssertionError(f"detector on the card differs from the "
                                 f"CPU on frame {i} (raw rel {rel:.3g})")
        box = float(np.abs(dg[:, 1:5] - dc[:, 1:5]).max())
        if not box < 0.5:
            raise AssertionError(f"boxes differ by {box} px on frame {i}")
        rel_max, box_max = max(rel_max, rel), max(box_max, box)
        det_lane.submit(rgb)
        det = det_lane.result()
        for b in f.boxes:
            n_gt += 1
            if det is None or not len(det):
                continue
            iou = _box_iou(det, b)
            j = int(np.argmax(iou))
            if iou[j] >= 0.4:
                hits += 1
                cls_hits += int(det[j, 0]) == int(b[0])
    log(f"detector (width {pg['stem']['conv']['w'].shape[0] / 64:g}, "
        f"{n_classes} classes): raw outputs on the card against the CPU, "
        f"max |diff| / max |raw| {rel_max:.3g} (< 1e-4); decoded boxes "
        f"within {box_max:.3g} px (< 0.5), same kept rows and classes; "
        f"recall {hits}/{n_gt} (>= 0.6), class accuracy {cls_hits}/{hits} "
        f"(>= 0.8)")
    if not (hits >= 0.6 * n_gt and cls_hits >= 0.8 * hits):
        raise AssertionError("detector recall or class accuracy too low")

    # times on one frame at the main path's shapes
    f = seq.frames[DETECTOR_FRAMES[2]]
    rgb = np.repeat(np.asarray(f.gray, np.float32)[..., None], 3, -1)
    x = torch.from_numpy(rgb).cuda()
    img, scale = yolox.letterbox(x)
    raw = yolox.yolox_forward(pg, img, depth_mult)
    fwd_ms = cuda_ms(lambda: yolox.yolox_forward(pg, img, depth_mult), 20)
    nms_ms = cuda_ms(lambda: yolox.decode_and_nms(raw, scale, n_classes), 20)
    lb_ms = cuda_ms(lambda: yolox.letterbox(x), 20)

    def lane():
        det_lane.submit(rgb)
        det_lane.result()
    lane_ms = cuda_ms(lane, 10)
    flops = yolox.forward_flops(pg, depth_mult)
    n_par = sum(t.numel() for t in _leaves(pg))
    b_ms, b_by = bound(4 * (n_par + img.numel() + raw.numel()), flops)
    fwd_n, fwd_us = device_per_call(
        lambda: yolox.yolox_forward(pg, img, depth_mult))
    nms_n, nms_us = device_per_call(
        lambda: yolox.decode_and_nms(raw, scale, n_classes))
    log(f"detector timing (640x640, float32, TF32 off): forward {fwd_ms:.3f}"
        f" ms per call ({fwd_n:g} device events, device {fwd_us:.1f} us), "
        f"bound {b_ms:.4f} ms ({b_by}: {flops / 1e9:.2f} GFLOP, {n_par} "
        f"parameters); decode + NMS {nms_ms:.3f} ms ({nms_n:g} device "
        f"events, device {nms_us:.1f} us; 128 greedy steps); letterbox "
        f"{lb_ms:.3f} ms; submit + result (with the host copies) "
        f"{lane_ms:.3f} ms per frame")
    return dict(forward_ms=fwd_ms, forward_bound_ms=b_ms,
                forward_device_us=fwd_us, decode_nms_ms=nms_ms,
                decode_nms_device_us=nms_us, letterbox_ms=lb_ms,
                lane_ms=lane_ms, recall=hits / n_gt)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def phase_online(objects_summary):
    """The online lane: the objects configuration with
    `semantic_online=True` on the first 20 frames of the class-textured
    arc, no boxes passed. Held to ATE < 3 cm, at least one map object, no
    reset and the launch counts (tests/test_yolox_train.py:115-142)."""
    from eao_fusion_tpu_torch.config import tum_fr3_config
    from eao_fusion_tpu_torch.io import synthetic
    cfg = tum_fr3_config(use_loop_closing=False, semantic_online=True)
    full = _arc(24, cfg, class_textures=True)
    seq = synthetic.SyntheticSequence(frames=full.frames[:N_FRAMES],
                                      camera=full.camera, scene=full.scene)
    s, summary, counts = run_system(cfg, seq, "online detector lane")
    if s.detector is None or s.detector.device.type != "cuda":
        raise AssertionError("the online detector is not on the card")
    _check_tracking(summary, counts, ate_cm=3.0)
    if summary["map_objects"] < 1:
        raise AssertionError("online detections made no map object")
    log(f"online: {summary['map_objects']} map objects, median frame "
        f"{summary['median_frame_ms']:.1f} ms against "
        f"{objects_summary['median_frame_ms']:.1f} ms with offline boxes")
    return summary


def phase_planes_twice():
    """Phase 7 twice in this process: with K2's sums in a fixed order the
    two runs must give the same launch counts and the same ATE bits.
    Returns the counts."""
    (s1, c1), (s2, c2) = phase_planes_path(), phase_planes_path()
    log(f"main path twice: launches {json.dumps(c1)} and {json.dumps(c2)}; "
        f"ATE {s1['ate_cm']!r} and {s2['ate_cm']!r} cm")
    if c1 != c2 or s1["ate_cm"] != s2["ate_cm"]:
        raise AssertionError("two runs of the main path differ")
    return c1


LOOP_FRAMES = 144
LOOP_SEED = 11


def _loop_cfg():
    """`tum_fr3_config(use_objects=False)`: planes and loop closing on, the
    GBA on its side thread, at full width; th_depth 70 (5.2 m), since the
    synthetic room's walls lie beyond the default 3 m close-point
    threshold, which starves keyframe insertion in the fast spin
    (tests/test_loop_e2e.py:22-28)."""
    import dataclasses

    from eao_fusion_tpu_torch.config import tum_fr3_config
    base = tum_fr3_config(use_objects=False)
    if not (base.use_loop_closing and base.use_planes
            and base.loop.async_gba):
        raise AssertionError("the default configuration has loop closing, "
                             "planes or the asynchronous GBA off")
    return base.replace(camera=dataclasses.replace(base.camera,
                                                   th_depth=70.0))


@functools.lru_cache(maxsize=None)
def _spin(camera):
    from eao_fusion_tpu_torch.io import synthetic
    t0 = time.perf_counter()
    seq = synthetic.generate_sequence(n_frames=LOOP_FRAMES, seed=LOOP_SEED,
                                      style="spin15", texture="aperiodic",
                                      camera=camera)
    log(f"rendered {LOOP_FRAMES} frames of the seed-{LOOP_SEED} spin15 "
        f"sequence in {time.perf_counter() - t0:.1f} s (host)")
    return seq


def time_loop_steps(lc):
    """Time the loop closer's steps on the host clock, the step's stream
    synchronized before and after (the GBA stages on the GBA thread's
    stream), by wrapping them on this instance: returns the dict of step
    -> [ms] that the wrappers fill."""
    import torch
    out = {}

    def timed(name, fn):
        @functools.wraps(fn)
        def run(*a, **k):
            torch.cuda.current_stream().synchronize()
            t = time.perf_counter()
            r = fn(*a, **k)
            torch.cuda.current_stream().synchronize()
            out.setdefault(name, []).append((time.perf_counter() - t) * 1e3)
            return r
        return run

    for n in ("compute_sim3", "correct", "_fuse_loop_points",
              "_fuse_loop_planes", "_essential_graph", "_gba_stage"):
        setattr(lc, n, timed(n, getattr(lc, n)))
    return out


def capture_gba_problem(lc, out: dict) -> None:
    """Keep a CPU copy of the first GBA problem the loop closer builds (at
    its first closure) in out["problem"] = (prob, plane_free)."""
    build = lc._build_gba_problem

    @functools.wraps(build)
    def run(m):
        prob, pf = build(m)
        if "problem" not in out:
            out["problem"] = (type(prob)(*(t.cpu() for t in prob)),
                              None if pf is None
                              else type(pf)(*(t.cpu() for t in pf)))
        return prob, pf

    lc._build_gba_problem = run


def check_loop_run(s, seq, summary, counts, steps, tag: str) -> dict:
    """The loop cell's bounds (tests/test_loop_e2e.py: <= 4 lost frames,
    >= 1 loop closed, the corrected ATE within 0.5 cm of the raw one and
    < 10 cm on frames 3 on, plane normals finite and of unit length
    within 1e-3), a GBA merged after a blocking poll, and the launch
    counts (K1 twice per tracked frame plus the relocalization solves, K4
    as often as K2). Logs and returns the loop closer's numbers."""
    from eao_fusion_tpu_torch.io import tum
    lc = s.loop_closer
    merges_before = s.n_gba_merges
    t = time.perf_counter()
    s._poll_gba(blocking=True)
    wait_ms = (time.perf_counter() - t) * 1e3

    gt = seq.gt_tcw()
    raw = tum.evaluate_ate_rpe(s.trajectory_tcw()[3:], gt[3:]).ate_rmse
    corr = tum.evaluate_ate_rpe(s.trajectory_tcw(corrected=True)[3:],
                                gt[3:]).ate_rmse
    n_lost = sum(1 for d in s.diags[2:] if d["n_inliers"] < 20)
    pl = s.map.pl_coeff[s.map.pl_valid].cpu().numpy()
    norm_err = (float(np.abs(np.linalg.norm(pl[:, :3], axis=1) - 1).max())
                if len(pl) else 0.0)

    def ms(name):
        v = steps.get(name, [])
        return [round(x, 2) for x in v]

    st = lc.stats
    out = {
        "lost": n_lost, "keyframes": s.n_keyframes,
        "loops_closed": s.n_loops_closed,
        "gba_merges_during_run": merges_before,
        "gba_merges": s.n_gba_merges,
        "gba_aborts": st.get("n_gba_aborts", 0),
        "relocalizations": s.n_relocalizations,
        "raw_ate_cm": raw * 100, "corrected_ate_cm": corr * 100,
        "map_planes": len(pl), "plane_norm_err": norm_err,
        "detect_ms_mean": st.get("t_detect", 0.0) / max(
            st.get("n_detect", 0), 1) * 1e3,
        "detect_calls": st.get("n_detect", 0),
        "sim3_ms": ms("compute_sim3"), "correct_ms": ms("correct"),
        "fuse_points_ms": ms("_fuse_loop_points"),
        "fuse_planes_ms": ms("_fuse_loop_planes"),
        "essential_graph_ms": ms("_essential_graph"),
        "gba_stage_ms": ms("_gba_stage"),
        "gba_whole_ms_mean": st.get("t_gba", 0.0) / max(
            st.get("n_gba", 0), 1) * 1e3,
        "gba_runs": st.get("n_gba", 0),
        "blocking_poll_wait_ms": wait_ms,
        "median_tracking_frame_ms_gba_inflight":
            summary["median_tracking_frame_ms_gba_inflight"],
        "tracking_frames_gba_inflight":
            summary["tracking_frames_gba_inflight"],
        "median_tracking_frame_ms_no_gba":
            summary["median_tracking_frame_ms_no_gba"]}
    log(f"{tag}: " + json.dumps(out))
    _check_tracking(summary, counts, ate_cm=10.0)
    if n_lost > 4:
        raise AssertionError(f"{n_lost} lost frames (<= 4)")
    if s.n_loops_closed < 1:
        raise AssertionError(f"no loop closed over {s.n_keyframes} "
                             f"keyframes")
    if s.n_gba_merges < 1:
        raise AssertionError("no GBA was merged")
    if not (corr <= raw + 0.005 and corr < 0.10):
        raise AssertionError(f"corrected ATE {corr * 100:.2f} cm against "
                             f"raw {raw * 100:.2f} cm")
    if not (np.isfinite(pl).all() and norm_err < 1e-3):
        raise AssertionError("a map plane is not finite or not unit")
    if lc.gba_inflight():
        raise AssertionError("a GBA is still in flight")
    return out


def phase_loop():
    """Loop closing at full width on the 144-frame spin (`check_loop_run`'s
    bounds). Returns the loop closer's numbers and the GBA problem built
    at the first closure (phase 20's input)."""
    cfg = _loop_cfg()
    seq = _spin(cfg.camera)
    hooks = {}

    def on_system(s):
        hooks["timed"] = time_loop_steps(s.loop_closer)
        capture_gba_problem(s.loop_closer, hooks)

    s, summary, counts = run_system(cfg, seq, "loop closing",
                                    on_system=on_system)
    out = check_loop_run(s, seq, summary, counts, hooks["timed"],
                         "loop closing")
    if "problem" not in hooks:
        raise AssertionError("no GBA problem was built")
    return out, hooks["problem"]


def _pose_err(pose, tcw):
    """(translation m, rotation rad) of pose against the true Tcw."""
    import torch
    from eao_fusion_tpu_torch.ops import lie
    d = lie.se3_log(lie.se3_compose(
        lie.se3_inverse(torch.as_tensor(np.asarray(pose, np.float32))),
        torch.as_tensor(np.asarray(tcw, np.float32)))).numpy()
    return float(np.linalg.norm(d[3:])), float(np.linalg.norm(d[:3]))


def _blackout(s, shape, t0):
    """Three frames of noise without depth: tracking must be lost."""
    r = np.random.default_rng(0)
    for k in range(3):
        noise = r.uniform(0, 1, shape).astype(np.float32)
        s.process_frame(noise, np.zeros(shape, np.float32), t0 + 0.03 * k)


def phase_relocalization():
    """Relocalization and localization-only mode at full width, the
    automatic reset off (tests/test_reloc_e2e.py:14-48,
    tests/test_tracking_e2e.py:90-119): on the 20-frame arc, 12 frames, a
    blackout, then frame 8 must come back within 5 cm and 0.05 rad and
    frames 9-11 track with > 80 inliers; then in localization-only mode
    frames 12-19 must leave every map tensor bit-identical, insert no
    keyframe and track within 3 cm with >= 30 inliers. On the arc the
    tracker's own reference-keyframe search recovers frame 8 (as in the
    JAX System), so a far revisit on the spin sequence (40 frames, a
    blackout, then frame 4, 150 degrees back) holds BoW relocalization
    itself: >= 1 relocalization, within 5 cm and 0.05 rad."""
    import dataclasses

    import torch
    from eao_fusion_tpu_torch import kernels
    from eao_fusion_tpu_torch.config import tum_fr3_config
    from eao_fusion_tpu_torch.pipeline.system import System
    base = tum_fr3_config(use_objects=False)
    cfg = base.replace(tracking=dataclasses.replace(
        base.tracking, reset_if_lost_below_kfs=0))
    seq = _arc(N_FRAMES, cfg)
    fr = seq.frames
    shape = fr[0].gray.shape

    s = System(cfg)
    torch.cuda.synchronize()
    kernels.reset_launches()
    for f in fr[:12]:
        s.process_frame(f.gray, f.depth, f.timestamp)
    if int(s.track.status) != 1:
        raise AssertionError("not tracking after 12 frames")
    _blackout(s, shape, 0.5)
    if int(s.track.status) == 1:
        raise AssertionError("tracking survived the blackout")
    t = time.perf_counter()
    pose = s.process_frame(fr[8].gray, fr[8].depth, fr[8].timestamp + 1.0)
    torch.cuda.synchronize()
    rec_ms = (time.perf_counter() - t) * 1e3
    dt, dr = _pose_err(pose, fr[8].tcw)
    inl = []
    for f in fr[9:12]:
        s.process_frame(f.gray, f.depth, f.timestamp + 1.0)
        inl.append(s.diags[-1]["n_inliers"])
    log(f"relocalization (arc): frame 8 after the blackout {dt * 100:.2f} "
        f"cm, {dr:.4f} rad (< 5 cm, < 0.05 rad) in {rec_ms:.1f} ms; "
        f"relocalizations {s.n_relocalizations}; frames 9-11 inliers {inl} "
        f"(> 80)")
    if not (dt < 0.05 and dr < 0.05):
        raise AssertionError("frame 8 was not recovered")
    if not all(n > 80 for n in inl):
        raise AssertionError("tracking did not resume after the recovery")

    # localization-only over the rest of the arc
    before = {k: v.clone() if isinstance(v, torch.Tensor) else v
              for k, v in s.map._asdict().items()}
    n_kf = s.n_keyframes
    s.activate_localization_mode()
    errs, inl = [], []
    for f in fr[12:]:
        pose = s.process_frame(f.gray, f.depth, f.timestamp + 1.0)
        errs.append(_pose_err(pose, f.tcw)[0])
        inl.append(s.diags[-1]["n_inliers"])
    s.deactivate_localization_mode()
    changed = [k for k, v in s.map._asdict().items()
               if not (torch.equal(v, before[k])
                       if isinstance(v, torch.Tensor) else v == before[k])]
    counts = dict(kernels.launches)
    log(f"localization-only: frames 12-19 position error cm "
        f"{[round(e * 100, 2) for e in errs]} (< 3), inliers {inl} (>= 30); "
        f"keyframes {n_kf} -> {s.n_keyframes}; map fields changed: "
        f"{changed}; launches {json.dumps(counts)}")
    if changed or s.n_keyframes != n_kf:
        raise AssertionError("localization-only mode changed the map")
    if not (max(errs) < 0.03 and min(inl) >= 30):
        raise AssertionError("localization-only tracking is off")
    tracked = len(s.diags)
    want = 2 * tracked + s.reloc_stats.get("pose_solves", 0)
    if counts["pose_opt"] != want:
        raise AssertionError(f"K1 launched {counts['pose_opt']} times, "
                             f"{want} expected")

    # the far revisit: only BoW relocalization can recover it
    lcfg = _loop_cfg()
    lcfg = lcfg.replace(tracking=dataclasses.replace(
        lcfg.tracking, reset_if_lost_below_kfs=0))
    spin = _spin(lcfg.camera).frames
    s = System(lcfg)
    for f in spin[:40]:
        s.process_frame(f.gray, f.depth, f.timestamp)
    _blackout(s, shape, 10.0)
    t = time.perf_counter()
    pose = s.process_frame(spin[4].gray, spin[4].depth,
                           spin[4].timestamp + 20.0)
    torch.cuda.synchronize()
    rec_ms = (time.perf_counter() - t) * 1e3
    dt, dr = _pose_err(pose, spin[4].tcw)
    log(f"relocalization (far revisit): frame 4 after 40 frames and a "
        f"blackout {dt * 100:.2f} cm, {dr:.4f} rad (< 5 cm, < 0.05 rad) in "
        f"{rec_ms:.1f} ms; relocalizations {s.n_relocalizations} (>= 1), "
        f"pose solves {s.reloc_stats.get('pose_solves', 0)}")
    if s.n_relocalizations < 1:
        raise AssertionError("BoW relocalization did not fire")
    if not (dt < 0.05 and dr < 0.05):
        raise AssertionError("the far revisit was not recovered")


# ------------------------------------------------------------------ steady

STEADY_WARM = 8
STEADY_CHUNK = 6


def run_chunked(s, frames, chunk: int, boxes: bool = False):
    """Drive System `s` (warmed up with `process_frame`) over `frames` in
    the steady chunked mode: `slam_chunk` over each chunk, its frames
    recorded, then `chunk_epilogue`. The launch counts are set to 0 just
    before and read just after. Returns the per-chunk records ({"ms",
    "epilogue_ms", "diag", "pending_before", "pending_after",
    "loops_closed"}) and the counts."""
    import torch
    from eao_fusion_tpu_torch import kernels
    from eao_fusion_tpu_torch.pipeline import steady
    C = _tests_module("torch_contracts")
    cfg = s.cfg
    st = steady.init_steady_state(s)
    kf_before = int(st.m.next_kf)
    out = []
    torch.cuda.synchronize()
    kernels.reset_launches()
    for lo in range(0, len(frames), chunk):
        g, d, b, ts = C.chunk_tensors(cfg, frames[lo:lo + chunk], boxes,
                                      torch.device("cuda"))
        t = time.perf_counter()
        st, diag = steady.slam_chunk(st, g, d, b, ts, cfg=cfg)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        s.record_chunk(st, diag, ts)
        pending = s._pending_detect is not None
        loops = s.n_loops_closed
        t = time.perf_counter()
        st = s.chunk_epilogue(st, kf_before)
        torch.cuda.synchronize()
        out.append(dict(ms=ms, epilogue_ms=(time.perf_counter() - t) * 1e3,
                        diag={k: v.cpu().numpy() for k, v in diag.items()},
                        pending_before=pending,
                        pending_after=s._pending_detect is not None,
                        loops_closed=s.n_loops_closed - loops))
        kf_before = s.next_kf_hint
    counts = dict(kernels.launches)
    return st, out, counts


def phase_steady(objects_summary, smi_line: str):
    """The steady chunked loop at full width, `tum_fr3_config()` (planes,
    objects with the renderer's boxes, loop closing): `process_frame` on 8
    frames of the 20-frame arc, then `slam_chunk` over the other 12 in
    chunks of 6, each followed by `chunk_epilogue`. The bounds of
    tests/test_steady.py and tests/test_chunk_epilogue.py: every frame
    > 30 inliers, >= 2 keyframes inserted, tracking OK, the last frame's
    translation within 5 cm; K1 twice per frame, K4 as often as K2. Prints
    the sustained rate of the chunked part (kf_every = 0), the epilogue's
    ms per chunk and the keyframe-trigger histogram."""
    import torch
    from eao_fusion_tpu_torch.config import tum_fr3_config
    from eao_fusion_tpu_torch.pipeline import tracking
    from eao_fusion_tpu_torch.pipeline.system import System
    cfg = tum_fr3_config()
    if not (cfg.use_planes and cfg.use_objects and cfg.use_loop_closing):
        raise AssertionError("the default configuration has planes, "
                             "objects or loop closing off")
    seq = _arc(N_FRAMES, cfg)
    s = System(cfg)
    warm_ms = []
    for f in seq.frames[:STEADY_WARM]:
        t = time.perf_counter()
        s.process_frame(f.gray, f.depth, f.timestamp, boxes=f.boxes)
        torch.cuda.synchronize()
        warm_ms.append((time.perf_counter() - t) * 1e3)
    reloc0 = s.reloc_stats.get("pose_solves", 0)
    frames = seq.frames[STEADY_WARM:]
    st, chunks, counts = run_chunked(s, frames, STEADY_CHUNK, boxes=True)
    s._poll_gba(blocking=True)
    ninl = np.concatenate([c["diag"]["n_inliers"] for c in chunks])
    kfi = np.concatenate([c["diag"]["kf_inserted"] for c in chunks])
    trig = np.concatenate([c["diag"]["kf_trigger"] for c in chunks])
    pose = st.ts.pose.cpu().numpy()
    t_err = float(np.linalg.norm(pose[4:7] - seq.frames[-1].tcw[4:7]))
    total_s = sum(c["ms"] + c["epilogue_ms"] for c in chunks) / 1e3
    hist = {int(k): int(v) for k, v in zip(*np.unique(trig,
                                                      return_counts=True))}
    log("steady: " + json.dumps({
        "frames": len(frames), "chunk": STEADY_CHUNK, "kf_every": 0,
        "sustained_fps": len(frames) / total_s,
        "chunk_ms": [round(c["ms"], 2) for c in chunks],
        "epilogue_ms": [round(c["epilogue_ms"], 2) for c in chunks],
        "ms_per_frame_in_chunks": sum(c["ms"] for c in chunks) / len(frames),
        "warmup_process_frame_ms": [round(m, 2) for m in warm_ms],
        "objects_phase_median_frame_ms": objects_summary["median_frame_ms"],
        "kf_trigger_histogram": hist, "kf_inserted": int(kfi.sum()),
        "n_inliers": ninl.tolist(), "final_translation_err_cm":
            t_err * 100.0, "map_objects": int(s.objects.valid.sum()),
        "relocalizations": s.n_relocalizations, "launches": counts,
        "card": smi_line}))
    if not (ninl > 30).all():
        raise AssertionError(f"tracking degraded in the chunks: {ninl}")
    if kfi.sum() < 2:
        raise AssertionError(f"{int(kfi.sum())} keyframes inserted (>= 2)")
    if int(st.ts.status) != tracking.STATUS_OK:
        raise AssertionError("not tracking at the end of the chunks")
    if not t_err < 0.05:
        raise AssertionError(f"final translation error {t_err:.4f} m")
    _check_launches(counts, len(frames),
                    s.reloc_stats.get("pose_solves", 0) - reloc0)
    return counts


def phase_loop_chunks():
    """The loop phase's spin15 sequence in the chunked mode (chunks of 8
    after 8 frames of `process_frame`), as tests/test_async_detect.py:
    at least one loop closed, each at a boundary that harvested a
    detection dispatched at the one before; the corrected trajectory
    (frames 3 on) under 10 cm; K1 twice per chunked frame plus the
    relocalization solves, K4 as often as K2."""
    import torch
    from eao_fusion_tpu_torch.io import tum
    from eao_fusion_tpu_torch.pipeline.system import System
    cfg = _loop_cfg()
    seq = _spin(cfg.camera)
    s = System(cfg)
    for f in seq.frames[:8]:
        s.process_frame(f.gray, f.depth, f.timestamp)
    torch.cuda.synchronize()
    reloc0 = s.reloc_stats.get("pose_solves", 0)
    st, chunks, counts = run_chunked(s, seq.frames[8:], 8)
    loops_run = s.n_loops_closed
    s._poll_gba(blocking=True)
    gt = seq.gt_tcw()
    n = len(s.trajectory)
    raw = tum.evaluate_ate_rpe(s.trajectory_tcw()[3:n], gt[3:n]).ate_rmse
    corr = tum.evaluate_ate_rpe(s.trajectory_tcw(corrected=True)[3:n],
                                gt[3:n]).ate_rmse
    closed_at = [i for i, c in enumerate(chunks) if c["loops_closed"]]
    ninl = np.concatenate([c["diag"]["n_inliers"] for c in chunks])
    st_ = s.loop_closer.stats
    log("loop in chunks: " + json.dumps({
        "frames": n, "chunks": len(chunks), "keyframes": s.n_keyframes,
        "loops_closed": s.n_loops_closed, "loops_closed_in_chunks":
            loops_run, "closed_at_boundaries": closed_at,
        "dispatched_at_boundaries": [i for i, c in enumerate(chunks)
                                     if c["pending_after"]],
        "gba_merges": s.n_gba_merges,
        "relocalizations": s.n_relocalizations,
        "lost_frames": int((ninl < 20).sum()),
        "raw_ate_cm": raw * 100, "corrected_ate_cm": corr * 100,
        "chunk_ms": [round(c["ms"], 1) for c in chunks],
        "epilogue_ms": [round(c["epilogue_ms"], 1) for c in chunks],
        "detect_ms_mean": st_.get("t_detect", 0.0) / max(
            st_.get("n_detect", 0), 1) * 1e3,
        "launches": counts}))
    if s.n_loops_closed < 1:
        raise AssertionError(f"no loop closed over {s.n_keyframes} "
                             f"keyframes (chunked)")
    for i in closed_at:
        if not (i > 0 and chunks[i]["pending_before"]
                and chunks[i - 1]["pending_after"]):
            raise AssertionError(f"a loop closed at boundary {i} without a "
                                 f"detection dispatched at boundary {i - 1}")
    if not corr < 0.10:
        raise AssertionError(f"corrected ATE {corr * 100:.2f} cm (< 10)")
    _check_launches(counts, len(seq.frames) - 8,
                    s.reloc_stats.get("pose_solves", 0) - reloc0)


@contextlib.contextmanager
def first_calls():
    """Keep clones of the inputs of the first K1 launch and of the first
    local-BA edge binding and its first K2 call, made while the context
    is open: {"k1": (pose0, obs, planes, cam, cfg), "edges": (x, tgt, kw),
    "k2": (cam_pose, pt_xyz, active)}."""
    from eao_fusion_tpu_torch.solvers import ba_edge, pose_opt

    def clone(t):
        return type(t)(*(v.clone() if v is not None else None for v in t))
    got = {}
    k1 = pose_opt.optimize_pose_cuda
    edge_cls = ba_edge.EdgePass

    def k1_spy(pose0, obs, plane_obs=None, *, cam, cfg):
        if "k1" not in got:
            got["k1"] = (pose0.clone(), clone(obs), plane_obs, cam, cfg)
        return k1(pose0, obs, plane_obs, cam=cam, cfg=cfg)

    class EdgeSpy(edge_cls):
        def __init__(self, x, tgt, **kw):
            super().__init__(x, tgt, **kw)
            if "edges" not in got:
                got["edges"] = (clone(x), tgt.clone(), kw)
                got["edge_pass"] = self

        def full(self, cam_pose, pt_xyz, active):
            if got.get("edge_pass") is self and "k2" not in got:
                got["k2"] = (cam_pose.clone(), pt_xyz.clone(), active.clone())
            return super().full(cam_pose, pt_xyz, active)

    pose_opt.optimize_pose_cuda = k1_spy
    ba_edge.EdgePass = EdgeSpy
    try:
        yield got
    finally:
        pose_opt.optimize_pose_cuda = k1
        ba_edge.EdgePass = edge_cls


def check_mono_kernels(got):
    """The first K1 launch and the first local-BA edge pass of the mono
    run, which carry only mono edges (uright < 0), against their plain
    versions with the tolerances of phases 3 and 4."""
    import torch
    from eao_fusion_tpu_torch.solvers import ba_edge, pose_opt
    pose0, obs, planes, cam, cfg = got["k1"]
    if bool((obs.uright[obs.valid] >= 0).any()):
        raise AssertionError("the mono run's K1 call has stereo edges")
    ref = pose_opt.optimize_pose_plain(pose0, obs, planes, cam=cam, cfg=cfg)
    ker = pose_opt.optimize_pose_cuda(pose0, obs, planes, cam=cam, cfg=cfg)
    err = pose_err(ref.pose, ker.pose)
    agree = float((ref.inliers == ker.inliers).float().mean())
    dn = abs(int(ref.n_inliers) - int(ker.n_inliers))
    log(f"mono K1 ({int(obs.valid.sum())} mono edges): pose err {err:.3g} "
        f"(< 1e-3), inlier agreement {agree:.4f} (> 0.995), n_inliers "
        f"{int(ref.n_inliers)} vs {int(ker.n_inliers)} (within 5)")
    if not (err < 1e-3 and agree > 0.995 and dn <= 5):
        raise AssertionError("mono K1 disagrees with its plain version")
    x, tgt, kw = got["edges"]
    cam_pose, pt_xyz, active = got["k2"]
    x = x._replace(cam_pose=cam_pose, pt_xyz=pt_xyz)
    if bool((x.obs_ur[active > 0] >= 0).any()):
        raise AssertionError("the mono run's local BA has stereo edges")
    edges = ba_edge.EdgePass(x, tgt, **kw)
    args = (cam_pose, pt_xyz, active)
    ref = ba_edge.edge_sums_plain(x, active, tgt, **kw)
    ker = edges.full(*args)
    # The gradient channels J^T W r of a window that local BA has nearly
    # converged cancel: each residual is the difference of two pixel
    # coordinates near 600 px, which float32 resolves to ~6e-5 px, so two
    # float32 versions of one sum part by that much times sum |J| w. They
    # are held to phase 4's per-edge K3 tolerance (1e-3 of max(chi2, 1))
    # carried through the sum: 1e-3 of sum_e |J_e|^T W_e max(|r_e|, 1 px).
    # The Hessian channels and Y keep phase 4's K2 tolerance.
    r, J, w = ba_edge._edge_math(x, active, kw["cam"], kw["chi2_mono"],
                                 kw["chi2_stereo"])[:3]
    gb = torch.einsum("eri,e,er->ei", J.abs(), w, r.abs().clamp(min=1.0))
    C, Pw = cam_pose.shape[0], pt_xyz.shape[0]
    g_scale = (torch.zeros((C, 6), device=gb.device).index_add_(
                   0, x.obs_cam.long(), gb[:, :6]),
               torch.zeros((Pw + 1, 3), device=gb.device).index_add_(
                   0, tgt.long(), gb[:, 6:])[:Pw])
    n_e = int((active > 0).sum())
    for name, a, b, dim, n_h, gs in (("acc_c", ref[0], ker[0], 0, 36,
                                      g_scale[0]),
                                     ("acc_p", ref[1], ker[1], 0, 9,
                                      g_scale[1]),
                                     ("Y", ref[2], ker[2], 1, None, None)):
        h = (slice(None), slice(0, n_h)) if n_h else (slice(None),)
        scale = a[h].abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
        rel = float(((a[h] - b[h]).abs() / scale).max())
        msg = (f"mono K2 ({n_e} mono edges) {name}: Hessian max err / "
               f"channel max {rel:.3g} (< 1e-4)" if n_h else
               f"mono K2 {name}: max err / channel max {rel:.3g} (< 1e-4)")
        ok = rel < 1e-4
        if n_h:
            g = (slice(None), slice(n_h, None))
            relg = float(((a[g] - b[g]).abs() / gs.clamp(min=1e-30)).max())
            chan = float(((a[g] - b[g]).abs() / a[g].abs().amax(
                dim=0, keepdim=True).clamp(min=1e-30)).max())
            msg += (f"; gradient max err / sum |J| w max(|r|, 1) "
                    f"{relg:.3g} (< 1e-3), / channel max {chan:.3g}")
            ok = ok and relg < 1e-3
        log(msg)
        if not ok:
            raise AssertionError(f"mono K2 disagrees ({name})")
    ref3 = ba_edge.edge_pass_chi2_plain(x, active, **kw)
    ker3 = edges.chi2_edges(*args)
    for name, a, b in zip(("robust", "raw"), ref3[:2], ker3[:2]):
        rel = float(((a - b).abs() / a.abs().clamp(min=1.0)).max())
        log(f"mono K3 {name} chi2: max err / max(chi2, 1) {rel:.3g} "
            f"(< 1e-3)")
        if not rel < 1e-3:
            raise AssertionError(f"mono K3 disagrees ({name})")


def phase_mono():
    """Monocular input at full width, `tum_fr3_config(sensor="mono",
    use_planes=False)`, on the 20-frame arc: two-view initialization (the
    GBA at init), at least 3 keyframes, more than 250 points, and a
    scale-aligned ATE < 4 cm from the first initialized frame on
    (tests/test_mono_e2e.py); the launch counts; one K1 launch and one
    local-BA edge pass of the run, with only mono edges, against their
    plain versions."""
    from eao_fusion_tpu_torch.config import tum_fr3_config
    cfg = tum_fr3_config(sensor="mono", use_planes=False)
    seq = _arc(N_FRAMES, cfg)
    with first_calls() as got:
        s, summary, counts = run_system(cfg, seq, "mono", mono=True)
    n_pts = int(s.map.next_pt)
    log(f"mono: initialized at frame {summary['init_frame']}, "
        f"{s.n_keyframes} keyframes, {n_pts} points, scale-aligned ATE "
        f"{summary['ate_cm']:.3f} cm (< 4)")
    _check_tracking(summary, counts, ate_cm=4.0)
    if n_pts <= 250:
        raise AssertionError(f"{n_pts} map points (> 250)")
    check_mono_kernels(got)
    return summary


def phase_stereo():
    """Stereo input at full width on the 20-frame arc with the port's own
    right renders: frame 0's stereo depths (>= 150 matches, median
    relative error < 5%, uR < uL; tests/test_stereo.py:27-45), then
    stereo tracking, `tum_fr3_config(sensor="stereo", use_planes=False,
    use_objects=False)`: ATE < 5 cm (tests/test_stereo.py:58-60), and, as
    in every System phase, local BA and the launch counts."""
    import torch
    from eao_fusion_tpu_torch.config import tum_fr3_config
    from eao_fusion_tpu_torch.frontend import stereo
    from eao_fusion_tpu_torch.io import synthetic
    cfg = tum_fr3_config(sensor="stereo", use_planes=False,
                         use_objects=False)
    seq = _arc(N_FRAMES, cfg)
    t = time.perf_counter()
    rights = synthetic.render_right_images(seq)
    log(f"rendered {len(rights)} right images in "
        f"{time.perf_counter() - t:.1f} s (host)")
    f = seq.frames[0]
    dev = torch.device("cuda")
    feats = stereo.extract_stereo_features(
        torch.as_tensor(f.gray, device=dev),
        torch.as_tensor(rights[0], device=dev), orb_cfg=cfg.orb,
        cam_cfg=cfg.camera)
    depth, uv = feats.depth.cpu().numpy(), feats.uv.cpu().numpy()
    ok = depth > 0
    ui = np.clip(np.round(uv[ok, 0]).astype(int), 0, cfg.camera.width - 1)
    vi = np.clip(np.round(uv[ok, 1]).astype(int), 0, cfg.camera.height - 1)
    gt = f.depth[vi, ui]
    rel = float(np.median(np.abs(depth[ok] - gt) / np.maximum(gt, 1e-6)))
    ur_ok = bool(np.all(feats.uright.cpu().numpy()[ok] < uv[ok, 0] + 1e-3))
    log(f"stereo depth, frame 0: {int(ok.sum())} matches (>= 150), median "
        f"relative error {rel:.4f} (< 0.05), uR < uL: {ur_ok}")
    if not (ok.sum() >= 150 and rel < 0.05 and ur_ok):
        raise AssertionError("stereo matching is off")
    _, summary, counts = run_system(cfg, seq, "stereo", rights=rights)
    _check_tracking(summary, counts, ate_cm=5.0)
    return summary


# -------------------------------------------------------------- I/O, CLI

def _cli_run(argv, tag):
    """`run_tum.main(argv)` on the card, the launch counts set to 0 just
    before and read just after; returns the System, the counts and the
    run's summary record from its JSONL log (the last argv pair)."""
    import torch
    from eao_fusion_tpu_torch import kernels
    from eao_fusion_tpu_torch.apps import run_tum
    torch.cuda.synchronize()
    kernels.reset_launches()
    t = time.perf_counter()
    s = run_tum.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = dict(kernels.launches)
    if s.device.type != "cuda":
        raise AssertionError(f"the CLI ran on {s.device}, not on the card")
    log_path = argv[argv.index("--log-jsonl") + 1]
    with open(log_path) as fh:
        recs = [json.loads(line) for line in fh]
    summary = recs[-1]
    if summary.get("event") != "summary":
        raise AssertionError(f"{tag}: the JSONL log has no summary")
    log(f"CLI {tag}: {summary['frames']} frames in {summary['seconds']:.2f}"
        f" s ({summary['fps_after_first']:.2f} fps after the first two), "
        f"{wall:.2f} s with set-up and outputs; launches {counts}")
    return s, counts, summary, recs


def phase_cli(objects_summary):
    """The port's dataset writer, native frame loader and CLI on the card,
    `tum_fr3_config()` at full width over the seed-0 20-frame arc on disk
    (the bounds are tests/test_tracking_e2e.py:72 and :90-119,
    tests/test_aux.py:58-64, tests/test_steady.py:46-54)."""
    import tempfile
    import torch
    from eao_fusion_tpu_torch.config import tum_fr3_config
    from eao_fusion_tpu_torch.io import native_loader, tum
    from eao_fusion_tpu_torch.ops import lie
    from eao_fusion_tpu_torch.tools.make_tum_dataset import write_dataset
    from eao_fusion_tpu_torch.types import to_numpy
    cfg = tum_fr3_config()
    seq = _arc(N_FRAMES, cfg)
    t = time.perf_counter()
    lib = native_loader.build()
    log(f"native frame loader {lib.name} ready in "
        f"{time.perf_counter() - t:.1f} s")
    gt = seq.gt_tcw()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        ds = os.path.join(tmp, "ds")
        t = time.perf_counter()
        write_dataset(ds, seq)
        log(f"dataset of {N_FRAMES} frames written in "
            f"{time.perf_counter() - t:.2f} s (host)")
        f = seq.frames[3]
        ts = f"{f.timestamp:.6f}"
        g8 = np.clip(np.round(f.gray * 255), 0, 255).astype(np.uint8)
        d16 = np.clip(np.round(f.depth * 5000.0), 0, 65535).astype(np.uint16)
        for name, want in ((f"rgb/{ts}.png", np.stack([g8] * 3, -1)),
                           (f"depth/{ts}.png", d16)):
            with open(os.path.join(ds, name), "rb") as fh:
                got, _, _ = native_loader.decode_png(fh.read())
            if not (got.dtype == want.dtype and np.array_equal(got, want)):
                raise AssertionError(f"{name} does not decode to the "
                                     f"array written")
        log("an RGB and a depth PNG decode to exactly the arrays written")

        def p(name):
            return os.path.join(tmp, name)
        base = [ds, "--boxes", os.path.join(ds, "boxes")]
        gt_arg = ["--gt", os.path.join(ds, "groundtruth.txt")]

        # (a) every output, and a checkpoint
        s, counts, summ, recs = _cli_run(
            base + gt_arg + ["--out", p("a.txt"), "--kitti", p("a.kitti"),
                             "--kf-out", p("a_kf.txt"), "--checkpoint",
                             p("a.npz"), "--log-jsonl", p("a.jsonl")], "(a)")
        ts_a, twc = tum.read_groundtruth(p("a.txt"))
        est = lie.se3_inverse(torch.from_numpy(twc)).numpy()
        ate = tum.evaluate_ate_rpe(est, gt).ate_rmse * 100.0
        kitti = np.loadtxt(p("a.kitti"))
        kf_ts, _ = tum.read_groundtruth(p("a_kf.txt"))
        with np.load(p("a.npz")) as z:
            ckpt_map = {k[4:]: z[k] for k in z.files if k.startswith("map.")}
            meta = json.loads(bytes(z["meta"]).decode())
        n_frame_recs = sum("frame" in r for r in recs)
        log(f"CLI (a): ATE {ate:.4f} cm (< 1.5) from the written TUM file; "
            f"{len(ts_a)} poses, KITTI {kitti.shape}, {len(kf_ts)} keyframe "
            f"poses, {n_frame_recs} frame records, checkpoint of "
            f"{len(ckpt_map)} map fields at frame {meta['frame_id']}")
        if not (len(ts_a) == N_FRAMES and kitti.shape == (N_FRAMES, 12)
                and np.allclose(kitti[:, [3, 7, 11]], twc[:, 4:], atol=1e-5)
                and len(kf_ts) == int(s.map.kf_valid.sum())
                and n_frame_recs == len(s.diags)
                and meta["frame_id"] == N_FRAMES):
            raise AssertionError("CLI (a): an output does not parse back")
        if not ate < 1.5:
            raise AssertionError(f"CLI (a): ATE {ate:.3f} cm >= 1.5 cm")
        _check_launches(counts, len(s.diags),
                        s.reloc_stats.get("pose_solves", 0))
        out["a"] = dict(ate_cm=ate, fps=summ["fps_after_first"],
                        keyframes=s.n_keyframes, launches=counts)
        n_kf = s.n_keyframes

        # (b) the checkpoint resumed, localization only, the same frames
        s, counts, summ, _ = _cli_run(
            base + gt_arg + ["--out", p("b.txt"), "--resume", p("a.npz"),
                             "--localization-only", "--log-jsonl",
                             p("b.jsonl")], "(b)")
        changed = [k for k, v in s.map._asdict().items()
                   if not np.array_equal(to_numpy(v), ckpt_map[k])]
        ate = tum.evaluate_ate_rpe(s.trajectory_tcw()[N_FRAMES:],
                                   gt).ate_rmse * 100.0
        solves = s.reloc_stats.get("pose_solves", 0)
        log(f"CLI (b): {s.n_keyframes} keyframes (resumed {n_kf}), map "
            f"fields changed: {changed}, ATE of the localized frames "
            f"{ate:.4f} cm (< 3), relocalizations {s.n_relocalizations}")
        if changed or s.n_keyframes != n_kf:
            raise AssertionError("CLI (b): localization changed the map")
        if not ate < 3.0:
            raise AssertionError(f"CLI (b): ATE {ate:.3f} cm >= 3 cm")
        if (counts["pose_opt"] != 2 * len(s.diags) + solves
                or counts["chol_solve"] != counts["ba_edge_full"]):
            raise AssertionError(f"CLI (b): launch counts {counts}")
        out["b"] = dict(ate_cm=ate, fps=summ["fps_after_first"],
                        relocalizations=s.n_relocalizations,
                        launches=counts)

        # (c) gravity-aligned from the accelerometer, in chunks of 6
        accel = os.path.join(ds, "accelerometer.txt")
        s, counts, summ, recs = _cli_run(
            base + ["--imu", accel, "--chunk", "6", "--out", p("c.txt"),
                    "--log-jsonl", p("c.jsonl")], "(c)")
        a = tum.read_accelerometer(accel)[0].accel
        R = lie.quat_to_rotmat(torch.from_numpy(s.trajectory[0][:4])).numpy()
        z_err = float(np.abs(R[:, 2] - a / np.linalg.norm(a)).max())
        chunk_recs = [r for r in recs if "kf_inserted" in r]
        ninl = [r["n_inliers"] for r in recs if "frame" in r]
        kfi = sum(r["kf_inserted"] for r in chunk_recs)
        ate = tum.evaluate_ate_rpe(s.trajectory_tcw(),
                                   gt).ate_rmse * 100.0
        log(f"CLI (c): world z against the measured acceleration "
            f"{z_err:.2e} (< 1e-5); {len(chunk_recs)} frames in chunks, "
            f"{kfi} keyframes there (>= 2), inliers min {min(ninl)} (> 30); "
            f"aligned ATE {ate:.4f} cm (< 5)")
        if not z_err < 1e-5:
            raise AssertionError("CLI (c): the world is not gravity-aligned")
        if not (min(ninl) > 30 and kfi >= 2 and len(chunk_recs) >= 6
                and ate < 5.0):
            raise AssertionError("CLI (c): the chunked run is off")
        _check_launches(counts, len(s.diags),
                        s.reloc_stats.get("pose_solves", 0))
        out["c"] = dict(ate_cm=ate, fps=summ["fps_after_first"],
                        chunk_frames=len(chunk_recs), launches=counts)
    log("CLI fps after the first two frames (a) / (b) / (c): "
        + " / ".join(f"{out[k]['fps']:.2f}" for k in "abc")
        + f"; the in-memory objects cell in this run: "
        f"{objects_summary['fps_after_first']:.2f}")
    return out


# ---------------------------------------------------------------- training

TRAIN_STEPS = 200
TRAIN_BATCH = 8
TRAIN_WIDTH = 0.25
# parameters after three steps, card against CPU, in units of the steps'
# summed learning rate (Adam's normalized update is about lr per weight)
TRAIN_PARAM_TOL_LR = 0.05


def phase_training():
    """Detector training on the card (frontend/yolox_train.py): three
    steps against the CPU on the same parameters and draws, 200 steps that
    must halve the loss, and `evaluate` with the shipped weights on the
    card against the CPU."""
    import torch
    from eao_fusion_tpu_torch.config import tum_fr3_config
    from eao_fusion_tpu_torch.frontend import yolox
    from eao_fusion_tpu_torch.frontend import yolox_train as YT
    from eao_fusion_tpu_torch.pipeline.system import REPO_ROOT
    from eao_fusion_tpu_torch.tools.train_yolox import TRAIN_SPECS, render
    t = time.perf_counter()
    seqs = [_arc(24, tum_fr3_config(), class_textures=True),
            render(TRAIN_SPECS[1], 8)]
    data_h = YT.build_dataset(seqs, 8)
    n_img = data_h["gray"].shape[0]
    log(f"training set: {n_img} images from 2 scenes, "
        f"{time.perf_counter() - t:.1f} s (host)")
    dev = torch.device("cuda")
    init = yolox.params_to_numpy(yolox.init_params(
        torch.Generator().manual_seed(0), width_mult=TRAIN_WIDTH,
        n_classes=8, device="cpu"))
    g = torch.Generator().manual_seed(1)
    draws = [YT.draw_batch(g, n_img, TRAIN_BATCH) for _ in range(3)]
    runs = {}
    for d in ("cpu", "cuda"):
        params = yolox.params_from_numpy(init, d)
        opt, sched = YT.make_optimizer(params, TRAIN_STEPS)
        data = YT.dataset_to_device(data_h, torch.device(d))
        losses = [float(YT.train_step(params, opt, sched, data,
                                      {k: v.to(d) for k, v in dr.items()})[0])
                  for dr in draws]
        runs[d] = (losses, yolox.params_to_numpy(params))
    loss_rel = max(abs(a / b - 1) for a, b in zip(runs["cuda"][0],
                                                  runs["cpu"][0]))
    lr = YT.lr_schedule(TRAIN_STEPS)
    lr_sum = sum(lr(k) for k in range(3))
    pc, pg = _flat_np(runs["cpu"][1]), _flat_np(runs["cuda"][1])
    p_err = max(float(np.abs(pg[k] - pc[k]).max()) for k in pc)
    log(f"three train steps, card against CPU: losses "
        f"{[round(x, 4) for x in runs['cuda'][0]]} / "
        f"{[round(x, 4) for x in runs['cpu'][0]]}, max relative "
        f"{loss_rel:.2e} (< 1e-4); parameters max |diff| {p_err:.3e} = "
        f"{p_err / lr_sum:.3e} of the summed learning rate {lr_sum:.3e} "
        f"(< {TRAIN_PARAM_TOL_LR})")
    if not (loss_rel < 1e-4 and p_err <= TRAIN_PARAM_TOL_LR * lr_sum):
        raise AssertionError("train steps on the card differ from the CPU")

    # 200 steps on the card
    data = YT.dataset_to_device(data_h, dev)
    params = yolox.params_from_numpy(init, dev)
    opt, sched = YT.make_optimizer(params, TRAIN_STEPS)
    gd = torch.Generator(device=dev).manual_seed(2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for _ in range(TRAIN_STEPS):
        t = time.perf_counter()
        loss, _ = YT.train_step(params, opt, sched, data,
                                YT.draw_batch(gd, n_img, TRAIN_BATCH))
        losses.append(float(loss))            # waits for the step
        ms.append((time.perf_counter() - t) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    first, last = float(np.mean(losses[:20])), float(np.mean(losses[-20:]))
    step_ms = float(np.median(ms[20:]))
    log(f"training on the card: {TRAIN_STEPS} steps, width {TRAIN_WIDTH}, "
        f"batch {TRAIN_BATCH}, 640x640: mean loss of the first 20 "
        f"{first:.3f}, of the last 20 {last:.3f} (<= half); median "
        f"{step_ms:.2f} ms a step after step 20; peak memory {peak:.0f} MiB")
    if not last <= 0.5 * first:
        raise AssertionError("the loss did not halve in 200 steps")

    # evaluate with the shipped weights, card against CPU
    path = f"{REPO_ROOT}/data/yolox_synth.npz"
    seq = seqs[0]
    grays = [seq.frames[i].gray for i in DETECTOR_FRAMES]
    boxes = [seq.frames[i].boxes for i in DETECTOR_FRAMES]
    m = {}
    for d in ("cpu", "cuda"):
        pw = yolox.load_params(path, d)
        dm, nc = yolox.infer_arch(pw)
        m[d] = YT.evaluate(pw, dm, nc, grays, boxes)
    log(f"evaluate, shipped weights, six frames: card {m['cuda']}, CPU "
        f"{m['cpu']}")
    if m["cuda"] != m["cpu"]:
        raise AssertionError("evaluate differs between the card and the CPU")
    return dict(step_ms=step_ms, peak_mib=peak, loss_first=first,
                loss_last=last, loss_rel=loss_rel,
                param_err_over_lr=p_err / lr_sum, eval=m["cuda"])


def _flat_np(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_np(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


CAM = (535.4, 539.2, 320.1, 247.6, 40.0)


# ------------------------------------------------------------- distributed
# Phases 20, 21 and 24 run ranks in spawned child processes (`run_ranks`):
# each group forms through a file store in a temporary directory; a rank
# that fails or a group that outlives its time limit fails the phase.
# Ranks print on lines before the last.

RANK_TIMEOUT_S = 300.0


def run_ranks(target, world: int, args, timeout: float = RANK_TIMEOUT_S):
    """Run target(rank, world, *args) in `world` spawned processes; raise
    unless every one exits 0 within `timeout` seconds (the rest are
    killed)."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, world, *args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    late = [p for p in procs if p.is_alive()]
    for p in late:
        p.kill()
        p.join()
    codes = [p.exitcode for p in procs]
    if late or any(c != 0 for c in codes):
        raise AssertionError(f"{target.__name__}: rank exit codes {codes}, "
                             f"{len(late)} killed after {timeout:.0f} s")


def _join_group(rank: int, world: int, store: str, backend: str):
    """This rank's process group on cuda:0 (every rank of a group shares
    the card here) through `multihost.ensure_initialized`."""
    import torch
    from eao_fusion_tpu_torch.parallel import multihost
    torch.cuda.set_device(0)
    multihost.ensure_initialized(multihost.MultihostSpec(
        coordinator_address=f"file://{store}", num_processes=world,
        process_id=rank, backend=backend))


@contextlib.contextmanager
def counting_solves():
    """Count `torch.linalg.solve` calls inside the block, one per LM
    iteration of either GBA solver: yields the one-element list the
    count is in."""
    import torch
    n = [0]
    solve = torch.linalg.solve

    def counted(*a, **k):
        n[0] += 1
        return solve(*a, **k)

    torch.linalg.solve = counted
    try:
        yield n
    finally:
        torch.linalg.solve = solve


def _save_gba_problem(path, prob, pf, cam) -> None:
    d = {f"prob_{k}": getattr(prob, k).cpu().numpy() for k in prob._fields}
    if pf is not None:
        d.update({f"pf_{k}": getattr(pf, k).cpu().numpy()
                  for k in pf._fields})
    np.savez(path, cam=np.asarray(cam, np.float64), **d)


def _load_gba_problem(path, dev):
    import torch
    from eao_fusion_tpu_torch.solvers import ba
    z = np.load(path)
    t = lambda k: torch.as_tensor(z[k], device=dev)
    prob = ba.BAProblem(*(t(f"prob_{k}") for k in ba.BAProblem._fields))
    pf = (ba.PlaneFreeBlock(*(t(f"pf_{k}") for k in ba.PlaneFreeBlock._fields))
          if "pf_pl_coeff" in z else None)
    return prob, pf, tuple(float(x) for x in z["cam"])


def _timed_gba(run, solves, barrier=lambda: None):
    """(result, ms per LM iteration, LM iterations) of run(): once to warm
    up, then timed on the host clock between synchronizations (and, for
    ranks, the group's barrier)."""
    import torch
    run()
    torch.cuda.synchronize()
    barrier()
    n0 = solves[0]
    t = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    iters = solves[0] - n0
    return res, (time.perf_counter() - t) * 1e3 / max(iters, 1), iters


def _gba_rank(rank, world, backend, tmp, n1, n2):
    """Phase 20's rank: the distributed GBA of the saved problem on cuda:0,
    timed; then the all-reduce of one LM iteration's camera system alone.
    Rank 0 writes the result and the times."""
    import torch
    import torch.distributed as dist
    from eao_fusion_tpu_torch.config import SolverConfig
    from eao_fusion_tpu_torch.parallel import dist_ba, mesh
    _join_group(rank, world, os.path.join(tmp, f"store_{backend}{world}"),
                backend)
    m = mesh.make_mesh(device_type="cuda")
    prob, pf, cam = _load_gba_problem(os.path.join(tmp, "gba.npz"), "cuda")

    def run():
        return dist_ba.distributed_bundle_adjust(
            prob, m, plane_free=pf, cam=cam, cfg=SolverConfig(),
            n_iters1=n1, n_iters=n2)

    with counting_solves() as solves:
        res, ms_iter, iters = _timed_gba(run, solves, dist.barrier)
    C = prob.cam_pose.shape[0]
    buf = torch.zeros(C * C * 36 + C * 6, dtype=torch.float64,
                      device="cuda")
    for _ in range(2):
        dist.all_reduce(buf)
    torch.cuda.synchronize()
    dist.barrier()
    t = time.perf_counter()
    for _ in range(10):
        dist.all_reduce(buf)
    torch.cuda.synchronize()
    ar_ms = (time.perf_counter() - t) * 1e3 / 10
    if rank == 0:
        np.savez(os.path.join(tmp, f"gba_{backend}{world}.npz"),
                 cam_pose=res.cam_pose.cpu().numpy(),
                 pt_xyz=res.pt_xyz.cpu().numpy(),
                 pl_coeff=(res.pl_coeff.cpu().numpy()
                           if res.pl_coeff is not None else np.zeros(0)),
                 chi2=res.chi2.cpu().numpy(), ms_iter=ms_iter, iters=iters,
                 allreduce_ms=ar_ms, allreduce_bytes=buf.numel() * 8)
    dist.destroy_process_group()


def _cam_rmse(a, b) -> float:
    """RMS of the SE3 log of a⁻¹ b over the cameras (tests/test_ba.py)."""
    import torch
    from eao_fusion_tpu_torch.ops import lie
    d = lie.se3_log(lie.se3_compose(lie.se3_inverse(torch.as_tensor(a)),
                                    torch.as_tensor(b))).numpy()
    return float(np.sqrt((d ** 2).sum(-1).mean()))


def phase_dist_ba(problem, loop_cfg):
    """Phase 20: the GBA problem of phase 12's first closure (full width:
    256 keyframe slots x 1024 keypoint slots, 16384 points, free planes)
    under the production two-phase schedule (global_ba_iters): (a) two
    gloo ranks sharing cuda:0 against the port's single-card
    `ba.bundle_adjust` (tests/test_ba.py:180-186's bounds: camera RMSE <
    2e-3, median point difference < 5e-3 m; plane normals within 1e-3);
    (b) a one-rank NCCL group against (a) within 1e-5 (only the order of
    the sums differs). ms per LM iteration of each beside the dense
    solver's, the all-reduce's ms and bytes per iteration."""
    import tempfile

    import torch
    from eao_fusion_tpu_torch.solvers import ba
    prob, pf = problem
    c = loop_cfg.camera
    cam = (c.fx, c.fy, c.cx, c.cy, c.bf)
    total = loop_cfg.solver.global_ba_iters
    n1, n2 = total // 2, total - total // 2
    C, N = prob.obs_pt.shape
    log(f"distributed BA: C = {C}, N = {N}, P = {prob.pt_xyz.shape[0]}, "
        f"L = {0 if pf is None else pf.pl_coeff.shape[0]}, "
        f"{int(prob.obs_valid.sum())} observations, "
        f"{int(prob.cam_valid.sum())} cameras, schedule {n1} + {n2}")
    with tempfile.TemporaryDirectory() as tmp:
        _save_gba_problem(os.path.join(tmp, "gba.npz"), prob, pf, cam)
        dprob, dpf, _ = _load_gba_problem(os.path.join(tmp, "gba.npz"),
                                          "cuda")
        with counting_solves() as solves:
            dense, dense_ms, dense_it = _timed_gba(
                lambda: ba.bundle_adjust(dprob, plane_free=dpf, cam=cam,
                                         cfg=loop_cfg.solver, n_iters1=n1,
                                         n_iters2=n2), solves)
        del dprob, dpf
        torch.cuda.empty_cache()
        runs = {}
        for backend, world in (("gloo", 2), ("nccl", 1)):
            t = time.perf_counter()
            run_ranks(_gba_rank, world, (backend, tmp, n1, n2))
            runs[(backend, world)] = dict(np.load(
                os.path.join(tmp, f"gba_{backend}{world}.npz")))
            log(f"  {world} {backend} rank(s): "
                f"{time.perf_counter() - t:.1f} s with start-up")
    two, one = runs[("gloo", 2)], runs[("nccl", 1)]
    kv = prob.cam_valid.numpy()
    pv = prob.pt_valid.numpy()
    d_pose = _cam_rmse(two["cam_pose"][kv], dense.cam_pose.cpu().numpy()[kv])
    d_pt = float(np.median(np.linalg.norm(
        two["pt_xyz"][pv] - dense.pt_xyz.cpu().numpy()[pv], axis=1)))
    out = {"dense_ms_per_iter": dense_ms, "dense_iters": dense_it,
           "rank2_gloo_ms_per_iter": float(two["ms_iter"]),
           "rank2_iters": int(two["iters"]),
           "rank1_nccl_ms_per_iter": float(one["ms_iter"]),
           "rank1_iters": int(one["iters"]),
           "allreduce_ms_gloo2": float(two["allreduce_ms"]),
           "allreduce_ms_nccl1": float(one["allreduce_ms"]),
           "allreduce_bytes_per_iter": int(two["allreduce_bytes"]),
           "cam_rmse_vs_dense": d_pose, "pt_median_vs_dense_m": d_pt}
    if pf is not None:
        lv = pf.pl_free.numpy()
        out["plane_normal_vs_dense"] = float(np.abs(
            two["pl_coeff"][lv, :3]
            - dense.pl_coeff.cpu().numpy()[lv, :3]).max()) if lv.any() \
            else 0.0
    out["one_vs_two_pose"] = float(np.abs(one["cam_pose"]
                                          - two["cam_pose"]).max())
    out["one_vs_two_pt_rel"] = float((np.abs(one["pt_xyz"] - two["pt_xyz"])
                                      / np.maximum(np.abs(two["pt_xyz"]),
                                                   1.0)).max())
    out["one_vs_two_chi2_rel"] = float(abs(one["chi2"] - two["chi2"])
                                       / max(abs(float(two["chi2"])), 1e-9))
    log("distributed BA: " + json.dumps(out))
    if not (d_pose < 2e-3 and d_pt < 5e-3
            and out.get("plane_normal_vs_dense", 0.0) < 1e-3):
        raise AssertionError("the 2-rank GBA departs from the dense one")
    if not (out["one_vs_two_pose"] < 1e-5 and out["one_vs_two_pt_rel"] < 1e-5
            and out["one_vs_two_chi2_rel"] < 1e-5):
        raise AssertionError("the 1-rank NCCL GBA departs from the 2-rank "
                             "gloo one")
    return out


class _SavedSequence:
    """Frames handed to a child process in an npz: what `run_system` and
    `check_loop_run` read of a synthetic sequence."""

    def __init__(self, path):
        from types import SimpleNamespace
        z = np.load(path)
        gray, depth, ts, tcw = z["gray"], z["depth"], z["ts"], z["tcw"]
        self.frames = [SimpleNamespace(gray=gray[i], depth=depth[i],
                                       timestamp=float(ts[i]), tcw=tcw[i],
                                       boxes=None)
                       for i in range(len(ts))]

    def gt_tcw(self):
        return np.stack([f.tcw for f in self.frames])

    @staticmethod
    def save(path, seq) -> None:
        np.savez(path, gray=np.stack([f.gray for f in seq.frames]),
                 depth=np.stack([f.depth for f in seq.frames]),
                 ts=np.array([f.timestamp for f in seq.frames]),
                 tcw=seq.gt_tcw())


def _loop_rank(rank, world, tmp):
    """Phase 21's rank: rank 0 runs the loop cell's System with
    gba_mesh_devices = world and writes its numbers; the others serve
    the GBA."""
    from eao_fusion_tpu_torch.parallel import dist_ba, mesh
    _join_group(rank, world, os.path.join(tmp, "store"), "gloo")
    cfg = _loop_cfg().replace(gba_mesh_devices=world)
    if rank:
        c = cfg.camera
        served = dist_ba.serve_gba(mesh.make_mesh(n_landmark=world),
                                   (c.fx, c.fy, c.cx, c.cy, c.bf),
                                   cfg.solver)
        log(f"rank {rank}: served {served} GBA stages")
        with open(os.path.join(tmp, f"served_{rank}.json"), "w") as f:
            json.dump(served, f)
        return
    seq = _SavedSequence(os.path.join(tmp, "spin.npz"))
    hooks = {}
    try:
        s, summary, counts = run_system(
            cfg, seq, "loop closing, mesh GBA",
            on_system=lambda s: hooks.update(
                timed=time_loop_steps(s.loop_closer), lc=s.loop_closer))
        out = check_loop_run(s, seq, summary, counts, hooks["timed"],
                             "loop closing, mesh GBA")
        out["launches"] = counts
    finally:
        lc = hooks.get("lc")
        if lc is not None:
            lc.abort_gba()
            dist_ba.stop_gba_server(lc.gba_mesh)
    with open(os.path.join(tmp, "loop.json"), "w") as f:
        json.dump(out, f)


def phase_loop_mesh(loop_out):
    """Phase 21: the loop cell with gba_mesh_devices = 2, two processes on
    the card (rank 0 the System, rank 1 `serve_gba`), the spin15 frames
    of phase 12 handed over in an npz: the loop cell's bounds and launch
    counts (`check_loop_run`), every GBA stage served, and the GBA's ms
    beside phase 12's."""
    import tempfile
    cfg = _loop_cfg()
    seq = _spin(cfg.camera)
    with tempfile.TemporaryDirectory() as tmp:
        _SavedSequence.save(os.path.join(tmp, "spin.npz"), seq)
        t = time.perf_counter()
        run_ranks(_loop_rank, 2, (tmp,))
        wall = time.perf_counter() - t
        with open(os.path.join(tmp, "loop.json")) as f:
            out = json.load(f)
        with open(os.path.join(tmp, "served_1.json")) as f:
            served = json.load(f)
    stages = len(out["gba_stage_ms"])
    log("loop closing, mesh GBA against phase 12: " + json.dumps({
        "wall_s_with_start_up": wall, "stages_served": served,
        "gba_whole_ms_mean": out["gba_whole_ms_mean"],
        "gba_whole_ms_mean_phase12": loop_out["gba_whole_ms_mean"],
        "gba_stage_ms": out["gba_stage_ms"],
        "gba_stage_ms_phase12": loop_out["gba_stage_ms"],
        "median_tracking_frame_ms_gba_inflight":
            out["median_tracking_frame_ms_gba_inflight"],
        "median_tracking_frame_ms_gba_inflight_phase12":
            loop_out["median_tracking_frame_ms_gba_inflight"]}))
    if served != stages or served < 1:
        raise AssertionError(f"rank 1 served {served} GBA stages, rank 0 "
                             f"ran {stages}")
    return out


def _arc_loader(n, seed, style, dn=0.0):
    """A loader of a rendered sequence, rendered once per run."""
    @functools.lru_cache(maxsize=None)
    def make():
        from eao_fusion_tpu_torch.io import synthetic
        return synthetic.generate_sequence(n_frames=n, seed=seed,
                                           style=style, depth_noise=dn)
    return make


def phase_eval():
    """Phase 22: `evaluate_sequences` over three short sequences
    (tests/test_parallel_eval.py's: arcs of 12 frames, seeds 0 and 5 with
    1 cm depth noise, and a 15-frame forward run) in three threads on
    cuda:0, against a serial run: the same keyframe counts, ATE within
    1e-6, each ATE < 2 cm; K4 as often as K2 over the threaded runs."""
    from eao_fusion_tpu_torch import kernels
    from eao_fusion_tpu_torch.config import MapCapacity, ORBConfig, \
        SystemConfig
    from eao_fusion_tpu_torch.parallel import eval as peval
    import torch
    cfg = SystemConfig(orb=ORBConfig(n_features=400, max_keypoints=512),
                       capacity=MapCapacity(max_keyframes=32,
                                            max_points=4096),
                       use_planes=False, use_objects=False)
    seqs = [("arc12", _arc_loader(12, 0, "arc")),
            ("arc12n", _arc_loader(12, 5, "arc", 0.01)),
            ("fwd15", _arc_loader(15, 3, "forward"))]
    t = time.perf_counter()
    for _, mk in seqs:
        mk()
    log(f"evaluation: rendered {len(seqs)} sequences in "
        f"{time.perf_counter() - t:.1f} s (host)")
    t = time.perf_counter()
    ser = [peval._run_one(mk, name, cfg, "cuda:0") for name, mk in seqs]
    torch.cuda.synchronize()
    ser_s = time.perf_counter() - t
    torch.cuda.synchronize()
    kernels.reset_launches()
    t = time.perf_counter()
    par = peval.evaluate_sequences(seqs, cfg, devices=["cuda:0"])
    torch.cuda.synchronize()
    par_s = time.perf_counter() - t
    counts = dict(kernels.launches)
    log(peval.summarize(par))
    log("evaluation: " + json.dumps({
        "serial_s": ser_s, "threads_s": par_s, "launches": counts,
        "ate_cm": [r.ate_rmse * 100 for r in par],
        "ate_gap_vs_serial": [abs(a.ate_rmse - b.ate_rmse)
                              for a, b in zip(par, ser)]}))
    for rp, rs in zip(par, ser):
        if not (rp.n_keyframes == rs.n_keyframes
                and abs(rp.ate_rmse - rs.ate_rmse) <= 1e-6
                and rp.ate_rmse < 0.02 and rp.device == "cuda:0"):
            raise AssertionError(f"{rp} against the serial {rs}")
    if counts["pose_opt"] < 1 or counts["chol_solve"] != \
            counts["ba_edge_full"] or counts["ba_edge_full"] < 1:
        raise AssertionError(f"evaluation launches {counts}")
    return {"serial_s": ser_s, "threads_s": par_s}


def phase_vocab():
    """Phase 23: the vocabulary trainer on one style x two seeds x 8
    frames (about 16k descriptors) with 1024 words and 15 iterations:
    the card's words equal a CPU run's on the same descriptors, the idf
    within 1e-6; then the command line into a temporary --out."""
    import tempfile
    from eao_fusion_tpu_torch.mapping import vocabulary
    from eao_fusion_tpu_torch.tools import train_vocab
    scenes = dict(styles=("arc",), textures=("blocky",), seeds=(100, 101),
                  n_frames=8)
    quiet = lambda *a: None
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        descs = train_vocab.gather_descriptors(**scenes, device="cuda",
                                               cache_dir=tmp)
        gather_s = time.perf_counter() - t
        X = np.concatenate(descs).astype(np.float32)
        t = time.perf_counter()
        words = train_vocab.kmeans_words(X, 1024, 15,
                                         np.random.default_rng(0),
                                         device="cuda", log=quiet)
        idf = train_vocab.idf_weights(descs, words, device="cuda")
        card_s = time.perf_counter() - t
        t = time.perf_counter()
        words_cpu = train_vocab.kmeans_words(X, 1024, 15,
                                             np.random.default_rng(0),
                                             device="cpu", log=quiet)
        idf_cpu = train_vocab.idf_weights(descs, words_cpu, device="cpu")
        cpu_s = time.perf_counter() - t
        out = os.path.join(tmp, "vocab.npz")
        t = time.perf_counter()
        res = train_vocab.main(["--words", "1024", "--styles", "arc",
                                "--textures", "blocky", "--seeds", "100",
                                "101", "--frames", "8", "--cache-dir", tmp,
                                "--out", out])
        cli_s = time.perf_counter() - t
        v = vocabulary.Vocabulary.load(out, device="cuda")
        cli_same = bool(np.array_equal(v.words.cpu().numpy(),
                                       words.astype(np.int8)))
    log("vocabulary: " + json.dumps({
        "descriptors": int(len(X)), "images": len(descs),
        "gather_s": gather_s, "kmeans_idf_card_s": card_s,
        "kmeans_idf_cpu_s": cpu_s, "command_line_s": cli_s,
        "command_line_words_equal_the_phase": cli_same,
        "idf_max_diff": float(np.abs(idf - idf_cpu).max())}))
    if not (np.array_equal(words, words_cpu)
            and np.abs(idf - idf_cpu).max() <= 1e-6):
        raise AssertionError("the card's vocabulary differs from the CPU's")
    if v.n_words != 1024 or res["descriptors"] != len(X):
        raise AssertionError(f"the command line wrote {v.n_words} words "
                             f"from {res['descriptors']} descriptors")
    return {"card_s": card_s, "cpu_s": cpu_s, "command_line_s": cli_s}


# ------------------------------------------------------------ sharded step
# Phase 24: the steady step with the map held in row blocks over an
# (lm, kf) mesh of ranks that share the card (`parallel/sharded_step.py`),
# against the unsharded step on the same handed-over state.

SHARDED_MESHES = (("gloo", (2, 1)), ("gloo", (2, 2)), ("nccl", (1, 1)))


def _save_steady(tmp, s, cfg, frames) -> None:
    """A warmed System's state for the ranks (the `io/checkpoint` npz and
    its generator's state beside it) and the frames they run (images,
    padded box tables, timestamps)."""
    from eao_fusion_tpu_torch.io import checkpoint
    checkpoint.save_state(os.path.join(tmp, "steady.npz"), s)
    np.save(os.path.join(tmp, "steady_gen.npy"),
            s.generator.get_state().numpy())
    bx = np.zeros((len(frames), cfg.objects.max_objects_2d, 6), np.float32)
    for i, f in enumerate(frames):
        b = np.asarray(f.boxes, np.float32)[:bx.shape[1]]
        bx[i, :len(b)] = b
    np.savez(os.path.join(tmp, "frames.npz"),
             gray=np.stack([f.gray for f in frames]),
             depth=np.stack([f.depth for f in frames]), boxes=bx,
             ts=np.array([f.timestamp for f in frames], np.float32))


def _load_steady(tmp, cfg):
    """(the steady carry restored from `_save_steady` on the card, the
    frames as card tensors); the same bits in every process."""
    import torch
    from eao_fusion_tpu_torch.io import checkpoint
    from eao_fusion_tpu_torch.pipeline import steady
    from eao_fusion_tpu_torch.pipeline.system import System
    s = System(cfg.replace(use_loop_closing=False))
    checkpoint.load_state(os.path.join(tmp, "steady.npz"), s)
    s.generator.set_state(torch.from_numpy(
        np.load(os.path.join(tmp, "steady_gen.npy"))))
    z = np.load(os.path.join(tmp, "frames.npz"))
    frames = [(torch.as_tensor(z["gray"][t], device="cuda"),
               torch.as_tensor(z["depth"][t], device="cuda"),
               torch.as_tensor(z["boxes"][t], device="cuda"),
               float(z["ts"][t])) for t in range(len(z["ts"]))]
    return steady.init_steady_state(s), frames


def _map_bytes(m) -> int:
    return sum(t.numel() * t.element_size() for t in m)


def _run_frames(step, st, frames, maps=None, check=None):
    """Drive `step` over the frames, each timed on the host clock between
    synchronizations, the launch counts set to 0 just before and read just
    after. Returns (state, per-frame record, counts); `check(state)` runs
    after each frame, outside the timing."""
    import torch
    from eao_fusion_tpu_torch import kernels
    per = {k: [] for k in ("ms", "kf_inserted", "n_inliers", "pose",
                           "calls", "bytes", "coll_ms")}
    torch.cuda.synchronize()
    kernels.reset_launches()
    for frame in frames:
        c0 = (maps.calls, maps.bytes, maps.ms) if maps else (0, 0, 0.0)
        t = time.perf_counter()
        st, diag = step(st, *frame)
        torch.cuda.synchronize()
        per["ms"].append((time.perf_counter() - t) * 1e3)
        c1 = (maps.calls, maps.bytes, maps.ms) if maps else (0, 0, 0.0)
        for k, a, b in zip(("calls", "bytes", "coll_ms"), c0, c1):
            per[k].append(b - a)
        per["kf_inserted"].append(bool(diag["kf_inserted"]))
        per["n_inliers"].append(int(diag["n_inliers"]))
        per["pose"].append(st.ts.pose.cpu().numpy())
        if check is not None:
            check(st)
    counts = dict(kernels.launches)
    return st, {k: np.asarray(v) for k, v in per.items()}, counts


def _steady_record(st) -> dict:
    """The final map and object table of a steady carry, as arrays."""
    from eao_fusion_tpu_torch.types import tree_to_numpy
    out = {f"map.{k}": v for k, v in tree_to_numpy(st.m).items()}
    out.update({f"objs.{k}": v for k, v in tree_to_numpy(st.objs).items()})
    out["kp_pt"] = st.ts.kp_pt.cpu().numpy()
    return out


def _sharded_rank(rank, world, backend, shape, tmp):
    """Phase 24's rank: the sharded steady step on a `shape` mesh of ranks
    sharing the card, from the handed-over state, every frame timed (the
    collectives too: `ShardedMap.timed`) and the replicated state checked
    across the ranks after it. Each rank writes its launches, block
    shapes, resident and peak bytes; rank 0 the per-frame record and the
    gathered final state."""
    import torch
    import torch.distributed as dist
    from eao_fusion_tpu_torch.config import tum_fr3_config
    from eao_fusion_tpu_torch.parallel import mesh, sharded_step
    tag = f"{backend}{shape[0]}x{shape[1]}"
    _join_group(rank, world, os.path.join(tmp, f"store_{tag}"), backend)
    cfg = tum_fr3_config()
    dm = mesh.make_mesh(*shape, device_type="cuda")
    st, frames = _load_steady(tmp, cfg)
    whole_bytes = _map_bytes(st.m)
    sst = sharded_step.shard_state(st, dm)
    del st
    step = sharded_step.make_sharded_slam_step(dm, cfg)
    sst.maps.timed = True
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    sst, per, counts = _run_frames(step, sst, frames, sst.maps,
                                   sharded_step.assert_replicated)
    m = sst.m
    info = {"launches": counts, "coord": list(sst.maps.coord),
            "pt_rows": m.pt_xyz.shape[0], "kf_rows": m.kf_pose.shape[0],
            "obs_block": list(m.obs_ind.shape),
            "resident_bytes": _map_bytes(m), "whole_map_bytes": whole_bytes,
            "peak_bytes": torch.cuda.max_memory_allocated()}
    with open(os.path.join(tmp, f"{tag}_{rank}.json"), "w") as f:
        json.dump(info, f)
    whole = sharded_step.unshard_state(sst)
    if rank == 0:
        np.savez(os.path.join(tmp, f"{tag}.npz"),
                 **{f"per.{k}": v for k, v in per.items()},
                 **_steady_record(whole))
    dist.destroy_process_group()


def _medians(per) -> dict:
    """Medians of the tracked (no keyframe) and the keyframe frames."""
    kf = per["kf_inserted"].astype(bool)

    def med(k, sel):
        return float(np.median(per[k][sel])) if sel.any() else None
    return {f"{k}_{part}": med(k, sel) for k in ("ms", "calls", "bytes",
                                                 "coll_ms")
            for part, sel in (("tracked", ~kf), ("keyframe", kf))}


def phase_sharded_step(smi_line: str):
    """Phase 24: the steady cell's configuration, `tum_fr3_config()` at
    full width (planes, objects with the renderer's boxes): rank 0 warms a
    System with `process_frame` on 8 frames of the 20-frame arc, as phase
    14, and hands its state over in an npz; then the other 12 frames run
    (a) through the unsharded `steady.slam_step` here, (b) through
    `make_sharded_slam_step` on 2 gloo ranks sharing the card (mesh
    2 x 1), (c) on 4 gloo ranks (2 x 2), (d) on a 1-rank NCCL group
    (1 x 1). (b)-(d) must give (a)'s bits in every frame's pose, keyframe
    decision and inliers and in the gathered final map and object table;
    at least one keyframe; every rank (a)'s launch counts (K1 twice a
    frame, K4 as often as K2) and the blocks P / n_lm point rows, K / n_kf
    keyframe rows, [K / n_kf, P / n_lm] of obs_ind. Prints the ms per
    frame (tracked and keyframe medians), the collectives' calls, bytes
    and ms, and each rank's resident and peak map bytes."""
    import tempfile
    import torch
    from eao_fusion_tpu_torch.config import tum_fr3_config
    from eao_fusion_tpu_torch.pipeline import steady
    from eao_fusion_tpu_torch.pipeline.system import System
    cfg = tum_fr3_config()
    P, K = cfg.capacity.max_points, cfg.capacity.max_keyframes
    seq = _arc(N_FRAMES, cfg)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        s = System(cfg)
        for f in seq.frames[:STEADY_WARM]:
            s.process_frame(f.gray, f.depth, f.timestamp, boxes=f.boxes)
        s._poll_gba(blocking=True)
        _save_steady(tmp, s, cfg, seq.frames[STEADY_WARM:])
        del s
        st, frames = _load_steady(tmp, cfg)
        step = functools.partial(steady.slam_step, cfg=cfg)
        st, ref, ref_counts = _run_frames(step, st, frames)
        ref_rec = _steady_record(st)
        del st
        out["a"] = dict(_medians(ref), launches=ref_counts)
        if ref["kf_inserted"].sum() < 1:
            raise AssertionError("no keyframe inserted in the 12 frames")
        _check_launches(ref_counts, len(frames), 0)
        for (backend, shape), name in zip(SHARDED_MESHES, "bcd"):
            n_lm, n_kf = shape
            tag = f"{backend}{n_lm}x{n_kf}"
            t = time.perf_counter()
            run_ranks(_sharded_rank, n_lm * n_kf, (backend, shape, tmp))
            wall = time.perf_counter() - t
            z = dict(np.load(os.path.join(tmp, f"{tag}.npz")))
            per = {k[4:]: v for k, v in z.items() if k.startswith("per.")}
            infos = [json.load(open(os.path.join(tmp, f"{tag}_{r}.json")))
                     for r in range(n_lm * n_kf)]
            out[name] = dict(
                _medians(per), mesh=tag, wall_s_with_start_up=wall,
                bytes_per_frame=per["bytes"].tolist(),
                calls_per_frame=per["calls"].tolist(),
                resident_bytes=[i["resident_bytes"] for i in infos],
                whole_map_bytes=infos[0]["whole_map_bytes"],
                peak_bytes=[i["peak_bytes"] for i in infos])
            for k in ("kf_inserted", "n_inliers"):
                if not np.array_equal(per[k], ref[k]):
                    raise AssertionError(f"{tag}: {k} {per[k].tolist()} "
                                         f"against {ref[k].tolist()}")
            if not np.array_equal(per["pose"].view(np.int32),
                                  ref["pose"].view(np.int32)):
                bad = np.nonzero((per["pose"] != ref["pose"]).any(1))[0]
                raise AssertionError(f"{tag}: poses differ from frame "
                                     f"{int(bad[0])}")
            differ = [k for k in ref_rec if not np.array_equal(
                np.asarray(z[k]).reshape(-1).view(np.uint8),
                np.asarray(ref_rec[k]).reshape(-1).view(np.uint8))]
            if differ:
                raise AssertionError(f"{tag}: the gathered state differs "
                                     f"in {differ}")
            for r, i in enumerate(infos):
                if i["launches"] != ref_counts:
                    raise AssertionError(f"{tag} rank {r}: launches "
                                         f"{i['launches']}, unsharded "
                                         f"{ref_counts}")
                if (i["pt_rows"] != P // n_lm or i["kf_rows"] != K // n_kf
                        or i["obs_block"] != [K // n_kf, P // n_lm]):
                    raise AssertionError(f"{tag} rank {r} holds {i}")
    log("sharded step (24): " + json.dumps({
        **out, "frames": len(frames), "keyframes":
            int(ref["kf_inserted"].sum()), "card": smi_line}))
    return out


# ---------------------------------------------- phases 25-29: the contracts
# of the JAX package's long-run and sensor-robustness tests
# (tests/torch_contracts.py states their configurations and bounds)

@functools.lru_cache(maxsize=None)
def _repo_module(subdir: str, name: str):
    """A torch-only module of this repository's tests/ or dev/, loaded from
    its file: a package called `tests` may be installed on the machine and
    would shadow the repository's, and neither directory goes on
    sys.path."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), subdir,
                        name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tests_module(name: str):
    return _repo_module("tests", name)


SYNTH_CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "synth_cache")
RENDER_WORKERS = 8


@functools.lru_cache(maxsize=None)
def _contract_inputs():
    """Every sequence of phases 25-31, rendered once per run: the noiseless
    ones in one pool of spawned processes (`synthetic.render_sequences`,
    kept under build/synth_cache), the whole 625-frame tour among them,
    the depth-noise arc serially. Three pooled tour frames (the first, the
    endurance contract's last and the lap's last) are held to a serial
    render."""
    from eao_fusion_tpu_torch.io import synthetic
    C = _tests_module("torch_contracts")
    H = _tests_module("torch_retrieval_harness")
    specs = {"tour": C.TOUR_SPEC, "corridor": C.EXPLORATION_SPEC,
             "corridor_full": C.CORRIDOR_SPEC, "forward": C.FORWARD_SPEC,
             "arc20": dict(n_frames=N_FRAMES, seed=SEED, style="arc"),
             "arc24ct": dict(n_frames=24, seed=SEED, style="arc",
                             class_textures=True)}
    spins = H.scene_specs()
    t = time.perf_counter()
    seqs = synthetic.render_sequences(list(specs.values()) + spins,
                                      workers=RENDER_WORKERS,
                                      cache_dir=SYNTH_CACHE)
    n = sum(len(q.frames) for q in seqs)
    log(f"contracts: rendered {n} frames of {len(seqs)} sequences in "
        f"{time.perf_counter() - t:.1f} s (host, {RENDER_WORKERS} "
        f"processes)")
    out = dict(zip(specs, seqs))
    out["spins"] = seqs[len(specs):]
    t = time.perf_counter()
    out["arc12n"] = C.depth_noise_arc()
    log(f"contracts: rendered the 12-frame depth-noise arc in "
        f"{time.perf_counter() - t:.1f} s (host, serial)")
    tour = out["tour"]
    for i in (0, C.ENDURANCE_FRAMES - 1, len(tour.frames) - 1):
        g, d = synthetic.render_frame(tour.scene, tour.camera,
                                      tour.frames[i].tcw)
        if not (np.array_equal(g, tour.frames[i].gray)
                and np.array_equal(d, tour.frames[i].depth)):
            raise AssertionError(f"pooled tour frame {i} differs from a "
                                 f"serial render")
    return out


def _occupancy_log(tag, n_frames, marks, every: int = 50):
    """An `on_frame` that prints the table occupancy every `every` frames
    and after the last, and notes the peak memory after frame 100."""
    import torch
    C = _tests_module("torch_contracts")

    def on_frame(s, i):
        if (i + 1) % every == 0 or i + 1 == n_frames:
            log(f"{tag} occupancy: " + json.dumps(C.occupancy(s)))
        if i + 1 == 100:
            marks["max_memory_allocated_mb_frame_100"] = (
                torch.cuda.max_memory_allocated() / 2 ** 20)
    return on_frame


def _contract_run(cfg, seq, tag, check, on_frame=None, **kw):
    """`run_system` on the card, the contract's `check(s)` and the launch
    rule; returns the System, its summary and the check's values."""
    s, summary, counts = run_system(cfg, seq, tag, on_frame=on_frame,
                                    frame_log=len(seq.frames) <= 40, **kw)
    out = check(s)
    _check_launches(counts, summary["tracked_frames"],
                    summary.get("reloc_pose_solves", 0))
    log(f"{tag} contract: " + json.dumps(out))
    return s, summary, out


def phase_lifecycle(smi_line: str, keep: dict = None):
    """Phase 25: the keyframe and point tables over hundreds of frames,
    loop closing on. (a) Endurance: frames 0-505 of the 625-frame seed-0
    tour into 24 keyframe and 3072 point slots (tests/test_endurance.py);
    (b) exploration: the 240-frame seed-5 corridor at 320x240, a keyframe
    at least every 6 frames (tests/test_kf_lifecycle.py:185-215). The
    occupancy every 50 frames, the median tracking and keyframe frame ms,
    the peak memory after frame 100 and at the end. `keep["exploration"]`
    receives (b)'s System, which phase 31a drives on."""
    C = _tests_module("torch_contracts")
    t0 = time.perf_counter()
    inp = _contract_inputs()
    out = {}
    endurance = C.endurance_sequence(inp["tour"])
    for tag, cfg, seq, check in (
            ("endurance", C.endurance_cfg(), endurance,
             lambda s: dict(C.check_endurance(s, endurance),
                            bow_rows_checked=C.check_bow_rows(s))),
            ("exploration", C.exploration_cfg(), inp["corridor"],
             lambda s: dict(C.check_exploration(s, inp["corridor"]),
                            bow_rows_checked=C.check_bow_rows(s)))):
        t = time.perf_counter()
        marks = {}
        s, summary, res = _contract_run(
            cfg, seq, tag, check, corrected=True,
            on_frame=_occupancy_log(tag, len(seq.frames), marks))
        if keep is not None and tag == "exploration":
            keep[tag] = s
        out[tag] = dict(res, **marks, wall_s=time.perf_counter() - t,
                        **{k: summary[k] for k in (
                            "median_tracking_frame_ms",
                            "median_keyframe_frame_ms",
                            "max_memory_allocated_mb", "launches")})
        log(f"{tag}: " + json.dumps(out[tag]))
    log(f"phase 25 (lifecycle) wall {time.perf_counter() - t0:.1f} s; "
        f"{smi_line}")
    return out


def phase_compaction_culling(smi_line: str):
    """Phase 26: (a) point compaction inside `process_frame` with objects
    on (offline boxes), 64 keyframe and 1024 point slots, loop closing
    off, on the 20-frame arc (tests/test_compaction.py:15-37); (b)
    `cull_keyframes` on the redundant map of tests/test_compaction.py:
    74-86 on the card, the same keyframes as on the CPU and the JAX
    tests' survivors."""
    C = _tests_module("torch_contracts")
    t0 = time.perf_counter()
    seq = _contract_inputs()["arc20"]
    next_pts, marks = [], {}
    occ = _occupancy_log("compaction", len(seq.frames), marks)

    def on_frame(s, i):
        next_pts.append(int(s.map.next_pt))
        occ(s, i)
    _, summary, res = _contract_run(
        C.compaction_cfg(), seq, "compaction inside process_frame",
        lambda s: C.check_compaction(s, seq, next_pts), on_frame=on_frame,
        boxes=True)
    log("culling, card against CPU: " + json.dumps(C.check_cull_on("cuda")))
    out = dict(res, median_tracking_frame_ms=summary[
        "median_tracking_frame_ms"], median_keyframe_frame_ms=summary[
        "median_keyframe_frame_ms"], max_memory_allocated_mb=summary[
        "max_memory_allocated_mb"], wall_s=time.perf_counter() - t0)
    log("phase 26 (compaction and culling): " + json.dumps(out)
        + f"; {smi_line}")
    return out


def phase_nuisance(smi_line: str):
    """Phase 27: the nuisance suite of tests/test_nuisance_e2e.py on the
    card: RGBD under each of the five profiles, mono under `combo`, BoW
    retrieval of `combo` views against the clean map, and the detector's
    recall under `combo`."""
    from eao_fusion_tpu_torch.io import synthetic
    C = _tests_module("torch_contracts")
    t0 = time.perf_counter()
    inp = _contract_inputs()
    seq = inp["arc20"]
    out = {}
    for profile in sorted(C.RGBD_FLOORS):
        nseq = synthetic.nuisance_sequence(seq, profile, seed=0)
        _, _, out[profile] = _contract_run(
            C.nuisance_cfg(), nseq, f"nuisance {profile}",
            lambda s, q=nseq, p=profile: C.check_rgbd_nuisance(s, q, p))
    combo = synthetic.nuisance_sequence(seq, "combo", seed=0)
    _, _, out["mono_combo"] = _contract_run(
        C.nuisance_mono_cfg(), combo, "nuisance mono combo",
        lambda s: C.check_mono_nuisance(s, seq), mono=True)
    _, _, out["retrieval_combo"] = _contract_run(
        C.nuisance_cfg(), seq, "nuisance retrieval (clean map)",
        lambda s: C.check_retrieval_nuisance(s, combo))
    out["detector_combo"] = C.check_detector_nuisance("cuda",
                                                      inp["arc24ct"])
    log("nuisance detector: " + json.dumps(out["detector_combo"]))
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 27 (nuisance) wall {out['wall_s']:.1f} s; {smi_line}")
    return out


def phase_crowded_retrieval(smi_line: str):
    """Phase 28: the crowded 256-keyframe BoW database of
    tests/test_retrieval_stress.py through the port's harness
    (tests/torch_retrieval_harness.py), extracted and scored on the card;
    the harness's whole dict and its floors."""
    H = _tests_module("torch_retrieval_harness")
    t0 = time.perf_counter()
    spins = _contract_inputs()["spins"]
    db = H.build_retrieval_db(spins, device="cuda")
    m = H.measure_retrieval(db, device="cuda")
    log("crowded retrieval: " + json.dumps(m))
    H.check_floors(m)
    log(f"phase 28 (crowded retrieval) wall "
        f"{time.perf_counter() - t0:.1f} s; {smi_line}")
    return m


def phase_odometry(smi_line: str):
    """Phase 29: tests/test_tracking_e2e.py's two short uncached contracts:
    the 15-frame seed-3 forward run (ATE < 3 cm) and the 12-frame seed-5
    arc with 1 cm depth noise (ATE < 5 cm), `small_cfg`."""
    C = _tests_module("torch_contracts")
    t0 = time.perf_counter()
    inp = _contract_inputs()
    out = {}
    for tag, seq, bound_m in (("forward", inp["forward"], 0.03),
                              ("depth noise", inp["arc12n"], 0.05)):
        _, _, out[tag] = _contract_run(
            C.odometry_cfg(), seq, f"odometry {tag}",
            lambda s, q=seq, b=bound_m: C.check_odometry(s, q, b))
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 29 (odometry) wall {out['wall_s']:.1f} s; {smi_line}")
    return out


# ------------------------ phase 30: the fr3-scale production run of the
# JAX package (dev/run_fr3_scale.py) through dev/torch_run_fr3_scale.py

FR3_LAPS = 2
FR3_CHUNK = 8


def _loop_after_compaction(ev: dict) -> bool:
    """A loop closed at a chunk boundary after the first keyframe
    compaction (`run_scale`'s event log)."""
    first = ev["kf_compaction"][0] if ev["kf_compaction"] else None
    return first is not None and any(isinstance(c, int) and c > first
                                     for c in ev["loop"])


def check_fr3_scale(out: dict, cap) -> None:
    """The bounds of phase 30 on `run_scale`'s record (`cap`, the map
    capacity): no reset; a loop closed and a GBA merged; both tables
    compacted, more lifetime keyframe insertions than slots, the live
    keyframes and points within their tables; a loop closed at a chunk
    boundary after the first keyframe compaction; the whole run's raw ATE
    under 5 cm (VERDICT.md's target; the JAX record on these frames, 4.08
    cm), the corrected ATE finite and at most 0.5 cm over the raw (phase
    12's bound), no live keyframe over 50 cm from its ground truth at the
    end; the launch rule of the chunked part."""
    ev = out["events"]
    fails = []
    if out["n_resets"]:
        fails.append(f"{out['n_resets']} resets")
    if out["loops_closed"] < 1 or out["gba_merges"] < 1:
        fails.append("no loop closed or no GBA merged")
    if out["kf_compactions"] < 1 or out["pt_compactions"] < 1:
        fails.append("a table never compacted")
    if not out["lifetime_kf_insertions"] > cap.max_keyframes:
        fails.append(f"{out['lifetime_kf_insertions']} lifetime keyframe "
                     f"insertions (> {cap.max_keyframes})")
    if not (out["peak_kf_live"] <= cap.max_keyframes
            and out["peak_points"] <= cap.max_points):
        fails.append("live keyframes or points over their table")
    if not _loop_after_compaction(ev):
        fails.append(f"no loop closed at a chunk boundary after the first "
                     f"keyframe compaction (loops at {ev['loop']}, "
                     f"compactions at {ev['kf_compaction']})")
    raw, cor = out["ate_cm"], out["ate_corrected_cm"]
    if not raw < 5.0:
        fails.append(f"raw ATE {raw:.3f} cm (< 5)")
    if not (np.isfinite(cor) and cor <= raw + 0.5):
        fails.append(f"corrected ATE {cor:.3f} cm (<= raw + 0.5)")
    if out["kf_gt_err_cm"]["over_50"]:
        fails.append(f"{out['kf_gt_err_cm']['over_50']} live keyframes "
                     f"over 50 cm from their ground truth (the farthest "
                     f"{out['kf_gt_err_cm']['max']:.1f} cm)")
    if fails:
        raise AssertionError("fr3 scale: " + "; ".join(fails))
    _check_launches(out["launches"], out["chunked_frames"],
                    out["reloc_pose_solves"])


def phase_fr3_scale(smi_line: str):
    """Phase 30: the JAX package's fr3-scale production run on the port:
    FR3_LAPS replays (FR3_LAPS + 1 when no loop closes after the first
    keyframe compaction) of the whole 625-frame seed-0 tour (the pooled
    render of phases 25-29), the JAX script's configuration (planes,
    objects with the renderer's boxes, loop closing; 256 keyframe and
    16384 point slots), 12 `process_frame` frames, then chunks of 8
    through `slam_chunk` and `chunk_epilogue` (`run_scale`, the launch
    counts set to 0 before the first chunk and read after the last). The
    bounds of `check_fr3_scale`, and the loop closer's bow rows after the
    run's remaps; prints the record, the determinism line (the chunk whose
    epilogue launched the first GBA and a digest of the raw poses up to
    it, so that two calls compare from their output), the median chunk
    and epilogue ms and the card."""
    from eao_fusion_tpu_torch.pipeline.system import System
    R = _repo_module("dev", "torch_run_fr3_scale")
    C = _tests_module("torch_contracts")
    t0 = time.perf_counter()
    tour = _contract_inputs()["tour"]
    cfg = R.scale_cfg()
    if not (cfg.use_planes and cfg.use_objects and cfg.use_loop_closing):
        raise AssertionError("the fr3-scale configuration has planes, "
                             "objects or loop closing off")
    for laps in (FR3_LAPS, FR3_LAPS + 1):
        s = System(cfg)
        if s.device.type != "cuda":
            raise AssertionError(f"System runs on {s.device}, not on the "
                                 f"card")
        chunks = R.ChunkLog(s)
        out = R.run_scale(s, tour, laps, FR3_CHUNK,
                          progress=lambda m: log(f"fr3 scale: {m}"),
                          on_chunk=chunks)
        if _loop_after_compaction(out["events"]):
            break
        log(f"phase 30 (fr3 scale): no loop after the first keyframe "
            f"compaction in {laps} laps ({out['events']}); once more, "
            f"{laps + 1} laps")
    out["bow_rows_checked"] = C.check_bow_rows(s)
    out["loop_stats"] = dict(s.loop_closer.stats)
    out["laps"] = laps
    out["wall_s"] = time.perf_counter() - t0
    log("fr3 scale (phase 30): " + json.dumps(out, default=float))
    log(f"phase 30 (fr3 scale): raw ATE {out['ate_cm']:.3f} cm, corrected "
        f"{out['ate_corrected_cm']:.3f}, per lap {out['lap_ate_cm']}, live "
        f"keyframes from their ground truth {out['kf_gt_err_cm']} cm; the "
        f"JAX package on the same frames: 4.08 cm (TPU, "
        f"dev/fr3_r5_prewarmfix_2lap.json)")
    first_gba = chunks.first_gba_launch()
    log("phase 30 (fr3 scale) determinism: " + json.dumps(dict(
        first_gba_launch_chunk=first_gba,
        raw_pose_digest_to_first_gba=(None if first_gba is None
                                      else chunks.pose_digest(first_gba)),
        raw_pose_digest=chunks.pose_digest(), loops=out["events"]["loop"],
        gba_merges=out["events"]["gba_merge"])))
    log(f"phase 30 (fr3 scale): median chunk of {FR3_CHUNK} "
        f"{out['median_chunk_ms']:.2f} ms, median epilogue "
        f"{out['median_epilogue_ms']:.2f} ms, p50 / p99 / max frame "
        f"{out['p50_frame_ms']:.2f} / {out['p99_frame_ms']:.2f} / "
        f"{out['max_frame_ms']:.2f} ms, wall {out['wall_s']:.1f} s; "
        f"{smi_line}")
    check_fr3_scale(out, cfg.capacity)
    return out


# ---------------------------------------------- phase 31: the kidnap, a
# loss in a region that capacity eviction removed and the return into the
# live map (tests/torch_contracts.py, the kidnap contract)

def _kidnap_inputs():
    """Phase 31's two corridors alone (one pool), for phase 31 run alone."""
    from eao_fusion_tpu_torch.io import synthetic
    C = _tests_module("torch_contracts")
    seqs = synthetic.render_sequences([C.EXPLORATION_SPEC, C.CORRIDOR_SPEC],
                                      workers=RENDER_WORKERS,
                                      cache_dir=SYNTH_CACHE)
    return dict(zip(("corridor", "corridor_full"), seqs))


def _kidnap_contract(s, seq, recs, n_pass, chunked, counts, tracked,
                     solves, resets0, **kw) -> dict:
    """The kidnap contract on a recording, the launch rule of the run and
    the loop closer's bow rows after it."""
    C = _tests_module("torch_contracts")
    out = C.check_kidnap_run(s, seq, recs, n_pass, chunked,
                             resets_before=resets0, **kw)
    _check_launches(counts, tracked, solves)
    out["bow_rows_checked"] = C.check_bow_rows(s)
    out["launches"] = counts
    out["tracked_frames"] = tracked
    out["reloc_pose_solves"] = solves
    return out


def phase_kidnap(smi_line: str, exploration=None, inputs=None):
    """Phase 31: the kidnap contract (`tests/torch_contracts.py`): the pass
    evicts, the kidnap jumps back to the corridor's first 24 frames, whose
    keyframes eviction removed, the return jumps to frames `back` ..
    `back` + 47 of the live map; nothing new is rendered for them. The
    premise (`check_kidnap`) is asserted and printed after the pass, then
    BoW relocalization itself of the return's first frame against the map
    (`probe_relocalization`: it must land within 5 cm and 0.05 rad), then
    the contract over the kidnap and the return (`check_kidnap_run`, (a)-
    (f)) and the launch rule (g), the counts set to 0 just before the
    driven frames and read just after; the loop closer's bow rows after
    the return. `inputs` holds the two corridors (`_contract_inputs`;
    None renders them). (a) 31a: phase 25b's System (`exploration`; or a
    new run of it) continues through `process_frame`, back = 192. (b) 31b: full width,
    `kidnap_cfg()` (the fr3-scale configuration with 64 keyframe and 8192
    point slots, a keyframe at least every 6 frames), the 640x480 seed-5
    corridor with the renderer's boxes, 8 `process_frame` frames, then
    chunks of 8 through `slam_chunk` and `chunk_epilogue`, back = 120.
    Prints the ms of a lost frame (tracking and `relocalize`) or of a
    relocalizing epilogue, the recovery point and the live objects before
    and after the kidnap."""
    import torch
    from eao_fusion_tpu_torch import kernels
    from eao_fusion_tpu_torch.pipeline.system import System
    C = _tests_module("torch_contracts")
    sync = torch.cuda.synchronize
    out = {}

    # 31a: the exploration scale, through process_frame
    t0 = time.perf_counter()
    inputs = inputs or _kidnap_inputs()
    corridor = inputs["corridor"]
    s = exploration
    if s is None:
        s, _, _ = _contract_run(C.exploration_cfg(), corridor,
                                "exploration",
                                lambda s: C.check_exploration(s, corridor))
    n = len(corridor.frames)
    seq = C.kidnap_sequence(corridor, back=C.BACK_EXPLORATION)
    premise = C.check_kidnap(s, seq, n)
    log("kidnap (31a) premise: " + json.dumps(premise))
    align = C.pass_alignment(s, seq, n)
    probe = C.probe_relocalization(s, seq, n + C.KIDNAP_FRAMES, align)
    log("kidnap (31a) BoW relocalization of the return's first frame: "
        + json.dumps(probe))
    objects0 = int(s.objects.valid.sum())
    tracked0, solves0 = len(s.diags), s.reloc_stats.get("pose_solves", 0)
    resets0 = s.n_resets
    sync()
    kernels.reset_launches()
    recs = C.run_kidnap_frames(s, seq, n, sync=sync)
    counts = dict(kernels.launches)
    # (e1) stands missed: the tracker's own search brings the JAX
    # package's return back too, with no relocalization
    # (tests/test_torch_kidnap.py::test_kidnap_matches_jax_system)
    res = _kidnap_contract(
        s, seq, recs, n, False, counts, len(s.diags) - tracked0,
        s.reloc_stats.get("pose_solves", 0) - solves0, resets0,
        standing=("(e1)",))
    res.update(premise=premise, probe=probe, objects_before=objects0,
               objects_after=int(s.objects.valid.sum()),
               wall_s=time.perf_counter() - t0)
    out["31a"] = res
    log("kidnap (31a): " + json.dumps(res, default=float))
    _check_probe(probe)

    # 31b: full width, through the chunked loop
    t0 = time.perf_counter()
    corridor = inputs["corridor_full"]
    n = len(corridor.frames)
    seq = C.kidnap_sequence(corridor, back=C.BACK_SCALE)
    s = System(C.kidnap_cfg())
    if s.device.type != "cuda":
        raise AssertionError(f"System runs on {s.device}, not on the card")
    marks = {}

    def on_chunk(ci, st):
        end = C.CHUNK_WARM + (ci + 1) * C.CHUNK
        if end == n:
            # the full-width pass keeps the corridor's first keyframe
            # (ROADMAP queue 3): the premise is printed, not asserted
            marks["premise"] = C.check_kidnap(s, seq, n, strict=False)
            log("kidnap (31b) premise: " + json.dumps(marks["premise"]))
            marks["objects_before"] = int(s.objects.valid.sum())
            marks["probe"] = C.probe_relocalization(
                s, seq, n + C.KIDNAP_FRAMES, C.pass_alignment(s, seq, n))
            log("kidnap (31b) BoW relocalization of the return's first "
                "frame: " + json.dumps(marks["probe"]))
        elif end == n + C.KIDNAP_FRAMES:
            marks["objects_after"] = int(s.objects.valid.sum())

    sync()
    kernels.reset_launches()
    for f in seq.frames[:C.CHUNK_WARM]:
        s.process_frame(f.gray, f.depth, f.timestamp, boxes=f.boxes)
    recs = C.run_kidnap_chunks(s, seq, C.CHUNK_WARM, boxes=True, sync=sync,
                               on_chunk=on_chunk)
    counts = dict(kernels.launches)
    # the probe's pose solves launched K1 too, between two chunks
    solves = (s.reloc_stats.get("pose_solves", 0)
              + marks["probe"]["pose_solves"])
    # (b) and (e1) stand missed at full width: from the same state the
    # JAX package's return also reports OK over 5 cm from the truth, and
    # comes back by the tracker's own search
    # (tests/test_torch_kidnap.py::test_kidnap_return_from_one_state;
    # ROADMAP queue 3), so a miss is printed, not raised
    res = _kidnap_contract(s, seq, recs, n, True, counts, len(s.diags),
                           solves, 0, min_inliers_end=80,
                           standing=("(b)", "(e1)"))
    res.update(marks,
               median_chunk_ms=float(np.median([r["ms"] for r in recs])),
               median_epilogue_ms=float(np.median(
                   [r["epilogue_ms"] for r in recs])),
               wall_s=time.perf_counter() - t0)
    out["31b"] = res
    log("kidnap (31b): " + json.dumps(res, default=float))
    _check_probe(marks["probe"])
    for tag, r in out.items():
        if r["standing"]:
            log(f"phase 31 ({tag}): missed, standing (the JAX package "
                f"misses them from the same state): {r['standing']}; "
                f"{len(r['wrong_ok_frames'])} frames OK over 5 cm or 0.05 "
                f"rad, the farthest {r['max_ok_error_cm']:.2f} cm")
        log(f"phase 31 ({tag}): recovery {r['recovery']} by "
            f"{r['recovered_by']}, {r['return_relocalizations']} "
            f"relocalizations in the return, lost frames {r['lost_frames']}, "
            f"return ATE {r['return_ate_cm']:.3f} cm, max OK error "
            f"{r['max_ok_error_cm']:.3f} cm; objects "
            f"{r['objects_before']} -> {r['objects_after']}; wall "
            f"{r['wall_s']:.1f} s; {smi_line}")
    return out


def _check_probe(probe: dict) -> None:
    """BoW relocalization of the return's first frame lands within 5 cm
    and 0.05 rad of its truth."""
    if not (probe["found"] and probe["error_cm"] < 5.0
            and probe["error_rad"] < 0.05):
        raise AssertionError(f"BoW relocalization into the live map: "
                             f"{probe}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    try:
        from eao_fusion_tpu_torch import kernels
        from eao_fusion_tpu_torch.config import SolverConfig
    except ImportError as e:
        print(f"chip_smoke: the port package is missing ({e})",
              file=sys.stderr)
        return 2
    try:
        dev = torch.device("cuda")
        name = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
        smi_line = smi[0] if smi else "nvidia-smi: no output"
        log(f"device: {name} x{count}; torch {torch.__version__}, CUDA "
            f"{torch.version.cuda}; {smi_line}")

        t0 = time.perf_counter()
        built = kernels.build_all()
        log(f"kernels built in {time.perf_counter() - t0:.1f} s: "
            + json.dumps({k: round(v, 1) for k, v in built.items()}))
        for lib in kernels.SOURCES:
            path = kernels.lib_path(lib)
            logf = kernels.BUILD_DIR / f"{path.stem}.log"
            if logf.exists():
                for line in logf.read_text().splitlines():
                    if "registers" in line or "spill" in line:
                        log(f"  {lib}: {line.strip()}")

        cfg = SolverConfig()
        k1 = phase_pose(dev, cfg)
        k2, k3 = phase_edges(dev, cfg)
        k4 = phase_chol(dev)
        phase_main_path()
        counts = phase_planes_twice()
        phase_compaction()
        obj_summary, _ = phase_objects()
        phase_detector()
        phase_online(obj_summary)
        loop_out, gba_problem = phase_loop()
        phase_relocalization()
        phase_steady(obj_summary, smi_line)
        phase_loop_chunks()
        phase_mono()
        phase_stereo()
        phase_cli(obj_summary)
        phase_training()
        phase_dist_ba(gba_problem, _loop_cfg())
        phase_loop_mesh(loop_out)
        phase_eval()
        phase_vocab()
        phase_sharded_step(smi_line)
        handed = {}
        phase_lifecycle(smi_line, keep=handed)
        phase_compaction_culling(smi_line)
        phase_nuisance(smi_line)
        phase_crowded_retrieval(smi_line)
        phase_odometry(smi_line)
        phase_fr3_scale(smi_line)
        phase_kidnap(smi_line, handed.pop("exploration"),
                     _contract_inputs())
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1

    rows = [
        dict(name="pose_opt", route="cuda",
             source="eao_fusion_tpu_torch/csrc/pose_opt.cu",
             replaces="eao_fusion_tpu/solvers/pose_opt_pallas.py:376",
             launches=counts["pose_opt"], **k1),
        dict(name="ba_edge_full", route="cuda",
             source="eao_fusion_tpu_torch/csrc/ba_edge.cu",
             replaces="eao_fusion_tpu/solvers/ba_edge_pallas.py:171",
             launches=counts["ba_edge_full"], **k2),
        dict(name="ba_edge_chi2", route="cuda",
             source="eao_fusion_tpu_torch/csrc/ba_edge.cu",
             replaces="eao_fusion_tpu/solvers/ba_edge_pallas.py:195",
             launches=counts["ba_edge_chi2"], **k3),
        dict(name="chol_solve", route="cuda",
             source="eao_fusion_tpu_torch/csrc/chol_solve.cu",
             replaces="eao_fusion_tpu/solvers/chol_pallas.py:117",
             launches=counts["chol_solve"], **k4),
    ]
    for r in rows[:3]:
        r["library_ms"] = None   # no single PyTorch call computes these
    print(json.dumps({"kernels": rows}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
