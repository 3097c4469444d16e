#!/usr/bin/env python3
"""Where the time goes on the port's main path, on one GPU.

    PYTHONPATH=. python3 dev/torch_profile_main_path.py [--frames 20] [--out FILE]

Runs the port's System over the 20-frame seed-0 synthetic arc at full
width (`tum_fr3_config`, planes / objects / loop closing off), as
`chip_smoke.py` does, and reports:
  * the host time of each stage (feature extraction, tracking, keyframe
    insertion, local mapping and, inside it, fusion and local BA), each
    call synchronized before and after;
  * over the frames after the first two, in a second run under the
    profiler, the device time of every CUDA kernel from its CUPTI trace
    (top 20 by total), and the device busy share: the summed kernel time
    over the first run's wall time for the same frames.
The stage timing synchronizes the card at every stage boundary, so its
per-frame total is somewhat above that of a run without it.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import numpy as np
import torch


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--out", default=None, help="write the report as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")

    from torch.profiler import ProfilerActivity, profile

    from eao_fusion_tpu_torch import kernels
    from eao_fusion_tpu_torch.config import tum_fr3_config
    from eao_fusion_tpu_torch.frontend import extractor
    from eao_fusion_tpu_torch.io import synthetic
    from eao_fusion_tpu_torch.pipeline import local_mapping, system, tracking
    from eao_fusion_tpu_torch.solvers import ba

    cfg = tum_fr3_config(use_planes=False, use_objects=False,
                         use_loop_closing=False)
    seq = synthetic.generate_sequence(n_frames=args.frames, seed=0,
                                      style="arc", camera=cfg.camera)
    kernels.build_all()

    stage_ms = defaultdict(list)

    def timed(name, fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            stage_ms[name].append((time.perf_counter() - t) * 1e3)
            return out
        return wrapper

    extractor.extract_features = timed("extract_features",
                                       extractor.extract_features)
    tracking.track_frame = timed("track_frame", tracking.track_frame)
    system.insert_keyframe_rgbd = timed("insert_keyframe_rgbd",
                                        system.insert_keyframe_rgbd)
    local_mapping.local_mapping_step = timed(
        "local_mapping_step", local_mapping.local_mapping_step)
    local_mapping.fuse_neighbors = timed("  fuse_neighbors",
                                         local_mapping.fuse_neighbors)
    ba.bundle_adjust_coo = timed("  bundle_adjust_coo",
                                 ba.bundle_adjust_coo)

    def run(s, frames):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for f in frames:
            s.process_frame(f.gray, f.depth, f.timestamp)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    # pass 1: stage times, no profiler (frames 0-1 warm up the card)
    s = system.System(cfg)
    run(s, seq.frames[:2])
    for v in stage_ms.values():
        v.clear()
    wall_ms = run(s, seq.frames[2:])
    n_kf = s.n_keyframes
    stages = {k: {"calls": len(v), "total": float(np.sum(v)),
                  "median": float(np.median(v))}
              for k, v in stage_ms.items() if v}
    # pass 2: the same frames on a fresh System under the profiler (device
    # activity only); kernel times do not depend on the host's pace, so
    # busy time over pass 1's wall time is the device busy share
    s = system.System(cfg)
    run(s, seq.frames[:2])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(s, seq.frames[2:])

    from torch.autograd import DeviceType
    per_kernel = defaultdict(lambda: [0, 0.0])
    busy_us = 0.0
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            dur = evt.time_range.elapsed_us()
            per_kernel[evt.name][0] += 1
            per_kernel[evt.name][1] += dur
            busy_us += dur
    rows = [(k, c, d) for k, (c, d) in per_kernel.items()]
    rows.sort(key=lambda r: -r[2])
    report = {
        "device": torch.cuda.get_device_name(0),
        "frames_profiled": len(seq.frames) - 2,
        "keyframes": n_kf,
        "wall_ms_unprofiled": wall_ms,
        "device_busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / 1e3 / wall_ms,
        "stages_ms": stages,
        "top_kernels": [{"name": k[:120], "calls": c, "device_ms": d / 1e3}
                        for k, c, d in rows[:20]],
    }
    print(json.dumps(report, indent=1))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
