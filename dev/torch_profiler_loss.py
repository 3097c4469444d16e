"""How often the PyTorch profiler's CUDA trace comes back short of the
kernels it ran, on one GPU, for the pose kernel (K1, 10 calls a trace) and
the BA edge kernel (K2, 20 calls a trace) at chip_smoke.py's shapes.

A trace is opened in three ways, `--traces` times each, interleaved:
  bare     profile(); the calls; synchronize;
  margin   the same with a 20 ms pause after the profiler starts and
           before it stops;
  spin     margin, and a spin kernel (`torch.cuda._sleep`, not counted)
           run and synchronized before the calls.
For each way and kernel it prints the histogram of kernels traced, and
for short traces the first kernel's start and the last kernel's end in µs
from the profiler's own origin, beside the same for full traces, so that
a lost first or last kernel shows. One JSON line, with the card's
`nvidia-smi` name and power limit.

    python3 dev/torch_profiler_loss.py [--traces 100]
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from eao_fusion_tpu_torch import kernels  # noqa: E402
from eao_fusion_tpu_torch.config import SolverConfig  # noqa: E402
from eao_fusion_tpu_torch.solvers import ba_edge, pose_opt  # noqa: E402

MARGIN_S = 0.02


def trace(fn, reps, way):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        if way != "bare":
            time.sleep(MARGIN_S)
        if way == "spin":
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        if way != "bare":
            time.sleep(MARGIN_S)
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.device_type == DeviceType.CUDA]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--traces", type=int, default=100)
    n = ap.parse_args().traces
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    kernels.build_all(["pose_opt", "ba_edge"])
    dev = torch.device("cuda")
    cfg = SolverConfig()
    pose0, obs, pobs = cs.pose_problem(np.random.default_rng(7), dev)
    planes = pobs["8 slots, 3 unmatched"]
    x0, a0 = cs.edge_problem(np.random.default_rng(11), dev)
    x, active = cs.edge_orders(x0, a0)["camera"]
    Pw = x.pt_xyz.shape[0]
    tgt = torch.where(active > 0, x.obs_pt, Pw).to(torch.int32)
    edges = ba_edge.EdgePass(x, tgt, cam=cs.CAM, chi2_mono=cfg.chi2_mono,
                             chi2_stereo=cfg.chi2_stereo)
    cases = {
        "K1": (lambda: pose_opt.optimize_pose_cuda(
            pose0, obs, planes, cam=cs.CAM, cfg=cfg), 10, "pose_opt_kernel"),
        "K2": (lambda: edges.full(x.cam_pose, x.pt_xyz, active), 20,
               "ba_edge_full_kernel"),
    }
    ways = ("bare", "margin", "spin")
    seen = {(k, w): [] for k in cases for w in ways}
    t0 = time.perf_counter()
    for _ in range(n):
        for k, (fn, reps, name) in cases.items():
            for w in ways:
                ev = [e for e in trace(fn, reps, w) if name in e[0]]
                seen[k, w].append((len(ev),
                                   min((e[1] for e in ev), default=-1.0),
                                   max((e[2] for e in ev), default=-1.0)))
    out = {"device": smi, "traces_per_way": n,
           "seconds": time.perf_counter() - t0}
    for (k, w), rows in seen.items():
        reps = cases[k][1]
        hist = collections.Counter(r[0] for r in rows)
        full = [r for r in rows if r[0] == reps]
        short = [r for r in rows if r[0] < reps]
        out[f"{k} {w}"] = {
            "kernels_traced": {str(c): hist[c] for c in sorted(hist)},
            "full_first_start_us_median": (
                float(np.median([r[1] for r in full])) if full else None),
            "full_last_end_us_median": (
                float(np.median([r[2] for r in full])) if full else None),
            "short_first_start_last_end_us": [
                [round(r[1], 1), round(r[2], 1)] for r in short[:10]],
        }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
