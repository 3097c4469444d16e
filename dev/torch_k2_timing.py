"""Times the K2 binding (`ba_edge.EdgePass.full`: the full edge pass with
its [C, 42] / [Pw, 12] segment sums) of the tree it is run from, on one
GPU, at chip_smoke.py's phase-4 window (E = 8192, C = 32, Pw = 2048), with
the edges in random camera order and in camera order. Prints one JSON
line: the card and its power limit, and per order the device kernels and
memsets per call, their device µs (profiler), the per-call ms (CUDA
events), and whether 10 calls gave the same bits.

Run it from the root of the tree to time (the tree's own `chip_smoke.py`
makes the window); to set two commits side by side, in one call:

    git archive <commit> | tar -x -C build/archive/parent
    (cd build/archive/parent && python3 ../../../dev/torch_k2_timing.py)
    python3 dev/torch_k2_timing.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from eao_fusion_tpu_torch import kernels  # noqa: E402
from eao_fusion_tpu_torch.config import SolverConfig  # noqa: E402
from eao_fusion_tpu_torch.solvers import ba_edge  # noqa: E402


def events(fn, reps=50):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [(e.name, e.device_time_total) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def main() -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    kernels.build_all(["ba_edge"])
    dev = torch.device("cuda")
    cfg = SolverConfig()
    kw = dict(cam=cs.CAM, chi2_mono=cfg.chi2_mono,
              chi2_stereo=cfg.chi2_stereo)
    x0, a0 = cs.edge_problem(np.random.default_rng(11), dev)
    Pw = x0.pt_xyz.shape[0]
    out = {"tree": os.getcwd(), "device": smi}
    for order, (x, active) in cs.edge_orders(x0, a0).items():
        tgt = torch.where(active > 0, x.obs_pt, Pw).to(torch.int32)
        edges = ba_edge.EdgePass(x, tgt, **kw)
        args = (x.cam_pose, x.pt_xyz, active)
        runs = [[t.clone() for t in edges.full(*args)] for _ in range(10)]
        same = all(torch.equal(a, b) for r in runs[1:]
                   for a, b in zip(runs[0], r))
        reps = 50
        ev = events(lambda: edges.full(*args), reps)
        kern = [us for n, us in ev if "memset" not in n.lower()]
        mems = [us for n, us in ev if "memset" in n.lower()]
        ms = cs.cuda_ms(lambda: edges.full(*args), 200)
        out[order] = dict(kernels_per_call=len(kern) / reps,
                          memsets_per_call=len(mems) / reps,
                          kernel_us=sum(kern) / max(len(kern), 1),
                          memset_us=sum(mems) / max(len(mems), 1),
                          ms_per_call=ms, bit_identical_10_calls=same)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
