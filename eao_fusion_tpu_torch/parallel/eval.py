"""Data-parallel sequence evaluation (port of
`eao_fusion_tpu/parallel/eval.py`).

The unit of data parallelism is a sequence: each SLAM run is independent,
so N sequences are evaluated at once, each from a host thread of its own
that builds its `System(cfg, device=dev)` and runs inside
`torch.cuda.device(dev)` on a CUDA stream of its own. Device work of the
runs overlaps (the interpreter lock is released while PyTorch waits on
the device); on one card the runs time-slice it. `devices` defaults to
every CUDA device; CPU devices run the plain versions.
"""

from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from eao_fusion_tpu_torch.config import SystemConfig
from eao_fusion_tpu_torch.io import tum


@dataclass
class SequenceResult:
    name: str
    n_frames: int
    n_keyframes: int
    n_loops: int
    ate_rmse: float
    rpe_rmse: float
    device: str


def _run_one(make_seq: Callable, name: str, cfg: SystemConfig,
             device) -> SequenceResult:
    # imported here: the System pulls in the whole pipeline
    from eao_fusion_tpu_torch.pipeline.system import System

    dev = torch.device(device)
    if dev.type == "cuda":
        ctx = contextlib.ExitStack()
        ctx.enter_context(torch.cuda.device(dev))
        ctx.enter_context(torch.cuda.stream(torch.cuda.Stream(dev)))
    else:
        ctx = contextlib.nullcontext()
    with ctx:
        seq = make_seq()
        s = System(cfg, device=dev)
        for f in seq.frames:
            boxes = getattr(f, "boxes", None) if cfg.use_objects else None
            s.process_frame(f.gray, f.depth, f.timestamp, boxes=boxes)
        est = s.trajectory_tcw(corrected=True)
        gt = np.stack([f.tcw for f in seq.frames])
        n = min(len(est), len(gt))
        err = tum.evaluate_ate_rpe(est[:n], gt[:n],
                                   with_scale=cfg.sensor == "mono")
    return SequenceResult(
        name=name, n_frames=n, n_keyframes=s.n_keyframes,
        n_loops=s.n_loops_closed, ate_rmse=float(err.ate_rmse),
        rpe_rmse=float(err.rpe_trans_rmse), device=str(dev))


def evaluate_sequences(
        sequences: Sequence,   # (name, make_seq) pairs; make_seq() -> seq
        cfg: Optional[SystemConfig] = None,
        devices: Optional[Sequence] = None,
        max_workers: Optional[int] = None) -> List[SequenceResult]:
    """Evaluate every sequence, sequence i on devices[i % len(devices)],
    concurrently. `sequences` holds (name, make_seq) pairs; make_seq is a
    zero-argument loader called in the worker thread."""
    cfg = cfg or SystemConfig()
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass devices="
                               "['cpu', ...] to evaluate on the CPU")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = list(devices)
    max_workers = max_workers or len(sequences)

    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        futs = [pool.submit(_run_one, make_seq, name, cfg,
                            devices[i % len(devices)])
                for i, (name, make_seq) in enumerate(sequences)]
        return [f.result() for f in futs]


def summarize(results: Sequence[SequenceResult]) -> str:
    lines = [f"{'sequence':24s} {'frames':>6s} {'KFs':>4s} {'loops':>5s} "
             f"{'ATE rmse':>9s} {'RPE rmse':>9s}  device"]
    for r in results:
        lines.append(f"{r.name:24s} {r.n_frames:6d} {r.n_keyframes:4d} "
                     f"{r.n_loops:5d} {r.ate_rmse * 100:8.2f}cm "
                     f"{r.rpe_rmse * 100:8.2f}cm  {r.device}")
    ates = np.array([r.ate_rmse for r in results])
    lines.append(f"{'mean':24s} {'':6s} {'':4s} {'':5s} "
                 f"{float(ates.mean()) * 100:8.2f}cm")
    return "\n".join(lines)
