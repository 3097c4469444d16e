"""Timing spans and `torch.profiler` traces (port of
`eao_fusion_tpu/utils/profiling.py`).

The structured counterpart of the reference's `[COST TIME]` prints
(`src/Frame.cc:193-246`, `src/Tracking.cc:407-428`): named spans add up
into a report; `trace()` records a block with `torch.profiler` and writes
a Chrome trace (chrome://tracing, Perfetto).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch


class Timers:
    def __init__(self) -> None:
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str,
             sync: Optional[torch.Tensor] = None) -> Iterator[None]:
        """Time a block on the host clock. With `sync`, a CUDA tensor, the
        span waits for its device (`torch.cuda.synchronize`) before it
        stops, so the time covers the work the block queued there."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None and sync.is_cuda:
                torch.cuda.synchronize(sync.device)
            self.total[name] += time.perf_counter() - t0
            self.count[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.total, key=lambda n: -self.total[n]):
            c = self.count[name]
            lines.append(f"{name:30s} {self.total[name]*1000:9.1f} ms total "
                         f"{self.total[name]/max(c,1)*1000:8.2f} ms/call "
                         f"x{c}")
        return "\n".join(lines)

    def reset(self) -> None:
        self.total.clear()
        self.count.clear()


GLOBAL = Timers()


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Record the block with `torch.profiler` (CPU, and CUDA when a card
    is present) and write `<logdir>/trace.json`, a Chrome trace."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
