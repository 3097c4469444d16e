"""CUDA graphs of the port's fixed-shape stages.

A `Workspace` holds the tensors that a stage reads and writes and that
outlive one call: its inputs, copied in by the caller, and its outputs,
which the caller reads or copies out. `run(name, fn)` runs a stage: `fn()`
reads and writes only the workspace's tensors (`put` writes one, created
at its first write), so its work is the same on every call but for the
values in them. On a CUDA card the first call of a stage runs `fn()`
eagerly, which also warms it up, and then captures it as a CUDA graph
(`capture_error_mode="thread_local"`, on a stream of the workspace's own,
every graph of the workspace in one memory pool, one capture at a time
in the process); every later call
replays the graph on the current stream, and the host launches one graph
where it launched the stage's kernels one by one. A stage that reads the
host (a device -> host sync) fails its capture: the stages are written
sync-free. On the CPU `run` calls `fn()`.

`workspace(key, device)` is the calling thread's workspace for `key` (the
device, the shapes and the constants the graphs bake in): on a card built
at first use and kept as long as the thread, on the CPU a fresh one each
call. So two threads never share a graph, and a thread's graphs go with
it.

The program counters `graph_capture` and `graph_replay`
(`utils/profiling.count`) count captures and replays on the innermost
open span.
"""

from __future__ import annotations

import threading
from typing import Callable, Hashable

import torch

from eao_fusion_tpu_torch.utils import profiling

_tls = threading.local()
# one capture at a time in the process: a capture's set-up synchronises
# the whole device, which fails while another thread's stream captures
_capture_lock = threading.Lock()


def enabled(device) -> bool:
    """Whether stages on `device` run as CUDA graphs: on a card."""
    return torch.device(device).type == "cuda"


class Workspace:
    """Tensors that outlive a call, and the graphs of the stages that
    read and write them (see the module's docstring)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.graphs_on = enabled(self.device)
        self._graphs = {}
        self._pool = None
        self._stream = None

    def __contains__(self, name: str) -> bool:
        return name in self.__dict__

    def put(self, name: str, value: torch.Tensor) -> torch.Tensor:
        """Write `value` into the workspace's tensor `name`, made at the
        first write as a copy of `value`; returns it."""
        buf = self.__dict__.get(name)
        if buf is None:
            buf = torch.empty(value.shape, dtype=value.dtype,
                              device=value.device).copy_(value)
            setattr(self, name, buf)
        else:
            buf.copy_(value)
        return buf

    def run(self, name: str, fn: Callable[[], None]) -> None:
        """Run stage `name`: `fn()` on the CPU and at the stage's first
        call on a card (then captured), a replay of its graph after."""
        if not self.graphs_on:
            fn()
            return
        g = self._graphs.get(name)
        if g is not None:
            g.replay()
            profiling.count(profiling.REPLAY_COUNTER)
            return
        fn()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)
        g = torch.cuda.CUDAGraph()
        with _capture_lock, torch.cuda.device(self.device), torch.cuda.graph(
                g, pool=self._pool, stream=self._stream,
                capture_error_mode="thread_local"):
            fn()
        self._graphs[name] = g
        profiling.count(profiling.CAPTURE_COUNTER)


def workspace(key: Hashable, device) -> Workspace:
    """The calling thread's workspace for `key` on a card, made at first
    use; a fresh one on the CPU."""
    if not enabled(device):
        return Workspace(device)
    cache = getattr(_tls, "cache", None)
    if cache is None:
        cache = _tls.cache = {}
    ws = cache.get(key)
    if ws is None:
        ws = cache[key] = Workspace(device)
    return ws
