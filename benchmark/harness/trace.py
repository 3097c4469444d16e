"""The device trace of a traced run: the profiler's CUPTI activity over a
span of chunks, opened and closed with a pause at each end (the trace was
seen to lose kernels that run right against its start or stop without
them), and the launches of the port's hand-written kernels in the same
span, with the shapes each was given (`kernels.launch`'s arguments).
Each idle gap is named by the port's innermost span that held the host
over it (`harness/spans.py`) and the device event that ends it."""

from __future__ import annotations

import time
from collections import defaultdict

import torch

from . import spans

TRACE_MARGIN_S = 0.02


def _cuda_events(prof):
    """(name, start ns, duration ns) of every device event (kernels,
    copies, sets) in the profiler's trace."""
    out = []
    try:
        evs = prof.profiler.kineto_results.events()
    except AttributeError:
        evs = None
    if evs is not None:
        for e in evs:
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                out.append((e.name(), e.start_ns(), e.duration_ns()))
        return out
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out.append((e.name, int(e.time_range.start * 1000),
                        int(e.time_range.elapsed_us() * 1000)))
    return out


def busy_intervals(events):
    """The union of the events' [start, end) intervals, sorted, as
    (start ns, end ns, name of the first event of the interval)."""
    merged = []
    for name, s, d in sorted(events, key=lambda e: e[1]):
        e = s + d
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e, name])
    return merged


def summarize(events, window_s: float, segs=(), top: int = 10) -> dict:
    """busy seconds (the union of device activity), the event count, the
    device time of each event name, the `top` names by time and the `top`
    longest gaps between busy intervals, each named `<innermost span> |
    before <event>`: the span of the main thread's segments `segs`
    (`spans.main_thread_segments`) that holds most of the gap, or
    `outside_spans`, and the event that ends it."""
    merged = busy_intervals(events)
    busy_ns = sum(e - s for s, e, _ in merged)
    by_name = defaultdict(float)
    count = defaultdict(int)
    for name, _, d in events:
        by_name[name] += d * 1e-9
        count[name] += 1
    _, named = spans.attribute(spans.idle_gaps(merged), segs)
    return dict(
        busy_s=busy_ns * 1e-9, window_s=window_s, n_events=len(events),
        by_name=dict(by_name), count=dict(count),
        device_ops=[[n, t] for n, t in sorted(by_name.items(),
                                              key=lambda x: -x[1])[:top]],
        idle_gaps=longest_gaps(named, top))


def longest_gaps(named, top: int = 10) -> list:
    """The `top` longest of `spans.attribute`'s named gaps, as
    [`<span> | before <event>`, seconds]."""
    return [[f"{span} | before {n}", g * 1e-9]
            for g, span, n in sorted(named, key=lambda g: -g[0])[:top]]


class Tracer:
    """Profiles one span of a run and records the kernel launches in it."""

    def __init__(self, device, shapes):
        """`shapes(kernel, args)` reads the shapes of one launch from its
        arguments, at the launch, while they are alive."""
        self.device = device
        self._shapes = shapes
        self.launches = []
        self.summary = None
        self.frames = 0

    def warm(self) -> None:
        """Start and stop the profiler once, so that its own start-up
        (CUPTI) is paid in set-up."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.zeros(1, device=self.device).add_(1)
            torch.cuda.synchronize(self.device)

    def begin(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        from eao_fusion_tpu_torch import kernels
        torch.cuda.synchronize(self.device)
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        time.sleep(TRACE_MARGIN_S)
        launch = kernels.launch
        self._launch, self._kernels = launch, kernels

        def recorded(kernel, fn, device, *args):
            self.launches.append((kernel, self._shapes(kernel, args)))
            return launch(kernel, fn, device, *args)
        kernels.launch = recorded
        self._t0 = time.perf_counter()

    def end(self, frames: int) -> None:
        torch.cuda.synchronize(self.device)
        window_s = time.perf_counter() - self._t0
        self._kernels.launch = self._launch
        time.sleep(TRACE_MARGIN_S)
        self._prof.__exit__(None, None, None)
        self.frames = frames
        self._window_s = window_s

    def read(self, record=None) -> None:
        """Read the trace, once the run's window has closed, its idle gaps
        named by the spans of the port's drained `record` (none where it
        is None)."""
        segs = spans.main_thread_segments(record) if record else ()
        self.summary = summarize(_cuda_events(self._prof), self._window_s,
                                 segs)
        del self._prof
