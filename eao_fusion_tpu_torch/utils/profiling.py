"""The port's recorder of host spans and counters.

`span(name)` times a block on the host: its name, start and end
(`time.perf_counter_ns`), the span that encloses it (its parent), the
thread, and the frame and chunk it serves (`frame=` / `chunk=`, which the
spans inside inherit: the identifier that the spans of one frame share).
`count(name, n)` adds to a counter of the innermost open span of the
calling thread. Names are `<layer>.<stage>`.

Recording is off by default. Off, `span` checks one flag and returns one
shared null context, and `count` returns: no clock read, no allocation.
A span never waits for the card: it measures host time, which is the
critical path of a program whose card is idle most of the time.

`enable()` turns recording on and takes the clock anchor, one
(`time.time_ns()`, `time.perf_counter_ns()`) pair, so that `drain()` gives
each span on the unix-ns clock as well: the clock on which the profiler
(Kineto) stamps its host and device events, so that spans and a device
trace share one timeline. On a CUDA card it also counts every device ->
host synchronisation (`.item()`, `.tolist()`, `int()` of a tensor, boolean
mask indexing, `nonzero`, a blocking copy to or from the card) as
`host_sync`: `torch.cuda.set_sync_debug_mode("warn")` makes each one a
warning, which the recorder counts and drops. `utils/graphs` counts
`graph_capture` and `graph_replay`, a stage captured as a CUDA graph and a
replay of one. `drain()` returns what was recorded and clears it; spans
are written out only at the end of a run.

`follow_profiler()` (called once a chunk by `steady.slam_chunk`) turns
recording on while a torch profiler records, and leaves it on after the
profiler stops: a run that takes a device trace of the steady path
gets the same run's spans beside it, and its later chunks timed by stage
without the profiler. Nothing turns it off again but `disable()`: after
one profiled `slam_chunk` the process keeps recording, keeps the sync
debug mode and the warnings hook on, and keeps every span in memory
until `drain()`. It stands in for the benchmark's tracer calling
`enable()` itself, and goes when the tracer does.

Readers: the benchmark's per-stage metrics and idle attribution
(`benchmark/harness/spans.py`), and `apps/run_tum.py --spans`, which
writes `chrome_trace()` and prints `report()`.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
import warnings
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional

import torch

SYNC_COUNTER = "host_sync"
# a stage captured as a CUDA graph, and replayed (`utils/graphs`)
CAPTURE_COUNTER = "graph_capture"
REPLAY_COUNTER = "graph_replay"
_SYNC_MESSAGE = "synchronizing CUDA operation"


class Span(NamedTuple):
    id: int
    parent: int               # 0: none
    name: str
    start_ns: int             # time.perf_counter_ns()
    end_ns: int
    start_unix_ns: int        # the same instants on time.time_ns()'s clock
    end_unix_ns: int
    thread: int               # threading.get_ident()
    frame: Optional[int]
    chunk: Optional[int]


_on = False
_NULL = contextlib.nullcontext()
_spans: list = []             # closed spans, as tuples of Span's first
_counts: Dict[tuple, int] = defaultdict(int)   # (span id, name) -> n
_lock = threading.Lock()
_tls = threading.local()
_ids = itertools.count(1)
_threads: Dict[int, str] = {}
_anchor = (0, 0)              # (time_ns, perf_counter_ns) at enable()
_sync_watch = None            # the warnings state saved by enable()


def _stack() -> list:
    try:
        return _tls.stack
    except AttributeError:
        _tls.stack = []
        _threads[threading.get_ident()] = threading.current_thread().name
        return _tls.stack


class _Span:
    __slots__ = ("name", "frame", "chunk", "id", "parent", "t0")

    def __init__(self, name: str, frame, chunk):
        self.name, self.frame, self.chunk = name, frame, chunk

    def __enter__(self):
        stack = _stack()
        if stack:
            top = stack[-1]
            self.parent = top.id
            if self.frame is None:
                self.frame = top.frame
            if self.chunk is None:
                self.chunk = top.chunk
        else:
            self.parent = 0
        self.id = next(_ids)
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        _tls.stack.pop()
        _spans.append((self.id, self.parent, self.name, self.t0, t1,
                       threading.get_ident(), self.frame, self.chunk))
        return False


def span(name: str, frame: Optional[int] = None,
         chunk: Optional[int] = None):
    """A context manager that records the block as span `name` while
    recording is on; the shared null context while it is off."""
    if not _on:
        return _NULL
    return _Span(name, frame, chunk)


def count(name: str, n: int = 1) -> None:
    """Add `n` to counter `name` of the calling thread's innermost open
    span (span id 0 outside every span)."""
    if not _on:
        return
    stack = _stack()
    key = (stack[-1].id if stack else 0, name)
    with _lock:
        _counts[key] += n


def enabled() -> bool:
    return _on


def _show_warning(message, category, filename, lineno, file=None,
                  line=None):
    if _SYNC_MESSAGE in str(message):
        count(SYNC_COUNTER)
        return
    _sync_watch[1](message, category, filename, lineno, file, line)


def enable() -> None:
    """Turn recording on (a no-op if it is on) and take the clock anchor."""
    global _on, _anchor, _sync_watch
    if _on:
        return
    p0 = time.perf_counter_ns()
    unix = time.time_ns()
    _anchor = (unix, (p0 + time.perf_counter_ns()) // 2)
    if torch.cuda.is_available():
        watch = warnings.catch_warnings()
        watch.__enter__()
        warnings.filterwarnings("always", message=".*" + _SYNC_MESSAGE)
        _sync_watch = (watch, warnings.showwarning,
                       torch.cuda.get_sync_debug_mode())
        warnings.showwarning = _show_warning
        torch.cuda.set_sync_debug_mode("warn")
    _on = True


def disable() -> None:
    """Turn recording off; what was recorded stays until `drain()`."""
    global _on, _sync_watch
    if not _on:
        return
    _on = False
    if _sync_watch is not None:
        watch, _, mode = _sync_watch
        torch.cuda.set_sync_debug_mode(mode)
        watch.__exit__(None, None, None)
        _sync_watch = None


def follow_profiler() -> None:
    """Turn recording on if a torch profiler is recording; it stays on,
    sync counting included, until `disable()`."""
    if not _on and torch._C._autograd._profiler_enabled():
        enable()


def drain() -> dict:
    """What was recorded since the last drain, cleared here: `spans`
    (closed spans, in the order they closed), `counts` ({span id: {name:
    n}}, span id 0 for counts outside every span), `anchor`, `threads`
    ({thread id: name}) and `main_thread`."""
    unix, perf = _anchor
    raw = list(_spans)
    del _spans[:len(raw)]     # a span another thread closes now stays
    with _lock:
        counts = dict(_counts)
        _counts.clear()
    spans = [Span(i, p, n, t0, t1, t0 - perf + unix, t1 - perf + unix,
                  th, fr, ch) for i, p, n, t0, t1, th, fr, ch in raw]
    by_span: Dict[int, Dict[str, int]] = defaultdict(dict)
    for (sid, name), n in counts.items():
        by_span[sid][name] = n
    return dict(spans=spans, counts=dict(by_span), anchor=_anchor,
                threads=dict(_threads),
                main_thread=threading.main_thread().ident)


def chrome_trace(rec: dict, pid: int = 0) -> dict:
    """A drained record as a Chrome trace (chrome://tracing, Perfetto):
    one complete event a span on the unix-µs clock, one track a thread,
    each span's counts in its `args`."""
    events = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
               "args": {"name": name}}
              for tid, name in rec["threads"].items()]
    for s in rec["spans"]:
        args = {k: v for k, v in (("frame", s.frame), ("chunk", s.chunk))
                if v is not None}
        args.update(rec["counts"].get(s.id, {}))
        events.append({"ph": "X", "name": s.name, "pid": pid,
                       "tid": s.thread, "ts": s.start_unix_ns / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3, "args": args})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def report(rec: dict) -> str:
    """Per span name: total ms, calls, ms a call and the host syncs it
    counted itself, longest total first."""
    tot: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0, 0])
    for s in rec["spans"]:
        t = tot[s.name]
        t[0] += (s.end_ns - s.start_ns) / 1e6
        t[1] += 1
        t[2] += rec["counts"].get(s.id, {}).get(SYNC_COUNTER, 0)
    lines = []
    for name, (ms, n, syncs) in sorted(tot.items(), key=lambda x: -x[1][0]):
        lines.append(f"{name:28s} {ms:10.1f} ms {ms / n:9.3f} ms/call "
                     f"x{n:<6d} {syncs} syncs")
    return "\n".join(lines)
