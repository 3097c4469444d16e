"""The port's own spans and counters in a traced run
(`eao_fusion_tpu_torch/utils/profiling.py`).

The recorder turns itself on at the first steady chunk that runs under
the profiler (`profiling.follow_profiler`, called by `steady.slam_chunk`)
and stays on to the end of the window, so a `--trace 1` run holds the
spans of every window chunk, and a `--trace 0` run none. The per-stage
readers take the chunks after the traced span: the recorder on, CUPTI
off, the chunks that give `epilogue_pct`. Where the port has no such
recorder, or it recorded nothing, `record()` is None and every reader
returns None.

The idle attribution puts each gap between the device's busy intervals
down to the innermost spans of the main thread open over it, in
proportion to the overlap; time in no span is `outside_spans`.
"""

from __future__ import annotations

from collections import defaultdict

OUTSIDE = "outside_spans"
SYNC = "host_sync"

_record = []


def record():
    """The recorder's drained record, read once in a process and shared
    by the readers; None where there is none or it holds no span."""
    if not _record:
        try:
            from eao_fusion_tpu_torch.utils import profiling
        except ImportError:
            profiling = None
        drain = getattr(profiling, "drain", None)
        _record.append(drain() if callable(drain) else None)
    rec = _record[0]
    return rec if rec and rec.get("spans") else None


def children(rec) -> dict:
    """{span id: [child spans]}."""
    out = defaultdict(list)
    for s in rec["spans"]:
        out[s.parent].append(s)
    return out


def subtree(kids: dict, roots) -> list:
    """The spans under `roots` (each root included)."""
    out, todo = [], list(roots)
    while todo:
        s = todo.pop()
        out.append(s)
        todo.extend(kids.get(s.id, ()))
    return out


def split_chunks(rec, skip_frames: int):
    """The main thread's `steady.slam_chunk` spans in time order, split
    where the first `skip_frames` frames' chunks end: ([(chunk, frames)]
    before, [(chunk, frames)] after, {span id: children})."""
    kids = children(rec)
    chunks = sorted((s for s in rec["spans"]
                     if s.name == "steady.slam_chunk"
                     and s.thread == rec["main_thread"]),
                    key=lambda s: s.start_ns)
    seen, before, after = 0, [], []
    for c in chunks:
        n = sum(1 for k in kids.get(c.id, ()) if k.name == "steady.step")
        (after if seen >= skip_frames else before).append((c, n))
        seen += n
    return before, after, kids


def window_chunks(rec, skip_frames: int):
    """(the main thread's `steady.slam_chunk` spans after the first
    `skip_frames` frames' chunks, the frames they hold, {span id:
    children}); None if no chunk is left."""
    _, later, kids = split_chunks(rec, skip_frames)
    frames = sum(n for _, n in later)
    if not frames:
        return None
    return [c for c, _ in later], frames, kids


def _after_trace(run: dict):
    rec = record()
    if rec is None or not run.get("trace_frames"):
        return None
    return window_chunks(rec, int(run["trace_frames"]))


def stage_ms(run: dict, name: str, per: str = "frame"):
    """Host ms of the spans `name` inside the chunks after the traced
    span, over their frames (`per="frame"`) or over the spans themselves
    (`per="span"`); None where there is nothing to read."""
    got = _after_trace(run)
    if got is None:
        return None
    chunks, frames, kids = got
    hits = [s for s in subtree(kids, chunks) if s.name == name]
    n = frames if per == "frame" else len(hits)
    if not n:
        return None
    return sum(s.end_ns - s.start_ns for s in hits) / 1e6 / n


def syncs_per_frame(run: dict):
    """`host_sync` counts of every span inside the chunks after the
    traced span, over their frames; None where nothing counted one (no
    counter, or no card)."""
    got = _after_trace(run)
    if got is None:
        return None
    chunks, frames, kids = got
    counts = record()["counts"]
    n = sum(counts.get(s.id, {}).get(SYNC, 0)
            for s in subtree(kids, chunks))
    return n / frames if n else None


# ------------------------------------------------------- idle attribution

def innermost_segments(spans) -> list:
    """[(start, end, name)]: the union of one thread's spans (each
    (start, end, name), nested properly) cut where the innermost open
    span changes, in time order."""
    segs, stack, cur = [], [], None
    for s0, s1, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][0] <= s0:
            end, top = stack.pop()
            if end > cur:
                segs.append((cur, end, top))
            cur = max(cur, end)
        if stack and s0 > cur:
            segs.append((cur, s0, stack[-1][1]))
        stack.append((s1, name))
        cur = s0
    while stack:
        end, top = stack.pop()
        if end > cur:
            segs.append((cur, end, top))
        cur = max(cur, end)
    return segs


def attribute(intervals, segs):
    """Put each interval (start, end, label) of `intervals` (sorted,
    disjoint) down to the segments of `innermost_segments` that overlap
    it, in proportion. Returns ({span name or OUTSIDE: ns}, [(ns, the
    name that holds most of the interval, label)] in the intervals'
    order)."""
    total = defaultdict(int)
    named = []
    j = 0
    for g0, g1, label in intervals:
        while j < len(segs) and segs[j][1] <= g0:
            j += 1
        by = defaultdict(int)
        k = j
        while k < len(segs) and segs[k][0] < g1:
            ov = min(g1, segs[k][1]) - max(g0, segs[k][0])
            if ov > 0:
                by[segs[k][2]] += ov
            k += 1
        rest = (g1 - g0) - sum(by.values())
        if rest > 0:
            by[OUTSIDE] += rest
        for name, ns in by.items():
            total[name] += ns
        named.append((g1 - g0, max(by, key=by.get) if by else OUTSIDE,
                      label))
    return dict(total), named


def idle_gaps(busy) -> list:
    """The gaps between busy intervals [(start, end, name)] (sorted,
    merged, as `trace.busy_intervals` gives them), each as (start, end,
    name of the event that ends it)."""
    return [(busy[i][1], busy[i + 1][0], busy[i + 1][2])
            for i in range(len(busy) - 1) if busy[i + 1][0] > busy[i][1]]


def main_thread_segments(rec) -> list:
    """`innermost_segments` of the main thread's spans on the unix-ns
    clock (the device trace's)."""
    return innermost_segments(
        [(s.start_unix_ns, s.end_unix_ns, s.name) for s in rec["spans"]
         if s.thread == rec["main_thread"]])
