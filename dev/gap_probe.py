"""What the host was doing in a traced run's longest device-idle gaps:
runs `benchmark/tools/stages.py`'s traced analysis in this process and,
beside it, records every CUDA-graph capture and replay (`utils/graphs`,
whether the span recorder is on or not), every garbage collection
(`gc.callbacks`) and the host's load average once a second, all on the
device trace's clock (unix ns).

    python3 dev/gap_probe.py --workload fr3_office.chunked --seed 7 \
        --seconds 51 [--out probe.json]

Printed and written: stages.py's output, the captures and replays in
set-up (before the window's first chunk), in the traced span and in the
rest of the window, the collections of each generation there, and for
each of the ten longest gaps of the traced span its length, the
innermost main-thread span over it, and the captures, collections and
load average inside it."""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import threading
import time
from collections import Counter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark.harness import spans, trace  # noqa: E402
from benchmark.tools import stages  # noqa: E402
from eao_fusion_tpu_torch.utils import profiling  # noqa: E402

GRAPH = (profiling.CAPTURE_COUNTER, profiling.REPLAY_COUNTER)


def _recorders():
    """Start the recorders; returns what they fill and a stop function."""
    from eao_fusion_tpu_torch.pipeline import steady
    got = dict(graph=[], gc=[], load=[], chunks=[])
    count = profiling.count
    slam_chunk = steady.slam_chunk

    def chunk(*a, **kw):
        got["chunks"].append(time.time_ns())
        return slam_chunk(*a, **kw)
    steady.slam_chunk = chunk

    def counted(name, n=1):
        if name in GRAPH:
            got["graph"].append((time.time_ns(), name))
        count(name, n)
    profiling.count = counted

    started = {}

    def on_gc(phase, info):
        if phase == "start":
            started["t"] = time.time_ns()
        elif "t" in started:
            got["gc"].append((started.pop("t"), time.time_ns(),
                              info["generation"]))
    gc.callbacks.append(on_gc)

    done = threading.Event()

    def sample():
        while not done.wait(1.0):
            got["load"].append((time.time_ns(), os.getloadavg()[0]))
    t = threading.Thread(target=sample, daemon=True)
    t.start()

    def stop():
        profiling.count = count
        steady.slam_chunk = slam_chunk
        gc.callbacks.remove(on_gc)
        done.set()
        t.join()
    return got, stop


def _where(w0, t0, t1, t):
    if t < w0:
        return "setup"
    return "traced" if t0 <= t <= t1 else "window_untraced"


def summarize(got, events, rec, top: int = 10) -> dict:
    """The recorders' findings in set-up (before the second `slam_chunk`
    call: the first is the warm chunk), the traced span [first, last
    device event] and the rest of the window, and in the traced span's
    longest gaps."""
    busy = trace.busy_intervals(events)
    t0, t1 = busy[0][0], busy[-1][1]
    w0 = got["chunks"][1] if len(got["chunks"]) > 1 else t0
    graph = Counter((_where(w0, t0, t1, t), n) for t, n in got["graph"])
    colls = Counter((_where(w0, t0, t1, s), g) for s, _, g in got["gc"])
    gc_ms = Counter()
    for s, e, g in got["gc"]:
        gc_ms[(_where(w0, t0, t1, s), g)] += (e - s) * 1e-6
    segs = spans.main_thread_segments(rec) if rec else []
    gaps = sorted(spans.idle_gaps(busy), key=lambda g: g[0] - g[1])[:top]
    rows = []
    for s, e, name in gaps:
        over = Counter()
        for a, b, span in segs:
            if a < e and b > s:
                over[span] += min(b, e) - max(a, s)
        load = [v for t, v in got["load"] if s - 1e9 <= t <= e + 1e9]
        rows.append(dict(
            gap_s=(e - s) * 1e-9, before=name,
            span=over.most_common(1)[0][0] if over else spans.OUTSIDE,
            captures=sum(1 for t, n in got["graph"]
                         if s <= t <= e and n == GRAPH[0]),
            gc=[[g, (b - a) * 1e-6] for a, b, g in got["gc"]
                if a < e and b > s],
            load=load))
    return dict(
        traced_s=(t1 - t0) * 1e-9,
        graph={f"{w}.{n}": k for (w, n), k in sorted(graph.items())},
        gc={f"{w}.gen{g}": [k, gc_ms[(w, g)]]
            for (w, g), k in sorted(colls.items())},
        load_min_max=[min(v for _, v in got["load"]),
                      max(v for _, v in got["load"])] if got["load"] else [],
        gaps=rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    kept = {}
    read = trace.Tracer.read

    def keep(self):
        kept["events"] = trace._cuda_events(self._prof)
        read(self)
    trace.Tracer.read = keep
    got, stop = _recorders()
    try:
        rc = stages.main(["--workload", args.workload, "--seed",
                          str(args.seed), "--seconds", str(args.seconds)])
    finally:
        stop()
        trace.Tracer.read = read
    out = summarize(got, kept["events"], spans.record())
    text = json.dumps(out)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    print(text, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
