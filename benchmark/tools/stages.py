"""Where a cell's frame goes, by the port's own spans: runs one cell
through `benchmark/run.py` in this process and prints what the per-layer
metrics do not.

    python3 benchmark/tools/stages.py --workload fr3_office.chunked \
        --seed 7 --seconds 30 [--out stages.json]
    python3 benchmark/tools/stages.py --workload fr3_office.chunked \
        --seed 7 --seconds 30 --cost

Without `--cost` the run is traced (`--trace 1`), and the device events
of its traced span are kept. Printed: how the two clocks line up (the
lag from the device's end of each `steady.gate` read to the span's
end), the share of the traced span's
device idle time that the main thread's spans hold (`outside_spans`, the
rest), the ten longest gaps named `<innermost span> | before <kernel>`,
the idle time by span, the share of `steady.slam_chunk`'s host time that
the top-level stages of `steady.step` cover, every span's host ms and
host syncs a frame over the chunks after the traced span, and the host
syncs of the traced chunks beside the blocking copies (Memcpy DtoH and
HtoD) that the device trace puts inside the same stages.

With `--cost` the run is untraced (`--trace 0`), and the recorder is
turned off and on by window chunk (off, on, on, off, ...): the host ms
a frame of each chunk, and of the chunks with the recorder on over
those with it off, next to each other.

Not run by the benchmark's own runs."""

from __future__ import annotations

import argparse
import bisect
import json
import os
import statistics
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import run as bench_run  # noqa: E402
from benchmark.harness import spans, trace  # noqa: E402

TOP = "steady.step"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--cost", action="store_true")
    ap.add_argument("--out", default=None)
    return ap.parse_args(argv)


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _stage_of(rec) -> dict:
    """{span id: the top-level stage it lies in}: the child of
    `steady.step` above it, or the root span's own name."""
    by_id = {s.id: s for s in rec["spans"]}
    out = {}
    for s in rec["spans"]:
        chain = [s]
        while chain[-1].parent in by_id:
            chain.append(by_id[chain[-1].parent])
        names = [c.name for c in chain]
        out[s.id] = (names[names.index(TOP) - 1]
                     if TOP in names and names.index(TOP) > 0
                     else names[-1])
    return out


def coverage(rec, chunks) -> float:
    """The top-level stages' share of the chunks' host time."""
    kids = spans.children(rec)
    steps = [k for c in chunks for k in kids.get(c.id, ()) if k.name == TOP]
    stage_ns = sum(k.end_ns - k.start_ns for st in steps
                   for k in kids.get(st.id, ()))
    return stage_ns / sum(c.end_ns - c.start_ns for c in chunks)


def stage_table(rec, chunks, frames: int) -> dict:
    """{span name: [host ms a frame, calls a frame, host syncs a frame]}
    over the chunks' subtrees."""
    counts = rec["counts"]
    tab = defaultdict(lambda: [0.0, 0.0, 0.0])
    for s in spans.subtree(spans.children(rec), chunks):
        t = tab[s.name]
        t[0] += (s.end_ns - s.start_ns) / 1e6 / frames
        t[1] += 1 / frames
        t[2] += counts.get(s.id, {}).get(spans.SYNC, 0) / frames
    return dict(sorted(tab.items(), key=lambda x: -x[1][0]))


def gate_copy_lag(rec, events):
    """The clocks side by side: each `steady.gate` span ends with one
    blocking device -> host read, so the last Memcpy DtoH that the device
    trace ends before the span's end (within 5 ms) should end just
    before it. Quartiles of (span end - copy end), µs; None where no
    gate span lies in the trace."""
    ends = sorted(s + d for n, s, d in events
                  if n.startswith("Memcpy DtoH"))
    lags = []
    for g in rec["spans"]:
        if g.name != "steady.gate":
            continue
        i = bisect.bisect_right(ends, g.end_unix_ns) - 1
        if i >= 0 and g.end_unix_ns - ends[i] < 5_000_000:
            lags.append((g.end_unix_ns - ends[i]) / 1e3)
    if len(lags) < 4:
        return None
    return statistics.quantiles(lags, n=4)


def traced_analysis(rec, events, frames: int) -> dict:
    busy = trace.busy_intervals(events)
    gaps = spans.idle_gaps(busy)
    segs = spans.main_thread_segments(rec)
    total, named = spans.attribute(gaps, segs)
    idle = sum(total.values())
    top = sorted(named, key=lambda g: -g[0])[:10]

    # syncs against blocking copies, by stage, in the traced chunks
    traced = [c for c, _ in spans.split_chunks(rec, frames)[0]]
    inside = {s.id for s in spans.subtree(spans.children(rec), traced)}
    stage = _stage_of(rec)
    idsegs = spans.innermost_segments(
        [(s.start_unix_ns, s.end_unix_ns, s.id) for s in rec["spans"]
         if s.thread == rec["main_thread"]])
    copies = sorted((s + d // 2, s + d // 2 + 1, n) for n, s, d in events
                    if n.startswith("Memcpy DtoH") or
                    n.startswith("Memcpy HtoD"))
    _, placed = spans.attribute(copies, idsegs)
    by_stage = defaultdict(lambda: dict(syncs=0, dtoh=0, htod=0))
    for _, sid, name in placed:
        if sid in inside:
            key = "dtoh" if name.startswith("Memcpy DtoH") else "htod"
            by_stage[stage[sid]][key] += 1
    for sid in inside:
        n = rec["counts"].get(sid, {}).get(spans.SYNC, 0)
        if n:
            by_stage[stage[sid]]["syncs"] += n
    return dict(
        gate_copy_lag_us=gate_copy_lag(rec, events),
        idle_s=idle * 1e-9,
        named_idle_share=1 - total.get(spans.OUTSIDE, 0) / idle,
        idle_by_span={k: v * 1e-9 for k, v in
                      sorted(total.items(), key=lambda x: -x[1])},
        idle_gaps=[[f"{s} | before {k}", g * 1e-9] for g, s, k in top],
        traced_coverage=coverage(rec, traced),
        syncs_and_copies=dict(by_stage))


def run_traced(args) -> dict:
    kept = {}
    read = trace.Tracer.read

    def keep(self):
        kept["events"] = trace._cuda_events(self._prof)
        kept["frames"] = self.frames
        read(self)
    trace.Tracer.read = keep
    rc = bench_run.main(["--workload", args.workload, "--seed",
                         str(args.seed), "--seconds", str(args.seconds),
                         "--trace", "1"])
    rec = spans.record()
    if rc != 0 or rec is None or "events" not in kept:
        raise SystemExit(f"no spans or no trace (exit {rc})")
    got = spans.window_chunks(rec, kept["frames"])
    out = traced_analysis(rec, kept["events"], kept["frames"])
    if got is not None:
        chunks, frames, _ = got
        out.update(later_frames=frames, later_coverage=coverage(rec, chunks),
                   stages=stage_table(rec, chunks, frames))
    return out


def cost_summary(per) -> dict:
    """From [(chunk index, host ms a frame, recorder on)] in run order:
    the medians with the recorder on and off, their ratio, and each chunk
    with it on over the chunk beside it with it off."""
    on_ms = [ms for _, ms, on in per if on]
    off_ms = [ms for _, ms, on in per if not on]
    pairs = []
    for j, (_, ms, on) in enumerate(per):
        near = [per[k][1] for k in (j - 1, j + 1)
                if on and 0 <= k < len(per) and not per[k][2]]
        if near:
            pairs.append(ms / near[0])
    return dict(chunks=[list(c) for c in per],
                on_ms_per_frame=statistics.median(on_ms),
                off_ms_per_frame=statistics.median(off_ms),
                on_over_off=(statistics.median(on_ms)
                             / statistics.median(off_ms)),
                on_over_off_pairs=pairs)


def run_cost(args) -> dict:
    """Alternate the recorder by window chunk, timing each chunk from its
    `slam_chunk` call to the next one (its recording and epilogue
    included)."""
    from eao_fusion_tpu_torch.pipeline import steady
    from eao_fusion_tpu_torch.utils import profiling
    calls = []
    real = steady.slam_chunk

    def alternating(st, grays, *a, **kw):
        i = len(calls) - 1          # the first call is the warm chunk
        on = i >= 0 and i % 4 in (1, 2)
        (profiling.enable if on else profiling.disable)()
        calls.append((time.perf_counter(), int(grays.shape[0]), on, i))
        return real(st, grays, *a, **kw)
    steady.slam_chunk = alternating
    try:
        rc = bench_run.main(["--workload", args.workload, "--seed",
                             str(args.seed), "--seconds", str(args.seconds),
                             "--trace", "0"])
    finally:
        steady.slam_chunk = real
        profiling.disable()
    if rc != 0:
        raise SystemExit(f"exit {rc}")
    per_chunk = calls[-1][1]
    return cost_summary([
        (i, (t1 - t0) * 1e3 / n, on)
        for (t0, n, on, i), (t1, _, _, _) in zip(calls, calls[1:])
        if i >= 0 and n == per_chunk])


def main(argv=None) -> int:
    args = parse_args(argv)
    out = run_cost(args) if args.cost else run_traced(args)
    out = dict(workload=args.workload, seed=args.seed, cost=args.cost,
               card=bench_run.smi_line(), **out)
    text = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    if args.cost:
        _log(f"recorder on / off, ms a frame: {out['on_ms_per_frame']:.2f}"
             f" / {out['off_ms_per_frame']:.2f} = {out['on_over_off']:.4f}")
    else:
        _log(f"named idle share {out['named_idle_share']:.4f} of "
             f"{out['idle_s']:.3f} s; top-level coverage traced "
             f"{out['traced_coverage']:.4f}, later "
             f"{out.get('later_coverage', float('nan')):.4f}")
        for name, (ms, calls, syncs) in out.get("stages", {}).items():
            _log(f"{name:28s} {ms:9.3f} ms/frame {calls:7.3f} calls/frame "
                 f"{syncs:7.3f} syncs/frame")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
