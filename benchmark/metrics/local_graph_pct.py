"""Local mapping replayed as CUDA graphs: the share of the keyframes in
the traced run's chunks after its traced span whose `mapping.local` span
holds graph replays and no capture, by the port's program counters
`graph_replay` and `graph_capture` (`utils/graphs`), summed over the
span's children (`benchmark/harness/spans.py`). 100 when every keyframe
of the window replays graphs captured in set-up. Where the port counts no
graph at all (a port without them, or none on the device), nothing is
read."""

from benchmark.harness import spans

REPLAY, CAPTURE = "graph_replay", "graph_capture"


def read(run: dict):
    rec = spans.record()
    if rec is None or not run.get("trace_frames"):
        return None
    got = spans.window_chunks(rec, int(run["trace_frames"]))
    if got is None:
        return None
    chunks, _, kids = got
    counts = rec["counts"]
    local = [s for s in spans.subtree(kids, chunks) if s.name == "mapping.local"]
    tallies = []
    for s in local:
        n = {REPLAY: 0, CAPTURE: 0}
        for t in spans.subtree(kids, [s]):
            for k in n:
                n[k] += counts.get(t.id, {}).get(k, 0)
        tallies.append(n)
    if not any(n[REPLAY] or n[CAPTURE] for n in tallies):
        return None
    replayed = sum(1 for n in tallies if n[REPLAY] and not n[CAPTURE])
    return 100.0 * replayed / len(tallies)
