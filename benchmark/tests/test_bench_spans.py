"""The per-stage readers on a synthetic span record, and the idle
attribution on synthetic intervals (`benchmark/harness/spans.py`)."""

import pytest

from benchmark.harness import spans
from benchmark.metrics import (extract_ms_per_frame, host_syncs_per_frame,
                               kf_branch_ms_per_kf, objects_ms_per_frame,
                               planes_ms_per_frame, track_ms_per_frame)
from eao_fusion_tpu_torch.utils.profiling import Span

MS = 1_000_000  # ns
MAIN, GBA = 1, 2


class _Rec:
    """Builds a record as `profiling.drain()` gives it."""

    def __init__(self):
        self.spans, self.counts, self.next = [], {}, 1

    def add(self, name, t0, t1, parent=0, thread=MAIN, syncs=0):
        sid = self.next
        self.next += 1
        self.spans.append(Span(sid, parent, name, t0, t1, t0 + 10, t1 + 10,
                               thread, None, None))
        if syncs:
            self.counts[sid] = {"host_sync": syncs}
        return sid

    def chunk(self, t0, frames, kf_frames=()):
        """A chunk of `frames` frames of 10 ms from t0 ms: extract 2,
        planes 1, track 3, objects 2 (1 sync each), gate 1 (1 sync), and
        on `kf_frames` a 20 ms keyframe branch (3 syncs)."""
        c = self.add("steady.slam_chunk", t0 * MS, (t0 + 30 * frames) * MS)
        t = t0
        for f in range(frames):
            kf = f in kf_frames
            st = self.add("steady.step", t * MS, (t + (30 if kf else 10))
                          * MS, parent=c)
            u = t
            for name, d, n in (("frontend.extract", 2, 0),
                               ("frontend.planes", 1, 0),
                               ("tracking.track", 3, 0),
                               ("objects.lane", 2, 1),
                               ("steady.gate", 1, 1)):
                self.add(name, u * MS, (u + d) * MS, parent=st, syncs=n)
                u += d
            if kf:
                self.add("mapping.kf_branch", u * MS, (u + 20) * MS,
                         parent=st, syncs=3)
            t += 30
        return c

    def record(self):
        return dict(spans=self.spans, counts=self.counts,
                    anchor=(10, 0), threads={MAIN: "main", GBA: "gba"},
                    main_thread=MAIN)


@pytest.fixture
def recorded():
    """Put a synthetic record where the readers look for the recorder's."""
    saved = list(spans._record)

    def put(rec):
        spans._record[:] = [rec]
    yield put
    spans._record[:] = saved


def _two_traced_two_later():
    r = _Rec()
    r.chunk(0, 4, kf_frames=(1,))          # traced chunks: not read
    r.chunk(200, 4, kf_frames=(0, 2))
    r.chunk(400, 4, kf_frames=(3,))        # read
    r.chunk(600, 4)
    r.add("loop.gba", 450 * MS, 700 * MS, thread=GBA, syncs=50)
    r.add("system.epilogue", 590 * MS, 595 * MS, syncs=7)
    return r.record()


def test_stage_readers_take_the_chunks_after_the_traced_span(recorded):
    recorded(_two_traced_two_later())
    run = dict(trace_frames=8)
    assert extract_ms_per_frame.read(run) == pytest.approx(2.0)
    assert planes_ms_per_frame.read(run) == pytest.approx(1.0)
    assert track_ms_per_frame.read(run) == pytest.approx(3.0)
    assert objects_ms_per_frame.read(run) == pytest.approx(2.0)
    assert kf_branch_ms_per_kf.read(run) == pytest.approx(20.0)
    # 2 a frame, and 3 on the one keyframe of 8 frames; the GBA thread's
    # and the epilogue's are not the step's
    assert host_syncs_per_frame.read(run) == pytest.approx(2 + 3 / 8)
    # an untraced run (no traced span) reads nothing; a shorter traced
    # span leaves three chunks, 3 keyframes in 12 frames
    assert kf_branch_ms_per_kf.read(dict(trace_frames=0)) is None
    assert host_syncs_per_frame.read(dict(trace_frames=4)) == \
        pytest.approx((2 * 12 + 3 * 3) / 12)


def test_readers_return_nothing_without_spans(recorded):
    run = dict(trace_frames=8)
    readers = (extract_ms_per_frame, planes_ms_per_frame, track_ms_per_frame,
               objects_ms_per_frame, kf_branch_ms_per_kf,
               host_syncs_per_frame)
    recorded(None)                          # a port without the recorder
    assert all(m.read(run) is None for m in readers)
    recorded(_Rec().record())               # recording never turned on
    assert all(m.read(run) is None for m in readers)
    r = _Rec()
    r.chunk(0, 4)
    r.chunk(200, 4)
    recorded(r.record())                    # all chunks in the traced span
    assert all(m.read(run) is None for m in readers)
    r = _Rec()                              # no keyframe, no sync counted
    for t in (0, 200, 400):
        c = r.add("steady.slam_chunk", t * MS, (t + 10) * MS)
        r.add("steady.step", t * MS, (t + 10) * MS, parent=c)
    recorded(r.record())
    assert kf_branch_ms_per_kf.read(dict(trace_frames=1)) is None
    assert host_syncs_per_frame.read(dict(trace_frames=1)) is None


def test_record_reads_the_port_once_and_shares_it(recorded):
    from eao_fusion_tpu_torch.utils import profiling
    spans._record.clear()
    profiling.enable()
    try:
        with profiling.span("steady.slam_chunk"):
            pass
    finally:
        profiling.disable()
    rec = spans.record()
    assert [s.name for s in rec["spans"]] == ["steady.slam_chunk"]
    assert spans.record() is rec and profiling.drain()["spans"] == []


def test_innermost_segments():
    # A [0, 100) holds B [10, 40) which holds C [20, 30); D [50, 60) in A;
    # E [120, 130) alone
    segs = spans.innermost_segments([(0, 100, "A"), (10, 40, "B"),
                                     (20, 30, "C"), (50, 60, "D"),
                                     (120, 130, "E")])
    assert segs == [(0, 10, "A"), (10, 20, "B"), (20, 30, "C"),
                    (30, 40, "B"), (40, 50, "A"), (50, 60, "D"),
                    (60, 100, "A"), (120, 130, "E")]


def test_idle_attribution_splits_gaps_between_spans():
    busy = [(0, 10, "k0"), (50, 60, "k1"), (100, 110, "k2"),
            (200, 210, "k3")]
    gaps = spans.idle_gaps(busy)
    assert gaps == [(10, 50, "k1"), (60, 100, "k2"), (110, 200, "k3")]
    segs = spans.innermost_segments([(0, 40, "a"), (40, 80, "x"),
                                     (80, 105, "b")])
    total, named = spans.attribute(gaps, segs)
    # gap 1 [10, 50): 30 in a, 10 in x; gap 2 [60, 100): 20 in x, 20 in b;
    # gap 3 [110, 200): outside every span
    assert total == {"a": 30, "x": 30, "b": 20, spans.OUTSIDE: 90}
    assert named == [(40, "a", "k1"), (40, "x", "k2"),
                     (90, spans.OUTSIDE, "k3")]


def test_main_thread_segments_use_the_unix_clock():
    r = _Rec()
    r.add("outer", 0, 100)
    r.add("inner", 20, 30, parent=1)
    r.add("loop.gba", 0, 100, thread=GBA)
    segs = spans.main_thread_segments(r.record())
    assert segs == [(10, 30, "outer"), (30, 40, "inner"),
                    (40, 110, "outer")]


def _traced_events():
    """Device events on the unix clock (the spans' own +10 ns) of the
    first chunk of `_Rec.chunk(0, 4, kf_frames=(1,))`: a kernel in each
    frame's tracking, the gate's read ending 50 µs before its span, a
    copy to the card in frame 0's tracking, and one kernel at 150 ms,
    after the chunk and outside every span."""
    def u(ms):
        return round(ms * MS) + 10
    ev = [("Memcpy HtoD (Pageable -> Device)", u(3.2), u(3.3) - u(3.2))]
    for t in (0, 30, 60, 90):
        ev.append(("k_track", u(t + 4), MS))
        ev.append(("Memcpy DtoH (Device -> Pageable)", u(t + 8.9),
                   u(t + 8.95) - u(t + 8.9)))
    ev.append(("k_end", u(150), MS))
    return ev


def test_stage_tool_on_a_synthetic_trace():
    from benchmark.tools import stages
    r = _Rec()
    r.chunk(0, 4, kf_frames=(1,))          # the traced chunk
    r.chunk(200, 4)                        # after the traced span
    rec = r.record()
    out = stages.traced_analysis(rec, _traced_events(), frames=4)

    assert out["gate_copy_lag_us"] == pytest.approx([50.0] * 3)
    # busy 5.3 ms from 3.2 to 151 ms; 30 ms (120-150) in no span
    assert out["idle_s"] == pytest.approx(142.5e-3)
    assert out["named_idle_share"] == pytest.approx(1 - 30 / 142.5)
    assert out["idle_by_span"][spans.OUTSIDE] == pytest.approx(30e-3)
    assert out["idle_by_span"]["mapping.kf_branch"] == pytest.approx(20e-3)
    # the longest gap is mostly outside; the next three (25.05 ms each)
    # are held by the chunk between steps, the keyframe branch, the chunk
    names = [n for n, _ in out["idle_gaps"][:4]]
    assert names == ["outside_spans | before k_end",
                     "steady.slam_chunk | before k_track",
                     "mapping.kf_branch | before k_track",
                     "steady.slam_chunk | before k_track"]
    assert out["idle_gaps"][0][1] == pytest.approx(51.05e-3)
    # stages: 9 ms of each 10 ms frame, 29 of the 30 ms keyframe
    assert out["traced_coverage"] == pytest.approx(56 / 120)
    assert out["syncs_and_copies"] == {
        "objects.lane": dict(syncs=4, dtoh=0, htod=0),
        "steady.gate": dict(syncs=4, dtoh=4, htod=0),
        "mapping.kf_branch": dict(syncs=3, dtoh=0, htod=0),
        "tracking.track": dict(syncs=0, dtoh=0, htod=1)}

    chunks, frames, _ = spans.window_chunks(rec, 4)
    assert frames == 4 and stages.coverage(rec, chunks) == \
        pytest.approx(36 / 120)
    tab = stages.stage_table(rec, chunks, frames)
    assert list(tab)[0] == "steady.slam_chunk"
    assert tab["steady.slam_chunk"] == pytest.approx([30.0, 0.25, 0.0])
    assert tab["frontend.extract"] == pytest.approx([2.0, 1.0, 0.0])
    assert tab["objects.lane"] == pytest.approx([2.0, 1.0, 1.0])
    assert "mapping.kf_branch" not in tab


def test_split_chunks_at_the_traced_frames():
    r = _Rec()
    a = r.chunk(0, 4)
    b = r.chunk(200, 3)
    c = r.chunk(400, 4)
    before, after, _ = spans.split_chunks(r.record(), 5)
    assert [(s.id, n) for s, n in before] == [(a, 4), (b, 3)]
    assert [(s.id, n) for s, n in after] == [(c, 4)]
    before, after, _ = spans.split_chunks(r.record(), 0)
    assert before == [] and len(after) == 3


def test_cost_summary_pairs_each_recorded_chunk_with_its_neighbour():
    from benchmark.tools import stages
    per = [(0, 10.0, False), (1, 11.0, True), (2, 12.0, True),
           (3, 10.0, False), (4, 9.0, False)]
    out = stages.cost_summary(per)
    assert out["on_ms_per_frame"] == pytest.approx(11.5)
    assert out["off_ms_per_frame"] == pytest.approx(10.0)
    assert out["on_over_off"] == pytest.approx(1.15)
    # chunk 1 over chunk 0, chunk 2 over chunk 3
    assert out["on_over_off_pairs"] == pytest.approx([1.1, 1.2])
    assert out["chunks"][1] == [1, 11.0, True]
