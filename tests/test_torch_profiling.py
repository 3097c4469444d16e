"""The port's recorder of host spans and counters (`utils/profiling.py`):
off by default and free when off, the span tree with its frame and chunk
ids, counts on the innermost span, the unix-ns clock that the profiler's
events share, the steady chunked loop's spans on the CPU, and the CLI's
Chrome trace (`run_tum --spans`). The card test checks the shared clock
against a kernel's own device timestamp and counts the card's host
syncs."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from eao_fusion_tpu_torch import config as TC
from eao_fusion_tpu_torch.apps import run_tum
from eao_fusion_tpu_torch.io import synthetic
from eao_fusion_tpu_torch.pipeline import steady, tracking
from eao_fusion_tpu_torch.pipeline.system import System
from eao_fusion_tpu_torch.tools.make_tum_dataset import write_dataset
from eao_fusion_tpu_torch.utils import profiling

# the top-level stages of one steady frame, in the order they run
STEP_STAGES = ("frontend.extract", "frontend.planes", "tracking.track",
               "objects.lane", "steady.gate")


@pytest.fixture(autouse=True)
def _recorder_off():
    """Every test starts and ends with the recorder off and empty."""
    profiling.disable()
    profiling.drain()
    yield
    profiling.disable()
    profiling.drain()


@pytest.fixture(scope="module")
def seq():
    """The seed-0 arc, rendered here (about 15 s on the CPU) and kept in
    memory only."""
    return synthetic.generate_sequence(n_frames=20, seed=0, style="arc")


def _by_name(rec):
    out = {}
    for s in rec["spans"]:
        out.setdefault(s.name, []).append(s)
    return out


def test_off_records_nothing_and_returns_the_shared_null_context():
    assert not profiling.enabled()
    a, b = profiling.span("x"), profiling.span("y", frame=3)
    assert a is b
    with a:
        profiling.count("host_sync")
    rec = profiling.drain()
    assert rec["spans"] == [] and rec["counts"] == {}


def test_nesting_gives_parent_ids_and_closing_order():
    profiling.enable()
    with profiling.span("outer"):
        with profiling.span("inner"):
            pass
        with profiling.span("inner"):
            pass
    with profiling.span("alone"):
        pass
    rec = profiling.drain()
    names = [s.name for s in rec["spans"]]
    assert names == ["inner", "inner", "outer", "alone"]
    outer = rec["spans"][2]
    assert [s.parent for s in rec["spans"]] == [outer.id, outer.id, 0, 0]
    assert len({s.id for s in rec["spans"]}) == 4
    for s in rec["spans"][:2]:
        assert outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns
    assert {s.thread for s in rec["spans"]} == {threading.get_ident()}
    assert rec["main_thread"] == threading.get_ident()


def test_an_exception_closes_its_span():
    profiling.enable()
    with pytest.raises(RuntimeError):
        with profiling.span("outer"):
            with profiling.span("failing"):
                raise RuntimeError("boom")
    with profiling.span("after"):
        pass
    rec = profiling.drain()
    assert [s.name for s in rec["spans"]] == ["failing", "outer", "after"]
    assert rec["spans"][2].parent == 0      # the stack was unwound


def test_counts_go_to_the_innermost_span():
    profiling.enable()
    profiling.count("host_sync")             # outside every span: id 0
    with profiling.span("outer"):
        profiling.count("host_sync", 2)
        with profiling.span("inner"):
            profiling.count("host_sync")
            profiling.count("other", 5)
        profiling.count("host_sync")
    rec = profiling.drain()
    inner, outer = rec["spans"]
    assert rec["counts"] == {0: {"host_sync": 1},
                             outer.id: {"host_sync": 3},
                             inner.id: {"host_sync": 1, "other": 5}}


def test_frame_and_chunk_ids_are_inherited():
    profiling.enable()
    with profiling.span("chunk", chunk=40):
        for f in (40, 41):
            with profiling.span("step", frame=f):
                with profiling.span("stage"):
                    pass
    with profiling.span("epilogue", chunk=40):
        with profiling.span("read"):
            pass
    got = [(s.name, s.frame, s.chunk) for s in profiling.drain()["spans"]]
    assert got == [("stage", 40, 40), ("step", 40, 40), ("stage", 41, 40),
                   ("step", 41, 40), ("chunk", None, 40),
                   ("read", None, 40), ("epilogue", None, 40)]


def test_each_thread_keeps_its_own_stack():
    profiling.enable()
    seen = {}

    def work():
        with profiling.span("loop.gba"):
            profiling.count("host_sync")
        seen["id"] = threading.get_ident()

    with profiling.span("main"):
        t = threading.Thread(target=work, name="eao-gba")
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    rec = profiling.drain()
    by = _by_name(rec)
    gba, main = by["loop.gba"][0], by["main"][0]
    assert gba.parent == 0 and gba.thread == seen["id"] != main.thread
    assert rec["counts"] == {gba.id: {"host_sync": 1}}
    assert rec["threads"][seen["id"]] == "eao-gba"


def test_unix_times_lie_between_time_ns_readings():
    profiling.enable()
    before = time.time_ns()
    with profiling.span("x"):
        time.sleep(0.002)
    after = time.time_ns()
    s, = profiling.drain()["spans"]
    # the anchor pair is read within microseconds; allow 1 ms either side
    assert before - 1_000_000 <= s.start_unix_ns < s.end_unix_ns \
        <= after + 1_000_000
    assert s.end_unix_ns - s.start_unix_ns == s.end_ns - s.start_ns
    assert s.end_ns - s.start_ns >= 2_000_000


def test_a_profiler_range_lies_inside_its_span():
    """The CPU profiler (Kineto) stamps a `record_function` range on the
    unix-ns clock: inside the span that encloses it, converted."""
    from torch.profiler import ProfilerActivity, profile, record_function
    profiling.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("outer"):
            time.sleep(0.001)
            with record_function("marker"):
                torch.ones(256).cumsum(0)
            time.sleep(0.001)
    s, = profiling.drain()["spans"]
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "marker"]
    assert len(ev) == 1
    start, end = ev[0].start_ns(), ev[0].start_ns() + ev[0].duration_ns()
    assert s.start_unix_ns <= start <= end <= s.end_unix_ns


def test_follow_profiler_turns_recording_on_and_keeps_it_on():
    from torch.profiler import ProfilerActivity, profile
    profiling.follow_profiler()
    assert not profiling.enabled()
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.follow_profiler()
        assert profiling.enabled()
    assert profiling.enabled()


def test_chrome_trace_and_report():
    profiling.enable()
    with profiling.span("steady.step", frame=7):
        profiling.count("host_sync", 2)
        with profiling.span("tracking.track"):
            pass
    rec = profiling.drain()
    tr = profiling.chrome_trace(rec, pid=5)
    xs = [e for e in tr["traceEvents"] if e["ph"] == "X"]
    meta = [e for e in tr["traceEvents"] if e["ph"] == "M"]
    assert [e["name"] for e in xs] == ["tracking.track", "steady.step"]
    step = xs[1]
    assert step["args"] == {"frame": 7, "host_sync": 2}
    assert step["ts"] == rec["spans"][1].start_unix_ns / 1e3
    assert step["tid"] == threading.get_ident() and step["pid"] == 5
    assert any(e["tid"] == step["tid"] for e in meta)
    json.dumps(tr)
    lines = profiling.report(rec).splitlines()
    assert lines[0].split()[0] == "steady.step" and "2 syncs" in lines[0]


def _cfg():
    return TC.SystemConfig(
        orb=TC.ORBConfig(n_features=500, max_keypoints=512),
        capacity=TC.MapCapacity(max_keyframes=32, max_points=2048))


def test_slam_chunk_records_the_step_tree(seq):
    """A small steady chunk on the CPU, planes and objects on, recorder
    on: one `steady.step` a frame under `steady.slam_chunk`, each with its
    stages in order, `mapping.kf_branch` exactly on the frames that
    inserted a keyframe, local mapping's stages and LM iterations under
    it, and the epilogue's spans under `system.epilogue`."""
    torch.set_num_threads(1)
    cfg = _cfg()
    s = System(cfg, device="cpu")
    for f in seq.frames[:4]:
        s.process_frame(f.gray, f.depth, f.timestamp, boxes=f.boxes)
    assert int(s.track.status) == tracking.STATUS_OK
    st = steady.init_steady_state(s)
    fr = seq.frames[4:10]
    bx = np.zeros((len(fr), cfg.objects.max_objects_2d, 6), np.float32)
    for i, f in enumerate(fr):
        b = f.boxes[:len(bx[i])]
        bx[i, :len(b)] = b
    grays = torch.from_numpy(np.stack([f.gray for f in fr]))
    depths = torch.from_numpy(np.stack([f.depth for f in fr]))
    tss = torch.tensor([f.timestamp for f in fr], dtype=torch.float32)
    kf_before, fid0 = int(st.m.next_kf), st.frame_id

    profiling.enable()
    st, diag = steady.slam_chunk(st, grays, depths, torch.from_numpy(bx),
                                 tss, cfg=cfg)
    s.record_chunk(st, diag, tss)
    st = s.chunk_epilogue(st, kf_before)
    profiling.disable()
    rec = profiling.drain()

    spans = {sp.id: sp for sp in rec["spans"]}
    by = _by_name(rec)
    chunk, = by["steady.slam_chunk"]
    steps = by["steady.step"]
    assert [sp.frame for sp in steps] == list(range(fid0, fid0 + len(fr)))
    assert all(sp.parent == chunk.id and sp.chunk == fid0 for sp in steps)
    kf = diag["kf_inserted"].tolist()
    assert any(kf) and not all(kf)
    for sp, inserted in zip(steps, kf):
        kids = sorted((c for c in rec["spans"] if c.parent == sp.id),
                      key=lambda c: c.start_ns)
        names = tuple(c.name for c in kids)
        assert names == STEP_STAGES + (("mapping.kf_branch",)
                                       if inserted else ())
        assert all(c.frame == sp.frame for c in kids)

    def ancestors(sp):
        out = []
        while sp.parent:
            sp = spans[sp.parent]
            out.append(sp.name)
        return out

    for name in ("mapping.insert", "mapping.points", "mapping.plane_map",
                 "mapping.local", "objects.merge_overlap"):
        assert len(by[name]) == sum(kf)
        assert all(ancestors(sp)[0] == "mapping.kf_branch"
                   for sp in by[name])
    for name in ("mapping.cull_points", "mapping.fuse", "mapping.window",
                 "mapping.local_ba", "mapping.writeback"):
        assert [ancestors(sp)[0] for sp in by[name]] == \
            ["mapping.local"] * sum(kf)
    assert by["solvers.lm_iter"]
    assert all(ancestors(sp)[0] == "mapping.local_ba"
               for sp in by["solvers.lm_iter"])
    for name in ("objects.build", "objects.merge", "objects.associate",
                 "objects.update"):
        assert len(by[name]) == len(fr)
    assert len(by["tracking.pose_solve"]) == 2 * len(fr)
    rc, = by["system.record_chunk"]
    ep, = by["system.epilogue"]
    assert rc.chunk == ep.chunk == fid0 and rc.parent == ep.parent == 0
    for name in ("epilogue.read", "epilogue.gba_poll",
                 "epilogue.compact_points", "epilogue.compact_kfs",
                 "loop.dispatch_detect"):
        sp, = by[name]
        assert ancestors(sp) == ["system.epilogue"]
    # the step's stages cover nearly all of the chunk's host time
    covered = sum(c.end_ns - c.start_ns for c in rec["spans"]
                  if c.parent in {sp.id for sp in steps})
    assert covered >= 0.9 * (chunk.end_ns - chunk.start_ns)
    # no card here: nothing counts a host sync
    assert all(profiling.SYNC_COUNTER not in c
               for c in rec["counts"].values())


def test_cli_writes_the_spans_as_a_chrome_trace(tmp_path, seq, capsys):
    torch.set_num_threads(1)
    sub = synthetic.SyntheticSequence(frames=seq.frames[:6],
                                      camera=seq.camera, scene=seq.scene)
    ds = tmp_path / "ds"
    write_dataset(str(ds), sub)
    out = tmp_path / "spans.json"
    log = tmp_path / "log.jsonl"
    run_tum.main([str(ds), "--device", "cpu", "--boxes", str(ds / "boxes"),
                  "--chunk", "3", "--out", str(tmp_path / "t.txt"),
                  "--log-jsonl", str(log), "--spans", str(out)])
    assert not profiling.enabled()
    tr = json.loads(out.read_text())
    xs = [e for e in tr["traceEvents"] if e["ph"] == "X"]
    steps = [e for e in xs if e["name"] == "steady.step"]
    assert len(steps) == 3
    assert [e["name"] for e in xs].count("system.epilogue") == 1
    assert all(e["ts"] > 1.6e15 and e["dur"] > 0 for e in xs)   # unix µs
    frames = [json.loads(line) for line in open(log)]
    frames = [r for r in frames if "frame" in r]
    kf = [e for e in xs if e["name"] == "mapping.kf_branch"]
    assert len(kf) == sum(r["kf_inserted"] for r in frames[-3:])
    assert "steady.step" in capsys.readouterr().out


@pytest.mark.gpu
def test_card_spans_share_the_device_clock_and_count_syncs():
    """On the card: a kernel launched inside a span starts on the device,
    by the profiler's CUPTI trace, after the span opened (on the shared
    unix-ns clock) and within a second of it; `.item()`, `.tolist()` and
    boolean-mask indexing each count one host sync, on their own span."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(1 << 20, device="cuda")
    x.cumsum(0)
    torch.cuda.synchronize()
    profiling.enable()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with profiling.span("marker"):
            torch.cuda._sleep(1_000_000)
            x.cumsum(0)
        torch.cuda.synchronize()
    with profiling.span("reads"):
        y = x[:8].clone()
        y.sum().item()
        with profiling.span("mask"):
            y[y > 0]
        y.tolist()
    rec = profiling.drain()
    by = _by_name(rec)
    span = by["marker"][0]
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.device_type() == torch.autograd.DeviceType.CUDA]
    assert ev
    first = min(e.start_ns() for e in ev)
    assert span.start_unix_ns <= first <= span.start_unix_ns + 1_000_000_000
    reads, mask = by["reads"][0], by["mask"][0]
    assert rec["counts"][reads.id][profiling.SYNC_COUNTER] == 2
    assert rec["counts"][mask.id][profiling.SYNC_COUNTER] >= 1
