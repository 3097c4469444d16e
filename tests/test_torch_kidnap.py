"""The kidnap contract (tests/torch_contracts.py) on the port against the
JAX package, on the CPU: a loss in a region that capacity eviction
removed, and the return into the live map.

Tier-1, on the cached 20-frame seed-0 arc: relocalization after an
eviction and a keyframe compaction, both packages on one map state
carried across; lost frames through `process_frame` and through the
steady chunks insert nothing. `slow`: the kidnap workload of
`chip_smoke.py` phase 31a (the 240-frame seed-5 corridor at 320x240, 24
keyframe slots), the JAX System and the port's through `process_frame`,
and both packages' steady chunks of 8; 31b's return (full width) from one
state on both packages. The slow tests render the corridors into
build/synth_cache (about 20 s and 40 s with 8 processes). Each test
states its tolerance."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eao_fusion_tpu import config as JC
from eao_fusion_tpu import types as JT
from eao_fusion_tpu.frontend import extractor as JE
from eao_fusion_tpu.io import synthetic as JS
from eao_fusion_tpu.mapping import map_state as JMS
from eao_fusion_tpu.mapping import vocabulary as JV
from eao_fusion_tpu.pipeline import loop_closing as JLC
from eao_fusion_tpu.pipeline import relocalization as JRel
from eao_fusion_tpu.pipeline import steady as JSt
from eao_fusion_tpu.pipeline.system import System as JSystem
from eao_fusion_tpu.pipeline.system import (_compact_keyframes_jit,
                                            _evict_keyframes_jit)
from eao_fusion_tpu_torch import config as TC
from eao_fusion_tpu_torch.frontend import extractor as TE
from eao_fusion_tpu_torch.io import synthetic as TS
from eao_fusion_tpu_torch.mapping import map_state as TMS
from eao_fusion_tpu_torch.mapping import vocabulary as TV
from eao_fusion_tpu_torch.ops import lie as TL
from eao_fusion_tpu_torch.pipeline import loop_closing as TLC
from eao_fusion_tpu_torch.pipeline import relocalization as TRel
from eao_fusion_tpu_torch.pipeline import steady, tracking
from eao_fusion_tpu_torch.pipeline.system import System
from eao_fusion_tpu_torch.types import FrameFeatures, tree_from_numpy

import torch_contracts as C

T = torch.from_numpy
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH_CACHE = os.path.join(ROOT, "build", "synth_cache")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This module's torch ops on one CPU thread (tier-1 runs six test
    files at once); the setting is put back after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_cfg(t):
    """The JAX package's SystemConfig with the port configuration `t`'s
    fields (the two are field-for-field copies, tests/test_torch_config)."""
    if dataclasses.is_dataclass(t):
        return getattr(JC, type(t).__name__)(**{
            f.name: jax_cfg(getattr(t, f.name))
            for f in dataclasses.fields(t)})
    return t


def _jax_draws(key, valid, n_hyp, k):
    """The hypothesis indices the JAX RANSAC draws from `key`
    (`jax.random.choice` over the valid rows, with replacement)."""
    p = np.asarray(valid, np.float32)
    p = p / max(p.sum(), 1.0)
    return T(np.array(jax.random.choice(key, len(p), shape=(n_hyp, k),
                                        replace=True, p=jnp.asarray(p)))
             ).long()


def _jax_feats(feats):
    """The port's FrameFeatures as the JAX package's (the packed
    descriptor words as uint32)."""
    return JT.FrameFeatures(**{
        k: jnp.asarray(v.numpy().view(np.uint32) if k == "desc_packed"
                       else v.numpy())
        for k, v in feats._asdict().items()})


def _pose_gap(a, b) -> tuple:
    """(metres, radians) between two Tcw poses."""
    d = TL.se3_log(TL.se3_compose(
        TL.se3_inverse(torch.as_tensor(np.asarray(a, np.float32))),
        torch.as_tensor(np.asarray(b, np.float32)))).numpy()
    return float(np.linalg.norm(d[3:])), float(np.linalg.norm(d[:3]))


# ------------------------------------------------------------------ tier-1

ARC_FRAMES = 14


def _arc_cfg():
    """A small RGBD configuration with loop closing on (the BoW database
    relocalization reads), a keyframe at least every 2 frames (7 in
    ARC_FRAMES frames) and no automatic reset, so that a loss goes to
    relocalization."""
    base = TC.SystemConfig(
        orb=TC.ORBConfig(n_features=500, max_keypoints=512),
        capacity=TC.MapCapacity(max_keyframes=10, max_points=3072,
                                max_local_ba_kfs=16),
        use_planes=False, use_objects=False)
    return base.replace(tracking=dataclasses.replace(
        base.tracking, reset_if_lost_below_kfs=0, max_frames_between_kf=2))


@pytest.fixture(scope="module")
def arc_run():
    """The port's System after the first ARC_FRAMES frames of the cached
    20-frame seed-0 arc, the sequence, and its map and BoW rows as they
    were then (numpy)."""
    seq = TS.generate_sequence(n_frames=20, seed=0, style="arc",
                               cache_dir=JS.DEFAULT_CACHE)
    s = System(_arc_cfg(), device="cpu")
    for f in seq.frames[:ARC_FRAMES]:
        s.process_frame(f.gray, f.depth, f.timestamp)
    assert int(s.track.status) == tracking.STATUS_OK
    return s, seq, TMS.to_numpy(s.map), s.loop_closer.bow.numpy().copy()


def test_relocalize_after_eviction_matches_jax(arc_run, monkeypatch):
    """On one map state carried across: `evict_keyframes` (4 of the 7
    live, the 3 newest protected, as the System protects at 10 slots),
    `compact_keyframes` and the loop closer's `apply_kf_remap` give the
    same live keyframes, remap and BoW rows on both packages (exactly).
    Then for the frame of an evicted keyframe and for the live newest
    frame: the same relocalization candidates (equal lists), and
    `relocalize` fed the JAX RANSAC draws the same outcome, the pose
    within 1e-4."""
    s, seq, d, bow = arc_run
    tcfg = s.cfg
    jcfg = jax_cfg(tcfg)
    jv, tv = JV.Vocabulary.load(), s.loop_closer.vocab
    mj = JMS.MapState(**{k: jnp.asarray(v) for k, v in d.items()})
    mt = TMS.from_numpy(d, "cpu")
    assert int(d["kf_valid"].sum()) == 7
    # the JAX System's own jitted eviction and compaction
    mj = _evict_keyframes_jit(mj, n_evict=4, protect_recent=3)
    mt = TMS.evict_keyframes(mt, 4, protect_recent=3)
    np.testing.assert_array_equal(mt.kf_valid.numpy(),
                                  np.asarray(mj.kf_valid))
    mj, rj = _compact_keyframes_jit(mj)
    mt, rt = TMS.compact_keyframes(mt)
    rj = np.asarray(rj)
    np.testing.assert_array_equal(rt.numpy(), rj)
    for k in ("kf_valid", "kf_pose", "kf_pt_idx", "pt_valid", "pt_xyz",
              "kf_frame_id", "obs_ind"):
        np.testing.assert_array_equal(getattr(mt, k).numpy(),
                                      np.asarray(getattr(mj, k)), err_msg=k)
    lj = JLC.LoopCloser(jcfg, jv)
    lt = TLC.LoopCloser(tcfg, tv, torch.Generator())
    lj.bow, lt.bow = jnp.asarray(bow), T(bow.copy())
    lj.apply_kf_remap(rj)
    lt.apply_kf_remap(rj.copy())
    np.testing.assert_array_equal(lt.bow.numpy(), np.asarray(lj.bow))

    evicted = [int(f) for f in d["kf_frame_id"][d["kf_valid"] & (rj < 0)]]
    assert len(evicted) == 4, evicted
    live = ARC_FRAMES - 1
    key = jax.random.PRNGKey(3)
    monkeypatch.setattr(TRel.ransac, "draw_hypotheses",
                        lambda valid, n, k, g: _jax_draws(key, valid.numpy(),
                                                          n, k))
    found = {}
    for frame in (evicted[0], live):
        f = seq.frames[frame]
        feats = TE.extract_features(
            torch.as_tensor(f.gray), torch.as_tensor(f.depth),
            orb_cfg=tcfg.orb, cam_cfg=tcfg.camera)
        jf = _jax_feats(feats)
        vt = TV.bow_vector(tv, feats.desc_pm1, feats.valid)
        vj = JV.bow_vector(jv, jf.desc_pm1, jf.valid)
        # tests/test_torch_loop.py's bound on a bow vector
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-6)
        np.testing.assert_array_equal(
            TRel.reloc_candidates(mt, vt, lt.bow),
            JRel.reloc_candidates(mj, vj, lj.bow))
        pj, _ = JRel.relocalize(mj, jf, lj.bow, jv, key, cfg=jcfg)
        pt, kt = TRel.relocalize(mt, feats, lt.bow, tv, torch.Generator(),
                                 cfg=tcfg)
        assert (pt is None) == (pj is None), frame
        if pt is not None:
            np.testing.assert_allclose(pt.numpy(), np.asarray(pj),
                                       atol=1e-4)
            found[frame] = _pose_gap(pt, f.tcw)
    print(f"[reloc after eviction] evicted keyframes of frames {evicted}; "
          f"relocalized (m, rad from the truth): {found}")
    # the live view comes back
    assert live in found and found[live][0] < 0.05 and found[live][1] < 0.05


def test_lost_frames_insert_nothing(arc_run):
    """Three noise frames without depth through `process_frame`, then a
    chunk of four through `slam_chunk` and `chunk_epilogue`, leave
    `kf_valid`, `kf_pose`, `pt_valid` and `pt_xyz` bit for bit as they
    were and the lifetime keyframe count unchanged; the tracker loses
    every one of them and no keyframe is inserted."""
    s, seq, _, _ = arc_run
    gate = s.cfg.tracking.min_matches_track
    shape = seq.frames[0].gray.shape
    r = np.random.default_rng(0)
    snap, n_kf = C.map_snapshot(s.map), s.n_keyframes
    for k in range(3):
        s.process_frame(r.uniform(0, 1, shape).astype(np.float32),
                        np.zeros(shape, np.float32), 1.0 + k / 30.0)
        assert s.diags[-1]["n_inliers"] < gate
        assert C.map_unchanged(s.map, snap) and s.n_keyframes == n_kf
    assert int(s.track.status) == tracking.STATUS_LOST

    st = steady.init_steady_state(s)
    kf_before = int(st.m.next_kf)
    noise = [dataclasses.replace(seq.frames[0], gray=r.uniform(
        0, 1, shape).astype(np.float32), depth=np.zeros(shape, np.float32),
        timestamp=1.1 + k / 30.0, boxes=np.zeros((0, 6), np.float32))
        for k in range(4)]
    st, diag = steady.slam_chunk(
        st, *C.chunk_tensors(s.cfg, noise, False, "cpu"), cfg=s.cfg)
    assert (diag["n_inliers"] < gate).all()
    assert not diag["kf_inserted"].any()
    assert C.map_unchanged(st.m, snap)
    s.record_chunk(st, diag, [f.timestamp for f in noise])
    st = s.chunk_epilogue(st, kf_before)
    assert C.map_unchanged(st.m, snap)
    assert int(st.m.next_kf) == kf_before
    assert int(st.ts.status) == tracking.STATUS_LOST


# -------------------------------------------------------------------- slow

def _corridor():
    return TS.render_sequences([C.EXPLORATION_SPEC], workers=8,
                               cache_dir=SYNTH_CACHE)[0]


def _jax_track(ts):
    """The JAX track state as the port's."""
    return tracking.track_state_from_numpy(jax.tree.map(np.asarray, ts),
                                           "cpu")


def _port_steps(js, f, tcfg):
    """The port's `track_frame` on frame `f` from the JAX System's map and
    track state before it (carried across whole), on the port's own
    features and on the JAX package's features of the frame: the two
    poses."""
    own = TE.extract_features(torch.as_tensor(f.gray),
                              torch.as_tensor(f.depth), orb_cfg=tcfg.orb,
                              cam_cfg=tcfg.camera)
    jf = JE.extract_features(jnp.asarray(f.gray), jnp.asarray(f.depth),
                             orb_cfg=js.cfg.orb, cam_cfg=js.cfg.camera)
    given = tree_from_numpy(FrameFeatures, jax.tree.map(
        np.asarray, jf)._asdict(), "cpu")
    m = TMS.from_numpy(jax.tree.map(np.asarray, js.map._asdict()), "cpu")
    ts = _jax_track(js.track)
    return [tracking.track_frame(m, ts, feats, js.frame_id, None,
                                 cfg=tcfg)[1].pose.numpy()
            for feats in (own, given)]


@pytest.mark.slow
def test_kidnap_matches_jax_system():
    """31a's workload (the pass, the kidnap, the return at back = 192) on
    the port's CPU System and the JAX System, the same frames: the port
    meets the kidnap contract's premise and bounds (a)-(f) but (e1), a
    relocalization in the return, which neither package makes (the
    tracker's own search brings both back, as the counts held below
    show); the two have the same per-frame tracking status (the tracker's
    gate, and the status each frame ends with), the same evictions and
    lifetime keyframes after the pass, the same count of relocalizations
    and the same recovery frame in the return (within one frame). Poses,
    stepped from the reference's state: on every frame both report OK,
    the port's tracking step from the JAX System's state before the
    frame, given the JAX package's features of the frame, lands within 1
    mm and 1e-3 rad of the JAX pose. The first stage to part is the
    features: the bilinear pyramid sums in another order, so a FAST
    response one ulp apart can swap a keypoint at the top-k cut; on its
    own features the port's step parts by up to a few cm on such frames
    and the two free runs drift apart (both printed; ROADMAP queue 3)."""
    corridor = _corridor()
    n = len(corridor.frames)
    seq = C.kidnap_sequence(corridor, back=C.BACK_EXPLORATION)
    tcfg = C.exploration_cfg()
    gate = tcfg.tracking.min_matches_track

    s = System(tcfg, device="cpu")
    for f in seq.frames[:n]:
        s.process_frame(f.gray, f.depth, f.timestamp)
    port_pass = (s.n_kf_evictions, s.n_keyframes)
    premise = C.check_kidnap(s, seq, n)
    recs = C.run_kidnap_frames(s, seq, n)
    out = C.check_kidnap_run(s, seq, recs, n, chunked=False,
                             standing=("(e1)",))
    print(f"[kidnap, port] premise {premise}; contract {out}")
    port_lost = [d["n_inliers"] < gate for d in s.diags]
    port_traj = s.trajectory_tcw()

    js = JSystem(jax_cfg(tcfg))
    steps, jax_lost, jrecs = [], [], []
    for i, f in enumerate(seq.frames):
        if i == n:
            jax_pass = (js.n_kf_evictions, js.n_keyframes)
        before = (_port_steps(js, f, tcfg) if i > 0 and not port_lost[i - 1]
                  else None)
        nr = js.n_relocalizations
        pose = js.process_frame(f.gray, f.depth, f.timestamp)
        if i == 0:
            continue
        lost = js.diags[-1]["n_inliers"] < gate
        rel = js.n_relocalizations > nr
        jax_lost.append(lost)
        if i >= n:
            jrecs.append(dict(frame=i, lost=lost, relocalized=rel,
                              ok=int(js.track.status) == 1, pose=pose,
                              n_inliers=js.diags[-1]["n_inliers"], ms=0.0,
                              reloc_ms=None, inserted=0))
        if before is not None and not lost and not rel:
            steps.append((i, *_pose_gap(before[1], pose),
                          _pose_gap(before[0], pose)[0]))
    jax_traj = js.trajectory_tcw()
    jsum = C.kidnap_summary(jrecs, False, n)
    free = [_pose_gap(a, b)[0] for a, b in zip(port_traj, jax_traj)]
    port_relocs = [r["frame"] for r in recs if r["relocalized"]]
    jax_relocs = [r["frame"] for r in jrecs if r["relocalized"]]
    gap = np.array([g[1] for g in steps])
    rot = np.array([g[2] for g in steps])
    own = np.array([g[3] for g in steps])
    print(f"[kidnap] JAX pass {jax_pass}, port {port_pass}; relocalizations "
          f"JAX {jax_relocs}, port {port_relocs}; recovery JAX "
          f"{jsum['recovery_frame']} by {jsum['recovered_by']}, port "
          f"{out['recovery']} by {out['recovered_by']}; steps from the JAX "
          f"state {len(steps)}: given the JAX features max "
          f"{gap.max() * 100:.5f} cm, {rot.max():.6f} rad; on the port's "
          f"features max {own.max() * 100:.4f} cm (frame "
          f"{steps[int(own.argmax())][0]}), median "
          f"{np.median(own) * 100:.4f} cm, {int((own > 0.01).sum())} over 1 "
          f"cm; free runs max {max(free) * 100:.3f} cm")
    assert port_lost == jax_lost
    assert [r["ok"] for r in recs] == [r["ok"] for r in jrecs]
    assert port_pass == jax_pass
    assert len(port_relocs) == len(jax_relocs)
    assert abs(out["recovery"] - jsum["recovery_frame"]) <= 1
    assert out["recovered_by"] == jsum["recovered_by"]
    assert len(steps) >= 0.9 * (len(seq.frames) - 1 - sum(jax_lost))
    assert gap.max() < 1e-3 and rot.max() < 1e-3


def _jax_drive_chunks(js, tcfg, seq, lo, chunk, on_chunk=None):
    """The JAX steady chunks and `chunk_epilogue` of JAX System `js` over
    `seq.frames[lo:]`: records in the form of `run_kidnap_chunks`' (what
    `torch_contracts.kidnap_summary` reads); `on_chunk(frame after the
    chunk)` runs after each epilogue."""
    jcfg = js.cfg
    gate = tcfg.tracking.min_matches_track
    st = JSt.init_steady_state(js)
    kf_before = int(np.asarray(st.m.next_kf))
    recs = []
    for ci, c0 in enumerate(range(lo, len(seq.frames), chunk)):
        frames = seq.frames[c0:c0 + chunk]
        g, d, b, ts = C.chunk_tensors(tcfg, frames, True, "cpu")
        st, diag = JSt.slam_chunk(st, jnp.asarray(g.numpy()),
                                  jnp.asarray(d.numpy()),
                                  jnp.asarray(b.numpy()),
                                  jnp.asarray(ts, jnp.float32), cfg=jcfg)
        end = int(np.asarray(st.ts.status))
        nr = js.n_relocalizations
        st = js.chunk_epilogue(st, kf_before)
        kf_before = js.next_kf_hint
        n_in = np.asarray(diag["n_inliers"])
        recs.append(dict(
            chunk=ci, frames=list(range(c0, c0 + len(frames))),
            lost=(n_in < gate).tolist(), n_inliers=n_in.tolist(),
            inserted=np.asarray(diag["kf_inserted"]).astype(int).tolist(),
            poses=np.asarray(diag["pose"]), status_end=end,
            status_after=int(np.asarray(st.ts.status)),
            relocalized=js.n_relocalizations > nr, epilogue_ms=0.0))
        if on_chunk is not None:
            on_chunk(c0 + len(frames))
    return recs


def _jax_chunks(tcfg, seq, lo, chunk):
    """The JAX System warmed up with `process_frame` over frames 0 .. lo -
    1, then `_jax_drive_chunks` over the rest: the records, and the
    object table after the kidnap."""
    js = JSystem(jax_cfg(tcfg))
    for f in seq.frames[:lo]:
        js.process_frame(f.gray, f.depth, f.timestamp, boxes=f.boxes)
    n_pass = len(seq.frames) - C.KIDNAP_FRAMES - C.RETURN_FRAMES
    objs = {}

    def on_chunk(end):
        if end == n_pass + C.KIDNAP_FRAMES:
            objs["table"] = js.objects

    recs = _jax_drive_chunks(js, tcfg, seq, lo, chunk, on_chunk)
    return recs, objs["table"]


@pytest.mark.slow
def test_kidnap_chunks_matches_jax_steady():
    """31a's workload through the steady chunks of 8 (8 `process_frame`
    frames first) at 31a's scale with the object lane on the renderer's
    boxes, on both packages: the same status at each chunk's end and
    after its epilogue, the same recovery chunk, and after the kidnap the
    same live object classes, each port object's centre within 2 cm of a
    JAX object of its class (tests/test_torch_objects_e2e.py's bound).
    The port meets the contract's premise and bounds (a)-(f) in chunks
    too, but (e1), as in `test_kidnap_matches_jax_system` (the same
    recovery path is held here)."""
    corridor = _corridor()
    n = len(corridor.frames)
    seq = C.kidnap_sequence(corridor, back=C.BACK_EXPLORATION)
    tcfg = C.exploration_cfg().replace(use_objects=True)
    s = System(tcfg, device="cpu")
    for f in seq.frames[:C.CHUNK_WARM]:
        s.process_frame(f.gray, f.depth, f.timestamp, boxes=f.boxes)
    marks = {}

    def on_chunk(ci, st):
        end = C.CHUNK_WARM + (ci + 1) * C.CHUNK
        if end == n:
            marks["premise"] = C.check_kidnap(s, seq, n)
            marks["objects_before"] = int(s.objects.valid.sum())
        elif end == n + C.KIDNAP_FRAMES:
            marks["objects"] = s.objects

    recs = C.run_kidnap_chunks(s, seq, C.CHUNK_WARM, boxes=True,
                               on_chunk=on_chunk)
    out = C.check_kidnap_run(s, seq, recs, n, chunked=True,
                             standing=("(e1)",))
    print(f"[kidnap chunks, port] {marks.get('premise')}; contract {out}")
    jrecs, jobjs = _jax_chunks(tcfg, seq, C.CHUNK_WARM, C.CHUNK)
    jsum = C.kidnap_summary(jrecs, True, n)
    tobjs = marks["objects"]
    cls_t = tobjs.cls.numpy()[tobjs.valid.numpy()]
    cen_t = tobjs.center.numpy()[tobjs.valid.numpy()]
    jv = np.asarray(jobjs.valid).astype(bool)
    cls_j, cen_j = np.asarray(jobjs.cls)[jv], np.asarray(jobjs.center)[jv]
    status = [(r["status_end"], r["status_after"]) for r in recs]
    jstatus = [(r["status_end"], r["status_after"]) for r in jrecs]
    print(f"[kidnap chunks] statuses port {status}, JAX {jstatus}; recovery "
          f"chunk port {out['recovery_chunk']} by {out['recovered_by']}, "
          f"JAX {jsum['recovery_chunk']} by {jsum['recovered_by']}; objects "
          f"after the kidnap port {len(cls_t)} (before "
          f"{marks['objects_before']}), JAX {len(cls_j)}")
    assert status == jstatus
    assert out["recovery_chunk"] == jsum["recovery_chunk"]
    assert out["recovered_by"] == jsum["recovered_by"]
    assert sorted(cls_t.tolist()) == sorted(cls_j.tolist())
    for c, p in zip(cls_t, cen_t):
        assert np.linalg.norm(cen_j[cls_j == c] - p, axis=1).min() < 0.02


def _state_tool():
    import importlib.util
    path = os.path.join(ROOT, "dev", "torch_kidnap_state.py")
    spec = importlib.util.spec_from_file_location("torch_kidnap_state",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.slow
def test_kidnap_return_from_one_state(tmp_path):
    """31b's return (full width, chunks of 8) from one state on both
    packages: the file of `dev/torch_kidnap_state.py` (the card's, named
    by the KIDNAP_STATE environment variable; without it, the port's CPU
    run of 31b to the kidnap's end writes one), restored into the JAX
    System, which drives the return frame by frame (`slam_step`, the
    epilogue every 8 frames). From the JAX state before each frame the
    port's `track_frame`, given the JAX package's features and planes of
    the frame, reports the same loss and, where JAX reports OK, a pose
    within 1 cm and 0.01 rad of JAX's. Prints, frame by
    frame, JAX's inliers and error from the truth after the pass
    alignment, the port's step on its own features, and the port's own
    replay of the return from the file (`dev/torch_kidnap_state.py`'s),
    each against bound (b) of the kidnap contract."""
    from eao_fusion_tpu.io import checkpoint as JCK
    from eao_fusion_tpu.ops import planes as JP
    from eao_fusion_tpu_torch.ops import planes as TP
    from eao_fusion_tpu_torch.types import FramePlanes
    K = _state_tool()
    n, seq = K.kidnap_scale_sequence(C, SYNTH_CACHE)
    path = os.environ.get("KIDNAP_STATE")
    if not path:
        path = str(tmp_path / "kidnap_state.npz")
        K.save_kidnap_state(C, seq, n, path, "cpu")
    port = {r["frame"]: r for r in K.replay_return(C, seq, n, path,
                                                     "cpu")["frames"]}

    tcfg = C.kidnap_cfg()
    gate = tcfg.tracking.min_matches_track
    js = JSystem(jax_cfg(tcfg))
    JCK.load_state(path, js)
    lf = js.track.last_feats
    js.track = js.track._replace(last_feats=lf._replace(
        desc_packed=jnp.asarray(np.asarray(lf.desc_packed).view(
            np.uint32))))
    jcfg = js.cfg
    align = C.pass_alignment(js, seq, n)
    gt = np.stack([f.tcw for f in seq.frames])
    lo = n + C.KIDNAP_FRAMES
    boxes = C.chunk_tensors(tcfg, seq.frames[lo:], True, "cpu")[2].numpy()
    st = JSt.init_steady_state(js)
    kf_before = int(np.asarray(st.m.next_kf))

    def err(pose, fi):
        e = C.aligned_error(pose, gt[fi], align)
        return e[0] * 100, e[1]

    def meets(lost, e):
        return lost or (e[0] < C.RELOC_M * 100 and e[1] < C.RELOC_RAD)

    rows = []
    for k, fi in enumerate(range(lo, len(seq.frames))):
        f = seq.frames[fi]
        m = TMS.from_numpy(jax.tree.map(np.asarray, st.m._asdict()), "cpu")
        ts = _jax_track(st.ts)
        jf = JE.extract_features(jnp.asarray(f.gray), jnp.asarray(f.depth),
                                 orb_cfg=jcfg.orb, cam_cfg=jcfg.camera)
        jp = JP.segment_planes(jnp.asarray(f.depth), cam=jcfg.camera,
                               cfg=jcfg.planes)
        given = (tree_from_numpy(FrameFeatures, jax.tree.map(
            np.asarray, jf)._asdict(), "cpu"), tree_from_numpy(
            FramePlanes, jax.tree.map(np.asarray, jp)._asdict(), "cpu"))
        own = (TE.extract_features(torch.as_tensor(f.gray),
                                   torch.as_tensor(f.depth),
                                   orb_cfg=tcfg.orb, cam_cfg=tcfg.camera),
               TP.segment_planes(torch.as_tensor(f.depth), cam=tcfg.camera,
                                 cfg=tcfg.planes))
        steps = [tracking.track_frame(m, ts, feats, int(st.frame_id), pl,
                                      cfg=tcfg)[1:] for feats, pl in
                 (given, own)]
        st, jd = JSt.slam_step(st, jnp.asarray(f.gray), jnp.asarray(f.depth),
                               jnp.asarray(boxes[k]),
                               jnp.float32(f.timestamp), cfg=jcfg)
        jn, jpose = int(jd["n_inliers"]), np.asarray(st.ts.pose)
        if (k + 1) % C.CHUNK == 0:
            st = js.chunk_epilogue(st, kf_before)
            kf_before = js.next_kf_hint
        (gts, gd), (ots, od) = steps
        rows.append(dict(
            frame=fi, jax=(jn, err(jpose, fi)), given=int(gd["n_inliers"]),
            gap=_pose_gap(gts.pose.numpy(), jpose),
            own=(int(od["n_inliers"]), err(ots.pose.numpy(), fi)),
            port=(port[fi]["n_inliers"], tuple(port[fi]["error"]))))
        r = rows[-1]
        verdict = {k: "met" if meets(n_ < gate, e) else "MISSED"
                   for k, (n_, e) in (("jax", r["jax"]),
                                      ("port", r["port"]))}
        print(f"frame {fi}: JAX {jn} inliers {r['jax'][1][0]:.2f} cm (b "
              f"{verdict['jax']}); the port's step given JAX's features "
              f"{r['given']} inliers, {r['gap'][0] * 100:.4f} cm from JAX; "
              f"on its own {r['own'][0]} inliers {r['own'][1][0]:.2f} cm; "
              f"the port's replay {r['port'][0]} inliers "
              f"{r['port'][1][0]:.2f} cm (b {verdict['port']})", flush=True)
    for r in rows:
        assert (r["given"] < gate) == (r["jax"][0] < gate), r
        if r["jax"][0] >= gate:
            assert r["gap"][0] < 0.01 and r["gap"][1] < 0.01, r
