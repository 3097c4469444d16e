"""The steady chunked loop of the port (`pipeline/steady.py`) and the
System's chunk-boundary protocol (`chunk_epilogue`, the batched loop
detection dispatched at one boundary and harvested at the next), against
the JAX package: `slam_chunk` from one state carried across, then twins of
tests/test_steady.py, tests/test_chunk_epilogue.py and
tests/test_async_detect.py::test_pending_detection_flow with their
thresholds. Small config (512 keypoints, 32 keyframes, 2048 points) on the
cached seed-0 arc."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eao_fusion_tpu.config import MapCapacity, ORBConfig, SystemConfig
from eao_fusion_tpu.io import synthetic
from eao_fusion_tpu.ops import lie as JL
from eao_fusion_tpu.pipeline import steady as JSt
from eao_fusion_tpu.pipeline.system import System as JSystem
from eao_fusion_tpu_torch import config as TC
from eao_fusion_tpu_torch import kernels
from eao_fusion_tpu_torch.io import tum
from eao_fusion_tpu_torch.ops import lie as TL
from eao_fusion_tpu_torch.pipeline import steady, tracking
from eao_fusion_tpu_torch.pipeline.system import System

OFF = dict(use_planes=False, use_objects=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This module's torch ops on one CPU thread (tier-1 runs six test
    files at once; see tests/test_torch_loop.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tcfg(**kw):
    return TC.SystemConfig(
        orb=TC.ORBConfig(n_features=500, max_keypoints=512),
        capacity=TC.MapCapacity(max_keyframes=32, max_points=2048),
        **{**OFF, **kw})


@pytest.fixture(scope="module")
def seq():
    return synthetic.generate_sequence(n_frames=20, seed=0, style="arc",
                                       cache_dir=synthetic.DEFAULT_CACHE)


def _chunk(cfg, frames, lo, n, boxes=False):
    """(grays, depths, boxes, timestamps) tensors of frames lo .. lo+n-1;
    the box table padded to max_objects_2d rows of zeros."""
    fr = frames[lo:lo + n]
    bx = np.zeros((n, cfg.objects.max_objects_2d, 6), np.float32)
    if boxes:
        for i, f in enumerate(fr):
            b = f.boxes[:len(bx[i])]
            bx[i, :len(b)] = b
    return (torch.from_numpy(np.stack([f.gray for f in fr])),
            torch.from_numpy(np.stack([f.depth for f in fr])),
            torch.from_numpy(bx),
            torch.tensor([f.timestamp for f in fr], dtype=torch.float32))


def _warm(cfg, frames, n):
    s = System(cfg, device="cpu")
    for f in frames[:n]:
        s.process_frame(f.gray, f.depth, f.timestamp, boxes=f.boxes)
    assert int(s.track.status) == tracking.STATUS_OK
    return s


# ------------------------------------------------------------ parity

@pytest.fixture(scope="module")
def jax_warm(seq):
    """A JAX System after 8 frames (planes, objects and loop closing off)."""
    js = JSystem(SystemConfig(
        orb=ORBConfig(n_features=500, max_keypoints=512),
        capacity=MapCapacity(max_keyframes=32, max_points=2048),
        use_loop_closing=False, **OFF))
    for f in seq.frames[:8]:
        js.process_frame(f.gray, f.depth, f.timestamp)
    return js


@pytest.mark.parametrize("kf_every", [0, 3])
def test_slam_chunk_matches_jax(jax_warm, seq, kf_every):
    """The JAX `slam_chunk` and the port's over frames 8-13 from one state
    carried across: the same keyframe decisions and triggers, inliers
    within 5, every pose within 5 mm / 0.3 degrees (the bound of the
    System twins)."""
    cfg = _tcfg(use_loop_closing=False)
    js = jax_warm
    st_t = steady.steady_state_from_numpy(
        jax.tree.map(np.asarray, JSt.init_steady_state(js)), "cpu",
        torch.Generator().manual_seed(11))
    g, d, b, t = _chunk(cfg, seq.frames, 8, 6)
    before = dict(kernels.launches)
    st_t, dt = steady.slam_chunk(st_t, g, d, b, t, cfg=cfg,
                                 kf_every=kf_every)
    assert kernels.launches == before        # the CPU path: no kernel
    _, dj = JSt.slam_chunk(JSt.init_steady_state(js), jnp.asarray(g.numpy()),
                           jnp.asarray(d.numpy()), jnp.asarray(b.numpy()),
                           jnp.asarray(t.numpy()), cfg=js.cfg,
                           kf_every=kf_every)
    dj = {k: np.asarray(v) for k, v in dj.items()}
    assert set(dt) == set(dj)
    np.testing.assert_array_equal(dt["kf_inserted"].numpy(),
                                  dj["kf_inserted"])
    np.testing.assert_array_equal(dt["kf_trigger"].numpy(), dj["kf_trigger"])
    assert dt["kf_inserted"].any()
    assert np.abs(dt["n_inliers"].numpy() - dj["n_inliers"]).max() <= 5
    a, b_ = dt["pose"].numpy(), dj["pose"]
    ca = np.asarray(JL.se3_inverse(a))[:, 4:7]
    cb = np.asarray(JL.se3_inverse(b_))[:, 4:7]
    assert np.linalg.norm(ca - cb, axis=1).max() < 5e-3
    dq = np.abs(np.sum(a[:, :4] * b_[:, :4], axis=1)).clip(max=1.0)
    assert np.degrees(2 * np.arccos(dq)).max() < 0.3
    assert st_t.frame_id == 14


# ---------------------------------------------------------- outcomes

def test_steady_chunk_tracks_and_inserts_keyframes(seq):
    """tests/test_steady.py: planes and objects on, the renderer's boxes,
    a keyframe every 4th frame over frames 8-19 in one chunk."""
    cfg = _tcfg(use_planes=True, use_objects=True, use_loop_closing=False)
    s = _warm(cfg, seq.frames, 8)
    st = steady.init_steady_state(s)
    kf_before = int(st.m.next_kf)
    st2, diag = steady.slam_chunk(st, *_chunk(cfg, seq.frames, 8, 12,
                                              boxes=True),
                                  cfg=cfg, kf_every=4)
    ninl = diag["n_inliers"].numpy()
    assert (ninl > 30).all(), ninl
    assert diag["kf_inserted"].sum() >= 2
    assert int(st2.m.next_kf) > kf_before
    assert int(st2.ts.status) == tracking.STATUS_OK
    assert np.linalg.norm(st2.ts.pose.numpy()[4:7]
                          - seq.frames[19].tcw[4:7]) < 0.05
    assert int(st2.objs.valid.sum()) >= 1      # the lane ran on the boxes


@pytest.fixture(scope="module")
def warm8(seq):
    """The state of a System after 8 frames (loop closing on, the
    automatic reset off), restored into a fresh System for each test."""
    base = _tcfg()
    cfg = base.replace(tracking=dataclasses.replace(
        base.tracking, reset_if_lost_below_kfs=0))
    s = _warm(cfg, seq.frames, 8)
    lc = s.loop_closer
    snap = (s.map, s.track, s.objects, s.frame_id, s.n_keyframes,
            lc.bow.clone())

    def fresh():
        t = System(cfg, device="cpu")
        (t.map, t.track, t.objects, t.frame_id, t.n_keyframes,
         bow) = snap
        t.loop_closer.bow = bow.clone()
        return t
    return fresh


def test_epilogue_compacts_points_and_remaps_tracking(warm8, seq):
    """tests/test_chunk_epilogue.py: with the point cursor forced near
    capacity the epilogue compacts, and tracking goes on over the
    compacted map."""
    s = warm8()
    cfg = s.cfg
    st = steady.init_steady_state(s)
    st = st._replace(m=st.m._replace(next_pt=torch.tensor(
        int(0.95 * cfg.capacity.max_points), dtype=torch.int32)))
    kf_before = int(st.m.next_kf)
    st, _ = steady.slam_chunk(st, *_chunk(cfg, seq.frames, 8, 4), cfg=cfg)
    st = s.chunk_epilogue(st, kf_before)
    assert s.n_pt_compactions == 1
    assert int(st.m.next_pt) < int(0.9 * cfg.capacity.max_points)
    st, diag = steady.slam_chunk(st, *_chunk(cfg, seq.frames, 12, 4),
                                 cfg=cfg)
    assert int(st.ts.status) == tracking.STATUS_OK
    assert int(diag["n_inliers"][-1]) > 50


def _err(pose, tcw):
    d = TL.se3_log(TL.se3_compose(TL.se3_inverse(pose),
                                  torch.from_numpy(tcw)))
    return float(torch.linalg.norm(d[3:]))


def test_lost_chunk_freezes_pose_and_epilogue_relocalizes(warm8, seq):
    """A chunk of noise frames without depth goes LOST with the pose
    frozen within 1e-3 m; a chunk over mapped views then recovers, and the
    epilogue leaves tracking OK within 8 cm of frame 7's true pose."""
    s = warm8()
    cfg = s.cfg
    st = steady.init_steady_state(s)
    pose_before = st.ts.pose.clone()
    shape = seq.frames[0].gray.shape
    r = np.random.default_rng(0)
    noise = torch.from_numpy(r.uniform(0, 1, (4,) + shape).astype(np.float32))
    kf_before = int(st.m.next_kf)
    st, _ = steady.slam_chunk(
        st, noise, torch.zeros((4,) + shape),
        torch.zeros((4, cfg.objects.max_objects_2d, 6)),
        torch.tensor([1.0, 1.03, 1.06, 1.09]), cfg=cfg)
    assert int(st.ts.status) == tracking.STATUS_LOST
    assert torch.isfinite(st.ts.pose).all()
    assert float(torch.linalg.norm(st.ts.pose[4:] - pose_before[4:])) < 1e-3
    st, _ = steady.slam_chunk(st, *_chunk(cfg, seq.frames, 4, 4), cfg=cfg)
    st = s.chunk_epilogue(st, kf_before)
    assert int(st.ts.status) == tracking.STATUS_OK
    assert _err(st.ts.pose, seq.frames[7].tcw) < 0.08


def test_epilogue_relocalizes_kidnapped_camera(warm8, seq):
    """Forced LOST with a far-off pose after a chunk over mapped views:
    the epilogue's BoW relocalization brings the pose back within 8 cm of
    the chunk's last frame."""
    s = warm8()
    cfg = s.cfg
    st = steady.init_steady_state(s)
    kf_before = int(st.m.next_kf)
    st, _ = steady.slam_chunk(st, *_chunk(cfg, seq.frames, 4, 4), cfg=cfg)
    far = torch.tensor([0.0, 1.0, 0.0, 0.0, 5.0, 5.0, 5.0])
    st = st._replace(ts=st.ts._replace(
        status=tracking._i32(tracking.STATUS_LOST, "cpu"), pose=far,
        last_pose=far))
    st = s.chunk_epilogue(st, kf_before)
    assert s.n_relocalizations >= 1
    assert int(st.ts.status) == tracking.STATUS_OK
    assert _err(st.ts.pose, seq.frames[7].tcw) < 0.08


def test_pending_detection_flow(warm8, seq):
    """tests/test_async_detect.py: an epilogue that inserted keyframes
    leaves a pending handle for exactly those slots; the next epilogue
    harvests it and dispatches a fresh one; the blocking flush clears it.
    The chunked trajectory recorded by `record_chunk` stays on the arc."""
    s = warm8()
    cfg = s.cfg
    st = steady.init_steady_state(s)
    kf_before = int(st.m.next_kf)
    g, d, b, t = _chunk(cfg, seq.frames, 8, 6)
    st, diag = steady.slam_chunk(st, g, d, b, t, cfg=cfg)
    s.record_chunk(st, diag, t.tolist())
    st = s.chunk_epilogue(st, kf_before)
    assert s.n_keyframes > kf_before
    assert s._pending_detect is not None
    assert s._pending_detect["slots"] == list(range(kf_before,
                                                    s.n_keyframes))
    n_detect = s.loop_closer.stats["n_detect"]

    kf_before2 = s.next_kf_hint
    g, d, b, t = _chunk(cfg, seq.frames, 14, 6)
    st, diag = steady.slam_chunk(st, g, d, b, t, cfg=cfg)
    s.record_chunk(st, diag, t.tolist())
    st = s.chunk_epilogue(st, kf_before2)
    if s.n_keyframes > kf_before2:
        assert s._pending_detect["slots"] == list(range(kf_before2,
                                                        s.n_keyframes))
    s._poll_gba(blocking=True)
    assert s._pending_detect is None
    assert s.loop_closer.stats["n_detect"] >= n_detect
    assert len(s.trajectory) == 12 and len(s.diags) == 12
    err = tum.evaluate_ate_rpe(s.trajectory_tcw(corrected=True),
                               seq.gt_tcw()[8:])
    assert err.ate_rmse < 0.02, err


def test_batched_detection_matches_per_keyframe(warm8):
    """The batched detection's statistics are the per-keyframe pass's:
    `dispatch_detect` over every live slot writes their bow rows (into a
    zeroed table here) and gives each slot the scores and the
    covisibility that `detect_stats` gives it; `on_keyframes` over them
    (no loop on this arc) closes nothing."""
    s = warm8()
    lc = s.loop_closer
    slots = list(range(int(s.map.next_kf)))
    lc.bow.zero_()
    m, pend = lc.dispatch_detect(s.map, slots)
    assert pend["slots"] == slots and pend["done"] is None
    bow = lc.bow.clone()
    assert (bow[slots].sum(dim=1) > 0).all()
    for i, slot in enumerate(slots):
        _, scores, covis, _ = lc.detect_stats(m, slot)
        np.testing.assert_array_equal(pend["scores"][i].numpy(), scores)
        np.testing.assert_array_equal(pend["covis"].numpy(), covis)
    np.testing.assert_array_equal(lc.bow.numpy(), bow.numpy())
    m2, n_closed, last = lc.on_keyframes(m, slots)
    assert (n_closed, last) == (0, -1)
    assert lc.stats["n_detect"] == 2 * len(slots)


def test_oversized_chunk_detects_synchronously(warm8, seq, monkeypatch):
    """A chunk that inserts more keyframes than one batched detection
    holds takes the synchronous batch path (`on_keyframes`) at its
    boundary and leaves no pending handle; the batch size is cut to 1 here
    so that a 6-frame chunk exceeds it."""
    from eao_fusion_tpu_torch.pipeline import loop_closing
    monkeypatch.setattr(loop_closing, "DETECT_BATCH", 1)
    s = warm8()
    cfg = s.cfg
    calls = []
    orig = s.loop_closer.on_keyframes
    s.loop_closer.on_keyframes = lambda m, slots: (calls.append(slots)
                                                   or orig(m, slots))
    st = steady.init_steady_state(s)
    kf_before = int(st.m.next_kf)
    st, _ = steady.slam_chunk(st, *_chunk(cfg, seq.frames, 8, 6), cfg=cfg)
    st = s.chunk_epilogue(st, kf_before)
    assert s.n_keyframes - kf_before >= 2
    assert calls == [list(range(kf_before, s.n_keyframes))]
    assert s._pending_detect is None
    assert s.loop_closer.stats["n_detect"] == s.n_keyframes - kf_before


def test_epilogue_compacts_keyframes_and_remaps_the_dispatch(seq):
    """A 12-slot keyframe table with a keyframe allowed every frame (the
    capacity of tests/test_kf_lifecycle.py, cut so that it fills within
    the arc): the chunk that fills it is followed by a keyframe
    compaction at its boundary, the detection for that chunk's keyframes
    is dispatched with their new slot ids (those the compaction dropped
    left out), `next_kf_hint` is the compacted cursor, and tracking goes
    on over the compacted table."""
    base = _tcfg()
    cfg = base.replace(
        capacity=dataclasses.replace(base.capacity, max_keyframes=12,
                                     max_local_ba_kfs=12),
        tracking=dataclasses.replace(base.tracking,
                                     max_frames_between_kf=1))
    s = _warm(cfg, seq.frames, 4)
    st = steady.init_steady_state(s)
    kf_before = int(st.m.next_kf)
    for lo in (4, 8, 12):
        st, _ = steady.slam_chunk(st, *_chunk(cfg, seq.frames, lo, 4),
                                  cfg=cfg)
        st = s.chunk_epilogue(st, kf_before)
        if s.n_kf_compactions:
            break
        kf_before = s.next_kf_hint
    assert s.n_kf_compactions == 1
    remap = s._last_kf_remap
    next_kf = int(st.m.next_kf)
    assert s.next_kf_hint == next_kf < 12
    want = [int(remap[k]) for k in range(kf_before, 12) if remap[k] >= 0]
    pend = s._pending_detect
    assert (pend["slots"] if pend is not None else []) == want
    kv = st.m.kf_valid.numpy()
    assert all(0 <= k < next_kf and kv[k] for k in want)
    st, diag = steady.slam_chunk(st, *_chunk(cfg, seq.frames, lo + 4, 4),
                                 cfg=cfg)
    assert int(st.ts.status) == tracking.STATUS_OK
    assert (diag["n_inliers"].numpy() > 30).all()
