"""Monocular input of the port against the JAX package: two-view
initialization fed the JAX draws, the DLT and checked triangulation, the
epipolar point creation `create_points_mono` on a map carried across, the
thresholds of tests/test_mono_init.py on the cached 8-frame arc, and the
port's monocular System on the 20-frame arc with the thresholds of
tests/test_mono_e2e.py. Small config (512 keypoints, 32 keyframes, 2048
points)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eao_fusion_tpu import config as JC
from eao_fusion_tpu.frontend import extractor as JE
from eao_fusion_tpu.frontend import matcher as JM
from eao_fusion_tpu.io import synthetic
from eao_fusion_tpu.mapping import map_state as JMS
from eao_fusion_tpu.ops import lie as JL
from eao_fusion_tpu.ops import twoview as JTV
from eao_fusion_tpu.pipeline import local_mapping as JLM
from eao_fusion_tpu.pipeline.system import System as JSystem
from eao_fusion_tpu.solvers import triangulation as JTri
from eao_fusion_tpu_torch import config as TC
from eao_fusion_tpu_torch import kernels
from eao_fusion_tpu_torch.io import tum
from eao_fusion_tpu_torch.mapping import map_state as TMS
from eao_fusion_tpu_torch.ops import lie as TL
from eao_fusion_tpu_torch.ops import twoview as TTV
from eao_fusion_tpu_torch.pipeline import local_mapping as TLM
from eao_fusion_tpu_torch.pipeline.system import System
from eao_fusion_tpu_torch.solvers import triangulation as TTri

MONO = dict(sensor="mono", use_planes=False, use_objects=False)
JCFG = JC.SystemConfig(orb=JC.ORBConfig(n_features=500, max_keypoints=512),
                       capacity=JC.MapCapacity(max_keyframes=32,
                                               max_points=2048), **MONO)
TCFG = TC.SystemConfig(orb=TC.ORBConfig(n_features=500, max_keypoints=512),
                       capacity=TC.MapCapacity(max_keyframes=32,
                                               max_points=2048), **MONO)
CAM = (JCFG.camera.fx, JCFG.camera.fy, JCFG.camera.cx, JCFG.camera.cy)


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This module's torch ops on one CPU thread (tier-1 runs six test
    files at once; see tests/test_torch_loop.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rot_err(qa, qb) -> float:
    dq = abs(float(np.sum(np.asarray(qa) * np.asarray(qb))))
    return 2.0 * float(np.arccos(min(dq, 1.0)))


@pytest.fixture(scope="module")
def pairs():
    """Matched pixels of frame 0 and frames 3, 5, 7 of the cached 8-frame
    arc (JAX features and matches, padded to 512 slots), as
    tests/test_mono_init.py builds them."""
    seq = synthetic.generate_sequence(n_frames=8, seed=0, style="arc",
                                      cache_dir=synthetic.DEFAULT_CACHE)

    def feats(f):
        return JE.extract_features(jnp.asarray(f.gray), None,
                                   orb_cfg=JCFG.orb, cam_cfg=JCFG.camera,
                                   with_depth=False)
    a = feats(seq.frames[0])
    out = {}
    for j in (3, 5, 7):
        b = feats(seq.frames[j])
        mm = JM.mutual_match(a.desc_pm1, a.valid, a.angle, b.desc_pm1,
                             b.valid, b.angle, th=64, use_ratio=True,
                             check_rotation=True)
        tgt = np.asarray(mm.target_idx)
        ia = np.where(tgt >= 0)[0]
        uv1 = np.zeros((512, 2), np.float32)
        uv2 = np.zeros((512, 2), np.float32)
        valid = np.zeros(512, bool)
        uv1[:len(ia)] = np.asarray(a.uv)[ia]
        uv2[:len(ia)] = np.asarray(b.uv)[tgt[ia]]
        valid[:len(ia)] = True
        out[j] = (uv1, uv2, valid, seq.frames[0].tcw, seq.frames[j].tcw)
    return out


@pytest.mark.parametrize("j", [3, 5, 7])
def test_two_view_matches_jax(pairs, j):
    """`initialize_two_view` fed the hypotheses the JAX function draws from
    its key: the same model and outcome, `ok` agreeing on more than 99% of
    the slots, rotation within 1e-3 rad, translation direction dot >
    0.9999, points within 1e-2 relative where both accept them."""
    uv1, uv2, valid, _, _ = pairs[j]
    key = jax.random.PRNGKey(j)
    rj = JTV.initialize_two_view(jnp.asarray(uv1), jnp.asarray(uv2),
                                 jnp.asarray(valid), key, cam=CAM)
    p = jnp.asarray(valid / valid.sum(), jnp.float32)
    kf, kh = jax.random.split(key)
    idx_f = np.asarray(jax.random.choice(kf, 512, shape=(200, 8), p=p))
    idx_h = np.asarray(jax.random.choice(kh, 512, shape=(200, 4), p=p))
    rt = TTV.initialize_two_view(T(uv1), T(uv2), T(valid), T(idx_f),
                                 T(idx_h), cam=CAM)
    assert bool(rt.used_h) == bool(rj.used_h)
    assert bool(rt.success) == bool(rj.success)
    ok_j, ok_t = np.asarray(rj.ok), rt.ok.numpy()
    assert (ok_j == ok_t).mean() > 0.99
    a, b = np.asarray(rj.tcw2), rt.tcw2.numpy()
    assert _rot_err(a[:4], b[:4]) < 1e-3
    ta, tb = a[4:] / np.linalg.norm(a[4:]), b[4:] / np.linalg.norm(b[4:])
    assert float(ta @ tb) > 0.9999
    both = ok_j & ok_t
    xj, xt = np.asarray(rj.xyz)[both], rt.xyz.numpy()[both]
    assert (np.linalg.norm(xj - xt, axis=1)
            <= 1e-2 * np.linalg.norm(xj, axis=1)).all()


def test_two_view_init_recovers_motion(pairs):
    """tests/test_mono_init.py's thresholds on frames 0 and 5 with the
    port's own draws: success, rotation within 0.02 rad of the true
    relative pose, translation direction dot > 0.995, more than 80
    triangulations."""
    uv1, uv2, valid, t0, t1 = pairs[5]
    g = torch.Generator().manual_seed(0)
    idx_f, idx_h = TTV.draw_two_view_hypotheses(T(valid), g)
    assert idx_f.shape == (200, 8) and idx_h.shape == (200, 4)
    assert valid[idx_f.numpy()].all() and valid[idx_h.numpy()].all()
    res = TTV.initialize_two_view(T(uv1), T(uv2), T(valid), idx_f, idx_h,
                                  cam=CAM)
    assert bool(res.success), int(res.ok.sum())
    t21 = TL.se3_compose(T(t1), TL.se3_inverse(T(t0))).numpy()
    est = res.tcw2.numpy()
    assert _rot_err(t21[:4], est[:4]) < 0.02
    tg = t21[4:7] / np.linalg.norm(t21[4:7])
    te = est[4:7] / max(np.linalg.norm(est[4:7]), 1e-9)
    assert float(tg @ te) > 0.995
    assert int(res.ok.sum()) > 80


def test_triangulation_matches_jax():
    """`triangulate_dlt` and `triangulate_checked` on noisy pixel pairs of
    a random scene, with invalid rows: points within 1e-4 m, the same
    acceptance mask."""
    rng = np.random.default_rng(0)
    t1 = np.array([1, 0, 0, 0, 0, 0, 0], np.float32)
    t2 = np.asarray(JL.se3_exp(jnp.asarray(
        rng.normal(0, 0.1, 6).astype(np.float32))))
    X = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    X[:, 2] += 3.0

    def px(t):
        return (np.asarray(JL.project(CAM, JL.se3_apply(jnp.asarray(t),
                                                        jnp.asarray(X))))
                + rng.normal(0, 0.5, (300, 2)).astype(np.float32))
    uv1, uv2 = px(t1), px(t2)
    valid = rng.uniform(size=300) < 0.9
    s1 = (1.2 ** (-2.0 * rng.integers(0, 3, 300))).astype(np.float32)
    s2 = (1.2 ** (-2.0 * rng.integers(0, 3, 300))).astype(np.float32)
    xn = [np.stack([(u[:, 0] - CAM[2]) / CAM[0],
                    (u[:, 1] - CAM[3]) / CAM[1]], -1) for u in (uv1, uv2)]
    np.testing.assert_allclose(
        TTri.triangulate_dlt(T(t1), T(t2), T(xn[0]), T(xn[1])).numpy(),
        np.asarray(JTri.triangulate_dlt(jnp.asarray(t1), jnp.asarray(t2),
                                        jnp.asarray(xn[0]),
                                        jnp.asarray(xn[1]))), atol=1e-4)
    rj = JTri.triangulate_checked(*(jnp.asarray(a) for a in (
        t1, t2, uv1, uv2, valid, s1, s2)), cam=CAM)
    rt = TTri.triangulate_checked(*(T(a) for a in (
        t1, t2, uv1, uv2, valid, s1, s2)), cam=CAM)
    np.testing.assert_allclose(rt.xyz.numpy(), np.asarray(rj.xyz), atol=1e-4)
    np.testing.assert_array_equal(rt.ok.numpy(), np.asarray(rj.ok))
    assert 50 < int(rt.ok.sum()) < int(valid.sum())


@pytest.fixture(scope="module")
def mono_run():
    """The port's monocular System (loop closing on, so its init runs the
    full GBA) over the 20-frame seed-0 arc; the map and slot of each
    `create_points_mono` call are kept."""
    seq = synthetic.generate_sequence(n_frames=20, seed=0, style="arc",
                                      cache_dir=synthetic.DEFAULT_CACHE)
    calls = []
    orig = TLM.create_points_mono

    def spy(m, kf_slot, *, cfg):
        calls.append((m, kf_slot))
        return orig(m, kf_slot, cfg=cfg)
    TLM.create_points_mono = spy
    try:
        s = System(TCFG, device="cpu")
        before = dict(kernels.launches)
        for f in seq.frames:
            s.process_frame(f.gray, None, f.timestamp)
        assert kernels.launches == before
    finally:
        TLM.create_points_mono = orig
    return s, seq, calls


def test_mono_system_arc_ate(mono_run):
    """tests/test_mono_e2e.py: two-view init, at least 3 keyframes, more
    than 250 points, scale-aligned ATE < 4 cm from the first
    initialized frame on; identity poses until then."""
    s, seq, calls = mono_run
    assert s.n_keyframes >= 3 and len(calls) >= 1
    assert int(s.map.next_pt) > 250
    assert s.n_resets == 0
    nonid = [i for i, p in enumerate(s.trajectory)
             if not np.allclose(p, [1, 0, 0, 0, 0, 0, 0])]
    i0 = nonid[0]
    assert all(np.allclose(p, [1, 0, 0, 0, 0, 0, 0])
               for p in s.trajectory[:i0])
    err = tum.evaluate_ate_rpe(s.trajectory_tcw()[i0:], seq.gt_tcw()[i0:],
                               align=True, with_scale=True)
    assert err.ate_rmse < 0.04, err
    # every tracked frame's edges are monocular: nothing has depth
    assert (s.map.kf_kp_uright[s.map.kf_valid] < 0).all()


def test_create_points_mono_matches_jax(mono_run):
    """The port's and the JAX `create_points_mono` on the map the port's
    System had before its second call: the point count within 1%, the new
    points' positions within 1 mm where both made the same id."""
    _, _, calls = mono_run
    m, slot = calls[min(1, len(calls) - 1)]
    mj = JLM.create_points_mono(
        JMS.MapState(**{k: jnp.asarray(v)
                        for k, v in TMS.to_numpy(m).items()}),
        jnp.int32(slot), cfg=JCFG)
    mt = TLM.create_points_mono(m, slot, cfg=TCFG)
    n0 = int(m.next_pt)
    nj, nt = int(mj.next_pt), int(mt.next_pt)
    assert nj - n0 >= 20
    assert abs(nt - nj) <= 0.01 * nj
    lo, hi = n0, min(nt, nj)
    same = (np.asarray(mj.pt_valid)[lo:hi] & mt.pt_valid[lo:hi].numpy())
    xj = np.asarray(mj.pt_xyz)[lo:hi][same]
    xt = mt.pt_xyz[lo:hi].numpy()[same]
    assert same.sum() >= 0.95 * (hi - lo)
    assert np.abs(xj - xt).max() < 1e-3
    obs_j = (np.asarray(mj.kf_pt_idx) >= n0).sum()
    obs_t = (mt.kf_pt_idx >= n0).sum().item()
    assert abs(obs_t - obs_j) <= 0.01 * obs_j + 2


@pytest.mark.slow
def test_mono_system_matches_jax_system(mono_run):
    """The JAX monocular System on the same frames (its compiles take
    minutes on the CPU): both initialize on the same frame, keyframe
    counts within 1, and both meet tests/test_mono_e2e.py's bound."""
    s, seq, _ = mono_run
    js = JSystem(JCFG)
    for f in seq.frames:
        js.process_frame(f.gray, None, f.timestamp)
    first = [next(i for i, p in enumerate(x.trajectory)
                  if not np.allclose(p, [1, 0, 0, 0, 0, 0, 0]))
             for x in (s, js)]
    assert first[0] == first[1]
    assert abs(s.n_keyframes - js.n_keyframes) <= 1
    i0 = first[1]
    err = tum.evaluate_ate_rpe(js.trajectory_tcw()[i0:], seq.gt_tcw()[i0:],
                               align=True, with_scale=True)
    assert err.ate_rmse < 0.04, err
