"""Loop closing and relocalization of the port against the JAX package:
the vocabulary, Horn / Sim3 / PnP RANSAC given the JAX draws, the Sim3
refinement and pose graph, the dense global BA with free planes, the
detection gating, the relocalization candidates, and `compute_sim3` and a
synchronous `correct` on one map state carried across. Each test states
its tolerance."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eao_fusion_tpu import config as JC
from eao_fusion_tpu.frontend import extractor as JE
from eao_fusion_tpu.io import synthetic
from eao_fusion_tpu.mapping import map_state as JMS
from eao_fusion_tpu.mapping import vocabulary as JV
from eao_fusion_tpu.ops import lie as JL
from eao_fusion_tpu.ops import ransac as JR
from eao_fusion_tpu.pipeline import loop_closing as JLC
from eao_fusion_tpu.pipeline import relocalization as JRel
from eao_fusion_tpu.solvers import ba as JB
from eao_fusion_tpu.solvers import pose_graph as JPG
from eao_fusion_tpu_torch import config as TC
from eao_fusion_tpu_torch.frontend import extractor as TE
from eao_fusion_tpu_torch.io import synthetic as TS
from eao_fusion_tpu_torch.mapping import map_state as TMS
from eao_fusion_tpu_torch.mapping import vocabulary as TV
from eao_fusion_tpu_torch.ops import lie as TL
from eao_fusion_tpu_torch.ops import ransac as TR
from eao_fusion_tpu_torch.pipeline import loop_closing as TLC
from eao_fusion_tpu_torch.pipeline import relocalization as TRel
from eao_fusion_tpu_torch.pipeline.system import System
from eao_fusion_tpu_torch.solvers import ba as TB
from eao_fusion_tpu_torch.solvers import pose_graph as TPG

from test_ba import CAM, CFG, make_ba_problem
from test_pnp import CAM as PNP_CAM, make_pnp

T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This module's torch ops on one CPU thread. Tier-1 runs six test
    files at once; many small ops, each split over every core while other
    processes hold the cores, wait on one another far longer than they
    compute. The setting is put back after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(x):
    return T(np.asarray(x, np.float32))


def _np(tree):
    return jax.tree.map(np.array, tree)._asdict()


def _jax_draws(key, valid, n_hyp, k):
    """The hypothesis indices the JAX RANSAC draws from `key`
    (`jax.random.choice` over the valid rows, with replacement)."""
    p = np.asarray(valid, np.float32)
    p = p / max(p.sum(), 1.0)
    return T(np.asarray(jax.random.choice(key, len(p), shape=(n_hyp, k),
                                          replace=True, p=jnp.asarray(p)))
             ).long()


# ----------------------------------------------------------------- vocabulary

@pytest.fixture(scope="module")
def vocabs():
    return JV.Vocabulary.load(), TV.Vocabulary.load()


def test_vocabulary_words_and_bow_match_jax(vocabs):
    """Word ids equal (exact float32 ±1 products, ties to the first word)
    and bow vectors within 1e-6, on a frame's real descriptors and on
    random ones with invalid slots."""
    jv, tv = vocabs
    assert tv.n_words == jv.n_words == 8192
    np.testing.assert_array_equal(tv.words.numpy(), np.asarray(jv.words))
    np.testing.assert_array_equal(tv.idf.numpy(), np.asarray(jv.idf))
    seq = synthetic.generate_sequence(n_frames=3, seed=0, style="arc",
                                      cache_dir=synthetic.DEFAULT_CACHE)
    cfg = JC.SystemConfig(orb=JC.ORBConfig(n_features=500, max_keypoints=512))
    f = JE.extract_features(jnp.asarray(seq.frames[0].gray),
                            jnp.asarray(seq.frames[0].depth),
                            orb_cfg=cfg.orb, cam_cfg=cfg.camera)
    r = np.random.default_rng(0)
    rnd = np.where(r.uniform(size=(256, 256)) < 0.5, -1, 1).astype(np.int8)
    for desc, valid in ((np.asarray(f.desc_pm1), np.asarray(f.valid)),
                        (rnd, r.uniform(size=256) < 0.8)):
        wj = np.asarray(JV.assign_words(jv, jnp.asarray(desc),
                                        jnp.asarray(valid)))
        wt = TV.assign_words(tv, T(desc), T(valid)).numpy()
        np.testing.assert_array_equal(wt, wj)
        bj = np.asarray(JV.bow_vector(jv, jnp.asarray(desc),
                                      jnp.asarray(valid)))
        bt = TV.bow_vector(tv, T(desc), T(valid)).numpy()
        np.testing.assert_allclose(bt, bj, atol=1e-6)
    db = r.uniform(size=(6, 64)).astype(np.float32)
    db /= db.sum(1, keepdims=True)
    q = db[2] * 0.5 + db[3] * 0.5
    ok = np.array([1, 1, 0, 1, 1, 1], bool)
    np.testing.assert_allclose(
        TV.l1_scores(T(q), T(db), T(ok)).numpy(),
        np.asarray(JV.l1_scores(jnp.asarray(q), jnp.asarray(db),
                                jnp.asarray(ok))), atol=1e-6)


def test_retrieval_ranks_same_place_first(vocabs):
    """The twin of tests/test_loop.py::TestVocabulary with the port's
    extractor: a nearby frame of the same scene outscores another scene,
    and the scores are the JAX package's within 1e-5."""
    jv, tv = vocabs
    cfg = TC.SystemConfig(orb=TC.ORBConfig(n_features=500, max_keypoints=512))
    seq = synthetic.generate_sequence(n_frames=3, seed=0, style="arc",
                                      cache_dir=synthetic.DEFAULT_CACHE)
    seq2 = synthetic.generate_sequence(n_frames=3, seed=9, style="arc",
                                       cache_dir=synthetic.DEFAULT_CACHE)
    vt, vj = [], []
    for f in [seq.frames[0], seq.frames[1], seq2.frames[0]]:
        ft = TE.extract_features(_f32(f.gray), _f32(f.depth),
                                 orb_cfg=cfg.orb, cam_cfg=cfg.camera)
        vt.append(TV.bow_vector(tv, ft.desc_pm1, ft.valid))
        vj.append(JV.bow_vector(jv, jnp.asarray(ft.desc_pm1.numpy()),
                                jnp.asarray(ft.valid.numpy())))
    s = TV.l1_scores(vt[0], torch.stack(vt[1:]),
                     torch.ones(2, dtype=torch.bool)).numpy()
    sj = np.asarray(JV.l1_scores(vj[0], jnp.stack(vj[1:]), jnp.ones(2, bool)))
    assert s[0] > s[1]
    np.testing.assert_allclose(s, sj, atol=1e-5)


def test_missing_vocabulary_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="vocabulary"):
        TV.Vocabulary.load(str(tmp_path / "none.npz"))


# --------------------------------------------------------------------- ransac

def _align_problem(seed, n, tau, n_out, noise):
    r = np.random.default_rng(seed)
    pa = r.uniform(-2, 2, (n, 3)).astype(np.float32)
    g_gt = np.asarray(JL.sim3_exp(jnp.asarray(np.asarray(tau, np.float32))))
    pb = np.array(JL.sim3_apply(jnp.asarray(g_gt), jnp.asarray(pa)))
    if noise:
        pb += r.normal(0, noise, pb.shape).astype(np.float32)
    out = r.choice(n, n_out, replace=False) if n_out else np.zeros(0, int)
    pb[out] += r.uniform(0.5, 2.0, (n_out, 3)).astype(np.float32)
    return pa, pb, g_gt, out


@pytest.mark.parametrize("with_scale", [False, True])
def test_horn_align_matches_jax(with_scale):
    """Weighted Horn alignment, batched in the port: within 1e-5."""
    pa, pb, _, _ = _align_problem(3, 40, [0.2, -0.1, 0.3, 0.5, -0.2, 0.8,
                                          0.2], 0, 0.01)
    w = np.random.default_rng(4).uniform(0.2, 1.0, 40).astype(np.float32)
    gj = np.asarray(JR.horn_align(jnp.asarray(pa), jnp.asarray(pb),
                                  jnp.asarray(w), with_scale))
    gt = TR.horn_align(T(pa), T(pb), T(w), with_scale).numpy()
    gtb = TR.horn_align(T(np.stack([pa, pa])), T(np.stack([pb, pb])),
                        T(np.stack([w, w])), with_scale).numpy()
    for g in (gt, gtb[0], gtb[1]):
        np.testing.assert_allclose(g, gj, atol=1e-5)


@pytest.mark.parametrize("case", ["se3_outliers", "sim3_scale"])
def test_ransac_align_given_jax_draws(case):
    """The twins of tests/test_loop.py::TestRansacAlign: fed the JAX draws,
    the port picks the same hypothesis (identical inliers) and refits to
    the JAX transform within 1e-4; the JAX test's own bounds hold."""
    if case == "se3_outliers":
        pa, pb, g_gt, out = _align_problem(
            0, 100, [0.2, -0.1, 0.3, 0.5, -0.2, 0.8, 0.0], 30, 0.005)
        key, with_scale, th = jax.random.PRNGKey(0), False, 0.05
    else:
        pa, pb, g_gt, out = _align_problem(
            1, 50, [0.1, 0.2, -0.1, 0.3, 0.1, -0.4, 0.3], 0, 0.0)
        key, with_scale, th = jax.random.PRNGKey(1), True, 0.05
    valid = np.ones(len(pa), bool)
    rj = JR.ransac_align(jnp.asarray(pa), jnp.asarray(pb),
                         jnp.asarray(valid), key, with_scale=with_scale,
                         inlier_th=th)
    rt = TR.ransac_align(T(pa), T(pb), T(valid), _jax_draws(key, valid, 128, 3),
                         with_scale=with_scale, inlier_th=th)
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    assert int(rt.n_inliers) == int(rj.n_inliers)
    np.testing.assert_allclose(rt.transform.numpy(), np.asarray(rj.transform),
                               atol=1e-4)
    if case == "se3_outliers":
        assert int(rt.n_inliers) >= 60 and not rt.inliers.numpy()[out].any()
        err = TL.sim3_log(TL.sim3_compose(TL.sim3_inverse(rt.transform),
                                          T(g_gt))).numpy()
        assert np.linalg.norm(err) < 0.05
    else:
        assert abs(float(rt.transform[7]) - float(g_gt[7])) < 0.02


@pytest.mark.parametrize("seed,noise,outliers", [(0, 0.5, 0.25),
                                                 (1, 0.0, 0.0)])
def test_ransac_pnp_given_jax_draws(seed, noise, outliers):
    """The twins of tests/test_pnp.py: fed the JAX draws, the same
    inliers and the JAX pose within 1e-4 (rotation) / 1e-3 (translation,
    a DLT from six points); the JAX test's bounds hold."""
    r = np.random.default_rng(seed)
    pw, uv, pose_gt, out = make_pnp(r, noise=noise, outlier_frac=outliers)
    key = jax.random.PRNGKey(seed)
    valid = np.ones(len(pw), bool)
    rj = JR.ransac_pnp(jnp.asarray(pw), jnp.asarray(uv), jnp.asarray(valid),
                       key, cam=PNP_CAM)
    rt = TR.ransac_pnp(T(pw), T(uv), T(valid), _jax_draws(key, valid, 192, 6),
                       cam=PNP_CAM)
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    d = TL.se3_log(TL.se3_compose(TL.se3_inverse(rt.pose),
                                  _f32(rj.pose))).numpy()
    assert np.linalg.norm(d[:3]) < 1e-4 and np.linalg.norm(d[3:]) < 1e-3
    d = TL.se3_log(TL.se3_compose(TL.se3_inverse(rt.pose),
                                  _f32(pose_gt))).numpy()
    if noise:
        assert int(rt.n_inliers) >= 45 and not rt.inliers.numpy()[out].any()
        assert np.linalg.norm(d[:3]) < 0.02 and np.linalg.norm(d[3:]) < 0.06
    else:
        assert int(rt.n_inliers) == len(pw) and np.linalg.norm(d) < 1e-3


def test_draw_hypotheses_uniform_over_valid_rows():
    """Every draw is a valid row, each valid row is drawn about equally
    often (within 20% of the mean over 128 x 3 draws of 16 rows), and the
    generator makes the draws reproducible."""
    valid = torch.zeros(40, dtype=torch.bool)
    valid[torch.arange(0, 40, 5)] = True
    valid[33:41] = True
    g = torch.Generator().manual_seed(3)
    idx = TR.draw_hypotheses(valid, 4096, 3, g)
    assert idx.shape == (4096, 3) and valid[idx].all()
    counts = torch.bincount(idx.reshape(-1), minlength=40)[valid].float()
    assert ((counts - counts.mean()).abs() < 0.2 * counts.mean()).all()
    g2 = torch.Generator().manual_seed(3)
    assert torch.equal(TR.draw_hypotheses(valid, 4096, 3, g2), idx)


# --------------------------------------------------- sim3 refine, pose graph

def test_sim3_refine_matches_jax():
    """The twin of tests/test_loop.py::TestSim3Refine, also with the scale
    free: within 1e-5 of the JAX refinement (analytic Jacobian against
    `jacfwd`), and converged to truth within 1e-3."""
    r = np.random.default_rng(2)
    pa = r.uniform(-1, 1, (40, 3)).astype(np.float32)
    g_gt = np.asarray(JL.sim3_exp(jnp.asarray(
        np.r_[0.05, -0.1, 0.08, 0.2, 0.1, -0.1, 0.0].astype(np.float32))))
    pb = np.asarray(JL.sim3_apply(jnp.asarray(g_gt), jnp.asarray(pa)))
    g0 = np.asarray(JL.sim3_retract(jnp.asarray(g_gt), jnp.asarray(
        np.r_[0.03, 0.02, -0.04, 0.05, -0.06, 0.02, 0.0].astype(np.float32))))
    w = np.ones(40, np.float32)
    for fix_scale in (True, False):
        gj = np.asarray(JPG.sim3_refine(jnp.asarray(pa), jnp.asarray(pb),
                                        jnp.asarray(w), jnp.asarray(g0),
                                        fix_scale=fix_scale))
        gt = TPG.sim3_refine(T(pa), T(pb), T(w), T(g0), fix_scale=fix_scale)
        np.testing.assert_allclose(gt.numpy(), gj, atol=1e-5)
        err = TL.sim3_log(TL.sim3_compose(TL.sim3_inverse(gt),
                                          T(g_gt))).numpy()
        assert np.linalg.norm(err) < 1e-3


def _ring():
    """tests/test_loop.py::TestPoseGraph's drifted ring of 12 keyframes
    with a perfect loop edge."""
    K = 12
    gt = np.stack([np.asarray(JL.se3_exp(jnp.asarray(np.r_[
        0, a, 0, np.sin(a), 0, 1 - np.cos(a)].astype(np.float32))))
        for a in 2 * np.pi * np.arange(K) / K])
    est = gt.copy()
    for i in range(1, K):
        est[i] = np.asarray(JL.se3_retract(jnp.asarray(gt[i]), jnp.asarray(
            np.r_[0, 0.03 * i, 0, 0.02 * i, 0, 0].astype(np.float32))))
    est_sim = np.asarray(JL.sim3_from_se3(jnp.asarray(est)))
    gt_sim = np.asarray(JL.sim3_from_se3(jnp.asarray(gt)))
    ei = list(range(K - 1)) + [K - 1]
    ej = list(range(1, K)) + [0]
    meas = [np.asarray(JL.sim3_compose(jnp.asarray(est_sim[i + 1]),
                                       JL.sim3_inverse(jnp.asarray(
                                           est_sim[i]))))
            for i in range(K - 1)]
    meas.append(np.asarray(JL.sim3_compose(
        jnp.asarray(gt_sim[0]), JL.sim3_inverse(jnp.asarray(gt_sim[K - 1])))))
    fixed = np.zeros(K, bool)
    fixed[0] = True
    return dict(poses=est_sim, pose_valid=np.ones(K, bool), fixed=fixed,
                edge_i=np.array(ei, np.int32), edge_j=np.array(ej, np.int32),
                edge_meas=np.stack(meas).astype(np.float32),
                edge_weight=np.array([1.0] * (K - 1) + [5.0], np.float32))


def test_pose_graph_closes_drifted_ring_as_jax():
    """The drifted ring of tests/test_loop.py:66-122: the port's Gauss-
    Newton (float64 central-difference Jacobians against the JAX `jacfwd`)
    gives the JAX poses within 2e-4 after 30 iterations, and the loop gap
    shrinks by 10x as the JAX test demands."""
    d = _ring()
    pj = np.asarray(JPG.optimize_pose_graph(
        JPG.PoseGraphProblem(**{k: jnp.asarray(v) for k, v in d.items()}),
        n_iters=30))
    pt = TPG.optimize_pose_graph(
        TPG.PoseGraphProblem(**{k: T(v) for k, v in d.items()}),
        n_iters=30).numpy()
    np.testing.assert_allclose(pt, pj, atol=2e-4)
    K = len(pt)

    def gap(p):
        rel = TL.sim3_compose(T(d["edge_meas"][-1]), TL.sim3_compose(
            T(np.asarray(p[K - 1])), TL.sim3_inverse(T(np.asarray(p[0])))))
        return float(np.linalg.norm(TL.sim3_log(rel).numpy()))

    assert gap(pt) < 0.1 * gap(d["poses"])


def test_tangent_jacobian_matches_jvp():
    """The pose graph's float64 central differences against
    `torch.func.jvp` (forward mode, the JAX `jacfwd`) on the ring's edge
    residuals: within 1e-5."""
    d = _ring()
    si, sj = T(d["poses"][d["edge_i"]]), T(d["poses"][d["edge_j"]])
    meas = T(d["edge_meas"])
    z = torch.zeros((len(meas), 7))
    got = TPG.tangent_jacobian(lambda t: TPG._edge_residual(
        TL.sim3_retract(si.double(), t), sj.double(), meas.double()), z)

    def f(t):
        return TPG._edge_residual(TL.sim3_retract(si, t), sj, meas)

    cols = [torch.func.jvp(f, (z,), (torch.eye(7)[c].expand(len(meas), 7),))[1]
            for c in range(7)]
    np.testing.assert_allclose(got.numpy(), torch.stack(cols, -1).numpy(),
                               atol=1e-5)


# ------------------------------------------------------------ dense global BA

def _plane_block(r, cams_gt):
    pl_gt = np.array([[0.0, -1.0, 0.0, 1.5], [1.0, 0.0, 0.0, 2.5],
                      [0.0, 0.0, 1.0, -8.0]], np.float32)
    C, L = cams_gt.shape[0], pl_gt.shape[0]
    meas = np.zeros((C, L, 4), np.float32)
    for c in range(C):
        R = np.asarray(JL.quat_to_rotmat(jnp.asarray(cams_gt[c, :4])))
        n_c = pl_gt[:, :3] @ R.T
        meas[c] = np.concatenate([n_c, (pl_gt[:, 3] - n_c @ cams_gt[c, 4:7])
                                  [:, None]], axis=1)
    pl0 = np.asarray(JB.plane_retract(jnp.asarray(pl_gt), jnp.asarray(
        r.normal(0, 0.05, (L, 3)).astype(np.float32))))
    free = np.array([True, True, False])
    obs_pl = np.tile(np.arange(L, dtype=np.int32), (C, 1))
    obs_pl[2, 1] = -1
    return dict(pl_coeff=pl0, pl_free=free, obs_pl=obs_pl, obs_meas=meas,
                obs_valid=np.ones((C, L), bool)), pl_gt


@pytest.mark.parametrize("planes", [False, True])
def test_dense_bundle_adjust_matches_jax(planes):
    """The global BA at C = 6 cameras, N = 128 slots, 256 points (with a
    starved camera frozen and a point invalid), with and without free
    plane vertices (one of them held): poses within 1e-4, points within
    1e-3 (median 1e-5), planes within 1e-4, the same inlier set, the
    fixed cameras and the invalid point unmoved, the held plane within
    1e-7."""
    r = np.random.default_rng(5)
    prob, cams_gt, _ = make_ba_problem(r, noise_px=0.4)
    d = _np(prob)
    d["cam_fixed"][3] = True
    d["pt_valid"][7] = False
    pf = None
    if planes:
        pf, _ = _plane_block(r, cams_gt)
    rj = JB.bundle_adjust(
        JB.BAProblem(**{k: jnp.asarray(v) for k, v in d.items()}),
        plane_free=None if pf is None else JB.PlaneFreeBlock(
            **{k: jnp.asarray(v) for k, v in pf.items()}),
        cam=CAM, cfg=CFG, pt_chunk=128)
    rt = TB.bundle_adjust(
        TB.BAProblem(**{k: T(v) for k, v in d.items()}),
        plane_free=None if pf is None else TB.PlaneFreeBlock(
            **{k: T(v) for k, v in pf.items()}),
        cam=CAM, cfg=TC.SolverConfig())
    np.testing.assert_allclose(rt.cam_pose.numpy(), np.asarray(rj.cam_pose),
                               atol=1e-4)
    dp = np.abs(rt.pt_xyz.numpy() - np.asarray(rj.pt_xyz))
    assert dp.max() < 1e-3 and np.median(dp) < 1e-5
    np.testing.assert_array_equal(rt.obs_inlier.numpy(),
                                  np.asarray(rj.obs_inlier))
    for c in (0, 3):
        np.testing.assert_array_equal(rt.cam_pose[c].numpy(),
                                      d["cam_pose"][c])
    np.testing.assert_array_equal(rt.pt_xyz[7].numpy(), d["pt_xyz"][7])
    if planes:
        np.testing.assert_allclose(rt.pl_coeff.numpy(),
                                   np.asarray(rj.pl_coeff), atol=1e-4)
        # a zero step re-normalizes the normal: unmoved to 1e-7, as
        # tests/test_ba.py::test_nonfree_planes_fixed holds it
        np.testing.assert_allclose(rt.pl_coeff[2].numpy(), pf["pl_coeff"][2],
                                   atol=1e-7)


# ------------------------------------------------------------ detection gate

def _configs(**kw):
    """The JAX and the port SystemConfig with the same small fields."""
    j = JC.SystemConfig(orb=JC.ORBConfig(n_features=500, max_keypoints=512),
                        capacity=JC.MapCapacity(max_keyframes=16,
                                                max_points=3072,
                                                max_local_ba_kfs=16), **kw)
    t = TC.SystemConfig(orb=TC.ORBConfig(n_features=500, max_keypoints=512),
                        capacity=TC.MapCapacity(max_keyframes=16,
                                                max_points=3072,
                                                max_local_ba_kfs=16), **kw)
    return j, t


def test_detect_from_stats_gating_matches_jax(vocabs):
    """Hand-made statistics over a stream of 8 keyframes: two covisibility
    groups of old keyframes, the query's own neighbourhood, scores that
    make one group a consistent candidate three times running; the port's
    candidates and consistency groups equal the JAX ones at every step,
    and the third consistent detection returns a candidate."""
    jv, tv = vocabs
    jcfg, tcfg = _configs()
    lj = JLC.LoopCloser(jcfg, jv)
    lt = TLC.LoopCloser(tcfg, tv, torch.Generator())
    K = 16
    r = np.random.default_rng(0)
    covis = np.zeros((K, K), np.float32)
    for grp in ([0, 1, 2], [4, 5], list(range(10, 16))):
        for a in grp:
            for b in grp:
                covis[a, b] = 40 + a + b
    covis[3, 4] = covis[4, 3] = 20
    kf_valid = np.ones(K, bool)
    kf_valid[6] = False
    seen = []
    for step, slot in enumerate([12, 13, 14, 15, 15, 9, 15, 15]):
        scores = r.uniform(0.0, 0.05, K).astype(np.float32)
        scores[[0, 1, 2]] = 0.3 + 0.01 * step
        scores[slot - 2:slot] = 0.1
        if step == 5:
            scores[:] = 0.0
        if step == 6:
            lj.last_loop_kf = lt.last_loop_kf = 7
        cj = lj._detect_from_stats(slot, scores, covis.copy(), kf_valid)
        ct = lt._detect_from_stats(slot, scores, covis.copy(), kf_valid)
        assert ct == cj, step
        assert lt.consistent_groups == lj.consistent_groups, step
        seen.append(ct)
    assert any(c in (0, 1, 2) for c in seen)
    assert any(c == -1 for c in seen)


@pytest.mark.parametrize("last_loop", [5, 6])
def test_apply_kf_remap_matches_jax(vocabs, last_loop):
    """Keyframe compaction seen by the loop closer: bow rows moved to their
    new slots (exactly), loop edges and consistency groups remapped or
    dropped, and the last loop keyframe followed (or, when it went, the
    nearest earlier survivor), as the JAX loop closer does."""
    jv, tv = vocabs
    jcfg, tcfg = _configs()
    lj = JLC.LoopCloser(jcfg, jv)
    lt = TLC.LoopCloser(tcfg, tv, torch.Generator())
    bow = np.random.default_rng(1).uniform(size=(16, jv.n_words)).astype(
        np.float32)
    lj.bow, lt.bow = jnp.asarray(bow), T(bow.copy())
    for lc in (lj, lt):
        lc.loop_edges = [(0, 9), (2, 6), (3, 12)]
        lc.consistent_groups = [({1, 2}, 2), ({6}, 1), ({7, 9, 12}, 3)]
        lc.last_loop_kf = last_loop
    remap = np.full(16, -1, np.int64)
    keep = [0, 1, 3, 4, 5, 7, 8, 9, 12]
    remap[keep] = np.arange(len(keep))
    lj.apply_kf_remap(remap)
    lt.apply_kf_remap(remap)
    np.testing.assert_array_equal(lt.bow.numpy(), np.asarray(lj.bow))
    assert lt.loop_edges == lj.loop_edges
    assert lt.consistent_groups == lj.consistent_groups
    assert lt.last_loop_kf == lj.last_loop_kf


def test_reloc_candidates_match_jax():
    """The twin of tests/test_reloc_e2e.py:51-94: two covisibility groups,
    a keyframe spoofing one common word; only the group that shares the
    query's words survives, in the JAX package's order."""
    jcfg = JC.SystemConfig(orb=JC.ORBConfig(n_features=100, max_keypoints=128),
                           capacity=JC.MapCapacity(max_keyframes=16,
                                                   max_points=512))
    K, W = 16, 64
    kf_pt = np.full((K, 128), -1, np.int32)
    for k in range(6):
        kf_pt[k, :100] = np.arange(100)
    for k in range(6, 12):
        kf_pt[k, :100] = 100 + np.arange(100)
    mj = JMS.empty_map(jcfg)._replace(
        kf_valid=jnp.asarray(np.r_[np.ones(12, bool), np.zeros(4, bool)]),
        kf_pt_idx=jnp.asarray(kf_pt), pt_valid=jnp.ones((512,), bool),
        next_kf=jnp.int32(12))
    mj = JMS.refresh_obs_ind(mj)
    mt = TMS.from_numpy(_np(mj), "cpu")
    bow = np.zeros((K, W), np.float32)
    bow[:6, :20] = 1.0 / 20
    bow[6:12, 40:60] = 1.0 / 20
    bow[8] = 0.0
    bow[8, 0] = 1.0
    bow[2, 3] = 0.5 / 20       # group A's keyframes differ a little
    v = np.zeros(W, np.float32)
    v[:20] = 1.0 / 20
    oj = JRel.reloc_candidates(mj, jnp.asarray(v), jnp.asarray(bow))
    ot = TRel.reloc_candidates(mt, T(v), T(bow))
    np.testing.assert_array_equal(ot, oj)
    assert len(ot) >= 1 and all(c < 6 for c in ot) and 8 not in ot


# ------------------------------------------- compute_sim3 and correct, parity

@pytest.fixture(scope="module")
def loop_map():
    """A map after the first 8 frames of the 14-frame seed-3 arc (small
    config, planes on, 16 keyframe slots) built by the port's System, as
    numpy: the same state for both packages. The port's renderer reads the
    JAX package's cache (and renders where it is missing, as on the card's
    host)."""
    seq = TS.generate_sequence(n_frames=14, seed=3, style="arc",
                               cache_dir=synthetic.DEFAULT_CACHE)
    _, tcfg = _configs(use_planes=True, use_objects=False,
                       use_loop_closing=False)
    s = System(tcfg, device="cpu")
    for f in seq.frames[:8]:
        s.process_frame(f.gray, f.depth, timestamp=f.timestamp)
    return TMS.to_numpy(s.map)


def _loop_pair(d):
    """(cur, cand): the newest keyframe and the oldest one it shares
    points with."""
    valid = np.where(d["kf_valid"])[0]
    return int(valid[-1]), int(valid[0])


def test_compute_sim3_and_correct_match_jax(loop_map, vocabs, monkeypatch):
    """On one map state: `compute_sim3` fed the JAX RANSAC draws gives the
    JAX Sim3 within 1e-4; then a synchronous `correct` (async_gba off)
    with that Sim3 moved by 3 cm and 0.02 rad (so the correction,
    fusion, essential graph and GBA have work to do) gives the JAX
    keyframe poses within 2e-3, point positions within 1 cm (median 1e-4),
    the same point validity and fused associations, and the plane
    coefficients within 2e-3."""
    jv, tv = vocabs
    loop = dataclasses.replace(JC.LoopConfig(), async_gba=False)
    jcfg, tcfg = _configs(use_planes=True, use_objects=False)
    jcfg = jcfg.replace(loop=loop)
    tcfg = tcfg.replace(loop=TC.LoopConfig(**dataclasses.asdict(loop)))
    mj = JMS.MapState(**{k: jnp.asarray(v) for k, v in loop_map.items()})
    mt = TMS.from_numpy(loop_map, "cpu")
    cur, cand = _loop_pair(loop_map)
    key = jax.random.PRNGKey(5)
    lj = JLC.LoopCloser(jcfg, jv)
    lt = TLC.LoopCloser(tcfg, tv, torch.Generator())
    drawn = []

    def draw(valid, n, k, g):
        drawn.append(int(valid.sum()))
        return _jax_draws(key, valid.numpy(), n, k)

    monkeypatch.setattr(TLC.ransac, "draw_hypotheses", draw)
    gj = lj.compute_sim3(mj, cur, cand, key)
    gt = lt.compute_sim3(mt, cur, cand)
    assert gj is not None and gt is not None and drawn[0] >= 20
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-4)

    s = np.asarray(JL.sim3_compose(
        JL.sim3_from_se3(JL.se3_exp(jnp.asarray(np.r_[
            0.0, 0.02, 0.0, 0.03, 0.0, -0.01].astype(np.float32)))), gj))
    cj = _np(lj.correct(mj, cur, cand, jnp.asarray(s)))
    ct = TMS.to_numpy(lt.correct(mt, cur, cand, T(s)))
    assert lt.loop_edges == lj.loop_edges and lt.last_loop_kf == cur
    for k in ("kf_valid", "pt_valid", "kf_pt_idx", "kf_pl_idx", "pl_valid"):
        np.testing.assert_array_equal(ct[k], cj[k], err_msg=k)
    kv = cj["kf_valid"]
    np.testing.assert_allclose(ct["kf_pose"][kv], cj["kf_pose"][kv],
                               atol=2e-3)
    pv = cj["pt_valid"]
    dp = np.linalg.norm(ct["pt_xyz"][pv] - cj["pt_xyz"][pv], axis=1)
    assert dp.max() < 1e-2 and np.median(dp) < 1e-4, (dp.max(),
                                                      np.median(dp))
    lv = cj["pl_valid"]
    np.testing.assert_allclose(ct["pl_coeff"][lv], cj["pl_coeff"][lv],
                               atol=2e-3)
    # the correction moved the map
    assert np.abs(ct["kf_pose"][kv] - loop_map["kf_pose"][kv]).max() > 1e-3


@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")
def test_correct_on_card_matches_cpu(loop_map, vocabs):
    """The loop closer's synchronous `correct` on `cuda` against the CPU on
    the same map and Sim3: poses within 2e-3, points within 1 cm (median
    1e-4), planes within 2e-3, the same validity and associations."""
    _, tv = vocabs
    _, tcfg = _configs(use_planes=True, use_objects=False)
    tcfg = tcfg.replace(loop=dataclasses.replace(tcfg.loop, async_gba=False))
    cur, cand = _loop_pair(loop_map)
    g = TL.sim3_from_se3(TL.se3_compose(TL.se3_exp(torch.tensor(
        [0.0, 0.02, 0.0, 0.03, 0.0, -0.01])), TL.se3_compose(
        T(loop_map["kf_pose"][cur]), TL.se3_inverse(T(loop_map["kf_pose"][
            cand])))))
    out = {}
    for dev in ("cpu", "cuda"):
        lt = TLC.LoopCloser(tcfg, TV.Vocabulary.load(device=dev),
                            torch.Generator(device=dev))
        out[dev] = TMS.to_numpy(lt.correct(TMS.from_numpy(loop_map, dev),
                                           cur, cand, g.to(dev)))
    a, b = out["cpu"], out["cuda"]
    for k in ("kf_valid", "pt_valid", "kf_pt_idx", "kf_pl_idx", "pl_valid"):
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    kv, pv, lv = a["kf_valid"], a["pt_valid"], a["pl_valid"]
    np.testing.assert_allclose(b["kf_pose"][kv], a["kf_pose"][kv], atol=2e-3)
    dp = np.linalg.norm(b["pt_xyz"][pv] - a["pt_xyz"][pv], axis=1)
    assert dp.max() < 1e-2 and np.median(dp) < 1e-4
    np.testing.assert_allclose(b["pl_coeff"][lv], a["pl_coeff"][lv],
                               atol=2e-3)
