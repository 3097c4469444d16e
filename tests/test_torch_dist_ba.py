"""The port's observation-sharded global BA against the JAX package:
`partition_observations` array for array, `_obs_residuals`, and
`distributed_bundle_adjust` on 2 gloo ranks (spawned processes, a file
store) against the JAX solver on a 2-device ``lm`` mesh of the conftest's
CPU devices, with and without free planes (n_iters1 = n_iters = 6); the
1- and 4-rank runs against the 2-rank one; and the port against its own
dense `bundle_adjust`. Each test states its tolerance."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eao_fusion_tpu.ops import lie as JL
from eao_fusion_tpu.parallel import dist_ba as JD
from eao_fusion_tpu.parallel import mesh as JM
from eao_fusion_tpu.solvers import ba as JB
from eao_fusion_tpu_torch.config import SolverConfig
from eao_fusion_tpu_torch.parallel import dist_ba as TD
from eao_fusion_tpu_torch.solvers import ba as TB
from test_ba import CAM, CFG, cam_rmse, make_ba_problem
import torch_dist_worker as W

ITERS = dict(n_iters1=6, n_iters=6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This module's torch ops on one CPU thread (tier-1 runs six test
    files at once); put back after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_torch(prob):
    return TB.BAProblem(*(torch.as_tensor(np.array(getattr(prob, k)))
                          for k in TB.BAProblem._fields))


def _plane_problem():
    """test_ba.py's two-phase problem with two free planes (seed 9)."""
    r = np.random.default_rng(9)
    prob, cams_gt, _ = make_ba_problem(r, n_pts=256, noise_px=0.2)
    C = cams_gt.shape[0]
    pl_gt = np.array([[0.0, -1.0, 0.0, 1.5],
                      [1.0, 0.0, 0.0, 2.5]], np.float32)
    Lp = pl_gt.shape[0]
    meas = np.zeros((C, Lp, 4), np.float32)
    for c in range(C):
        R = np.asarray(JL.quat_to_rotmat(jnp.asarray(cams_gt[c, :4])))
        n_c = pl_gt[:, :3] @ R.T
        d_c = pl_gt[:, 3] - n_c @ cams_gt[c, 4:7]
        meas[c] = np.concatenate([n_c, d_c[:, None]], axis=1)
    delta = r.normal(0, 0.05, (Lp, 3)).astype(np.float32)
    pl0 = np.asarray(JB.plane_retract(jnp.asarray(pl_gt),
                                      jnp.asarray(delta)))
    pf = JB.PlaneFreeBlock(
        pl_coeff=jnp.asarray(pl0), pl_free=jnp.ones(Lp, bool),
        obs_pl=jnp.tile(jnp.arange(Lp, dtype=jnp.int32), (C, 1)),
        obs_meas=jnp.asarray(meas), obs_valid=jnp.ones((C, Lp), bool))
    return prob, pf


def _problems():
    prob, _, _ = make_ba_problem(np.random.default_rng(3), n_pts=256,
                                 noise_px=0.2)
    return {"plain": (prob, None), "planes": _plane_problem()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both problems through the port on 1, 2 and 4 ranks (one spawned
    group each, the three at once) and through the JAX solver on a
    2-device mesh meanwhile:
    {name: {"w1"|"w2"|"w4"|"jax": result arrays}}."""
    tmp = tmp_path_factory.mktemp("dist_ba")
    probs = _problems()
    for name, (prob, pf) in probs.items():
        W.save_problem(tmp / f"{name}.npz", prob, pf)
    args = dict(problems=list(probs), cam=list(CAM), **ITERS)
    out = {name: {} for name in probs}
    groups = {world: W.start_ranks(W.job_dist_ba, world, tmp, args)
              for world in (1, 2, 4)}
    mesh = JM.make_mesh(n_landmark=2)
    for name, (prob, pf) in probs.items():
        res = JD.distributed_bundle_adjust(prob, mesh, plane_free=pf,
                                           cam=CAM, cfg=CFG, **ITERS)
        out[name]["jax"] = {
            "cam_pose": np.asarray(res.cam_pose),
            "pt_xyz": np.asarray(res.pt_xyz),
            "obs_inlier": np.asarray(res.obs_inlier),
            "chi2": np.asarray(res.chi2)}
        if pf is not None:
            out[name]["jax"]["pl_coeff"] = np.asarray(res.pl_coeff)
    for world, handle in groups.items():
        W.join_ranks(handle)
        for name in probs:
            out[name][f"w{world}"] = dict(
                np.load(tmp / f"{name}_w{world}.npz"))
    return out


@pytest.mark.parametrize("n_pts,n_dev", [(256, 2), (256, 4), (256, 8),
                                         (512, 2), (512, 4), (512, 8)])
def test_partition_matches_jax(n_pts, n_dev):
    """The same arrays, exactly, on test_ba's problem (512 observation
    slots a camera for 512 points)."""
    prob, _, _ = make_ba_problem(np.random.default_rng(7), n_pts=n_pts,
                                 n_slots=n_pts)
    ref = JD.partition_observations(prob, n_dev)
    got = TD.partition_observations(_to_torch(prob), n_dev)
    for k in JD.ShardedObs._fields:
        a, b = getattr(got, k).numpy(), np.asarray(getattr(ref, k))
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert got.valid.sum() == int(np.asarray(
        prob.obs_valid & (prob.obs_pt >= 0)).sum())


def test_obs_residuals_match_jax():
    """Each shard's observations, some points behind their cameras: the
    same stereo and behind flags; in front of the cameras, the projections
    (observation - residual) within 1e-5 relative or 1e-4 px (a projection
    adds cx = 320 px, whose float32 spacing is 3e-5 px), the Jacobians
    within 1e-5 relative or absolute. Behind a camera the depth is clamped
    to 1e-6, which scales rounding by 1e6, and the weight is 0."""
    prob, _, _ = make_ba_problem(np.random.default_rng(5), n_pts=256,
                                 n_slots=256)
    pts = np.asarray(prob.pt_xyz).copy()
    pts[::31, 2] = -pts[::31, 2]
    prob = prob._replace(pt_xyz=jnp.asarray(pts))
    ref_obs = JD.partition_observations(prob, 2)
    got_obs = TD.partition_observations(_to_torch(prob), 2)
    n_behind = 0
    for d in range(2):
        jo = JD.ShardedObs(*(x[d] for x in ref_obs))
        to = TD.ShardedObs(*(x[d] for x in got_obs))
        sl = slice(d * 128, (d + 1) * 128)
        ref = JD._obs_residuals(prob.cam_pose, prob.pt_xyz[sl], jo, CAM)
        got = TD._obs_residuals(torch.as_tensor(np.array(prob.cam_pose)),
                                torch.as_tensor(pts[sl]), to, CAM)
        for k in (3, 4):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
        front = ~got[4].numpy() & to.valid.numpy()
        uv = np.concatenate([to.uv.numpy(), to.ur.numpy()[:, None]], 1)
        np.testing.assert_allclose((uv - got[0].numpy())[front],
                                   (uv - np.asarray(ref[0]))[front],
                                   rtol=1e-5, atol=1e-4)
        for k in (1, 2):
            np.testing.assert_allclose(got[k].numpy()[front],
                                       np.asarray(ref[k])[front],
                                       rtol=1e-5, atol=1e-5)
        assert front.sum() > 300
        n_behind += int(got[4].sum())
    assert n_behind > 0


def _gaps(a, b):
    """(max |Δ pose|, median point distance m, relative chi2 gap, share of
    equal inlier flags)."""
    dp = np.linalg.norm(a["pt_xyz"] - b["pt_xyz"], axis=1)
    return (float(np.abs(a["cam_pose"] - b["cam_pose"]).max()),
            float(np.median(dp)),
            float(abs(a["chi2"] - b["chi2"]) / max(abs(b["chi2"]), 1e-9)),
            float(np.mean(a["obs_inlier"] == b["obs_inlier"])))


@pytest.mark.parametrize("name", ["plain", "planes"])
def test_two_ranks_match_jax_mesh(runs, name):
    """2 gloo ranks against the JAX 2-device mesh: poses within 1e-3, the
    median point 1e-3 m, chi2 1e-3 relative, inlier flags equal on
    >= 99.5%; planes within 1e-3."""
    got, ref = runs[name]["w2"], runs[name]["jax"]
    pose, pt, chi2, same = _gaps(got, ref)
    print(f"{name}: 2 ranks vs JAX mesh: pose {pose:.3g}, point median "
          f"{pt:.3g} m, chi2 {chi2:.3g}, inliers equal {same:.4f}")
    assert pose < 1e-3 and pt < 1e-3 and chi2 < 1e-3 and same >= 0.995
    if name == "planes":
        np.testing.assert_allclose(got["pl_coeff"], ref["pl_coeff"],
                                   atol=1e-3)


@pytest.mark.parametrize("world", [1, 4])
def test_rank_counts_agree(runs, world):
    """1 and 4 ranks against 2: only the order of the sums differs. Poses
    within 1e-5, points and chi2 within 1e-5 relative, the same inlier
    flags."""
    for name in ("plain", "planes"):
        a, b = runs[name][f"w{world}"], runs[name]["w2"]
        pose, pt, chi2, same = _gaps(a, b)
        print(f"{name}: {world} vs 2 ranks: pose {pose:.3g}, point "
              f"median {pt:.3g} m, chi2 {chi2:.3g}")
        assert pose < 1e-5 and chi2 < 1e-5 and same == 1.0
        np.testing.assert_allclose(a["pt_xyz"], b["pt_xyz"], rtol=1e-5,
                                   atol=1e-6)
        if name == "planes":
            np.testing.assert_allclose(a["pl_coeff"], b["pl_coeff"],
                                       atol=1e-5)


@pytest.mark.parametrize("name", ["plain", "planes"])
def test_matches_dense_bundle_adjust(runs, name):
    """The port's 2-rank run against its own dense solver on the same
    problem, to tests/test_ba.py:180-186's bounds: camera RMSE < 2e-3,
    median point difference < 5e-3 m."""
    prob, pf = _problems()[name]
    tpf = None if pf is None else TB.PlaneFreeBlock(
        *(torch.as_tensor(np.array(x)) for x in pf))
    res = TB.bundle_adjust(_to_torch(prob), plane_free=tpf, cam=CAM,
                           cfg=SolverConfig(), n_iters1=6, n_iters2=6)
    got = runs[name]["w2"]
    assert cam_rmse(got["cam_pose"], res.cam_pose.numpy()) < 2e-3
    dpt = np.linalg.norm(got["pt_xyz"] - res.pt_xyz.numpy(), axis=1)
    assert np.median(dpt) < 5e-3
