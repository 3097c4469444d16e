"""Pose optimization of the port against the JAX package: the plain PyTorch
version against `_optimize_pose_xla` and the Pallas kernel (interpreted),
on the 1024-observation problem of test_pose_opt.py (20% outliers, mixed
mono / stereo, every 17th slot invalid), with no planes, two planes, and
eight plane slots of which three are invalid (the second solve of
track_frame gets Q = max_planes_per_frame = 8 slots). Tolerances: pose
error < 1e-3, inlier agreement > 99.5%, n_inliers within 5. The CUDA
kernel against the plain version runs under the `gpu` marker."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eao_fusion_tpu.config import SolverConfig
from eao_fusion_tpu.ops import lie as JL
from eao_fusion_tpu.solvers import pose_opt as JP
from eao_fusion_tpu.solvers import pose_opt_pallas as JPP
from eao_fusion_tpu_torch import config as TC
from eao_fusion_tpu_torch.solvers import pose_opt as TP
from test_pose_opt import CAM, make_problem, pose_err

CFG = SolverConfig()
TCFG = TC.SolverConfig()


# five planes of the scene (floor, back wall, side walls, ceiling) and the
# slots of the eight-slot case: -1 marks an unmatched slot, whose landmark
# is slot 0's (build_plane_obs clamps the index) and whose measurement is
# wrong; the solve must ignore it
PLANES_W = np.array([[0, -1, 0, 1.2], [0, 0, -1, 4.5], [1, 0, 0, 2.5],
                     [-1, 0, 0, 2.5], [0, 1, 0, 1.5]], np.float32)
SLOTS8 = [0, 1, -1, 2, -1, 3, 4, -1]


def _problem(n_slots=2):
    r = np.random.default_rng(7)
    pose_gt, obs, _ = make_problem(r, n=1024, noise=0.3, outlier_frac=0.2)
    ur = np.asarray(obs.uright).copy()
    ur[::3] = -1.0
    valid = np.ones((1024,), bool)
    valid[::17] = False
    obs = obs._replace(uright=jnp.asarray(ur), valid=jnp.asarray(valid))
    R = np.asarray(JL.quat_to_rotmat(pose_gt[:4]))
    n_c = PLANES_W[:, :3] @ R.T
    d_c = PLANES_W[:, 3] - n_c @ pose_gt[4:7]
    meas = np.concatenate([n_c, d_c[:, None]], axis=1).astype(np.float32)
    slots = [0, 1] if n_slots == 2 else SLOTS8
    idx = np.maximum(slots, 0)
    planes_w, meas_c = PLANES_W[idx], meas[idx]
    bad = np.array(slots) < 0
    # wrong measurements in the unmatched slots, inside the plane chi2
    # gate, so that using them would pull the pose: the back wall 15 cm
    # off, the floor 15 cm off, a side wall's normal tilted by 0.25 rad
    if bad.any():
        tilt = np.r_[meas[2, :3] + [0, 0.25, 0], meas[2, 3]]
        meas_c[bad] = [meas[1] + [0, 0, 0, 0.15], meas[0] + [0, 0, 0, 0.15],
                       tilt / np.r_[np.linalg.norm(tilt[:3]).repeat(3), 1]]
    pobs = JP.PlaneObs(plane_w=jnp.asarray(planes_w),
                       meas_c=jnp.asarray(meas_c.astype(np.float32)),
                       valid=jnp.asarray(~bad))
    pose0 = jnp.asarray(np.asarray(JL.se3_retract(
        jnp.asarray(pose_gt), jnp.asarray(
            np.r_[0.02, -0.01, 0.02, 0.06, -0.04, 0.05], np.float32))))
    return pose0, obs, pobs


def _to_torch(nt, cls, device="cpu"):
    return cls(*[torch.as_tensor(np.array(getattr(nt, k)), device=device)
                 for k in cls._fields])


def _valid_only(pobs):
    """The same plane factors with the unmatched slots left out."""
    keep = np.asarray(pobs.valid)
    return type(pobs)(*[t[keep] for t in pobs])


def _check(ref, pose, inliers, n_inliers):
    assert pose_err(ref.pose, np.asarray(pose)) < 1e-3
    ri = np.asarray(ref.inliers)
    assert (ri == np.asarray(inliers)).mean() > 0.995
    assert abs(int(ref.n_inliers) - int(n_inliers)) <= 5


@pytest.mark.parametrize("with_planes", [False, True, "8 slots"])
def test_plain_matches_xla_and_pallas(with_planes):
    pose0, obs, pobs = _problem(8 if with_planes == "8 slots" else 2)
    p = pobs if with_planes else None
    res = TP.optimize_pose(torch.from_numpy(np.array(pose0)),
                           _to_torch(obs, TP.PoseObs),
                           _to_torch(p, TP.PlaneObs) if p else None,
                           cam=CAM, cfg=TCFG)
    ref_x = JP._optimize_pose_xla(pose0, obs, p, cam=CAM, cfg=CFG)
    ref_p = JPP.optimize_pose_pallas(pose0, obs, p, cam=CAM, cfg=CFG,
                                     interpret=True)
    for ref in (ref_x, ref_p):
        _check(ref, res.pose.numpy(), res.inliers.numpy(), res.n_inliers)
    np.testing.assert_allclose(float(res.chi2), float(ref_x.chi2), rtol=1e-3)
    if with_planes == "8 slots":
        # the unmatched slots change nothing (used, they would move the
        # pose by ~7e-4)
        res5 = TP.optimize_pose(torch.from_numpy(np.array(pose0)),
                                _to_torch(obs, TP.PoseObs),
                                _to_torch(_valid_only(p), TP.PlaneObs),
                                cam=CAM, cfg=TCFG)
        assert pose_err(res5.pose.numpy(), res.pose.numpy()) < 1e-4


def test_cpu_dispatch_is_the_plain_version():
    pose0, obs, _ = _problem()
    args = (torch.from_numpy(np.array(pose0)), _to_torch(obs, TP.PoseObs))
    a = TP.optimize_pose(*args, cam=CAM, cfg=TCFG)
    stats = {}
    b = TP.optimize_pose_plain(*args, cam=CAM, cfg=TCFG, stats=stats)
    np.testing.assert_array_equal(a.pose.numpy(), b.pose.numpy())
    assert 4 <= stats["gn_iters"] <= TCFG.pose_rounds * TCFG.pose_iters_per_round


def test_kernel_wrapper_never_falls_back():
    """Handed a CPU tensor, the CUDA wrapper raises instead of running the
    plain version; too many planes raise before anything launches."""
    from eao_fusion_tpu_torch import kernels
    pose0, obs, pobs = _problem()
    before = dict(kernels.launches)
    with pytest.raises(ValueError, match="CUDA"):
        TP.optimize_pose_cuda(torch.from_numpy(np.array(pose0)),
                              _to_torch(obs, TP.PoseObs), cam=CAM, cfg=TCFG)
    many = TP.PlaneObs(plane_w=torch.zeros(129, 4), meas_c=torch.zeros(129, 4),
                       valid=torch.ones(129, dtype=torch.bool))
    with pytest.raises(ValueError, match="planes"):
        TP.optimize_pose_cuda(torch.from_numpy(np.array(pose0)),
                              _to_torch(obs, TP.PoseObs), many, cam=CAM,
                              cfg=TCFG)
    assert kernels.launches == before


def _bad_inputs(case):
    """The problem's inputs with one thing the kernel does not take."""
    pose0, obs, _ = _problem()
    pose0 = torch.from_numpy(np.array(pose0))
    obs = _to_torch(obs, TP.PoseObs)
    if case == "float64 pts_w":
        obs = obs._replace(pts_w=obs.pts_w.double())
    elif case == "non-contiguous pts_w":
        obs = obs._replace(pts_w=obs.pts_w.T.contiguous().T)
    elif case == "1025 observations":
        obs = TP.PoseObs(*[torch.cat([t, t[:1]]) for t in obs])
    return pose0, obs


@pytest.mark.parametrize("case, message", [
    ("cpu", "CUDA"), ("float64 pts_w", "float32"),
    ("non-contiguous pts_w", "contiguous"),
    ("1025 observations", "observations")])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(case, message):
    """The kernel reads its inputs where they lie, so the wrapper checks
    each one and raises before anything launches; it copies nothing."""
    from eao_fusion_tpu_torch import kernels
    pose0, obs = _bad_inputs(case)
    before = dict(kernels.launches)
    with pytest.raises(ValueError, match=message):
        TP.optimize_pose_cuda(pose0, obs, cam=CAM, cfg=TCFG)
    assert kernels.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("with_planes", [False, True, "8 slots"])
def test_cuda_kernel_matches_plain(with_planes):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pose0, obs, pobs = _problem(8 if with_planes == "8 slots" else 2)
    dev = torch.device("cuda")
    args = (torch.as_tensor(np.array(pose0), device=dev),
            _to_torch(obs, TP.PoseObs, dev),
            _to_torch(pobs, TP.PlaneObs, dev) if with_planes else None)
    ref = TP.optimize_pose_plain(*args, cam=CAM, cfg=TCFG)
    ker = TP.optimize_pose_cuda(*args, cam=CAM, cfg=TCFG)
    assert pose_err(ref.pose.cpu().numpy(), ker.pose.cpu().numpy()) < 1e-3
    agree = (ref.inliers == ker.inliers).float().mean().item()
    assert agree > 0.995
    assert abs(int(ref.n_inliers) - int(ker.n_inliers)) <= 5
    if with_planes == "8 slots":
        ker5 = TP.optimize_pose_cuda(
            *args[:2], _to_torch(_valid_only(pobs), TP.PlaneObs, dev),
            cam=CAM, cfg=TCFG)
        assert pose_err(ker5.pose.cpu().numpy(), ker.pose.cpu().numpy()) < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("n_slots", [0, 8])
def test_cuda_call_is_one_device_kernel(n_slots):
    """The wrapper packs nothing and converts nothing: the profiler sees
    exactly one device kernel per call, with and without the plane slots."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    pose0, obs, pobs = _problem(max(n_slots, 2))
    dev = torch.device("cuda")
    args = (torch.as_tensor(np.array(pose0), device=dev),
            _to_torch(obs, TP.PoseObs, dev),
            _to_torch(pobs, TP.PlaneObs, dev) if n_slots else None)
    TP.optimize_pose_cuda(*args, cam=CAM, cfg=TCFG)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            TP.optimize_pose_cuda(*args, cam=CAM, cfg=TCFG)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(names) == 5, names
    assert all("pose_opt_kernel" in n for n in names), names
