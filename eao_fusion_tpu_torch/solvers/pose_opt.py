"""Per-frame pose optimization: Gauss-Newton with Huber IRLS and chi2
inlier reclassification (port of `eao_fusion_tpu/solvers/pose_opt.py`).

The schedule is the reference's (`Optimizer::PoseOptimization`): 4 rounds
of up to 10 GN iterations with an early exit at |δ| <= 1e-6, chi2 gates
5.991 (mono) / 7.815 (stereo) between rounds, optional fixed-plane factors
(angleInfo 3282.8, disInfo 1e4, chi2 300). The update is the left
retraction T <- exp(δ) T.

`optimize_pose` runs the hand-written CUDA kernel `csrc/pose_opt.cu`
(`optimize_pose_cuda`, the port of the Pallas kernel
`eao_fusion_tpu/solvers/pose_opt_pallas.py:optimize_pose_pallas`) for
CUDA tensors, and the plain PyTorch version `optimize_pose_plain` (the
port of `_optimize_pose_xla`) for CPU tensors. `SolverConfig.use_pallas_pose`
is not read.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from eao_fusion_tpu_torch import kernels
from eao_fusion_tpu_torch.config import SolverConfig
from eao_fusion_tpu_torch.ops import lie

MAX_PLANES = 128
# the kernel's block of 256 threads holds four observations a thread
MAX_OBS = 1024


class PoseObs(NamedTuple):
    """Fixed-capacity point-observation set for one frame."""
    pts_w: torch.Tensor       # [M, 3] world points
    uv: torch.Tensor          # [M, 2] observed pixels
    uright: torch.Tensor      # [M] virtual right u; < 0 -> mono edge
    inv_sigma2: torch.Tensor  # [M] information scale
    valid: torch.Tensor       # [M] bool


class PlaneObs(NamedTuple):
    """Camera-frame measured plane vs fixed world plane landmark (both
    Hessian normal [n, d])."""
    plane_w: torch.Tensor     # [Q, 4]
    meas_c: torch.Tensor      # [Q, 4]
    valid: torch.Tensor       # [Q] bool


class PoseOptResult(NamedTuple):
    pose: torch.Tensor        # [7] optimized Tcw
    inliers: torch.Tensor     # [M] bool
    n_inliers: torch.Tensor   # [] int32
    chi2: torch.Tensor        # [] f32


def _point_residual_jac(pose, obs: PoseObs, fx, fy, cx, cy, bf):
    """Residuals r [M,3] (3rd lane zero for mono) and Jacobian J [M,3,6]
    w.r.t. the left-retraction tangent."""
    xc = lie.se3_apply(pose, obs.pts_w)
    x, y = xc[:, 0], xc[:, 1]
    z = torch.clamp(xc[:, 2], min=1e-6)
    iz = 1.0 / z
    iz2 = iz * iz
    u = fx * x * iz + cx
    v = fy * y * iz + cy
    ur = u - bf * iz
    stereo = obs.uright >= 0.0
    r = torch.stack([obs.uv[:, 0] - u, obs.uv[:, 1] - v,
                     torch.where(stereo, obs.uright - ur, 0.0)], dim=-1)
    zero = torch.zeros_like(z)
    du = torch.stack([fx * iz, zero, -fx * x * iz2], dim=-1)
    dv = torch.stack([zero, fy * iz, -fy * y * iz2], dim=-1)
    dur = du + torch.stack([zero, zero, bf * iz2], dim=-1)
    dproj = torch.stack([du, dv, torch.where(stereo[:, None], dur, 0.0)],
                        dim=-2)                                   # [M,3,3]
    eye = torch.eye(3, dtype=xc.dtype, device=xc.device).expand(
        xc.shape[:-1] + (3, 3))
    dxc = torch.cat([-lie.so3_hat(xc), eye], dim=-1)              # [M,3,6]
    J = -torch.einsum("mij,mjk->mik", dproj, dxc)
    behind = xc[:, 2] < 1e-3
    return r, J, stereo, behind


def _plane_residual_jac(pose, pobs: PlaneObs):
    """Plane residual r = [n_c × n_m, d_c − d_m] and its Jacobians at the
    left-retraction origin (derivation in the JAX module)."""
    n_w = pobs.plane_w[:, :3]
    d_w = pobs.plane_w[:, 3]
    R = lie.quat_to_rotmat(pose[:4])
    t = pose[4:7]
    n_c = n_w @ R.T
    d_c = d_w - n_c @ t
    n_m = pobs.meas_c[:, :3]
    d_m = pobs.meas_c[:, 3]
    r_ang = lie.cross(n_c, n_m)
    r_dst = (d_c - d_m)[:, None]
    J_ang_w = torch.einsum("qij,qjk->qik", -lie.so3_hat(n_m),
                           -lie.so3_hat(n_c))
    J_ang = torch.cat([J_ang_w, torch.zeros_like(J_ang_w)], dim=-1)
    J_dst = torch.cat([torch.zeros_like(n_c), -n_c], dim=-1)[:, None, :]
    return r_ang, r_dst, J_ang, J_dst


def optimize_pose(pose0: torch.Tensor, obs: PoseObs,
                  plane_obs: Optional[PlaneObs] = None,
                  *, cam: Tuple[float, float, float, float, float],
                  cfg: SolverConfig) -> PoseOptResult:
    """cam = (fx, fy, cx, cy, bf). CUDA tensors go through the kernel, CPU
    tensors through the plain version; there is no fallback between them."""
    if pose0.is_cuda:
        return optimize_pose_cuda(pose0, obs, plane_obs, cam=cam, cfg=cfg)
    return optimize_pose_plain(pose0, obs, plane_obs, cam=cam, cfg=cfg)


def optimize_pose_plain(pose0: torch.Tensor, obs: PoseObs,
                        plane_obs: Optional[PlaneObs] = None,
                        *, cam: Tuple[float, float, float, float, float],
                        cfg: SolverConfig,
                        stats: Optional[dict] = None) -> PoseOptResult:
    """The plain PyTorch version (port of `_optimize_pose_xla`). The early
    exit reads |δ| on the host once per iteration. If `stats` is given, it
    receives the number of GN iterations run (`stats["gn_iters"]`), which
    sizes the kernel's work for its bound."""
    fx, fy, cx, cy, bf = cam
    valid_f = obs.valid.float()
    eye6 = torch.eye(6, dtype=torch.float32, device=pose0.device)

    def point_chi2(pose):
        r, _, stereo, behind = _point_residual_jac(pose, obs, fx, fy, cx, cy,
                                                   bf)
        return torch.sum(r * r, dim=-1) * obs.inv_sigma2, stereo, behind

    def plane_chi2(pose):
        r_ang, r_dst, _, _ = _plane_residual_jac(pose, plane_obs)
        return (cfg.plane_angle_info * torch.sum(r_ang * r_ang, dim=-1)
                + cfg.plane_dist_info * torch.sum(r_dst * r_dst, dim=-1))

    def gn_iter(pose, inlier, pl_inlier):
        r, J, stereo, behind = _point_residual_jac(pose, obs, fx, fy, cx, cy,
                                                   bf)
        w_info = obs.inv_sigma2
        chi2 = torch.sum(r * r, dim=-1) * w_info
        delta2 = torch.where(stereo, cfg.chi2_stereo, cfg.chi2_mono)
        w_rob = torch.clamp(torch.sqrt(delta2 / torch.clamp(chi2, min=1e-12)),
                            max=1.0)
        w = w_info * w_rob * inlier.float() * valid_f * (1.0 - behind.float())
        H = torch.einsum("mri,m,mrj->ij", J, w, J)
        b = -torch.einsum("mri,m,mr->i", J, w, r)
        if plane_obs is not None:
            r_ang, r_dst, J_ang, J_dst = _plane_residual_jac(pose, plane_obs)
            c2 = (cfg.plane_angle_info * torch.sum(r_ang * r_ang, -1)
                  + cfg.plane_dist_info * torch.sum(r_dst * r_dst, -1))
            hub_p = torch.clamp(torch.sqrt(
                cfg.plane_chi2 / torch.clamp(c2, min=1e-12)), max=1.0)
            pw = plane_obs.valid.float() * hub_p * pl_inlier.float()
            H = H + cfg.plane_angle_info * torch.einsum(
                "qri,q,qrj->ij", J_ang, pw, J_ang)
            b = b - cfg.plane_angle_info * torch.einsum(
                "qri,q,qr->i", J_ang, pw, r_ang)
            H = H + cfg.plane_dist_info * torch.einsum(
                "qri,q,qrj->ij", J_dst, pw, J_dst)
            b = b - cfg.plane_dist_info * torch.einsum(
                "qri,q,qr->i", J_dst, pw, r_dst)
        delta = torch.linalg.solve(H + 1e-6 * eye6, b)
        delta = torch.where(torch.all(torch.isfinite(delta)), delta, 0.0)
        return lie.se3_retract(pose, delta), float(torch.linalg.norm(delta))

    pose = pose0
    inlier = obs.valid
    pl_inlier = plane_obs.valid if plane_obs is not None else None
    n_iters = 0
    for _ in range(cfg.pose_rounds):
        it, dn = 0, float("inf")
        while it < cfg.pose_iters_per_round and dn > 1e-6:
            pose, dn = gn_iter(pose, inlier, pl_inlier)
            it += 1
        n_iters += it
        chi2, stereo, behind = point_chi2(pose)
        thresh = torch.where(stereo, cfg.chi2_stereo, cfg.chi2_mono)
        inlier = (chi2 <= thresh) & obs.valid & (~behind)
        if plane_obs is not None:
            pl_inlier = (plane_chi2(pose) <= cfg.plane_chi2) & plane_obs.valid
    chi2, _, _ = point_chi2(pose)
    if stats is not None:
        stats["gn_iters"] = n_iters
    return PoseOptResult(pose=pose, inliers=inlier,
                         n_inliers=inlier.sum().to(torch.int32),
                         chi2=torch.sum(torch.where(inlier, chi2, 0.0)))


def optimize_pose_cuda(pose0: torch.Tensor, obs: PoseObs,
                       plane_obs: Optional[PlaneObs] = None,
                       *, cam: Tuple[float, float, float, float, float],
                       cfg: SolverConfig) -> PoseOptResult:
    """The whole schedule in one launch of `csrc/pose_opt.cu` (one thread
    block, the observations in registers). The kernel reads the inputs
    where they lie and writes the result's tensors, so a call is one device
    kernel. Raises, before anything launches, on what the kernel does not
    take: a CPU tensor, another dtype, shape or a non-contiguous layout,
    more than MAX_OBS observations or MAX_PLANES planes."""
    dev = pose0.device
    M = obs.valid.shape[0]
    Q = 0 if plane_obs is None else plane_obs.valid.shape[0]
    if Q > MAX_PLANES:
        raise ValueError(f"pose kernel takes at most {MAX_PLANES} planes, "
                         f"got {Q}")
    if not 1 <= M <= MAX_OBS:
        raise ValueError(f"pose kernel takes 1 to {MAX_OBS} observations, "
                         f"got {M}")
    f32, b8 = torch.float32, torch.bool
    inputs = [(pose0, "pose0", f32, (7,)),
              (obs.pts_w, "pts_w", f32, (M, 3)),
              (obs.uv, "uv", f32, (M, 2)),
              (obs.uright, "uright", f32, (M,)),
              (obs.inv_sigma2, "inv_sigma2", f32, (M,)),
              (obs.valid, "valid", b8, (M,))]
    if Q:
        inputs += [(plane_obs.plane_w, "plane_w", f32, (Q, 4)),
                   (plane_obs.meas_c, "meas_c", f32, (Q, 4)),
                   (plane_obs.valid, "plane valid", b8, (Q,))]
    for t, name, dtype, shape in inputs:
        kernels.require_layout(t, name, dtype, shape)
    for t, name, _, _ in inputs:
        kernels.require_device(t, name, dev)
    planes = ([t.data_ptr() for t in plane_obs] if Q else [None] * 3)
    pose = torch.empty(7, dtype=f32, device=dev)
    inliers = torch.empty(M, dtype=b8, device=dev)
    n_inliers = torch.empty((), dtype=torch.int32, device=dev)
    chi2 = torch.empty((), dtype=f32, device=dev)
    fx, fy, cx, cy, bf = (float(c) for c in cam)
    lib = kernels.library("pose_opt")
    kernels.launch(
        "pose_opt", lib.pose_opt_launch, dev,
        pose0.data_ptr(), *(t.data_ptr() for t in obs), M, *planes, Q,
        fx, fy, cx, cy, bf, int(cfg.pose_rounds),
        int(cfg.pose_iters_per_round), float(cfg.chi2_mono),
        float(cfg.chi2_stereo), float(cfg.plane_angle_info),
        float(cfg.plane_dist_info), float(cfg.plane_chi2),
        pose.data_ptr(), inliers.data_ptr(), n_inliers.data_ptr(),
        chi2.data_ptr())
    return PoseOptResult(pose=pose, inliers=inliers, n_inliers=n_inliers,
                         chi2=chi2)
