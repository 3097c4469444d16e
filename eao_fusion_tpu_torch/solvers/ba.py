"""Local bundle adjustment on the COO edge layout (port of
`eao_fusion_tpu/solvers/ba.py:bundle_adjust_coo`, with its fixed-plane
camera factors; `_plane_free_terms` and the global `bundle_adjust` come
with the loop-closing slice).

Two-phase Levenberg-Marquardt over C cameras, a window of Pw points and E
edges: phase 1 (≤ n_iters1), a chi2 / positive-depth outlier gate, phase 2
(≤ n_iters2), as `Optimizer::LocalBundleAdjustment` schedules it. The
edge passes are bound once per call (`solvers/ba_edge.EdgePass`: the CUDA
kernels for CUDA tensors). Each iteration runs the full pass, which also
sums the camera and point blocks (the JAX package's one-hot [C,E] /
[Pw,E] matmuls; inside the kernel on the card, `index_add_` in the plain
version), and the chi2 sum of the accept test; it gathers the Hcp block
into a dense [C, Pw] grid through an edge-index table, solves the reduced
camera system with the Cholesky solve of `solvers/chol.py` (the CUDA
kernel K4 for CUDA tensors; the JAX function uses `jnp.linalg.solve`) and
back-substitutes the points. The accept test and the stopping rule read
the cost on the host once per iteration (the JAX `while_loop` becomes a
Python loop); the arithmetic of that host logic is done in float32, as
the JAX loop does it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from eao_fusion_tpu_torch.config import SolverConfig
from eao_fusion_tpu_torch.ops import lie
from eao_fusion_tpu_torch.solvers import ba_edge, chol


class BACooProblem(NamedTuple):
    cam_pose: torch.Tensor    # [C, 7] Tcw
    cam_valid: torch.Tensor   # [C] bool
    cam_fixed: torch.Tensor   # [C] bool
    pt_xyz: torch.Tensor      # [Pw, 3] window-compacted points
    pt_valid: torch.Tensor    # [Pw] bool
    obs_cam: torch.Tensor     # [E] int32 camera index
    obs_pt: torch.Tensor      # [E] int32 window-local point index (-1 none)
    obs_uv: torch.Tensor      # [E, 2]
    obs_ur: torch.Tensor      # [E] virtual right u, < 0 = mono
    obs_inv_sigma2: torch.Tensor  # [E]
    obs_valid: torch.Tensor   # [E] bool


class BAResult(NamedTuple):
    cam_pose: torch.Tensor
    pt_xyz: torch.Tensor
    obs_inlier: torch.Tensor  # [E] bool
    chi2: torch.Tensor        # [] total inlier chi2
    pl_coeff: Optional[torch.Tensor] = None


def _inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate / determinant)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-18, 1e-18, det)
    M = torch.stack([torch.stack([A11, A12, A13], -1),
                     torch.stack([A21, A22, A23], -1),
                     torch.stack([A31, A32, A33], -1)], -2)
    return M * inv_det[..., None, None]


def _plane_terms(cam_pose: torch.Tensor, plane_w: torch.Tensor,
                 meas_c: torch.Tensor, valid: torch.Tensor,
                 cfg: SolverConfig):
    """Per-camera fixed-plane factors: (Hcc_add [C,6,6], bc_add [C,6],
    cost []), with the residual and Jacobians of the pose solver's plane
    factor; each measurement is sign-aligned to its predicted normal."""
    R = lie.quat_to_rotmat(cam_pose[:, :4])                   # [C, 3, 3]
    n_c = torch.einsum("cij,cfj->cfi", R, plane_w[..., :3])   # [C, F, 3]
    d_c = plane_w[..., 3] - torch.einsum("cfi,ci->cf", n_c, cam_pose[:, 4:7])
    n_m = meas_c[..., :3]
    d_m = meas_c[..., 3]
    flip = torch.sum(n_c * n_m, dim=-1) < 0
    n_m = torch.where(flip[..., None], -n_m, n_m)
    d_m = torch.where(flip, -d_m, d_m)

    r_ang = lie.cross(n_c, n_m)                               # [C, F, 3]
    r_dst = d_c - d_m                                         # [C, F]
    chi2 = (cfg.plane_angle_info * torch.sum(r_ang * r_ang, dim=-1)
            + cfg.plane_dist_info * r_dst * r_dst)
    hub = torch.clamp(torch.sqrt(cfg.plane_chi2
                                 / torch.clamp(chi2, min=1e-12)), max=1.0)
    w = valid.float() * hub * (chi2 <= 4 * cfg.plane_chi2).float()

    J_ang_w = torch.einsum("cfij,cfjk->cfik", -lie.so3_hat(n_m),
                           -lie.so3_hat(n_c))
    J_ang = torch.cat([J_ang_w, torch.zeros_like(J_ang_w)], dim=-1)
    J_dst = torch.cat([torch.zeros_like(n_c), -n_c], dim=-1)  # [C, F, 6]
    Hcc = (cfg.plane_angle_info
           * torch.einsum("cfri,cf,cfrj->cij", J_ang, w, J_ang)
           + cfg.plane_dist_info
           * torch.einsum("cfi,cf,cfj->cij", J_dst, w, J_dst))
    bc = -(cfg.plane_angle_info
           * torch.einsum("cfri,cf,cfr->ci", J_ang, w, r_ang)
           + cfg.plane_dist_info
           * torch.einsum("cfi,cf,cf->ci", J_dst, w, r_dst))
    cost = torch.sum(torch.where(valid, torch.clamp(chi2, max=cfg.plane_chi2),
                                 0.0))
    return Hcc, bc, cost


def edge_lut(obs_cam: torch.Tensor, tgt: torch.Tensor, C: int, Pw: int
             ) -> torch.Tensor:
    """[C, Pw] edge index of each (camera, point) pair, E where none.
    A duplicate (camera, point) edge resolves to ONE edge, the one with the
    highest index (the JAX scatter's last write on the CPU); `tgt` is the
    point index, Pw for an edge that takes no part."""
    E = obs_cam.shape[0]
    dev = obs_cam.device
    key = obs_cam.long() * (Pw + 1) + tgt.long()
    lut = torch.full((C * (Pw + 1),), -1, dtype=torch.int64, device=dev)
    lut = lut.scatter_reduce(0, key, torch.arange(E, device=dev),
                             reduce="amax")
    lut = torch.where(lut < 0, E, lut)
    return lut.reshape(C, Pw + 1)[:, :Pw]


def bundle_adjust_coo(prob: BACooProblem,
                      plane_block: Optional[Tuple[torch.Tensor, ...]] = None,
                      *, cam: Tuple[float, ...], cfg: SolverConfig,
                      n_iters1: int = 5, n_iters2: int = 10,
                      damping: float = 1e-3, ftol: float = 1e-4) -> BAResult:
    """Two-phase LM BA on the COO layout; obs_inlier is [E]. `plane_block`
    = (plane_w [C,F,4], meas_c [C,F,4], valid [C,F]) adds fixed-plane
    camera factors to the cost and, on the free cameras, to Hcc / bc."""
    C = prob.cam_pose.shape[0]
    Pw = prob.pt_xyz.shape[0]
    E = prob.obs_cam.shape[0]
    dev = prob.cam_pose.device
    f32 = torch.float32
    cam_idx = prob.obs_cam.long()
    free_cam = (prob.cam_valid & (~prob.cam_fixed)).to(f32)
    obs_ok0 = prob.obs_valid & (prob.obs_pt >= 0) & prob.cam_valid[cam_idx]
    tgt0 = torch.where(obs_ok0, prob.obs_pt.long(), Pw)
    lut = edge_lut(prob.obs_cam, tgt0, C, Pw)                  # [C, Pw]
    # the edge passes, bound once to the fixed part of the problem
    edges = ba_edge.EdgePass(
        ba_edge.EdgeInputs(
            cam_pose=prob.cam_pose, pt_xyz=prob.pt_xyz,
            obs_cam=prob.obs_cam.to(torch.int32),
            obs_pt=torch.clamp(prob.obs_pt, 0, Pw - 1).to(torch.int32),
            obs_uv=prob.obs_uv, obs_ur=prob.obs_ur,
            obs_inv_sigma2=prob.obs_inv_sigma2, free_cam=free_cam),
        tgt0, cam=cam, chi2_mono=cfg.chi2_mono, chi2_stereo=cfg.chi2_stereo)
    eye3 = torch.eye(3, dtype=f32, device=dev)
    eye6 = torch.eye(6, dtype=f32, device=dev)
    pt_free = prob.pt_valid[:, None, None]

    def robust_chi2(cam_pose, pt_xyz, active_f):
        total = edges.chi2_sum(cam_pose, pt_xyz, active_f)
        if plane_block is not None:
            total = total + _plane_terms(cam_pose, *plane_block, cfg)[-1]
        return total

    def gn_iter(cam_pose, pt_xyz, active_f, lam: float):
        # acc_c, acc and y are the binding's buffers: all used up below,
        # before the next gn_iter overwrites them
        acc_c, acc, y = edges.full(cam_pose, pt_xyz, active_f)
        Y = y.T.reshape(E, 6, 3)
        Hcc = acc_c[:, :36].reshape(C, 6, 6)
        bc = -acc_c[:, 36:]
        if plane_block is not None:
            Hp, bp_c, _ = _plane_terms(cam_pose, *plane_block, cfg)
            Hcc = Hcc + Hp * free_cam[:, None, None]
            bc = bc + bp_c * free_cam[:, None]
        Hpp = acc[:, :9].reshape(Pw, 3, 3) + (lam + 1e-6) * eye3
        bp = -acc[:, 9:]
        Hpp_inv = torch.where(pt_free, _inv3x3(Hpp), 0.0)

        # Hcp gathered into the dense [C, Pw] grid
        A = torch.cat([Y, Y.new_zeros((1, 6, 3))])[lut]       # [C, Pw, 6, 3]
        AH = torch.einsum("cpij,pjk->cpik", A, Hpp_inv)
        AH2 = AH.permute(0, 2, 1, 3).reshape(C * 6, Pw * 3)
        A2 = A.permute(0, 2, 1, 3).reshape(C * 6, Pw * 3)
        S = -(AH2 @ A2.T).reshape(C, 6, C, 6).permute(0, 2, 1, 3)
        diag = torch.arange(C, device=dev)
        S[diag, diag] += Hcc
        rhs = bc - (AH2 @ bp.reshape(-1)).reshape(C, 6)
        S = S * free_cam[:, None, None, None] * free_cam[None, :, None, None]
        S[diag, diag] += (eye6 * (1.0 - free_cam)[:, None, None]
                          + eye6 * lam)
        rhs = rhs * free_cam[:, None]
        M = S.permute(0, 2, 1, 3).reshape(C * 6, C * 6)
        delta_c = chol.cholesky_solve(M, rhs.reshape(-1)).reshape(C, 6)
        good = torch.all(torch.isfinite(delta_c))
        delta_c = torch.where(good, delta_c, 0.0)
        t = bp - (A2.T @ delta_c.reshape(-1)).reshape(Pw, 3)
        delta_p = torch.einsum("pij,pj->pi", Hpp_inv, t)
        delta_p = torch.clamp(torch.where(good & prob.pt_valid[:, None],
                                          delta_p, 0.0), -10.0, 10.0)
        return lie.se3_retract(cam_pose, delta_c), pt_xyz + delta_p

    def run_phase(cam_pose, pt_xyz, active, iters):
        """LM accept / reject with the current cost carried; ends after two
        consecutive iterations without a relative improvement of `ftol`
        (rejected steps count)."""
        active_f = active.to(f32)
        lam = np.float32(damping)
        c_cur = np.float32(robust_chi2(cam_pose, pt_xyz, active_f).item())
        it, stall = 0, 0
        while it < iters and stall < 2:
            cp2, ps2 = gn_iter(cam_pose, pt_xyz, active_f, float(lam))
            c_new = np.float32(robust_chi2(cp2, ps2, active_f).item())
            accept = bool(c_new < c_cur) and bool(np.isfinite(c_new))
            if accept:
                cam_pose, pt_xyz = cp2, ps2
                lam = max(lam * np.float32(0.5), np.float32(1e-6))
            else:
                lam = min(lam * np.float32(5.0), np.float32(1e3))
            improved = accept and bool(
                c_cur - c_new >= np.float32(ftol) * max(c_cur,
                                                        np.float32(1e-9)))
            stall = 0 if improved else stall + 1
            if accept:
                c_cur = c_new
            it += 1
        return cam_pose, pt_xyz

    def classify(cam_pose, pt_xyz, thr):
        """Raw chi2 + behind flag for the between-phase outlier gate."""
        _, chi2, behind = edges.chi2_edges(cam_pose, pt_xyz,
                                           obs_ok0.to(f32))
        return obs_ok0 & (chi2 <= thr) & (behind < 0.5), chi2

    thr = torch.where(prob.obs_ur >= 0.0, cfg.chi2_stereo, cfg.chi2_mono)
    cam_pose, pt_xyz = run_phase(prob.cam_pose.contiguous(),
                                 prob.pt_xyz.contiguous(), obs_ok0, n_iters1)
    inlier, _ = classify(cam_pose, pt_xyz, thr)
    cam_pose, pt_xyz = run_phase(cam_pose, pt_xyz, inlier, n_iters2)
    inlier, chi2 = classify(cam_pose, pt_xyz, thr)
    total = torch.sum(torch.where(inlier, chi2, 0.0))
    return BAResult(cam_pose=cam_pose, pt_xyz=pt_xyz, obs_inlier=inlier,
                    chi2=total)
