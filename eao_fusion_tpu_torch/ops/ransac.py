"""Batched-hypothesis RANSAC: Horn's closed-form SE3 / Sim3 alignment and
2D-3D PnP (port of `eao_fusion_tpu/ops/ransac.py`).

All hypotheses are drawn and scored at once (the JAX `vmap` becomes a batch
axis) and the one with most inliers wins; the 3D-3D solver refits on its
inliers. The draws are split from the solvers: `draw_hypotheses` takes a
`torch.Generator` and returns the index tensor, uniform over the valid
rows with replacement, as `jax.random.choice(p=valid / Σ valid)` draws it;
`ransac_align` and `ransac_pnp` are deterministic given those indices, so
tests hand both packages the JAX draws. Torch cannot reproduce the JAX
random stream itself.

The batched 3x3 and 12x12 SVDs are `torch.linalg.svd`, a library call for
an operation the JAX package also leaves to XLA outside any Pallas kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from eao_fusion_tpu_torch.ops import lie


def draw_hypotheses(valid: torch.Tensor, n_hypotheses: int, k: int,
                    generator: torch.Generator) -> torch.Tensor:
    """[n_hypotheses, k] int64 row indices, each uniform over the rows where
    `valid` holds, with replacement (inverse CDF of valid / Σ valid). With
    no valid row every index is the last row; the solvers then find no
    inlier."""
    p = valid.float()
    cdf = torch.cumsum(p, 0)
    u = torch.rand((n_hypotheses, k), generator=generator,
                   device=valid.device) * cdf[-1]
    idx = torch.searchsorted(cdf, u.reshape(-1), right=True)
    return torch.clamp(idx, max=valid.shape[0] - 1).reshape(n_hypotheses, k)


def horn_align(pa: torch.Tensor, pb: torch.Tensor, w: torch.Tensor,
               with_scale: bool = False) -> torch.Tensor:
    """Weighted closed-form alignment pb ≈ s R pa + t, batched over leading
    axes: pa, pb [..., N, 3], w [..., N]. Returns sim3 [..., 8] (s = 1
    unless with_scale). Horn's method via the SVD of the weighted
    covariance."""
    wn = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    ca = torch.sum(pa * wn[..., None], dim=-2)
    cb = torch.sum(pb * wn[..., None], dim=-2)
    A = pa - ca[..., None, :]
    B = pb - cb[..., None, :]
    cov = torch.einsum("...n,...ni,...nj->...ij", wn, B, A)
    U, D, Vt = torch.linalg.svd(cov)
    sgn = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt))
    dS = torch.stack([torch.ones_like(sgn), torch.ones_like(sgn), sgn], -1)
    R = (U * dS[..., None, :]) @ Vt
    if with_scale:
        var_a = torch.sum(wn * torch.sum(A * A, dim=-1), dim=-1)
        s = torch.sum(D * dS, dim=-1) / torch.clamp(var_a, min=1e-12)
    else:
        s = torch.ones(cov.shape[:-2], dtype=cov.dtype, device=cov.device)
    t = cb - s[..., None] * (R @ ca[..., :, None])[..., 0]
    q = lie.rotmat_to_quat(R)
    return torch.cat([q, t, s[..., None]], dim=-1)


def dlt_pnp(pw: torch.Tensor, xn: torch.Tensor) -> torch.Tensor:
    """6-point DLT pose, batched: world points pw [..., 6, 3], normalized
    image coordinates xn [..., 6, 2] (K⁻¹ u). Returns Tcw [..., 7]."""
    X, Y, Z = pw[..., 0], pw[..., 1], pw[..., 2]
    u, v = xn[..., 0], xn[..., 1]
    one = torch.ones_like(X)
    zero = torch.zeros_like(X)
    r1 = torch.stack([X, Y, Z, one, zero, zero, zero, zero,
                      -u * X, -u * Y, -u * Z, -u], dim=-1)
    r2 = torch.stack([zero, zero, zero, zero, X, Y, Z, one,
                      -v * X, -v * Y, -v * Z, -v], dim=-1)
    A = torch.cat([r1, r2], dim=-2)                          # [..., 12, 12]
    Vt = torch.linalg.svd(A)[2]
    P = Vt[..., -1, :].reshape(Vt.shape[:-2] + (3, 4))
    # resolve the global sign of P so that det(M) > 0 (M = s·R, s > 0)
    sgn = torch.where(torch.linalg.det(P[..., :3]) < 0, -1.0, 1.0)
    P = sgn[..., None, None] * P
    U, D, Vt2 = torch.linalg.svd(P[..., :3])
    d = torch.sign(torch.linalg.det(U @ Vt2))
    dS = torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1)
    R = (U * dS[..., None, :]) @ Vt2
    s = torch.clamp(D.mean(-1), min=1e-12)
    t = P[..., 3] / s[..., None]
    return lie.se3_from_Rt(R, t)


class PnPResult(NamedTuple):
    pose: torch.Tensor        # [7] Tcw
    inliers: torch.Tensor     # [N] bool
    n_inliers: torch.Tensor   # [] int32


class RansacResult(NamedTuple):
    transform: torch.Tensor   # [8] sim3 (pb ≈ s R pa + t)
    inliers: torch.Tensor     # [N] bool
    n_inliers: torch.Tensor   # [] int32


def _count(inl: torch.Tensor) -> torch.Tensor:
    return inl.sum(-1).to(torch.int32)


def ransac_pnp(pw: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor,
               idx: torch.Tensor, *, cam: Tuple[float, float, float, float],
               reproj_th: float = 4.0) -> PnPResult:
    """2D-3D pose RANSAC: world points pw [N, 3] against pixels uv [N, 2],
    one DLT hypothesis per row of idx [H, 6] (`draw_hypotheses(valid, 192,
    6, g)` as the JAX function draws them)."""
    fx, fy, cx, cy = cam
    xn = torch.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy], dim=-1)

    def inliers(pose):
        xc = lie.se3_apply(pose[..., None, :], pw)
        err = torch.linalg.norm(lie.project(cam, xc) - uv, dim=-1)
        return (err < reproj_th) & (xc[..., 2] > 0.05) & valid

    poses = dlt_pnp(pw[idx], xn[idx])                         # [H, 7]
    best = torch.argmax(_count(inliers(poses)))
    pose = poses[best]
    inl = inliers(pose)
    return PnPResult(pose=pose, inliers=inl, n_inliers=_count(inl))


def ransac_align(pa: torch.Tensor, pb: torch.Tensor, valid: torch.Tensor,
                 idx: torch.Tensor, *, inlier_th: float = 0.10,
                 with_scale: bool = False) -> RansacResult:
    """3D-3D RANSAC: Horn on each minimal triple of idx [H, 3]
    (`draw_hypotheses(valid, 128, 3, g)` as the JAX function draws them),
    the hypothesis with most 3D-distance inliers, refit on its inliers."""
    def inliers(g):
        err = torch.linalg.norm(lie.sim3_apply(g[..., None, :], pa) - pb,
                                dim=-1)
        return (err < inlier_th) & valid

    ones = torch.ones(idx.shape, dtype=pa.dtype, device=pa.device)
    gs = horn_align(pa[idx], pb[idx], ones, with_scale)      # [H, 8]
    best = torch.argmax(_count(inliers(gs)))
    inl = inliers(gs[best])
    g = horn_align(pa, pb, inl.to(pa.dtype), with_scale)
    inl = inliers(g)
    return RansacResult(transform=g, inliers=inl, n_inliers=_count(inl))
