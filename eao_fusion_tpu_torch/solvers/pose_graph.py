"""Sim3 pose-graph optimization, the essential graph, and the Sim3
refinement of a loop candidate (port of
`eao_fusion_tpu/solvers/pose_graph.py`).

Vertices are keyframe Sim3 poses S_iw (scale 1 for RGBD); an edge carries
a relative measurement S_ji and the residual e = log(S_ji ∘ S_iw ∘ S_jw⁻¹)
∈ R⁷. Gauss-Newton with the per-edge Jacobians at the retraction origin
(the JAX `jacfwd` under `vmap`; here float64 central differences in one
batched call, `tangent_jacobian`, which the tests hold against
`torch.func.jvp`), dense normal
equations over the 7K parameters and `torch.linalg.solve`, as the JAX
function uses `jnp.linalg.solve` (K·7 = 1792 at 256 keyframes, beyond the
Cholesky kernel's 256).

The sums over edges into the vertices' blocks and right-hand sides add in
edge order (`ops/scatter.index_sum`), so a run gives the same bits every
time.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from eao_fusion_tpu_torch.ops import lie
from eao_fusion_tpu_torch.ops.scatter import index_sum

DOF = 7


class PoseGraphProblem(NamedTuple):
    poses: torch.Tensor        # [K, 8] sim3 S_iw
    pose_valid: torch.Tensor   # [K] bool
    fixed: torch.Tensor        # [K] bool
    edge_i: torch.Tensor       # [E] int
    edge_j: torch.Tensor       # [E] int
    edge_meas: torch.Tensor    # [E, 8] measured S_ji
    edge_weight: torch.Tensor  # [E] float32 (0 = disabled)


def _edge_residual(si, sj, meas):
    """e = log(meas ∘ S_iw ∘ S_jw⁻¹)."""
    return lie.sim3_log(lie.sim3_compose(
        meas, lie.sim3_compose(si, lie.sim3_inverse(sj))))


def tangent_jacobian(f: Callable[[torch.Tensor], torch.Tensor],
                     z: torch.Tensor, h: float = 1e-6) -> torch.Tensor:
    """Jacobian of f at z for f acting row by row on z [..., D] (row i of
    the output depends only on row i of the input): [..., out, D] float32,
    by central differences in float64 over the D tangent directions, all
    in one batched call of f (which must keep float64). The step's
    truncation error (~h²) and rounding (~1e-16 / h) are far below
    float32's, so this is the float32 Jacobian that the JAX `jacfwd` gives;
    `torch.func.jvp` gives it too, at ~30 ms of host dispatch per call."""
    D = z.shape[-1]
    step = h * torch.eye(D, dtype=torch.float64, device=z.device).reshape(
        (D,) + (1,) * (z.dim() - 1) + (D,))
    zz = z.double()
    diff = (f(zz + step) - f(zz - step)) / (2.0 * h)        # [D, ..., out]
    return torch.movedim(diff, 0, -1).float()


def optimize_pose_graph(prob: PoseGraphProblem, *, n_iters: int = 20,
                        fix_scale: bool = True,
                        damping: float = 1e-4) -> torch.Tensor:
    """Returns the optimized poses [K, 8]."""
    K = prob.poses.shape[0]
    E = prob.edge_i.shape[0]
    dev = prob.poses.device
    ei, ej = prob.edge_i.long(), prob.edge_j.long()
    w = prob.edge_weight
    free = (prob.pose_valid & (~prob.fixed)).float()
    wi = w * free[ei]
    wj = w * free[ej]
    wij = wi * wj / torch.clamp(w, min=1e-9)
    anchor = torch.eye(DOF, device=dev) * (damping + 1e3 * (1.0 - free))[
        :, None, None]
    diag = torch.arange(K, device=dev)
    keep = torch.arange(DOF, device=dev) < 6          # all but the scale
    z = torch.zeros((E, DOF), dtype=torch.float32, device=dev)
    meas64 = prob.edge_meas.double()
    poses = prob.poses
    for _ in range(n_iters):
        si, sj = poses[ei], poses[ej]
        r = _edge_residual(si, sj, prob.edge_meas)               # [E, 7]
        si64, sj64 = si.double(), sj.double()
        Ji = tangent_jacobian(lambda t: _edge_residual(
            lie.sim3_retract(si64, t), sj64, meas64), z)         # [E, 7, 7]
        Jj = tangent_jacobian(lambda t: _edge_residual(
            si64, lie.sim3_retract(sj64, t), meas64), z)

        def gram(A, wgt, B):
            return torch.einsum("eri,e,erj->eij", A, wgt, B)

        # the blocks [K·K, 7, 7], diagonal and off-diagonal, and b [K, 7]
        H = torch.zeros((K * K, DOF, DOF), dtype=torch.float32, device=dev)
        for rows, blk in ((ei * (K + 1), gram(Ji, wi, Ji)),
                          (ej * (K + 1), gram(Jj, wj, Jj)),
                          (ei * K + ej, gram(Ji, wij, Jj)),
                          (ej * K + ei, gram(Jj, wij, Ji))):
            index_sum(H, rows, blk)
        H = H.reshape(K, K, DOF, DOF)
        H[diag, diag] += anchor
        b = torch.zeros((K, DOF), dtype=torch.float32, device=dev)
        index_sum(b, ei, -torch.einsum("eri,e,er->ei", Ji, wi, r))
        index_sum(b, ej, -torch.einsum("eri,e,er->ei", Jj, wj, r))
        b = b * free[:, None]
        M = H.permute(0, 2, 1, 3).reshape(K * DOF, K * DOF)
        delta = torch.linalg.solve(M, b.reshape(-1)).reshape(K, DOF)
        delta = torch.where(torch.isfinite(delta).all(), delta, 0.0)
        if fix_scale:
            delta = torch.where(keep, delta, 0.0)
        poses = lie.sim3_retract(poses, delta)
    return poses


def sim3_refine(pa: torch.Tensor, pb: torch.Tensor, w: torch.Tensor,
                g0: torch.Tensor, n_iters: int = 10,
                fix_scale: bool = True) -> torch.Tensor:
    """Gauss-Newton refinement of g with pb ≈ g(pa) on weighted 3D pairs
    (the role of `Optimizer::OptimizeSim3`, `src/Optimizer.cc:1437`, with
    3D residuals)."""
    dev = pa.device
    eye7 = torch.eye(DOF, device=dev)
    keep = torch.arange(DOF, device=dev) < (6 if fix_scale else DOF)
    g = g0
    for _ in range(n_iters):
        # at tau = 0 the left retraction moves a point p = g(pa) by
        # d/d(omega, v, sigma) = [-[p]x | I | p]: the Jacobian of the JAX
        # function's jacfwd, in closed form
        p = lie.sim3_apply(g, pa)                                # [N, 3]
        r = ((p - pb) * w[:, None]).reshape(-1)
        eye3 = torch.eye(3, device=dev).expand(p.shape[:1] + (3, 3))
        J = (torch.cat([-lie.so3_hat(p), eye3, p[..., None]], dim=-1)
             * w[:, None, None]).reshape(-1, DOF)                # [3N, 7]
        H = J.T @ J + 1e-6 * eye7
        delta = torch.where(keep, torch.linalg.solve(H, -J.T @ r), 0.0)
        g = lie.sim3_retract(g, torch.where(torch.isfinite(delta).all(),
                                            delta, 0.0))
    return g
