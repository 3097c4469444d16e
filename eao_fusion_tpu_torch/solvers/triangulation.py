"""Two-view triangulation with ORB-SLAM2's acceptance checks (port of
`eao_fusion_tpu/solvers/triangulation.py`).

The triangulation core of `LocalMapping::CreateNewMapPoints`
(`src/LocalMapping.cc:211-456`) and `Initializer::Triangulate`: a DLT for
every candidate pair at once, one batched 4x4 SVD, with the parallax,
positive-depth, reprojection and finiteness gates as masks. The batched SVD
is `torch.linalg.svd`, a library call for what the JAX package also leaves
to XLA outside any Pallas kernel; the null vector's sign cancels in the
division by its last entry.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from eao_fusion_tpu_torch.ops import lie


def triangulate_dlt(tcw1: torch.Tensor, tcw2: torch.Tensor,
                    xn1: torch.Tensor, xn2: torch.Tensor) -> torch.Tensor:
    """DLT triangulation. xn1, xn2: [..., N, 2] normalized image coords
    (K⁻¹ u); tcw1, tcw2: [..., 7], broadcast over the leading axes. Returns
    world points [..., N, 3]."""
    P1 = lie.se3_matrix(tcw1)[..., None, :3, :]              # [..., 1, 3, 4]
    P2 = lie.se3_matrix(tcw2)[..., None, :3, :]
    a, b = xn1[..., None], xn2[..., None]                     # [..., N, 2, 1]
    A = torch.cat(torch.broadcast_tensors(
        a[..., 0:1, :] * P1[..., 2:3, :] - P1[..., 0:1, :],
        a[..., 1:2, :] * P1[..., 2:3, :] - P1[..., 1:2, :],
        b[..., 0:1, :] * P2[..., 2:3, :] - P2[..., 0:1, :],
        b[..., 1:2, :] * P2[..., 2:3, :] - P2[..., 1:2, :]),
        dim=-2)                                               # [..., N, 4, 4]
    X = torch.linalg.svd(A)[2][..., -1, :]
    w = X[..., 3:4]
    return X[..., :3] / torch.where(torch.abs(w) < 1e-12, 1e-12, w)


class TriangulationResult(NamedTuple):
    xyz: torch.Tensor     # [N, 3] world points
    ok: torch.Tensor      # [N] acceptance mask


def triangulate_checked(tcw1: torch.Tensor, tcw2: torch.Tensor,
                        uv1: torch.Tensor, uv2: torch.Tensor,
                        valid: torch.Tensor, inv_sigma2_1: torch.Tensor,
                        inv_sigma2_2: torch.Tensor, *,
                        cam: Tuple[float, float, float, float],
                        min_parallax_cos: float = 0.9998,
                        chi2: float = 5.991) -> TriangulationResult:
    """Triangulate matched pixel pairs with the reference's gates."""
    fx, fy, cx, cy = cam
    xn1 = torch.stack([(uv1[:, 0] - cx) / fx, (uv1[:, 1] - cy) / fy], -1)
    xn2 = torch.stack([(uv2[:, 0] - cx) / fx, (uv2[:, 1] - cy) / fy], -1)
    xw = triangulate_dlt(tcw1, tcw2, xn1, xn2)

    xc1 = lie.se3_apply(tcw1, xw)
    xc2 = lie.se3_apply(tcw2, xw)
    pos_depth = (xc1[:, 2] > 0.02) & (xc2[:, 2] > 0.02)

    # parallax between the viewing rays
    r1 = xw - lie.se3_inverse(tcw1)[4:7]
    r2 = xw - lie.se3_inverse(tcw2)[4:7]
    cosp = torch.sum(r1 * r2, -1) / torch.clamp(
        torch.linalg.norm(r1, dim=-1) * torch.linalg.norm(r2, dim=-1),
        min=1e-9)
    parallax_ok = cosp < min_parallax_cos

    e1 = lie.project(cam, xc1) - uv1
    e2 = lie.project(cam, xc2) - uv2
    rep_ok = ((torch.sum(e1 * e1, -1) * inv_sigma2_1 < chi2)
              & (torch.sum(e2 * e2, -1) * inv_sigma2_2 < chi2))

    ok = (valid & pos_depth & parallax_ok & rep_ok
          & torch.all(torch.isfinite(xw), dim=-1))
    return TriangulationResult(xyz=xw, ok=ok)
