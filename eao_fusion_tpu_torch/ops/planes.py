"""Plane segmentation from organized depth: PEAC-style windowed fitting with
label-propagation merging (port of `eao_fusion_tpu/ops/planes.py`).

The image is tiled into 10x10-px windows; each window's plane comes from
its first and second moments and a closed-form symmetric 3x3 eigensolve.
Compatible neighbouring windows merge into connected components by
alternating min-label sweeps with pointer jumping; each component is refit
from its summed moments, and the largest components become the frame's
planes, each with a strided sample of supporting points as its boundary.

What the JAX function does with 0/1 indicator matmuls only for the TPU's
sake is written as what it computes: the window sums are a reshape-sum,
the pointer jump is the integer gather `lbl[lbl]` (exact), and the
component refit sums the [G, 13] moments by label in window order
(`ops/scatter.index_sum`: the same bits in every run, on the card too).
The moments are sums of z² ≈ 16 m², and `cov = pp/n − μμᵀ` cancels: in
float32 (the JAX package's) the plane of a small, far component moves by
centimetres with the order of its sums, on the card against the CPU too.
So the moments, the window fits and the component refit run in float64,
and the coefficients come out in float32.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from eao_fusion_tpu_torch.config import CameraConfig, PlaneConfig
from eao_fusion_tpu_torch.ops import lie
from eao_fusion_tpu_torch.ops.scatter import index_sum
from eao_fusion_tpu_torch.ops.topk import top_k_stable
from eao_fusion_tpu_torch.types import FramePlanes

# boundary samples are taken on every BOUNDARY_STRIDE-th pixel, a static
# stand-in for the reference's 5 cm voxel filter
BOUNDARY_STRIDE = 8


def eigh3_smallest(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Smallest eigenvalue and its unit eigenvector of symmetric [..., 3, 3]
    matrices: trigonometric eigenvalues, eigenvector from the largest cross
    product of two rows of (A − λI); any unit vector for (near-)isotropic
    matrices."""
    a00, a11, a22 = A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]
    a01, a02, a12 = A[..., 0, 1], A[..., 0, 2], A[..., 1, 2]
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = (b00 * b00 + b11 * b11 + b22 * b22
          + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12))
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-20))
    ip = 1.0 / p
    c00, c11, c22 = b00 * ip, b11 * ip, b22 * ip
    c01, c02, c12 = a01 * ip, a02 * ip, a12 * ip
    detB = (c00 * (c11 * c22 - c12 * c12)
            - c01 * (c01 * c22 - c12 * c02)
            + c02 * (c01 * c12 - c11 * c02))
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam0 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)

    r0 = torch.stack([a00 - lam0, a01, a02], dim=-1)
    r1 = torch.stack([a01, a11 - lam0, a12], dim=-1)
    r2 = torch.stack([a02, a12, a22 - lam0], dim=-1)
    vs = torch.stack([lie.cross(r0, r1), lie.cross(r0, r2),
                      lie.cross(r1, r2)], dim=-2)               # [..., 3, 3]
    norms = torch.sum(vs * vs, dim=-1)                          # [..., 3]
    best = torch.argmax(norms, dim=-1)
    v = torch.gather(vs, -2, best[..., None, None].expand(
        best.shape + (1, 3)))[..., 0, :]
    degenerate = torch.amax(norms, dim=-1) < 1e-18
    v = torch.where(degenerate[..., None], v.new_tensor([0.0, 0.0, 1.0]), v)
    v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                        min=1e-12)
    return lam0, v


def backproject_depth(depth: torch.Tensor, cam: CameraConfig
                      ) -> torch.Tensor:
    """[H, W] depth -> [H, W, 3] camera-frame organized cloud."""
    return torch.stack(backproject_depth_channels(depth, cam), dim=-1)


def backproject_depth_channels(depth: torch.Tensor, cam: CameraConfig):
    """[H, W] depth -> three [H, W] camera-frame channel images (x, y, z),
    at pixel centres."""
    H, W = depth.shape
    dev = depth.device
    us = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5)[None, :]
    vs = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5)[:, None]
    x = (us - cam.cx) / cam.fx * depth
    y = (vs - cam.cy) / cam.fy * depth
    return x, y, depth


def _window_moments(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
                    valid: torch.Tensor, win: int):
    """Per-window count n [G], sum s [G, 3] and outer-product sum
    pp [G, 3, 3] over the valid pixels, G = (H//win)·(W//win) row-major."""
    H, W = x.shape
    gh, gw = H // win, W // win
    G = gh * gw
    Hc, Wc = gh * win, gw * win
    m = valid[:Hc, :Wc].double()
    xm = x[:Hc, :Wc].double() * m
    ym = y[:Hc, :Wc].double() * m
    zm = z[:Hc, :Wc].double() * m
    chans = torch.stack([m, xm, ym, zm, xm * xm, ym * ym, zm * zm,
                         xm * ym, xm * zm, ym * zm])            # [10, Hc, Wc]
    w = chans.reshape(10, gh, win, gw, win).sum(dim=(2, 4)).reshape(10, G)
    n = w[0]
    s = torch.stack([w[1], w[2], w[3]], dim=-1)
    pp = torch.stack([
        torch.stack([w[4], w[7], w[8]], dim=-1),
        torch.stack([w[7], w[5], w[9]], dim=-1),
        torch.stack([w[8], w[9], w[6]], dim=-1)], dim=-2)
    return n, s, pp, gh, gw


def _fit_from_moments(n, s, pp):
    """Plane fit from (count, sum, sum-outer): normal, d >= 0 (normal toward
    the camera), mse and mean."""
    nf = torch.clamp(n.to(s.dtype), min=1.0)
    mu = s / nf[:, None]
    cov = pp / nf[:, None, None] - mu[:, :, None] * mu[:, None, :]
    mse, normal = eigh3_smallest(cov)
    d = -torch.sum(normal * mu, dim=-1)
    flip = d < 0
    normal = torch.where(flip[:, None], -normal, normal)
    d = torch.where(flip, -d, d)
    return normal, d, torch.clamp(mse, min=0.0), mu


def segment_planes(depth: torch.Tensor, *, cam: CameraConfig,
                   cfg: PlaneConfig) -> FramePlanes:
    """[H, W] metric depth -> the frame's planes (capacity
    `max_planes_per_frame`), largest support first."""
    H, W = depth.shape
    dev = depth.device
    win = cfg.window
    cx, cy, cz = backproject_depth_channels(depth, cam)
    valid = (depth > 0.1) & (depth < 10.0)

    n, s, pp, gh, gw = _window_moments(cx, cy, cz, valid, win)
    normal, d, mse, mu = _fit_from_moments(n, s, pp)
    depth_w = torch.clamp(mu[:, 2], min=0.3)
    # depth-adaptive planarity gate (depth noise grows ~ z^2)
    mse_ok = mse < cfg.mse_max * depth_w * depth_w
    planar = (n >= int(0.8 * win * win)) & mse_ok
    G = gh * gw

    # ---- connected components over compatible neighbours ---------------
    nrm = normal.reshape(gh, gw, 3)
    muv = mu.reshape(gh, gw, 3)
    pl = planar.reshape(gh, gw)
    ys = torch.arange(gh, device=dev)[:, None]
    xs = torch.arange(gw, device=dev)[None, :]
    offs = [(0, 1), (0, -1), (1, 0), (-1, 0)]

    def compatible(dy, dx):
        """Whether each window may merge with its neighbour at (dy, dx):
        both planar, inside the grid, normals and offsets agreeing."""
        nrm2 = torch.roll(nrm, (-dy, -dx), dims=(0, 1))
        mu2 = torch.roll(muv, (-dy, -dx), dims=(0, 1))
        pl2 = torch.roll(pl, (-dy, -dx), dims=(0, 1))
        inb = ((ys + dy >= 0) & (ys + dy < gh) & (xs + dx >= 0)
               & (xs + dx < gw))
        ang = torch.sum(nrm * nrm2, dim=-1) > cfg.merge_normal_dot
        dist = torch.abs(torch.sum(nrm * (mu2 - muv), dim=-1)) \
            < cfg.merge_dist
        return pl & pl2 & inb & ang & dist

    comp = [compatible(dy, dx) for dy, dx in offs]
    iota_g = torch.arange(G, dtype=torch.int64, device=dev)
    labels = torch.where(planar, iota_g, G)
    sentinel = torch.full((gh, gw), G, dtype=torch.int64, device=dev)
    for _ in range(cfg.n_merge_sweeps):
        mn = labels.reshape(gh, gw)
        for k, (dy, dx) in enumerate(offs):
            nb = torch.roll(mn, (-dy, -dx), dims=(0, 1))
            mn = torch.minimum(mn, torch.where(comp[k], nb, sentinel))
        labels = mn.reshape(G)
        for _ in range(2):          # pointer jumping (G = invalid sink)
            labels = torch.where(labels >= G, G,
                                 labels[torch.clamp(labels, max=G - 1)])
        labels = torch.where(planar, labels, G)

    # ---- per-component refit from summed moments ------------------------
    mom = torch.cat([n[:, None], s, pp.reshape(G, 9)], dim=1)     # [G, 13]
    seg = index_sum(torch.zeros((G + 1, 13), dtype=torch.float64,
                                device=dev), labels, mom)[:G]
    seg_n = seg[:, 0].float()
    seg_normal, seg_d, _, _ = _fit_from_moments(
        seg[:, 0], seg[:, 1:4], seg[:, 4:13].reshape(G, 3, 3))
    seg_normal, seg_d = seg_normal.float(), seg_d.float()
    ok = seg_n >= cfg.min_support_px

    # the largest components by support
    Pk = cfg.max_planes_per_frame
    score = torch.where(ok, seg_n, 0.0)
    top_val, top_idx = top_k_stable(score, Pk)
    p_valid = top_val > 0.0
    p_coeff = torch.cat([seg_normal[top_idx], seg_d[top_idx][:, None]],
                        dim=-1)
    p_count = seg_n[top_idx].to(torch.int32)

    # ---- boundary sampling on a strided pixel grid -----------------------
    st = BOUNDARY_STRIDE
    pts = torch.stack([cx[::st, ::st].reshape(-1), cy[::st, ::st].reshape(-1),
                       cz[::st, ::st].reshape(-1)], dim=-1)       # [S, 3]
    pts_ok = valid[::st, ::st].reshape(-1)
    dist = torch.abs(pts @ p_coeff[:, :3].T + p_coeff[None, :, 3])  # [S, Pk]
    close = (dist < 0.03) & pts_ok[:, None] & p_valid[None, :]
    B = cfg.max_boundary_points
    # up to B supporting samples per plane, nearest first (the JAX function
    # uses `approx_max_k`, which is exact on the CPU; rejected slots tie)
    sel_score = torch.where(close, -dist, -1e9)
    top_b, idx_b = top_k_stable(sel_score.T, B)                 # [Pk, B]
    return FramePlanes(coeffs=p_coeff, n_inliers=p_count,
                       valid=p_valid & (p_count > 0),
                       boundary=pts[idx_b], boundary_valid=top_b > -1e8)
