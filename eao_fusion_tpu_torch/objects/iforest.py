"""Isolation forest over batches of point sets (port of
`eao_fusion_tpu/objects/iforest.py`).

Re-design of the reference's header-only iForest
(`include/isolation_forest.h`: recursive `IsolationTree::Node::Build` at
:165, scoring at :398) with the pointer tree replaced by level-synchronous
arrays: each of T trees is a complete binary tree of depth D, its nodes
numbered as a heap (level l holds nodes 2^l - 1 .. 2^(l+1) - 2). Building
walks the sample down one level at a time (scatter-min/max per node for
the split range); scoring routes every point through every tree,
accumulating the path-length estimate h(x) = depth-to-isolation +
c(leaf size).

The random draws are split from the arithmetic: `draw_forest` makes them
from a `torch.Generator`, and `anomaly_scores` is deterministic given them,
so a test can hand both packages the same draws. The JAX package walks
each level with one-hot matmuls (a TPU layout); here the per-node lookups
are gathers and scatters.

Usage gates mirror `Object_Map::IsolationForestDeleteOutliers`
(`src/Object.cc:1248-1348`): >= 30 points, 50 trees, sample 64, anomaly
threshold 0.6 (0.65 for one class)."""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

EULER_GAMMA = 0.5772156649
DEPTH = 8
SAMPLE = 64


class ForestDraws(NamedTuple):
    """The randoms of one forest per point set, with leading batch dims
    [...]: which points each tree samples, and per heap node the split
    dimension and the split's fraction of the node's range."""
    samp_idx: torch.Tensor   # [..., T, S] int64 sampled point indices
    dims: torch.Tensor       # [..., T, 2^D - 1] int64 split dimension (0..2)
    frac: torch.Tensor       # [..., T, 2^D - 1] float32 in [0, 1)


def _avg_path(n: torch.Tensor) -> torch.Tensor:
    """c(n): average BST unsuccessful-search path length."""
    n = torch.clamp(n.to(torch.float32), min=2.0)
    return 2.0 * (torch.log(n - 1.0) + EULER_GAMMA) - 2.0 * (n - 1.0) / n


def draw_forest(generator: torch.Generator, valid: torch.Tensor,
                n_trees: int = 50, depth: int = DEPTH,
                sample: int = SAMPLE) -> ForestDraws:
    """Draws for one forest per row of valid [..., M]: each tree samples
    `sample` indices with replacement among the row's valid points (all
    points where none is valid; their scores are 0 anyway)."""
    batch, M = valid.shape[:-1], valid.shape[-1]
    dev = valid.device
    w = valid.reshape(-1, M).to(torch.float32)
    w = torch.where(w.sum(dim=1, keepdim=True) > 0, w, 1.0)
    # inverse-CDF sampling (as `jax.random.choice` with p does), which
    # needs no host check of the weights; the clamp keeps a draw that
    # rounds up to the total on the last drawable point
    cdf = torch.cumsum(w, dim=1)
    u = torch.rand((w.shape[0], n_trees * sample), generator=generator,
                   device=dev) * cdf[:, -1:]
    last = M - 1 - torch.argmax((w.flip(-1) > 0).to(torch.int32), dim=-1,
                                keepdim=True)
    samp = torch.minimum(torch.searchsorted(cdf, u, right=True), last)
    n_nodes = (1 << depth) - 1
    shape = batch + (n_trees, n_nodes)
    dims = torch.randint(0, 3, shape, generator=generator, device=dev)
    frac = torch.rand(shape, generator=generator, device=dev)
    return ForestDraws(samp.reshape(batch + (n_trees, sample)), dims, frac)


def anomaly_scores(pts: torch.Tensor, valid: torch.Tensor,
                   draws: ForestDraws) -> torch.Tensor:
    """pts [..., M, 3], valid [..., M] -> scores [..., M] in [0, 1]
    (0.5 = typical). Invalid points get score 0 (never culled)."""
    batch, M = valid.shape[:-1], valid.shape[-1]
    T, S = draws.samp_idx.shape[-2:]
    depth = (draws.dims.shape[-1] + 1).bit_length() - 1
    dev = pts.device
    B = math.prod(batch)
    pts = pts.reshape(B, 1, M, 3).expand(B, T, M, 3)
    samp = draws.samp_idx.reshape(B, T, S)
    dims = draws.dims.reshape(B, T, -1)
    frac = draws.frac.reshape(B, T, -1)
    spts = pts.gather(2, samp[..., None].expand(B, T, S, 3))  # [B, T, S, 3]

    # ---- build: per level, the split of every node from its samples ----
    node = torch.zeros((B, T, S), dtype=torch.int64, device=dev)
    split_lv, dim_lv, cnt_lv = [], [], []
    for lvl in range(depth):
        w, off = 1 << lvl, (1 << lvl) - 1
        d_l = dims[..., off:off + w]                          # [B, T, w]
        idx3 = node[..., None].expand(B, T, S, 3)
        mn = torch.full((B, T, w, 3), 1e9, device=dev).scatter_reduce(
            2, idx3, spts, "amin")
        mx = torch.full((B, T, w, 3), -1e9, device=dev).scatter_reduce(
            2, idx3, spts, "amax")
        cnt = torch.zeros((B, T, w), device=dev).scatter_add_(
            2, node, torch.ones_like(spts[..., 0]))
        lo = mn.gather(3, d_l[..., None])[..., 0]
        hi = mx.gather(3, d_l[..., None])[..., 0]
        split = lo + frac[..., off:off + w] * torch.clamp(hi - lo, min=1e-9)
        v = spts.gather(3, d_l.gather(2, node)[..., None])[..., 0]
        node = node * 2 + (v > split.gather(2, node)).to(torch.int64)
        split_lv.append(split)
        dim_lv.append(d_l)
        cnt_lv.append(cnt)

    # ---- scoring: route every point through every tree ------------------
    node = torch.zeros((B, T, M), dtype=torch.int64, device=dev)
    h = torch.zeros((B, T, M), device=dev)
    alive = torch.ones((B, T, M), dtype=torch.bool, device=dev)
    last_cnt = torch.full((B, T, M), float(S), device=dev)
    for lvl in range(depth):
        c_here = cnt_lv[lvl].gather(2, node)
        isolated_now = alive & (c_here <= 1.0)
        alive2 = alive & (c_here > 1.0)
        h = h + alive2.to(torch.float32)
        last_cnt = torch.where(isolated_now, 1.0,
                               torch.where(alive2, c_here, last_cnt))
        v = pts.gather(3, dim_lv[lvl].gather(2, node)[..., None])[..., 0]
        node = node * 2 + (v > split_lv[lvl].gather(2, node)).to(torch.int64)
        alive = alive2
    # terminal correction for points still in populated nodes
    h = h + torch.where(last_cnt > 1.0, _avg_path(last_cnt), 0.0)
    # c(S) in float32, as the JAX package computes it
    n = np.float32(max(S, 2))
    c_s = float(np.float32(2.0) * (np.log(n - 1) + np.float32(EULER_GAMMA))
                - np.float32(2.0) * (n - 1) / n)
    score = torch.exp2(-h.mean(dim=1) / c_s)
    return torch.where(valid.reshape(B, M), score, 0.0).reshape(batch + (M,))


def cull_mask(pts: torch.Tensor, valid: torch.Tensor, draws: ForestDraws,
              threshold, min_points: int = 30) -> torch.Tensor:
    """bool [..., M]: True for members to REMOVE. No-op below min_points
    (`src/Object.cc:1265`). `threshold` is a float or a tensor [...]."""
    s = anomaly_scores(pts, valid, draws)
    if isinstance(threshold, torch.Tensor):
        threshold = threshold[..., None]
    enough = valid.sum(dim=-1, keepdim=True) >= min_points
    return valid & (s > threshold) & enough
