"""FAST-9/16 corner detection on whole images (port of
`eao_fusion_tpu/ops/fast.py`).

The segment test over the 16 arc starts is a sliding minimum over the
circle-neighbour margins, the score is the largest threshold that still
passes, NMS is a 3x3 max-pool compare, and keypoints are picked per cell
and then globally with `top_k_stable` (lower index wins ties, as
`lax.top_k` does).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from eao_fusion_tpu_torch.ops.topk import top_k_stable

# Bresenham circle of radius 3, OpenCV's FAST-16 ordering, as (dy, dx).
CIRCLE_OFFSETS = np.array([
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
], dtype=np.int32)

ARC_LEN = 9  # FAST-9: 9 contiguous circle pixels all brighter / darker


def _shifted_stack(img: torch.Tensor) -> torch.Tensor:
    """[16, H, W] stack of the circle-neighbour images (edge-padded)."""
    p = 3
    h, w = img.shape
    padded = F.pad(img[None, None], (p, p, p, p), mode="replicate")[0, 0]
    return torch.stack([padded[p + int(dy):p + int(dy) + h,
                               p + int(dx):p + int(dx) + w]
                        for dy, dx in CIRCLE_OFFSETS], dim=0)


def _arc_best(margin: torch.Tensor) -> torch.Tensor:
    """max over the 16 arc starts of the min margin within the 9-arc, as a
    doubling sliding minimum (min and max are exact, so the result equals
    the reference's unrolled loop bit for bit)."""
    m2 = torch.cat([margin, margin[:ARC_LEN - 1]], dim=0)   # [24, H, W]
    w2 = torch.minimum(m2[:-1], m2[1:])                      # windows of 2
    w4 = torch.minimum(w2[:-2], w2[2:])                      # of 4
    w8 = torch.minimum(w4[:-4], w4[4:])                      # of 8
    w9 = torch.minimum(w8[:16], m2[8:24])                    # of 9
    return torch.amax(w9, dim=0)


def fast_score(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """FAST-9 corner score map [H, W]; 0 where not a corner."""
    c = _shifted_stack(img)
    center = img[None]
    score = torch.maximum(_arc_best(c - center), _arc_best(center - c))
    return torch.where(score >= threshold, score, 0.0)


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """Keep local maxima of each 3x3 neighbourhood."""
    m = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where((score >= m) & (score > 0.0), score, 0.0)


def select_keypoints(score: torch.Tensor, cell: int, top_per_cell: int,
                     n_out: int, border: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spatially distributed top-k: `top_per_cell` best responses per
    `cell`-px tile, then the global best `n_out`. Returns (yx [n_out, 2]
    int32, score [n_out]); empty slots score 0."""
    h, w = score.shape
    dev = score.device
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    ok = ((ys >= border) & (ys < h - border)
          & (xs >= border) & (xs < w - border))
    s = torch.where(ok, score, 0.0)

    gh, gw = h // cell, w // cell
    tiles = s[:gh * cell, :gw * cell].reshape(gh, cell, gw, cell)
    tiles = tiles.permute(0, 2, 1, 3).reshape(gh * gw, cell * cell)
    vals, idx = top_k_stable(tiles, top_per_cell)            # [G, top]
    g = torch.arange(gh * gw, device=dev)[:, None]
    yy = ((g // gw) * cell + idx // cell).reshape(-1)
    xx = ((g % gw) * cell + idx % cell).reshape(-1)
    vals = vals.reshape(-1)
    k = min(n_out, vals.shape[0])
    best, bi = top_k_stable(vals, k)
    out_y = yy[bi].to(torch.int32)
    out_x = xx[bi].to(torch.int32)
    if k < n_out:
        pad = n_out - k
        best = torch.cat([best, best.new_zeros(pad)])
        out_y = torch.cat([out_y, out_y.new_zeros(pad)])
        out_x = torch.cat([out_x, out_x.new_zeros(pad)])
    return torch.stack([out_y, out_x], dim=-1), best


def detect_level(img: torch.Tensor, ini_th: float, min_th: float, cell: int,
                 top_per_cell: int, n_out: int, border: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pyramid level with threshold fallback: score with the low
    threshold, and lift corners above the high one by 1000 so that strong
    corners win cell slots (the reference's 20 -> 7 retry in one pass)."""
    s = nms3x3(fast_score(img, float(min_th)))
    s = torch.where(s >= ini_th, s + 1000.0, s)
    return select_keypoints(s, cell, top_per_cell, n_out, border)
