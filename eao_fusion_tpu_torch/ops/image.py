"""Image ops: Gaussian kernel, pyramid construction and batched window
reads (port of `eao_fusion_tpu/ops/image.py`).

`jax.image.resize(..., "bilinear")` antialiases when it downscales
(`image.py:69`); the matching PyTorch call is `F.interpolate` with
`mode="bilinear", antialias=True, align_corners=False` (without
`antialias` a 480x640 -> 400x533 level is off by up to 0.28).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def pyramid_shapes(height: int, width: int, n_levels: int,
                   scale_factor: float) -> List[Tuple[int, int]]:
    # clamp: levels must stay larger than the descriptor patch (41 px)
    return [(max(int(round(height / scale_factor ** l)), 48),
             max(int(round(width / scale_factor ** l)), 48))
            for l in range(n_levels)]


def build_pyramid(img: torch.Tensor, n_levels: int, scale_factor: float
                  ) -> List[torch.Tensor]:
    """List of [H_l, W_l] images, level 0 = input; each level is resized
    from the previous one (cascaded, like the reference's cv::resize)."""
    h, w = img.shape
    shapes = pyramid_shapes(h, w, n_levels, scale_factor)
    out = [img]
    for l in range(1, n_levels):
        out.append(F.interpolate(out[-1][None, None], size=shapes[l],
                                 mode="bilinear", antialias=True,
                                 align_corners=False)[0, 0])
    return out


def windows(img: torch.Tensor, r0: torch.Tensor, c0: torch.Tensor,
            h: int, w: int) -> torch.Tensor:
    """[B, h, w] windows of img [H, W] with top-left corners (r0, c0) [B],
    each start handled as `lax.dynamic_slice` handles it in the JAX
    package: a negative start counts from the end, then the start is
    clamped so that the window fits (torch indexing would do neither)."""
    def start(s, size, n):
        s = s.long()
        s = torch.where(s < 0, s + size, s)
        return torch.clamp(s, 0, size - n)

    rows = start(r0, img.shape[0], h)[:, None, None] + torch.arange(
        h, device=img.device)[None, :, None]
    cols = start(c0, img.shape[1], w)[:, None, None] + torch.arange(
        w, device=img.device)[None, None, :]
    return img[rows, cols]
