"""Image ops: grayscale, separable Gaussian blur, pyramid construction
and batched window reads (port of `eao_fusion_tpu/ops/image.py`).

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


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """[H,W,3] (float or uint8) -> [H,W] float32 in [0,1]."""
    x = rgb.to(torch.float32)
    if rgb.dtype == torch.uint8:
        x = x / 255.0
    return x @ torch.tensor([0.299, 0.587, 0.114], dtype=torch.float32,
                            device=rgb.device)


def gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: torch.Tensor, sigma: float = 2.0,
                  radius: int = 3) -> torch.Tensor:
    """Separable Gaussian blur with edge replication, the vertical pass
    first. img: [H, W] f32."""
    k = torch.as_tensor(gaussian_kernel1d(sigma, radius), device=img.device)
    x = F.pad(img[None, None], (0, 0, radius, radius), mode="replicate")
    x = F.conv2d(x, k[None, None, :, None])
    x = F.pad(x, (radius, radius, 0, 0), mode="replicate")
    return F.conv2d(x, k[None, None, None, :])[0, 0]


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
