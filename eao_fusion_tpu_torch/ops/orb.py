"""Oriented BRIEF descriptors (port of `eao_fusion_tpu/ops/orb.py`):
intensity-centroid orientation and rotated binary tests, batched over
keypoints.

The sampling pattern is the JAX package's own (`orb.py:33-41`): 256 point
pairs drawn from N(0, (31/5)^2) with numpy seed 42, rounded and clipped to
±13 — regenerated here bit for bit, so descriptors from both packages
match each other.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from eao_fusion_tpu_torch.ops.image import gaussian_kernel1d

PATCH_HALF = 22          # rotated test points (±13·√2≈±19) + blur support ±3
PATCH = 2 * PATCH_HALF + 1
ORI_RADIUS = 15          # intensity-centroid circle radius
N_BITS = 256
BORDER = PATCH_HALF + 1  # detection border margin per level


def _make_pattern(seed: int = 42) -> np.ndarray:
    """[256, 4] int32 rows (y1, x1, y2, x2), sigma = 31/5."""
    r = np.random.default_rng(seed)
    sigma = 31.0 / 5.0
    pts = r.normal(0.0, sigma, size=(N_BITS, 4))
    return np.clip(np.round(pts), -13, 13).astype(np.int32)


PATTERN = _make_pattern()

_yy, _xx = np.meshgrid(np.arange(PATCH) - PATCH_HALF,
                       np.arange(PATCH) - PATCH_HALF, indexing="ij")
_ORI_MASK = ((_yy ** 2 + _xx ** 2) <= ORI_RADIUS ** 2).astype(np.float32)
_ORI_X = (_xx * _ORI_MASK).astype(np.float32)
_ORI_Y = (_yy * _ORI_MASK).astype(np.float32)


def extract_patches(img: torch.Tensor, yx: torch.Tensor) -> torch.Tensor:
    """Batched [N, PATCH, PATCH] patches centred at integer yx [N, 2].
    The start is handled as `dynamic_slice` handles it in the JAX package
    (`orb.py:50-57`): a negative start counts from the end, then the start
    is clamped into the image (torch indexing would do neither). Detection
    keeps valid keypoints away from the border; this fixes what the empty
    slots (centre 0, 0) read."""
    h, w = img.shape

    def start(c, size):
        s = c.long() - PATCH_HALF
        s = torch.where(s < 0, s + size, s)
        return torch.clamp(s, 0, size - PATCH)

    y0 = start(yx[:, 0], h)
    x0 = start(yx[:, 1], w)
    off = torch.arange(PATCH, device=img.device)
    rows = (y0[:, None] + off)[:, :, None]                  # [N, P, 1]
    cols = (x0[:, None] + off)[:, None, :]                  # [N, 1, P]
    return img[rows, cols]


def _blur_band_matrix(sigma: float, radius: int) -> np.ndarray:
    """[PATCH, PATCH] banded Gaussian matrix B with B@x = 1-D blur of x."""
    k = gaussian_kernel1d(sigma, radius)
    B = np.zeros((PATCH, PATCH), np.float32)
    for i in range(PATCH):
        for j, wgt in enumerate(k):
            c = i + j - radius
            if 0 <= c < PATCH:
                B[i, c] += wgt
    return B


def blur_patches(patches: torch.Tensor, sigma: float = 2.0,
                 radius: int = 3) -> torch.Tensor:
    """Separable Gaussian blur of the patch batch (two banded products;
    descriptor samples stay `radius` inside the patch border, so this
    equals blurring the whole level)."""
    B = torch.from_numpy(_blur_band_matrix(sigma, radius)).to(patches.device)
    return torch.matmul(torch.matmul(B, patches), B.T)


def orientations(patches: torch.Tensor) -> torch.Tensor:
    """IC_Angle: atan2 of the intensity-centroid moments over the circular
    patch. patches [N, PATCH, PATCH] -> angles [N] in radians."""
    dev = patches.device
    m10 = torch.einsum("nhw,hw->n", patches, torch.from_numpy(_ORI_X).to(dev))
    m01 = torch.einsum("nhw,hw->n", patches, torch.from_numpy(_ORI_Y).to(dev))
    return torch.atan2(m01, m10)


def descriptors_from_patches(patches: torch.Tensor, angles: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Steered BRIEF from blurred patches. Returns (bits_packed [N, 8]
    int32 holding the reference's uint32 words, pm1 [N, 256] int8 ±1)."""
    dev = patches.device
    pat = torch.from_numpy(PATTERN.astype(np.float32)).to(dev)
    ca, sa = torch.cos(angles), torch.sin(angles)
    ys = torch.cat([pat[:, 0], pat[:, 2]])
    xs = torch.cat([pat[:, 1], pat[:, 3]])
    iy = torch.clamp(torch.round(sa[:, None] * xs[None] + ca[:, None] * ys[None])
                     + PATCH_HALF, 0, PATCH - 1).long()           # [N, 512]
    ix = torch.clamp(torch.round(ca[:, None] * xs[None] - sa[:, None] * ys[None])
                     + PATCH_HALF, 0, PATCH - 1).long()
    # the JAX package selects rows and columns with one-hot products on the
    # MXU (`orb.py:118-125`); here it is a plain gather
    n = patches.shape[0]
    flat = patches.reshape(n, PATCH * PATCH)
    vals = torch.gather(flat, 1, iy * PATCH + ix)                  # [N, 512]
    bits = vals[:, :N_BITS] < vals[:, N_BITS:]                     # [N, 256]

    # pack to 8 words, little-endian within each word; int64 arithmetic,
    # then the low 32 bits as int32
    b = bits.reshape(n, 8, 32).to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=dev) << torch.arange(
        32, dtype=torch.int64, device=dev)
    words = torch.sum(b * weights, dim=-1)
    packed = torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)
    pm1 = torch.where(bits, 1, -1).to(torch.int8)
    return packed, pm1
