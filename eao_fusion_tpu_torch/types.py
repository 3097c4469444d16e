"""Core state types (port of `eao_fusion_tpu/types.py`).

Fixed-shape tensors with validity masks instead of dynamic sizes, as
NamedTuples whose field names match the JAX package, so tests compare the
two field by field. `tree_from_numpy` / `tree_to_numpy` carry such a
tuple across as a dict of numpy arrays (what
`jax.tree.map(np.asarray, x)._asdict()` gives).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class FrameFeatures(NamedTuple):
    """Per-frame ORB features, fixed capacity N = ORBConfig.max_keypoints."""

    uv: torch.Tensor          # [N, 2] float32, level-0 pixel coords (x, y)
    response: torch.Tensor    # [N] float32 FAST score (0 for empty slots)
    level: torch.Tensor       # [N] int32 pyramid octave
    angle: torch.Tensor       # [N] float32 radians
    desc_packed: torch.Tensor  # [N, 8] int32 — 256-bit BRIEF, packed (the
                               # bits of the reference's uint32 words)
    desc_pm1: torch.Tensor    # [N, 256] int8 — same bits as ±1
    valid: torch.Tensor       # [N] bool
    depth: torch.Tensor       # [N] float32 meters; 0 = no depth
    uright: torch.Tensor      # [N] float32 virtual right u (u - bf/z); -1 = mono

    @property
    def n_slots(self) -> int:
        return self.uv.shape[0]


class FramePlanes(NamedTuple):
    """Per-frame plane observations, fixed capacity P = max_planes_per_frame.
    Hessian-normal [n, d] in the CAMERA frame with n·x + d = 0, n unit,
    d >= 0."""

    coeffs: torch.Tensor         # [P, 4] float32 camera-frame plane
    n_inliers: torch.Tensor      # [P] int32 supporting pixel count
    valid: torch.Tensor          # [P] bool
    boundary: torch.Tensor       # [P, B, 3] float32 camera-frame samples
    boundary_valid: torch.Tensor  # [P, B] bool


def to_tensor(x, device) -> torch.Tensor:
    """numpy array / scalar -> tensor on `device`. uint32 arrays keep their
    bits as int32 (torch has no general uint32 arithmetic)."""
    a = np.array(x)                 # a writable copy: torch shares memory
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


def to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def tree_from_numpy(cls, d, device):
    """Build NamedTuple `cls` from a dict (or NamedTuple) of numpy arrays."""
    if hasattr(d, "_asdict"):
        d = d._asdict()
    return cls(**{k: to_tensor(d[k], device) for k in cls._fields})


def tree_to_numpy(x) -> dict:
    return {k: to_numpy(v) for k, v in x._asdict().items()}
