"""Helpers of the kind modules: copies of the program's tensors, made on
the device when a call is drawn, and the control's rounding."""

from __future__ import annotations

import numpy as np
import torch

# the solver settings that the pose solve and local BA read from the
# port's configuration
SOLVER_KEYS = ("pose_rounds", "pose_iters_per_round", "chi2_mono",
               "chi2_stereo", "plane_angle_info", "plane_dist_info",
               "plane_chi2")


def clone(x):
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, (tuple, list)):
        return type(x)(clone(v) for v in x) if not hasattr(x, "_fields") \
            else type(x)(*(clone(v) for v in x))
    return x


def fields(m, names):
    return {n: getattr(m, n).detach().clone() for n in names}


def to_np(d: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in d.items()}


def bf16(a: np.ndarray) -> np.ndarray:
    """`a` rounded to bfloat16, in its own dtype."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return t.to(torch.bfloat16).float().numpy().astype(a.dtype)
