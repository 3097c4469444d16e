"""`pose_opt.optimize_pose`, K1's path: the pose that drawn solves gave,
against a Gauss-Newton reference from the same start and observations.

  pose_gap            max over the drawn solves of max(|dt| m, angle rad)
                      between the program's pose and the reference's
"""

from __future__ import annotations

import torch

from benchmark.reference import lie as rlie
from benchmark.reference import pose as rpose

from ._common import SOLVER_KEYS, clone

TARGET = ("eao_fusion_tpu_torch.solvers.pose_opt", "optimize_pose")
NUMBERS = ("pose_gap",)


def wrap(orig, take, keep):
    def optimize_pose(pose0, obs, plane_obs=None, *, cam, cfg):
        if not take():
            return orig(pose0, obs, plane_obs, cam=cam, cfg=cfg)
        item = dict(pose0=clone(pose0), obs=clone(tuple(obs)),
                    planes=None if plane_obs is None
                    else clone(tuple(plane_obs)), cam=tuple(cam),
                    p={k: getattr(cfg, k) for k in SOLVER_KEYS})
        res = orig(pose0, obs, plane_obs, cam=cam, cfg=cfg)
        item["out"] = res.pose.detach().clone()
        keep(item)
        return res
    return optimize_pose


def _solve(it, *dtype):
    """The reference's pose for a drawn solve (in float64, or `dtype`)."""
    o = it["obs"]
    return rpose.solve(it["pose0"], o[0], o[1], o[2], o[3], o[4],
                       it["planes"], it["cam"], it["p"], *dtype)


def numbers(items) -> dict:
    gaps = [float(rlie.pose_gap(it["out"], _solve(it))) for it in items]
    return dict(pose_gap=max(gaps) if gaps else None)


def control(it):
    return _solve(it, torch.bfloat16).float()
