"""`ba.bundle_adjust_coo`, K2-K4's path: the window cameras that drawn
local BAs gave, against a Levenberg-Marquardt reference on the same
problem.

  ba_gap              max over the drawn local BAs' free cameras of
                      max(|dt| m, angle rad) between the program's pose
                      and the reference's
"""

from __future__ import annotations

import torch

from benchmark.reference import lie as rlie
from benchmark.reference import local_ba

from ._common import SOLVER_KEYS, clone

TARGET = ("eao_fusion_tpu_torch.solvers.ba", "bundle_adjust_coo")
NUMBERS = ("ba_gap",)


def wrap(orig, take, keep):
    def bundle_adjust_coo(prob, plane_block=None, *, cam, cfg, **kw):
        if not take():
            return orig(prob, plane_block, cam=cam, cfg=cfg, **kw)
        item = dict(prob={k: clone(v) for k, v in prob._asdict().items()},
                    planes=clone(plane_block), cam=tuple(cam),
                    p={k: getattr(cfg, k) for k in SOLVER_KEYS},
                    kw=dict(n_iters1=kw.get("n_iters1", 5),
                            n_iters2=kw.get("n_iters2", 10),
                            damping=kw.get("damping", 1e-3),
                            ftol=kw.get("ftol", 1e-4)))
        res = orig(prob, plane_block, cam=cam, cfg=cfg, **kw)
        item["out"] = res.cam_pose.detach().clone()
        keep(item)
        return res
    return bundle_adjust_coo


def numbers(items) -> dict:
    gaps = []
    for it in items:
        prob = it["prob"]
        cams, _ = local_ba.solve(prob, it["planes"], it["cam"], it["p"],
                                 **it["kw"])
        free = prob["cam_valid"] & ~prob["cam_fixed"]
        if bool(free.any()):
            gaps.append(float(rlie.pose_gap(it["out"][free],
                                             cams[free]).max()))
    return dict(ba_gap=max(gaps) if gaps else None)


def control(it):
    cams, _ = local_ba.solve(it["prob"], it["planes"], it["cam"], it["p"],
                             dtype=torch.bfloat16, **it["kw"])
    return cams.float()
