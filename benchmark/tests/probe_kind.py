"""A kind of check that the harness never names (`benchmark/checks/`
holds no such module): the tests point a workload at it by its whole
module name. It wraps `steady.slam_chunk` and compares the norm of every
reported pose's quaternion of the drawn chunks with 1, worked out in
float64."""

import torch

from benchmark.checks._common import clone

TARGET = ("eao_fusion_tpu_torch.pipeline.steady", "slam_chunk")
NUMBERS = ("probe_quat_norm_gap",)


def wrap(orig, take, keep):
    def slam_chunk(st, grays, depths, boxes, timestamps, *, cfg, **kw):
        st, diag = orig(st, grays, depths, boxes, timestamps, cfg=cfg, **kw)
        if take():
            keep(dict(out=clone(diag["pose"])))
        return st, diag
    return slam_chunk


def numbers(items) -> dict:
    if not items:
        return dict.fromkeys(NUMBERS)
    gap = max(float((it["out"][:, :4].double().norm(dim=-1) - 1).abs().max())
              for it in items)
    return dict(probe_quat_norm_gap=gap)


def control(it):
    return it["out"].to(torch.bfloat16).float()
