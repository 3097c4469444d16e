"""`update.object_update`, the object lane: the object table after drawn
updates, against the reference's update of the same table.

  object_mismatch     entries of the drawn object updates' membership and
                      counters that differ from the reference's (exact)
  object_gap          the largest gap of their centres, cuboids, radii,
                      centre sums (m) and boxes (px)
  object_spread_gap   the largest gap of their members' spread (m)
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import objects as robj

from ._common import bf16, fields, to_np

TARGET = ("eao_fusion_tpu_torch.objects.update", "object_update")
NUMBERS = ("object_mismatch", "object_gap", "object_spread_gap")
FO_FIELDS = ("cls", "box", "valid", "pt_ids", "pt_w", "pt_valid", "n_pts",
             "center", "on_edge")


def wrap(orig, take, keep):
    def object_update(tab, fo, assoc, pt_xyz, tcw, frame_id, rand, *, cfg):
        oc = cfg.objects
        plain = oc.mode in ("None", "NA") or oc.iforest_keyframe_rate
        if not (plain and take()):
            return orig(tab, fo, assoc, pt_xyz, tcw, frame_id, rand,
                        cfg=cfg)
        cam = cfg.camera
        item = dict(tab=fields(tab, tab._fields),
                    fo=fields(fo, FO_FIELDS),
                    target=assoc.target.clone(),
                    potential=assoc.potential.clone(),
                    pt_xyz=pt_xyz.clone(), tcw=tcw.clone(),
                    fid=int(frame_id), W=cam.width, H=cam.height,
                    cam=(cam.fx, cam.fy, cam.cx, cam.cy),
                    min_points=oc.min_points_init)
        out = orig(tab, fo, assoc, pt_xyz, tcw, frame_id, rand, cfg=cfg)
        item["out"] = fields(out, out._fields)
        keep(item)
        return out
    return object_update


def object_args(it) -> tuple:
    """The reference's arguments for a captured object update."""
    return (to_np(it["tab"]), to_np(it["fo"]), it["target"].cpu().numpy(),
            it["potential"].cpu().numpy(), it["pt_xyz"].cpu().numpy(),
            it["tcw"].cpu().numpy(), it["fid"], it["cam"], it["W"], it["H"],
            it["min_points"])


def numbers(items) -> dict:
    """object_mismatch, object_gap and object_spread_gap over the drawn
    object updates."""
    if not items:
        return dict.fromkeys(NUMBERS)
    n, g, sg = 0, 0.0, 0.0
    for it in items:
        dn, dg, ds = robj.gaps(to_np(it["out"]),
                               robj.update(*object_args(it)))
        n, g, sg = n + dn, max(g, dg), max(sg, ds)
    return dict(object_mismatch=float(n), object_gap=g,
                object_spread_gap=sg)


def control(it) -> dict:
    ref = robj.update(*object_args(it), quant=bf16)
    return {k: torch.as_tensor(np.asarray(v)) for k, v in ref.items()}
