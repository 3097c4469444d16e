"""Ensemble object data association: IoU, Wilcoxon rank-sum, projected-box
IoU and t-test, batched over (frame objects x map objects) (port of
`eao_fusion_tpu/objects/association.py`).

Re-design of `Object_2D::ObjectDataAssociation` + `NoParaDataAssociation`
(`src/Object.cc:161-724, 728-962`): the reference's sequential cascade
becomes dense [F, O] gate matrices with the same priority order
(IoU > nonparametric > projected box > t-test), the same thresholds, and
the same accept check (`DataAssociateUpdate` step 1, :1364-1437). The
ablation `mode` string ("Full"/"NA"/"IoU"/"NP"/...) gates methods like the
reference's flag.

Method codes: 0 none, 1 IoU, 2 NP, 3 t-test, 4 projected box.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from eao_fusion_tpu_torch.config import SystemConfig
from eao_fusion_tpu_torch.objects import ttable
from eao_fusion_tpu_torch.objects.object_map import (FrameObjects,
                                                     ObjectTable, _clip0,
                                                     project_members,
                                                     rect_iou,
                                                     rect_overlap_former)

_BIG = 1e9


class AssocResult(NamedTuple):
    target: torch.Tensor     # [F] int32 map-object row, -1 = none
    method: torch.Tensor     # [F] int32 (0..4)
    potential: torch.Tensor  # [F, O] bool — passed some gate but not chosen


def rank_counts(fw: torch.Tensor, fvalid: torch.Tensor, ow: torch.Tensor,
                ovalid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rank-sum pair counts per (frame object, map object, axis):
    w12 = #{valid (s, m): fw[f,s] > ow[o,m]}, w21 = #{... <}, as int64
    [F, O, 3]. Each object's members are sorted per axis (invalid ones at
    +inf) and every valid frame sample is located by `searchsorted`: the
    same integers as the JAX package's dense [F, O, S, M, 3] comparison,
    without that tensor."""
    F, S, _ = fw.shape
    O = ow.shape[0]
    srt = torch.sort(torch.where(ovalid[..., None], ow, float("inf"))
                     .permute(0, 2, 1).contiguous(), dim=-1).values  # [O,3,M]
    n_o = ovalid.sum(dim=1)                                   # [O]
    vals = fw.permute(2, 0, 1).reshape(1, 3, F * S).expand(O, 3, F * S)
    vals = vals.contiguous()
    below = torch.searchsorted(srt, vals, right=False)        # # members < x
    upto = torch.searchsorted(srt, vals, right=True)          # # members <= x
    fv = fvalid.reshape(1, 1, F * S)
    w12 = torch.where(fv, below, 0).reshape(O, 3, F, S).sum(dim=-1)
    w21 = torch.where(fv, n_o[:, None, None] - upto, 0)
    w21 = w21.reshape(O, 3, F, S).sum(dim=-1)
    return w12.permute(2, 0, 1), w21.permute(2, 0, 1)


def ensemble_associate(tab: ObjectTable, fo: FrameObjects,
                       pt_xyz: torch.Tensor, tcw: torch.Tensor,
                       frame_id, *, cfg: SystemConfig) -> AssocResult:
    oc = cfg.objects
    mode = oc.mode
    F = fo.box.shape[0]
    O = tab.cls.shape[0]
    dev = fo.box.device
    W, H = cfg.camera.width, cfg.camera.height
    cam = (cfg.camera.fx, cfg.camera.fy, cfg.camera.cx, cfg.camera.cy)
    f32 = torch.float32

    cls_eq = fo.cls[:, None] == tab.cls[None, :]
    alive = tab.valid[None, :] & fo.valid[:, None] & cls_eq

    # ---------------- STEP 1: IoU with motion-predicted box --------------
    seen_last = tab.last_frame == frame_id - 1
    seen_ll = tab.lastlast_frame == frame_id - 2
    pred = 2.0 * tab.last_rect - tab.lastlast_rect
    pred = torch.stack([torch.clamp(pred[:, 0], 0, W),
                        torch.clamp(pred[:, 1], 0, H),
                        torch.clamp(pred[:, 2], 0, W),
                        torch.clamp(pred[:, 3], 0, H)], dim=-1)
    rect_pred = torch.where(seen_ll[:, None], pred, tab.last_rect)
    iou = rect_iou(fo.box[:, None, :], rect_pred[None, :, :])   # [F, O]
    iou_th = torch.where(seen_ll, 0.6, oc.iou_threshold)
    iou_ok = alive & seen_last[None, :] & (iou > iou_th[None, :])

    # ---------------- shared projections ---------------------------------
    _, _, rect_proj = project_members(tab, pt_xyz, tcw, cam, W, H)
    n_o = tab.pt_ok.sum(dim=1)                                   # [O]
    df = tab.n_frames                                            # [O]

    # accept check used by NP and t-test (projected-rect consistency):
    # rect2 = bbox of frame-object pixels U projected members; accept if
    # IoU(rect_proj, rect2) >= 0.5 or inter/area(rect2 vs box) >= 0.8
    fr, rp = fo.feat_rect[:, None, :], rect_proj[None, :, :]
    rect2 = torch.cat([torch.minimum(fr[..., :2], rp[..., :2]),
                       torch.maximum(fr[..., 2:], rp[..., 2:])], dim=-1)
    accept = ((rect_iou(rp, rect2) >= 0.5)
              | (rect_overlap_former(rect2, fo.box[:, None, :]) >= 0.8))

    # ---------------- STEP 2: Wilcoxon rank-sum (NP) ---------------------
    ow = pt_xyz[_clip0(tab.pt_idx)]                               # [O, M, 3]
    w12, w21 = rank_counts(fo.pt_w, fo.pt_valid, ow, tab.pt_ok)
    w12, w21 = w12.to(f32), w21.to(f32)
    mf = fo.pt_valid.sum(dim=1).to(f32)[:, None]                  # [F, 1]
    nf = n_o.to(f32)[None, :]                                     # [1, O]
    w00 = mf[..., None] * nf[..., None] - w12 - w21
    Wst = torch.minimum(w12 + (mf * (mf + 1) / 2)[..., None],
                        w21 + (nf * (nf + 1) / 2)[..., None]) + w00 / 2
    mn1 = (mf * nf * (mf + nf + 1) / 12)[..., None]
    mid = (0.5 * mf * (mf + nf + 1))[..., None]
    half = 1.282 * torch.sqrt(torch.clamp(mn1, min=1e-9))
    np_dim_ok = (Wst > mid - half) & (Wst < mid + half)           # [F, O, 3]
    np_ok = (alive & np_dim_ok.all(dim=-1)
             & (mf >= 20) & (nf >= 20) & accept)

    # ---------------- STEP 3: projected-box IoU --------------------------
    fiou = torch.maximum(rect_iou(fo.box[:, None, :], rp),
                         rect_iou(fr, rp))
    # reference gate: skip when frame obj has >=10 pts AND df > 8
    proj_applicable = ~((fo.n_pts[:, None] >= 10) & (df[None, :] > 8))
    proj_ok = alive & proj_applicable & (fiou >= oc.projected_iou_threshold)

    # ---------------- STEP 4: t-test --------------------------------------
    dfl = torch.clamp(df, min=1).to(f32)
    cen_mean = tab.cen_sum / dfl[:, None]
    cen_var = tab.cen_sq / dfl[:, None] - cen_mean * cen_mean
    cen_std = torch.sqrt(torch.clamp(cen_var, min=1e-12))         # [O, 3]
    dis = (tab.center[None, :, :] - fo.center[:, None, :]).abs()  # [F, O, 3]
    t = dis / (cen_std[None] / torch.sqrt(dfl)[None, :, None] + 1e-12)
    crit05 = ttable.crit(df - 1, ttable.COL_ALPHA_05)[None, :, None]
    crit001 = ttable.crit(df - 1, ttable.COL_ALPHA_001)[None, :, None]
    t_mean = t.mean(dim=-1)
    strict = (t < crit05).all(dim=-1)
    relaxed = (fiou > 0.25) & ((t < crit001).all(dim=-1) | (t_mean < 10.0))
    forced = (t_mean < 4.0) & (fiou > 0.25)
    t_ok = alive & (df[None, :] > 8) & (strict | relaxed | forced) & accept

    # ---------------- priority selection ----------------------------------
    def pick(ok, score):
        best = torch.argmax(torch.where(ok, score, -_BIG), dim=1)
        return ok.any(dim=1), torch.where(ok.any(dim=1), best, -1)

    obj_recency = torch.arange(O, dtype=f32, device=dev)[None, :].expand(F, O)
    has_iou, tgt_iou = pick(iou_ok, iou)
    has_np, tgt_np = pick(np_ok, obj_recency)        # newest first on ties
    has_proj, tgt_proj = pick(proj_ok, fiou)
    has_t, tgt_t = pick(t_ok, obj_recency)

    off = torch.zeros((F,), dtype=torch.bool, device=dev)
    if mode == "NA":
        has_iou = has_np = has_proj = has_t = off
    elif mode == "IoU":
        has_np = has_proj = has_t = off
    elif mode == "NP":
        has_iou = has_proj = has_t = off

    target = torch.where(has_iou, tgt_iou, torch.where(
        has_np, tgt_np, torch.where(has_proj, tgt_proj,
                                    torch.where(has_t, tgt_t, -1))))
    method = torch.where(has_iou, 1, torch.where(
        has_np, 2, torch.where(has_proj, 4, torch.where(has_t, 3, 0))))
    method = torch.where(target >= 0, method, 0)

    # potentials: candidates that passed any gate but were not chosen
    passed = iou_ok | np_ok | proj_ok | t_ok
    chosen = torch.arange(O, device=dev)[None, :] == target[:, None]
    potential = passed & ~chosen & (target >= 0)[:, None]
    return AssocResult(target=target.to(torch.int32),
                       method=method.to(torch.int32), potential=potential)
