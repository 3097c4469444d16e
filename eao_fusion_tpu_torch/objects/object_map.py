"""Object landmarks: fixed-capacity table, per-frame 2D objects and their
statistics (port of `eao_fusion_tpu/objects/object_map.py`).

Re-design of `Object_2D` / `Object_Map` (`src/Object.cc`, SURVEY.md §2.1):
objects are rows of a dense table; member map points are id slots into the
global point table (so BA moves object points automatically); all
per-object statistics are masked reductions.

Semantics kept from the reference:
  * per-frame object = detector box + the tracked map points whose keypoint
    falls inside it (`Tracking::AssociateObjAndPoints`,
    `src/Tracking.cc:3031`), with depth-boxplot outlier rejection (IQR rule, far side only,
    `Object_2D::RemoveOutliersByBoxPlot` :104).
  * member addition gated by distance to center <= th * rMax (th = 1.0, or
    0.9 after 5 observations) (`DataAssociateUpdate` :1466-1476).
  * historical members projecting inside the image but outside the current
    box are removed unless seen >8 times (:1540-1597).
  * per-object cuboid = axis-aligned point bounds (yaw stays 0, as in the
    reference fork the JAX package follows).

Scatters that drop out-of-range rows in JAX (`mode="drop"` into row O or F)
write into one extra sink row here, which is then sliced off.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from eao_fusion_tpu_torch.config import SystemConfig
from eao_fusion_tpu_torch.ops import lie
from eao_fusion_tpu_torch.ops.topk import top_k_stable
from eao_fusion_tpu_torch.types import FrameFeatures

MEMBERS = 256  # member point slots per object
SAMPLE = 64    # compacted member sample per frame object
_BIG = 1e9


class ObjectTable(NamedTuple):
    cls: torch.Tensor          # [O] int32 detector class
    valid: torch.Tensor        # [O] bool
    pt_idx: torch.Tensor       # [O, M] int32 member map-point ids
    pt_ok: torch.Tensor        # [O, M] bool
    pt_addcnt: torch.Tensor    # [O, M] int32 times re-associated
    n_frames: torch.Tensor     # [O] int32 frame observations (df)
    last_frame: torch.Tensor   # [O] int32
    lastlast_frame: torch.Tensor  # [O] int32
    last_rect: torch.Tensor    # [O, 4] (x0,y0,x1,y1)
    lastlast_rect: torch.Tensor  # [O, 4]
    center: torch.Tensor       # [O, 3] mean of member points
    std: torch.Tensor          # [O, 3]
    cen_sum: torch.Tensor      # [O, 3] running sum of frame-object centers
    cen_sq: torch.Tensor       # [O, 3] running sum of squares
    cub_min: torch.Tensor      # [O, 3]
    cub_max: torch.Tensor      # [O, 3]
    rmax: torch.Tensor         # [O] max center-to-corner radius
    reobj: torch.Tensor        # [O, O] int32 potential-association counters
    sametime: torch.Tensor     # [O, O] int32 co-appearance counters
    next_obj: torch.Tensor     # [] int32


class FrameObjects(NamedTuple):
    """Per-frame 2D objects after filtering + point stats (Object_2D)."""
    cls: torch.Tensor          # [F] int32
    score: torch.Tensor        # [F]
    box: torch.Tensor          # [F, 4] (x0,y0,x1,y1)
    valid: torch.Tensor        # [F] bool
    kp_mask: torch.Tensor      # [F, N] member keypoints
    pt_ids: torch.Tensor       # [F, S] compacted member point ids (-1 pad)
    pt_w: torch.Tensor         # [F, S, 3] member world positions
    pt_valid: torch.Tensor     # [F, S]
    n_pts: torch.Tensor        # [F] int32
    center: torch.Tensor       # [F, 3]
    std: torch.Tensor          # [F, 3]
    feat_rect: torch.Tensor    # [F, 4] bbox of member keypoints
    on_edge: torch.Tensor      # [F] bool


def empty_table(cfg: SystemConfig, device) -> ObjectTable:
    O = cfg.objects.max_map_objects
    i32, f32 = torch.int32, torch.float32

    def full(shape, v, dt):
        return torch.full(shape, v, dtype=dt, device=device)

    return ObjectTable(
        cls=full((O,), -1, i32), valid=full((O,), False, torch.bool),
        pt_idx=full((O, MEMBERS), -1, i32),
        pt_ok=full((O, MEMBERS), False, torch.bool),
        pt_addcnt=full((O, MEMBERS), 0, i32), n_frames=full((O,), 0, i32),
        last_frame=full((O,), -9, i32), lastlast_frame=full((O,), -9, i32),
        last_rect=full((O, 4), 0.0, f32), lastlast_rect=full((O, 4), 0.0, f32),
        center=full((O, 3), 0.0, f32), std=full((O, 3), 0.0, f32),
        cen_sum=full((O, 3), 0.0, f32), cen_sq=full((O, 3), 0.0, f32),
        cub_min=full((O, 3), 0.0, f32), cub_max=full((O, 3), 0.0, f32),
        rmax=full((O,), 0.0, f32), reobj=full((O, O), 0, i32),
        sametime=full((O, O), 0, i32), next_obj=full((), 0, i32))


def table_where(cond: torch.Tensor, a: ObjectTable,
                b: ObjectTable) -> ObjectTable:
    """`a` where the scalar bool tensor `cond` holds, else `b` (no host
    read)."""
    return ObjectTable(*[torch.where(cond, x, y) for x, y in zip(a, b)])


def _clip0(idx: torch.Tensor) -> torch.Tensor:
    return torch.clamp(idx.long(), min=0)


def _mean_std(pw: torch.Tensor, w: torch.Tensor,
              n: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked mean and std over axis 1 of pw [R, K, 3] with weights w
    [R, K, 1] and counts n [R, 1] (already clamped to >= 1)."""
    center = (pw * w).sum(dim=1) / n
    sq = (pw * pw * w).sum(dim=1) / n
    return center, torch.sqrt(torch.clamp(sq - center * center, min=0.0))


def build_frame_objects(boxes: torch.Tensor, feats: FrameFeatures,
                        kp_pt: torch.Tensor, pt_xyz: torch.Tensor,
                        pt_valid: torch.Tensor, tcw: torch.Tensor, *,
                        cfg: SystemConfig) -> FrameObjects:
    """boxes [B, 6] rows (class, x, y, w, h, score) — detector output after
    the score/class filter (`src/Tracking.cc:431-470`)."""
    oc = cfg.objects
    F = oc.max_objects_2d
    W, H = cfg.camera.width, cfg.camera.height
    dev = pt_xyz.device
    n_in = min(int(boxes.shape[0]), F)
    boxes = torch.cat([boxes[:F].to(device=dev, dtype=torch.float32),
                       boxes.new_zeros((F - n_in, 6), dtype=torch.float32,
                                       device=dev)], dim=0)
    present = torch.arange(F, device=dev) < n_in
    score_ok = boxes[:, 5] >= oc.min_box_score
    x0, y0 = boxes[:, 1], boxes[:, 2]
    x1, y1 = x0 + boxes[:, 3], y0 + boxes[:, 4]
    box = torch.stack([x0, y0, x1, y1], dim=-1)
    on_edge = ((x0 < oc.image_border) | (y0 < oc.image_border)
               | (x1 > W - oc.image_border) | (y1 > H - oc.image_border))
    valid = present & score_ok & (boxes[:, 3] > 4) & (boxes[:, 4] > 4)

    # member keypoints: inside box, with a tracked, valid map point
    u, v = feats.uv[:, 0], feats.uv[:, 1]
    inb = ((u[None] >= x0[:, None]) & (u[None] <= x1[:, None])
           & (v[None] >= y0[:, None]) & (v[None] <= y1[:, None]))
    kp = _clip0(kp_pt)
    has_pt = (kp_pt >= 0) & feats.valid & pt_valid[kp]
    member = inb & has_pt[None] & valid[:, None]             # [F, N]
    N = member.shape[1]

    pw_all = pt_xyz[kp]                                      # [N, 3]
    zc_all = lie.se3_apply(tcw, pw_all)[:, 2]                # [N]
    inf = float("inf")

    # ---- depth boxplot (far-side IQR cut, reference semantics) ----------
    zs = torch.sort(torch.where(member, zc_all[None], inf), dim=1).values
    cnt = member.sum(dim=1)
    q1 = zs.gather(1, (cnt // 4)[:, None])[:, 0]
    q3 = zs.gather(1, torch.clamp(3 * cnt // 4, max=N - 1)[:, None])[:, 0]
    zmax = torch.where(cnt >= 4, q3 + 1.5 * (q3 - q1), inf)
    member = member & (zc_all[None] <= zmax[:, None])

    # ---- central-anchor depth gate (improvement over the reference):
    # anchor on the median depth of the box's central region and keep only
    # points near that shell
    cx0, cx1 = 0.75 * x0 + 0.25 * x1, 0.25 * x0 + 0.75 * x1
    cy0, cy1 = 0.75 * y0 + 0.25 * y1, 0.25 * y0 + 0.75 * y1
    central = (member & (u[None] >= cx0[:, None]) & (u[None] <= cx1[:, None])
               & (v[None] >= cy0[:, None]) & (v[None] <= cy1[:, None]))
    zcs = torch.sort(torch.where(central, zc_all[None], inf), dim=1).values
    ccnt = central.sum(dim=1)
    anchor = zcs.gather(1, (ccnt // 2)[:, None])[:, 0]
    tol = torch.clamp(0.15 * anchor, min=0.45)
    near = (zc_all[None] - anchor[:, None]).abs() <= tol[:, None]
    member = member & torch.where((ccnt >= 3)[:, None], near, True)

    n_pts = member.sum(dim=1).to(torch.int32)
    valid = valid & (n_pts >= 2)

    # ---- compact member sample (static S slots, lower index first) -----
    sel_val, sel_idx = top_k_stable(member.to(torch.int32), SAMPLE)
    pt_ok = sel_val > 0
    pt_ids = torch.where(pt_ok, kp_pt[sel_idx], -1).to(torch.int32)
    pt_w = pw_all[sel_idx]                                   # [F, S, 3]

    # ---- stats ---------------------------------------------------------
    wm = member.to(torch.float32)
    denom = torch.clamp(n_pts.to(torch.float32), min=1.0)[:, None]
    center = (wm @ pw_all) / denom
    sq = (wm @ (pw_all * pw_all)) / denom
    std = torch.sqrt(torch.clamp(sq - center * center, min=0.0))

    def ext(x, fill, fn):
        return fn(torch.where(member, x[None], fill), dim=1).values

    feat_rect = torch.stack([ext(u, _BIG, torch.min), ext(v, _BIG, torch.min),
                             ext(u, -_BIG, torch.max),
                             ext(v, -_BIG, torch.max)], dim=-1)
    return FrameObjects(cls=boxes[:, 0].to(torch.int32), score=boxes[:, 5],
                        box=box, valid=valid, kp_mask=member, pt_ids=pt_ids,
                        pt_w=pt_w, pt_valid=pt_ok, n_pts=n_pts,
                        center=center, std=std, feat_rect=feat_rect,
                        on_edge=on_edge)


def free_slots(taken: torch.Tensor, new: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Place the `new` entries of each row, in order, into that row's free
    slots (`~taken`), lowest free slot first: (placed [R, K] bool, slot
    [R, K] long). `new` beyond the free count is not placed."""
    S = taken.shape[-1]
    _, free_idx = top_k_stable((~taken).to(torch.int32), S)
    n_free = (~taken).sum(dim=-1, keepdim=True)
    rank = torch.cumsum(new.to(torch.int64), dim=-1) - 1
    place = new & (rank < n_free)
    slot = free_idx.gather(-1, torch.clamp(rank, 0, S - 1))
    return place, slot


def merge_frame_objects(fo: FrameObjects, last: FrameObjects,
                        pt_valid: torch.Tensor, *,
                        cfg: SystemConfig) -> FrameObjects:
    """Frame-to-frame object enrichment (`Object_2D::MergeTwoFrameObj`,
    `src/Object.cc:965-996`): a current-frame object absorbs the member
    points of the same-class last-frame object it overlaps (IoU > 0.5),
    deduplicated."""
    F, S = fo.pt_ids.shape
    dev = fo.pt_ids.device
    iou = rect_iou(fo.box[:, None, :], last.box[None, :, :])
    ok = (fo.valid[:, None] & last.valid[None, :]
          & (fo.cls[:, None] == last.cls[None, :]) & (iou > 0.5))
    best = torch.argmax(torch.where(ok, iou, -1.0), dim=1)
    has = ok.any(dim=1)

    l_ids = last.pt_ids[best]                                # [F, S]
    l_ok = (last.pt_valid[best] & has[:, None]
            & pt_valid[_clip0(l_ids)] & (l_ids >= 0))
    l_w = last.pt_w[best]
    exists = ((l_ids[:, :, None] == fo.pt_ids[:, None, :])
              & fo.pt_valid[:, None, :]).any(dim=-1)
    place, slot = free_slots(fo.pt_valid, l_ok & ~exists)
    rows = torch.where(place, torch.arange(F, device=dev)[:, None], F)
    sink = (rows.reshape(-1), slot.reshape(-1))

    def put(x, vals, fill):
        pad = torch.cat([x, torch.full_like(x[:1], fill)], dim=0)
        return pad.index_put(sink, vals)[:F]

    pt_ids = put(fo.pt_ids, l_ids.reshape(-1), -1)
    pt_w = put(fo.pt_w, l_w.reshape(-1, 3), 0.0)
    pt_ok = put(fo.pt_valid, torch.ones_like(place.reshape(-1)), False)

    # refresh count/center/std from the enriched sample
    n = torch.clamp(pt_ok.sum(dim=1).to(torch.float32), min=1.0)[:, None]
    center, std = _mean_std(pt_w, pt_ok.to(torch.float32)[..., None], n)
    n_pts = fo.n_pts + place.sum(dim=1).to(torch.int32)
    return fo._replace(pt_ids=pt_ids, pt_w=pt_w, pt_valid=pt_ok,
                       n_pts=n_pts, center=center, std=std)


# ----------------------------------------------------------------- helpers

def _inter(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    x0 = torch.maximum(a[..., 0], b[..., 0])
    y0 = torch.maximum(a[..., 1], b[..., 1])
    x1 = torch.minimum(a[..., 2], b[..., 2])
    y1 = torch.minimum(a[..., 3], b[..., 3])
    return torch.clamp(x1 - x0, min=0.0) * torch.clamp(y1 - y0, min=0.0)


def _area(a: torch.Tensor) -> torch.Tensor:
    return (torch.clamp(a[..., 2] - a[..., 0], min=0.0)
            * torch.clamp(a[..., 3] - a[..., 1], min=0.0))


def rect_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of rects [..., 4] (x0,y0,x1,y1), broadcasting."""
    inter = _inter(a, b)
    return inter / torch.clamp(_area(a) + _area(b) - inter, min=1e-6)


def rect_overlap_former(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """intersection / area(a) (`Converter::bboxOverlapratioFormer`)."""
    return _inter(a, b) / torch.clamp(_area(a), min=1e-6)


def project_members(tab: ObjectTable, pt_xyz: torch.Tensor,
                    tcw: torch.Tensor,
                    cam: Tuple[float, float, float, float],
                    width: int, height: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project member points of every object. Returns (uv [O,M,2],
    ok [O,M], rect [O,4] clipped) — `Object_Map::ComputeProjectRectFrame`
    (`src/Object.cc:1606-1652`)."""
    pc = lie.se3_apply(tcw, pt_xyz[_clip0(tab.pt_idx)])     # [O, M, 3]
    ok = tab.pt_ok & (pc[..., 2] > 0.05)
    uv = lie.project(cam, pc)

    def ext(x, fill, fn):
        return fn(torch.where(ok, x, fill), dim=1).values

    rect = torch.stack([
        torch.clamp(ext(uv[..., 0], _BIG, torch.min), 0, width),
        torch.clamp(ext(uv[..., 1], _BIG, torch.min), 0, height),
        torch.clamp(ext(uv[..., 0], -_BIG, torch.max), 0, width),
        torch.clamp(ext(uv[..., 1], -_BIG, torch.max), 0, height)], dim=-1)
    rect = torch.where(ok.any(dim=1)[:, None], rect, 0.0)
    return uv, ok, rect


def member_stats(tab: ObjectTable, pt_xyz: torch.Tensor) -> ObjectTable:
    """Recompute center/std/cuboid/rmax from member points
    (`Object_Map::ComputeMeanAndStandard`, `src/Object.cc:999-1235`)."""
    pw = pt_xyz[_clip0(tab.pt_idx)]
    ok3 = tab.pt_ok[..., None]
    n = torch.clamp(tab.pt_ok.sum(dim=1).to(torch.float32), min=1.0)[:, None]
    center, std = _mean_std(pw, ok3.to(torch.float32), n)
    has = tab.pt_ok.any(dim=1)[:, None]
    cmin = torch.where(has, torch.where(ok3, pw, _BIG).min(dim=1).values, 0.0)
    cmax = torch.where(has, torch.where(ok3, pw, -_BIG).max(dim=1).values, 0.0)
    # max distance from the point-mean to a cuboid corner
    d = torch.maximum((cmin - center).abs(), (cmax - center).abs())
    return tab._replace(center=center, std=std, cub_min=cmin, cub_max=cmax,
                        rmax=torch.linalg.norm(d, dim=-1))


def boxes_tensor(boxes, device) -> torch.Tensor:
    """[B, 6] numpy boxes (class, x, y, w, h, score) as a float32 tensor."""
    return torch.as_tensor(np.asarray(boxes, np.float32).reshape(-1, 6),
                           device=device)
