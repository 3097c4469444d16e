"""Object-table update after association: member fusion, projection culling,
statistics refresh, isolation-forest culling and new-object creation (port
of `eao_fusion_tpu/objects/update.py`).

Re-design of `Object_Map::DataAssociateUpdate` (`src/Object.cc:1352-1602`)
and the creation branch of `ObjectDataAssociation` (:663-722) as one
scattered batch update over the fixed-capacity table. Rows that the JAX
package drops (`mode="drop"` into row O) go to one extra sink row here."""

from __future__ import annotations

from typing import Optional, Union

import torch

from eao_fusion_tpu_torch.config import SystemConfig
from eao_fusion_tpu_torch.objects.association import AssocResult
from eao_fusion_tpu_torch.objects.iforest import (ForestDraws, cull_mask,
                                                  draw_forest)
from eao_fusion_tpu_torch.objects.object_map import (MEMBERS, SAMPLE,
                                                     FrameObjects,
                                                     ObjectTable, _clip0,
                                                     free_slots, member_stats)
from eao_fusion_tpu_torch.ops import lie
from eao_fusion_tpu_torch.ops.topk import top_k_stable

IFOREST_SKIP_CLASSES = (75, 64, 65)   # reference `src/Object.cc:1244-1246`
IFOREST_SPECIAL_CLASS = 62            # threshold 0.65 instead of 0.6

# a cull's randoms: a generator to draw them from, or the draws themselves
Randoms = Union[torch.Generator, ForestDraws]


def _sink(x: torch.Tensor, fill=0) -> torch.Tensor:
    """x with one extra row (the sink) appended along dim 0."""
    return torch.cat([x, torch.full_like(x[:1], fill)], dim=0)


def iforest_cull(tab: ObjectTable, pt_xyz: torch.Tensor, rand: Randoms,
                 touched: Optional[torch.Tensor] = None, *,
                 cfg: SystemConfig, compact: int = 0) -> ObjectTable:
    """Isolation-forest member culling over (a subset of) the object table
    (`Object_Map::IsolationForestDeleteOutliers`).

    `compact` > 0 gathers only that many gated rows (most recently seen
    first), runs the forest on that subset and writes the culled
    membership back; the reference only re-culls objects whose membership
    changed. `rand` gives one forest per row culled (K = `compact` rows,
    or all O), in row order."""
    oc = cfg.objects
    O = tab.cls.shape[0]
    thresh = torch.where(tab.cls == IFOREST_SPECIAL_CLASS,
                         oc.iforest_threshold_merged, oc.iforest_threshold)
    skip = torch.zeros_like(tab.valid)
    for c in IFOREST_SKIP_CLASSES:
        skip = skip | (tab.cls == c)
    gate = tab.valid & ~skip
    if touched is not None:
        gate = gate & touched

    def cull(rows):
        ok = tab.pt_ok[rows]
        draws = rand if isinstance(rand, ForestDraws) else draw_forest(
            rand, ok, n_trees=oc.iforest_trees, sample=oc.iforest_sample)
        c = cull_mask(pt_xyz[_clip0(tab.pt_idx[rows])], ok, draws,
                      thresh[rows])
        return ok & ~(c & gate[rows][:, None])

    if compact and compact < O:
        # most-recently-observed gated rows first (membership only changes
        # on observation, so stale rows were already culled when touched)
        _, rows = top_k_stable(torch.where(gate, tab.last_frame, -1),
                               compact)                      # distinct rows
        sink_rows = torch.where(gate[rows], rows, O)
        pt_ok = _sink(tab.pt_ok, False).index_put((sink_rows,),
                                                  cull(rows))[:O]
    else:
        pt_ok = cull(torch.arange(O, device=tab.pt_ok.device))
    return member_stats(tab._replace(pt_ok=pt_ok), pt_xyz)


def object_update(tab: ObjectTable, fo: FrameObjects, assoc: AssocResult,
                  pt_xyz: torch.Tensor, tcw: torch.Tensor, frame_id,
                  rand: Randoms, *, cfg: SystemConfig) -> ObjectTable:
    oc = cfg.objects
    F = fo.box.shape[0]
    O = tab.cls.shape[0]
    dev = fo.box.device
    W, H = cfg.camera.width, cfg.camera.height
    cam = (cfg.camera.fx, cfg.camera.fy, cfg.camera.cx, cfg.camera.cy)
    i32 = torch.int32
    ar_f = torch.arange(F, device=dev)
    fid = (frame_id.to(dev, i32) if isinstance(frame_id, torch.Tensor)
           else torch.full((), int(frame_id), dtype=i32,
                           device=dev)).expand(F)

    # ---- resolve duplicate targets (keep the larger frame object) -------
    target = assoc.target.long()
    has_t = target >= 0
    tsink = torch.where(has_t, target, O)
    tcl = torch.clamp(target, 0, O - 1)
    key_score = torch.where(has_t, fo.n_pts, -1).to(i32)
    best_per_o = torch.full((O + 1,), -1, dtype=i32,
                            device=dev).scatter_reduce(0, tsink, key_score,
                                                       "amax")
    winner = has_t & (key_score == best_per_o[tcl])
    # tie-break by frame-object index
    first_f = torch.full((O + 1,), F, dtype=torch.int64,
                         device=dev).scatter_reduce(
        0, torch.where(winner, target, O), ar_f, "amin")
    winner = winner & (ar_f == first_f[tcl])
    target = torch.where(winner, target, -1)
    has_t = target >= 0
    tgt_row = torch.where(has_t, target, O)                  # O = sink row
    tcl = torch.clamp(target, 0, O - 1)

    # ---- 1. member addition (dedup + distance gate) ----------------------
    # distance gate: || p - center_o || <= th * rmax_o, th = 1.0 / 0.9
    th = torch.where(tab.n_frames > 5, 0.9, 1.0)             # [O]
    rmax_t = (tab.rmax * th)[tcl]                            # [F]
    first_obs = tab.n_frames[tcl] == 0
    dist = torch.linalg.norm(fo.pt_w - tab.center[tcl][:, None, :], dim=-1)
    dist_ok = (dist <= rmax_t[:, None]) | first_obs[:, None]
    cand = fo.pt_valid & dist_ok & has_t[:, None]            # [F, S]

    # dedup: does pid already exist in the target row?
    row_ids = tab.pt_idx[tcl]                                # [F, M]
    row_ok = tab.pt_ok[tcl]
    eq = (fo.pt_ids[:, :, None] == row_ids[:, None, :]) & row_ok[:, None, :]
    exists = eq.any(dim=-1)                                  # [F, S]
    # addcnt increment for re-observed members
    slot_of = torch.argmax(eq.to(torch.int32), dim=-1)       # [F, S]
    inc_rows = torch.where(exists & cand, tgt_row[:, None], O)
    addcnt = _sink(tab.pt_addcnt).index_put(
        (inc_rows.reshape(-1), slot_of.reshape(-1)),
        torch.ones(F * SAMPLE, dtype=i32, device=dev), accumulate=True)

    # free-slot assignment in each target row
    place, slot = free_slots(row_ok, cand & ~exists)
    put = (torch.where(place, tgt_row[:, None], O).reshape(-1),
           slot.reshape(-1))
    tab = tab._replace(
        pt_idx=_sink(tab.pt_idx, -1).index_put(
            put, fo.pt_ids.reshape(-1))[:O],
        pt_ok=_sink(tab.pt_ok, False).index_put(
            put, torch.ones_like(place.reshape(-1)))[:O],
        pt_addcnt=addcnt.index_put(
            put, torch.ones(F * SAMPLE, dtype=i32, device=dev))[:O])

    # ---- 2. bookkeeping --------------------------------------------------
    upd = _sink(torch.zeros_like(tab.valid)).index_put(
        (tgt_row,), torch.ones_like(has_t))[:O]
    box_of_o = _sink(torch.zeros_like(tab.last_rect)).index_put(
        (tgt_row,), fo.box)[:O]
    cen_of_o = _sink(torch.zeros_like(tab.center)).index_put(
        (tgt_row,), fo.center)[:O]
    u1 = upd[:, None]
    tab = tab._replace(
        n_frames=torch.where(upd, tab.n_frames + 1, tab.n_frames),
        lastlast_frame=torch.where(upd, tab.last_frame, tab.lastlast_frame),
        last_frame=torch.where(upd, fid[0], tab.last_frame),
        lastlast_rect=torch.where(u1, tab.last_rect, tab.lastlast_rect),
        last_rect=torch.where(u1, box_of_o, tab.last_rect),
        cen_sum=torch.where(u1, tab.cen_sum + cen_of_o, tab.cen_sum),
        cen_sq=torch.where(u1, tab.cen_sq + cen_of_o * cen_of_o, tab.cen_sq))

    # ---- 3. projection culling (members outside the current box) ---------
    # only when the box is well inside the image (25 px margin,
    # `src/Object.cc:1540-1546`) and member seen <= 8 times
    margin_ok_f = ((fo.box[:, 0] > 25) & (fo.box[:, 1] > 25)
                   & (fo.box[:, 2] < W - 25) & (fo.box[:, 3] < H - 25))
    margin_of_o = _sink(torch.zeros_like(tab.valid)).index_put(
        (tgt_row,), margin_ok_f)[:O]
    pc = lie.se3_apply(tcw, pt_xyz[_clip0(tab.pt_idx)])
    uv = lie.project(cam, pc)
    u, v = uv[..., 0], uv[..., 1]
    in_img = (pc[..., 2] > 0.05) & (u > 0) & (u < W) & (v > 0) & (v < H)
    inside_box = ((u >= box_of_o[:, None, 0]) & (u <= box_of_o[:, None, 2])
                  & (v >= box_of_o[:, None, 1]) & (v <= box_of_o[:, None, 3]))
    cull_proj = (tab.pt_ok & in_img & ~inside_box & (tab.pt_addcnt <= 8)
                 & (upd & margin_of_o)[:, None])
    tab = tab._replace(pt_ok=tab.pt_ok & ~cull_proj)

    # ---- 4. creation ------------------------------------------------------
    create = (fo.valid & (assoc.target < 0) & ~fo.on_edge
              & (fo.n_pts >= oc.min_points_init))
    order = torch.cumsum(create.to(torch.int64), dim=0) - 1
    new_row = torch.where(create, tab.next_obj.long() + order, O)
    new_row = torch.where(new_row >= O, O, new_row)
    pad = MEMBERS - SAMPLE
    mem_ids = torch.cat([fo.pt_ids, torch.full((F, pad), -1, dtype=i32,
                                               device=dev)], dim=1)
    mem_ok = torch.cat([fo.pt_valid, torch.zeros((F, pad), dtype=torch.bool,
                                                 device=dev)], dim=1)
    def put_new(x, vals, fill=0):
        return _sink(x, fill).index_put((new_row,), vals)[:O]

    tab = tab._replace(
        cls=put_new(tab.cls, fo.cls),
        valid=put_new(tab.valid, torch.ones_like(create)),
        pt_idx=put_new(tab.pt_idx, mem_ids),
        pt_ok=put_new(tab.pt_ok, mem_ok),
        pt_addcnt=put_new(tab.pt_addcnt, mem_ok.to(i32)),
        n_frames=put_new(tab.n_frames, torch.ones_like(fo.cls)),
        last_frame=put_new(tab.last_frame, fid),
        lastlast_frame=put_new(tab.lastlast_frame, fid),
        last_rect=put_new(tab.last_rect, fo.box),
        lastlast_rect=put_new(tab.lastlast_rect, fo.box),
        cen_sum=put_new(tab.cen_sum, fo.center),
        cen_sq=put_new(tab.cen_sq, fo.center * fo.center),
        next_obj=torch.clamp(tab.next_obj + create.sum().to(i32), max=O))
    touched = upd | _sink(torch.zeros_like(tab.valid)).index_put(
        (new_row,), torch.ones_like(create))[:O]

    # ---- 5. stats + isolation forest -------------------------------------
    tab = member_stats(tab, pt_xyz)
    if oc.mode not in ("None", "NA") and not oc.iforest_keyframe_rate:
        tab = iforest_cull(tab, pt_xyz, rand, touched, cfg=cfg,
                           compact=oc.iforest_compact_rows)

    # ---- 6. co-occurrence + potential-association counters ---------------
    present = torch.zeros(O + 1, dtype=torch.bool, device=dev)
    present[torch.cat([tgt_row, new_row])] = True
    pvec = present[:O].to(i32)
    co = pvec[:, None] * pvec[None, :] * (1 - torch.eye(O, dtype=i32,
                                                        device=dev))
    pot = (assoc.potential & has_t[:, None]).to(i32)         # [F, O]
    add_re = torch.zeros((O + 1, O), dtype=i32, device=dev).index_add_(
        0, tgt_row, pot)[:O]
    return tab._replace(sametime=tab.sametime + co, reobj=tab.reobj + add_re)
