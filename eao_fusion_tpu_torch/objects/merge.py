"""Map-object merge and overlap resolution, keyframe-rate maintenance (port
of `eao_fusion_tpu/objects/merge.py`).

Re-design of `Object_Map::WhetherMergeTwoMapObjs` / `MergeTwoMapObjs` /
`WhetherOverlap` / `DealTwoOverlapObjs` / `BigToSmall` /
`DivideEquallyTwoObjs` (`src/Object.cc:1655-2228`) driven from the
LocalMapping thread (`src/LocalMapping.cc:798-883`). Sequential pairwise
merges become a small fixed number of one-pair-per-round passes (each
pass picks the strongest candidate), which converges across keyframes.

Merge gate parity note: the reference's double-t-test
(`DoubleSampleTtest`, :1708) pools MEANS instead of standard deviations,
and its result is irrelevant anyway because the caller merges whenever the
pair never co-appeared (:1681-1703). The effective behavior is kept:
reobj >= 3 and no co-appearance => merge, smaller object absorbed by the
bigger one.

The chosen pair stays on the device: a merge that does not fire is a
masked no-op, so a round reads nothing back to the host.
"""

from __future__ import annotations

from typing import Tuple

import torch

from eao_fusion_tpu_torch.config import SystemConfig
from eao_fusion_tpu_torch.objects.object_map import (ObjectTable, _clip0,
                                                     free_slots, member_stats)
from eao_fusion_tpu_torch.objects.update import Randoms, iforest_cull


def _absorb(tab: ObjectTable, big: torch.Tensor, small: torch.Tensor,
            pt_xyz: torch.Tensor, active: torch.Tensor) -> ObjectTable:
    """Merge row `small` into row `big` (0-dim tensors); no-op unless
    `active`."""
    O = tab.cls.shape[0]
    rows = torch.arange(O, device=tab.cls.device)
    is_big = (rows == big) & active                          # [O]
    is_small = (rows == small) & active

    # member transfer with the 1.1x-cuboid gate (`MergeTwoMapObjs` :1768-1778)
    sm_ids = tab.pt_idx[small]
    sm_ok = tab.pt_ok[small] & active
    cub_c = 0.5 * (tab.cub_min[big] + tab.cub_max[big])
    half = 0.55 * (tab.cub_max[big] - tab.cub_min[big])     # 1.1 * dims/2
    inside = ((pt_xyz[_clip0(sm_ids)] - cub_c).abs()
              <= half + 1e-6).all(dim=-1)
    # dedup vs big's members
    bg_ids, bg_ok = tab.pt_idx[big], tab.pt_ok[big]
    exists = ((sm_ids[:, None] == bg_ids[None, :]) & bg_ok[None, :]).any(1)
    place, slot = free_slots(bg_ok, sm_ok & inside & ~exists)
    M = bg_ok.shape[0]
    slot = torch.where(place, slot, M)                       # M = sink slot

    def put_row(row, vals, fill):
        return torch.cat([row, row.new_full((1,), fill)]).scatter(
            0, slot, vals)[:M]

    b = is_big[:, None]
    big_ids = put_row(bg_ids, sm_ids, -1)
    big_ok = put_row(bg_ok, torch.ones_like(place), False)
    big_cnt = put_row(tab.pt_addcnt[big], torch.ones_like(sm_ids), 0)

    # counters / recency bookkeeping
    more_recent = is_big & (tab.last_frame[small] > tab.last_frame[big])

    def add_small(x):
        return x + torch.where(is_big.reshape((O,) + (1,) * (x.dim() - 1)),
                               x[small], torch.zeros_like(x[small]))

    return tab._replace(
        pt_idx=torch.where(b, big_ids, tab.pt_idx),
        pt_ok=torch.where(b, big_ok, tab.pt_ok),
        pt_addcnt=torch.where(b, big_cnt, tab.pt_addcnt),
        n_frames=add_small(tab.n_frames),
        cen_sum=add_small(tab.cen_sum),
        cen_sq=add_small(tab.cen_sq),
        last_frame=torch.where(more_recent, tab.last_frame[small],
                               tab.last_frame),
        last_rect=torch.where(more_recent[:, None], tab.last_rect[small],
                              tab.last_rect),
        reobj=add_small(tab.reobj),
        sametime=add_small(tab.sametime),
        valid=tab.valid & ~is_small)


def _pair_volumes(tab: ObjectTable
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    vol = torch.clamp(tab.cub_max - tab.cub_min, min=0.0).prod(dim=-1)
    olo = torch.maximum(tab.cub_min[:, None, :], tab.cub_min[None, :, :])
    ohi = torch.minimum(tab.cub_max[:, None, :], tab.cub_max[None, :, :])
    odim = torch.clamp(ohi - olo, min=0.0)
    return vol, odim.prod(dim=-1), odim


def _best_pair(score: torch.Tensor):
    """(i, j, any): the first largest entry of score [O, O], and whether
    it is > 0."""
    O = score.shape[0]
    flat = torch.argmax(score.reshape(-1))
    return flat // O, flat % O, score.reshape(-1)[flat] > 0


def merge_and_overlap(tab: ObjectTable, pt_xyz: torch.Tensor, rand: Randoms,
                      *, cfg: SystemConfig, n_rounds: int = 3) -> ObjectTable:
    O = tab.cls.shape[0]
    neye = ~torch.eye(O, dtype=torch.bool, device=tab.cls.device)

    for _ in range(n_rounds):
        # ---------- potential-association merge (reobj >= 3, never
        # co-appearing) ----------
        cand = (tab.valid[:, None] & tab.valid[None, :] & neye
                & (tab.reobj >= 3) & (tab.sametime == 0))
        i0, j0, active = _best_pair(torch.where(cand, tab.reobj, -1))
        bigger = tab.n_frames[i0] >= tab.n_frames[j0]
        tab = _absorb(tab, torch.where(bigger, i0, j0),
                      torch.where(bigger, j0, i0), pt_xyz, active)
        # clear the processed counter either way
        reobj = tab.reobj.clone()
        reobj[i0, j0] = 0
        reobj[j0, i0] = 0
        tab = tab._replace(reobj=reobj)

        # ---------- cuboid overlap resolution ----------
        vol, ovol, _ = _pair_volumes(tab)
        overlapping = (tab.valid[:, None] & tab.valid[None, :] & neye
                       & (ovol > 1e-9))
        iou3 = ovol / torch.clamp(vol[:, None] + vol[None, :] - ovol,
                                  min=1e-9)
        b_iou = iou3 >= 0.3
        b_volume = ((vol[:, None] > 2 * vol[None, :])
                    | (vol[None, :] > 2 * vol[:, None]))
        b_same = tab.sametime > 3
        b_class = tab.cls[:, None] == tab.cls[None, :]
        case1 = overlapping & b_iou & ~b_volume & ~b_same & b_class
        case2 = overlapping & b_volume & ~b_same & b_class
        nf = tab.n_frames
        case5 = (overlapping & b_iou & ~b_same & b_class
                 & ((nf[:, None] // 2 >= nf[None, :])
                    | (nf[None, :] // 2 >= nf[:, None])))
        merge_pair = case1 | case5
        i1, j1, act2 = _best_pair(torch.where(merge_pair, ovol, -1.0))
        bigger2 = nf[i1] >= nf[j1]
        tab = _absorb(tab, torch.where(bigger2, i1, j1),
                      torch.where(bigger2, j1, i1), pt_xyz, act2)

        # case 2 (false detection): erase the smaller/less-observed one
        e_ij = (case2 & (nf[:, None] >= nf[None, :])
                & (vol[:, None] > vol[None, :]) & ~merge_pair)
        tab = tab._replace(valid=tab.valid & ~e_ij.any(dim=0))

    tab = member_stats(tab, pt_xyz)
    if cfg.objects.iforest_keyframe_rate and cfg.objects.mode not in (
            "None", "NA"):
        tab = iforest_cull(tab, pt_xyz, rand, cfg=cfg,
                           compact=cfg.objects.iforest_compact_rows)
    return tab
