"""Local mapping at keyframe rate: point culling, two-way fusion with the
covisible neighbours, window selection, local BA (with the window's plane
factors when planes are on), outlier observation removal, keyframe culling
and point-statistic refresh, and the monocular point creation by
epipolar triangulation (port of `eao_fusion_tpu/pipeline/local_mapping.py`).

Every top-k whose indices are used goes through `top_k_stable`:
covisibility counts tie constantly, and `lax.top_k` takes the lower index.
"""

from __future__ import annotations

from typing import Tuple

import torch

from eao_fusion_tpu_torch.config import SystemConfig
from eao_fusion_tpu_torch.frontend import matcher as fm
from eao_fusion_tpu_torch.mapping import covisibility
from eao_fusion_tpu_torch.mapping.map_state import (
    MapState, merge_obs_columns, refresh_obs_rows, set_rows,
    update_point_stats)
from eao_fusion_tpu_torch.ops import lie
from eao_fusion_tpu_torch.ops.topk import top_k_stable
from eao_fusion_tpu_torch.solvers import ba, triangulation
from eao_fusion_tpu_torch.types import FrameFeatures


def _neighbour_row(covis: torch.Tensor, m: MapState, kf_slot: int,
                   self_value: float) -> torch.Tensor:
    row = covis[kf_slot].clone()
    row[kf_slot] = self_value
    return torch.where(m.kf_valid, row, -1.0)


def create_points_mono(m: MapState, kf_slot: int, *,
                       cfg: SystemConfig) -> MapState:
    """Monocular point creation: epipolar triangulation of the unmatched
    keypoints of the new keyframe against its best covisible neighbours,
    one neighbour after another (`LocalMapping::CreateNewMapPoints`,
    `src/LocalMapping.cc:211-456`, with `SearchForTriangulation`). A
    neighbour with 10 or fewer shared points makes nothing (its gate is
    read once for all neighbours)."""
    cam = (cfg.camera.fx, cfg.camera.fy, cfg.camera.cx, cfg.camera.cy)
    s = cfg.orb.scale_factor
    dev = m.kf_pose.device
    covis = covisibility.covisibility_counts(
        covisibility.observation_indicator(m))
    row = _neighbour_row(covis, m, kf_slot, 0.0)
    _, nbrs = top_k_stable(row, cfg.capacity.triangulation_neighbors)
    ok_nb = ((covis[kf_slot, nbrs] > 10) & m.kf_valid[nbrs]
             & (nbrs != kf_slot)).tolist()
    lvl_a = m.kf_kp_level[kf_slot]
    centre = lie.se3_inverse(m.kf_pose[kf_slot])[4:7]
    for nb, ok in zip(nbrs.tolist(), ok_nb):
        if not ok:
            continue
        # unassociated keypoints on both sides
        va = m.kf_kp_valid[kf_slot] & (m.kf_pt_idx[kf_slot] < 0)
        vb = m.kf_kp_valid[nb] & (m.kf_pt_idx[nb] < 0)
        mm = fm.mutual_match(m.kf_desc_pm1[kf_slot], va,
                             m.kf_kp_angle[kf_slot], m.kf_desc_pm1[nb], vb,
                             m.kf_kp_angle[nb], th=cfg.matcher.th_low,
                             use_ratio=True, check_rotation=True)
        pair_ok = mm.target_idx >= 0
        jb = torch.clamp(mm.target_idx.long(), min=0)
        res = triangulation.triangulate_checked(
            m.kf_pose[kf_slot], m.kf_pose[nb], m.kf_kp_uv[kf_slot],
            m.kf_kp_uv[nb][jb], pair_ok, s ** (-2.0 * lvl_a.float()),
            s ** (-2.0 * m.kf_kp_level[nb][jb].float()), cam=cam)
        make = res.ok & pair_ok
        new_ids = m.next_pt + torch.cumsum(make.to(torch.int32), 0) - 1
        make = make & (new_ids < m.max_pt)          # writes past capacity drop
        new_ids = torch.where(make, new_ids, -1).to(torch.int32)
        tgt = new_ids[make].long()

        view = res.xyz - centre
        dist = torch.linalg.norm(view, dim=-1)
        max_d = dist * (s ** lvl_a.float()) * 1.2
        m = m._replace(
            pt_xyz=set_rows(m.pt_xyz, tgt, res.xyz[make]),
            pt_valid=set_rows(m.pt_valid, tgt, True),
            pt_desc_pm1=set_rows(m.pt_desc_pm1, tgt,
                                 m.kf_desc_pm1[kf_slot][make]),
            pt_normal=set_rows(m.pt_normal, tgt, (
                view / torch.clamp(dist[:, None], min=1e-9))[make]),
            pt_min_dist=set_rows(m.pt_min_dist, tgt,
                                 max_d[make] / (s ** cfg.orb.n_levels)),
            pt_max_dist=set_rows(m.pt_max_dist, tgt, max_d[make]),
            pt_ref_kf=set_rows(m.pt_ref_kf, tgt, int(kf_slot)),
            pt_found=set_rows(m.pt_found, tgt, 1),
            pt_visible=set_rows(m.pt_visible, tgt, 1),
            pt_first_frame=set_rows(m.pt_first_frame, tgt,
                                    m.kf_frame_id[kf_slot]),
            next_pt=torch.clamp(m.next_pt + make.sum().to(torch.int32),
                                max=m.max_pt))
        # the observations, in both keyframes
        kf_pt = m.kf_pt_idx.clone()
        kf_pt[kf_slot] = torch.where(make, new_ids, kf_pt[kf_slot])
        kf_pt[nb, jb[make]] = new_ids[make]
        m = m._replace(kf_pt_idx=kf_pt)
    return refresh_obs_rows(m, torch.cat([
        torch.tensor([kf_slot], device=dev), nbrs]))


def fuse_neighbors(m: MapState, kf_slot: int, *,
                   cfg: SystemConfig) -> MapState:
    """Duplicate map-point fusion with the top covisible keyframes, in both
    directions (new KF's points -> neighbour, neighbour's points -> new
    KF). A projection that lands on a keypoint with a matching descriptor
    merges the two points (the better-observed id wins) or adds the
    missing observation. All 2n directions are matched against the same
    pre-fuse state; the loser -> winner redirects compose in sequence."""
    cam = (cfg.camera.fx, cfg.camera.fy, cfg.camera.cx, cfg.camera.cy)
    W, H = cfg.camera.width, cfg.camera.height
    s = cfg.orb.scale_factor
    P = m.max_pt
    dev = m.kf_pose.device
    Z = covisibility.observation_indicator(m)
    covis = covisibility.covisibility_counts(Z)
    obs_count = torch.sum(Z, dim=0)
    row = _neighbour_row(covis, m, kf_slot, 0.0)
    n_fuse = cfg.capacity.fuse_neighbors
    _, nbrs = top_k_stable(row, n_fuse)
    ok_nb = ((covis[kf_slot, nbrs] > 15) & m.kf_valid[nbrs]
             & (nbrs != kf_slot)).tolist()
    nbrs_l = nbrs.tolist()

    def match_pair(src: int, dst: int):
        """Project src's tracked points into dst; per-dst-slot merge / add
        proposals (no state change)."""
        src_pt = m.kf_pt_idx[src]
        src_c = torch.clamp(src_pt.long(), min=0)
        src_ok = (src_pt >= 0) & m.pt_valid[src_c]
        dst_feats = FrameFeatures(
            uv=m.kf_kp_uv[dst], response=torch.ones_like(m.kf_kp_angle[dst]),
            level=m.kf_kp_level[dst], angle=m.kf_kp_angle[dst],
            desc_packed=None, desc_pm1=m.kf_desc_pm1[dst],
            valid=m.kf_kp_valid[dst], depth=m.kf_kp_depth[dst],
            uright=m.kf_kp_uright[dst])
        lvl = m.kf_kp_level[src]
        res = fm.match_points_to_frame(
            m.pt_xyz[src_c], m.kf_desc_pm1[src], src_ok,
            m.kf_kp_angle[src], lvl, 3.0 * s ** lvl.float(), lvl - 1,
            lvl + 1, dst_feats, m.kf_pose[dst], cam=cam, width=W, height=H,
            th=cfg.matcher.th_low, check_rotation=False)
        has = res.target_idx >= 0
        pt_new = src_pt[torch.clamp(res.target_idx.long(), min=0)]
        pt_old = m.kf_pt_idx[dst]
        new_c = torch.clamp(pt_new.long(), min=0)
        old_c = torch.clamp(pt_old.long(), min=0)
        both = has & (pt_old >= 0) & (pt_new != pt_old) & m.pt_valid[old_c]
        keep_new = obs_count[new_c] >= obs_count[old_c]
        winner = torch.where(both, torch.where(keep_new, pt_new, pt_old), -1)
        loser = torch.where(both, torch.where(keep_new, pt_old, pt_new), -1)
        add = torch.where(has & (pt_old < 0), pt_new, -1)
        return winner, loser, add

    pairs = ([(kf_slot, nb, ok) for nb, ok in zip(nbrs_l, ok_nb)]
             + [(nb, kf_slot, ok) for nb, ok in zip(nbrs_l, ok_nb)])
    ident = torch.arange(P + 1, dtype=torch.int64, device=dev)
    total = ident
    pt_valid = m.pt_valid.clone()
    adds = []
    for src, dst, ok in pairs:
        if not ok:
            # a pair that fails the gate proposes nothing
            continue
        winner, loser, add = match_pair(src, dst)
        sel = loser >= 0
        r = ident.clone()
        r[loser[sel].long()] = winner[sel].long()
        total = r[total]            # this map applies after the earlier ones
        pt_valid[loser[sel].long()] = False
        adds.append((dst, add))
    kf_pt = torch.where(m.kf_pt_idx >= 0,
                        total[torch.clamp(m.kf_pt_idx.long(), min=0)],
                        m.kf_pt_idx.long()).to(torch.int32)
    for dst, add in adds:
        row_d = kf_pt[dst]
        new = total[torch.clamp(add.long(), min=0)].to(torch.int32)
        kf_pt[dst] = torch.where((add >= 0) & (row_d < 0), new, row_d)
    m = m._replace(kf_pt_idx=kf_pt, pt_valid=pt_valid)
    m = merge_obs_columns(m, total[:P].to(torch.int32))
    rows = torch.cat([torch.tensor([kf_slot], device=dev), nbrs])
    return refresh_obs_rows(m, rows)


def cull_keyframes(m: MapState, cur_kf: int, redundancy: float = 0.9,
                   max_cull: int = 3) -> MapState:
    """KeyFrame culling: a covisible keyframe goes when > 90% of its points
    are seen by at least 3 other keyframes; keyframe 0, the two newest and
    object-created keyframes are kept. Up to `max_cull` victims, most
    redundant first, recounting between victims."""
    kf_valid = m.kf_valid
    idx = torch.arange(m.max_kf, device=kf_valid.device)
    for _ in range(max_cull):
        Z = (m.obs_ind & kf_valid[:, None]).float()
        covis = Z @ Z.T
        obs_count = torch.sum(Z, dim=0)
        pv = m.pt_valid.float()
        red = (m.pt_valid & (obs_count >= 4.0)).float()
        counts = Z @ torch.stack([pv, red], dim=-1)
        n_tracked = counts[:, 0]
        ratio = counts[:, 1] / torch.clamp(n_tracked, min=1.0)
        local = covis[cur_kf] >= 15
        cand = (kf_valid & local & (ratio > redundancy) & (n_tracked > 20)
                & (~m.kf_by_obj) & (idx != 0) & (idx < m.next_kf - 2))
        victim = torch.argmax(torch.where(cand, ratio, -1.0))
        kf_valid = kf_valid.clone()
        kf_valid[victim] = kf_valid[victim] & (~torch.any(cand))
    return m._replace(kf_valid=kf_valid)


def cull_points(m: MapState, cur_kf: int, min_obs: int = 2) -> MapState:
    """MapPointCulling: only points created within the last 3 keyframes are
    tested (found/visible < 0.25, or fewer than `min_obs` keyframes after
    2); points with no observation at all go regardless."""
    Z = covisibility.observation_indicator(m)
    obs = torch.sum(Z, dim=0)
    age = cur_kf - m.pt_ref_kf
    recent = (m.pt_ref_kf >= 0) & (age >= 0) & (age <= 3)
    ratio_bad = recent & (m.pt_visible >= 4) & (
        m.pt_found.float() < 0.25 * m.pt_visible.float())
    young_weak = recent & (age >= 2) & (obs < min_obs)
    cull = m.pt_valid & (ratio_bad | young_weak | (obs < 1))
    return m._replace(pt_valid=m.pt_valid & (~cull))


def _select_window(m: MapState, kf_slot: int, n_local: int, n_fixed: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """(kf_idx [C], sel_valid [C], fixed [C], local_pts [P]); local
    keyframes first, then the best-connected frontier keyframes (fixed)."""
    Z = covisibility.observation_indicator(m)
    covis = covisibility.covisibility_counts(Z)
    row = _neighbour_row(covis, m, kf_slot, 1e9)       # self always first
    loc_val, loc_idx = top_k_stable(row, n_local)
    local_ok = loc_val > 0.0
    local_mask = torch.zeros((m.max_kf,), dtype=torch.bool,
                             device=row.device)
    local_mask[loc_idx[local_ok]] = True
    local_pts = covisibility.points_of_keyframes(Z, local_mask)
    votes = Z @ local_pts.float()
    votes = torch.where(m.kf_valid & (~local_mask), votes, -1.0)
    fix_val, fix_idx = top_k_stable(votes, n_fixed)
    fixed_ok = fix_val > 0.0

    kf_idx = torch.cat([loc_idx, fix_idx])
    sel_valid = torch.cat([local_ok, fixed_ok])
    fixed = torch.cat([torch.zeros((n_local,), dtype=torch.bool,
                                   device=row.device),
                       torch.ones((n_fixed,), dtype=torch.bool,
                                  device=row.device)])
    # gauge anchoring: with no frontier keyframe, fix the oldest local one
    no_fix = ~torch.any(fixed_ok)
    oldest = torch.argmin(torch.where(local_ok, kf_idx[:n_local], 1 << 30))
    fixed[oldest] = fixed[oldest] | no_fix
    fixed = fixed | (kf_idx == 0)          # keyframe 0 anchors the world
    return kf_idx, sel_valid, fixed, local_pts


def local_mapping_step(m: MapState, kf_slot: int, *,
                       cfg: SystemConfig) -> MapState:
    cam5 = (cfg.camera.fx, cfg.camera.fy, cfg.camera.cx, cfg.camera.cy,
            cfg.camera.bf)
    m = cull_points(m, kf_slot, min_obs=3 if cfg.sensor == "mono" else 2)
    m = fuse_neighbors(m, kf_slot, cfg=cfg)

    n_fixed = 8
    n_local = cfg.capacity.max_local_ba_kfs - n_fixed
    kf_idx, sel_valid, fixed, local_pts = _select_window(
        m, kf_slot, n_local, n_fixed)

    # window compaction: a compact [Pw] point table and [E] edge list
    N = m.kf_pt_idx.shape[1]
    C = kf_idx.shape[0]
    P = m.max_pt
    Pw = min(cfg.capacity.max_local_ba_points, P)
    E = min(cfg.capacity.max_local_ba_obs, C * N)
    dev = kf_idx.device
    sel = m.pt_valid & local_pts
    widx = torch.argsort((~sel).to(torch.int8), stable=True)[:Pw]
    wvalid = sel[widx]
    lut = torch.full((P,), -1, dtype=torch.int32, device=dev)
    lut[widx[wvalid]] = torch.arange(Pw, dtype=torch.int32,
                                     device=dev)[wvalid]

    obs_pt_dense = m.kf_pt_idx[kf_idx]                        # [C, N]
    pid_w = lut[torch.clamp(obs_pt_dense.long(), min=0)]
    obs_ok = (m.kf_kp_valid[kf_idx] & (obs_pt_dense >= 0) & (pid_w >= 0)
              & (sel_valid & m.kf_valid[kf_idx])[:, None])
    flat_ok = obs_ok.reshape(-1)
    eidx = torch.argsort((~flat_ok).to(torch.int8), stable=True)[:E]
    e_ok = flat_ok[eidx]
    e_cam = (eidx // N).to(torch.int32)
    e_slot = (eidx % N)
    lvl = m.kf_kp_level[kf_idx].reshape(-1)[eidx].float()
    # freeze under-constrained window cameras, counting the edges the
    # solver gets: the [E] cap keeps edges in window order, so it can leave
    # a late camera with none, held by its plane factors alone (a singular
    # block; local BA then throws that keyframe metres, or to 1e11 m, at the
    # production tables). The JAX package counts before the cap; below the
    # cap the two counts are the same.
    starved = (torch.bincount(e_cam[e_ok].long(), minlength=C)
               < cfg.solver.min_cam_obs)
    prob = ba.BACooProblem(
        cam_pose=m.kf_pose[kf_idx],
        cam_valid=sel_valid & m.kf_valid[kf_idx],
        cam_fixed=fixed | starved,
        pt_xyz=m.pt_xyz[widx],
        pt_valid=wvalid,
        obs_cam=e_cam,
        obs_pt=torch.where(e_ok, pid_w.reshape(-1)[eidx], -1),
        obs_uv=m.kf_kp_uv[kf_idx].reshape(-1, 2)[eidx],
        obs_ur=m.kf_kp_uright[kf_idx].reshape(-1)[eidx],
        obs_inv_sigma2=cfg.orb.scale_factor ** (-2.0 * lvl),
        obs_valid=e_ok,
    )
    plane_block = None
    if cfg.use_planes:
        # fixed-plane factors of the window keyframes' plane observations
        pl_idx = m.kf_pl_idx[kf_idx]                          # [C, F]
        pl_c = torch.clamp(pl_idx.long(), min=0)
        pl_ok = (pl_idx >= 0) & m.pl_valid[pl_c] & sel_valid[:, None]
        plane_block = (m.pl_coeff[pl_c], m.kf_pl_coeff[kf_idx], pl_ok)
    res = ba.bundle_adjust_coo(prob, plane_block, cam=cam5, cfg=cfg.solver,
                               n_iters1=cfg.solver.local_ba_iters_first,
                               n_iters2=cfg.solver.local_ba_iters_second,
                               ftol=cfg.solver.local_ba_ftol)

    # write optimized poses / points back (updated, valid, non-fixed slots)
    upd = sel_valid & (~fixed)
    m = m._replace(
        kf_pose=set_rows(m.kf_pose, kf_idx[upd], res.cam_pose[upd]),
        pt_xyz=set_rows(m.pt_xyz, widx[wvalid], res.pt_xyz[wvalid]))

    # remove outlier observations from the window keyframes
    clear = e_ok & (~res.obs_inlier)
    m = m._replace(kf_pt_idx=set_rows(
        m.kf_pt_idx, (kf_idx[e_cam.long()][clear], e_slot[clear]), -1))

    m = refresh_obs_rows(m, kf_idx)
    m = cull_keyframes(m, kf_slot)
    m = update_point_stats(m)
    # the full-table descriptor vote is amortized: every 4th keyframe
    if kf_slot % 4 == 0:
        m = refresh_point_descriptors(m)
    return m


def refresh_point_descriptors(m: MapState) -> MapState:
    """Hamming-space centroid: per-bit majority vote over all keyframe
    observations of each point (zero-vote bits keep the old bit)."""
    K, N = m.kf_pt_idx.shape
    pt = m.kf_pt_idx.reshape(-1).long()
    ok = (pt >= 0) & m.kf_valid.repeat_interleave(N)
    tgt = torch.where(ok, pt, m.max_pt)
    votes = torch.zeros((m.max_pt + 1, 256), device=pt.device).index_add_(
        0, tgt, m.kf_desc_pm1.reshape(-1, 256).float()
        * ok[:, None].float())[:m.max_pt]
    have = torch.any(votes != 0.0, dim=-1)
    desc = torch.where(votes > 0, 1, -1).to(torch.int8)
    desc = torch.where(votes == 0, m.pt_desc_pm1, desc)
    return m._replace(pt_desc_pm1=torch.where(
        (m.pt_valid & have)[:, None], desc, m.pt_desc_pm1))
