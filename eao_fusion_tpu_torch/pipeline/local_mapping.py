"""Local mapping at keyframe rate: point culling, two-way fusion with the
covisible neighbours, window selection, local BA (with the window's plane
factors when planes are on), outlier observation removal, keyframe culling
and point-statistic refresh, and the monocular point creation by
epipolar triangulation (port of `eao_fusion_tpu/pipeline/local_mapping.py`).

Every top-k whose indices are used goes through `top_k_stable`:
covisibility counts tie constantly, and `lax.top_k` takes the lower index.

`local_mapping_step` reads the host nothing (no device -> host sync): the
keyframe slot is a device index, a masked write goes to a spare row, the
fusion's 2n pairs all run with the gated-out ones masked. So on a card its
stages run as CUDA graphs (`utils/graphs`), captured at the first
keyframe of a shape and replayed after, and the host launches between
them only local BA's hand-written kernels; on the CPU the same body runs
eagerly.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from eao_fusion_tpu_torch.config import SystemConfig
from eao_fusion_tpu_torch.frontend import matcher as fm
from eao_fusion_tpu_torch.mapping import covisibility
from eao_fusion_tpu_torch.mapping.map_state import (
    MapState, merge_obs_columns, refresh_obs_rows, set_rows, set_rows_where,
    update_point_stats)
from eao_fusion_tpu_torch.ops import lie
from eao_fusion_tpu_torch.ops.scatter import put_last
from eao_fusion_tpu_torch.ops.topk import top_k_stable
from eao_fusion_tpu_torch.solvers import ba, triangulation
from eao_fusion_tpu_torch.types import FrameFeatures
from eao_fusion_tpu_torch.utils import graphs, profiling

Slot = Union[int, torch.Tensor]

# the MapState fields local mapping reads; it writes some of them
_FIELDS = ("kf_pose", "kf_valid", "kf_kp_uv", "kf_kp_level", "kf_kp_angle",
           "kf_kp_depth", "kf_kp_uright", "kf_kp_valid", "kf_desc_pm1",
           "kf_pt_idx", "kf_by_obj", "pt_xyz", "pt_valid", "pt_normal",
           "pt_ref_kf", "pt_found", "pt_visible", "pl_coeff", "pl_valid",
           "kf_pl_coeff", "kf_pl_idx", "obs_ind", "next_kf")


def _slot_index(kf_slot: Slot, device) -> torch.Tensor:
    """The keyframe slot as a [1] int64 index on the device: a Python int
    is filled in (no copy from the host), a tensor taken as it is."""
    if isinstance(kf_slot, torch.Tensor):
        return kf_slot.reshape(1).long()
    return torch.full((1,), int(kf_slot), dtype=torch.int64, device=device)


def _neighbour_row(covis: torch.Tensor, m: MapState, slot: torch.Tensor,
                   self_value: float) -> torch.Tensor:
    row = covis[slot][0].index_fill(0, slot, self_value)
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
    row = _neighbour_row(covis, m, _slot_index(kf_slot, dev), 0.0)
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


def fuse_neighbors(m: MapState, kf_slot: Slot, *,
                   cfg: SystemConfig) -> MapState:
    """Duplicate map-point fusion with the top covisible keyframes, in both
    directions (new KF's points -> neighbour, neighbour's points -> new
    KF). A projection that lands on a keypoint with a matching descriptor
    merges the two points (the better-observed id wins) or adds the
    missing observation. All 2n directions are matched against the same
    pre-fuse state; the loser -> winner redirects compose in sequence. A
    pair whose neighbour fails the gate runs masked and proposes nothing
    (the identity redirect, no adds), so nothing is read on the host."""
    cam = (cfg.camera.fx, cfg.camera.fy, cfg.camera.cx, cfg.camera.cy)
    W, H = cfg.camera.width, cfg.camera.height
    s = cfg.orb.scale_factor
    P = m.max_pt
    dev = m.kf_pose.device
    slot = _slot_index(kf_slot, dev)
    Z = covisibility.observation_indicator(m)
    covis = covisibility.covisibility_counts(Z)
    obs_count = torch.sum(Z, dim=0)
    row = _neighbour_row(covis, m, slot, 0.0)
    n_fuse = cfg.capacity.fuse_neighbors
    _, nbrs = top_k_stable(row, n_fuse)
    ok_nb = ((covis[slot][0][nbrs] > 15) & m.kf_valid[nbrs]
             & (nbrs != slot))

    def match_pair(src: torch.Tensor, dst: torch.Tensor, ok: torch.Tensor):
        """Project src's tracked points into dst ([1] slot indices);
        per-dst-slot merge / add proposals (no state change), none unless
        `ok`."""
        src_pt = m.kf_pt_idx[src][0]
        src_c = torch.clamp(src_pt.long(), min=0)
        src_ok = (src_pt >= 0) & m.pt_valid[src_c]
        dst_feats = FrameFeatures(
            uv=m.kf_kp_uv[dst][0],
            response=torch.ones_like(m.kf_kp_angle[dst][0]),
            level=m.kf_kp_level[dst][0], angle=m.kf_kp_angle[dst][0],
            desc_packed=None, desc_pm1=m.kf_desc_pm1[dst][0],
            valid=m.kf_kp_valid[dst][0], depth=m.kf_kp_depth[dst][0],
            uright=m.kf_kp_uright[dst][0])
        lvl = m.kf_kp_level[src][0]
        res = fm.match_points_to_frame(
            m.pt_xyz[src_c], m.kf_desc_pm1[src][0], src_ok,
            m.kf_kp_angle[src][0], lvl, 3.0 * s ** lvl.float(), lvl - 1,
            lvl + 1, dst_feats, m.kf_pose[dst][0], cam=cam, width=W,
            height=H, th=cfg.matcher.th_low, check_rotation=False)
        has = ok & (res.target_idx >= 0)
        pt_new = src_pt[torch.clamp(res.target_idx.long(), min=0)]
        pt_old = m.kf_pt_idx[dst][0]
        new_c = torch.clamp(pt_new.long(), min=0)
        old_c = torch.clamp(pt_old.long(), min=0)
        both = has & (pt_old >= 0) & (pt_new != pt_old) & m.pt_valid[old_c]
        keep_new = obs_count[new_c] >= obs_count[old_c]
        winner = torch.where(both, torch.where(keep_new, pt_new, pt_old), -1)
        loser = torch.where(both, torch.where(keep_new, pt_old, pt_new), -1)
        add = torch.where(has & (pt_old < 0), pt_new, -1)
        return winner, loser, add

    rep = slot.expand(n_fuse)
    srcs = torch.cat([rep, nbrs])
    dsts = torch.cat([nbrs, rep])
    oks = torch.cat([ok_nb, ok_nb])
    ident = torch.arange(P + 1, dtype=torch.int64, device=dev)
    total = ident
    # slot P of the redirect and of the validity is a spare: what does not
    # merge writes there
    pt_valid = torch.cat([m.pt_valid, m.pt_valid.new_ones((1,))])
    adds = []
    # every pair runs: one that fails the gate proposes nothing
    for i in range(2 * n_fuse):
        dst = dsts[i:i + 1]
        winner, loser, add = match_pair(srcs[i:i + 1], dst, oks[i])
        sel = loser >= 0
        lose = torch.where(sel, loser.long(), P)
        r = put_last(ident.clone(), lose, torch.where(sel, winner.long(), P))
        total = r[total]            # this map applies after the earlier ones
        pt_valid.index_fill_(0, lose, False)
        adds.append((dst, add))
    kf_pt = torch.where(m.kf_pt_idx >= 0,
                        total[torch.clamp(m.kf_pt_idx.long(), min=0)],
                        m.kf_pt_idx.long()).to(torch.int32)
    for dst, add in adds:
        row_d = kf_pt[dst][0]
        new = total[torch.clamp(add.long(), min=0)].to(torch.int32)
        kf_pt[dst] = torch.where((add >= 0) & (row_d < 0), new, row_d)[None]
    m = m._replace(kf_pt_idx=kf_pt, pt_valid=pt_valid[:P])
    m = merge_obs_columns(m, total[:P].to(torch.int32))
    return refresh_obs_rows(m, torch.cat([slot, nbrs]))


def cull_keyframes(m: MapState, cur_kf: Slot, redundancy: float = 0.9,
                   max_cull: int = 3) -> MapState:
    """KeyFrame culling: a covisible keyframe goes when > 90% of its points
    are seen by at least 3 other keyframes; keyframe 0, the two newest and
    object-created keyframes are kept. Up to `max_cull` victims, most
    redundant first, recounting between victims."""
    kf_valid = m.kf_valid
    idx = torch.arange(m.max_kf, device=kf_valid.device)
    slot = _slot_index(cur_kf, kf_valid.device)
    for _ in range(max_cull):
        Z = (m.obs_ind & kf_valid[:, None]).float()
        covis = Z @ Z.T
        obs_count = torch.sum(Z, dim=0)
        pv = m.pt_valid.float()
        red = (m.pt_valid & (obs_count >= 4.0)).float()
        counts = Z @ torch.stack([pv, red], dim=-1)
        n_tracked = counts[:, 0]
        ratio = counts[:, 1] / torch.clamp(n_tracked, min=1.0)
        local = covis[slot][0] >= 15
        cand = (kf_valid & local & (ratio > redundancy) & (n_tracked > 20)
                & (~m.kf_by_obj) & (idx != 0) & (idx < m.next_kf - 2))
        victim = torch.argmax(torch.where(cand, ratio, -1.0))
        kf_valid = kf_valid & ~((idx == victim) & torch.any(cand))
    return m._replace(kf_valid=kf_valid)


def cull_points(m: MapState, cur_kf: Slot, min_obs: int = 2) -> MapState:
    """MapPointCulling: only points created within the last 3 keyframes are
    tested (found/visible < 0.25, or fewer than `min_obs` keyframes after
    2); points with no observation at all go regardless."""
    Z = covisibility.observation_indicator(m)
    obs = torch.sum(Z, dim=0)
    age = _slot_index(cur_kf, obs.device)[0] - m.pt_ref_kf
    recent = (m.pt_ref_kf >= 0) & (age >= 0) & (age <= 3)
    ratio_bad = recent & (m.pt_visible >= 4) & (
        m.pt_found.float() < 0.25 * m.pt_visible.float())
    young_weak = recent & (age >= 2) & (obs < min_obs)
    cull = m.pt_valid & (ratio_bad | young_weak | (obs < 1))
    return m._replace(pt_valid=m.pt_valid & (~cull))


def _select_window(m: MapState, slot: torch.Tensor, n_local: int,
                   n_fixed: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """(kf_idx [C], sel_valid [C], fixed [C], local_pts [P]); local
    keyframes first, then the best-connected frontier keyframes (fixed)."""
    Z = covisibility.observation_indicator(m)
    covis = covisibility.covisibility_counts(Z)
    K = m.max_kf
    row = _neighbour_row(covis, m, slot, 1e9)          # self always first
    loc_val, loc_idx = top_k_stable(row, n_local)
    local_ok = loc_val > 0.0
    local_mask = torch.zeros((K + 1,), dtype=torch.bool, device=row.device)
    local_mask.index_fill_(0, torch.where(local_ok, loc_idx, K), True)
    local_mask = local_mask[:K]
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
    fixed = fixed | ((torch.arange(n_local + n_fixed, device=row.device)
                      == oldest) & no_fix)
    fixed = fixed | (kf_idx == 0)          # keyframe 0 anchors the world
    return kf_idx, sel_valid, fixed, local_pts


def _window(ws: graphs.Workspace, cfg: SystemConfig) -> None:
    """Window selection and compaction into local BA's problem: a compact
    [Pw] point table and [E] edge list, with the window keyframes' plane
    factors when planes are on; into the workspace (`kf_idx`, `sel_valid`,
    `fixed`, `widx`, `wvalid`, `e_ok`, `e_cam`, `e_slot`, `prob_<field>`
    of `BACooProblem`, `pl_w`, `pl_meas`, `pl_ok`)."""
    m = ws.m
    n_fixed = 8
    n_local = cfg.capacity.max_local_ba_kfs - n_fixed
    kf_idx, sel_valid, fixed, local_pts = _select_window(
        m, ws.slot, n_local, n_fixed)
    N = m.kf_pt_idx.shape[1]
    C = kf_idx.shape[0]
    P = m.max_pt
    Pw = min(cfg.capacity.max_local_ba_points, P)
    E = min(cfg.capacity.max_local_ba_obs, C * N)
    dev = kf_idx.device
    sel = m.pt_valid & local_pts
    widx = torch.argsort((~sel).to(torch.int8), stable=True)[:Pw]
    wvalid = sel[widx]
    lut = torch.full((P + 1,), -1, dtype=torch.int32, device=dev)
    lut[torch.where(wvalid, widx, P)] = torch.arange(    # P: a spare
        Pw, dtype=torch.int32, device=dev)
    lut = lut[:P]

    obs_pt_dense = m.kf_pt_idx[kf_idx]                            # [C, N]
    pid_w = lut[torch.clamp(obs_pt_dense.long(), min=0)]
    obs_ok = (m.kf_kp_valid[kf_idx] & (obs_pt_dense >= 0) & (pid_w >= 0)
              & (sel_valid & m.kf_valid[kf_idx])[:, None])
    flat_ok = obs_ok.reshape(-1)
    eidx = torch.argsort((~flat_ok).to(torch.int8), stable=True)[:E]
    e_ok = flat_ok[eidx]
    e_cam = (eidx // N).to(torch.int32)
    lvl = m.kf_kp_level[kf_idx].reshape(-1)[eidx].float()
    # freeze under-constrained window cameras, counting the edges the
    # solver gets: the [E] cap keeps edges in window order, so it can
    # leave a late camera with none, held by its plane factors alone (a
    # singular block; local BA then throws that keyframe metres, or to
    # 1e11 m, at the production tables). The JAX package counts before
    # the cap; below the cap the two counts are the same.
    n_cam = torch.zeros((C,), dtype=torch.int64, device=dev).scatter_add_(
        0, e_cam.long(), e_ok.long())
    starved = n_cam < cfg.solver.min_cam_obs
    for name, t in (("kf_idx", kf_idx), ("sel_valid", sel_valid),
                    ("fixed", fixed), ("widx", widx), ("wvalid", wvalid),
                    ("e_ok", e_ok), ("e_cam", e_cam), ("e_slot", eidx % N)):
        ws.put(name, t)
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
    for name, t in prob._asdict().items():
        ws.put("prob_" + name, t)
    if cfg.use_planes:
        # fixed-plane factors of the window keyframes' plane observations
        pl_idx = m.kf_pl_idx[kf_idx]                              # [C, F]
        pl_c = torch.clamp(pl_idx.long(), min=0)
        ws.put("pl_w", m.pl_coeff[pl_c])
        ws.put("pl_meas", m.kf_pl_coeff[kf_idx])
        ws.put("pl_ok", (pl_idx >= 0) & m.pl_valid[pl_c] & sel_valid[:, None])


def _writeback(ws: graphs.Workspace) -> MapState:
    """Local BA's answer (`res_cam`, `res_pt`, `res_inlier`) written back
    to the updated, valid, non-fixed keyframes and the window's points,
    its outlier observations removed; then the window's indicator rows,
    keyframe culling and the point statistics."""
    m = ws.m
    K, N = m.kf_pt_idx.shape
    kf_idx = ws.kf_idx
    upd = ws.sel_valid & (~ws.fixed)
    m = m._replace(
        kf_pose=set_rows_where(m.kf_pose, kf_idx, upd, ws.res_cam),
        pt_xyz=set_rows_where(m.pt_xyz, ws.widx, ws.wvalid, ws.res_pt))
    # remove outlier observations from the window keyframes
    clear = ws.e_ok & (~ws.res_inlier)
    flat = set_rows_where(m.kf_pt_idx.reshape(-1),
                          kf_idx[ws.e_cam.long()] * N + ws.e_slot, clear, -1)
    m = m._replace(kf_pt_idx=flat.reshape(K, N))
    m = refresh_obs_rows(m, kf_idx)
    m = cull_keyframes(m, ws.slot)
    return update_point_stats(m)


def local_mapping_step(m: MapState, kf_slot: int, *,
                       cfg: SystemConfig) -> MapState:
    """Point culling, fusion with the covisible neighbours, local BA on the
    window and the write-back, for the new keyframe `kf_slot`.

    The fields it reads (`_FIELDS`) are copied into the workspace of the
    map's shapes and `cfg`, each stage updates them there (the other
    fields are None inside: a stage that reads one fails at once), and
    the fields written come back out as new tensors. On a card every stage
    but local BA's kernels is a graph replay (`utils/graphs`); local BA is
    called through the `ba` module, with the workspace's problem."""
    cam5 = (cfg.camera.fx, cfg.camera.fy, cfg.camera.cx, cfg.camera.cy,
            cfg.camera.bf)
    dev = m.kf_pose.device
    key = ("local_mapping_step", dev, cfg) + tuple(
        (getattr(m, f).dtype, tuple(getattr(m, f).shape)) for f in _FIELDS)
    ws = graphs.workspace(key, dev)
    for f in _FIELDS:
        ws.put(f, getattr(m, f))
    if "m" not in ws:
        ws.m = MapState(**{f: getattr(ws, f) if f in _FIELDS else None
                           for f in MapState._fields})
        ws.slot = torch.zeros((1,), dtype=torch.int64, device=dev)
        ws.written = set()
    ws.slot.fill_(kf_slot)

    def write(out: MapState) -> None:
        for f in _FIELDS:
            t = getattr(out, f)
            if t is not getattr(ws.m, f):
                getattr(ws.m, f).copy_(t)
                ws.written.add(f)

    with profiling.span("mapping.cull_points"):
        ws.run("cull_points", lambda: write(cull_points(
            ws.m, ws.slot, min_obs=3 if cfg.sensor == "mono" else 2)))
    with profiling.span("mapping.fuse"):
        ws.run("fuse", lambda: write(fuse_neighbors(ws.m, ws.slot, cfg=cfg)))
    with profiling.span("mapping.window"):
        ws.run("window", lambda: _window(ws, cfg))
        prob = ba.BACooProblem(*(getattr(ws, "prob_" + f)
                                 for f in ba.BACooProblem._fields))
        plane_block = ((ws.pl_w, ws.pl_meas, ws.pl_ok) if cfg.use_planes
                       else None)
    with profiling.span("mapping.local_ba"):
        res = ba.bundle_adjust_coo(prob, plane_block, cam=cam5, cfg=cfg.solver,
                                   n_iters1=cfg.solver.local_ba_iters_first,
                                   n_iters2=cfg.solver.local_ba_iters_second,
                                   ftol=cfg.solver.local_ba_ftol)

    with profiling.span("mapping.writeback"):
        ws.put("res_cam", res.cam_pose)
        ws.put("res_pt", res.pt_xyz)
        ws.put("res_inlier", res.obs_inlier)
        ws.run("writeback", lambda: write(_writeback(ws)))
        m = m._replace(**{f: getattr(ws.m, f).clone() if ws.graphs_on
                          else getattr(ws.m, f) for f in ws.written})
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
