"""Per-frame tracking: motion-model search -> pose GN -> local-map search ->
pose GN -> keyframe decision (port of `eao_fusion_tpu/pipeline/tracking.py`).

The map is read-only here except for the found / visible counters. The
two `lax.cond`s of the JAX function (the doubled-window retry and the
reference-keyframe fallback, `tracking.py:126,148`) become host branches:
each reads one match count with `.item()` and runs only the branch taken,
instead of computing both sides.

The steps along the map's landmark axis (point and keyframe row reads,
the covisibility votes, the local-map search, the found / visible marks)
go through a `WholeMap`, which runs them on a map this process holds
whole. `parallel/sharded_step.ShardedMap` runs the same steps on one row
block of a map split over the ranks of a mesh.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from eao_fusion_tpu_torch.config import SystemConfig
from eao_fusion_tpu_torch.frontend import matcher
from eao_fusion_tpu_torch.mapping import covisibility, plane_map
from eao_fusion_tpu_torch.mapping.map_state import MapState
from eao_fusion_tpu_torch.ops import lie
from eao_fusion_tpu_torch.solvers import pose_opt
from eao_fusion_tpu_torch.types import (FramePlanes, FrameFeatures,
                                        to_tensor, tree_from_numpy)

STATUS_UNINIT = 0
STATUS_OK = 1
STATUS_LOST = 2


class TrackState(NamedTuple):
    pose: torch.Tensor         # [7] current Tcw
    velocity: torch.Tensor     # [7] Tcw_t ∘ Twc_{t-1}
    last_pose: torch.Tensor    # [7]
    last_feats: FrameFeatures
    kp_pt: torch.Tensor        # [N] int32: kp slot -> map point id
    ref_kf: torch.Tensor       # [] int32
    n_inliers: torch.Tensor    # [] int32
    status: torch.Tensor       # [] int32
    frame_id: torch.Tensor     # [] int32
    last_kf_frame_id: torch.Tensor  # [] int32


def _empty_feats(cfg: SystemConfig, device) -> FrameFeatures:
    n = cfg.orb.max_keypoints
    z = dict(device=device)
    return FrameFeatures(
        uv=torch.zeros((n, 2), **z), response=torch.zeros((n,), **z),
        level=torch.zeros((n,), dtype=torch.int32, **z),
        angle=torch.zeros((n,), **z),
        desc_packed=torch.zeros((n, 8), dtype=torch.int32, **z),
        desc_pm1=torch.zeros((n, 256), dtype=torch.int8, **z),
        valid=torch.zeros((n,), dtype=torch.bool, **z),
        depth=torch.zeros((n,), **z), uright=torch.full((n,), -1.0, **z))


def _i32(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int32, device=device)


def init_track_state(cfg: SystemConfig, device) -> TrackState:
    n = cfg.orb.max_keypoints
    ident = lie.se3_identity(device=device)
    return TrackState(
        pose=ident, velocity=ident, last_pose=ident,
        last_feats=_empty_feats(cfg, device),
        kp_pt=torch.full((n,), -1, dtype=torch.int32, device=device),
        ref_kf=_i32(0, device), n_inliers=_i32(0, device),
        status=_i32(STATUS_UNINIT, device),
        frame_id=_i32(-1, device), last_kf_frame_id=_i32(-1, device))


def track_state_from_numpy(d, device) -> TrackState:
    """TrackState from the JAX state as a dict (or NamedTuple) of numpy
    arrays; `last_feats` may itself be a dict or a NamedTuple."""
    if hasattr(d, "_asdict"):
        d = d._asdict()
    fields = {k: to_tensor(d[k], device) for k in TrackState._fields
              if k != "last_feats"}
    fields["last_feats"] = tree_from_numpy(FrameFeatures, d["last_feats"],
                                           device)
    return TrackState(**fields)


def _inv_sigma2(level: torch.Tensor, scale: float) -> torch.Tensor:
    return scale ** (-2.0 * level.float())


def _mark(n: int, idx: torch.Tensor) -> torch.Tensor:
    """bool [n] with True at the non-negative entries of idx."""
    out = torch.zeros((n,), dtype=torch.bool, device=idx.device)
    out[idx[idx >= 0].long()] = True
    return out


class WholeMap:
    """The landmark-axis steps of a frame (`track_frame`, and the object
    lane and keyframe branch of `steady.slam_step`) on a map that this
    process holds whole: plain indexing and products."""

    def n_points(self, m: MapState) -> int:
        return m.max_pt

    def n_keyframes(self, m: MapState) -> int:
        return m.max_kf

    def begin_frame(self, m: MapState) -> None:
        """Called once a frame, before the steps below."""

    def point_rows(self, m: MapState, idx: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(pt_xyz, pt_valid) at the point ids `idx` (in range)."""
        return m.pt_xyz[idx], m.pt_valid[idx]

    def whole_points(self, m: MapState) -> Tuple[torch.Tensor, torch.Tensor]:
        """(pt_xyz, pt_valid) of every point: the object lane's view."""
        return m.pt_xyz, m.pt_valid

    def kf_rows(self, m: MapState, k, names) -> tuple:
        """The rows at keyframe slot `k` (an int or a 0-d tensor) of the
        keyframe tables `names`."""
        return tuple(getattr(m, n)[k] for n in names)

    def mark(self, m: MapState, idx: torch.Tensor) -> torch.Tensor:
        """bool over the point rows held here, True at the non-negative
        ids of `idx`."""
        return _mark(m.max_pt, idx)

    def local_keyframes(self, m: MapState, Z: torch.Tensor,
                        seen: torch.Tensor, k_top: int) -> torch.Tensor:
        return covisibility.local_keyframes(Z, seen, m.kf_valid, k_top)

    def points_of_keyframes(self, Z: torch.Tensor, kf_mask: torch.Tensor
                            ) -> torch.Tensor:
        return covisibility.points_of_keyframes(Z, kf_mask)

    def match_points_to_frame(self, *args, **kwargs) -> matcher.MatchResult:
        """The local-map search (`matcher.match_points_to_frame`) over the
        point rows held here; target_idx holds point ids."""
        return matcher.match_points_to_frame(*args, **kwargs)

    def reference_keyframe(self, Z: torch.Tensor, found: torch.Tensor,
                           cand: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(the keyframe that observes most of `found`, the count of
        `cand`)."""
        return torch.argmax(Z @ found.float()).to(torch.int32), cand.sum()

    def point_obs_at(self, Z: torch.Tensor, idx: torch.Tensor
                     ) -> torch.Tensor:
        """The observation counts (Z's column sums) of the point ids
        `idx`, -1 read as 0."""
        return torch.sum(Z, dim=0)[torch.clamp(idx.long(), min=0)]

    def gather(self, m: MapState) -> MapState:
        """The whole map, for the keyframe branch."""
        return m

    def keep_rows(self, m: MapState) -> MapState:
        """The part of a whole map that this process holds."""
        return m


WHOLE = WholeMap()


def _build_pose_obs(m: MapState, feats: FrameFeatures, kp_pt: torch.Tensor,
                    scale: float, maps: WholeMap = WHOLE
                    ) -> pose_opt.PoseObs:
    ok = (kp_pt >= 0) & feats.valid
    idx = torch.clamp(kp_pt.long(), 0, maps.n_points(m) - 1)
    xyz, valid = maps.point_rows(m, idx)
    return pose_opt.PoseObs(
        pts_w=xyz, uv=feats.uv, uright=feats.uright,
        inv_sigma2=_inv_sigma2(feats.level, scale), valid=ok & valid)


def track_frame(m: MapState, ts: TrackState, feats: FrameFeatures,
                frame_id: int, planes: Optional[FramePlanes] = None, *,
                cfg: SystemConfig, maps: WholeMap = WHOLE
                ) -> Tuple[MapState, TrackState, dict]:
    cam = (cfg.camera.fx, cfg.camera.fy, cfg.camera.cx, cfg.camera.cy)
    cam5 = cam + (cfg.camera.bf,)
    W, H = cfg.camera.width, cfg.camera.height
    s = cfg.orb.scale_factor
    n_kp = cfg.orb.max_keypoints
    dev = ts.pose.device
    P, K = maps.n_points(m), maps.n_keyframes(m)
    maps.begin_frame(m)

    # ---- 1. motion-model prediction -----------------------------------
    pose_guess = lie.se3_compose(ts.velocity, ts.last_pose)

    # ---- 2. match last frame's tracked points -------------------------
    last_pt = ts.kp_pt
    lf = ts.last_feats
    src_idx = torch.clamp(last_pt.long(), 0, P - 1)
    pts_w, src_ok = maps.point_rows(m, src_idx)
    src_valid = (last_pt >= 0) & lf.valid & src_ok
    radius = cfg.matcher.radius_motion_model * s ** lf.level.float()

    def run_mm(radius_mult):
        res = matcher.match_points_to_frame(
            pts_w, lf.desc_pm1, src_valid, lf.angle, lf.level,
            radius * radius_mult, lf.level - 1, lf.level + 1,
            feats, pose_guess, cam=cam, width=W, height=H,
            th=cfg.matcher.th_high, check_rotation=True)
        return torch.where(res.target_idx >= 0,
                           last_pt[torch.clamp(res.target_idx.long(), 0,
                                               n_kp - 1)], -1)

    kp_pt_mm = run_mm(1.0)
    n_mm = int((kp_pt_mm >= 0).sum())
    # if < 20 matches, retry with a doubled window (host branch)
    if n_mm < cfg.tracking.min_matches_track:
        kp_pt_mm = run_mm(2.0)
    n_mm2 = int((kp_pt_mm >= 0).sum())

    # TrackReferenceKeyFrame fallback: descriptor matching against the
    # reference keyframe, seeded from the last pose (host branch)
    use_ref = n_mm2 < cfg.tracking.min_matches_track
    if use_ref:
        ref = min(max(int(ts.ref_kf), 0), K - 1)
        ref_pt, ref_kp_valid, ref_desc, ref_angle = maps.kf_rows(
            m, ref, ("kf_pt_idx", "kf_kp_valid", "kf_desc_pm1",
                     "kf_kp_angle"))
        va = (ref_kp_valid & (ref_pt >= 0)
              & maps.point_rows(m, torch.clamp(ref_pt.long(), min=0))[1])
        mm = matcher.mutual_match(
            ref_desc, va, ref_angle,
            feats.desc_pm1, feats.valid, feats.angle,
            th=cfg.matcher.th_low, use_ratio=True, check_rotation=True)
        kp_pt_mm = torch.full((n_kp,), -1, dtype=torch.int32, device=dev)
        hit = mm.target_idx >= 0
        kp_pt_mm[mm.target_idx[hit].long()] = ref_pt[hit]
        pose_guess = ts.last_pose

    # ---- 3. first pose optimization -----------------------------------
    obs1 = _build_pose_obs(m, feats, kp_pt_mm, s, maps)
    r1 = pose_opt.optimize_pose(pose_guess, obs1, cam=cam5, cfg=cfg.solver)
    kp_pt_mm = torch.where(r1.inliers & (kp_pt_mm >= 0), kp_pt_mm, -1)

    # ---- 4. local map -------------------------------------------------
    Z = covisibility.observation_indicator(m)
    seen = maps.mark(m, kp_pt_mm)
    kf_local = maps.local_keyframes(m, Z, seen,
                                    cfg.tracking.max_local_keyframes)
    pt_local = maps.points_of_keyframes(Z, kf_local) & m.pt_valid

    # frustum + view-cone gating (Frame::isInFrustum)
    center = lie.se3_inverse(r1.pose)[4:7]
    rel = m.pt_xyz - center
    dist = torch.linalg.norm(rel, dim=-1)
    view_cos = torch.sum(rel * m.pt_normal, dim=-1) / torch.clamp(dist,
                                                                  min=1e-9)
    in_range = (dist >= 0.8 * m.pt_min_dist) & (dist <= 1.2 * m.pt_max_dist)
    pred_lvl = matcher.predict_scale_level(dist, m.pt_max_dist, s,
                                           cfg.orb.n_levels)
    cand = pt_local & in_range & (view_cos > 0.5) & (~seen)
    _, _, in_img = matcher.project_points(r1.pose, m.pt_xyz, cam, W, H)
    visible = (cand & in_img) | seen
    m = m._replace(pt_visible=m.pt_visible + visible.to(torch.int32))

    r_base = torch.where(view_cos > 0.998, 2.5, 4.0)
    radius_lm = r_base * s ** pred_lvl.float()
    # only points not already matched this frame
    res_lm = maps.match_points_to_frame(
        m.pt_xyz, m.pt_desc_pm1, visible & ~seen,
        torch.zeros((m.max_pt,), device=dev), pred_lvl,
        radius_lm, pred_lvl - 1, pred_lvl,
        feats, r1.pose, cam=cam, width=W, height=H,
        th=cfg.matcher.th_high, nn_ratio=0.8, use_ratio=True,
        check_rotation=False)
    kp_pt = torch.where(kp_pt_mm >= 0, kp_pt_mm,
                        torch.where(res_lm.target_idx >= 0,
                                    res_lm.target_idx, -1))

    # ---- 4b. plane association at the first solve's pose; the measured
    # planes, sign-aligned to their landmarks, join the second solve ----
    plane_obs = plane_assoc = None
    if planes is not None:
        plane_assoc = plane_map.associate_planes(m, planes, r1.pose, cfg=cfg)
        plane_obs = plane_map.build_plane_obs(m, planes, plane_assoc)
        plane_obs = plane_obs._replace(meas_c=plane_map._align_sign(
            plane_obs.meas_c, plane_obs.plane_w, r1.pose))

    # ---- 5. second pose optimization ----------------------------------
    obs2 = _build_pose_obs(m, feats, kp_pt, s, maps)
    r2 = pose_opt.optimize_pose(r1.pose, obs2, plane_obs, cam=cam5,
                                cfg=cfg.solver)
    kp_pt = torch.where(r2.inliers & (kp_pt >= 0), kp_pt, -1)
    n_in = (kp_pt >= 0).sum().to(torch.int32)

    found = maps.mark(m, kp_pt)
    m = m._replace(pt_found=m.pt_found + found.to(torch.int32))

    ok = n_in >= cfg.tracking.min_matches_track
    status = torch.where(ok, STATUS_OK, STATUS_LOST).to(torch.int32)
    pose_out = torch.where(ok, r2.pose, ts.pose)

    # ---- 6. keyframe decision (NeedNewKeyFrame) -----------------------
    ref_kf, n_local_pts = maps.reference_keyframe(Z, found, cand)
    mature_obs = 3.0 if cfg.sensor == "mono" else 2.0
    min_obs = torch.where(m.next_kf <= 2, 1.0, mature_obs)
    ref_pts, = maps.kf_rows(m, ref_kf.long(), ("kf_pt_idx",))
    ref_ok = (ref_pts >= 0) & (maps.point_obs_at(Z, ref_pts) >= min_obs)
    n_ref = ref_ok.sum().to(torch.int32)
    close = (feats.depth > 0) & (feats.depth < cfg.camera.depth_threshold)
    tracked_close = (close & (kp_pt >= 0)).sum().to(torch.int32)
    untracked_close = (close & (kp_pt < 0) & feats.valid).sum().to(
        torch.int32)
    need_close = ((tracked_close < cfg.tracking.kf_min_close_points)
                  & (untracked_close > cfg.tracking.kf_max_close_tracked))
    frames_since = frame_id - ts.last_kf_frame_id
    c1 = frames_since >= cfg.tracking.max_frames_between_kf
    ratio_ok = n_in < cfg.tracking.kf_ref_ratio * n_ref.float()
    ratio_ok = ratio_ok & (frames_since
                           >= cfg.tracking.min_frames_between_kf)
    c2 = (ratio_ok | need_close) & (n_in > 15)
    has_capacity = m.next_kf < K
    need_kf = ok & (c1 | c2) & has_capacity & (frames_since >= 1)

    vel = lie.se3_compose(pose_out, lie.se3_inverse(ts.last_pose))
    ident = lie.se3_identity(device=dev)
    new_ts = TrackState(
        pose=pose_out,
        velocity=torch.where(ok & (ts.status == STATUS_OK), vel, ident),
        last_pose=pose_out, last_feats=feats, kp_pt=kp_pt, ref_kf=ref_kf,
        n_inliers=n_in, status=status, frame_id=_i32(frame_id, dev),
        last_kf_frame_id=ts.last_kf_frame_id)
    diag = {"n_mm": torch.tensor(n_mm, device=dev), "n_inliers": n_in,
            "need_kf": need_kf,
            "n_local_pts": n_local_pts,
            "n_kf_local": kf_local.sum(),
            "n_ref": n_ref, "tracked_close": tracked_close,
            "untracked_close": untracked_close,
            "kf_trigger": (c1.to(torch.int32)
                           + 2 * (ratio_ok & (n_in > 15)).to(torch.int32)
                           + 4 * (need_close & (n_in > 15)).to(torch.int32))}
    if plane_assoc is not None:
        diag["n_planes_matched"] = (plane_assoc >= 0).sum().to(torch.int32)
        diag["plane_assoc"] = plane_assoc
    return m, new_ts, diag
