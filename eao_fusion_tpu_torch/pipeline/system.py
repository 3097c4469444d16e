"""System facade for RGBD, stereo and monocular SLAM with plane and object
landmarks, local mapping, loop closing and relocalization (port of
`eao_fusion_tpu/pipeline/system.py`).

The host sequences the per-frame plane segmentation, `track_frame`,
relocalization on loss and the EAO object lane (frame objects, ensemble
association, object update), the keyframe-rate `insert_keyframe_rgbd`,
plane-map update, `local_mapping_step`, object merge and loop closing
(detection, Sim3, correction, the global BA on a side thread, merged when
it finishes), and the episodic point and keyframe compaction. A frame with
depth is RGBD; a rectified right image without depth is stereo (SAD
matching fills the depth); a frame with neither, or any frame under
`sensor="mono"`, is monocular: two-view initialization, then epipolar
triangulation at every keyframe. Boxes come from the caller (offline box
files) or, with `semantic_online`, from the port's own YOLOX lane.
Localization-only mode tracks against a frozen map.

The steady chunked mode (`pipeline/steady.py`) runs frames without this
facade; `chunk_epilogue` is its chunk-boundary protocol: loop detection
dispatched at one boundary and harvested at the next, the GBA merge,
compaction and relocalization.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from eao_fusion_tpu_torch import DeviceLike, resolve_device
from eao_fusion_tpu_torch.config import COCO_CLASS_WHITELIST, SystemConfig
from eao_fusion_tpu_torch.frontend import extractor, matcher, yolox
from eao_fusion_tpu_torch.frontend import stereo as stereo_fe
from eao_fusion_tpu_torch.mapping import map_state as ms
from eao_fusion_tpu_torch.mapping import plane_map, vocabulary
from eao_fusion_tpu_torch.objects import association
from eao_fusion_tpu_torch.objects import merge as obj_merge
from eao_fusion_tpu_torch.objects import object_map as om
from eao_fusion_tpu_torch.objects import update as obj_update
from eao_fusion_tpu_torch.ops import lie, twoview
from eao_fusion_tpu_torch.ops import planes as plane_ops
from eao_fusion_tpu_torch.pipeline import (local_mapping, loop_closing,
                                           relocalization, steady, tracking)
from eao_fusion_tpu_torch.pipeline.loop_closing import LoopCloser
from eao_fusion_tpu_torch.types import FrameFeatures, FramePlanes
from eao_fusion_tpu_torch.utils import profiling


def insert_keyframe_rgbd(m: ms.MapState, feats: FrameFeatures,
                         pose: torch.Tensor, kp_pt: torch.Tensor,
                         frame_id: int, timestamp: float, *,
                         cfg: SystemConfig, is_init: bool = False,
                         by_obj: bool = False) -> ms.MapState:
    """Keyframe insertion + RGBD point creation + stat refresh. At init
    every depth point spawns a landmark; afterwards only close points
    without an association do."""
    cam = (cfg.camera.fx, cfg.camera.fy, cfg.camera.cx, cfg.camera.cy)
    m, slot = ms.insert_keyframe(m, feats, pose, frame_id, timestamp, kp_pt,
                                 by_obj=by_obj)
    max_depth = 1e9 if is_init else float(cfg.camera.depth_threshold)
    m = ms.create_points_from_depth(m, slot, feats, pose, kp_pt, max_depth,
                                    cam, frame_id,
                                    scale_factor=cfg.orb.scale_factor,
                                    n_levels=cfg.orb.n_levels)
    m = ms.refresh_obs_rows(m, torch.tensor([slot], device=pose.device))
    return ms.update_point_stats(m)


REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WEIGHT_CANDIDATES = ("data/yolox_s.npz", "data/yolox_synth.npz")


def make_detector(device: torch.device) -> yolox.Detector:
    """The online detector lane (`SemanticOnline`: the reference's YOLOX
    thread, `src/System.cc:112-114`), from `EAO_YOLOX_WEIGHTS` or the first
    of `WEIGHT_CANDIDATES` found (relative to the working directory, then
    to the repo root). With no weights file this raises: the JAX package
    falls back to random weights with a warning, which feeds garbage
    detections into the object map."""
    env_path = os.environ.get("EAO_YOLOX_WEIGHTS")
    if env_path is not None:
        if not os.path.exists(env_path):
            raise FileNotFoundError(
                f"EAO_YOLOX_WEIGHTS={env_path} does not exist")
        wpath = env_path
    else:
        cands = [p for name in WEIGHT_CANDIDATES
                 for p in (name, os.path.join(REPO_ROOT, name))]
        wpath = next((p for p in cands if os.path.exists(p)), None)
        if wpath is None:
            raise FileNotFoundError(
                "online detector: no weights found (" + ", ".join(
                    WEIGHT_CANDIDATES) + "); train with "
                "tools/train_yolox.py or set EAO_YOLOX_WEIGHTS")
    params = yolox.load_params(wpath, device)
    depth_mult, n_classes = yolox.infer_arch(params)
    return yolox.Detector(params, depth_mult=depth_mult, n_classes=n_classes)


class System:
    """Feed RGBD, stereo or monocular frames, read poses and the
    trajectory. Runs on `cuda` unless `device` names another; with no card
    and no device named it raises."""

    def __init__(self, cfg: Optional[SystemConfig] = None,
                 device: DeviceLike = None):
        self.cfg = cfg or SystemConfig()
        self.device = resolve_device(device)
        self.map = ms.empty_map(self.cfg, self.device)
        self.track = tracking.init_track_state(self.cfg, self.device)
        self.trajectory: List[np.ndarray] = []
        self.timestamps: List[float] = []
        self._traj_refs: List = []
        self.frame_id = 0
        self.n_keyframes = 0
        self.diags: List[dict] = []
        self.n_resets = 0
        self.n_pt_compactions = 0
        self.n_kf_compactions = 0
        self.n_kf_evictions = 0     # keyframes dropped by capacity eviction
        self.events: List[dict] = []   # {"frame_id", "event", ...}
        self.objects = om.empty_table(self.cfg, self.device)
        self._last_fo: Optional[om.FrameObjects] = None
        self._mono_ref = None       # monocular init: (feats, t, frame id)
        # the chunked mode's host state: the map's insertion cursor as of
        # the last chunk boundary, the loop detection dispatched there (a
        # LoopCloser pending handle) and the last keyframe compaction's
        # slot remap
        self.next_kf_hint = 0
        self._pending_detect: Optional[dict] = None
        self._last_kf_remap: Optional[np.ndarray] = None
        # the randoms of the object lane (isolation-forest draws), loop
        # closing, relocalization and monocular init (RANSAC draws), in
        # place of the JAX System's PRNGKey(7)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(7)
        self.n_obj_keyframes = 0    # keyframes inserted for a new object
        self.detector = (make_detector(self.device)
                         if self.cfg.semantic_online else None)
        self.localization_only = False
        self.n_loops_closed = 0
        self.n_relocalizations = 0
        self.n_gba_merges = 0
        self.reloc_stats: dict = {}   # relocalization's pose solves
        # the vocabulary is the shipped file; a missing one raises (the JAX
        # System falls back to a random codebook)
        self.loop_closer = (LoopCloser(self.cfg, vocabulary.Vocabulary.load(
            device=self.device), self.generator)
            if self.cfg.use_loop_closing else None)

    def activate_localization_mode(self) -> None:
        """Track against the frozen map (`System::ActivateLocalizationMode`,
        `src/Tracking.cc:963-1021` mbOnlyTracking): no keyframe insertion,
        no reset, no landmark, plane or object update; the map stays
        bit-identical. Relocalization still runs on a loss."""
        self.localization_only = True

    def deactivate_localization_mode(self) -> None:
        self.localization_only = False

    def reset(self) -> None:
        """Clear the map, object and tracking state; the trajectory is kept,
        with past entries frozen at their recorded poses."""
        self.map = ms.empty_map(self.cfg, self.device)
        self.track = tracking.init_track_state(self.cfg, self.device)
        self.objects = om.empty_table(self.cfg, self.device)
        self._last_fo = None
        self._mono_ref = None
        # a pending detection belongs to the old map (the JAX System keeps
        # it)
        self._pending_detect = None
        self.n_keyframes = 0
        self._traj_refs = [(-1, raw) for raw, _ in
                           zip(self.trajectory, self._traj_refs)]
        lc = self.loop_closer
        if lc is not None:
            lc.abort_gba()           # its snapshot belongs to the old map
            lc.bow = torch.zeros_like(lc.bow)
            lc.consistent_groups = []

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def process_frame(self, gray: np.ndarray,
                      depth: Optional[np.ndarray] = None,
                      timestamp: float = 0.0, boxes=None,
                      initial_pose: Optional[np.ndarray] = None,
                      right=None) -> np.ndarray:
        """Track one frame; returns the estimated Tcw [7]. With `depth` it
        is RGBD; with a rectified `right` image and no depth (and a sensor
        other than mono), stereo; otherwise monocular (`TrackRGBD` /
        `TrackStereo` / `TrackMonocular`, `src/System.cc:142-249`). `boxes`
        are the frame's detections, [B, 6] rows (class, x, y, w, h,
        score); with the online detector and no boxes given, the
        detector's are used. `initial_pose` seeds the world frame at
        initialization."""
        cfg = self.cfg
        stereo = right is not None and depth is None and cfg.sensor != "mono"
        mono = (depth is None and not stereo) or cfg.sensor == "mono"
        online = self.detector is not None and boxes is None
        if online:
            # dispatch detection before feature extraction so that the two
            # overlap (the reference's InsertImage at frame start,
            # `src/Tracking.cc:318`)
            rgb = np.asarray(gray)
            self.detector.submit(np.stack([rgb, rgb, rgb], axis=-1))
        depth_t = None if depth is None else self._tensor(depth)
        if stereo:
            feats = stereo_fe.extract_stereo_features(
                self._tensor(gray), self._tensor(right), orb_cfg=cfg.orb,
                cam_cfg=cfg.camera)
        else:
            feats = extractor.extract_features(
                self._tensor(gray), None if mono else depth_t,
                orb_cfg=cfg.orb, cam_cfg=cfg.camera, with_depth=not mono)
        planes = None
        if cfg.use_planes and not mono and depth_t is not None:
            planes = plane_ops.segment_planes(depth_t, cam=cfg.camera,
                                              cfg=cfg.planes)

        if mono and int(self.track.status) == tracking.STATUS_UNINIT:
            pose = self._try_mono_init(feats, timestamp, initial_pose)
            self._record(pose, timestamp)
            self.frame_id += 1
            return pose.cpu().numpy()

        if int(self.track.status) == tracking.STATUS_UNINIT:
            pose = self._tensor(initial_pose if initial_pose is not None
                                else [1, 0, 0, 0, 0, 0, 0])
            n_depth = int(((feats.depth > 0) & feats.valid).sum())
            # 500-point gate of StereoInitialization, scaled to the budget
            if n_depth >= min(500, cfg.orb.max_keypoints // 2):
                kp_pt = torch.full((cfg.orb.max_keypoints,), -1,
                                   dtype=torch.int32, device=self.device)
                self.map = insert_keyframe_rgbd(
                    self.map, feats, pose, kp_pt, self.frame_id, timestamp,
                    cfg=cfg, is_init=True)
                slot = int(self.map.next_kf) - 1
                dev = self.device
                self.track = self.track._replace(
                    pose=pose, last_pose=pose, last_feats=feats,
                    kp_pt=self.map.kf_pt_idx[slot],
                    status=tracking._i32(tracking.STATUS_OK, dev),
                    frame_id=tracking._i32(self.frame_id, dev),
                    last_kf_frame_id=tracking._i32(self.frame_id, dev))
                self.n_keyframes += 1
                if planes is not None:
                    self._update_planes(planes, pose, slot)
            self._record(pose, timestamp)
            self.frame_id += 1
            return pose.cpu().numpy()

        loc_only = self.localization_only
        m_out, self.track, diag = tracking.track_frame(
            self.map, self.track, feats, self.frame_id, planes, cfg=cfg)
        if not loc_only:
            # localization-only keeps the map untouched (track_frame's only
            # map writes are the found / visible counters)
            self.map = m_out

        # relocalization on tracking loss (`src/Tracking.cc:999`), before
        # the object lane so that the lane runs once, with the recovered
        # pose. A loss with few keyframes goes to the reset below instead
        if (self.loop_closer is not None
                and int(self.track.status) == tracking.STATUS_LOST
                and (loc_only or self.n_keyframes
                     > cfg.tracking.reset_if_lost_below_kfs)):
            self._relocalize(feats)

        # ---- object lane (EAO): frame objects, ensemble association,
        # object-table update (`Tracking::TrackWithMotionModel` object
        # block, `src/Tracking.cc:1733-2177`) ----
        if online:
            boxes = self.detector.result()      # joins the async detection
            wl = cfg.objects.class_whitelist
            if wl is None and self.detector.n_classes == 80:
                # a COCO-class detector gets the reference's 14-id
                # whitelist (`src/Tracking.cc:437-441`)
                wl = COCO_CLASS_WHITELIST
            if boxes is not None and wl is not None and len(boxes):
                boxes = boxes[np.isin(boxes[:, 0].astype(np.int64),
                                      np.asarray(wl))]
        fo = None
        new_obj = torch.zeros((), dtype=torch.bool, device=self.device)
        if (cfg.use_objects and boxes is not None and len(boxes)
                and not loc_only):
            fo, new_obj = self._object_lane(boxes, feats)

        # one device -> host read for every scalar the host gates on: the
        # diagnostics, the tracking status, whether the lane made an
        # object, and the keyframe cursor
        names = [k for k, v in diag.items() if v.dim() == 0]
        vals = torch.stack([diag[k].to(torch.int64).reshape(())
                            for k in names] + [
            self.track.status.to(torch.int64).reshape(()),
            new_obj.to(torch.int64), self.map.next_kf.to(torch.int64)
        ]).tolist()
        diag_h = dict(zip(names, vals))
        status, new_object, next_kf = vals[len(names):]
        self.diags.append(diag_h)

        # auto-reset when lost early: with <= 5 keyframes a loss means the
        # initialization was bad
        if (status == tracking.STATUS_LOST and not loc_only
                and self.n_keyframes <= cfg.tracking.reset_if_lost_below_kfs):
            self.n_resets += 1
            self.reset()
            self._record(self.track.pose, timestamp)
            self.frame_id += 1
            return self.track.pose.cpu().numpy()
        if fo is not None and status == tracking.STATUS_OK:
            self._last_fo = fo

        # a new map object also triggers a keyframe (the reference's
        # NeedNewKeyFrame returns 2 on AppearNewObject,
        # `src/Tracking.cc:2390-2462`)
        new_object = bool(new_object) and next_kf < self.map.max_kf
        if not loc_only and (diag_h["need_kf"] or new_object):
            by_obj = new_object and not diag_h["need_kf"]
            self.n_obj_keyframes += int(by_obj)
            self.map = insert_keyframe_rgbd(
                self.map, feats, self.track.pose, self.track.kp_pt,
                self.frame_id, timestamp, cfg=cfg, is_init=False,
                by_obj=by_obj)
            slot = int(self.map.next_kf) - 1
            self.track = self.track._replace(
                kp_pt=self.map.kf_pt_idx[slot],
                last_kf_frame_id=tracking._i32(self.frame_id, self.device),
                ref_kf=tracking._i32(slot, self.device))
            self.n_keyframes += 1
            if planes is not None:
                self._update_planes(planes, self.track.pose, slot)
            self._on_keyframe(slot)

        self._record(self.track.pose, timestamp)
        self.frame_id += 1
        return self.track.pose.cpu().numpy()

    def _try_mono_init(self, feats: FrameFeatures, timestamp: float,
                       initial_pose) -> torch.Tensor:
        """Monocular two-view initialization (`MonocularInitialization` and
        `CreateInitialMapMonocular`, `src/Tracking.cc:1337-1549`): hold a
        reference frame, match against it, run the H / F initializer on
        draws from the System's generator, build the initial map with the
        median scene depth scaled to 1, then the full GBA when loop closing
        is on. Returns the frame's pose (the identity until it succeeds)."""
        cfg = self.cfg
        dev = self.device
        ident = lie.se3_identity(device=dev)
        if self._mono_ref is None or int(feats.valid.sum()) < 100:
            self._mono_ref = (feats, timestamp, self.frame_id)
            return ident
        ref_feats, ref_ts, ref_fid = self._mono_ref
        mm = matcher.mutual_match(ref_feats.desc_pm1, ref_feats.valid,
                                  ref_feats.angle, feats.desc_pm1,
                                  feats.valid, feats.angle, th=64,
                                  use_ratio=True, check_rotation=True)
        tgt = mm.target_idx.cpu().numpy()
        ia = np.where(tgt >= 0)[0]
        if len(ia) < 100:
            self._mono_ref = (feats, timestamp, self.frame_id)
            return ident
        n = cfg.orb.max_keypoints
        m_ = len(ia)
        ia_t = torch.as_tensor(ia, device=dev)
        uv1 = torch.zeros((n, 2), device=dev)
        uv2 = torch.zeros((n, 2), device=dev)
        valid = torch.zeros((n,), dtype=torch.bool, device=dev)
        uv1[:m_] = ref_feats.uv[ia_t]
        uv2[:m_] = feats.uv[mm.target_idx[ia_t].long()]
        valid[:m_] = True
        idx_f, idx_h = twoview.draw_two_view_hypotheses(valid,
                                                         self.generator)
        cam = (cfg.camera.fx, cfg.camera.fy, cfg.camera.cx, cfg.camera.cy)
        res = twoview.initialize_two_view(uv1, uv2, valid, idx_f, idx_h,
                                          cam=cam)
        if not bool(res.success):
            return ident

        # scale: the median triangulated depth becomes 1
        # (`src/Tracking.cc:1497-1515`)
        ok = res.ok.cpu().numpy()
        xyz = res.xyz.cpu().numpy()
        med = float(np.median(xyz[ok][:, 2]))
        if med <= 0:
            return ident
        tcw2 = res.tcw2.cpu().numpy().copy()
        tcw2[4:7] /= med

        pose1 = (self._tensor(initial_pose) if initial_pose is not None
                 else ident)
        kp_empty = torch.full((n,), -1, dtype=torch.int32, device=dev)
        m, k1 = ms.insert_keyframe(self.map, ref_feats, pose1, ref_fid,
                                   ref_ts, kp_empty)
        m, k2 = ms.insert_keyframe(
            m, feats, lie.se3_compose(self._tensor(tcw2), pose1),
            self.frame_id, timestamp, kp_empty)
        # the triangulated points, observed in both keyframes; `ok` indexes
        # the padded match slots, so map back to keypoint ids
        kp1 = ia[np.where(ok[:m_])[0]]
        kp2 = tgt[kp1]
        pids = torch.arange(len(kp1), device=dev)
        xyz_w = lie.se3_apply(lie.se3_inverse(pose1),
                              self._tensor(xyz[:m_][ok[:m_]] / med))
        kp1_t = torch.as_tensor(kp1, device=dev)
        kp2_t = torch.as_tensor(kp2, device=dev).long()
        kf_pt = m.kf_pt_idx.clone()
        kf_pt[k1, kp1_t] = pids.to(torch.int32)
        kf_pt[k2, kp2_t] = pids.to(torch.int32)
        m = m._replace(
            pt_xyz=ms.set_rows(m.pt_xyz, pids, xyz_w),
            pt_valid=ms.set_rows(m.pt_valid, pids, True),
            pt_desc_pm1=ms.set_rows(m.pt_desc_pm1, pids,
                                    feats.desc_pm1[kp2_t]),
            pt_ref_kf=ms.set_rows(m.pt_ref_kf, pids, k1),
            pt_max_dist=ms.set_rows(m.pt_max_dist, pids, 10.0),
            pt_found=ms.set_rows(m.pt_found, pids, 2),
            pt_visible=ms.set_rows(m.pt_visible, pids, 2),
            pt_first_frame=ms.set_rows(m.pt_first_frame, pids, ref_fid),
            next_pt=tracking._i32(len(kp1), dev), kf_pt_idx=kf_pt)
        self.map = ms.update_point_stats(ms.refresh_obs_ind(m))
        self.n_keyframes = 2

        # full BA on the initial map (`Optimizer::GlobalBundleAdjustemnt`
        # at mono init, `src/Tracking.cc:1466`)
        lc = self.loop_closer
        if lc is not None:
            self.map = lc._global_ba(self.map)
            lc.add_keyframe_bow(self.map, k1)
            lc.add_keyframe_bow(self.map, k2)

        pose2 = self.map.kf_pose[k2]
        self.track = self.track._replace(
            pose=pose2, last_pose=pose2, last_feats=feats,
            kp_pt=self.map.kf_pt_idx[k2],
            status=tracking._i32(tracking.STATUS_OK, dev),
            frame_id=tracking._i32(self.frame_id, dev),
            last_kf_frame_id=tracking._i32(self.frame_id, dev),
            ref_kf=tracking._i32(k2, dev))
        self._mono_ref = None
        return pose2

    def _relocalize(self, feats: FrameFeatures) -> bool:
        """BoW retrieval, RANSAC and the pose solve against the map; on
        success tracking resumes from the recovered pose."""
        lc = self.loop_closer
        pose, kp_pt = relocalization.relocalize(
            self.map, feats, lc.bow, lc.vocab, self.generator, cfg=self.cfg,
            stats=self.reloc_stats)
        if pose is None:
            return False
        dev = self.device
        self.track = self.track._replace(
            pose=pose, last_pose=pose, last_feats=feats, kp_pt=kp_pt,
            velocity=lie.se3_identity(device=dev),
            status=tracking._i32(tracking.STATUS_OK, dev))
        self.n_relocalizations += 1
        return True

    def _object_lane(self, boxes: np.ndarray, feats: FrameFeatures):
        """Build this frame's objects, merge the last frame's into them,
        associate them with the map objects and update the table. The lane
        runs whatever the tracking status and its table counts only where
        tracking is OK (a select on the device, so the host reads nothing
        here). Returns the frame objects and whether a map object was
        made (a bool tensor)."""
        cfg, m, ts = self.cfg, self.map, self.track
        fo = om.build_frame_objects(om.boxes_tensor(boxes, self.device),
                                    feats, ts.kp_pt, m.pt_xyz, m.pt_valid,
                                    ts.pose, cfg=cfg)
        if self._last_fo is not None:
            fo = om.merge_frame_objects(fo, self._last_fo, m.pt_valid,
                                        cfg=cfg)
        assoc = association.ensemble_associate(
            self.objects, fo, m.pt_xyz, ts.pose, self.frame_id, cfg=cfg)
        new_tab = obj_update.object_update(
            self.objects, fo, assoc, m.pt_xyz, ts.pose, self.frame_id,
            self.generator, cfg=cfg)
        ok = ts.status == tracking.STATUS_OK
        made = ok & (new_tab.next_obj > self.objects.next_obj)
        self.objects = om.table_where(ok, new_tab, self.objects)
        return fo, made

    def _update_planes(self, planes: FramePlanes, pose: torch.Tensor,
                       kf_slot: int) -> None:
        """Keyframe-rate plane landmark update: association redone at the
        final pose, then merge or insert; the keyframe's plane observations
        are recorded for the BA plane factors."""
        assoc = plane_map.associate_planes(self.map, planes, pose,
                                           cfg=self.cfg)
        self.map, plane_ids = plane_map.update_plane_map(
            self.map, planes, assoc, pose, kf_slot, cfg=self.cfg)
        self.map = plane_map.record_kf_plane_obs(self.map, kf_slot, planes,
                                                 plane_ids)

    def _poll_gba(self, blocking: bool = False) -> bool:
        """Merge a finished asynchronous GBA into the live map (the
        reference's post-GBA map update under mMutexGBA). The tracking pose
        is rebased through its reference keyframe: the camera-relative
        transform T_c,ref is invariant under map corrections. A blocking
        poll first harvests a pending chunk-boundary loop detection (its
        correction may itself launch a GBA, joined here)."""
        lc = self.loop_closer
        if lc is None:
            return False
        if blocking and self._pending_detect is not None:
            pend, self._pending_detect = self._pending_detect, None
            self._harvest(int(self.map.next_kf) - 1, pend)
        if lc._gba_thread is None:
            return False
        ref = int(self.track.ref_kf)
        before = self.map.kf_pose[ref] if ref >= 0 else None
        self.map, merged = lc.poll_gba(self.map, blocking=blocking)
        if merged:
            self.n_gba_merges += 1
        if merged and before is not None:
            rebase = lie.se3_compose(lie.se3_inverse(before),
                                     self.map.kf_pose[ref])
            self.track = self.track._replace(
                pose=lie.se3_compose(self.track.pose, rebase),
                last_pose=lie.se3_compose(self.track.last_pose, rebase))
        return merged

    def _harvest(self, anchor: int, pend: Optional[dict] = None,
                 kf_valid: Optional[np.ndarray] = None,
                 slots: Optional[List[int]] = None) -> None:
        """Loop detection on a chunk's keyframes: harvest the pending
        handle `pend` (or, with `slots`, detect on them synchronously); a
        closure moves the tracker by the correction of keyframe `anchor`,
        the newest."""
        anchor_pose_old = self.map.kf_pose[anchor]
        if slots is not None:
            self.map, n_closed, _ = self.loop_closer.on_keyframes(self.map,
                                                                  slots)
        else:
            self.map, n_closed, _ = self.loop_closer.harvest_detect(
                self.map, pend, kf_valid=kf_valid)
        if n_closed:
            self.n_loops_closed += n_closed
            self._apply_loop_delta(anchor, anchor_pose_old)

    def _apply_loop_delta(self, anchor: int,
                          anchor_pose_old: torch.Tensor) -> None:
        """Move the tracker by the anchor keyframe's correction (T' = T ∘
        T_aw_old⁻¹ ∘ T_aw_new): the chunk's last frame keeps its motion
        relative to the anchor instead of rewinding to the closed keyframe
        (which may lie frames earlier, and whose point row is keyed to the
        keyframe's keypoints, not to last_feats'). Point ids that loop
        fusion invalidated are dropped and found again by the next
        local-map search."""
        delta = lie.se3_compose(lie.se3_inverse(anchor_pose_old),
                                self.map.kf_pose[anchor])
        kp = self.track.kp_pt
        kp = torch.where(
            (kp >= 0) & self.map.pt_valid[torch.clamp(kp.long(), min=0)],
            kp, -1)
        self.track = self.track._replace(
            pose=lie.se3_compose(self.track.pose, delta),
            last_pose=lie.se3_compose(self.track.last_pose, delta),
            kp_pt=kp)

    def chunk_epilogue(self, st, kf_before: int):
        """The chunk-boundary protocol of the steady chunked mode: take the
        facade's state from the steady carry `st`; harvest the loop
        detection dispatched at the last boundary (its device work ran
        beside this chunk, so a loop arising in chunk k is corrected at
        boundary k + 1); merge a finished GBA; compact point and keyframe
        slots when low; dispatch detection for this chunk's keyframes
        (slots from `kf_before` on), after compaction so that the slot ids
        in the handle stay current; relocalize on the last frame's
        features if the chunk ended LOST. Returns the refreshed carry."""
        with profiling.span("system.epilogue", chunk=self.frame_id):
            return self._chunk_epilogue(st, kf_before)

    def _chunk_epilogue(self, st, kf_before: int):
        self.map, self.track, self.objects = st.m, st.ts, st.objs
        # one device -> host read for every scalar the host gates on
        K = self.map.max_kf
        with profiling.span("epilogue.read"):
            vals = torch.cat([torch.stack([
                st.m.next_kf, st.m.next_pt, st.ts.status]).long(),
                st.m.kf_valid.long()]).cpu().numpy()
        next_kf, next_pt, status = (int(v) for v in vals[:3])
        kf_valid_h = vals[3:3 + K] > 0
        self.frame_id = st.frame_id
        self.n_keyframes = next_kf
        lc = self.loop_closer
        if lc is not None and self._pending_detect is not None:
            pend, self._pending_detect = self._pending_detect, None
            with profiling.span("epilogue.harvest"):
                self._harvest(next_kf - 1, pend, kf_valid=kf_valid_h)
        with profiling.span("epilogue.gba_poll"):
            self._poll_gba()
        # the triggers read the values above (stale only after a closure,
        # whose fusion can only shrink the tables)
        with profiling.span("epilogue.compact_points"):
            pts_compacted = self._maybe_compact_points(next_pt=next_pt)
        with profiling.span("epilogue.compact_kfs"):
            kfs_compacted = self._maybe_compact_keyframes(
                next_kf=next_kf, kf_valid=kf_valid_h)
        self.next_kf_hint = (int(self.map.next_kf) if kfs_compacted
                             else next_kf)
        if lc is not None and kf_before < next_kf:
            new_slots = list(range(kf_before, next_kf))
            if kfs_compacted:
                remap = self._last_kf_remap
                new_slots = [int(remap[k]) for k in new_slots
                             if remap[k] >= 0]
            if len(new_slots) > loop_closing.DETECT_BATCH:
                # an oversized chunk takes the synchronous batch path
                with profiling.span("epilogue.harvest"):
                    self._harvest(self.next_kf_hint - 1, slots=new_slots)
            elif new_slots:
                self.map, self._pending_detect = lc.dispatch_detect(
                    self.map, new_slots)
        if status == tracking.STATUS_LOST and lc is not None:
            with profiling.span("epilogue.relocalize"):
                self._relocalize(self.track.last_feats)

        last_fo = st.last_fo
        if pts_compacted and self.cfg.use_objects:
            # the cached frame objects hold old point ids: an empty table
            last_fo = steady.empty_frame_objects(self.cfg, self.map,
                                                 self.track)
        return st._replace(m=self.map, ts=self.track, objs=self.objects,
                           last_fo=last_fo, frame_id=self.frame_id)

    def record_chunk(self, st, diag: dict, timestamps) -> None:
        """Record a chunk's frames in the trajectory and the diagnostics,
        before its `chunk_epilogue`: each pose relative to the carry's
        reference keyframe at the chunk's end, so that `trajectory_tcw(
        corrected=True)` follows later corrections of that keyframe."""
        with profiling.span("system.record_chunk", chunk=self.frame_id):
            poses = diag["pose"].cpu()
            ref = int(st.ts.ref_kf)
            t_rw_inv = lie.se3_inverse(st.m.kf_pose[ref].cpu())
            t_cr = lie.se3_compose(poses, t_rw_inv[None]).numpy()
            cols = {k: diag[k].cpu().tolist() for k in ("n_inliers",
                                                        "kf_inserted",
                                                        "kf_trigger")}
            for j, t in enumerate(timestamps):
                self.trajectory.append(poses[j].numpy())
                self.timestamps.append(float(t))
                self._traj_refs.append((ref, t_cr[j]))
                self.diags.append({k: int(v[j]) for k, v in cols.items()})

    def _on_keyframe(self, slot: int) -> None:
        """Keyframe-rate mapping: a finished GBA merged first; monocular
        point creation; culling, fusion, local BA, stat refresh, object
        merge; point compaction; loop closing; keyframe compaction."""
        self._poll_gba()
        if self.cfg.sensor == "mono" and self.n_keyframes >= 2:
            # monocular landmarks by epipolar triangulation
            self.map = local_mapping.create_points_mono(self.map, slot,
                                                        cfg=self.cfg)
        if self.n_keyframes >= 3:
            with profiling.span("mapping.local"):
                self.map = local_mapping.local_mapping_step(self.map, slot,
                                                            cfg=self.cfg)
            # BA may have removed some associations as outliers
            self.track = self.track._replace(kp_pt=self.map.kf_pt_idx[slot])
        if self.cfg.use_objects:
            # keyframe-rate object maintenance (`LocalMapping::Run` :86-91)
            self.objects = obj_merge.merge_and_overlap(
                self.objects, self.map.pt_xyz, self.generator, cfg=self.cfg)
        self._maybe_compact_points()
        if self.loop_closer is not None:
            self.map, closed = self.loop_closer.on_keyframe(self.map, slot)
            if closed:
                self.n_loops_closed += 1
                # the correction moved poses and points: tracking restarts
                # from the corrected keyframe
                self.track = self.track._replace(
                    pose=self.map.kf_pose[slot],
                    last_pose=self.map.kf_pose[slot],
                    kp_pt=self.map.kf_pt_idx[slot])
        self._maybe_compact_keyframes()

    def _maybe_compact_points(self, next_pt: Optional[int] = None) -> bool:
        """Point-slot compaction when the insertion cursor runs low:
        `next_pt` is append-only, so without it point creation would stop
        at `max_pt` lifetime insertions. `next_pt` is the cursor if the
        caller has read it already."""
        if next_pt is None:
            next_pt = int(self.map.next_pt)
        if next_pt <= 0.9 * self.map.max_pt:
            return False
        self.map, remap = ms.compact_points(self.map)
        self.n_pt_compactions += 1
        self.events.append({"frame_id": self.frame_id,
                            "event": "pt_compaction",
                            "live_pts": int(self.map.pt_valid.sum())})
        if self.loop_closer is not None:
            # an in-flight GBA must see the new point slots
            self.loop_closer.note_pt_remap(remap.cpu().numpy())
        def follow(ids):
            return torch.where(ids >= 0, remap[torch.clamp(ids.long(), min=0)],
                               -1)

        if self.cfg.use_objects:
            ids = follow(self.objects.pt_idx)
            self.objects = self.objects._replace(
                pt_idx=ids, pt_ok=self.objects.pt_ok & (ids >= 0))
        self.track = self.track._replace(kp_pt=follow(self.track.kp_pt))
        # the last frame's objects hold the old point ids
        self._last_fo = None
        return True

    def _maybe_compact_keyframes(self, next_kf: Optional[int] = None,
                                 kf_valid: Optional[np.ndarray] = None
                                 ) -> bool:
        """Keyframe-slot lifecycle: when insertion reaches 0.9 of the table,
        reclaim the slots that culling freed; if the table is full of live
        keyframes (exploration), first evict the ones least tied to the
        recent window. Lifetime keyframe insertions become unbounded. The
        map's own references are remapped by `compact_keyframes`; here the
        tracking reference, the trajectory references and the loop
        closer's bow rows and keyframe ids follow. A pending chunk-boundary
        detection holds the old slot ids, so it goes (those keyframes lose
        one detection; compactions are episodic). `next_kf` and `kf_valid`
        are the cursor and the mask if the caller has read them already."""
        m = self.map
        if next_kf is None:
            next_kf = int(m.next_kf)
        if next_kf < int(0.9 * m.max_kf):
            return False
        live = int(m.kf_valid.sum() if kf_valid is None else kf_valid.sum())
        if live > int(0.8 * m.max_kf):
            # a multiple of 8, as the JAX System buckets it
            n_evict = max(8, ((live - int(0.7 * m.max_kf) + 7) // 8) * 8)
            m = ms.evict_keyframes(m, n_evict,
                                   protect_recent=min(10, m.max_kf // 3))
            evicted = live - int(m.kf_valid.sum())
            self.n_kf_evictions += evicted
            self.events.append({"frame_id": self.frame_id,
                                "event": "kf_eviction", "n": evicted})
        kf_pose_old = m.kf_pose.cpu()
        self.map, remap = ms.compact_keyframes(m)
        remap_h = remap.cpu().numpy()
        self._last_kf_remap = remap_h
        self._pending_detect = None
        self.n_kf_compactions += 1
        self.events.append({"frame_id": self.frame_id,
                            "event": "kf_compaction",
                            "live_kfs": int(self.map.kf_valid.sum())})

        # a trajectory entry whose keyframe went is frozen at its absolute
        # pose
        new_refs = []
        for ref, t_cr in self._traj_refs:
            if ref >= 0 and remap_h[ref] < 0:
                new_refs.append((-1, lie.se3_compose(
                    torch.from_numpy(t_cr), kf_pose_old[ref]).numpy()))
            else:
                new_refs.append((int(remap_h[ref]) if ref >= 0 else ref,
                                 t_cr))
        self._traj_refs = new_refs

        old_ref = int(self.track.ref_kf)
        r = int(remap_h[old_ref]) if old_ref >= 0 else -1
        if r < 0:
            earlier = remap_h[:max(old_ref, 0) + 1]
            r = int(earlier.max()) if (earlier >= 0).any() else 0
        kp = self.track.kp_pt
        # points that lost their last observer leave the association cache
        kp = torch.where(
            (kp >= 0) & self.map.pt_valid[torch.clamp(kp.long(), min=0)],
            kp, -1)
        self.track = self.track._replace(
            ref_kf=tracking._i32(r, self.device), kp_pt=kp)
        if self.loop_closer is not None:
            self.loop_closer.apply_kf_remap(remap_h)
        return True

    def _record(self, pose: torch.Tensor, timestamp: float) -> None:
        self.trajectory.append(pose.cpu().numpy())
        self.timestamps.append(float(timestamp))
        # reference keyframe + relative pose, so the trajectory can be
        # re-derived through later keyframe corrections
        ref = int(self.track.ref_kf) if self.n_keyframes > 0 else -1
        if ref >= 0:
            t_cr = lie.se3_compose(pose, lie.se3_inverse(self.map.kf_pose[ref]))
            self._traj_refs.append((ref, t_cr.cpu().numpy()))
        else:
            self._traj_refs.append((-1, pose.cpu().numpy()))

    def keyframe_trajectory(self):
        """(timestamps [K], Tcw [K, 7]) of the surviving keyframes in slot
        order (`System::SaveKeyFrameTrajectoryTUM`): every loop correction
        and GBA included, an in-flight GBA waited for first."""
        self._poll_gba(blocking=True)
        sel = self.map.kf_valid
        return (self.map.kf_timestamp[sel].cpu().numpy(),
                self.map.kf_pose[sel].cpu().numpy())

    def trajectory_tcw(self, corrected: bool = False) -> np.ndarray:
        """Raw per-frame estimates, or (corrected=True) the trajectory
        re-derived through the current keyframe poses (an in-flight GBA
        is waited for and merged first)."""
        if not self.trajectory:
            return np.zeros((0, 7), np.float32)
        if not corrected:
            return np.stack(self.trajectory)
        self._poll_gba(blocking=True)
        kf_pose = self.map.kf_pose.cpu()
        kf_valid = self.map.kf_valid.cpu().numpy()
        out = []
        for raw, (ref, t_cr) in zip(self.trajectory, self._traj_refs):
            if ref >= 0 and kf_valid[ref]:
                out.append(lie.se3_compose(torch.from_numpy(t_cr),
                                           kf_pose[ref]).numpy())
            else:
                out.append(raw)
        return np.stack(out)
