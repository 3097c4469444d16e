"""System facade for RGBD tracking with plane and object landmarks and
keyframe-rate local mapping (port of the RGBD subset of
`eao_fusion_tpu/pipeline/system.py`).

The host sequences the per-frame plane segmentation, `track_frame` and the
EAO object lane (frame objects, ensemble association, object update), the
keyframe-rate `insert_keyframe_rgbd`, plane-map update,
`local_mapping_step` and object merge, and the episodic point and keyframe
compaction. Boxes come from the caller (offline box files) or, with
`semantic_online`, from the port's own YOLOX lane. Loop closing and
monocular and stereo input come with later slices of the port: a config or
a call that needs them raises NotImplementedError.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from eao_fusion_tpu_torch import DeviceLike, resolve_device
from eao_fusion_tpu_torch.config import COCO_CLASS_WHITELIST, SystemConfig
from eao_fusion_tpu_torch.frontend import extractor, yolox
from eao_fusion_tpu_torch.mapping import map_state as ms
from eao_fusion_tpu_torch.mapping import plane_map
from eao_fusion_tpu_torch.objects import association
from eao_fusion_tpu_torch.objects import merge as obj_merge
from eao_fusion_tpu_torch.objects import object_map as om
from eao_fusion_tpu_torch.objects import update as obj_update
from eao_fusion_tpu_torch.ops import lie
from eao_fusion_tpu_torch.ops import planes as plane_ops
from eao_fusion_tpu_torch.pipeline import local_mapping, tracking
from eao_fusion_tpu_torch.types import FrameFeatures, FramePlanes


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


def _check_slice(cfg: SystemConfig) -> None:
    unported = [name for name, on in (
        ("use_loop_closing", cfg.use_loop_closing),
        ("sensor != 'rgbd'", cfg.sensor != "rgbd")) if on]
    if unported:
        raise NotImplementedError(
            "not ported yet (RGBD tracking, planes, objects, the detector "
            "lane and local mapping only): " + ", ".join(unported))


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
    """Feed RGBD frames, read poses and the trajectory. Runs on `cuda`
    unless `device` names another; with no card and no device named it
    raises."""

    def __init__(self, cfg: Optional[SystemConfig] = None,
                 device: DeviceLike = None):
        self.cfg = cfg or SystemConfig()
        _check_slice(self.cfg)
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
        # the object lane's randoms (isolation-forest draws), in place of
        # the JAX System's PRNGKey(7)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(7)
        self.n_obj_keyframes = 0    # keyframes inserted for a new object
        self.detector = (make_detector(self.device)
                         if self.cfg.semantic_online else None)

    def reset(self) -> None:
        """Clear the map, object and tracking state; the trajectory is kept,
        with past entries frozen at their recorded poses."""
        self.map = ms.empty_map(self.cfg, self.device)
        self.track = tracking.init_track_state(self.cfg, self.device)
        self.objects = om.empty_table(self.cfg, self.device)
        self._last_fo = None
        self.n_keyframes = 0
        self._traj_refs = [(-1, raw) for raw, _ in
                           zip(self.trajectory, self._traj_refs)]

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def process_frame(self, gray: np.ndarray,
                      depth: Optional[np.ndarray] = None,
                      timestamp: float = 0.0, boxes=None,
                      initial_pose: Optional[np.ndarray] = None,
                      right=None) -> np.ndarray:
        """Track one RGBD frame; returns the estimated Tcw [7]. `boxes` are
        the frame's detections, [B, 6] rows (class, x, y, w, h, score);
        with the online detector and no boxes given, the detector's are
        used."""
        if depth is None or right is not None:
            raise NotImplementedError(
                "only RGBD input is ported (monocular and stereo come with "
                "a later slice)")
        cfg = self.cfg
        online = self.detector is not None and boxes is None
        if online:
            # dispatch detection before feature extraction so that the two
            # overlap (the reference's InsertImage at frame start,
            # `src/Tracking.cc:318`)
            rgb = np.asarray(gray)
            self.detector.submit(np.stack([rgb, rgb, rgb], axis=-1))
        depth_t = self._tensor(depth)
        feats = extractor.extract_features(
            self._tensor(gray), depth_t, orb_cfg=cfg.orb,
            cam_cfg=cfg.camera, with_depth=True)
        planes = None
        if cfg.use_planes:
            planes = plane_ops.segment_planes(depth_t, cam=cfg.camera,
                                              cfg=cfg.planes)

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

        self.map, self.track, diag = tracking.track_frame(
            self.map, self.track, feats, self.frame_id, planes, cfg=cfg)

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
        if cfg.use_objects and boxes is not None and len(boxes):
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
        if (status == tracking.STATUS_LOST
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
        if diag_h["need_kf"] or new_object:
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

    def _on_keyframe(self, slot: int) -> None:
        """Keyframe-rate mapping: culling, fusion, local BA, stat refresh,
        then point and keyframe compaction when their tables run low."""
        if self.n_keyframes >= 3:
            self.map = local_mapping.local_mapping_step(self.map, slot,
                                                        cfg=self.cfg)
            # BA may have removed some associations as outliers
            self.track = self.track._replace(kp_pt=self.map.kf_pt_idx[slot])
        if self.cfg.use_objects:
            # keyframe-rate object maintenance (`LocalMapping::Run` :86-91)
            self.objects = obj_merge.merge_and_overlap(
                self.objects, self.map.pt_xyz, self.generator, cfg=self.cfg)
        self._maybe_compact_points()
        self._maybe_compact_keyframes()

    def _maybe_compact_points(self) -> bool:
        """Point-slot compaction when the insertion cursor runs low:
        `next_pt` is append-only, so without it point creation would stop
        at `max_pt` lifetime insertions."""
        if int(self.map.next_pt) <= 0.9 * self.map.max_pt:
            return False
        self.map, remap = ms.compact_points(self.map)
        self.n_pt_compactions += 1
        self.events.append({"frame_id": self.frame_id,
                            "event": "pt_compaction",
                            "live_pts": int(self.map.pt_valid.sum())})
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

    def _maybe_compact_keyframes(self) -> bool:
        """Keyframe-slot lifecycle: when insertion reaches 0.9 of the table,
        reclaim the slots that culling freed; if the table is full of live
        keyframes (exploration), first evict the ones least tied to the
        recent window. Lifetime keyframe insertions become unbounded. The
        map's own references are remapped by `compact_keyframes`; here the
        tracking reference and the trajectory references follow. (The JAX
        System also drops its pending loop detection and remaps the loop
        closer's keyframe ids; those come with the loop-closing slice.)"""
        m = self.map
        if int(m.next_kf) < int(0.9 * m.max_kf):
            return False
        live = int(m.kf_valid.sum())
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

    def trajectory_tcw(self, corrected: bool = False) -> np.ndarray:
        """Raw per-frame estimates, or (corrected=True) the trajectory
        re-derived through the current keyframe poses."""
        if not self.trajectory:
            return np.zeros((0, 7), np.float32)
        if not corrected:
            return np.stack(self.trajectory)
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
