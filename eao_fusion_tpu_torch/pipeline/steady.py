"""The steady-state SLAM step: tracking, plane segmentation, the EAO object
lane and keyframe-rate mapping for one frame, and a chunk of frames in one
call (port of `eao_fusion_tpu/pipeline/steady.py`).

The JAX package makes the whole frame one jitted function, the keyframe
branch a `lax.cond` and a chunk a `lax.scan`, so that the host dispatches
once per chunk. Here the chunk is a Python loop over `slam_step`, and the
keyframe branch is a branch on the host: every scalar the host gates a
frame on (the tracker's keyframe decision, its status, whether the object
lane made an object, the keyframe cursor) comes back in one device -> host
read per frame. The step's own modules read more (the tracker's retry
branches, local mapping).

Loop closing, compaction and relocalization do not run inside a chunk:
`System.chunk_epilogue` runs them at the chunk's boundary. The randoms
come from the System's `torch.Generator` (the JAX step splits its PRNG
key, `steady.py:91`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from eao_fusion_tpu_torch.config import SystemConfig
from eao_fusion_tpu_torch.frontend import extractor
from eao_fusion_tpu_torch.mapping import map_state as ms
from eao_fusion_tpu_torch.mapping import plane_map
from eao_fusion_tpu_torch.objects import association
from eao_fusion_tpu_torch.objects import merge as obj_merge
from eao_fusion_tpu_torch.objects import object_map as om
from eao_fusion_tpu_torch.objects import update as obj_update
from eao_fusion_tpu_torch.ops import planes as plane_ops
from eao_fusion_tpu_torch.pipeline import local_mapping, tracking
from eao_fusion_tpu_torch.types import (FramePlanes, FrameFeatures,
                                        tree_from_numpy)
from eao_fusion_tpu_torch.utils import profiling

# the per-frame diagnostics that `slam_chunk` stacks (`steady.py:161-167`)
CHUNK_DIAG = ("n_inliers", "kf_inserted", "kf_trigger", "n_ref",
              "tracked_close", "untracked_close", "pose")


class SteadyState(NamedTuple):
    """Carry of the steady-state loop."""
    m: ms.MapState
    ts: tracking.TrackState
    objs: om.ObjectTable
    last_fo: om.FrameObjects
    frame_id: int                    # host frame counter
    generator: torch.Generator


def empty_frame_objects(cfg: SystemConfig, m: ms.MapState,
                        ts: tracking.TrackState) -> om.FrameObjects:
    """Frame objects of an empty detection table: the object lane's "last
    frame" before the first, or after a point compaction."""
    n = cfg.orb.max_keypoints
    dev = ts.pose.device
    feats = FrameFeatures(*(torch.zeros_like(x) for x in ts.last_feats))
    return om.build_frame_objects(
        torch.zeros((cfg.objects.max_objects_2d, 6), device=dev), feats,
        torch.full((n,), -1, dtype=torch.int32, device=dev), m.pt_xyz,
        m.pt_valid, ts.pose, cfg=cfg)


def _keyframe_branch(m: ms.MapState, ts: tracking.TrackState,
                     feats: FrameFeatures, fp: Optional[FramePlanes],
                     fid: int, timestamp: float, cfg: SystemConfig,
                     by_obj: bool = False
                     ) -> Tuple[ms.MapState, tracking.TrackState]:
    """Insertion, the plane landmark update and local mapping, as the
    System's keyframe path (`src/Tracking.cc:2521` and
    `LocalMapping::Run`)."""
    cam = (cfg.camera.fx, cfg.camera.fy, cfg.camera.cx, cfg.camera.cy)
    with profiling.span("mapping.insert"):
        m, slot = ms.insert_keyframe(m, feats, ts.pose, fid, timestamp,
                                     ts.kp_pt, by_obj=by_obj)
    with profiling.span("mapping.points"):
        m = ms.create_points_from_depth(
            m, slot, feats, ts.pose, ts.kp_pt,
            float(cfg.camera.depth_threshold), cam, fid,
            scale_factor=cfg.orb.scale_factor, n_levels=cfg.orb.n_levels)
        dev = ts.pose.device
        m = ms.refresh_obs_rows(m, torch.tensor([slot], device=dev))
    if fp is not None:
        with profiling.span("mapping.plane_map"):
            assoc = plane_map.associate_planes(m, fp, ts.pose, cfg=cfg)
            m, plane_ids = plane_map.update_plane_map(m, fp, assoc, ts.pose,
                                                      slot, cfg=cfg)
            m = plane_map.record_kf_plane_obs(m, slot, fp, plane_ids)
    with profiling.span("mapping.local"):
        m = local_mapping.local_mapping_step(m, slot, cfg=cfg)
    ts = ts._replace(kp_pt=m.kf_pt_idx[slot],
                     last_kf_frame_id=tracking._i32(fid, dev),
                     ref_kf=tracking._i32(slot, dev))
    return m, ts


def slam_step(st: SteadyState, gray: torch.Tensor, depth: torch.Tensor,
              boxes: torch.Tensor, timestamp: float, *, cfg: SystemConfig,
              kf_every: int = 0, maps: tracking.WholeMap = tracking.WHOLE
              ) -> Tuple[SteadyState, dict]:
    """One steady-state frame. `boxes` is a fixed-shape [B, 6] detection
    table (class, x, y, w, h, score; score <= 0 rows are padding), and the
    object lane runs on every frame over it. `kf_every` > 0 pins a keyframe
    cadence (one per that many frames while tracking is OK, in place of the
    tracker's decision); 0 takes the tracker's decision, or a new map
    object's. `maps` runs the landmark-axis steps (`tracking.WholeMap`;
    `parallel/sharded_step` passes a map split over ranks): the object
    lane reads its whole point table, and the keyframe branch runs on its
    whole map."""
    m, ts, objs, last_fo, fid, gen = st
    with profiling.span("frontend.extract"):
        feats = extractor.extract_features(gray, depth, orb_cfg=cfg.orb,
                                           cam_cfg=cfg.camera)
    fp = None
    if cfg.use_planes:
        with profiling.span("frontend.planes"):
            fp = plane_ops.segment_planes(depth, cam=cfg.camera,
                                          cfg=cfg.planes)

    with profiling.span("tracking.track"):
        m, ts, diag = tracking.track_frame(m, ts, feats, fid, fp, cfg=cfg,
                                           maps=maps)

    # ---- object lane (per frame) ----
    with profiling.span("objects.lane"):
        new_obj = torch.zeros((), dtype=torch.bool, device=ts.pose.device)
        if cfg.use_objects:
            pt_xyz, pt_valid = maps.whole_points(m)
            with profiling.span("objects.build"):
                fo = om.build_frame_objects(boxes, feats, ts.kp_pt, pt_xyz,
                                            pt_valid, ts.pose, cfg=cfg)
            with profiling.span("objects.merge"):
                fo = om.merge_frame_objects(fo, last_fo, pt_valid, cfg=cfg)
            with profiling.span("objects.associate"):
                assoc = association.ensemble_associate(objs, fo, pt_xyz,
                                                       ts.pose, fid, cfg=cfg)
            prev_next_obj = objs.next_obj
            with profiling.span("objects.update"):
                objs = obj_update.object_update(objs, fo, assoc, pt_xyz,
                                                ts.pose, fid, gen, cfg=cfg)
            new_obj = objs.next_obj > prev_next_obj
            last_fo = fo

    # ---- keyframe branch: one read of what the host gates on ----
    with profiling.span("steady.gate"):
        need_kf, status, made, next_kf = torch.stack([
            diag["need_kf"].long(), ts.status.long(), new_obj.long(),
            m.next_kf.long()]).tolist()
        ok = status == tracking.STATUS_OK
        by_obj = False
        if kf_every:
            need = fid % kf_every == 0 and ok
        else:
            need_classic = bool(need_kf) and ok
            # a newly created map object also triggers a keyframe (the
            # reference's NeedNewKeyFrame returns 2 on AppearNewObject,
            # `src/Tracking.cc:2390-2462`); such keyframes carry the
            # `kf_by_obj` culling exemption
            need_obj = bool(made) and ok
            need = need_classic or need_obj
            by_obj = need_obj and not need_classic
        need = need and next_kf < maps.n_keyframes(m)
    if need:
        with profiling.span("mapping.kf_branch"):
            m, ts = _keyframe_branch(maps.gather(m), ts, feats, fp, fid,
                                     timestamp, cfg, by_obj=by_obj)
            if cfg.use_objects:
                with profiling.span("objects.merge_overlap"):
                    objs = obj_merge.merge_and_overlap(objs, m.pt_xyz, gen,
                                                       cfg=cfg)
            m = maps.keep_rows(m)

    diag = dict(diag)
    diag["kf_inserted"] = need
    diag["kf_trigger"] = diag["kf_trigger"] + 8 * new_obj.to(torch.int32)
    return SteadyState(m=m, ts=ts, objs=objs, last_fo=last_fo,
                       frame_id=fid + 1, generator=gen), diag


def slam_chunk(st: SteadyState, grays: torch.Tensor, depths: torch.Tensor,
               boxes: torch.Tensor, timestamps, *, cfg: SystemConfig,
               kf_every: int = 0, maps: tracking.WholeMap = tracking.WHOLE
               ) -> Tuple[SteadyState, dict]:
    """`slam_step` over a [T, H, W] chunk of frames (`boxes` [T, B, 6],
    `timestamps` [T]). Returns the carry and the stacked per-frame
    diagnostics of `CHUNK_DIAG` (`pose` is the pose after each frame)."""
    profiling.follow_profiler()
    with profiling.span("steady.slam_chunk", chunk=st.frame_id):
        if isinstance(timestamps, torch.Tensor):
            timestamps = timestamps.tolist()
        per = {k: [] for k in CHUNK_DIAG}
        for t in range(grays.shape[0]):
            with profiling.span("steady.step", frame=st.frame_id):
                st, diag = slam_step(st, grays[t], depths[t], boxes[t],
                                     float(timestamps[t]), cfg=cfg,
                                     kf_every=kf_every, maps=maps)
            for k in CHUNK_DIAG[:-1]:
                per[k].append(diag[k])
            per["pose"].append(st.ts.pose)
        out = {k: (torch.tensor(v, device=grays.device)
                   if k == "kf_inserted" else torch.stack(v))
               for k, v in per.items()}
    return st, out


def steady_state_from_numpy(d, device, generator: torch.Generator
                            ) -> SteadyState:
    """SteadyState from the JAX package's steady carry as a dict (or
    NamedTuple) of numpy arrays or trees of them: the map, the track state,
    the object table and the last frame objects carried whole; the JAX PRNG
    key is not carried, the randoms come from `generator`."""
    if hasattr(d, "_asdict"):
        d = d._asdict()
    return SteadyState(
        m=ms.from_numpy(d["m"], device),
        ts=tracking.track_state_from_numpy(d["ts"], device),
        objs=tree_from_numpy(om.ObjectTable, d["objs"], device),
        last_fo=tree_from_numpy(om.FrameObjects, d["last_fo"], device),
        frame_id=int(d["frame_id"]), generator=generator)


def init_steady_state(system) -> SteadyState:
    """The steady carry of a warmed-up System, drawing from the System's
    generator."""
    last_fo = system._last_fo
    if last_fo is None:
        last_fo = empty_frame_objects(system.cfg, system.map, system.track)
    return SteadyState(m=system.map, ts=system.track, objs=system.objects,
                       last_fo=last_fo, frame_id=system.frame_id,
                       generator=system.generator)
