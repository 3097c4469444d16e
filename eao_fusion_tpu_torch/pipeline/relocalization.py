"""Relocalization after tracking loss (port of
`eao_fusion_tpu/pipeline/relocalization.py`).

`Tracking::Relocalization` (`src/Tracking.cc:2786-2945`) with
`KeyFrameDatabase::DetectRelocalizationCandidates`: bag-of-words retrieval
as dense L1 scores, then per candidate keyframe a descriptor match, a
RANSAC pose (3D-3D Horn when at least 15 matches have depth, the RGBD
path; 2D-3D PnP otherwise), a projection search for more matches and the
pose solve of tracking (`pose_opt.optimize_pose`: the CUDA kernel K1 for
CUDA tensors). The candidate gating is host numpy, as in the JAX package;
the RANSAC draws come from the caller's `torch.Generator`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from eao_fusion_tpu_torch.config import SystemConfig
from eao_fusion_tpu_torch.frontend import matcher
from eao_fusion_tpu_torch.mapping import covisibility, vocabulary
from eao_fusion_tpu_torch.mapping.map_state import MapState
from eao_fusion_tpu_torch.ops import lie, ransac
from eao_fusion_tpu_torch.pipeline.tracking import _build_pose_obs
from eao_fusion_tpu_torch.solvers import pose_opt
from eao_fusion_tpu_torch.types import FrameFeatures


def reloc_candidates(m: MapState, v: torch.Tensor, bow_db: torch.Tensor,
                     max_candidates: int = 5) -> np.ndarray:
    """Candidate keyframes, best first (`DetectRelocalizationCandidates`,
    `src/KeyFrameDatabase.cc:198-310`): (1) common-word count > 0.8 x the
    largest, (2) scores accumulated over each candidate's top-10 covisible
    keyframes, (3) the groups scoring >= 0.75 x the best, each represented
    by its best keyframe. One read of the device statistics, then the host
    numpy of the JAX function."""
    Z = covisibility.observation_indicator(m)
    common, scores, covis, kf_valid = (t.cpu().numpy() for t in (
        (bow_db > 0).float() @ (v > 0).float(),
        vocabulary.l1_scores(v, bow_db, m.kf_valid),
        covisibility.covisibility_counts(Z), m.kf_valid))
    common = np.where(kf_valid, common, 0.0)
    if common.max() <= 0:
        return np.zeros((0,), np.int64)
    is_cand = common > 0.8 * common.max()
    scores = np.where(is_cand, scores, 0.0)

    covis = np.where(kf_valid[None, :] & kf_valid[:, None], covis, 0)
    K = covis.shape[0]
    top10 = np.argsort(-covis, axis=1)[:, :10]
    in_group = np.zeros((K, K), bool)
    rows = np.repeat(np.arange(K), 10)
    in_group[rows, top10.reshape(-1)] = covis[rows, top10.reshape(-1)] > 0
    in_group[np.arange(K), np.arange(K)] = True
    acc = (in_group * scores[None, :]).sum(axis=1)
    best_kf = (in_group * scores[None, :]).argmax(axis=1)
    acc = np.where(is_cand, acc, 0.0)
    retain = acc >= 0.75 * acc.max()
    cand_kfs, first = np.unique(best_kf[retain & is_cand], return_index=True)
    cand_acc = acc[retain & is_cand][first]
    return cand_kfs[np.argsort(-cand_acc)][:max_candidates]


def relocalize(m: MapState, feats: FrameFeatures, bow_db: torch.Tensor,
               vocab: vocabulary.Vocabulary, generator: torch.Generator, *,
               cfg: SystemConfig, n_candidates: int = 5,
               stats: Optional[dict] = None
               ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(pose [7], kp_pt [N] association vector), or (None, None) when no
    candidate gives 50 inliers. `stats["pose_solves"]` counts the pose
    solves (K1 launches on the card)."""
    v = vocabulary.bow_vector(vocab, feats.desc_pm1, feats.valid)
    scores = vocabulary.l1_scores(v, bow_db, m.kf_valid).cpu().numpy()
    order = reloc_candidates(m, v, bow_db, max_candidates=n_candidates)
    cam = (cfg.camera.fx, cfg.camera.fy, cfg.camera.cx, cfg.camera.cy)
    cam5 = cam + (cfg.camera.bf,)
    dev = feats.uv.device
    depth = feats.depth.cpu().numpy()

    for cand in order:
        if scores[cand] <= 0:
            break
        cand = int(cand)
        mm = matcher.mutual_match(
            m.kf_desc_pm1[cand], m.kf_kp_valid[cand], m.kf_kp_angle[cand],
            feats.desc_pm1, feats.valid, feats.angle,
            th=cfg.matcher.th_low, use_ratio=True, check_rotation=True)
        tgt = mm.target_idx.cpu().numpy()
        pt_kf = m.kf_pt_idx[cand].cpu().numpy()
        pair = (tgt >= 0) & (pt_kf >= 0)
        with_depth = pair & (depth[np.clip(tgt, 0, None)] > 0)
        if with_depth.sum() >= 15:
            # RGBD: 3D-3D Horn RANSAC on the matches with depth
            pids = torch.as_tensor(pt_kf[with_depth], device=dev).long()
            kps = torch.as_tensor(tgt[with_depth], device=dev).long()
            pc = lie.backproject(cam, feats.uv[kps], feats.depth[kps])
            ok = torch.ones(kps.shape, dtype=torch.bool, device=dev)
            res = ransac.ransac_align(
                m.pt_xyz[pids], pc, ok,
                ransac.draw_hypotheses(ok, 128, 3, generator),
                with_scale=False, inlier_th=0.10)
            pose0 = lie.sim3_to_se3(res.transform)
        elif pair.sum() >= 15:
            # monocular: 2D-3D PnP RANSAC (the reference's EPnP role,
            # `src/Tracking.cc:2830-2856`)
            pids = torch.as_tensor(pt_kf[pair], device=dev).long()
            kps = torch.as_tensor(tgt[pair], device=dev).long()
            ok = torch.ones(kps.shape, dtype=torch.bool, device=dev)
            res = ransac.ransac_pnp(
                m.pt_xyz[pids], feats.uv[kps], ok,
                ransac.draw_hypotheses(ok, 192, 6, generator), cam=cam)
            pose0 = res.pose
        else:
            continue
        if int(res.n_inliers) < 10:
            continue

        # all associations by projection, then the pose solve of tracking
        # (the reference's SearchByProjection + PoseOptimization rounds)
        n_kp = feats.uv.shape[0]
        kp_pt = torch.full((n_kp,), -1, dtype=torch.int32, device=dev)
        kp_pt[kps] = torch.where(res.inliers, pids.to(torch.int32), -1)
        P = m.max_pt
        lvl = torch.zeros((P,), dtype=torch.int32, device=dev)
        proj = matcher.match_points_to_frame(
            m.pt_xyz, m.pt_desc_pm1, m.pt_valid,
            torch.zeros((P,), device=dev), lvl,
            torch.full((P,), cfg.matcher.radius_reloc, device=dev), lvl,
            lvl + cfg.orb.n_levels, feats, pose0, cam=cam,
            width=cfg.camera.width, height=cfg.camera.height,
            th=cfg.matcher.th_high, check_rotation=False)
        kp_pt = torch.where(kp_pt >= 0, kp_pt, proj.target_idx)
        obs = _build_pose_obs(m, feats, kp_pt, cfg.orb.scale_factor)
        r = pose_opt.optimize_pose(pose0, obs, cam=cam5, cfg=cfg.solver)
        if stats is not None:
            stats["pose_solves"] = stats.get("pose_solves", 0) + 1
        if int(r.n_inliers) >= 50:
            return r.pose, torch.where(r.inliers & (kp_pt >= 0), kp_pt, -1)
    return None, None
