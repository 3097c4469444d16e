"""Covisibility as indicator-matrix products (port of
`eao_fusion_tpu/mapping/covisibility.py`).

With Z ∈ {0,1}^[K, P] the observation indicator: covis = Z Zᵀ (shared
point counts), votes = Z s, local points = Zᵀ 1_kfs. The top-k calls here
use only the k-th value, so tie order does not matter.
"""

from __future__ import annotations

import torch

from eao_fusion_tpu_torch.mapping.map_state import MapState
from eao_fusion_tpu_torch.ops.topk import top_k_stable


def observation_indicator(m: MapState) -> torch.Tensor:
    """Z [K, P] f32: 1 where keyframe k observes point p (culled keyframes
    drop out even if the cached indicator is one refresh behind)."""
    return (m.obs_ind & m.kf_valid[:, None]).float()


def covisibility_counts(Z: torch.Tensor) -> torch.Tensor:
    """[K, K] shared-observation counts; diagonal = per-KF point count."""
    return Z @ Z.T


def local_keyframes(Z: torch.Tensor, seen_pts: torch.Tensor,
                    kf_valid: torch.Tensor, k_top: int) -> torch.Tensor:
    """bool [K] mask of the top `k_top` keyframes by votes of `seen_pts`
    (vote > 0)."""
    votes = Z @ seen_pts.float()
    votes = torch.where(kf_valid, votes, -1.0)
    k_top = min(k_top, votes.shape[0])
    thresh = torch.topk(votes, k_top).values[-1]
    return (votes >= torch.clamp(thresh, min=1.0)) & kf_valid


def points_of_keyframes(Z: torch.Tensor, kf_mask: torch.Tensor
                        ) -> torch.Tensor:
    """bool [P]: points observed by any keyframe in kf_mask."""
    return (Z.T @ kf_mask.float()) > 0.5


def top_covisible(covis: torch.Tensor, kf_slot: int, kf_valid: torch.Tensor,
                  k_top: int, min_shared: int = 15) -> torch.Tensor:
    """bool [K] mask of the best-connected keyframes of `kf_slot`: those
    sharing at least the k_top-th largest count and at least `min_shared`
    points (`KeyFrame::GetBestCovisibilityKeyFrames`,
    `src/KeyFrame.cc:210`)."""
    row = covis[kf_slot].clone()
    row[kf_slot] = 0.0
    row = torch.where(kf_valid, row, 0.0)
    k_top = min(k_top, row.shape[0])
    thresh = top_k_stable(row, k_top)[0][-1]
    return (row >= torch.clamp(thresh, min=float(min_shared))) & kf_valid
