"""Descriptor matching as masked Hamming matrices (port of
`eao_fusion_tpu/frontend/matcher.py`).

Every projection search becomes one dense Hamming matrix with a boolean
feasibility mask, a row-wise best / second-best reduction, duplicate
resolution and the rotation-histogram filter. Thresholds follow the
reference exactly (TH_HIGH 100, TH_LOW 50, ratio, 30-bin histogram keeping
the top 3 bins). `argmin` / `argmax` take the first index in both
frameworks; `lax.top_k` is only used for its values here.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from eao_fusion_tpu_torch.ops import hamming, lie

INF = 10 ** 9


class MatchResult(NamedTuple):
    target_idx: torch.Tensor   # [A] int32, -1 = none
    dist: torch.Tensor         # [A] int32 (valid where target_idx >= 0)


def project_points(tcw: torch.Tensor, pts_w: torch.Tensor, cam,
                   width: int, height: int, border: float = 0.0
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """World points -> (uv [P,2], z [P], in_image [P])."""
    xc = lie.se3_apply(tcw, pts_w)
    z = xc[:, 2]
    uv = lie.project(cam, xc)
    ok = ((z > 0.05) & (uv[:, 0] >= border) & (uv[:, 0] < width - border)
          & (uv[:, 1] >= border) & (uv[:, 1] < height - border))
    return uv, z, ok


def resolve_duplicates(best_kp: torch.Tensor, best_dist: torch.Tensor,
                       valid: torch.Tensor, n_kp: int) -> torch.Tensor:
    """Many source rows may claim one keypoint; the lowest distance wins,
    ties to the lowest row. Returns kp_to_src [n_kp] int32 (-1 unclaimed)."""
    a = best_kp.shape[0]
    dev = best_kp.device
    rows = torch.arange(a, dtype=torch.int64, device=dev)
    key = torch.where(valid, best_dist.long() * a + rows, INF)
    slot = torch.where(valid, best_kp.long(), 0)
    best_key = torch.full((n_kp,), INF, dtype=torch.int64, device=dev)
    best_key = best_key.scatter_reduce(0, slot, key, reduce="amin")
    winner = valid & (key == best_key[slot])
    # `.at[...].set(mode="drop")`: the rows that do not win write a spare
    # slot, dropped after (a keypoint has one winner: keys are distinct)
    kp_to_src = torch.full((n_kp + 1,), -1, dtype=torch.int32, device=dev)
    kp_to_src[torch.where(winner, best_kp.long(), n_kp)] = rows.to(
        torch.int32)
    return kp_to_src[:n_kp]


def rotation_consistency(angle_src: torch.Tensor, angle_kp: torch.Tensor,
                         kp_idx: torch.Tensor, valid: torch.Tensor,
                         histo_length: int = 30) -> torch.Tensor:
    """ORB-SLAM rotation histogram: keep matches whose angle-difference bin
    is among the 3 most populated. Returns the filtered validity mask."""
    two_pi = 2.0 * math.pi
    a_kp = angle_kp[torch.clamp(kp_idx.long(), 0, angle_kp.shape[0] - 1)]
    # `jnp.mod`: an exact fmod, moved into [0, 2π) — not torch.remainder,
    # whose a - b·floor(a/b) rounds differently at bin edges
    rot = torch.fmod(angle_src - a_kp, two_pi)
    rot = torch.where(rot < 0, rot + two_pi, rot)
    bins = torch.clamp((rot / two_pi * histo_length).to(torch.int64),
                       0, histo_length - 1)
    counts = torch.zeros((histo_length,), dtype=torch.int64,
                         device=valid.device)
    counts = counts.index_add(0, torch.where(valid, bins, 0),
                              valid.to(torch.int64))
    third = torch.topk(counts, 3).values[2]      # values only: ties harmless
    keep_bin = counts >= torch.clamp(third, min=1)
    return valid & keep_bin[bins]


def masked_best2(dist: torch.Tensor, mask: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Row-wise best and second-best over a masked distance matrix:
    (best_idx [A], best [A], second [A])."""
    d = torch.where(mask, dist, INF)
    best = torch.amin(d, dim=1)
    best_idx = torch.argmin(d, dim=1)
    # a scatter of the scalar: an assignment of one would copy it from the
    # host, and wait for the card
    second = torch.amin(d.scatter(1, best_idx[:, None], INF), dim=1)
    return best_idx.to(torch.int32), best, second


def candidate_matches(
        pts_w, pt_desc_pm1, pt_valid, radius_px, level_lo, level_hi, feats,
        tcw, *, cam, width: int, height: int, th: int = 100,
        nn_ratio: float = 1.0, use_ratio: bool = False
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The row-wise half of the projection search: each landmark row's
    best keypoint, its distance and whether it passes the threshold and
    ratio tests, (best_kp [P] int32, best [P], ok [P] bool). Every row is
    independent of the others."""
    uv_p, _, in_img = project_points(tcw, pts_w, cam, width, height)
    dist = hamming.hamming_matrix(pt_desc_pm1, feats.desc_pm1)   # [P, N]

    du = uv_p[:, 0:1] - feats.uv[None, :, 0]
    dv = uv_p[:, 1:2] - feats.uv[None, :, 1]
    within = ((torch.abs(du) <= radius_px[:, None])
              & (torch.abs(dv) <= radius_px[:, None]))
    lvl_ok = ((feats.level[None, :] >= level_lo[:, None])
              & (feats.level[None, :] <= level_hi[:, None]))
    mask = (within & lvl_ok & in_img[:, None] & pt_valid[:, None]
            & feats.valid[None, :])

    best_kp, best, second = masked_best2(dist, mask)
    ok = (best <= th) & (best < INF)
    if use_ratio:
        ok = ok & (best.float()
                   <= nn_ratio * torch.clamp(second, max=th + 1).float())
    return best_kp, best, ok


def match_points_to_frame(
        pts_w, pt_desc_pm1, pt_valid, pt_ref_angle, pt_level, radius_px,
        level_lo, level_hi, feats, tcw, *, cam, width: int, height: int,
        th: int = 100, nn_ratio: float = 1.0, use_ratio: bool = False,
        histo_length: int = 30, check_rotation: bool = True) -> MatchResult:
    """Projection search of P landmark points into the frame; returns the
    keypoint-centric association (target_idx[k] = source row or -1)."""
    best_kp, best, ok = candidate_matches(
        pts_w, pt_desc_pm1, pt_valid, radius_px, level_lo, level_hi, feats,
        tcw, cam=cam, width=width, height=height, th=th, nn_ratio=nn_ratio,
        use_ratio=use_ratio)
    n_kp = feats.uv.shape[0]
    kp_to_src = resolve_duplicates(best_kp, best, ok, n_kp)
    matched = kp_to_src >= 0
    if check_rotation:
        src_angle = pt_ref_angle[torch.clamp(kp_to_src.long(), 0,
                                             pts_w.shape[0] - 1)]
        matched = rotation_consistency(
            src_angle, feats.angle,
            torch.arange(n_kp, device=matched.device), matched, histo_length)
    kp_to_src = torch.where(matched, kp_to_src, -1)
    d_out = torch.where(matched, best[torch.clamp(kp_to_src.long(), min=0)],
                        INF)
    return MatchResult(target_idx=kp_to_src, dist=d_out.to(torch.int32))


def mutual_match(desc_a, valid_a, angle_a, desc_b, valid_b, angle_b, *,
                 th: int = 50, nn_ratio: float = 0.9, use_ratio: bool = True,
                 check_rotation: bool = True) -> MatchResult:
    """Unconstrained mutual-best descriptor matching; per-A matched B."""
    dist = hamming.hamming_matrix(desc_a, desc_b)
    mask = valid_a[:, None] & valid_b[None, :]
    best_b, best, second = masked_best2(dist, mask)
    ok = best <= th
    if use_ratio:
        ok = ok & (best.float()
                   <= nn_ratio * torch.clamp(second, max=th + 1).float())
    best_a_for_b = torch.argmin(torch.where(mask, dist, INF), dim=0)
    mutual = best_a_for_b[torch.clamp(best_b.long(), min=0)] == torch.arange(
        desc_a.shape[0], device=dist.device)
    ok = ok & mutual
    if check_rotation:
        ok = rotation_consistency(angle_a, angle_b, best_b, ok)
    return MatchResult(target_idx=torch.where(ok, best_b, -1),
                       dist=torch.where(ok, best, INF).to(torch.int32))


def predict_scale_level(dist_w: torch.Tensor, max_dist: torch.Tensor,
                        scale_factor: float, n_levels: int) -> torch.Tensor:
    """MapPoint::PredictScale."""
    ratio = torch.clamp(max_dist, min=1e-6) / torch.clamp(dist_w, min=1e-6)
    lvl = torch.ceil(torch.log(ratio) / torch.log(
        torch.tensor(scale_factor, dtype=torch.float32, device=ratio.device)))
    return torch.clamp(lvl, 0, n_levels - 1).to(torch.int32)
