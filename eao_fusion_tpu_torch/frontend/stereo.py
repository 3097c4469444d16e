"""Stereo lane: left and right ORB extraction and epipolar stereo matching
(port of `eao_fusion_tpu/frontend/stereo.py`).

`Frame::ComputeStereoMatches` (`src/Frame.cc:841-1014`, the path behind
`System::TrackStereo`) as in the JAX package: the coarse match is one
masked [N, N] Hamming matrix (row band, octave band, disparity range and
validity as a boolean mask); the subpixel refinement runs the reference's
11x11 sliding-window SAD for all keypoints at once, the windows gathered
from the pyramid level of each left keypoint's octave (the level-major
slot layout of `extract_from_pyramid` groups the keypoints by octave).

Kept from the reference: the candidate gates (|vR - vL| <= 2 scale(octave
R), octave within ±1, uR in [uL - maxD, uL + 3], maxD = bf / baseline);
the best Hamming distance below TH_HIGH, then the centre-subtracted L1
correlation over incR in [-5, 5]; the parabola subpixel step, rejecting
|deltaR| > 1 and minima at the window's edge; disparity in [0, maxD) with
the 0.01 clamp, depth = bf / disparity; the median-SAD outlier rejection
at 1.5 * 1.4 * median.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from eao_fusion_tpu_torch.config import CameraConfig, ORBConfig
from eao_fusion_tpu_torch.frontend import extractor
from eao_fusion_tpu_torch.ops import hamming
from eao_fusion_tpu_torch.ops import image as image_ops
from eao_fusion_tpu_torch.types import FrameFeatures

_W = 5     # correlation half-window (11x11 patch), `src/Frame.cc:936`
_L = 5     # incR search radius, `src/Frame.cc:942`
TH_HIGH = 100


def _correlate_level(pyr_l: torch.Tensor, pyr_r: torch.Tensor,
                     su: torch.Tensor, sv: torch.Tensor, sur: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sliding-window SAD for one octave. su / sv / sur are integer pixel
    coordinates in this level's images; the 11x11 window and the 11x21
    strip are read as the JAX `dynamic_slice`s read them, clamped at the
    border (`image.windows`). Returns (best incR with its subpixel step,
    best SAD, ok)."""
    rows, cols = pyr_r.shape
    side = 2 * _W + 1
    il = image_ops.windows(pyr_l, sv - _W, su - _W, side, side)
    ir = image_ops.windows(pyr_r, sv - _W, sur - _L - _W, side,
                           side + 2 * _L)                    # [B, 11, 21]
    ilc = il - il[:, _W, _W][:, None, None]
    # 11 shifted windows, each centred by its own centre pixel
    # (`src/Frame.cc:949-952`)
    d = torch.stack([
        torch.abs(ilc - (ir[:, :, o:o + side]
                         - ir[:, _W, o + _W][:, None, None])).sum(dim=(1, 2))
        for o in range(2 * _L + 1)], dim=1)                     # [B, 11]
    bi = torch.argmin(d, dim=1)

    def at(idx):
        return torch.gather(d, 1, idx[:, None])[:, 0]

    d1 = at(torch.clamp(bi - 1, min=0))
    d2 = at(bi)
    d3 = at(torch.clamp(bi + 1, max=2 * _L))
    denom = d1 + d3 - 2.0 * d2
    delta = torch.where(torch.abs(denom) > 1e-9,
                        (d1 - d3) / (2.0 * torch.clamp(denom, min=1e-9)), 0.0)
    ok = ((bi > 0) & (bi < 2 * _L)                # not at the window's edge
          # a flat valley (denom ~ 0) has an infinite deltaR in the
          # reference, rejected by its |deltaR| > 1 gate (`src/Frame.cc:974`)
          & (denom > 1e-9)
          & (torch.abs(delta) <= 1.0)
          # in bounds (the reference's iniu / endu check)
          & (sv - _W >= 0) & (sv + _W < rows)
          & (su - _W >= 0) & (su + _W < pyr_l.shape[1])
          & (sur - _L - _W >= 0) & (sur + _L + _W < cols))
    return (bi - _L).float() + delta, d2, ok


def stereo_match(feats_l: FrameFeatures, feats_r: FrameFeatures,
                 pyr_l: List[torch.Tensor], pyr_r: List[torch.Tensor], *,
                 orb_cfg: ORBConfig, cam_cfg: CameraConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Left -> right stereo match. Returns (depth [N], uright [N]) for the
    left features (0 / -1 where unmatched)."""
    sf = extractor.scale_factors(orb_cfg)
    max_d = cam_cfg.bf / cam_cfg.baseline        # = fx (`src/Frame.cc:870`)
    dev = feats_l.uv.device

    # ---- coarse match: one masked Hamming matrix ----------------------
    dist = hamming.hamming_matrix(feats_l.desc_pm1, feats_r.desc_pm1)
    band = 2.0 * torch.from_numpy(sf).to(dev)[feats_r.level.long()] + 0.5
    dv = torch.abs(feats_l.uv[:, 1][:, None] - feats_r.uv[:, 1][None, :])
    dl = torch.abs(feats_l.level[:, None] - feats_r.level[None, :])
    ur = feats_r.uv[:, 0][None, :]
    ul = feats_l.uv[:, 0][:, None]
    feas = ((dv <= band[None, :]) & (dl <= 1)
            & (ur >= ul - max_d) & (ur <= ul + 3.0)
            & feats_l.valid[:, None] & feats_r.valid[None, :])
    dist = torch.where(feas, dist, hamming.N_BITS)
    best_r = torch.argmin(dist, dim=1)        # the first of tied minima
    best_d = torch.amin(dist, dim=1)
    matched = best_d < TH_HIGH

    # ---- subpixel correlation at each left keypoint's octave ----------
    # slots are level-major with fixed budgets: one slice per octave
    u_r0 = feats_r.uv[best_r, 0]
    inc_parts, sad_parts, ok_parts = [], [], []
    off = 0
    for l, b in enumerate(extractor.features_per_level(orb_cfg)):
        if b == 0:
            continue
        inv = float(1.0 / sf[l])
        sl = slice(off, off + b)
        su = torch.round(feats_l.uv[sl, 0] * inv).to(torch.int32)
        sv = torch.round(feats_l.uv[sl, 1] * inv).to(torch.int32)
        sur = torch.round(u_r0[sl] * inv).to(torch.int32)
        inc, sad, ok = _correlate_level(pyr_l[l], pyr_r[l], su, sv, sur)
        inc_parts.append(float(sf[l]) * (sur.float() + inc))
        sad_parts.append(sad)
        ok_parts.append(ok)
        off += b
    best_ur = torch.cat(inc_parts)                       # level-0 coords
    sad = torch.cat(sad_parts)
    ok = torch.cat(ok_parts) & matched

    disparity = feats_l.uv[:, 0] - best_ur
    ok = ok & (disparity >= 0.0) & (disparity < max_d)
    disparity = torch.clamp(disparity, min=0.01)         # `src/Frame.cc:991`

    # ---- median SAD rejection (`src/Frame.cc:1002-1014`) --------------
    n_ok = ok.sum()
    sorted_sad = torch.sort(torch.where(ok, sad, float("inf"))).values
    median = sorted_sad[torch.clamp(n_ok // 2, 0, sad.shape[0] - 1)]
    ok = ok & (sad < 1.5 * 1.4 * median)

    depth = torch.where(ok, cam_cfg.bf / disparity, 0.0)
    uright = torch.where(ok, feats_l.uv[:, 0] - disparity, -1.0)
    return depth, uright


def extract_stereo_features(left: torch.Tensor, right: torch.Tensor, *,
                            orb_cfg: ORBConfig,
                            cam_cfg: CameraConfig) -> FrameFeatures:
    """The stereo front end: ORB on both rectified images, then the left
    features' depth and uright channels filled by epipolar matching."""
    pyr_l = image_ops.build_pyramid(left, orb_cfg.n_levels,
                                    orb_cfg.scale_factor)
    pyr_r = image_ops.build_pyramid(right, orb_cfg.n_levels,
                                    orb_cfg.scale_factor)
    feats_l = extractor.extract_from_pyramid(pyr_l, orb_cfg=orb_cfg)
    feats_r = extractor.extract_from_pyramid(pyr_r, orb_cfg=orb_cfg)
    depth, uright = stereo_match(feats_l, feats_r, pyr_l, pyr_r,
                                 orb_cfg=orb_cfg, cam_cfg=cam_cfg)
    return feats_l._replace(depth=depth, uright=uright)
