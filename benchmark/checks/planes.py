"""`planes.segment_planes`: the planes of drawn frames, from the stream's
own depth image.

  plane_mismatch      planes of the drawn frames whose presence, support
                      or boundary count differ from the reference's
  plane_gap           the largest gap of the planes of equal rank: the
                      angle between normals (rad) or the offsets'
                      difference (m)
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import planes as rplanes

from ._common import bf16, to_np

TARGET = ("eao_fusion_tpu_torch.ops.planes", "segment_planes")
NUMBERS = ("plane_mismatch", "plane_gap")
PLANE_KEYS = ("window", "mse_max", "merge_normal_dot", "merge_dist",
              "n_merge_sweeps", "min_support_px", "max_planes_per_frame",
              "max_boundary_points")


def wrap(orig, take, keep):
    def segment_planes(depth, *, cam, cfg):
        out = orig(depth, cam=cam, cfg=cfg)
        if take():
            keep(dict(
                depth=depth.detach().clone(),
                cam=(cam.fx, cam.fy, cam.cx, cam.cy),
                p={k: getattr(cfg, k) for k in PLANE_KEYS},
                out={k: getattr(out, k).detach().clone() for k in (
                    "coeffs", "n_inliers", "valid", "boundary_valid")}))
        return out
    return segment_planes


def numbers(items) -> dict:
    """plane_mismatch and plane_gap over the drawn frames."""
    if not items:
        return dict.fromkeys(NUMBERS)
    miss, gap = 0, 0.0
    for it in items:
        ref = rplanes.segment(it["depth"].cpu().numpy(), it["cam"], it["p"])
        m, g = rplanes.gaps(to_np(it["out"]), ref)
        miss, gap = miss + m, max(gap, g)
    return dict(plane_mismatch=float(miss), plane_gap=gap)


def control(it) -> dict:
    ref = rplanes.segment(it["depth"].cpu().numpy(), it["cam"], it["p"],
                          quant=bf16)
    P = it["out"]["coeffs"].shape[0]
    B = int(it["p"]["max_boundary_points"])
    k = min(len(ref["n_inliers"]), P)
    coeffs = np.zeros((P, 4), np.float32)
    coeffs[:k] = ref["coeffs"][:k]
    n_in = np.zeros(P, np.int32)
    n_in[:k] = ref["n_inliers"][:k]
    bnd = np.zeros((P, B), bool)
    for j in range(k):
        bnd[j, :ref["n_boundary"][j]] = True
    return dict(coeffs=torch.as_tensor(coeffs), n_inliers=torch.as_tensor(
        n_in), valid=torch.as_tensor(np.arange(P) < k),
        boundary_valid=torch.as_tensor(bnd))
