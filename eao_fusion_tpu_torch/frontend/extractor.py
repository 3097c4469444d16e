"""ORB feature extractor: pyramid -> FAST -> orientation -> steered BRIEF
(port of `eao_fusion_tpu/frontend/extractor.py`).

Per-level keypoint budgets follow the reference's geometric allocation;
slots are laid out level-major; the RGBD depth lookup gives the virtual
right coordinate uR = u - bf/z.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from eao_fusion_tpu_torch.config import CameraConfig, ORBConfig
from eao_fusion_tpu_torch.ops import fast as fast_ops
from eao_fusion_tpu_torch.ops import image as image_ops
from eao_fusion_tpu_torch.ops import orb as orb_ops
from eao_fusion_tpu_torch.types import FrameFeatures


def features_per_level(cfg: ORBConfig, total: Optional[int] = None
                       ) -> List[int]:
    """Geometric keypoint budget per level (most at level 0)."""
    total = total or cfg.max_keypoints
    inv = 1.0 / cfg.scale_factor
    raw = np.array([inv ** l for l in range(cfg.n_levels)])
    alloc = np.floor(total * raw / raw.sum()).astype(int)
    alloc[0] += total - alloc.sum()
    return [int(a) for a in alloc]


def scale_factors(cfg: ORBConfig) -> np.ndarray:
    return np.array([cfg.scale_factor ** l for l in range(cfg.n_levels)],
                    np.float32)


def extract_from_pyramid(pyramid: List[torch.Tensor], *,
                         orb_cfg: ORBConfig) -> FrameFeatures:
    """Detection + orientation + description over a prebuilt pyramid;
    depth channel unset (depth=0, uright=-1)."""
    budgets = features_per_level(orb_cfg)
    dev = pyramid[0].device

    uv_all, resp_all, lvl_all, patches_all = [], [], [], []
    for l, (level_img, budget) in enumerate(zip(pyramid, budgets)):
        if budget == 0:
            continue
        scale = orb_cfg.scale_factor ** l
        cell = max(int(round(orb_cfg.cell_size / scale)), 8)
        # FAST thresholds are in 0-255 units; images are [0, 1]
        yx, score = fast_ops.detect_level(
            level_img, float(orb_cfg.ini_th_fast) / 255.0,
            float(orb_cfg.min_th_fast) / 255.0,
            cell=cell, top_per_cell=3, n_out=budget, border=orb_ops.BORDER)
        uv_all.append(torch.stack([yx[:, 1].float() * scale,
                                   yx[:, 0].float() * scale], dim=-1))
        resp_all.append(score)
        lvl_all.append(torch.full((budget,), l, dtype=torch.int32,
                                  device=dev))
        patches_all.append(orb_ops.extract_patches(level_img, yx))

    uv = torch.cat(uv_all)
    response = torch.cat(resp_all)
    level = torch.cat(lvl_all)
    valid = response > 0.0
    patches = torch.cat(patches_all)
    angle = orb_ops.orientations(patches)
    blurred = orb_ops.blur_patches(patches, orb_cfg.blur_sigma, 3)
    desc_packed, desc_pm1 = orb_ops.descriptors_from_patches(blurred, angle)
    n = uv.shape[0]
    pm1 = torch.where(valid[:, None], desc_pm1, torch.zeros_like(desc_pm1))
    return FrameFeatures(uv=uv, response=response, level=level, angle=angle,
                         desc_packed=desc_packed, desc_pm1=pm1, valid=valid,
                         depth=torch.zeros((n,), device=dev),
                         uright=torch.full((n,), -1.0, device=dev))


def extract_features(img: torch.Tensor,
                     depth: Optional[torch.Tensor] = None,
                     *,
                     orb_cfg: ORBConfig,
                     cam_cfg: CameraConfig,
                     with_depth: bool = True) -> FrameFeatures:
    """img [H, W] f32 gray in [0, 1]; depth [H, W] f32 meters (0 = none)
    or None for monocular."""
    pyramid = image_ops.build_pyramid(img, orb_cfg.n_levels,
                                      orb_cfg.scale_factor)
    feats = extract_from_pyramid(pyramid, orb_cfg=orb_cfg)
    if not (with_depth and depth is not None):
        return feats
    uv, valid = feats.uv, feats.valid
    h, w = depth.shape
    ui = torch.clamp(torch.round(uv[:, 0]).long(), 0, w - 1)
    vi = torch.clamp(torch.round(uv[:, 1]).long(), 0, h - 1)
    d = depth[vi, ui]
    has_d = (d > 0.0) & valid
    d = torch.where(has_d, d, 0.0)
    uright = torch.where(has_d,
                         uv[:, 0] - cam_cfg.bf / torch.clamp(d, min=1e-6),
                         -1.0)
    return feats._replace(depth=d, uright=uright)

