"""`extractor.extract_features`, the front end: the keypoints and
descriptors of drawn frames, from the stream's own image.

  feature_miss_pct    keypoints (level and pixel) of the drawn frames that
                      only one of the program and the reference has, in %
                      of the reference's
  desc_bits_pct       descriptor bits that differ on the keypoints both
                      have, in % of their bits
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import features as rfeat

from ._common import bf16, to_np

TARGET = ("eao_fusion_tpu_torch.frontend.extractor", "extract_features")
NUMBERS = ("feature_miss_pct", "desc_bits_pct")
ORB_KEYS = ("n_levels", "scale_factor", "ini_th_fast", "min_th_fast",
            "max_keypoints", "cell_size", "blur_sigma")


def wrap(orig, take, keep):
    def extract_features(img, depth=None, *, orb_cfg, cam_cfg,
                         with_depth=True):
        out = orig(img, depth, orb_cfg=orb_cfg, cam_cfg=cam_cfg,
                   with_depth=with_depth)
        if take():
            keep(dict(
                img=img.detach().clone(),
                p={k: getattr(orb_cfg, k) for k in ORB_KEYS},
                out={k: getattr(out, k).detach().clone() for k in (
                    "uv", "level", "valid", "desc_packed")}))
        return out
    return extract_features


def numbers(items) -> dict:
    """feature_miss_pct and desc_bits_pct over the drawn frames."""
    if not items:
        return dict.fromkeys(NUMBERS)
    miss, n_ref, both, bits = 0, 0, 0, 0
    for it in items:
        ref = rfeat.extract(it["img"].cpu().numpy(), it["p"])
        o = to_np(it["out"])
        prog = rfeat.program_features(o["uv"], o["level"], o["valid"],
                                      o["desc_packed"],
                                      it["p"]["scale_factor"])
        m, b, nb = rfeat.gaps(prog, ref)
        miss, n_ref, both, bits = miss + m, n_ref + len(ref), both + b, \
            bits + nb
    return dict(feature_miss_pct=100.0 * miss / max(n_ref, 1),
                desc_bits_pct=100.0 * bits / max(256 * both, 1))


def control(it) -> dict:
    ref = rfeat.extract(it["img"].cpu().numpy(), it["p"], quant=bf16)
    out = {k: v.clone() for k, v in it["out"].items()}
    n = out["uv"].shape[0]
    sc = float(it["p"]["scale_factor"])
    uv = np.zeros((n, 2), np.float32)
    level = np.zeros(n, np.int32)
    packed = np.zeros((n, 8), np.int64)
    for i, ((l, y, x), (_, bits)) in enumerate(list(ref.items())[:n]):
        uv[i] = (x * sc ** l, y * sc ** l)
        level[i] = l
        packed[i] = (bits.reshape(8, 32).astype(np.int64)
                     << np.arange(32)).sum(1)
    packed = np.where(packed >= 2 ** 31, packed - 2 ** 32, packed)
    valid = np.arange(n) < len(ref)
    return dict(uv=torch.as_tensor(uv), level=torch.as_tensor(level),
                valid=torch.as_tensor(valid),
                desc_packed=torch.as_tensor(packed.astype(np.int32)))
