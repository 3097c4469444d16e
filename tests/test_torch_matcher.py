"""Hamming matching of the port against the JAX package on the features of
two synthetic frames: distance matrices, projection search, mutual
matching, and the tie order of `top_k_stable`."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eao_fusion_tpu.config import ORBConfig, SystemConfig
from eao_fusion_tpu.frontend import extractor as JE
from eao_fusion_tpu.frontend import matcher as JM
from eao_fusion_tpu.io import synthetic
from eao_fusion_tpu.ops import hamming as JH
from eao_fusion_tpu.ops import lie as JL
from eao_fusion_tpu_torch.frontend import matcher as TM
from eao_fusion_tpu_torch.ops import hamming as TH
from eao_fusion_tpu_torch.ops.topk import top_k_stable
from eao_fusion_tpu_torch.types import FrameFeatures, tree_from_numpy

CFG = SystemConfig(orb=ORBConfig(n_features=500, max_keypoints=512))
CAM = (CFG.camera.fx, CFG.camera.fy, CFG.camera.cx, CFG.camera.cy)


@pytest.fixture(scope="module")
def frames():
    seq = synthetic.generate_sequence(n_frames=20, seed=0, style="arc",
                                      cache_dir=synthetic.DEFAULT_CACHE)
    out = []
    for f in (seq.frames[4], seq.frames[6]):
        fj = JE.extract_features(jnp.asarray(f.gray), jnp.asarray(f.depth),
                                 orb_cfg=CFG.orb, cam_cfg=CFG.camera)
        out.append((f, fj, tree_from_numpy(FrameFeatures, {
            k: np.asarray(v) for k, v in fj._asdict().items()}, "cpu")))
    return out


def test_top_k_stable_ties_like_lax():
    x = torch.tensor([1.0, 3.0, 3.0, 2.0, 3.0])
    vals, idx = top_k_stable(x, 3)
    assert idx.tolist() == [1, 2, 4]
    assert vals.tolist() == [3.0, 3.0, 3.0]
    import jax
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    assert idx.tolist() == np.asarray(ji).tolist()


def test_hamming_matrix_exact(frames):
    (_, fa, ta), (_, fb, tb) = frames
    a = np.asarray(JH.hamming_matrix(fa.desc_pm1, fb.desc_pm1))
    b = TH.hamming_matrix(ta.desc_pm1, tb.desc_pm1).numpy()
    np.testing.assert_array_equal(b, a)
    # against a popcount of the packed words
    pa = np.asarray(fa.desc_packed)[:16]
    pb = np.asarray(fb.desc_packed)[:16]
    pop = np.unpackbits((pa[:, None, :] ^ pb[None, :, :]).view(np.uint8),
                        axis=-1).sum(-1)
    np.testing.assert_array_equal(b[:16, :16], pop)


def test_match_points_to_frame_identical(frames):
    (fr_a, fa, ta), (fr_b, fb, tb) = frames
    # landmarks: frame A's depth keypoints, back-projected with its GT pose
    d = np.asarray(fa.depth)
    xc = np.asarray(JL.backproject(CAM, fa.uv, fa.depth))
    pts_w = np.asarray(JL.se3_apply(JL.se3_inverse(jnp.asarray(fr_a.tcw)),
                                    jnp.asarray(xc)))
    valid = np.asarray(fa.valid) & (d > 0)
    lvl = np.asarray(fa.level)
    radius = (15.0 * 1.2 ** lvl).astype(np.float32)
    args = (pts_w, np.asarray(fa.desc_pm1), valid, np.asarray(fa.angle), lvl,
            radius, lvl - 1, lvl + 1)
    kw = dict(cam=CAM, width=640, height=480, th=100)
    rj = JM.match_points_to_frame(*[jnp.asarray(a) for a in args], fb,
                                  jnp.asarray(fr_b.tcw), check_rotation=True,
                                  **kw)
    rt = TM.match_points_to_frame(*[torch.from_numpy(np.array(a))
                                    for a in args], tb,
                                  torch.from_numpy(fr_b.tcw.copy()),
                                  check_rotation=True, **kw)
    tj = np.asarray(rj.target_idx)
    assert (tj >= 0).sum() > 100
    np.testing.assert_array_equal(rt.target_idx.numpy(), tj)
    np.testing.assert_array_equal(rt.dist.numpy(), np.asarray(rj.dist))
    # the ratio-test variant of the local-map search
    rj = JM.match_points_to_frame(*[jnp.asarray(a) for a in args], fb,
                                  jnp.asarray(fr_b.tcw), nn_ratio=0.8,
                                  use_ratio=True, check_rotation=False, **kw)
    rt = TM.match_points_to_frame(*[torch.from_numpy(np.array(a))
                                    for a in args], tb,
                                  torch.from_numpy(fr_b.tcw.copy()),
                                  nn_ratio=0.8, use_ratio=True,
                                  check_rotation=False, **kw)
    np.testing.assert_array_equal(rt.target_idx.numpy(),
                                  np.asarray(rj.target_idx))


def test_mutual_match_identical(frames):
    (_, fa, ta), (_, fb, tb) = frames
    rj = JM.mutual_match(fa.desc_pm1, fa.valid, fa.angle, fb.desc_pm1,
                         fb.valid, fb.angle, th=50)
    rt = TM.mutual_match(ta.desc_pm1, ta.valid, ta.angle, tb.desc_pm1,
                         tb.valid, tb.angle, th=50)
    assert (np.asarray(rj.target_idx) >= 0).sum() > 50
    np.testing.assert_array_equal(rt.target_idx.numpy(),
                                  np.asarray(rj.target_idx))
    np.testing.assert_array_equal(rt.dist.numpy(), np.asarray(rj.dist))


def test_resolve_duplicates_and_scale_level():
    r = np.random.default_rng(3)
    best_kp = r.integers(0, 20, 200).astype(np.int32)
    best = r.integers(0, 60, 200).astype(np.int32)
    valid = r.random(200) < 0.7
    a = np.asarray(JM.resolve_duplicates(jnp.asarray(best_kp),
                                         jnp.asarray(best),
                                         jnp.asarray(valid), 20))
    b = TM.resolve_duplicates(torch.from_numpy(best_kp),
                              torch.from_numpy(best),
                              torch.from_numpy(valid), 20).numpy()
    np.testing.assert_array_equal(b, a)
    dist = r.uniform(0.3, 8, 500).astype(np.float32)
    mx = r.uniform(0.3, 8, 500).astype(np.float32)
    a = np.asarray(JM.predict_scale_level(jnp.asarray(dist), jnp.asarray(mx),
                                          1.2, 8))
    b = TM.predict_scale_level(torch.from_numpy(dist), torch.from_numpy(mx),
                               1.2, 8).numpy()
    np.testing.assert_array_equal(b, a)
