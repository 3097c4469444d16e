"""Stereo input of the port against the JAX package: the epipolar SAD
matcher on frame 0 of the cached right-image file, the port's right-eye
renderer against that file, and the port's stereo System on the 16 cached
frames with the thresholds of tests/test_stereo.py. Small config (512
keypoints, 32 keyframes, 2048 points)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eao_fusion_tpu import config as JC
from eao_fusion_tpu.frontend import extractor as JE
from eao_fusion_tpu.frontend import stereo as JS
from eao_fusion_tpu.ops import image as JI
from eao_fusion_tpu.io import synthetic
from eao_fusion_tpu.pipeline.system import System as JSystem
from eao_fusion_tpu_torch import config as TC
from eao_fusion_tpu_torch import kernels
from eao_fusion_tpu_torch.frontend import stereo as TS
from eao_fusion_tpu_torch.types import FrameFeatures, tree_from_numpy
from eao_fusion_tpu_torch.io import synthetic as TSy
from eao_fusion_tpu_torch.io import tum
from eao_fusion_tpu_torch.pipeline import tracking
from eao_fusion_tpu_torch.pipeline.system import System

STEREO = dict(sensor="stereo", use_planes=False, use_objects=False)
JCFG = JC.SystemConfig(orb=JC.ORBConfig(n_features=500, max_keypoints=512),
                       capacity=JC.MapCapacity(max_keyframes=32,
                                               max_points=2048), **STEREO)
TCFG = TC.SystemConfig(orb=TC.ORBConfig(n_features=500, max_keypoints=512),
                       capacity=TC.MapCapacity(max_keyframes=32,
                                               max_points=2048), **STEREO)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This module's torch ops on one CPU thread (tier-1 runs six test
    files at once; see tests/test_torch_loop.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def seq16():
    """The port's 16-frame seed-0 arc and its cached right images."""
    seq = TSy.generate_sequence(n_frames=16, seed=0, style="arc",
                                cache_dir=synthetic.DEFAULT_CACHE)
    return seq, TSy.render_right_images(seq, seed=0,
                                        cache_dir=synthetic.DEFAULT_CACHE)


@pytest.fixture(scope="module")
def frame0(seq16):
    seq, rights = seq16
    f = seq.frames[0]
    tf = TS.extract_stereo_features(torch.from_numpy(f.gray),
                                    torch.from_numpy(rights[0]),
                                    orb_cfg=TCFG.orb, cam_cfg=TCFG.camera)
    return f, rights[0], tf


def test_stereo_match_matches_jax(frame0):
    """The left keypoints agree in at least 99% of the valid slots (the
    bound of tests/test_torch_extractor.py: the pyramids differ by up to
    1e-4); on those slots the matched sets agree on at least 99% of the
    matches, and depth and uright agree within 1e-4 relative where both
    matched."""
    f, right, tf = frame0
    jf = JS.extract_stereo_features(f.gray, right, orb_cfg=JCFG.orb,
                                    cam_cfg=JCFG.camera)
    valid = tf.valid.numpy() & np.asarray(jf.valid)
    same = valid & (np.abs(tf.uv.numpy() - np.asarray(jf.uv)).max(1) < 1e-3)
    assert same.sum() >= 0.99 * valid.sum()
    dj, dt = np.asarray(jf.depth), tf.depth.numpy()
    mj, mt = (dj > 0) & same, (dt > 0) & same
    assert mj.sum() >= 150
    assert (mj & mt).sum() >= 0.99 * max(mj.sum(), mt.sum())
    both = mj & mt
    assert (np.abs(dt[both] - dj[both]) <= 1e-4 * dj[both]).all()
    uj, ut = np.asarray(jf.uright), tf.uright.numpy()
    assert (np.abs(ut[both] - uj[both])
            <= 1e-4 * np.abs(uj[both]) + 1e-4).all()
    assert (ut[dt == 0] == -1.0).all()


def test_stereo_match_on_the_same_features(frame0):
    """`stereo_match` alone, both packages given the JAX pyramids and
    features of frame 0's pair: the same matched set (at least 99% of the
    matches; the SAD sums run in another float order) and depth and
    uright within 1e-4 relative."""
    f, right, _ = frame0
    pyr = [[np.array(x) for x in JI.build_pyramid(
        jnp.asarray(img), JCFG.orb.n_levels, JCFG.orb.scale_factor)]
        for img in (f.gray, right)]

    @jax.jit
    def jax_match(pyr_l, pyr_r):
        fl = JE.extract_from_pyramid(pyr_l, orb_cfg=JCFG.orb)
        fr = JE.extract_from_pyramid(pyr_r, orb_cfg=JCFG.orb)
        return fl, fr, JS.stereo_match(fl, fr, pyr_l, pyr_r,
                                       orb_cfg=JCFG.orb, cam_cfg=JCFG.camera)
    *fj, (dj, uj) = jax_match(*[[jnp.asarray(x) for x in p] for p in pyr])
    dj, uj = np.asarray(dj), np.asarray(uj)
    ft = [tree_from_numpy(FrameFeatures, jax.tree.map(np.asarray, x), "cpu")
          for x in fj]
    dt, ut = (a.numpy() for a in TS.stereo_match(
        *ft, *[[torch.from_numpy(x) for x in p] for p in pyr],
        orb_cfg=TCFG.orb, cam_cfg=TCFG.camera))
    mj, mt = dj > 0, dt > 0
    assert mj.sum() >= 150
    assert (mj & mt).sum() >= 0.99 * max(mj.sum(), mt.sum())
    both = mj & mt
    assert (np.abs(dt[both] - dj[both]) <= 1e-4 * dj[both]).all()
    assert (np.abs(ut[both] - uj[both])
            <= 1e-4 * np.abs(uj[both]) + 1e-4).all()


def test_stereo_depth_accuracy(frame0):
    """tests/test_stereo.py: at least 150 matches, their depths within 5%
    (median) of the renderer's depth image, uR < uL."""
    f, _, tf = frame0
    depth, uv = tf.depth.numpy(), tf.uv.numpy()
    ok = depth > 0
    assert ok.sum() >= 150, ok.sum()
    ui = np.clip(np.round(uv[ok, 0]).astype(int), 0, TCFG.camera.width - 1)
    vi = np.clip(np.round(uv[ok, 1]).astype(int), 0, TCFG.camera.height - 1)
    gt = f.depth[vi, ui]
    rel = np.abs(depth[ok] - gt) / np.maximum(gt, 1e-6)
    assert np.median(rel) < 0.05, float(np.median(rel))
    assert np.all(tf.uright.numpy()[ok] < uv[ok, 0] + 1e-3)


def test_render_right_images_matches_cache(seq16):
    """The port renders frame 0's right image as the cached file holds it
    (written by the JAX renderer under the same key)."""
    seq, rights = seq16
    one = TSy.SyntheticSequence(frames=seq.frames[:1], camera=seq.camera,
                                scene=seq.scene)
    mine = TSy.render_right_images(one)
    assert mine.shape == (1, 480, 640) and rights.shape == (16, 480, 640)
    np.testing.assert_allclose(mine[0], rights[0], atol=1e-6)


@pytest.fixture(scope="module")
def stereo_run(seq16):
    seq, rights = seq16
    s = System(TCFG, device="cpu")
    before = dict(kernels.launches)
    for f, r in zip(seq.frames, rights):
        s.process_frame(f.gray, right=r, timestamp=f.timestamp)
    assert kernels.launches == before
    return s, seq


def test_stereo_tracking_e2e(stereo_run):
    """tests/test_stereo.py: the 16-frame arc tracked from the stereo pair
    alone (initialization, tracking and keyframe mapping off matched
    stereo depth): at least 2 keyframes, ATE < 5 cm."""
    s, seq = stereo_run
    assert int(s.track.status) == tracking.STATUS_OK
    assert s.n_keyframes >= 2 and s.n_resets == 0
    err = tum.evaluate_ate_rpe(s.trajectory_tcw(), seq.gt_tcw())
    assert err.ate_rmse < 0.05, err
    # keyframes carry stereo observations
    kv = s.map.kf_valid
    assert (s.map.kf_kp_uright[kv] >= 0).sum() >= 150 * int(kv.sum())


@pytest.mark.slow
def test_stereo_system_matches_jax_system(stereo_run):
    """The JAX stereo System on the same frames (minutes of CPU compiles):
    keyframe counts within 1 and both under tests/test_stereo.py's bound."""
    s, seq = stereo_run
    rights = TSy.render_right_images(seq, seed=0,
                                     cache_dir=synthetic.DEFAULT_CACHE)
    js = JSystem(JCFG)
    for f, r in zip(seq.frames, rights):
        js.process_frame(f.gray, right=r, timestamp=f.timestamp)
    assert abs(s.n_keyframes - js.n_keyframes) <= 1
    err = tum.evaluate_ate_rpe(js.trajectory_tcw(), seq.gt_tcw())
    assert err.ate_rmse < 0.05, err
