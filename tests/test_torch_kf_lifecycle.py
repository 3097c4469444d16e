"""Keyframe-slot lifecycle of the port against the JAX package:
`compact_keyframes` and `evict_keyframes` on one map state carried across
(planes on, so plane references are remapped too), and the port's System
beside the JAX System on a 24-frame run whose 12-slot keyframe table
forces compaction and eviction (loop closing off in both)."""

import numpy as np
import pytest
import torch

import jax

from eao_fusion_tpu.config import (MapCapacity, ORBConfig, SystemConfig,
                                   TrackingConfig)
from eao_fusion_tpu.io import synthetic
from eao_fusion_tpu.mapping import map_state as JMS
from eao_fusion_tpu.ops import lie as JL
from eao_fusion_tpu.pipeline.system import System as JSystem
from eao_fusion_tpu_torch import config as TC
from eao_fusion_tpu_torch import kernels
from eao_fusion_tpu_torch.io import tum
from eao_fusion_tpu_torch.mapping import map_state as TMS
from eao_fusion_tpu_torch.pipeline.system import System

SMALL = dict(use_planes=True, use_objects=False, use_loop_closing=False)


def _np(tree):
    return jax.tree.map(np.asarray, tree)._asdict()


@pytest.fixture(scope="module")
def jax_map():
    """A map after the 14-frame seed-3 arc (small config, planes on, 16
    keyframe slots), built by the port's System and carried across to a
    JAX MapState."""
    seq = synthetic.generate_sequence(n_frames=14, seed=3, style="arc",
                                      cache_dir=synthetic.DEFAULT_CACHE)
    s = System(TC.SystemConfig(
        orb=TC.ORBConfig(n_features=500, max_keypoints=512),
        capacity=TC.MapCapacity(max_keyframes=16, max_points=3072,
                                max_local_ba_kfs=16), **SMALL), device="cpu")
    for f in seq.frames:
        s.process_frame(f.gray, f.depth, timestamp=f.timestamp)
    return JMS.MapState(**{k: jax.numpy.asarray(v)
                           for k, v in TMS.to_numpy(s.map).items()})


def _assert_maps_equal(mt, mj):
    """Every field identical: compaction and eviction only move rows and
    remap indices, so there is no arithmetic to differ in."""
    for k, v in _np(mj).items():
        np.testing.assert_array_equal(getattr(mt, k).cpu().numpy(), v,
                                      err_msg=k)


def test_compact_keyframes_matches_jax(jax_map):
    """Keyframes 0, 1 and the second newest culled by hand. Keyframe 0 owns
    the first frame's planes and points, so those are re-anchored to their
    first surviving observer: identical remap, kf_valid, pt_ref_kf,
    pl_ref_kf and every other field."""
    n_kf = int(jax_map.next_kf)
    assert n_kf >= 6
    assert int((np.asarray(jax_map.pl_ref_kf) == 0).sum()) >= 1
    kf_valid = np.asarray(jax_map.kf_valid).copy()
    kf_valid[[0, 1, n_kf - 2]] = False
    mj = jax_map._replace(kf_valid=jax.numpy.asarray(kf_valid))
    mt = TMS.from_numpy(_np(mj), "cpu")

    mj2, rj = jax.jit(JMS.compact_keyframes)(mj)
    mt2, rt = TMS.compact_keyframes(mt)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    assert rt.dtype == torch.int32
    _assert_maps_equal(mt2, mj2)
    # the culled owner's planes moved to a surviving observer
    old = np.asarray(mj.pl_ref_kf)
    assert (np.asarray(mj2.pl_ref_kf)[(old == 0) & np.asarray(mj2.pl_valid)]
            >= 0).all()


@pytest.mark.parametrize("n_evict,protect", [(2, 2), (8, 5)])
def test_evict_keyframes_matches_jax(jax_map, n_evict, protect):
    """The same victims (lowest covisibility with the protected window,
    oldest first on ties), and with one victim made object-created, the
    same deprioritised choice."""
    mt = TMS.from_numpy(_np(jax_map), "cpu")
    ev = jax.jit(JMS.evict_keyframes, static_argnums=(1, 2))
    mj2 = ev(jax_map, n_evict, protect)
    mt2 = TMS.evict_keyframes(mt, n_evict, protect_recent=protect)
    np.testing.assert_array_equal(mt2.kf_valid.numpy(),
                                  np.asarray(mj2.kf_valid))
    victims = np.where(np.asarray(jax_map.kf_valid)
                       & ~np.asarray(mj2.kf_valid))[0]
    assert 1 <= len(victims) <= n_evict

    by_obj = np.asarray(jax_map.kf_by_obj).copy()
    by_obj[victims[0]] = True
    mj3 = ev(jax_map._replace(kf_by_obj=jax.numpy.asarray(by_obj)),
             n_evict, protect)
    mt3 = TMS.evict_keyframes(mt._replace(kf_by_obj=torch.from_numpy(by_obj)),
                              n_evict, protect_recent=protect)
    np.testing.assert_array_equal(mt3.kf_valid.numpy(),
                                  np.asarray(mj3.kf_valid))


def test_system_compaction_matches_jax_system():
    """The 24-frame seed-0 arc with a keyframe allowed every frame into
    12 slots (the capacity of tests/test_kf_lifecycle.py, cut so that
    compaction fires in 24 frames), planes on, loop closing off: the same
    compactions and evictions, per-frame poses within 5 mm / 0.3 degrees,
    and that test's bounds (lifetime keyframes > 12, next_kf <= 12, no
    reset, corrected-trajectory ATE < 5 cm)."""
    seq = synthetic.generate_sequence(n_frames=24, seed=0, style="arc",
                                      cache_dir=synthetic.DEFAULT_CACHE)
    js = JSystem(SystemConfig(
        orb=ORBConfig(n_features=500, max_keypoints=512),
        capacity=MapCapacity(max_keyframes=12, max_points=3072,
                             max_local_ba_kfs=12),
        tracking=TrackingConfig(max_frames_between_kf=1), **SMALL))
    ts = System(TC.SystemConfig(
        orb=TC.ORBConfig(n_features=500, max_keypoints=512),
        capacity=TC.MapCapacity(max_keyframes=12, max_points=3072,
                                max_local_ba_kfs=12),
        tracking=TC.TrackingConfig(max_frames_between_kf=1), **SMALL),
        device="cpu")
    before = dict(kernels.launches)
    for k, f in enumerate(seq.frames):
        js.process_frame(f.gray, f.depth, timestamp=k / 30.0)
        ts.process_frame(f.gray, f.depth, timestamp=k / 30.0)
    assert kernels.launches == before

    assert ts.n_kf_compactions >= 1
    assert ts.n_kf_compactions == js.n_kf_compactions
    assert ts.n_kf_evictions == js.n_kf_evictions
    assert ts.events == js.events          # frame, kind and sizes of each
    assert ts.n_keyframes == js.n_keyframes > 12
    assert int(ts.map.next_kf) == int(js.map.next_kf) <= 12
    assert int(ts.track.ref_kf) == int(js.track.ref_kf)
    assert ts.n_resets == js.n_resets == 0

    for corrected in (False, True):
        a = ts.trajectory_tcw(corrected=corrected)
        b = js.trajectory_tcw(corrected=corrected)
        ca = np.asarray(JL.se3_inverse(a))[:, 4:7]
        cb = np.asarray(JL.se3_inverse(b))[:, 4:7]
        assert np.linalg.norm(ca - cb, axis=1).max() < 5e-3
        dq = np.abs(np.sum(a[:, :4] * b[:, :4], axis=1)).clip(max=1.0)
        assert np.degrees(2 * np.arccos(dq)).max() < 0.3
    err = tum.evaluate_ate_rpe(ts.trajectory_tcw(corrected=True),
                               seq.gt_tcw())
    assert err.ate_rmse < 0.05, err
