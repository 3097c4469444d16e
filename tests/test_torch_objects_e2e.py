"""The object lane end to end against the JAX package: the JAX System and
the port's System (CPU) over the 16-frame seed-0 arc with the renderer's
boxes as offline boxes (the small config of tests/test_objects.py: planes
and loop closing off, objects "Full"), and the port alone with its online
YOLOX lane on the class-textured arc."""

import os

import numpy as np
import torch

from eao_fusion_tpu.config import MapCapacity, ORBConfig, SystemConfig
from eao_fusion_tpu.io import synthetic
from eao_fusion_tpu.pipeline.system import System as JSystem
from eao_fusion_tpu_torch import config as TC
from eao_fusion_tpu_torch import kernels
from eao_fusion_tpu_torch.io import tum
from eao_fusion_tpu_torch.pipeline.system import System

from test_torch_slice_e2e import _assert_same_trajectory

SMALL = dict(use_planes=False, use_loop_closing=False)
# the port's object centres against the JAX System's, per class: the
# isolation-forest draws of the two Systems differ, so their member sets
# do too (the largest distance on this run is 7.0 mm: 128 members against
# 131 in one object)
CENTRE_TOL_M = 0.02


def _tcfg(**kw):
    return TC.SystemConfig(
        orb=TC.ORBConfig(n_features=500, max_keypoints=512),
        capacity=TC.MapCapacity(max_keyframes=64, max_points=4096),
        **{**SMALL, **kw})


def _objects(tab):
    """(class, centre) of every valid object, as numpy."""
    valid = np.asarray(tab.valid).astype(bool)
    cls = np.asarray(tab.cls)[valid]
    cen = np.asarray(tab.center)[valid]
    return cls, cen


def test_objects_match_jax_system():
    seq = synthetic.generate_sequence(n_frames=16, seed=0, style="arc",
                                      cache_dir=synthetic.DEFAULT_CACHE)
    js = JSystem(SystemConfig(
        orb=ORBConfig(n_features=500, max_keypoints=512),
        capacity=MapCapacity(max_keyframes=64, max_points=4096), **SMALL))
    ts = System(_tcfg(), device="cpu")
    assert ts.cfg.use_objects and ts.cfg.objects.mode == "Full"
    before = dict(kernels.launches)
    for f in seq.frames:
        js.process_frame(f.gray, f.depth, f.timestamp, boxes=f.boxes)
        ts.process_frame(f.gray, f.depth, f.timestamp, boxes=f.boxes)
    assert kernels.launches == before          # the CPU path launches none

    _assert_same_trajectory(ts.trajectory_tcw(), js.trajectory_tcw())
    assert abs(ts.n_keyframes - js.n_keyframes) <= 1
    assert ts.n_resets == 0

    cls_t, cen_t = _objects(ts.objects)
    cls_j, cen_j = _objects(js.objects)
    assert sorted(cls_t) == sorted(cls_j)
    for c, p in zip(cls_t, cen_t):
        d = np.linalg.norm(cen_j[cls_j == c] - p, axis=1).min()
        assert d < CENTRE_TOL_M, (c, d)

    # the JAX package's bounds (tests/test_objects.py:51-71) on the port
    n_obj = len(cls_t)
    assert 3 <= n_obj <= 6, n_obj
    gt_centers = np.stack([(b.lo + b.hi) / 2 for b in seq.scene.boxes])
    gt_classes = {b.class_id for b in seq.scene.boxes}
    valid = np.where(ts.objects.valid.numpy())[0]
    for o, c in zip(valid, cen_t):
        assert np.linalg.norm(gt_centers - c, axis=1).min() < 0.4
        assert int(ts.objects.n_frames[o]) >= max(3, len(seq.frames) // 4)
    assert len(set(cls_t.tolist()) & gt_classes) >= 3
    # every cuboid holds its centre (tests/test_objects.py:89-97)
    lo = ts.objects.cub_min.numpy()[valid]
    hi = ts.objects.cub_max.numpy()[valid]
    assert np.all(lo <= cen_t + 1e-5) and np.all(cen_t <= hi + 1e-5)
    assert np.all(hi - lo < 1.5)
    err = tum.evaluate_ate_rpe(ts.trajectory_tcw(), seq.gt_tcw())
    assert err.ate_rmse < 0.02, err


def test_online_detector_lane_builds_objects(monkeypatch):
    """`semantic_online` with no boxes: the port's own YOLOX lane with the
    shipped weights feeds the object lane (the bounds of
    tests/test_yolox_train.py::test_system_online_semantic_e2e, on 8
    frames)."""
    monkeypatch.setenv("EAO_YOLOX_WEIGHTS", os.path.join(
        os.path.dirname(__file__), "..", "data", "yolox_synth.npz"))
    seq = synthetic.generate_sequence(
        n_frames=24, seed=0, style="arc", n_objects=4, class_textures=True,
        cache_dir=synthetic.DEFAULT_CACHE)
    s = System(_tcfg(semantic_online=True), device="cpu")
    assert s.detector is not None and s.detector.n_classes == 8
    for f in seq.frames[:8]:
        s.process_frame(f.gray, f.depth, f.timestamp)       # no boxes
    err = tum.evaluate_ate_rpe(s.trajectory_tcw(), seq.gt_tcw()[:8])
    assert err.ate_rmse < 0.03, err
    assert int(s.objects.valid.sum()) >= 1
    assert s.n_resets == 0
    assert torch.equal(s.objects.next_obj >= 1, torch.tensor(True))
