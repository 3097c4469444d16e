"""The whole slice against the JAX package: RGBD tracking with
keyframe-rate local BA over the 20-frame seed-0 arc (small config; objects
and loop closing off, planes off and on), the port's System on the CPU
beside the JAX System on the same frames; which options the port
accepts, what the mesh-routed global BA needs, and where it routes frames
without depth."""

import numpy as np
import pytest
import torch

from eao_fusion_tpu.config import MapCapacity, ORBConfig, SystemConfig
from eao_fusion_tpu.io import synthetic
from eao_fusion_tpu.ops import lie as JL
from eao_fusion_tpu.pipeline.system import System as JSystem
from eao_fusion_tpu_torch import config as TC
from eao_fusion_tpu_torch import kernels
from eao_fusion_tpu_torch.io import tum
from eao_fusion_tpu_torch.pipeline.system import System

OFF = dict(use_planes=False, use_objects=False, use_loop_closing=False)


def _tcfg(**kw):
    return TC.SystemConfig(
        orb=TC.ORBConfig(n_features=500, max_keypoints=512),
        capacity=TC.MapCapacity(max_keyframes=64, max_points=4096),
        **{**OFF, **kw})


def _run_both(**kw):
    """The 20-frame seed-0 arc through the JAX System and the port's System
    (CPU); returns both Systems, the sequence and whether any kernel was
    launched."""
    seq = synthetic.generate_sequence(n_frames=20, seed=0, style="arc",
                                      cache_dir=synthetic.DEFAULT_CACHE)
    js = JSystem(SystemConfig(
        orb=ORBConfig(n_features=500, max_keypoints=512),
        capacity=MapCapacity(max_keyframes=64, max_points=4096),
        **{**OFF, **kw}))
    ts = System(_tcfg(**kw), device="cpu")
    before = dict(kernels.launches)
    for f in seq.frames:
        js.process_frame(f.gray, f.depth, f.timestamp)
        ts.process_frame(f.gray, f.depth, f.timestamp)
    return js, ts, seq, kernels.launches != before


def _assert_same_trajectory(a, b):
    """Per-frame camera centres within 5 mm, rotations within 0.3 degrees."""
    assert a.shape == b.shape
    ca = np.asarray(JL.se3_inverse(a))[:, 4:7]
    cb = np.asarray(JL.se3_inverse(b))[:, 4:7]
    assert np.linalg.norm(ca - cb, axis=1).max() < 5e-3
    dq = np.abs(np.sum(a[:, :4] * b[:, :4], axis=1)).clip(max=1.0)
    assert np.degrees(2 * np.arccos(dq)).max() < 0.3


def test_slice_matches_jax_system():
    js, ts, seq, launched = _run_both()
    # the CPU path never touches a kernel
    assert not launched

    a, b = ts.trajectory_tcw(), js.trajectory_tcw()
    assert a.shape == b.shape == (20, 7)
    _assert_same_trajectory(a, b)
    assert abs(ts.n_keyframes - js.n_keyframes) <= 1
    assert ts.n_keyframes >= 4                  # local BA ran
    err = tum.evaluate_ate_rpe(a, seq.gt_tcw())
    assert err.ate_rmse < 0.02, err
    assert all(d["n_inliers"] > 50 for d in ts.diags)
    assert ts.n_resets == 0


def test_slice_with_planes_matches_jax_system():
    """The default RGBD path with planes on: plane segmentation on every
    frame, plane factors in the second pose solve and in local BA, plane
    landmarks at every keyframe. Same tolerances as the planes-off run, the
    same number of map planes in both Systems, and the JAX package's
    full-config bound ATE < 1.5 cm (tests/test_tracking_e2e.py)."""
    js, ts, seq, launched = _run_both(use_planes=True)
    assert not launched

    a, b = ts.trajectory_tcw(), js.trajectory_tcw()
    assert a.shape == b.shape == (20, 7)
    _assert_same_trajectory(a, b)
    assert abs(ts.n_keyframes - js.n_keyframes) <= 1
    assert ts.n_keyframes >= 4
    n_pl_t = int(ts.map.pl_valid.sum())
    assert n_pl_t == int(np.asarray(js.map.pl_valid).sum())
    assert n_pl_t >= 2
    # planes are matched on most tracked frames
    matched = [d["n_planes_matched"] for d in ts.diags]
    assert sum(m > 0 for m in matched) >= 0.8 * len(matched)
    assert matched == [d["n_planes_matched"] for d in js.diags]
    err = tum.evaluate_ate_rpe(a, seq.gt_tcw())
    assert err.ate_rmse < 0.015, err
    assert ts.n_resets == 0


def test_device_defaults_to_the_card(monkeypatch):
    """With no card and no device named, the System raises; there is no
    silent CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        System(_tcfg())


def test_mesh_gba_needs_a_process_group():
    """A global BA over a 2-rank mesh (`tum_fr3_config(gba_mesh_devices=2)`)
    without an initialized process group raises, naming it: there is no
    single-device fallback. The routed path runs in
    tests/test_torch_gba_mesh.py."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        System(TC.tum_fr3_config(gba_mesh_devices=2), device="cpu")


@pytest.mark.parametrize("flag", ["use_objects", "semantic_online",
                                  "use_loop_closing"])
def test_ported_options_are_accepted(flag):
    """Objects, the online detector lane and loop closing are ported: the
    System starts with an empty object table; with `semantic_online` a
    detector loaded from the shipped weights; with `use_loop_closing` a
    loop closer holding the shipped vocabulary and an empty bow table."""
    s = System(_tcfg(**{flag: True}), device="cpu")
    assert int(s.objects.valid.sum()) == 0
    if flag == "semantic_online":
        assert s.detector is not None and s.detector.n_classes == 8
    else:
        assert s.detector is None
    if flag == "use_loop_closing":
        lc = s.loop_closer
        assert lc.vocab.n_words == 8192 and not lc.bow.any()
        assert s.n_loops_closed == s.n_relocalizations == 0
    else:
        assert s.loop_closer is None


def test_missing_vocabulary_raises(monkeypatch, tmp_path):
    """No random codebook in place of the shipped vocabulary: with loop
    closing on and no vocabulary file the System raises."""
    from eao_fusion_tpu_torch.mapping import vocabulary
    monkeypatch.setattr(vocabulary, "DEFAULT_VOCAB_PATH",
                        str(tmp_path / "none.npz"))
    with pytest.raises(FileNotFoundError, match="vocabulary"):
        System(_tcfg(use_loop_closing=True), device="cpu")


def test_missing_detector_weights_raise(monkeypatch, tmp_path):
    """No silent fallback to random weights: a named weights file that does
    not exist raises, and so does finding none of the default files."""
    from eao_fusion_tpu_torch.pipeline import system as tsys
    monkeypatch.setenv("EAO_YOLOX_WEIGHTS", str(tmp_path / "none.npz"))
    with pytest.raises(FileNotFoundError, match="EAO_YOLOX_WEIGHTS"):
        System(_tcfg(semantic_online=True), device="cpu")
    monkeypatch.delenv("EAO_YOLOX_WEIGHTS")
    monkeypatch.setattr(tsys, "WEIGHT_CANDIDATES", ("data/no_such.npz",))
    with pytest.raises(FileNotFoundError, match="no weights"):
        System(_tcfg(semantic_online=True), device="cpu")


def test_input_without_depth_takes_the_mono_path():
    """Monocular input is ported: under `sensor="mono"`, and for a frame
    without depth or right image under the RGBD sensor, the frame goes to
    two-view initialization, which holds it as the reference frame: the
    System stays UNINIT at the identity with an empty map."""
    seq = synthetic.generate_sequence(n_frames=3, seed=0, style="arc",
                                      cache_dir=synthetic.DEFAULT_CACHE)
    f = seq.frames[0]
    # the mono sensor takes the mono path even where depth is given
    for cfg, depth in ((_tcfg(sensor="mono"), f.depth), (_tcfg(), None)):
        s = System(cfg, device="cpu")
        pose = s.process_frame(f.gray, depth, f.timestamp)
        np.testing.assert_array_equal(pose, [1, 0, 0, 0, 0, 0, 0])
        assert int(s.track.status) == 0 and s._mono_ref is not None
        assert s.n_keyframes == 0 and int(s.map.next_pt) == 0


def test_right_image_takes_the_stereo_path():
    """Stereo input is ported: a frame with a right image and no depth is
    matched left to right and initializes the map from the stereo depths,
    as RGBD initializes from the depth image."""
    seq = synthetic.generate_sequence(n_frames=16, seed=0, style="arc",
                                      cache_dir=synthetic.DEFAULT_CACHE)
    right = synthetic.render_right_images(seq, seed=0,
                                          cache_dir=synthetic.DEFAULT_CACHE)
    s = System(_tcfg(sensor="stereo"), device="cpu")
    s.process_frame(seq.frames[0].gray, right=right[0], timestamp=0.0)
    assert int(s.track.status) == 1 and s.n_keyframes == 1
    n_pts = int(s.map.next_pt)
    assert n_pts >= 150
    assert (s.map.kf_kp_uright[0][s.map.kf_pt_idx[0] >= 0] >= 0).all()


def test_planes_option_is_ported():
    """`use_planes` (the default) is accepted: the first frame segments
    its planes and makes them map landmarks owned by keyframe 0."""
    seq = synthetic.generate_sequence(n_frames=20, seed=0, style="arc",
                                      cache_dir=synthetic.DEFAULT_CACHE)
    s = System(_tcfg(use_planes=True), device="cpu")
    s.process_frame(seq.frames[0].gray, seq.frames[0].depth, 0.0)
    n_pl = int(s.map.pl_valid.sum())
    assert n_pl >= 2
    assert (s.map.pl_ref_kf[:n_pl] == 0).all()
    assert int((s.map.kf_pl_idx[0] >= 0).sum()) == n_pl


def test_full_keyframe_table_compacts():
    """Where next_kf reaches 0.9 of the table, the keyframe slots are
    compacted (the JAX System's `_maybe_compact_keyframes`): next_kf falls
    back to the live count, the tracking reference follows its keyframe,
    and an event is recorded."""
    seq = synthetic.generate_sequence(n_frames=20, seed=0, style="arc",
                                      cache_dir=synthetic.DEFAULT_CACHE)
    s = System(_tcfg(), device="cpu")
    s.process_frame(seq.frames[0].gray, seq.frames[0].depth, 0.0)
    K = s.map.max_kf
    s._on_keyframe(0)                          # far from full: nothing
    assert s.n_kf_compactions == 0
    s.map = s.map._replace(next_kf=torch.tensor(int(0.9 * K),
                                                dtype=torch.int32))
    s._on_keyframe(0)
    assert s.n_kf_compactions == 1 and s.n_kf_evictions == 0
    assert int(s.map.next_kf) == int(s.map.kf_valid.sum()) == 1
    assert int(s.track.ref_kf) == 0
    assert s.events[-1]["event"] == "kf_compaction"
