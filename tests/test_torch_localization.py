"""Localization-only mode of the port's System on the CPU: the twin of
tests/test_tracking_e2e.py:90-119, on a shorter run (8 frames of mapping
and 8 of localization where the JAX test takes 12 and 8)."""

import pytest
import torch

from eao_fusion_tpu.io import synthetic
from eao_fusion_tpu_torch import config as TC
from eao_fusion_tpu_torch.io import tum
from eao_fusion_tpu_torch.pipeline.system import System


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This module's torch ops on one CPU thread. Tier-1 runs six test
    files at once; many small ops, each split over every core while other
    processes hold the cores, wait on one another far longer than they
    compute. The setting is put back after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_localization_only_mode_freezes_map():
    """Tracking against a frozen map (`System::ActivateLocalizationMode`)
    inserts no keyframe and leaves every map tensor bit-identical, while
    the poses stay accurate (ATE < 3 cm, >= 30 inliers on the last 8
    frames); switched off again, the map grows."""
    cfg = TC.SystemConfig(
        orb=TC.ORBConfig(n_features=500, max_keypoints=512),
        capacity=TC.MapCapacity(max_keyframes=64, max_points=4096),
        use_planes=False, use_objects=False)
    seq = synthetic.generate_sequence(n_frames=20, seed=0, style="arc",
                                      cache_dir=synthetic.DEFAULT_CACHE)
    s = System(cfg, device="cpu")
    for f in seq.frames[:8]:
        s.process_frame(f.gray, f.depth, f.timestamp)
    kf_before = s.n_keyframes
    before = {k: v.clone() for k, v in s.map._asdict().items()}

    s.activate_localization_mode()
    for f in seq.frames[8:16]:
        s.process_frame(f.gray, f.depth, f.timestamp)
    assert s.n_keyframes == kf_before
    for name, v in s.map._asdict().items():
        assert torch.equal(v, before[name]), f"map field {name} changed"
    err = tum.evaluate_ate_rpe(s.trajectory_tcw()[3:], seq.gt_tcw()[3:16])
    assert err.ate_rmse < 0.03, err
    assert all(d["n_inliers"] >= 30 for d in s.diags[-8:])

    s.deactivate_localization_mode()
    for f in seq.frames[16:18]:
        s.process_frame(f.gray, f.depth, f.timestamp)
    assert not torch.equal(s.map.pt_found, before["pt_found"])
