"""The port's CLI on the CPU with `--stereo` and `--mono` over the first
frames of the cached arcs, as the port's writer puts them on disk: right
images are paired by timestamp and read by the native decoder (the
bound of tests/test_stereo.py:58-60); monocular input initializes from
two views and is held after scale alignment (tests/test_mono_e2e.py:
22-31)."""

import numpy as np
import pytest
import torch

from eao_fusion_tpu.io import synthetic as JS
from eao_fusion_tpu_torch.apps import run_tum
from eao_fusion_tpu_torch.io import synthetic, tum
from eao_fusion_tpu_torch.tools.make_tum_dataset import write_dataset


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This module's torch ops on one CPU thread (tier-1 runs six test
    files at once); the setting is put back after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_cli_stereo_lane(tmp_path):
    seq = synthetic.generate_sequence(n_frames=16, seed=0, style="arc",
                                      cache_dir=JS.DEFAULT_CACHE)
    right = synthetic.render_right_images(seq, cache_dir=JS.DEFAULT_CACHE)
    seq.frames = seq.frames[:6]
    ds = tmp_path / "ds"
    write_dataset(str(ds), seq, right[:6])
    s = run_tum.main([str(ds), "--device", "cpu", "--stereo", "--no-loop",
                      "--no-objects", "--gt", str(ds / "groundtruth.txt"),
                      "--out", str(tmp_path / "t.txt")])
    assert s.cfg.sensor == "stereo" and not s.cfg.use_planes
    assert len(s.trajectory) == 6 and s.n_keyframes >= 2
    assert all(d["n_inliers"] > 30 for d in s.diags)
    err = tum.evaluate_ate_rpe(s.trajectory_tcw(), seq.gt_tcw())
    assert err.ate_rmse < 0.05, err
    assert len(np.loadtxt(tmp_path / "t.txt")) == 6


def test_cli_mono_lane(tmp_path):
    seq = synthetic.generate_sequence(n_frames=20, seed=0, style="arc",
                                      cache_dir=JS.DEFAULT_CACHE)
    seq.frames = seq.frames[:8]
    ds = tmp_path / "ds"
    write_dataset(str(ds), seq)
    s = run_tum.main([str(ds), "--device", "cpu", "--mono", "--no-loop",
                      "--no-objects", "--gt", str(ds / "groundtruth.txt"),
                      "--out", str(tmp_path / "t.txt")])
    assert s.cfg.sensor == "mono"
    assert s.n_keyframes >= 2 and int(s.map.pt_valid.sum()) > 250
    est = s.trajectory_tcw()
    i0 = next(i for i, p in enumerate(est)
              if not np.allclose(p, [1, 0, 0, 0, 0, 0, 0]))
    err = tum.evaluate_ate_rpe(est[i0:], seq.gt_tcw()[i0:], with_scale=True)
    assert err.ate_rmse < 0.04, err
