"""The port's CLI on the CPU with the IMU gravity alignment and the steady
chunked mode over the first 6 frames of the cached arc, in the JAX
package's default configuration (planes, objects from the box files, loop
closing), and its offline visual artifacts."""

import json

import numpy as np
import pytest
import torch

from eao_fusion_tpu.io import synthetic as JS
from eao_fusion_tpu_torch.apps import run_tum
from eao_fusion_tpu_torch.io import imu, synthetic, tum
from eao_fusion_tpu_torch.ops import lie
from eao_fusion_tpu_torch.tools.make_tum_dataset import write_dataset


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This module's torch ops on one CPU thread (tier-1 runs six test
    files at once); the setting is put back after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_cli_imu_alignment_chunks_and_viz(tmp_path):
    pytest.importorskip("matplotlib")
    seq = synthetic.generate_sequence(n_frames=20, seed=0, style="arc",
                                      cache_dir=JS.DEFAULT_CACHE)
    seq.frames = seq.frames[:6]
    ds = tmp_path / "ds"
    write_dataset(str(ds), seq)
    log = str(tmp_path / "log.jsonl")
    viz = tmp_path / "viz"
    s = run_tum.main([str(ds), "--device", "cpu", "--boxes",
                      str(ds / "boxes"), "--imu",
                      str(ds / "accelerometer.txt"), "--chunk", "3",
                      "--out", str(tmp_path / "t.txt"), "--log-jsonl", log,
                      "--viz-dir", str(viz)])
    # the first pose's world z axis (R[:, 2] in camera coordinates) lies
    # along the measured acceleration (tests/test_aux.py:58-64)
    a = tum.read_accelerometer(str(ds / "accelerometer.txt"))[0].accel
    R = lie.quat_to_rotmat(torch.from_numpy(s.trajectory[0][:4])).numpy()
    np.testing.assert_allclose(R[:, 2], a / np.linalg.norm(a), atol=1e-5)
    np.testing.assert_allclose(s.trajectory[0],
                               imu.gravity_init_pose(a), atol=1e-6)
    # three frames per process_frame warm-up (three keyframes), then one
    # chunk of three through slam_chunk and chunk_epilogue
    recs = [json.loads(line) for line in open(log)]
    frames = [r for r in recs if "frame" in r]
    assert len(frames) == 5
    assert [("kf_inserted" in r) for r in frames] == [False] * 2 + [True] * 3
    assert all(r["n_inliers"] > 30 for r in frames)
    assert s.n_keyframes >= 3
    # motion relative to the first frame is the ground truth's, in the
    # gravity-aligned world
    est = s.trajectory_tcw()
    rel = lie.se3_compose(torch.from_numpy(est[-1]),
                          lie.se3_inverse(torch.from_numpy(est[0])))
    gt = seq.gt_tcw()
    rel_gt = lie.se3_compose(torch.from_numpy(gt[-1]),
                             lie.se3_inverse(torch.from_numpy(gt[0])))
    assert float(torch.norm(rel[4:] - rel_gt[4:])) < 0.02
    for name in ("map_topview.png", "quadric_overlay.png"):
        data = (viz / name).read_bytes()
        assert data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) > 1000
