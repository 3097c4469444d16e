"""The port's CLI (`python -m eao_fusion_tpu_torch.apps.run_tum`) on the
CPU over a dataset that the port's writer makes from the first 6 frames of
the cached 20-frame arc: every output parses, the ATE holds the bound of
tests/test_tracking_e2e.py, and a resumed map in localization-only mode
inserts no keyframe."""

import json

import numpy as np
import pytest
import torch

from eao_fusion_tpu.io import synthetic as JS
from eao_fusion_tpu_torch.apps import run_tum
from eao_fusion_tpu_torch.io import synthetic, tum
from eao_fusion_tpu_torch.ops import lie
from eao_fusion_tpu_torch.tools.make_tum_dataset import encode_png, \
    write_dataset

N_FRAMES = 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This module's torch ops on one CPU thread (tier-1 runs six test
    files at once); the setting is put back after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dataset(root):
    seq = synthetic.generate_sequence(n_frames=20, seed=0, style="arc",
                                      cache_dir=JS.DEFAULT_CACHE)
    seq.frames = seq.frames[:N_FRAMES]
    write_dataset(str(root), seq)
    return seq


def test_cli_outputs_ate_and_localization_resume(tmp_path):
    ds = tmp_path / "ds"
    seq = _dataset(ds)
    out = {k: str(tmp_path / k) for k in ("traj.txt", "kitti.txt",
                                          "kf.txt", "log.jsonl", "c.npz")}
    base = [str(ds), "--device", "cpu", "--boxes", str(ds / "boxes"),
            "--gt", str(ds / "groundtruth.txt"), "--no-loop",
            "--no-objects"]
    s = run_tum.main(base + ["--out", out["traj.txt"],
                             "--kitti", out["kitti.txt"],
                             "--kf-out", out["kf.txt"],
                             "--log-jsonl", out["log.jsonl"],
                             "--checkpoint", out["c.npz"]])
    assert s.device.type == "cpu" and len(s.trajectory) == N_FRAMES

    ts, twc = tum.read_groundtruth(out["traj.txt"])
    assert len(ts) == N_FRAMES
    np.testing.assert_allclose(ts, [f.timestamp for f in seq.frames],
                               atol=1e-6)
    est = lie.se3_inverse(torch.from_numpy(twc)).numpy()
    err = tum.evaluate_ate_rpe(est, seq.gt_tcw())
    assert err.ate_rmse < 0.02, err
    kitti = np.loadtxt(out["kitti.txt"])
    assert kitti.shape == (N_FRAMES, 12)
    np.testing.assert_allclose(kitti[:, [3, 7, 11]], twc[:, 4:], atol=1e-5)
    kf_ts, kf_twc = tum.read_groundtruth(out["kf.txt"])
    assert len(kf_ts) == s.n_keyframes >= 2
    recs = [json.loads(line) for line in open(out["log.jsonl"])]
    frames = [r for r in recs if "frame" in r]
    assert len(frames) == N_FRAMES - 1          # the init frame has none
    assert all(r["n_inliers"] > 30 for r in frames)
    summary = recs[-1]
    assert summary["event"] == "summary" and summary["frames"] == N_FRAMES
    assert summary["device"] == "cpu"

    # the same frames against the resumed map, in localization-only mode
    s2 = run_tum.main(base + ["--out", str(tmp_path / "traj2.txt"),
                              "--resume", out["c.npz"],
                              "--localization-only"])
    assert s2.localization_only
    assert s2.n_keyframes == s.n_keyframes
    assert int(s2.map.next_kf) == int(s.map.next_kf)
    assert torch.equal(s2.map.kf_pose, s.map.kf_pose)
    assert len(s2.trajectory) == 2 * N_FRAMES
    assert all(d["n_inliers"] > 30 for d in s2.diags)


def test_cli_refuses_a_directory_without_rgb_txt(tmp_path):
    with pytest.raises(SystemExit, match="rgb.txt"):
        run_tum.main([str(tmp_path), "--device", "cpu"])


def test_right_image_reader_matches_the_prefetcher(tmp_path):
    """The stereo lane's right images go through the native decoder with
    the prefetcher's grey weights."""
    from eao_fusion_tpu_torch.io import native_loader
    r = np.random.default_rng(0)
    img = r.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    grey = r.integers(0, 256, (48, 64), dtype=np.uint8)
    (tmp_path / "c.png").write_bytes(encode_png(img))
    (tmp_path / "g.png").write_bytes(encode_png(grey))
    with native_loader.FramePrefetcher([str(tmp_path / "c.png")], None,
                                       [0.0], width=64, height=48) as pf:
        (_, _, want, _), = list(pf)
    np.testing.assert_allclose(run_tum._gray_png(str(tmp_path / "c.png")),
                               want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(run_tum._gray_png(str(tmp_path / "g.png")),
                                  grey.astype(np.float32) / 255.0)
