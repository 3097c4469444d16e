"""Relocalization of the port's System on the CPU: the twin of
tests/test_reloc_e2e.py (a blackout, then a revisited view), and the
relocalization routine itself on that view, through its RGBD (Horn) and its
monocular (PnP) branch."""

import numpy as np
import pytest
import torch

from eao_fusion_tpu.io import synthetic
from eao_fusion_tpu_torch import config as TC
from eao_fusion_tpu_torch.frontend import extractor
from eao_fusion_tpu_torch.ops import lie
from eao_fusion_tpu_torch.pipeline import relocalization
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


def _system():
    cfg = TC.SystemConfig(
        orb=TC.ORBConfig(n_features=500, max_keypoints=512),
        capacity=TC.MapCapacity(max_keyframes=64, max_points=4096),
        use_planes=False, use_objects=False)
    # no automatic reset, so that a loss goes to relocalization
    cfg = cfg.replace(tracking=cfg.tracking.__class__(
        **{**cfg.tracking.__dict__, "reset_if_lost_below_kfs": 0}))
    return System(cfg, device="cpu")


def _pose_err(pose, tcw):
    d = lie.se3_log(lie.se3_compose(
        lie.se3_inverse(torch.as_tensor(np.asarray(pose, np.float32))),
        torch.as_tensor(np.asarray(tcw, np.float32)))).numpy()
    return np.linalg.norm(d[3:]), np.linalg.norm(d[:3])


@pytest.fixture(scope="module")
def after_blackout():
    """The System after 12 frames of the seed-0 arc and three noise frames
    without depth (tracking lost), and the sequence."""
    seq = synthetic.generate_sequence(n_frames=20, seed=0, style="arc",
                                      cache_dir=synthetic.DEFAULT_CACHE)
    s = _system()
    for f in seq.frames[:12]:
        s.process_frame(f.gray, f.depth, f.timestamp)
    assert int(s.track.status) == 1
    r = np.random.default_rng(0)
    for k in range(3):
        noise = r.uniform(0, 1, seq.frames[0].gray.shape).astype(np.float32)
        s.process_frame(noise, np.zeros_like(seq.frames[0].depth),
                        0.5 + 0.03 * k)
    assert int(s.track.status) != 1
    return s, seq


def test_relocalize_recovers_revisited_view(after_blackout):
    """`relocalize` itself on frame 8 against the map after the blackout:
    BoW candidates, Horn RANSAC on the matches with depth, the projection
    search and the pose solve give the pose within 5 cm and 0.05 rad with
    >= 50 associated points; with the depth removed, the monocular branch
    (PnP RANSAC) recovers it within 10 cm and 0.05 rad. (It reads the map
    only; the System twin below goes on from the same state.)"""
    s, seq = after_blackout
    f = seq.frames[8]
    cfg = s.cfg
    feats = extractor.extract_features(
        torch.as_tensor(f.gray, dtype=torch.float32),
        torch.as_tensor(f.depth, dtype=torch.float32),
        orb_cfg=cfg.orb, cam_cfg=cfg.camera)
    lc = s.loop_closer
    for depth, tol in ((feats.depth, 0.05), (torch.zeros_like(feats.depth),
                                             0.10)):
        stats = {}
        pose, kp_pt = relocalization.relocalize(
            s.map, feats._replace(depth=depth), lc.bow, lc.vocab,
            torch.Generator().manual_seed(7), cfg=cfg, stats=stats)
        assert pose is not None
        dt, dr = _pose_err(pose, f.tcw)
        assert dt < tol and dr < 0.05, (dt, dr)
        assert int((kp_pt >= 0).sum()) >= 50
        assert stats["pose_solves"] >= 1


def test_rgbd_relocalization_after_blackout(after_blackout):
    """The twin of tests/test_reloc_e2e.py:14-48: after three noise frames
    the revisited frame 8 comes back within 5 cm and 0.05 rad, and frames
    9-11 track with > 80 inliers."""
    s, seq = after_blackout
    f = seq.frames[8]
    pose = s.process_frame(f.gray, f.depth, f.timestamp + 1.0)
    dt, dr = _pose_err(pose, f.tcw)
    assert dt < 0.05 and dr < 0.05, (dt, dr, s.n_relocalizations)
    for f in seq.frames[9:12]:
        s.process_frame(f.gray, f.depth, f.timestamp + 1.0)
        assert s.diags[-1]["n_inliers"] > 80
