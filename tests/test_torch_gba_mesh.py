"""The mesh-routed global BA of loop closing: a map carried from the port's
System (the cached 14-frame seed-3 arc, planes on) through the
synchronous `_global_ba` of a loop closer with gba_mesh_devices = 2, in a
2-rank gloo group whose rank 1 runs `serve_gba`, against the port's
single-device `_global_ba` on the same map."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from eao_fusion_tpu.io import synthetic
from eao_fusion_tpu_torch import config as TC
from eao_fusion_tpu_torch.io import synthetic as TS
from eao_fusion_tpu_torch.mapping import map_state as TMS
from eao_fusion_tpu_torch.mapping import vocabulary as TV
from eao_fusion_tpu_torch.pipeline import loop_closing as TLC
from eao_fusion_tpu_torch.pipeline.system import System
import torch_dist_worker as W


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This module's torch ops on one CPU thread (tier-1 runs six test
    files at once); put back after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    """tests/test_torch_loop.py's small configuration, the GBA synchronous."""
    return TC.SystemConfig(
        orb=TC.ORBConfig(n_features=500, max_keypoints=512),
        capacity=TC.MapCapacity(max_keyframes=16, max_points=3072,
                                max_local_ba_kfs=16),
        use_planes=True, use_objects=False, **kw).replace(
            loop=dataclasses.replace(TC.LoopConfig(), async_gba=False))


def test_mesh_routed_global_ba_matches_single_device(tmp_path):
    """Poses within 2e-3, points median 5e-3 m, planes within 2e-3; the
    serving rank served the schedule's four stages (20 LM iterations in
    stages of 5) and stopped."""
    seq = TS.generate_sequence(n_frames=14, seed=3, style="arc",
                               cache_dir=synthetic.DEFAULT_CACHE)
    s = System(_cfg(use_loop_closing=False), device="cpu")
    for f in seq.frames:
        s.process_frame(f.gray, f.depth, timestamp=f.timestamp)
    d = TMS.to_numpy(s.map)
    np.savez(tmp_path / "map.npz", **d)

    cfg = _cfg(gba_mesh_devices=2)
    handle = W.start_ranks(W.job_gba_mesh, 2, tmp_path, dict(cfg=cfg))
    lc = TLC.LoopCloser(_cfg(), TV.Vocabulary.load(device="cpu"),
                        torch.Generator())
    ref = TMS.to_numpy(lc._global_ba(TMS.from_numpy(d, "cpu")))
    W.join_ranks(handle)
    got = dict(np.load(tmp_path / "map_mesh.npz"))
    served = json.loads((tmp_path / "served_1.json").read_text())["served"]
    assert served == 4

    kv, pv, lv = d["kf_valid"], d["pt_valid"], d["pl_valid"]
    assert kv.sum() >= 4 and pv.sum() > 200 and lv.sum() >= 1
    dpose = np.abs(got["kf_pose"][kv] - ref["kf_pose"][kv]).max()
    dpt = np.linalg.norm(got["pt_xyz"][pv] - ref["pt_xyz"][pv], axis=1)
    print(f"mesh vs single device: pose {dpose:.3g}, point median "
          f"{np.median(dpt):.3g} m, max {dpt.max():.3g} m")
    assert dpose < 2e-3 and np.median(dpt) < 5e-3
    np.testing.assert_allclose(got["pl_coeff"][lv], ref["pl_coeff"][lv],
                               atol=2e-3)
    # the GBA moved the map
    assert np.abs(ref["kf_pose"][kv] - d["kf_pose"][kv]).max() > 1e-5
