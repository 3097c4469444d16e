"""Checkpoints cross between the packages: a map saved by the port's System
loads into the JAX System, and the JAX package's re-save loads back into
the port bit for bit; the resumed port System tracks on (the twin of
tests/test_aux.py:69-97, which is `slow` there)."""

import numpy as np
import pytest
import torch

from eao_fusion_tpu import config as JC
from eao_fusion_tpu.io import checkpoint as JK
from eao_fusion_tpu.io import synthetic
from eao_fusion_tpu.pipeline.system import System as JSystem
from eao_fusion_tpu_torch import config as TC
from eao_fusion_tpu_torch.io import checkpoint as TK
from eao_fusion_tpu_torch.pipeline.system import System

N_SAVE = 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This module's torch ops on one CPU thread (tier-1 runs six test
    files at once); the setting is put back after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(mod):
    return mod.SystemConfig(
        orb=mod.ORBConfig(n_features=300, max_keypoints=256),
        capacity=mod.MapCapacity(max_keyframes=32, max_points=2048),
        use_planes=False, use_objects=False, use_loop_closing=False)


def _state(s):
    out = {f"map.{k}": v for k, v in s.map._asdict().items()}
    out.update({f"objects.{k}": v for k, v in s.objects._asdict().items()})
    t = s.track._asdict()
    out.update({f"track.last_feats.{k}": v
                for k, v in t.pop("last_feats")._asdict().items()})
    out.update({f"track.{k}": v for k, v in t.items()})
    return {k: v.clone() for k, v in out.items()}


def test_checkpoint_round_trip_through_the_jax_package(tmp_path):
    seq = synthetic.generate_sequence(n_frames=8, seed=0, style="arc",
                                      cache_dir=synthetic.DEFAULT_CACHE)
    s = System(_cfg(TC), device="cpu")
    for f in seq.frames[:N_SAVE]:
        s.process_frame(f.gray, f.depth, f.timestamp)
    saved = _state(s)
    port_file = str(tmp_path / "port.npz")
    TK.save_state(port_file, s)

    # the JAX System reads the port's file and writes it again
    js = JSystem(_cfg(JC))
    JK.load_state(port_file, js)
    assert js.frame_id == s.frame_id and js.n_keyframes == s.n_keyframes
    jax_file = str(tmp_path / "jax.npz")
    JK.save_state(jax_file, js)
    with np.load(port_file) as zp, np.load(jax_file) as zj:
        assert sorted(zp.files) == sorted(zj.files)
        for k in zj.files:
            assert zp[k].dtype == zj[k].dtype, k
            assert zp[k].shape == zj[k].shape, k
            np.testing.assert_array_equal(zp[k], zj[k], err_msg=k)

    # the port loads the JAX file: every tensor bit for bit
    s2 = System(_cfg(TC), device="cpu")
    TK.load_state(jax_file, s2)
    got = _state(s2)
    assert set(got) == set(saved)
    for k, v in saved.items():
        assert got[k].dtype == v.dtype, k
        assert torch.equal(got[k], v), k
    assert (s2.frame_id, s2.n_keyframes) == (s.frame_id, s.n_keyframes)
    assert s2.timestamps == s.timestamps
    for a, b in zip(s2.trajectory, s.trajectory):
        np.testing.assert_array_equal(a, b)

    # the resumed System tracks the rest as the uninterrupted one does
    for f in seq.frames[N_SAVE:]:
        s.process_frame(f.gray, f.depth, f.timestamp)
        s2.process_frame(f.gray, f.depth, f.timestamp)
    assert s2.diags[-1]["n_inliers"] > 33
    d = np.linalg.norm(s2.trajectory_tcw()[N_SAVE:, 4:]
                       - s.trajectory_tcw()[N_SAVE:, 4:], axis=1)
    assert d.max() < 0.005, d
    # one corrected entry per frame; the restored frames keep their poses
    corr = s2.trajectory_tcw(corrected=True)
    assert len(corr) == len(s2.trajectory) == len(seq.frames)
    np.testing.assert_array_equal(corr[:N_SAVE],
                                  np.stack(s.trajectory[:N_SAVE]))


def test_load_keeps_missing_fields_and_refuses_other_shapes(tmp_path):
    s = System(_cfg(TC), device="cpu")
    path = str(tmp_path / "c.npz")
    TK.save_state(path, s)
    with np.load(path) as z:
        payload = {k: z[k] for k in z.files}
    template = s.map.pt_xyz.clone()
    del payload["map.pt_xyz"]
    np.savez(str(tmp_path / "old.npz"), **payload)
    s2 = System(_cfg(TC), device="cpu")
    TK.load_state(str(tmp_path / "old.npz"), s2)
    assert torch.equal(s2.map.pt_xyz, template)
    payload["map.pt_xyz"] = np.zeros((7, 3), np.float32)
    np.savez(str(tmp_path / "bad.npz"), **payload)
    with pytest.raises(ValueError, match="pt_xyz"):
        TK.load_state(str(tmp_path / "bad.npz"), s2)


def test_load_rebuilds_the_loop_closers_bow_rows(tmp_path):
    """With loop closing on, a load rebuilds the bag-of-words row of every
    valid keyframe from the map, as the JAX load_state does: the rows the
    running System built come back, and the initial keyframe, which the
    loop closer never saw, gets its row too."""
    from eao_fusion_tpu_torch.mapping import vocabulary
    import dataclasses
    cfg = dataclasses.replace(_cfg(TC), use_loop_closing=True)
    seq = synthetic.generate_sequence(n_frames=8, seed=0, style="arc",
                                      cache_dir=synthetic.DEFAULT_CACHE)
    s = System(cfg, device="cpu")
    for f in seq.frames[:4]:
        s.process_frame(f.gray, f.depth, f.timestamp)
    path = str(tmp_path / "c.npz")
    TK.save_state(path, s)
    s2 = System(cfg, device="cpu")
    TK.load_state(path, s2)
    valid = s.map.kf_valid
    assert int(valid.sum()) >= 2
    lc, lc2 = s.loop_closer, s2.loop_closer
    for k in valid.nonzero().flatten().tolist():
        want = vocabulary.bow_vector(lc.vocab, s.map.kf_desc_pm1[k],
                                     s.map.kf_kp_valid[k])
        assert torch.equal(lc2.bow[k], want), k
        if lc.bow[k].any():
            assert torch.equal(lc2.bow[k], lc.bow[k]), k
    assert not lc2.bow[~valid].any()
