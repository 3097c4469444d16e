"""Tracking and local mapping of the port against the JAX package, started
from the same map: the JAX System runs 6 frames of the seed-0 arc, its map
and tracking state are carried across with `from_numpy`, and one
`track_frame` / one `local_mapping_step` run in both packages on the same
inputs."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eao_fusion_tpu.config import MapCapacity, ORBConfig, SystemConfig
from eao_fusion_tpu.frontend import extractor as JE
from eao_fusion_tpu.io import synthetic
from eao_fusion_tpu.pipeline import local_mapping as JLM
from eao_fusion_tpu.pipeline import tracking as JT
from eao_fusion_tpu.pipeline.system import System as JSystem
from eao_fusion_tpu_torch import config as TC
from eao_fusion_tpu_torch.mapping import map_state as TMS
from eao_fusion_tpu_torch.pipeline import local_mapping as TLM
from eao_fusion_tpu_torch.pipeline import tracking as TT
from eao_fusion_tpu_torch.types import FrameFeatures, tree_from_numpy

N_WARM = 6


def _cfgs():
    kw = dict(use_planes=False, use_objects=False, use_loop_closing=False)
    j = SystemConfig(orb=ORBConfig(n_features=500, max_keypoints=512),
                     capacity=MapCapacity(max_keyframes=64, max_points=4096),
                     **kw)
    t = TC.SystemConfig(orb=TC.ORBConfig(n_features=500, max_keypoints=512),
                        capacity=TC.MapCapacity(max_keyframes=64,
                                                max_points=4096), **kw)
    return j, t


def _np(tree):
    return jax.tree.map(np.asarray, tree)._asdict()


@pytest.fixture(scope="module")
def warm():
    jcfg, tcfg = _cfgs()
    seq = synthetic.generate_sequence(n_frames=20, seed=0, style="arc",
                                      cache_dir=synthetic.DEFAULT_CACHE)
    s = JSystem(jcfg)
    for f in seq.frames[:N_WARM]:
        s.process_frame(f.gray, f.depth, f.timestamp)
    assert s.n_keyframes >= 3
    f = seq.frames[N_WARM]
    feats = JE.extract_features(jnp.asarray(f.gray), jnp.asarray(f.depth),
                                orb_cfg=jcfg.orb, cam_cfg=jcfg.camera)
    return dict(jcfg=jcfg, tcfg=tcfg, map=s.map, track=s.track, feats=feats)


def test_state_round_trip(warm):
    d = _np(warm["map"])
    m = TMS.from_numpy(d, "cpu")
    assert m.max_kf == warm["map"].max_kf and m.max_pt == warm["map"].max_pt
    back = TMS.to_numpy(m)
    for k, v in d.items():
        b = back[k]
        if v.dtype == np.uint32:
            b = b.view(np.uint32)
        np.testing.assert_array_equal(b, v, err_msg=k)
    ts = TT.track_state_from_numpy(_np(warm["track"]), "cpu")
    np.testing.assert_array_equal(ts.kp_pt.numpy(),
                                  np.asarray(warm["track"].kp_pt))


def test_track_frame_matches_jax(warm):
    jcfg, tcfg = warm["jcfg"], warm["tcfg"]
    mj, tsj, dj = JT.track_frame(warm["map"], warm["track"], warm["feats"],
                                 jnp.int32(N_WARM), None, cfg=jcfg)
    m = TMS.from_numpy(_np(warm["map"]), "cpu")
    ts = TT.track_state_from_numpy(_np(warm["track"]), "cpu")
    feats = tree_from_numpy(FrameFeatures, _np(warm["feats"]), "cpu")
    mt, tst, dt = TT.track_frame(m, ts, feats, N_WARM, cfg=tcfg)

    np.testing.assert_allclose(tst.pose.numpy(), np.asarray(tsj.pose),
                               atol=1e-4)
    kj, kt = np.asarray(tsj.kp_pt), tst.kp_pt.numpy()
    assert (kj >= 0).sum() > 50
    assert (kj == kt).mean() >= 0.99
    assert int(dt["need_kf"]) == int(dj["need_kf"])
    assert abs(int(dt["n_inliers"]) - int(dj["n_inliers"])) <= 5
    assert int(tst.ref_kf) == int(tsj.ref_kf)
    assert (mt.pt_visible.numpy() == np.asarray(mj.pt_visible)).mean() > 0.99
    assert (mt.pt_found.numpy() == np.asarray(mj.pt_found)).mean() > 0.99


def test_track_frame_hands_the_pose_kernel_what_it_takes(warm,
                                                        monkeypatch):
    """The pose kernel reads its inputs in place and copies nothing, so
    both solves of a frame must hand it contiguous float32 / bool tensors
    of the right shapes (checked here as its wrapper checks them on the
    card)."""
    _, tcfg = warm["jcfg"], warm["tcfg"]
    m = TMS.from_numpy(_np(warm["map"]), "cpu")
    ts = TT.track_state_from_numpy(_np(warm["track"]), "cpu")
    feats = tree_from_numpy(FrameFeatures, _np(warm["feats"]), "cpu")
    solve = TT.pose_opt.optimize_pose
    calls = []

    def checked(pose0, obs, plane_obs=None, **kw):
        M = obs.valid.shape[0]
        want = [(pose0, torch.float32, (7,)),
                (obs.pts_w, torch.float32, (M, 3)),
                (obs.uv, torch.float32, (M, 2)),
                (obs.uright, torch.float32, (M,)),
                (obs.inv_sigma2, torch.float32, (M,)),
                (obs.valid, torch.bool, (M,))]
        for t, dtype, shape in want:
            assert t.dtype == dtype and tuple(t.shape) == shape
            assert t.is_contiguous()
        calls.append(M)
        return solve(pose0, obs, plane_obs, **kw)

    monkeypatch.setattr(TT.pose_opt, "optimize_pose", checked)
    TT.track_frame(m, ts, feats, N_WARM, cfg=tcfg)
    assert calls == [tcfg.orb.max_keypoints] * 2


def test_local_mapping_step_matches_jax(warm):
    jcfg, tcfg = warm["jcfg"], warm["tcfg"]
    mj0 = warm["map"]
    slot = int(mj0.next_kf) - 1
    mj = JLM.local_mapping_step(mj0, jnp.int32(slot), cfg=jcfg)
    mt = TLM.local_mapping_step(TMS.from_numpy(_np(mj0), "cpu"), slot,
                                cfg=tcfg)
    kv = np.asarray(mj.kf_valid)
    np.testing.assert_array_equal(mt.kf_valid.numpy(), kv)
    tj = np.asarray(mj.kf_pose)[kv, 4:7]
    np.testing.assert_allclose(mt.kf_pose.numpy()[kv, 4:7], tj, atol=1e-3)
    pv = np.asarray(mj.pt_valid) & mt.pt_valid.numpy()
    assert pv.sum() > 100
    assert (mt.pt_valid.numpy() == np.asarray(mj.pt_valid)).mean() > 0.99
    dxyz = np.linalg.norm(mt.pt_xyz.numpy()[pv] - np.asarray(mj.pt_xyz)[pv],
                          axis=1)
    assert np.median(dxyz) < 1e-3
    kj = np.asarray(mj.kf_pt_idx)[kv]
    assert (mt.kf_pt_idx.numpy()[kv] == kj).mean() >= 0.99
    assert (mt.obs_ind.numpy() == np.asarray(mj.obs_ind)).mean() > 0.99


def test_fuse_and_cull_match_jax(warm):
    """The first two stages of local mapping alone, exactly."""
    jcfg, tcfg = warm["jcfg"], warm["tcfg"]
    mj0 = warm["map"]
    slot = int(mj0.next_kf) - 1
    mj = JLM.fuse_neighbors(JLM.cull_points(mj0, jnp.int32(slot)),
                            jnp.int32(slot), cfg=jcfg)
    m0 = TMS.from_numpy(_np(mj0), "cpu")
    mt = TLM.fuse_neighbors(TLM.cull_points(m0, slot), slot, cfg=tcfg)
    for k in ("kf_pt_idx", "pt_valid", "obs_ind"):
        np.testing.assert_array_equal(getattr(mt, k).numpy(),
                                      np.asarray(getattr(mj, k)), err_msg=k)
    mj = JLM.refresh_point_descriptors(mj)
    mt = TLM.refresh_point_descriptors(mt)
    np.testing.assert_array_equal(mt.pt_desc_pm1.numpy(),
                                  np.asarray(mj.pt_desc_pm1))


def test_insert_keyframe_rgbd_matches_jax(warm):
    """Keyframe insertion, RGBD point creation and the stat refresh, on the
    same map, pose and associations."""
    from eao_fusion_tpu.pipeline.system import insert_keyframe_rgbd as jins
    from eao_fusion_tpu_torch.pipeline.system import insert_keyframe_rgbd
    jcfg, tcfg = warm["jcfg"], warm["tcfg"]
    mj0, ts = warm["map"], warm["track"]
    kp = np.asarray(ts.kp_pt).copy()
    kp[::2] = -1                                # half the slots unassociated
    mj = jins(mj0, warm["feats"], ts.pose, jnp.asarray(kp), N_WARM, 0.2,
              cfg=jcfg)
    mt = insert_keyframe_rgbd(
        TMS.from_numpy(_np(mj0), "cpu"),
        tree_from_numpy(FrameFeatures, _np(warm["feats"]), "cpu"),
        torch.from_numpy(np.array(ts.pose)), torch.from_numpy(kp), N_WARM,
        0.2, cfg=tcfg)
    exact = ("kf_pt_idx", "kf_valid", "kf_frame_id", "kf_kp_level",
             "pt_valid", "pt_ref_kf", "pt_first_frame", "pt_found",
             "pt_visible", "pt_desc_pm1", "obs_ind", "next_kf", "next_pt")
    for k in exact:
        np.testing.assert_array_equal(getattr(mt, k).numpy(),
                                      np.asarray(getattr(mj, k)), err_msg=k)
    for k in ("pt_xyz", "pt_normal", "pt_max_dist", "pt_min_dist",
              "kf_timestamp", "kf_pose"):
        np.testing.assert_allclose(getattr(mt, k).numpy(),
                                   np.asarray(getattr(mj, k)), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    assert int(mt.next_pt) > int(mj0.next_pt)


def test_compact_points_matches_jax(warm):
    from eao_fusion_tpu.mapping import map_state as JMS
    mj0 = warm["map"]
    pv = np.asarray(mj0.pt_valid).copy()
    pv[1::3] = False                            # free some slots first
    mj0 = mj0._replace(pt_valid=jnp.asarray(pv))
    mj, rj = JMS.compact_points(mj0)
    mt, rt = TMS.compact_points(TMS.from_numpy(_np(mj0), "cpu"))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    for k, v in _np(mj).items():
        b = getattr(mt, k).numpy()
        if v.dtype == np.uint32:
            b = b.view(np.uint32)
        np.testing.assert_array_equal(b, v, err_msg=k)


def test_lost_frame_resets_like_jax():
    """A blank frame after initialization loses tracking with one keyframe,
    and both packages reset the map and keep the trajectory."""
    from eao_fusion_tpu_torch.pipeline.system import System
    jcfg, tcfg = _cfgs()
    seq = synthetic.generate_sequence(n_frames=20, seed=0, style="arc",
                                      cache_dir=synthetic.DEFAULT_CACHE)
    f = seq.frames[0]
    blank = np.zeros_like(f.gray)
    js, ts = JSystem(jcfg), System(tcfg, device="cpu")
    for s in (js, ts):
        s.process_frame(f.gray, f.depth, 0.0)
        s.process_frame(blank, f.depth, 0.033)
    assert ts.n_resets == js.n_resets == 1
    assert ts.n_keyframes == js.n_keyframes == 0
    np.testing.assert_allclose(ts.trajectory_tcw(), js.trajectory_tcw(),
                               atol=1e-6)
    assert int(ts.track.status) == TT.STATUS_UNINIT
