"""The port's map-sharded steady step (`parallel/sharded_step.py`): its
layout against the JAX module's `NamedSharding`s, its runs on 2 gloo ranks
(mesh 2 x 1) and 4 (mesh 2 x 2) against the port's unsharded
`steady.slam_step` (the same bits), and the 2-rank run against the JAX
`steady.slam_step` under tests/test_sharded_step.py's bounds. The small
configuration of tests/test_sharded_step.py (512 keypoints, 32
keyframes, 2048 points, planes and objects on) on the cached 16-frame
seed-0 arc: 8 frames of `process_frame`, then 6 frames with kf_every = 4.
The ranks are spawned processes (tests/torch_dist_worker.py); the pytest
process itself never joins a process group."""

import json
import os

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

import jax
import jax.numpy as jnp

from eao_fusion_tpu import types as JTy
from eao_fusion_tpu.config import MapCapacity, ORBConfig, SystemConfig
from eao_fusion_tpu.io import synthetic
from eao_fusion_tpu.mapping import map_state as JMS
from eao_fusion_tpu.objects import object_map as JOM
from eao_fusion_tpu.parallel import mesh as JM
from eao_fusion_tpu.parallel import sharded_step as JSS
from eao_fusion_tpu.pipeline import steady as JSt
from eao_fusion_tpu.pipeline import tracking as JT
from eao_fusion_tpu_torch import config as TC
from eao_fusion_tpu_torch.io import synthetic as TSyn
from eao_fusion_tpu_torch.mapping import map_state as TMS
from eao_fusion_tpu_torch.parallel import sharded_step as TSS
from eao_fusion_tpu_torch.pipeline import steady
from eao_fusion_tpu_torch.pipeline.system import System
import torch_dist_worker as W

N_WARM, N_RUN, KF_EVERY = 8, 6, 4
MESHES = [(2, 1), (2, 2)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This module's torch ops on one CPU thread (tier-1 runs six test
    files at once); put back after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tcfg():
    return TC.SystemConfig(
        orb=TC.ORBConfig(n_features=500, max_keypoints=512),
        capacity=TC.MapCapacity(max_keyframes=32, max_points=2048),
        use_planes=True, use_objects=True, use_loop_closing=False)


def _jcfg():
    return SystemConfig(
        orb=ORBConfig(n_features=500, max_keypoints=512),
        capacity=MapCapacity(max_keyframes=32, max_points=2048),
        use_planes=True, use_objects=True, use_loop_closing=False)


def _bits(a) -> np.ndarray:
    return np.asarray(a).reshape(-1).view(np.uint8)


def _save_frames(path, cfg, frames) -> None:
    """The frames' images, box tables (padded to max_objects_2d rows) and
    timestamps."""
    bx = np.zeros((len(frames), cfg.objects.max_objects_2d, 6), np.float32)
    for i, f in enumerate(frames):
        b = np.asarray(f.boxes, np.float32)[:bx.shape[1]]
        bx[i, :len(b)] = b
    np.savez(path, gray=np.stack([f.gray for f in frames]),
             depth=np.stack([f.depth for f in frames]), boxes=bx,
             ts=np.array([f.timestamp for f in frames], np.float32))


def _unsharded(tmp, cfg, device="cpu"):
    """The port's `steady.slam_step` over the saved frames from the saved
    state: (per-frame poses, keyframe decisions, inlier counts; the final
    record)."""
    st = W.load_steady(os.path.join(tmp, "steady.npz"), cfg, device)
    fr = np.load(os.path.join(tmp, "frames.npz"))
    per = {"pose": [], "kf_inserted": [], "n_inliers": []}
    for t in range(len(fr["ts"])):
        st, d = steady.slam_step(
            st, *(torch.as_tensor(fr[k][t], device=device)
                  for k in ("gray", "depth", "boxes")),
            float(fr["ts"][t]), cfg=cfg, kf_every=KF_EVERY)
        per["pose"].append(st.ts.pose.cpu().numpy())
        per["kf_inserted"].append(bool(d["kf_inserted"]))
        per["n_inliers"].append(int(d["n_inliers"]))
    return {k: np.asarray(v) for k, v in per.items()}, W.run_record(st)


def _jax_leaf(name, v):
    if name == "desc_packed":        # the port keeps the words as int32
        return jnp.asarray(v.numpy().view(np.uint32))
    if name == "status":             # weakly typed, as slam_step returns it
        return jnp.asarray(int(v))
    return jnp.asarray(v.numpy())


def _to_jax(cls, tree):
    return cls(**{k: (_to_jax(JTy.FrameFeatures, v) if isinstance(v, tuple)
                      else _jax_leaf(k, v))
                  for k, v in tree._asdict().items()})


def _jax_run(tmp, cfg):
    """The JAX `steady.slam_step` over the saved frames from the saved
    state carried across: (per-frame poses and keyframe decisions, the
    final pt_valid / pt_xyz / next_kf / next_pt)."""
    st = W.load_steady(os.path.join(tmp, "steady.npz"), cfg)
    jst = JSt.SteadyState(
        m=_to_jax(JMS.MapState, st.m), ts=_to_jax(JT.TrackState, st.ts),
        objs=_to_jax(JOM.ObjectTable, st.objs),
        last_fo=_to_jax(JOM.FrameObjects, st.last_fo),
        frame_id=jnp.int32(st.frame_id), key=jax.random.PRNGKey(0))
    fr = np.load(os.path.join(tmp, "frames.npz"))
    poses, kfi = [], []
    for t in range(len(fr["ts"])):
        jst, d = JSt.slam_step(jst, jnp.asarray(fr["gray"][t]),
                               jnp.asarray(fr["depth"][t]),
                               jnp.asarray(fr["boxes"][t]),
                               jnp.float32(fr["ts"][t]), cfg=_jcfg(),
                               kf_every=KF_EVERY)
        poses.append(np.asarray(jst.ts.pose))
        kfi.append(bool(d["kf_inserted"]))
    return {"pose": np.stack(poses), "kf_inserted": np.asarray(kfi),
            "pt_valid": np.asarray(jst.m.pt_valid),
            "pt_xyz": np.asarray(jst.m.pt_xyz),
            "next_kf": int(jst.m.next_kf), "next_pt": int(jst.m.next_pt)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The warmed state handed over in an npz, then the sharded step on
    both meshes (two spawned groups at once) while this process runs the
    port's unsharded step and the JAX step from the same state:
    {"ref": (per, record), "jax": ..., (n_lm, n_kf): (per, record),
    "blocks": {mesh: [per-rank json]}, "errors": json}."""
    tmp = str(tmp_path_factory.mktemp("sharded_step"))
    cfg = _tcfg()
    seq = synthetic.generate_sequence(n_frames=16, seed=0, style="arc",
                                      cache_dir=synthetic.DEFAULT_CACHE)
    s = System(cfg, device="cpu")
    for f in seq.frames[:N_WARM]:
        s.process_frame(f.gray, f.depth, f.timestamp, boxes=f.boxes)
    W.save_steady(os.path.join(tmp, "steady.npz"), s)
    _save_frames(os.path.join(tmp, "frames.npz"), cfg,
                 seq.frames[N_WARM:N_WARM + N_RUN])
    groups = {ms: W.start_ranks(W.job_sharded_step, ms[0] * ms[1], tmp,
                                dict(cfg=cfg, mesh=ms, kf_every=KF_EVERY,
                                     errors=ms == (2, 1)))
              for ms in MESHES}
    out = {"ref": _unsharded(tmp, cfg), "jax": _jax_run(tmp, cfg),
           "blocks": {}}
    for ms, handle in groups.items():
        W.join_ranks(handle)
        got = dict(np.load(os.path.join(tmp, f"sharded_{ms[0]}x{ms[1]}.npz")))
        out[ms] = ({k[4:]: v for k, v in got.items() if k.startswith("per.")},
                   {k: v for k, v in got.items() if not k.startswith("per.")})
        out["blocks"][ms] = [
            json.load(open(os.path.join(tmp, f"blocks_{ms[0]}x{ms[1]}_{r}"
                                             f".json")))
            for r in range(ms[0] * ms[1])]
    out["errors"] = json.load(open(os.path.join(tmp, "errors.json")))
    return out


# ------------------------------------------------------------- layout

def _jax_placements(spec) -> tuple:
    """A JAX PartitionSpec as the port's (over lm, over kf) placements."""
    pl = [Replicate(), Replicate()]
    for dim, axis in enumerate(spec):
        if axis is not None:
            pl[("lm", "kf").index(axis)] = Shard(dim)
    return tuple(pl)


def test_map_shardings_match_jax():
    """Every field placed as the JAX module places it on a 4 x 2 mesh (the
    fields tests/test_sharded_step.py::test_map_shardings_layout names:
    pt_xyz on lm, kf_pose on kf, obs_ind on both, pl_coeff and next_kf
    replicated)."""
    jsh = JSS.map_shardings(JM.make_mesh(n_landmark=4, n_kf=2))
    tsh = TSS.map_shardings(None)
    assert TMS.MapState._fields == JMS.MapState._fields
    for f in TMS.MapState._fields:
        assert getattr(tsh, f) == _jax_placements(getattr(jsh, f).spec), f
    assert tsh.pt_xyz == (Shard(0), Replicate())
    assert tsh.kf_pose == (Replicate(), Shard(0))
    assert tsh.obs_ind == (Shard(1), Shard(0))
    assert tsh.pl_coeff == tsh.next_kf == (Replicate(), Replicate())


def test_block_rows_match_devices_indices_map():
    """On a 4 x 2 mesh, for every field, the rows `shard_state` gives rank
    (i, j) are the index JAX's `devices_indices_map` gives the device at
    mesh position (i, j) (the 8 CPU devices of tests/conftest.py)."""
    jmesh = JM.make_mesh(n_landmark=4, n_kf=2)
    jsh = JSS.map_shardings(jmesh)
    m = TMS.empty_map(_tcfg(), "cpu")
    for f in TMS.MapState._fields:
        shape = tuple(getattr(m, f).shape)
        imap = getattr(jsh, f).devices_indices_map(shape)
        for i in range(4):
            for j in range(2):
                want = imap[jmesh.devices[i, j]]
                got = TSS.block_index(f, shape, (4, 2), (i, j))
                assert len(got) == len(want) == len(shape), f
                for g, w, n in zip(got, want, shape):
                    assert g.indices(n) == w.indices(n), (f, i, j)


# -------------------------------------------- sharded against unsharded

@pytest.mark.parametrize("mesh", MESHES, ids=["2x1", "2x2"])
def test_sharded_matches_unsharded_bits(runs, mesh):
    """The same bits as the port's unsharded step frame by frame (pose,
    keyframe decision, inliers) and at the end (next_kf, next_pt, every
    field of the gathered map, the object table, kp_pt); at least one
    keyframe inserted."""
    (per_r, rec_r), (per_s, rec_s) = runs["ref"], runs[mesh]
    assert per_r["kf_inserted"].sum() >= 1
    np.testing.assert_array_equal(per_s["kf_inserted"], per_r["kf_inserted"])
    np.testing.assert_array_equal(per_s["n_inliers"], per_r["n_inliers"])
    np.testing.assert_array_equal(_bits(per_s["pose"]), _bits(per_r["pose"]))
    assert set(rec_s) == set(rec_r)
    differ = [k for k in rec_r
              if not np.array_equal(_bits(rec_s[k]), _bits(rec_r[k]))]
    assert not differ, differ
    assert int(rec_s["map.next_kf"]) == int(rec_r["map.next_kf"])
    assert int(rec_s["map.next_pt"]) == int(rec_r["map.next_pt"])


@pytest.mark.parametrize("mesh", MESHES, ids=["2x1", "2x2"])
def test_ranks_hold_their_blocks(runs, mesh):
    """Each rank holds P / n_lm point rows, K / n_kf keyframe rows, the
    [K / n_kf, P / n_lm] obs_ind block and the whole plane table, at its
    own mesh position; its `kf_rows` read the gathered map's rows (the
    reference-keyframe fallback's gather over kf). The replicated state
    was checked across the ranks after every frame (the ranks raise)."""
    cfg = _tcfg()
    P, K = cfg.capacity.max_points, cfg.capacity.max_keyframes
    N, L = cfg.orb.max_keypoints, cfg.capacity.max_planes
    n_lm, n_kf = mesh
    blocks = runs["blocks"][mesh]
    assert sorted(tuple(b["coord"]) for b in blocks) == [
        (i, j) for i in range(n_lm) for j in range(n_kf)]
    for b in blocks:
        assert b["pt_xyz"] == [P // n_lm, 3]
        assert b["pt_desc_pm1"] == [P // n_lm, 256]
        assert b["kf_pose"] == [K // n_kf, 7]
        assert b["kf_desc_pm1"] == [K // n_kf, N, 256]
        assert b["obs_ind"] == [K // n_kf, P // n_lm]
        assert b["pl_coeff"] == [L, 4]
        assert b["kf_rows_equal"]


def test_sharded_within_jax_bounds(runs):
    """The 2-rank sharded run against the JAX `steady.slam_step` from the
    same state, under tests/test_sharded_step.py's bounds: every pose
    within 2e-3, the same keyframe decisions, next_kf and next_pt, pt_valid
    disagreeing on under 1% of the rows, pt_xyz within 5e-2 where both
    hold a point."""
    per, rec = runs[(2, 1)]
    j = runs["jax"]
    np.testing.assert_array_equal(per["kf_inserted"], j["kf_inserted"])
    np.testing.assert_allclose(per["pose"], j["pose"], atol=2e-3)
    assert int(rec["map.next_kf"]) == j["next_kf"]
    assert int(rec["map.next_pt"]) == j["next_pt"]
    v = rec["map.pt_valid"]
    assert (v != j["pt_valid"]).mean() < 0.01
    both = v & j["pt_valid"]
    np.testing.assert_allclose(rec["map.pt_xyz"][both], j["pt_xyz"][both],
                               atol=5e-2)


# -------------------------------------------------------------- errors

def test_step_raises_without_a_process_group():
    """No group in this process: the step and `shard_state` raise before
    they touch the mesh."""
    cfg = _tcfg()
    with pytest.raises(RuntimeError, match="process group"):
        TSS.make_sharded_slam_step(None, cfg)
    with pytest.raises(RuntimeError, match="process group"):
        TSS.make_sharded_slam_chunk(None, cfg)
    st = steady.SteadyState(m=TMS.empty_map(cfg, "cpu"), ts=None, objs=None,
                            last_fo=None, frame_id=0,
                            generator=torch.Generator())
    with pytest.raises(RuntimeError, match="process group"):
        TSS.shard_state(st, None)


@pytest.mark.parametrize("case,words", [
    ("mesh_over_group", "does not fit a group of 2"),
    ("mesh_over_group_step", "does not fit a group of 2"),
    ("max_points", "max_points = 2049"),
    ("max_keyframes", "max_keyframes = 33")])
def test_step_raises_on_a_layout_that_does_not_fit(runs, case, words):
    """In a 2-rank group: a mesh larger than the group (from `make_mesh`,
    and handed to the step directly), and capacities the mesh does not
    divide, each raise a ValueError naming what does not fit."""
    assert runs["errors"][case] is not None, case
    assert words in runs["errors"][case]


# ------------------------------------------------------------- the card

@pytest.mark.gpu
def test_sharded_step_on_the_card(tmp_path):
    """Phase 24 (b) of chip_smoke.py at this file's size: 2 gloo ranks
    sharing the card against the unsharded step on the card, the same
    bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tmp = str(tmp_path)
    cfg = _tcfg()
    # the port's renderer: the card's host has no render cache
    seq = TSyn.generate_sequence(n_frames=16, seed=0, style="arc",
                                 cache_dir=synthetic.DEFAULT_CACHE)
    s = System(cfg, device="cuda")
    for f in seq.frames[:N_WARM]:
        s.process_frame(f.gray, f.depth, f.timestamp, boxes=f.boxes)
    W.save_steady(os.path.join(tmp, "steady.npz"), s)
    _save_frames(os.path.join(tmp, "frames.npz"), cfg,
                 seq.frames[N_WARM:N_WARM + N_RUN])
    handle = W.start_ranks(W.job_sharded_step, 2, tmp,
                           dict(cfg=cfg, mesh=(2, 1), kf_every=KF_EVERY,
                                device="cuda"))
    per_r, rec_r = _unsharded(tmp, cfg, "cuda")
    W.join_ranks(handle)
    got = dict(np.load(os.path.join(tmp, "sharded_2x1.npz")))
    np.testing.assert_array_equal(_bits(got["per.pose"]),
                                  _bits(per_r["pose"]))
    np.testing.assert_array_equal(got["per.kf_inserted"],
                                  per_r["kf_inserted"])
    differ = [k for k in rec_r
              if not np.array_equal(_bits(got[k]), _bits(rec_r[k]))]
    assert not differ, differ
