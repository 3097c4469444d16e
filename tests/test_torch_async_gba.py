"""The port's asynchronous global BA and its merge: the twins of
tests/test_async_gba.py (the merge of keyframes and points made while the
GBA was in flight, the thread round trip, the abort), on the port's
System on the CPU; and a failure in the GBA thread raised by `poll_gba`
rather than dropped."""

import numpy as np
import pytest
import torch

from eao_fusion_tpu.io import synthetic
from eao_fusion_tpu_torch import config as TC
from eao_fusion_tpu_torch.ops import lie
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


def _cfg():
    return TC.SystemConfig(
        orb=TC.ORBConfig(n_features=500, max_keypoints=512),
        capacity=TC.MapCapacity(max_keyframes=16, max_points=4096,
                                max_local_ba_kfs=16),
        tracking=TC.TrackingConfig(max_frames_between_kf=3),
        use_planes=False, use_objects=False)


def _reproj_rmse(m, kf, pt_sel, cam):
    """RMS reprojection error of keyframe `kf`'s observations of the points
    in `pt_sel` (bool [P])."""
    kp_pt = m.kf_pt_idx[kf].numpy()
    valid = (kp_pt >= 0) & m.kf_kp_valid[kf].numpy()
    valid &= pt_sel[np.clip(kp_pt, 0, None)]
    if not valid.any():
        return None
    pc = lie.se3_apply(m.kf_pose[kf], m.pt_xyz[kp_pt[valid]]).numpy()
    fx, fy, cx, cy = cam
    uv = m.kf_kp_uv[kf].numpy()[valid]
    return float(np.sqrt(np.mean((fx * pc[:, 0] / pc[:, 2] + cx - uv[:, 0]) ** 2
                                 + (fy * pc[:, 1] / pc[:, 2] + cy
                                    - uv[:, 1]) ** 2)))


def _run(s, frames):
    for f in frames:
        s.process_frame(f.gray, f.depth, timestamp=f.timestamp)


@pytest.fixture(scope="module")
def arc():
    """One System for the module, after the first 10 frames of the seed-0
    arc, and the 28-frame sequence. The tests run in the file's order: the
    abort and the failure leave the map as it was, the round trip goes on
    from frame 10 and the merge from frame 18 (each first runs the System
    up to its start frame if it is not there yet)."""
    seq = synthetic.generate_sequence(n_frames=28, seed=0, style="arc",
                                      cache_dir=synthetic.DEFAULT_CACHE)
    s = System(_cfg(), device="cpu")
    _run(s, seq.frames[:10])
    return s, seq


def _advance(s, seq, frame):
    """Run the System up to (not including) `frame`."""
    _run(s, seq.frames[s.frame_id:frame])


def test_abort_discards_result(arc):
    """The twin of tests/test_async_gba.py:152: an aborted GBA leaves no
    result and the poll merges nothing."""
    s, _ = arc
    lc = s.loop_closer
    pose_before = s.map.kf_pose.clone()
    lc.launch_gba_async(s.map)
    lc.abort_gba()
    assert lc._gba_thread is None and lc._gba_out is None
    m, merged = lc.poll_gba(s.map)
    assert not merged
    assert torch.equal(m.kf_pose, pose_before)


def test_gba_thread_failure_is_raised(arc, monkeypatch):
    """An exception in the GBA thread is kept and raised by `poll_gba` (and
    through the System's own poll), not printed and dropped."""
    s, _ = arc
    lc = s.loop_closer

    def fail(*a, **k):
        raise ValueError("solver failed")

    monkeypatch.setattr(lc, "_gba_stage", fail)
    lc.launch_gba_async(s.map)
    with pytest.raises(RuntimeError, match="global BA") as e:
        lc.poll_gba(s.map, blocking=True)
    assert isinstance(e.value.__cause__, ValueError)
    assert lc._gba_thread is None
    lc.launch_gba_async(s.map)
    lc._gba_thread.join()
    with pytest.raises(RuntimeError, match="global BA"):
        s.trajectory_tcw(corrected=True)


def test_async_thread_roundtrip(arc):
    """The twin of tests/test_async_gba.py:127: a GBA launched on the map of
    frame 10 runs on its thread while 8 more frames are tracked; a
    blocking poll merges it and tracking goes on with >= 30 inliers."""
    s, seq = arc
    start = s.frame_id
    s.loop_closer.launch_gba_async(s.map)
    assert s.loop_closer._gba_thread is not None
    _run(s, seq.frames[start:start + 8])
    merges = s.n_gba_merges
    s._poll_gba(blocking=True)
    assert s.loop_closer._gba_thread is None
    assert s.n_gba_merges >= 1 and s.n_gba_merges >= merges
    assert s.diags[-1]["n_inliers"] >= 30
    f = seq.frames[start + 7]
    s.process_frame(f.gray, f.depth, timestamp=f.timestamp + 1 / 30)
    assert s.diags[-1]["n_inliers"] >= 30


@pytest.fixture(scope="module")
def merge_case(arc):
    """The GBA solved on the module System's map after frame 17 (the JAX
    test's frame 20 is cut to what the System reaches through the round
    trip), then the System tracking frames 18-25: (the snapshot map, a
    clone of its tensors taken at once, the snapshot's validity record,
    the GBA result, the live map)."""
    s, seq = arc
    _advance(s, seq, 18)
    lc = s.loop_closer
    m_snap = s.map
    frozen = {k: v.clone() for k, v in m_snap._asdict().items()}
    snap = {k: getattr(m_snap, k).numpy().copy()
            for k in ("kf_frame_id", "kf_valid", "pt_valid", "pl_valid")}
    prob, plane_free = lc._build_gba_problem(m_snap)
    res = lc._run_gba_stages(prob, plane_free)
    _run(s, seq.frames[18:26])
    return m_snap, frozen, snap, res, s.map


def test_merge_inflight_keyframes_deterministic(arc, merge_case):
    """The twin of tests/test_async_gba.py:52: the GBA solved on the map
    after frame 17, the System tracking frames 18-25, then the merge.
    Snapshot
    keyframes take their GBA poses and snapshot points their GBA positions
    (exactly); keyframes made during the flight keep their reprojection
    error within 0.05 px of what it was. The snapshot tensors stay as they
    were while the live map moves on (every map update is out of place)."""
    s, _ = arc
    cfg = s.cfg
    lc = s.loop_closer
    m_snap, frozen, snap, res, m_live = merge_case
    n_kf_snap = int(m_snap.next_kf)
    assert int(m_live.next_kf) > n_kf_snap
    for k, v in m_snap._asdict().items():
        assert torch.equal(v, frozen[k]), f"snapshot field {k} changed"

    cam = (cfg.camera.fx, cfg.camera.fy, cfg.camera.cx, cfg.camera.cy)
    new_pts = m_live.pt_valid.numpy().copy()
    new_pts[:int(m_snap.next_pt)] = False
    live_valid = m_live.kf_valid.numpy()
    new_kfs = [k for k in range(n_kf_snap, int(m_live.next_kf))
               if live_valid[k]]
    before = {k: _reproj_rmse(m_live, k, new_pts, cam) for k in new_kfs}

    merged = lc._merge_gba(m_live, res, snap,
                           np.arange(m_live.max_pt, dtype=np.int64))
    fid_live = m_live.kf_frame_id.numpy()
    snap_slot = {int(f): i for i, f in enumerate(snap["kf_frame_id"])
                 if snap["kf_valid"][i]}
    n_checked = 0
    for j in np.where(live_valid)[0]:
        sslot = snap_slot.get(int(fid_live[j]), -1)
        if sslot >= 0:
            np.testing.assert_allclose(merged.kf_pose[j].numpy(),
                                       res.cam_pose[sslot].numpy(), atol=1e-6)
            n_checked += 1
    assert n_checked >= 3
    for k in new_kfs:
        if before[k] is None:
            continue
        after = _reproj_rmse(merged, k, new_pts, cam)
        assert after is not None and abs(after - before[k]) < 0.05
    sel = snap["pt_valid"] & m_live.pt_valid.numpy()
    np.testing.assert_allclose(merged.pt_xyz.numpy()[sel],
                               res.pt_xyz.numpy()[sel], atol=1e-6)


def test_merge_matches_jax_after_point_compaction(arc, merge_case):
    """The port's `LoopCloser._merge_gba` against the JAX package's on the
    same live map, snapshot record and GBA result, with a point compaction
    while the GBA was in flight: the live map compacted and the
    snapshot-to-live point map its remap (as `note_pt_remap` composes
    it), which moves snapshot points to other slots. Snapshot keyframes
    take the same GBA poses exactly, keyframes made in flight lie within
    1e-4 m of JAX's, every point within 1e-5 m."""
    import types

    import jax.numpy as jnp

    from eao_fusion_tpu import config as JC
    from eao_fusion_tpu.mapping import map_state as JMS
    from eao_fusion_tpu.pipeline import loop_closing as JLC
    from eao_fusion_tpu_torch.mapping import map_state as TMS
    s, _ = arc
    lc = s.loop_closer
    _, _, snap, res, m_live = merge_case
    m_c, remap = TMS.compact_points(m_live)
    remap = remap.numpy().astype(np.int64)
    moved = snap["pt_valid"] & (remap >= 0) & (remap != np.arange(len(remap)))
    assert moved.any()                  # a non-identity remap
    pt_map = np.arange(m_c.max_pt, dtype=np.int64)
    lc_pm, lc._gba_pt_map = lc._gba_pt_map, pt_map
    lc.note_pt_remap(remap)
    pt_map, lc._gba_pt_map = lc._gba_pt_map, lc_pm
    np.testing.assert_array_equal(pt_map, remap)

    ours = lc._merge_gba(m_c, res, snap, pt_map)
    jcfg = JC.SystemConfig(
        orb=JC.ORBConfig(n_features=500, max_keypoints=512),
        capacity=JC.MapCapacity(max_keyframes=16, max_points=4096,
                                max_local_ba_kfs=16),
        tracking=JC.TrackingConfig(max_frames_between_kf=3),
        use_planes=False, use_objects=False)
    jm = JMS.MapState(**{k: jnp.asarray(v)
                         for k, v in TMS.to_numpy(m_c).items()})
    jres = types.SimpleNamespace(**{
        k: (None if v is None else v.numpy())
        for k, v in res._asdict().items()
        if k in ("cam_pose", "pt_xyz", "pl_coeff")})
    theirs = JLC.LoopCloser._merge_gba(types.SimpleNamespace(cfg=jcfg), jm,
                                       jres, snap, pt_map)
    kv = m_c.kf_valid.numpy()
    in_snap = np.isin(m_c.kf_frame_id.numpy(),
                      snap["kf_frame_id"][snap["kf_valid"]]) & kv
    flight = kv & ~in_snap
    assert in_snap.sum() >= 3 and flight.any()
    tk, jk = ours.kf_pose.numpy(), np.asarray(theirs.kf_pose)

    def centre(p):
        return lie.se3_inverse(torch.as_tensor(p))[:, 4:].numpy()
    pv = m_c.pt_valid.numpy()
    kf_diff = np.abs(centre(tk[flight]) - centre(jk[flight])).max()
    pt_diff = np.abs(ours.pt_xyz.numpy()[pv]
                     - np.asarray(theirs.pt_xyz)[pv]).max()
    print({"points_moved_by_the_remap": int(moved.sum()),
           "snapshot_keyframes": int(in_snap.sum()),
           "inflight_keyframes": int(flight.sum()),
           "inflight_kf_diff_m": float(kf_diff), "pt_diff_m": float(pt_diff)})
    np.testing.assert_array_equal(tk[in_snap], jk[in_snap])
    assert kf_diff < 1e-4
    assert pt_diff < 1e-5
