"""The fr3-scale production run of the port (`dev/torch_run_fr3_scale.py`)
at a small size on the CPU: its loop alone, and against the JAX System
driven the way the JAX package's `dev/run_fr3_scale.py:112-141` drives it
(without its `prewarm`, which compiles ahead and changes nothing else).
The cached 24-frame seed-0 arc is one lap; planes, objects (the
renderer's boxes) and loop closing on, 512 keypoint slots and the 12-slot
keyframe table of `chip_smoke.py` phase 8 (a keyframe allowed every
frame), so that keyframe compaction fires inside `chunk_epilogue`."""

import dataclasses
import importlib.util
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eao_fusion_tpu import config as JC
from eao_fusion_tpu.io import synthetic
from eao_fusion_tpu.pipeline import steady as JSt
from eao_fusion_tpu.pipeline.system import System as JSystem
from eao_fusion_tpu_torch import config as TC
from eao_fusion_tpu_torch import kernels
from eao_fusion_tpu_torch.io import tum
from eao_fusion_tpu_torch.pipeline.system import System

from test_torch_imports import _forbidden, _imported
from test_torch_slice_e2e import _assert_same_trajectory

DEV = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "dev")
CHUNK = 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This module's torch ops on one CPU thread (tier-1 runs six test
    files at once; see tests/test_torch_loop.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _runner():
    spec = importlib.util.spec_from_file_location(
        "torch_run_fr3_scale", os.path.join(DEV, "torch_run_fr3_scale.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_runner_imports_no_jax():
    """The port's script stands alone, as the package does."""
    names = list(_imported("dev/torch_run_fr3_scale.py"))
    assert "eao_fusion_tpu_torch.pipeline.system" in names
    assert not [n for n in names if _forbidden(n)]


def _small(C):
    """The small configuration in either package's config module."""
    return C.SystemConfig(
        orb=C.ORBConfig(n_features=500, max_keypoints=512),
        capacity=C.MapCapacity(max_keyframes=12, max_local_ba_kfs=12,
                               max_points=4096),
        tracking=dataclasses.replace(C.TrackingConfig(),
                                     max_frames_between_kf=1))


def _jax_record_keys():
    """The keys of the JAX script's JSON record (`out = {...}`)."""
    with open(os.path.join(DEV, "run_fr3_scale.py")) as fh:
        src = fh.read()
    body = src[src.index("    out = {"):]
    body = body[:body.index("}\n")]
    return set(re.findall(r'"([a-z0-9_]+)":', body))


@pytest.fixture(scope="module")
def seq():
    return synthetic.generate_sequence(n_frames=24, seed=0, style="arc",
                                       cache_dir=synthetic.DEFAULT_CACHE)


@pytest.fixture(scope="module")
def port_run(seq):
    """The port's System through `run_scale`, one lap, chunks of 6; the
    keyframe count after each warm-up frame."""
    R = _runner()
    s = System(_small(TC), device="cpu")
    assert s.cfg.use_planes and s.cfg.use_objects and s.cfg.use_loop_closing
    n_kf, process = [], s.process_frame

    def counted(*a, **kw):
        pose = process(*a, **kw)
        n_kf.append(s.n_keyframes)
        return pose
    s.process_frame = counted
    before = dict(kernels.launches)
    out = R.run_scale(s, seq, laps=1, chunk=CHUNK)
    assert kernels.launches == dict.fromkeys(before, 0)   # reset, none on CPU
    return R, s, out, n_kf


def test_runner_record_and_events(port_run, seq):
    """The record has the JAX script's keys but `prewarm_s`, and the
    readings the port's script adds; the timed frames follow the JAX
    script's rule (whole chunks only, the first left out); a keyframe
    compaction fires in a chunk epilogue and the event log names its
    chunk; `ate_cm` is the ATE of the raw per-chunk poses."""
    R, s, out, _ = port_run
    jax_keys = _jax_record_keys()
    assert "prewarm_s" in jax_keys and "ate_cm" in jax_keys
    added = {"ate_corrected_cm", "lap_ate_cm", "kf_gt_err_cm",
             "corrected_moved_over_50cm", "n_resets", "chunked_frames",
             "events", "launches", "reloc_pose_solves", "first_chunk_ms",
             "median_chunk_ms", "median_epilogue_ms", "peak_memory_mb",
             "device"}
    assert set(out) == (jax_keys - {"prewarm_s"}) | added
    n_chunks = (len(seq.frames) - R.N_WARM) // CHUNK
    assert out["chunked_frames"] == n_chunks * CHUNK
    assert out["frames"] == (n_chunks - 1) * CHUNK
    assert out["device"] == "cpu" and out["peak_memory_mb"] is None
    assert out["kf_compactions"] >= 1
    assert out["events"]["kf_compaction"], out["events"]
    assert all(0 <= c < n_chunks for c in out["events"]["kf_compaction"])
    assert out["n_resets"] == 0
    assert out["lifetime_kf_insertions"] > 12
    assert out["peak_kf_live"] <= 12
    raw = np.stack(s.trajectory)[R.N_WARM:R.N_WARM + out["chunked_frames"]]
    gt = seq.gt_tcw()[R.N_WARM:R.N_WARM + out["chunked_frames"]]
    assert out["ate_cm"] == tum.evaluate_ate_rpe(raw, gt).ate_rmse * 100
    assert out["ate_cm"] < 5.0 and out["ate_corrected_cm"] < 5.0
    assert out["lap_ate_cm"] == [out["ate_cm"]]          # one lap
    assert out["kf_gt_err_cm"]["over_50"] == 0 and not out["events"]["kf_far"]
    assert out["corrected_moved_over_50cm"] == 0


def _held_cameras(prob, min_obs: int) -> torch.Tensor:
    """The window cameras of local BA problem `prob` with fewer than
    `min_obs` edges in its capped edge list ([C] bool)."""
    kept = torch.bincount(prob.obs_cam[prob.obs_valid].long(),
                          minlength=prob.cam_pose.shape[0])
    return prob.cam_valid & (kept < min_obs)


def _against_jax(m, slot: int, prob, out, jcfg) -> dict:
    """The port's local-mapping step on map `m` (its BA problem `prob`,
    its result `out`) against the JAX package's `local_mapping_step` from
    the same map, on the CPU: the keyframes the port held (cameras under
    `min_cam_obs` edges), whether they kept their poses, how far JAX moved
    them, and how far every other live keyframe lies from JAX's (cm)."""
    from eao_fusion_tpu.mapping import map_state as JMS
    from eao_fusion_tpu.ops import lie as JL
    from eao_fusion_tpu.pipeline import local_mapping as JLM
    from eao_fusion_tpu_torch.mapping import map_state as TMS
    mn = TMS.to_numpy(m)
    jo = JLM.local_mapping_step(
        JMS.MapState(**{k: jnp.asarray(v) for k, v in mn.items()}),
        jnp.int32(slot), cfg=jcfg)
    j_pose, j_valid = np.asarray(jo.kf_pose), np.asarray(jo.kf_valid)
    t_pose, t_valid = out.kf_pose.cpu().numpy(), out.kf_valid.cpu().numpy()
    cams = prob.cam_pose.cpu().numpy()[
        _held_cameras(prob, jcfg.solver.min_cam_obs).cpu().numpy()]
    # a window camera's slot: the live keyframe with its pose
    eq = (mn["kf_pose"][None] == cams[:, None]).all(-1) & mn["kf_valid"]
    held = eq.any(0) & t_valid

    def centres(p):
        return np.asarray(JL.se3_inverse(p))[:, 4:]

    live = t_valid & j_valid & ~held
    return dict(
        slot=int(slot), same_kf_valid=bool((t_valid == j_valid).all()),
        n_held=int(held.sum()),
        held_still=bool((t_pose[held] == mn["kf_pose"][held]).all()),
        jax_moved_held_cm=float(np.linalg.norm(
            centres(j_pose[held]) - centres(mn["kf_pose"][held]),
            axis=1).max(initial=0.0) * 100),
        diff_cm=float(np.linalg.norm(
            centres(t_pose[live]) - centres(j_pose[live]), axis=1).max()
            * 100))


def test_local_ba_freezes_cameras_the_edge_cap_starves(port_run,
                                                      monkeypatch):
    """Local BA's edge list is capped (`max_local_ba_obs`) and keeps edges
    in window order, so the cap can leave a late window camera with fewer
    than `min_cam_obs` edges, or none, held by its plane factors alone.
    Such a camera is frozen and keeps its pose. Below the cap the frozen
    set is the JAX package's (fewer than `min_cam_obs` observations) and
    the step is JAX's; under a cap that starves a camera, every other
    keyframe still lands where JAX's step puts it."""
    from eao_fusion_tpu_torch.pipeline import local_mapping as LM
    _, s, _, _ = port_run
    seen, bundle_adjust = [], LM.ba.bundle_adjust_coo

    def spy(prob, plane_block=None, **kw):
        res = bundle_adjust(prob, plane_block, **kw)
        seen.append((prob, res))
        return res
    monkeypatch.setattr(LM.ba, "bundle_adjust_coo", spy)
    m, slot = s.map, int(s.map.next_kf) - 1
    min_obs = s.cfg.solver.min_cam_obs

    def kept(prob):
        return torch.bincount(prob.obs_cam[prob.obs_valid].long(),
                              minlength=prob.cam_pose.shape[0])

    out = LM.local_mapping_step(m, slot, cfg=s.cfg)
    prob, _ = seen[-1]
    n = kept(prob)
    assert int(n.sum()) < prob.obs_valid.shape[0]       # below the cap
    free = prob.cam_valid & ~prob.cam_fixed
    assert torch.equal(free, prob.cam_valid & (n >= min_obs) & free)
    r = _against_jax(m, slot, prob, out, _small(JC))
    assert r["same_kf_valid"] and r["held_still"], r
    assert r["diff_cm"] < 0.1, r
    # caps that leave the second free camera min_cam_obs - 1 edges, and
    # none; with none it touches no point, and the rest is JAX's step
    c1, c2 = torch.nonzero(free).flatten()[:2].tolist()
    jcfg = _small(JC)
    for left in (min_obs - 1, 0):
        cap = int(n[:c2].sum()) + left
        cfg = s.cfg.replace(capacity=dataclasses.replace(
            s.cfg.capacity, max_local_ba_obs=cap))
        out = LM.local_mapping_step(m, slot, cfg=cfg)
        prob, res = seen[-1]
        assert int(kept(prob)[c2]) == left and bool(prob.cam_valid[c2])
        assert bool(prob.cam_fixed[c2]) and not bool(prob.cam_fixed[c1])
        assert torch.equal(res.cam_pose[c2], prob.cam_pose[c2])
        assert bool(prob.cam_fixed[_held_cameras(prob, min_obs)].all())
    r = _against_jax(m, slot, prob, out, jcfg.replace(
        capacity=dataclasses.replace(jcfg.capacity, max_local_ba_obs=cap)))
    print(r)
    assert r["same_kf_valid"] and r["held_still"] and r["n_held"] >= 1, r
    assert r["diff_cm"] < 0.1, r


def _jax_run(seq, n_warm, chunk):
    """The JAX System through the loop of dev/run_fr3_scale.py:112-141,
    one lap, without `prewarm`: the poses, the keyframe decision of every
    frame, the compactions and the lifetime insertions."""
    cfg = _small(JC)
    s = JSystem(cfg)
    poses, kf = [], []
    for k in range(n_warm):
        f = seq.frames[k]
        n0 = s.n_keyframes
        poses.append(np.asarray(s.process_frame(
            f.gray, f.depth, timestamp=k / 30.0, boxes=f.boxes)))
        kf.append(s.n_keyframes > n0)
    nb = cfg.objects.max_objects_2d

    def pad(b):
        out = np.zeros((nb, 6), np.float32)
        if b is not None and len(b):
            out[:min(len(b), nb)] = b[:nb]
        return out

    st = JSt.init_steady_state(s)
    lifetime_kf = s.n_keyframes
    kf_hint = None
    for lo in range(n_warm, len(seq.frames), chunk):
        idxs = list(range(lo, min(lo + chunk, len(seq.frames))))
        if len(idxs) < chunk:
            break
        fr = [seq.frames[i] for i in idxs]
        tss = jnp.asarray([(lo + j) / 30.0 for j in range(chunk)],
                          jnp.float32)
        kf_before = kf_hint if kf_hint is not None \
            else int(np.asarray(st.m.next_kf))
        st, diag = JSt.slam_chunk(
            st, jnp.asarray(np.stack([f.gray for f in fr])),
            jnp.asarray(np.stack([f.depth for f in fr])),
            jnp.asarray(np.stack([pad(f.boxes) for f in fr])), tss, cfg=cfg)
        poses.extend(np.asarray(diag["pose"]))
        kf.extend(np.asarray(diag["kf_inserted"]).astype(bool))
        st = s.chunk_epilogue(st, kf_before)
        lifetime_kf += s.n_keyframes - kf_before
        kf_hint = s.next_kf_hint
    s._poll_gba(blocking=True)
    return dict(poses=np.stack(poses), kf=np.array(kf),
                kf_compactions=s.n_kf_compactions,
                lifetime_kf_insertions=lifetime_kf)


def test_runner_matches_jax(port_run, seq):
    """The same keyframe decision on every frame, the same compactions and
    lifetime insertions, and every raw pose within 5 mm and 0.3 degrees
    (the bound of the System twins)."""
    R, s, out, n_kf = port_run
    j = _jax_run(seq, R.N_WARM, CHUNK)
    n = R.N_WARM + out["chunked_frames"]
    kf_warm = np.diff([0] + n_kf) > 0
    kf_chunks = np.array([d["kf_inserted"] for d in s.diags[-out[
        "chunked_frames"]:]]).astype(bool)
    np.testing.assert_array_equal(np.concatenate([kf_warm, kf_chunks]),
                                  j["kf"])
    assert out["kf_compactions"] == j["kf_compactions"]
    assert out["lifetime_kf_insertions"] == j["lifetime_kf_insertions"]
    _assert_same_trajectory(np.stack(s.trajectory)[:n], j["poses"])


@pytest.mark.gpu
def test_loop_corrections_match_jax_on_the_card():
    """On the card, the 2-lap fr3-scale run at the JAX script's
    configuration (`run_scale`, production tables): each loop correction
    the port makes also runs, on the same map, Sim3 and loop edges,
    through the JAX package's `LoopCloser.correct` and the port's, both
    with the global BA synchronous. The same keyframe and point validity,
    keyframe centres within 1 cm, points within 1 cm at the median; at
    least two corrections, one of them after the first keyframe
    compaction. Prints each correction's values, with how far it moved a
    keyframe and how far the keyframes then lie from the ground truth."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from eao_fusion_tpu.mapping import map_state as JMS
    from eao_fusion_tpu.mapping import vocabulary as JV
    from eao_fusion_tpu.ops import lie as JL
    from eao_fusion_tpu.pipeline import loop_closing as JLC
    from eao_fusion_tpu_torch.mapping import map_state as TMS
    from eao_fusion_tpu_torch.pipeline import loop_closing as TLC

    R = _runner()
    seq = R.render_tour(cache_dir=os.path.join(os.path.dirname(DEV),
                                               "build", "synth_cache"))
    s = System(R.scale_cfg())
    lc = s.loop_closer
    jcfg = JC.SystemConfig(loop=dataclasses.replace(JC.LoopConfig(),
                                                    async_gba=False))
    tcfg = s.cfg.replace(loop=dataclasses.replace(s.cfg.loop,
                                                  async_gba=False))
    jl = JLC.LoopCloser(jcfg, JV.Vocabulary.load())
    tl = TLC.LoopCloser(tcfg, lc.vocab, torch.Generator(device="cuda"))

    def centres(p):
        return np.asarray(JL.se3_inverse(np.asarray(p)))[:, 4:]

    rows, correct = [], lc.correct

    def compared(m, cur, cand, g):
        mn = TMS.to_numpy(m)
        jl.loop_edges = list(lc.loop_edges)
        tl.loop_edges = list(lc.loop_edges)
        cj = jl.correct(JMS.MapState(**{k: jnp.asarray(v)
                                        for k, v in mn.items()}),
                        cur, cand, jnp.asarray(g.cpu().numpy()))
        cj = {k: np.asarray(v) for k, v in cj._asdict().items()}
        ct = TMS.to_numpy(tl.correct(TMS.from_numpy(mn, "cuda"), cur, cand,
                                     g.clone()))
        kv, pv = cj["kf_valid"], cj["pt_valid"]
        gt = centres(np.stack([seq.frames[int(f) % len(seq.frames)].tcw
                               for f in mn["kf_frame_id"][kv]]))
        rows.append(dict(
            kf_compactions_before=s.n_kf_compactions, cur=int(cur),
            cand=int(cand),
            same_kf_valid=bool((ct["kf_valid"] == kv).all()),
            same_pt_valid=bool((ct["pt_valid"] == pv).all()),
            kf_diff_cm=float(np.linalg.norm(
                centres(ct["kf_pose"][kv]) - centres(cj["kf_pose"][kv]),
                axis=1).max() * 100),
            pt_diff_cm_median=float(np.median(np.linalg.norm(
                ct["pt_xyz"][pv] - cj["pt_xyz"][pv], axis=1)) * 100),
            kf_moved_cm_max=float(np.linalg.norm(
                centres(cj["kf_pose"][kv]) - centres(mn["kf_pose"][kv]),
                axis=1).max() * 100),
            kf_gt_err_cm_max=float(np.linalg.norm(
                centres(cj["kf_pose"][kv]) - gt, axis=1).max() * 100)))
        print("correction", rows[-1], flush=True)
        return correct(m, cur, cand, g)
    lc.correct = compared
    out = R.run_scale(s, seq, laps=2, chunk=8)
    print({k: out[k] for k in ("ate_cm", "ate_corrected_cm", "lap_ate_cm",
                               "events")})
    assert len(rows) >= 2
    assert any(r["kf_compactions_before"] >= 1 for r in rows)
    for r in rows:
        assert r["same_kf_valid"] and r["same_pt_valid"], r
        assert r["kf_diff_cm"] < 1.0 and r["pt_diff_cm_median"] < 1.0, r


@pytest.mark.gpu
def test_local_mapping_matches_jax_on_the_card(monkeypatch):
    """On the card, the 2-lap fr3-scale run at the JAX script's
    configuration (`run_scale`, production tables): up to 8 local-mapping
    steps whose capped edge list left a local window camera with no edge
    (and none with 1 to `min_cam_obs` - 1) also run, from the same map,
    through the JAX package's `local_mapping_step` (on the CPU). The port
    holds such cameras in place, where the JAX package leaves them free
    on their plane factors alone; every other live keyframe lands within
    1 cm of JAX's, with the same keyframe validity. Prints each step,
    with how far JAX moved the held keyframes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from eao_fusion_tpu_torch.pipeline import local_mapping as LM

    R = _runner()
    seq = R.render_tour(cache_dir=os.path.join(os.path.dirname(DEV),
                                               "build", "synth_cache"))
    s = System(R.scale_cfg())
    jcfg = JC.SystemConfig()
    n_local = s.cfg.capacity.max_local_ba_kfs - 8
    min_obs = s.cfg.solver.min_cam_obs
    probs, rows = [], []
    bundle_adjust, step = LM.ba.bundle_adjust_coo, LM.local_mapping_step

    def spy(prob, plane_block=None, **kw):
        probs.append(prob)
        return bundle_adjust(prob, plane_block, **kw)

    def compared(m, slot, *, cfg):
        out = step(m, slot, cfg=cfg)
        prob = probs.pop()
        kept = torch.bincount(prob.obs_cam[prob.obs_valid].long(),
                              minlength=prob.cam_pose.shape[0])[:n_local]
        live = prob.cam_valid[:n_local]
        if (len(rows) < 8 and bool(prob.obs_valid.all())
                and bool((live & (kept == 0)).any())
                and not bool((live & (kept > 0) & (kept < min_obs)).any())):
            rows.append(dict(_against_jax(m, slot, prob, out, jcfg),
                             frame=int(m.kf_frame_id[slot]),
                             kf_compactions_before=s.n_kf_compactions))
            print("local mapping", rows[-1], flush=True)
        return out
    monkeypatch.setattr(LM.ba, "bundle_adjust_coo", spy)
    monkeypatch.setattr(LM, "local_mapping_step", compared)
    out = R.run_scale(s, seq, laps=2, chunk=8)
    print({k: out[k] for k in ("ate_cm", "ate_corrected_cm",
                               "kf_gt_err_cm", "events")})
    assert rows
    print({"steps": len(rows),
           "diff_cm_max": max(r["diff_cm"] for r in rows),
           "jax_moved_held_cm_max": max(r["jax_moved_held_cm"]
                                        for r in rows)})
    for r in rows:
        assert r["same_kf_valid"] and r["held_still"], r
        assert r["diff_cm"] < 1.0, r


@pytest.mark.gpu
def test_steps_match_jax_on_the_card():
    """On the card, the first 270 chunked frames of the tour at the JAX
    script's configuration: the JAX `slam_step` runs every frame from its
    own state; every tenth frame the port's `slam_step` runs once on the
    card from that same state (an empty object table: the lane's randoms
    are the generator's). The port's pose is within 1 cm of JAX's on every
    sampled frame, and on average no nearer the ground truth and no
    farther from it than 0.1 cm. Prints each sampled frame."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import jax

    from eao_fusion_tpu.ops import lie as JL
    from eao_fusion_tpu_torch.mapping import map_state as TMS
    from eao_fusion_tpu_torch.objects import object_map as om
    from eao_fusion_tpu_torch.pipeline import steady, tracking

    R = _runner()
    seq = R.render_tour(cache_dir=os.path.join(os.path.dirname(DEV),
                                               "build", "synth_cache"))
    jcfg, tcfg, dev = JC.SystemConfig(), R.scale_cfg(), "cuda"
    js = JSystem(jcfg)
    for k in range(R.N_WARM):
        f = seq.frames[k]
        js.process_frame(f.gray, f.depth, timestamp=k / 30.0, boxes=f.boxes)
    st = JSt.init_steady_state(js)
    nb = jcfg.objects.max_objects_2d
    rows = []
    for fi in range(R.N_WARM, R.N_WARM + 270):
        f = seq.frames[fi]
        bx = R._pad_boxes(f.boxes, nb)
        if fi % 10 == 0:
            m = TMS.from_numpy(jax.tree.map(np.asarray, st.m)._asdict(), dev)
            ts = tracking.track_state_from_numpy(
                jax.tree.map(np.asarray, st.ts), dev)
            tst, _ = steady.slam_step(
                steady.SteadyState(
                    m=m, ts=ts, objs=om.empty_table(tcfg, dev),
                    last_fo=steady.empty_frame_objects(tcfg, m, ts),
                    frame_id=int(np.asarray(st.frame_id)),
                    generator=torch.Generator(device=dev).manual_seed(11)),
                torch.as_tensor(f.gray, device=dev),
                torch.as_tensor(f.depth, device=dev),
                torch.as_tensor(bx, device=dev), fi / 30.0, cfg=tcfg)
        st, _ = JSt.slam_step(st, jnp.asarray(f.gray), jnp.asarray(f.depth),
                               jnp.asarray(bx), jnp.float32(fi / 30.0),
                               cfg=jcfg)
        if fi % 10 == 0:
            c = [np.asarray(JL.se3_inverse(np.asarray(p)))[4:] for p in (
                st.ts.pose, tst.ts.pose.cpu().numpy(), f.tcw)]
            rows.append(dict(frame=fi,
                             diff_cm=float(np.linalg.norm(c[0] - c[1]) * 100),
                             jax_err_cm=float(np.linalg.norm(c[0] - c[2])
                                              * 100),
                             port_err_cm=float(np.linalg.norm(c[1] - c[2])
                                               * 100)))
            print("step", rows[-1], flush=True)
    d = np.array([r["diff_cm"] for r in rows])
    e = np.array([r["port_err_cm"] - r["jax_err_cm"] for r in rows])
    print({"frames": len(rows), "diff_cm_median": float(np.median(d)),
           "diff_cm_max": float(d.max()),
           "port_minus_jax_err_cm_mean": float(e.mean()),
           "port_nearer": int((e < 0).sum()),
           "port_farther": int((e > 0).sum())})
    assert d.max() < 1.0
    assert abs(e.mean()) < 0.1
