"""The JAX package's long-run and sensor-robustness contracts, stated once
for the port: their configurations and inputs, and their bounds as
checks on a port System after its run. The CPU twins
(`tests/test_torch_{compaction,nuisance}_*.py`) and `chip_smoke.py`
phases 25-29 (on the card) drive the System and call these.

Each configuration, input and bound is its JAX test's:
  endurance      tests/test_endurance.py:22-71
  exploration    tests/test_kf_lifecycle.py:23-33,185-215
  compaction     tests/test_compaction.py:15-37
  nuisance       tests/test_nuisance_e2e.py:21-183
  odometry       tests/test_tracking_e2e.py:15-53

Imports torch and the port only, never JAX.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List

import numpy as np
import torch

from eao_fusion_tpu_torch.config import (CameraConfig, MapCapacity,
                                         ORBConfig, SystemConfig,
                                         TrackingConfig)
from eao_fusion_tpu_torch.io import tum

SMALL_CAM = CameraConfig(width=320, height=240, fx=267.7, fy=269.6,
                         cx=160.0, cy=120.0, bf=40.0, th_depth=40.0)
ORB512 = ORBConfig(n_features=500, max_keypoints=512)

# ATE floors per nuisance profile (metres), tests/test_nuisance_e2e.py:44-50
RGBD_FLOORS = {"shot": 0.02, "exposure": 0.02, "blur": 0.03, "depth": 0.03,
               "combo": 0.04}

WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "yolox_synth.npz")


# ------------------------------------------------------------ configurations

def endurance_cfg() -> SystemConfig:
    """Tight tables, about a tenth of production, so that 506 frames put
    the pressure of about 2500 on them; loop closing on (the default)."""
    return SystemConfig(orb=ORB512,
                        capacity=MapCapacity(max_keyframes=24,
                                             max_points=3072),
                        use_planes=False, use_objects=False)


def exploration_cfg() -> SystemConfig:
    return SystemConfig(camera=SMALL_CAM, orb=ORB512,
                        capacity=MapCapacity(max_keyframes=24,
                                             max_points=3072,
                                             max_local_ba_kfs=16),
                        use_planes=False, use_objects=False,
                        tracking=TrackingConfig(max_frames_between_kf=6))


def compaction_cfg() -> SystemConfig:
    return SystemConfig(orb=ORB512,
                        capacity=MapCapacity(max_keyframes=64,
                                             max_points=1024),
                        use_planes=False, use_objects=True,
                        use_loop_closing=False)


def nuisance_cfg(**kw) -> SystemConfig:
    base = dict(orb=ORB512,
                capacity=MapCapacity(max_keyframes=32, max_points=8192,
                                     max_local_ba_kfs=16),
                use_planes=False, use_objects=False)
    base.update(kw)
    return SystemConfig(**base)


def nuisance_mono_cfg() -> SystemConfig:
    return nuisance_cfg(sensor="mono",
                        tracking=TrackingConfig(max_frames_between_kf=3))


def odometry_cfg() -> SystemConfig:
    """`small_cfg` of tests/test_tracking_e2e.py."""
    return SystemConfig(orb=ORB512,
                        capacity=MapCapacity(max_keyframes=64,
                                             max_points=4096))


# -------------------------------------------------------------------- inputs

# the whole 625-frame seed-0 tour, one closed lap (frame 624 is frame 0's
# pose): the fr3-scale run replays it, the endurance contract takes its
# first ENDURANCE_FRAMES frames (tests/test_endurance.py:22-25)
TOUR_SPEC = dict(n_frames=625, seed=0, style="tour")
ENDURANCE_FRAMES = 506
ENDURANCE_SPEC = dict(TOUR_SPEC, frames=list(range(ENDURANCE_FRAMES)))
EXPLORATION_SPEC = dict(n_frames=240, seed=5, style="corridor",
                        camera=SMALL_CAM)
FORWARD_SPEC = dict(n_frames=15, seed=3, style="forward")


def endurance_sequence(tour):
    """The endurance contract's input: the tour's first ENDURANCE_FRAMES
    frames."""
    return dataclasses.replace(tour, frames=tour.frames[:ENDURANCE_FRAMES])


def depth_noise_arc():
    """The 12-frame seed-5 arc with 1 cm depth noise (rendered serially:
    the noise is one random stream over the frames)."""
    from eao_fusion_tpu_torch.io import synthetic
    return synthetic.generate_sequence(n_frames=12, seed=5, style="arc",
                                       depth_noise=0.01)


def _gt(seq) -> np.ndarray:
    return np.stack([f.tcw for f in seq.frames])


def _n_weak(s) -> int:
    return sum(1 for d in s.diags[2:] if d["n_inliers"] < 20)


def occupancy(s) -> Dict:
    """The table occupancy and lifecycle counters of a System."""
    m = s.map
    return {"frame": s.frame_id, "live_kfs": int(m.kf_valid.sum()),
            "lifetime_kfs": s.n_keyframes, "next_kf": int(m.next_kf),
            "live_pts": int(m.pt_valid.sum()), "next_pt": int(m.next_pt),
            "n_pt_compactions": s.n_pt_compactions,
            "n_kf_compactions": s.n_kf_compactions,
            "n_kf_evictions": s.n_kf_evictions,
            "loops": s.n_loops_closed, "gba_merges": s.n_gba_merges}


def check_bow_rows(s) -> int:
    """The loop closer's BoW database after the run's slot remaps: the row
    of every live keyframe is the bow vector of that keyframe's own
    descriptors, bit for bit (a row left behind by a compaction or an
    eviction would be another keyframe's). The RGBD map's first keyframe
    (frame 0) never passes through loop detection, in the JAX System too
    (`eao_fusion_tpu/pipeline/system.py:232-247`), so its row may be
    empty. Returns the rows held to their bow vectors."""
    from eao_fusion_tpu_torch.mapping import vocabulary
    lc, m = s.loop_closer, s.map
    n = 0
    for k in torch.nonzero(m.kf_valid).flatten().tolist():
        row = lc.bow[k]
        if int(m.kf_frame_id[k]) == 0 and not bool(row.any()):
            continue
        want = vocabulary.bow_vector(lc.vocab, m.kf_desc_pm1[k],
                                     m.kf_kp_valid[k])
        assert torch.equal(row, want), f"bow row of slot {k}"
        n += 1
    return n


# ---------------------------------------------------------------- the bounds

def check_endurance(s, seq) -> Dict:
    cfg = s.cfg
    n_lost = _n_weak(s)
    m = s.map
    n_pts, n_kfs = int(m.pt_valid.sum()), int(m.kf_valid.sum())
    est, gt = s.trajectory_tcw(corrected=True), _gt(seq)
    n = min(len(est), len(gt))
    err = tum.evaluate_ate_rpe(est[:n], gt[:n])
    e1 = tum.evaluate_ate_rpe(est[3:n // 2], gt[3:n // 2])
    e2 = tum.evaluate_ate_rpe(est[n // 2:n], gt[n // 2:n])
    out = {"frames": n, "weak_frames": n_lost, "resets": s.n_resets,
           "live_pts": n_pts, "live_kfs": n_kfs,
           "ate_cm": err.ate_rmse * 100, "first_half_ate_cm":
           e1.ate_rmse * 100, "second_half_ate_cm": e2.ate_rmse * 100}
    assert n_lost <= 10, out
    assert s.n_resets == 0, out
    assert n_pts <= cfg.capacity.max_points, out
    assert 0 < n_kfs <= cfg.capacity.max_keyframes, out
    assert n_kfs <= 24, out
    assert err.ate_rmse < 0.05, out
    assert e2.ate_rmse < 3.0 * max(e1.ate_rmse, 0.005), out
    return out


def check_exploration(s, seq) -> Dict:
    cfg = s.cfg
    est, gt = s.trajectory_tcw(corrected=True), _gt(seq)
    err = tum.evaluate_ate_rpe(est, gt[:len(est)])
    out = {"frames": len(seq.frames), "lifetime_kfs": s.n_keyframes,
           "next_kf": int(s.map.next_kf),
           "live_kfs": int(s.map.kf_valid.sum()),
           "live_pts": int(s.map.pt_valid.sum()), "resets": s.n_resets,
           "weak_frames": _n_weak(s), "ate_cm": err.ate_rmse * 100}
    assert s.n_keyframes > cfg.capacity.max_keyframes, out
    assert out["next_kf"] <= cfg.capacity.max_keyframes, out
    assert out["live_pts"] <= cfg.capacity.max_points, out
    assert s.n_resets == 0, out
    assert out["weak_frames"] <= 10, out
    assert err.ate_rmse < 0.10, out
    return out


def compaction_frames(next_pts: List[int]) -> List[int]:
    """Point compactions seen from outside: the frames whose `next_pt`
    fell below the previous frame's."""
    return [i for i in range(1, len(next_pts))
            if next_pts[i] < next_pts[i - 1]]


def check_compaction(s, seq, next_pts: List[int]) -> Dict:
    err = tum.evaluate_ate_rpe(s.trajectory_tcw(), _gt(seq))
    frames = compaction_frames(next_pts)
    out = {"compactions": len(frames), "compaction_frames": frames,
           "n_pt_compactions": s.n_pt_compactions,
           "ate_cm": err.ate_rmse * 100,
           "last_frame_inliers": s.diags[-1]["n_inliers"]}
    assert out["compactions"] >= 1, out
    assert err.ate_rmse < 0.03, out
    assert out["last_frame_inliers"] > 60, out
    # the facade's own count agrees with what is seen from outside
    assert s.n_pt_compactions == out["compactions"], out
    return out


def check_rgbd_nuisance(s, seq, profile: str) -> Dict:
    est, gt = s.trajectory_tcw(), _gt(seq)
    err = tum.evaluate_ate_rpe(est[2:], gt[2:len(est)])
    out = {"profile": profile, "ate_cm": err.ate_rmse * 100,
           "floor_cm": RGBD_FLOORS[profile] * 100,
           "weak_frames": _n_weak(s)}
    assert err.ate_rmse < RGBD_FLOORS[profile], out
    assert out["weak_frames"] <= 2, out
    return out


def check_mono_nuisance(s, seq) -> Dict:
    """Scale-aligned ATE from the first frame that moved (the ground truth
    is the clean sequence's; the nuisance keeps the poses)."""
    est, gt = s.trajectory_tcw(), _gt(seq)
    nonid = [i for i, p in enumerate(s.trajectory)
             if np.linalg.norm(np.asarray(p)[4:]) > 1e-6]
    assert nonid, "mono init never produced motion under combo nuisance"
    i0 = nonid[0]
    err = tum.evaluate_ate_rpe(est[i0:], gt[i0:len(est)], align=True,
                               with_scale=True)
    out = {"init_frame": i0, "ate_cm": err.ate_rmse * 100}
    assert err.ate_rmse < 0.08, out
    return out


def check_retrieval_nuisance(s, nseq) -> Dict:
    """Each live keyframe's frame, nuisanced, must retrieve its own
    keyframe or one covisible with it (>= 15 shared points) as the top
    L1 score of the loop closer's BoW database, for 80% of them."""
    from eao_fusion_tpu_torch.frontend import extractor
    from eao_fusion_tpu_torch.mapping import covisibility, vocabulary
    lc, cfg, dev = s.loop_closer, s.cfg, s.device
    assert lc is not None
    kf_valid = s.map.kf_valid.cpu().numpy()
    kf_fids = s.map.kf_frame_id.cpu().numpy()
    covis = covisibility.covisibility_counts(
        covisibility.observation_indicator(s.map)).cpu().numpy()
    hits = exact = total = 0
    for slot in np.where(kf_valid)[0]:
        nf = nseq.frames[int(kf_fids[slot])]
        feats = extractor.extract_features(
            torch.as_tensor(nf.gray, device=dev),
            torch.as_tensor(nf.depth, device=dev),
            orb_cfg=cfg.orb, cam_cfg=cfg.camera)
        v = vocabulary.bow_vector(lc.vocab, feats.desc_pm1, feats.valid)
        scores = vocabulary.l1_scores(v, lc.bow, s.map.kf_valid)
        top = int(torch.argmax(scores))
        total += 1
        exact += top == int(slot)
        hits += int(top == int(slot) or covis[slot, top] >= 15)
    out = {"covisible_top1": hits, "exact_top1": exact, "keyframes": total}
    assert hits >= 0.8 * total, out
    return out


def detector_recall(det_lane, frames) -> float:
    """Recall at IoU 0.4 of the online detector lane over `frames` (the
    gray image repeated to RGB), as tests/test_nuisance_e2e.py counts it."""
    n_gt = hits = 0
    for f in frames:
        rgb = np.repeat(np.asarray(f.gray, np.float32)[..., None], 3,
                        axis=-1)
        det_lane.submit(rgb)
        det = det_lane.result()
        for b in f.boxes:
            n_gt += 1
            if det is None or not len(det):
                continue
            ix0 = np.maximum(det[:, 1], b[1])
            iy0 = np.maximum(det[:, 2], b[2])
            ix1 = np.minimum(det[:, 1] + det[:, 3], b[1] + b[3])
            iy1 = np.minimum(det[:, 2] + det[:, 4], b[2] + b[4])
            inter = np.maximum(ix1 - ix0, 0) * np.maximum(iy1 - iy0, 0)
            iou = inter / np.maximum(
                det[:, 3] * det[:, 4] + b[3] * b[4] - inter, 1e-9)
            hits += float(iou.max()) >= 0.4
    return hits / max(n_gt, 1)


def check_detector_nuisance(device, seq) -> Dict:
    """`data/yolox_synth.npz` on every fourth frame of the class-textured
    24-frame arc, clean and under `combo`: the nuisanced recall keeps half
    the clean one and is at least 0.4."""
    from eao_fusion_tpu_torch.frontend import yolox
    from eao_fusion_tpu_torch.io import synthetic
    params = yolox.load_params(WEIGHTS, device)
    depth_mult, n_classes = yolox.infer_arch(params)
    lane = yolox.Detector(params, depth_mult=depth_mult, n_classes=n_classes)
    r_clean = detector_recall(lane, seq.frames[::4])
    nseq = synthetic.nuisance_sequence(seq, "combo", seed=0)
    r_noisy = detector_recall(lane, nseq.frames[::4])
    out = {"recall_clean": r_clean, "recall_combo": r_noisy}
    assert r_noisy >= max(0.4, 0.5 * r_clean), out
    return out


def check_odometry(s, seq, bound_m: float) -> Dict:
    err = tum.evaluate_ate_rpe(s.trajectory_tcw(), _gt(seq))
    out = {"ate_cm": err.ate_rmse * 100, "bound_cm": bound_m * 100}
    assert err.ate_rmse < bound_m, out
    return out


def redundant_map(n_kf: int = 8, n_pt: int = 100, device="cpu"):
    """`_redundant_map` of tests/test_compaction.py on the port: n_kf
    keyframes all observing the same n_pt points, so every unprotected
    keyframe is a culling candidate."""
    from eao_fusion_tpu_torch.mapping import map_state as ms
    cfg = SystemConfig(orb=ORBConfig(n_features=300, max_keypoints=256),
                       capacity=MapCapacity(max_keyframes=16,
                                            max_points=512))
    m = ms.empty_map(cfg, device)
    row = torch.full((256,), -1, dtype=torch.int32, device=device)
    row[:n_pt] = torch.arange(n_pt, dtype=torch.int32, device=device)
    pt_valid, kf_valid = m.pt_valid.clone(), m.kf_valid.clone()
    pt_valid[:n_pt] = True
    kf_valid[:n_kf] = True
    kf_pt_idx = m.kf_pt_idx.clone()
    kf_pt_idx[:n_kf] = row
    i32 = dict(dtype=torch.int32, device=device)
    m = m._replace(pt_valid=pt_valid, kf_valid=kf_valid, kf_pt_idx=kf_pt_idx,
                   next_kf=torch.tensor(n_kf, **i32),
                   next_pt=torch.tensor(n_pt, **i32))
    return ms.refresh_obs_ind(m)


# (keyframes, max_cull) -> live keyframes after one `cull_keyframes` call
# on `redundant_map`, and the slots that must survive
# (tests/test_compaction.py:89-118)
CULL_CASES = {(8, 1): (7, (0, 6, 7)), (8, 3): (5, (0, 6, 7)),
              (8, 8): (3, (0, 6, 7)), (5, 4): (3, (0, 3, 4))}


def check_cull(kf_valid: np.ndarray, n_kf: int, max_cull: int) -> None:
    live, keep = CULL_CASES[(n_kf, max_cull)]
    assert kf_valid.sum() == live, (n_kf, max_cull, kf_valid)
    assert kf_valid[list(keep)].all(), (n_kf, max_cull, kf_valid)


def check_cull_on(device) -> Dict:
    """Every culling case on `device` against the CPU: the same keyframes,
    and the JAX tests' survivors. Returns the live count of each case."""
    from eao_fusion_tpu_torch.pipeline import local_mapping
    out = {}
    for n_kf, max_cull in CULL_CASES:
        got = [local_mapping.cull_keyframes(
            redundant_map(n_kf, device=d), n_kf - 1,
            max_cull=max_cull).kf_valid.cpu().numpy() for d in (device, "cpu")]
        np.testing.assert_array_equal(*got)
        check_cull(got[0], n_kf, max_cull)
        out[f"{n_kf} keyframes, max_cull {max_cull}"] = int(got[0].sum())
    return out


# ---------------------------------------------------------------- the kidnap
# Exploration that evicts, a jump back to where it began (a place whose
# keyframes eviction removed), then a jump into the live map: the kidnap
# contract (chip_smoke.py phase 31, tests/test_torch_kidnap.py). The
# workload replays the rendered corridor; nothing new is rendered.

KIDNAP_FRAMES = 24        # the kidnap: the corridor's frames 0-23 again
RETURN_FRAMES = 48        # the return: frames back .. back + 47
BACK_EXPLORATION = 192    # 31a: 2.35 m behind the pass's last frame
BACK_SCALE = 120          # 31b: full width, 64 keyframe slots
CHUNK = 8                 # the steady loop's chunk (dev/torch_run_fr3_scale)
CHUNK_WARM = 8            # process_frame frames before the first chunk
# the map fields a LOST frame must leave bit for bit as they were
LOST_FIELDS = ("kf_valid", "kf_pose", "pt_valid", "pt_xyz")
# the bounds of tests/test_reloc_e2e.py:40-48
RELOC_M, RELOC_RAD = 0.05, 0.05
CORRIDOR_SPEC = dict(n_frames=240, seed=5, style="corridor")


def kidnap_cfg() -> SystemConfig:
    """31b: the fr3-scale configuration (planes, objects on the renderer's
    boxes, loop closing, 1024 keypoint slots) with quarter-size keyframe
    tables at the endurance contract's 1 : 128 ratio and a keyframe at
    least every 6 frames, as the exploration contract has it."""
    base = SystemConfig()
    return base.replace(
        capacity=dataclasses.replace(base.capacity, max_keyframes=64,
                                     max_points=8192),
        tracking=dataclasses.replace(base.tracking,
                                     max_frames_between_kf=6))


def kidnap_order(n_pass: int, kidnap: int = KIDNAP_FRAMES,
                 back: int = BACK_EXPLORATION) -> List[int]:
    """The corridor frame of each frame of the workload: the pass (frames
    0 .. n_pass - 1), the kidnap (0 .. kidnap - 1), the return (back ..
    back + RETURN_FRAMES - 1)."""
    return (list(range(n_pass)) + list(range(kidnap))
            + list(range(back, back + RETURN_FRAMES)))


def kidnap_sequence(corridor, kidnap: int = KIDNAP_FRAMES,
                    back: int = BACK_EXPLORATION):
    """The kidnap workload over the rendered `corridor`, frames in
    `kidnap_order`, the timestamps rising 1/30 s a frame."""
    order = kidnap_order(len(corridor.frames), kidnap, back)
    return dataclasses.replace(corridor, frames=[
        dataclasses.replace(corridor.frames[i], timestamp=k / 30.0)
        for k, i in enumerate(order)])


def _centres(tcw) -> np.ndarray:
    from eao_fusion_tpu_torch.ops import lie
    return lie.se3_inverse(torch.as_tensor(
        np.asarray(tcw, np.float32)))[..., 4:].numpy()


def pass_alignment(s, seq, n_pass: int):
    """(R, t): the rigid alignment of the pass's raw trajectory onto its
    ground truth, as the pass's ATE takes it."""
    est = s.trajectory_tcw()[:n_pass]
    R, t, _ = tum.umeyama_alignment(_centres(est), _centres(_gt(seq)[:n_pass]))
    return R, t


def aligned_error(tcw, tcw_gt, align) -> tuple:
    """(metres, radians) between an estimated pose, carried into the
    ground truth's frame by the pass alignment `align`, and its truth."""
    from eao_fusion_tpu_torch.ops import lie
    R, t = align
    twc = lie.se3_inverse(torch.as_tensor(np.asarray(tcw, np.float32)))
    gwc = lie.se3_inverse(torch.as_tensor(np.asarray(tcw_gt, np.float32)))
    c = R @ twc[4:].numpy().astype(np.float64) + t
    Re = R @ lie.quat_to_rotmat(twc[:4]).numpy().astype(np.float64)
    Rg = lie.quat_to_rotmat(gwc[:4]).numpy().astype(np.float64)
    cos = np.clip((np.trace(Rg.T @ Re) - 1.0) / 2.0, -1.0, 1.0)
    return (float(np.linalg.norm(c - gwc[4:].numpy())),
            float(np.arccos(cos)))


def check_kidnap(s, seq, n_pass: int, kidnap: int = KIDNAP_FRAMES,
                 strict: bool = True) -> Dict:
    """The premise, after the pass and before the kidnap: an eviction has
    run; no live keyframe lies within 2 m of any kidnap frame's true camera
    centre; a live keyframe lies within 0.5 m of each return frame's; the
    return's first frame lies at least 1 m from the pose the tracker holds
    at the pass's end (its last OK pose, carried by the pass alignment):
    the return is a jump that the motion model cannot track. (The return
    then walks on towards the pass's end, so its later frames come near
    that pose.) A live keyframe's place is its frame's ground truth. If
    this fails, the workload is wrong, not the port. `fails` names the
    clauses that fail; `strict` raises if any does."""
    gt = _centres(_gt(seq))
    m = s.map
    kv = m.kf_valid.cpu().numpy()
    kf_c = gt[m.kf_frame_id.cpu().numpy()[kv]]
    kid = gt[n_pass:n_pass + kidnap]
    ret = gt[n_pass + kidnap:]

    def nearest(a, b):
        return np.linalg.norm(a[:, None] - b[None], axis=-1).min(axis=1)

    R, t = pass_alignment(s, seq, n_pass)
    frozen = R @ _centres(s.track.pose.cpu()).astype(np.float64) + t
    evictions = sum(e["event"] == "kf_eviction" for e in s.events)
    out = {"kf_evictions": evictions, "n_kf_evicted": s.n_kf_evictions,
           "live_kfs": int(kv.sum()),
           "live_kf_frames": [int(f) for f in
                              sorted(m.kf_frame_id.cpu().numpy()[kv])],
           "kidnap_nearest_kf_m": float(nearest(kid, kf_c).min()),
           "return_nearest_kf_max_m": float(nearest(ret, kf_c).max()),
           "return_jump_m": float(np.linalg.norm(ret[0] - frozen))}
    out["fails"] = [name for name, ok in (
        ("an eviction", evictions >= 1),
        ("the kidnap 2 m from every live keyframe",
         out["kidnap_nearest_kf_m"] > 2.0),
        ("a live keyframe within 0.5 m of each return frame",
         out["return_nearest_kf_max_m"] < 0.5),
        ("the return's first frame 1 m from the held pose",
         out["return_jump_m"] >= 1.0)) if not ok]
    if strict and out["fails"]:
        raise AssertionError(out)
    return out


def map_snapshot(m) -> tuple:
    return tuple(getattr(m, f).clone() for f in LOST_FIELDS)


def map_unchanged(m, snap) -> bool:
    return all(torch.equal(getattr(m, f), x)
               for f, x in zip(LOST_FIELDS, snap))


def run_kidnap_frames(s, seq, lo: int, boxes: bool = False,
                      sync=lambda: None) -> List[Dict]:
    """Drive System `s` over `seq.frames[lo:]` through `process_frame` and
    record each frame: the tracker lost it (fewer inliers than the
    tracking gate), BoW relocalization recovered it, the status and pose
    it reports, its inliers, its ms and the ms of `relocalize` in it
    (`sync` waits for the device), the keyframes inserted, and for a lost
    frame left lost whether `LOST_FIELDS` kept their bits."""
    gate = s.cfg.tracking.min_matches_track
    reloc_ms = []
    relocalize = s._relocalize

    def timed(feats):
        t = time.perf_counter()
        ok = relocalize(feats)
        sync()
        reloc_ms.append((time.perf_counter() - t) * 1e3)
        return ok

    s._relocalize = timed
    recs = []
    try:
        for i in range(lo, len(seq.frames)):
            f = seq.frames[i]
            snap, n_kf = map_snapshot(s.map), s.n_keyframes
            n_rel, n_ms = s.n_relocalizations, len(reloc_ms)
            t = time.perf_counter()
            pose = s.process_frame(f.gray, f.depth, f.timestamp,
                                   boxes=f.boxes if boxes else None)
            sync()
            ms = (time.perf_counter() - t) * 1e3
            n_in = s.diags[-1]["n_inliers"]
            rel = s.n_relocalizations > n_rel
            lost = n_in < gate
            recs.append(dict(
                frame=i, lost=lost, relocalized=rel,
                ok=int(s.track.status) == 1, pose=np.asarray(pose),
                n_inliers=n_in, ms=ms,
                reloc_ms=reloc_ms[-1] if len(reloc_ms) > n_ms else None,
                inserted=s.n_keyframes - n_kf,
                unchanged=(map_unchanged(s.map, snap) if lost and not rel
                           else None)))
    finally:
        del s._relocalize            # the bound method again
    return recs


def chunk_tensors(cfg, frames, boxes: bool, device):
    """A chunk's (grays, depths, box tables, timestamps) on `device`; each
    box table padded to max_objects_2d rows of zeros (score 0)."""
    bx = np.zeros((len(frames), cfg.objects.max_objects_2d, 6), np.float32)
    for i, f in enumerate(frames):
        if boxes and len(f.boxes):
            b = np.asarray(f.boxes, np.float32)[:bx.shape[1]]
            bx[i, :len(b)] = b
    return (torch.as_tensor(np.stack([f.gray for f in frames]),
                            device=device),
            torch.as_tensor(np.stack([f.depth for f in frames]),
                            device=device),
            torch.as_tensor(bx, device=device),
            [float(f.timestamp) for f in frames])


# the System counters that a chunk boundary can move
BOUNDARY_COUNTERS = {"loop": "n_loops_closed", "gba_merge": "n_gba_merges",
                     "kf_compaction": "n_kf_compactions",
                     "pt_compaction": "n_pt_compactions",
                     "relocalization": "n_relocalizations"}


def run_kidnap_chunks(s, seq, lo: int, chunk: int = CHUNK,
                      boxes: bool = False, sync=lambda: None,
                      on_chunk=None) -> List[Dict]:
    """Drive System `s` (warmed up with `process_frame` over frames
    0 .. lo - 1) over `seq.frames[lo:]` in the steady chunked mode:
    `slam_chunk`, `record_chunk`, `chunk_epilogue`. Records each chunk:
    its frames, which the tracker lost, their inliers and insertions, the
    pose of each frame, the status at the chunk's end and after its
    epilogue, the events of the boundary, whether the boundary relocalized
    and to what pose, the chunk's and the epilogue's ms, and whether
    `LOST_FIELDS` kept their bits through a chunk the tracker lost whole
    and through its epilogue. `on_chunk(index, carry)` runs after each
    epilogue."""
    from eao_fusion_tpu_torch.pipeline import steady
    cfg = s.cfg
    gate = cfg.tracking.min_matches_track
    st = steady.init_steady_state(s)
    kf_before = int(st.m.next_kf)
    recs = []
    for ci, c0 in enumerate(range(lo, len(seq.frames), chunk)):
        frames = seq.frames[c0:c0 + chunk]
        g, d, b, ts = chunk_tensors(cfg, frames, boxes, s.device)
        snap = map_snapshot(st.m)
        t = time.perf_counter()
        st, diag = steady.slam_chunk(st, g, d, b, ts, cfg=cfg)
        sync()
        ms = (time.perf_counter() - t) * 1e3
        s.record_chunk(st, diag, ts)
        n_in = diag["n_inliers"].cpu().numpy()
        lost = n_in < gate
        status_end = int(st.ts.status)
        before = {k: getattr(s, v) for k, v in BOUNDARY_COUNTERS.items()}
        snap_ep = map_snapshot(st.m)
        t = time.perf_counter()
        st = s.chunk_epilogue(st, kf_before)
        sync()
        ep_ms = (time.perf_counter() - t) * 1e3
        kf_before = s.next_kf_hint
        events = [k for k, v in BOUNDARY_COUNTERS.items()
                  if getattr(s, v) > before[k]]
        rel = "relocalization" in events
        recs.append(dict(
            chunk=ci, frames=list(range(c0, c0 + len(frames))),
            lost=lost.tolist(), n_inliers=n_in.tolist(),
            inserted=diag["kf_inserted"].cpu().numpy().astype(int).tolist(),
            poses=diag["pose"].cpu().numpy(), status_end=status_end,
            status_after=int(st.ts.status), events=events,
            relocalized=rel,
            reloc_pose=st.ts.pose.cpu().numpy() if rel else None,
            ms=ms, epilogue_ms=ep_ms,
            unchanged=map_unchanged(st.m, snap) if lost.all() else None,
            unchanged_epilogue=map_unchanged(st.m, snap_ep)))
        if on_chunk is not None:
            on_chunk(ci, st)
    return recs


def _frames_of(recs, chunked: bool) -> List[Dict]:
    """Per-frame rows (frame, lost, ok, pose, n_inliers, inserted) of
    either recording."""
    if not chunked:
        return recs
    return [dict(frame=f, lost=lo, ok=not lo, pose=p, n_inliers=n,
                 inserted=k)
            for r in recs for f, lo, p, n, k in zip(
                r["frames"], r["lost"], r["poses"], r["n_inliers"],
                r["inserted"])]


def check_kidnap_run(s, seq, recs, n_pass: int, chunked: bool,
                     kidnap: int = KIDNAP_FRAMES, min_inliers_end: int = 0,
                     resets_before: int = 0, standing=()) -> Dict:
    """The kidnap contract over the kidnap and the return (`recs` of
    `run_kidnap_frames`, or of `run_kidnap_chunks` with `chunked`): (a) no
    reset; (b) no frame reports OK at a pose more than RELOC_M or
    RELOC_RAD from its truth, after the pass alignment; (c) every
    relocalization lands within the same bounds (a boundary's on the
    chunk's last frame); (d) no keyframe is inserted on a lost frame, and
    `LOST_FIELDS` keep their bits across every run of lost frames (each
    lost frame through `process_frame`; each chunk lost whole, and the
    epilogues between two such chunks but those that compacted, closed a
    loop or merged a GBA); (e1) a relocalization in the return, and (e2)
    the track back in the return (its first OK frame after a lost one, by
    BoW relocalization or by the tracker's own reference-keyframe search,
    which both packages run on a lost track first) with the last 24
    frames OK (with more than `min_inliers_end` inliers each); (f) the raw
    ATE of the return's OK frames under 5 cm. A bound named in `standing`
    (its label, "(b)", "(e1)") is one the JAX package was shown to miss
    from the same state: its failure goes to "standing" and raises
    nothing. Returns the values it read."""
    align = pass_alignment(s, seq, n_pass)
    gt = _gt(seq)
    start_ret = n_pass + kidnap
    if chunked:
        # the chunks from the one that ends the pass on
        recs = [r for r in recs if r["frames"][-1] >= n_pass - 1]
    rows = [r for r in _frames_of(recs, chunked) if r["frame"] >= n_pass]
    fails = []
    errs = {}
    for r in rows:
        if r["ok"]:
            errs[r["frame"]] = aligned_error(r["pose"], gt[r["frame"]], align)
    wrong = {f: e for f, e in errs.items()
             if not (e[0] < RELOC_M and e[1] < RELOC_RAD)}
    if chunked:
        relocs = {r["frames"][-1]: aligned_error(
            r["reloc_pose"], gt[r["frames"][-1]], align)
            for r in recs if r["relocalized"]}
    else:
        relocs = {r["frame"]: errs[r["frame"]] for r in recs
                  if r["relocalized"]}
    bad_relocs = {f: e for f, e in relocs.items()
                  if not (e[0] < RELOC_M and e[1] < RELOC_RAD)}
    inserted_lost = [r["frame"] for r in rows if r["lost"] and r["inserted"]]
    if chunked:
        changed = [r["chunk"] for r in recs
                   if r["unchanged"] is False and r["frames"][0] >= n_pass]
        changed += [f"epilogue {a['chunk']}" for a, b in zip(recs, recs[1:])
                    if a["unchanged"] and b["unchanged"] is not None
                    and not set(a["events"]) & {"kf_compaction",
                                                "pt_compaction", "loop",
                                                "gba_merge"}
                    and not a["unchanged_epilogue"]]
    else:
        changed = [r["frame"] for r in recs if r["unchanged"] is False]
    ret_relocs = sorted(f for f in relocs if f >= start_ret)
    tail = [r for r in rows if r["frame"] >= len(seq.frames) - 24]
    tail_ok = all(r["ok"] and r["n_inliers"] > min_inliers_end
                  for r in tail)
    ret_ok = [r for r in rows if r["frame"] >= start_ret and r["ok"]]
    ret_ate = (tum.evaluate_ate_rpe(
        np.stack([r["pose"] for r in ret_ok]),
        gt[[r["frame"] for r in ret_ok]]).ate_rmse * 100
        if len(ret_ok) >= 3 else float("nan"))
    lost = [r["frame"] for r in rows if r["lost"]]
    m = s.map
    kv = m.kf_valid.cpu().numpy()
    kf_err = np.array([aligned_error(p, gt[f], align)[0] * 100
                       for p, f in zip(m.kf_pose.cpu().numpy()[kv],
                                       m.kf_frame_id.cpu().numpy()[kv])])
    summary = kidnap_summary(recs, chunked, n_pass, kidnap)
    recovery = summary["recovery_frame"]
    out = {"resets": s.n_resets - resets_before,
           "lost_frames": len(lost),
           "lost_in_kidnap": sum(f < start_ret for f in lost),
           "lost_in_return": sum(f >= start_ret for f in lost),
           "ok_frames": len(errs),
           "max_ok_error_cm": max((e[0] for e in errs.values()),
                                  default=0.0) * 100,
           "max_ok_error_rad": max((e[1] for e in errs.values()),
                                   default=0.0),
           "wrong_ok_frames": {f: [e[0] * 100, e[1]]
                               for f, e in sorted(wrong.items())},
           "relocalizations": {f: [e[0] * 100, e[1]]
                               for f, e in sorted(relocs.items())},
           "first_return_reloc_frame": ret_relocs[0] if ret_relocs else None,
           "return_relocalizations": len(ret_relocs),
           "recovery": recovery, "recovered_by": summary["recovered_by"],
           "inserted_on_lost_frames": inserted_lost,
           "map_changed_while_lost": changed,
           "last_24_ok": tail_ok,
           "last_24_min_inliers": min(r["n_inliers"] for r in tail),
           "return_ate_cm": ret_ate, "return_ok_frames": len(ret_ok),
           "pass_ate_cm": tum.evaluate_ate_rpe(
               s.trajectory_tcw()[:n_pass], gt[:n_pass]).ate_rmse * 100,
           "live_kf_error_cm": {"median": float(np.median(kf_err)),
                                "max": float(kf_err.max())}}
    if chunked:
        out["boundary_events"] = {r["chunk"]: r["events"] for r in recs
                                  if r["events"]}
    if out["resets"]:
        fails.append("(a) a reset")
    if wrong:
        fails.append("(b) OK at a wrong pose")
    if bad_relocs:
        fails.append("(c) a wrong relocalization")
    if inserted_lost or changed:
        fails.append("(d) the map moved while lost")
    if not ret_relocs:
        fails.append("(e1) no relocalization in the return")
    if recovery is None or recovery < start_ret or not tail_ok:
        fails.append("(e2) the track did not come back")
    if not ret_ate < 5.0:
        fails.append("(f) the return's ATE")
    out["standing"] = [f for f in fails if f.split()[0] in standing]
    out["fails"] = [f for f in fails if f.split()[0] not in standing]
    out.update(summary)
    assert not out["fails"], out
    return out


def probe_relocalization(s, seq, frame: int, align, seed: int = 0) -> Dict:
    """BoW relocalization itself (`relocalization.relocalize`, the RANSAC
    draws from a generator of its own) of `seq.frames[frame]` against
    System `s`'s map, which it only reads: the pose it lands on, after the
    pass alignment `align`, against the frame's truth, with its ms and
    pose solves."""
    from eao_fusion_tpu_torch.frontend import extractor
    from eao_fusion_tpu_torch.pipeline import relocalization
    cfg, dev, f = s.cfg, s.device, seq.frames[frame]
    feats = extractor.extract_features(
        torch.as_tensor(f.gray, device=dev),
        torch.as_tensor(f.depth, device=dev), orb_cfg=cfg.orb,
        cam_cfg=cfg.camera)
    stats = {}
    t = time.perf_counter()
    pose, kp_pt = relocalization.relocalize(
        s.map, feats, s.loop_closer.bow, s.loop_closer.vocab,
        torch.Generator(device=dev).manual_seed(seed), cfg=cfg, stats=stats)
    ms = (time.perf_counter() - t) * 1e3
    out = {"frame": frame, "ms": ms,
           "pose_solves": stats.get("pose_solves", 0),
           "found": pose is not None}
    if pose is not None:
        dt, dr = aligned_error(pose.cpu(), _gt(seq)[frame], align)
        out.update(error_cm=dt * 100, error_rad=dr,
                   associated=int((kp_pt >= 0).sum()))
    return out


def kidnap_summary(recs, chunked: bool, n_pass: int,
                   kidnap: int = KIDNAP_FRAMES) -> Dict:
    """What the kidnap phase prints beside its contract: the ms of a lost
    frame through `process_frame` (tracking, plus `relocalize`), or of an
    epilogue after a chunk that ended lost (it tries a relocalization);
    the recovery point, the first OK frame of the return (after a lost
    frame, or the return's first frame), with its chunk, and what
    recovered it: BoW relocalization (in `process_frame`, or at the
    epilogue before its chunk) or the tracker itself."""
    start = n_pass + kidnap
    rows = _frames_of(recs, chunked)
    prev = {r["frame"]: q for q, r in zip(rows, rows[1:])}
    rec = next((r for r in rows if r["frame"] >= start and r["ok"]
                and (r["frame"] == start or prev[r["frame"]]["lost"])),
               None)
    out = {"recovery_frame": None if rec is None else rec["frame"]}
    if not chunked:
        lost = [r for r in recs if r["lost"]]
        tried = [r["reloc_ms"] for r in lost if r["reloc_ms"] is not None]
        out.update(
            lost_frame_ms_median=float(np.median([r["ms"] for r in lost]))
            if lost else None,
            lost_frame_ms_max=max((r["ms"] for r in lost), default=None),
            relocalize_ms_median=float(np.median(tried)) if tried else None,
            recovered_by=None if rec is None else (
                "relocalization" if rec["relocalized"] else "tracking"))
        return out
    tried = [r for r in recs if r["status_end"] != 1]
    chunk = next((r for r in recs if rec is not None
                  and rec["frame"] in r["frames"]), None)
    before = (None if chunk is None or chunk["chunk"] == recs[0]["chunk"]
              else recs[recs.index(chunk) - 1])
    by_reloc = (before is not None and before["relocalized"]
                and rec["frame"] == chunk["frames"][0])
    out.update(
        lost_chunks=[r["chunk"] for r in tried],
        relocalizing_epilogue_ms=[r["epilogue_ms"] for r in tried],
        recovery_chunk=None if chunk is None else chunk["chunk"],
        recovered_by=None if rec is None else (
            "relocalization" if by_reloc else "tracking"))
    return out
