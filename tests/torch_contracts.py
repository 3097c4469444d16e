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

import os
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
    import dataclasses
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
