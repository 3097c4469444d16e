#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (`eao_fusion_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. the device: name, count, `nvidia-smi` name and power limit;
  2. build every CUDA kernel of the main path from `eao_fusion_tpu_torch/csrc`;
  3. the pose kernel (K1) against its plain PyTorch version, M = 1024,
     with and without planes;
  4. the BA edge kernels (K2 full pass, K3 chi2 pass) against their plain
     versions at E = 8192, C = 32, Pw = 2048;
  5. the main path end to end at full width: RGBD tracking with
     keyframe-rate local BA (`tum_fr3_config` with planes, objects and
     loop closing off: 640x480, 1024 keypoint slots, 256 keyframes, 16384
     points) on the port's own 20-frame synthetic arc, with the launch
     counts set to 0 just before and read just after;
  6. one JSON line with every kernel's numbers, the `nvidia-smi` line, and
     as the last line {"ok": true, "device": {...}}.

All times are measured on the card in this run (CUDA events for kernels,
the host clock around synchronized work for frames). `bound_ms` is the
larger of the bytes the function must move over 3.35 TB/s and its
operations over 67 TFLOP/s (H100 SXM float32 without tensor cores).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_FLOP_PER_S = 67e12        # H100 SXM float32, outside the tensor cores

N_FRAMES = 20
SEED = 0

# flops of the pose kernel per observation: one GN iteration (projection,
# residual, Huber weight, 3x6 Jacobian, 21 H + 6 b sums) and one chi2 pass
POSE_FLOPS_PER_OBS_ITER = 320
POSE_FLOPS_PER_OBS_CHI2 = 40
# flops of the edge kernels per edge (camera rotation, projection, Huber,
# 3x9 Jacobian; the full pass adds the 63 Gram entries and 9 rhs sums)
EDGE_FLOPS_FULL = 600
EDGE_FLOPS_CHI2 = 90


def log(*a) -> None:
    print(*a, flush=True)


def _us(v) -> str:
    return "not measured" if v is None else f"{v:.2f} us"


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device time of fn() over `reps` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_us(fn, reps: int, kernel: str):
    """Mean device time (µs) of the CUDA kernel named `kernel` over `reps`
    calls of fn(), from the profiler's CUPTI trace; None if the trace
    shows no such kernel. Unlike `cuda_ms`, this leaves out the host time
    between launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    for evt in prof.key_averages():
        if kernel in evt.key and evt.count:
            total = getattr(evt, "device_time_total", None)
            if total is None:
                total = getattr(evt, "cuda_time_total", None)
            if total:
                return total / evt.count
    return None


def pose_problem(rng, dev, n=1024, noise=0.3, outlier_frac=0.2):
    """The problem of tests/test_pose_opt.py: points in front of a perturbed
    camera, 20% gross outliers, every 3rd edge mono, every 17th invalid,
    two planes measured under the true pose."""
    import torch
    from eao_fusion_tpu_torch.ops import lie
    from eao_fusion_tpu_torch.solvers import pose_opt

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    fx, fy, cx, cy, bf = CAM
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                    rng.uniform(2, 6, n)], axis=1).astype(np.float32)
    tau = np.concatenate([rng.uniform(-0.1, 0.1, 3),
                          rng.uniform(-0.3, 0.3, 3)]).astype(np.float32)
    pose_gt = lie.se3_exp(t(tau))
    xc = lie.se3_apply(pose_gt, t(pts)).cpu().numpy()
    uv = np.stack([fx * xc[:, 0] / xc[:, 2] + cx,
                   fy * xc[:, 1] / xc[:, 2] + cy], axis=1)
    ur = uv[:, 0] - bf / xc[:, 2] + rng.normal(0, noise, n)
    uv += rng.normal(0, noise, uv.shape)
    sel = rng.choice(n, int(outlier_frac * n), replace=False)
    uv[sel] += rng.uniform(20, 80, (len(sel), 2)) * rng.choice([-1, 1],
                                                               (len(sel), 2))
    ur[::3] = -1.0
    valid = np.ones(n, bool)
    valid[::17] = False
    obs = pose_opt.PoseObs(pts_w=t(pts), uv=t(uv), uright=t(ur),
                           inv_sigma2=t(np.ones(n)),
                           valid=torch.as_tensor(valid, device=dev))
    planes_w = np.array([[0, -1, 0, 1.2], [0, 0, -1, 4.5]], np.float32)
    R = lie.quat_to_rotmat(pose_gt[:4]).cpu().numpy()
    tr = pose_gt[4:7].cpu().numpy()
    n_c = planes_w[:, :3] @ R.T
    d_c = planes_w[:, 3] - n_c @ tr
    pobs = pose_opt.PlaneObs(
        plane_w=t(planes_w), meas_c=t(np.concatenate([n_c, d_c[:, None]], 1)),
        valid=torch.ones(2, dtype=torch.bool, device=dev))
    pose0 = lie.se3_retract(pose_gt, t([0.02, -0.01, 0.02, 0.06, -0.04, 0.05]))
    return pose0, obs, pobs


def pose_err(a, b) -> float:
    import torch
    from eao_fusion_tpu_torch.ops import lie
    d = lie.se3_compose(lie.se3_inverse(a.cpu()), b.cpu())
    return float(torch.linalg.norm(lie.se3_log(d)))


def phase_pose(dev, cfg):
    """K1 against optimize_pose_plain; returns the kernel's numbers."""
    from eao_fusion_tpu_torch.solvers import pose_opt
    rng = np.random.default_rng(7)
    pose0, obs, pobs = pose_problem(rng, dev)
    cam5 = CAM
    max_err = 0.0
    for planes in (None, pobs):
        ref = pose_opt.optimize_pose_plain(pose0, obs, planes, cam=cam5,
                                           cfg=cfg)
        ker = pose_opt.optimize_pose_cuda(pose0, obs, planes, cam=cam5,
                                          cfg=cfg)
        err = pose_err(ref.pose, ker.pose)
        agree = float((ref.inliers == ker.inliers).float().mean())
        dn = abs(int(ref.n_inliers) - int(ker.n_inliers))
        tag = "planes" if planes is not None else "no planes"
        log(f"K1 pose_opt ({tag}): pose err {err:.3g} (< 1e-3), inlier "
            f"agreement {agree:.4f} (> 0.995), n_inliers {int(ref.n_inliers)}"
            f" vs {int(ker.n_inliers)} (within 5)")
        if not (err < 1e-3 and agree > 0.995 and dn <= 5):
            raise AssertionError(f"K1 disagrees with its plain version "
                                 f"({tag})")
        max_err = max(max_err, float((ref.pose - ker.pose).abs().max()))
    # timing at the main path's shape: M = 1024, no planes
    stats = {}
    pose_opt.optimize_pose_plain(pose0, obs, None, cam=cam5, cfg=cfg,
                                 stats=stats)
    ms = cuda_ms(lambda: pose_opt.optimize_pose_cuda(pose0, obs, None,
                                                     cam=cam5, cfg=cfg), 50)
    plain_ms = cuda_ms(lambda: pose_opt.optimize_pose_plain(
        pose0, obs, None, cam=cam5, cfg=cfg), 5, warmup=1)
    dev_us = device_us(lambda: pose_opt.optimize_pose_cuda(
        pose0, obs, None, cam=cam5, cfg=cfg), 20, "pose_opt_kernel")
    M = obs.valid.shape[0]
    nbytes = 7 * 4 + 8 * M * 4 + (8 + M + 2) * 4
    flops = M * (POSE_FLOPS_PER_OBS_ITER * stats["gn_iters"]
                 + POSE_FLOPS_PER_OBS_CHI2 * (cfg.pose_rounds + 1))
    b_ms, b_by = bound(nbytes, flops)
    log(f"K1 timing: kernel {ms:.4f} ms per call, device time "
        f"{_us(dev_us)}, plain {plain_ms:.3f} ms, bound {b_ms:.6f} ms "
        f"({b_by}; {stats['gn_iters']} GN iterations)")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by)


def edge_problem(rng, dev, C=32, Pw=2048, E=8192):
    """A local-BA window: C cameras on an arc, Pw points in front, E edges
    (the last 5% empty padding), a third mono, 8 fixed cameras."""
    import torch
    from eao_fusion_tpu_torch.ops import lie
    from eao_fusion_tpu_torch.solvers import ba_edge

    def t(a, dt=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

    s = np.linspace(0, 1, C)
    tau = np.stack([0.02 * s, -0.25 * s, 0 * s, 0.4 * s, 0.02 * s, 0.1 * s], 1)
    cams = lie.se3_exp(t(tau.astype(np.float32)))
    pts = np.stack([rng.uniform(-2, 2, Pw), rng.uniform(-1.5, 1.5, Pw),
                    rng.uniform(3, 7, Pw)], 1).astype(np.float32)
    obs_cam = rng.integers(0, C, E).astype(np.int32)
    obs_pt = rng.integers(0, Pw, E).astype(np.int32)
    n_pad = E // 20
    obs_pt[-n_pad:] = -1
    xc = lie.se3_apply(cams[t(obs_cam, torch.long)],
                       t(pts)[t(np.clip(obs_pt, 0, None), torch.long)])
    xc = xc.cpu().numpy()
    fx, fy, cx, cy, bf = CAM
    uv = np.stack([fx * xc[:, 0] / xc[:, 2] + cx,
                   fy * xc[:, 1] / xc[:, 2] + cy], 1) + rng.normal(0, 1.0,
                                                                  (E, 2))
    ur = uv[:, 0] - bf / xc[:, 2] + rng.normal(0, 1.0, E)
    ur[::3] = -1.0
    uv[::50] += 40.0                                 # a few gross outliers
    lvl = rng.integers(0, 8, E)
    free = np.ones(C, np.float32)
    free[-8:] = 0.0
    x = ba_edge.EdgeInputs(
        cam_pose=cams.contiguous(), pt_xyz=t(pts), obs_cam=t(obs_cam,
                                                             torch.int32),
        obs_pt=t(np.clip(obs_pt, 0, None), torch.int32),
        obs_uv=t(uv.astype(np.float32)), obs_ur=t(ur.astype(np.float32)),
        obs_inv_sigma2=t((1.2 ** (-2.0 * lvl)).astype(np.float32)),
        free_cam=t(free))
    active = t((obs_pt >= 0).astype(np.float32))
    return x, active


def phase_edges(dev, cfg):
    """K2 and K3 against their plain versions; returns their numbers."""
    from eao_fusion_tpu_torch.solvers import ba_edge
    rng = np.random.default_rng(11)
    x, active = edge_problem(rng, dev)
    kw = dict(cam=CAM, chi2_mono=cfg.chi2_mono, chi2_stereo=cfg.chi2_stereo)
    C, Pw, E = x.cam_pose.shape[0], x.pt_xyz.shape[0], x.obs_cam.shape[0]

    ref = ba_edge.edge_pass_full_plain(x, active, **kw)
    ker = ba_edge.edge_pass_full(x, active, **kw)
    full_err = 0.0
    for name, a, b in zip(("pay_c", "pay_p", "Y"), ref, ker):
        scale = a.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
        rel = float(((a - b).abs() / scale).max())
        full_err = max(full_err, float((a - b).abs().max()))
        log(f"K2 ba_edge_full {name}: max err / channel max {rel:.3g} "
            f"(< 1e-4)")
        if not rel < 1e-4:
            raise AssertionError(f"K2 disagrees with its plain version "
                                 f"({name})")
    # chi2 tolerance: a residual is the difference of two pixel coordinates
    # of size ~600, which float32 resolves to ~6e-5 px; the kernel's fused
    # multiply-adds move it by that much, so chi2 = r²/σ² moves by about
    # 2|r|·6e-5 — relative 1e-3 of max(chi2, 1) covers it
    ref3 = ba_edge.edge_pass_chi2_plain(x, active, **kw)
    ker3 = ba_edge.edge_pass_chi2(x, active, **kw)
    chi2_err = 0.0
    for name, a, b in zip(("robust", "raw"), ref3[:2], ker3[:2]):
        rel = float(((a - b).abs() / a.abs().clamp(min=1.0)).max())
        chi2_err = max(chi2_err, float((a - b).abs().max()))
        log(f"K3 ba_edge_chi2 {name} chi2: max err / max(chi2, 1) {rel:.3g} "
            f"(< 1e-3)")
        if not rel < 1e-3:
            raise AssertionError(f"K3 disagrees with its plain version "
                                 f"({name})")
    if not bool((ref3[2] == ker3[2]).all()):
        raise AssertionError("K3 behind flags differ from the plain version")
    log("K3 ba_edge_chi2 behind flags: identical")

    ms2 = cuda_ms(lambda: ba_edge.edge_pass_full(x, active, **kw), 200)
    plain2 = cuda_ms(lambda: ba_edge.edge_pass_full_plain(x, active, **kw),
                     20)
    ms3 = cuda_ms(lambda: ba_edge.edge_pass_chi2(x, active, **kw), 200)
    plain3 = cuda_ms(lambda: ba_edge.edge_pass_chi2_plain(x, active, **kw),
                     20)
    dev2 = device_us(lambda: ba_edge.edge_pass_full(x, active, **kw), 50,
                     "ba_edge_kernel")
    dev3 = device_us(lambda: ba_edge.edge_pass_chi2(x, active, **kw), 50,
                     "ba_edge_kernel")
    shared = C * 7 * 4 + Pw * 3 * 4 + C * 4
    per_edge_in = 4 + 4 + 8 + 4 + 4 + 4
    b2 = bound(shared + E * (per_edge_in + 72 * 4), E * EDGE_FLOPS_FULL)
    b3 = bound(shared + E * (per_edge_in + 3 * 4), E * EDGE_FLOPS_CHI2)
    log(f"K2 timing: kernel {ms2:.4f} ms per call, device time "
        f"{_us(dev2)}, plain {plain2:.3f} ms, bound {b2[0]:.6f} ms ({b2[1]})")
    log(f"K3 timing: kernel {ms3:.4f} ms per call, device time "
        f"{_us(dev3)}, plain {plain3:.3f} ms, bound {b3[0]:.6f} ms ({b3[1]})")
    return (dict(max_abs_err=full_err, ms=ms2, plain_ms=plain2,
                 bound_ms=b2[0], bound_by=b2[1]),
            dict(max_abs_err=chi2_err, ms=ms3, plain_ms=plain3,
                 bound_ms=b3[0], bound_by=b3[1]))


def phase_main_path(dev):
    """The port's System on the card at full width; returns its summary
    and the launch counts of the run."""
    import torch
    from eao_fusion_tpu_torch import kernels
    from eao_fusion_tpu_torch.config import tum_fr3_config
    from eao_fusion_tpu_torch.io import synthetic, tum
    from eao_fusion_tpu_torch.pipeline.system import System

    cfg = tum_fr3_config(use_planes=False, use_objects=False,
                         use_loop_closing=False)
    t0 = time.perf_counter()
    seq = synthetic.generate_sequence(n_frames=N_FRAMES, seed=SEED,
                                      style="arc", camera=cfg.camera)
    log(f"rendered {N_FRAMES} frames of the seed-{SEED} arc in "
        f"{time.perf_counter() - t0:.1f} s (host)")

    s = System(cfg)
    if s.device.type != "cuda":
        raise AssertionError(f"System runs on {s.device}, not on the card")
    kf_ms = []
    on_keyframe = s._on_keyframe

    def timed_on_keyframe(slot):
        t = time.perf_counter()
        on_keyframe(slot)
        torch.cuda.synchronize()
        kf_ms.append((time.perf_counter() - t) * 1e3)

    s._on_keyframe = timed_on_keyframe
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    kernels.reset_launches()
    frame_ms, is_kf = [], []
    for f in seq.frames:
        n_kf = s.n_keyframes
        t = time.perf_counter()
        s.process_frame(f.gray, f.depth, f.timestamp)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t) * 1e3)
        is_kf.append(s.n_keyframes > n_kf)
    counts = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated()

    err = tum.evaluate_ate_rpe(s.trajectory_tcw(), seq.gt_tcw())
    tracked = len(s.diags)
    n_ba = len(kf_ms) - 2 if len(kf_ms) >= 2 else 0   # from the 3rd KF on
    track_ms = [m for m, k in zip(frame_ms[1:], is_kf[1:]) if not k]
    kf_frame_ms = [m for m, k in zip(frame_ms[1:], is_kf[1:]) if k]
    summary = {
        "frames": N_FRAMES, "tracked_frames": tracked,
        "keyframes": s.n_keyframes, "local_ba_runs": n_ba,
        "resets": s.n_resets, "ate_cm": err.ate_rmse * 100.0,
        "median_frame_ms": float(np.median(frame_ms[1:])),
        "median_tracking_frame_ms": float(np.median(track_ms))
        if track_ms else None,
        "median_keyframe_frame_ms": float(np.median(kf_frame_ms))
        if kf_frame_ms else None,
        "mean_local_mapping_ms": float(np.mean(kf_ms[2:]))
        if len(kf_ms) > 2 else None,
        "first_tracked_frame_ms": frame_ms[1],
        "fps_after_first": (N_FRAMES - 2) / (sum(frame_ms[2:]) / 1e3),
        "max_memory_allocated_mb": peak / 2 ** 20,
        "launches": counts,
    }
    log("main path: " + json.dumps(summary))
    log("per-frame ms: " + json.dumps([round(m, 2) for m in frame_ms]))
    if not err.ate_rmse < 0.02:
        raise AssertionError(f"ATE {err.ate_rmse * 100:.2f} cm >= 2 cm")
    if s.n_keyframes < 3 or n_ba < 1:
        raise AssertionError("local BA did not run")
    if s.n_resets:
        raise AssertionError("tracking was lost and reset")
    if counts["pose_opt"] != 2 * tracked:
        raise AssertionError(f"pose kernel launched {counts['pose_opt']} "
                             f"times for {tracked} tracked frames")
    if counts["ba_edge_full"] < 1 or counts["ba_edge_chi2"] < 1:
        raise AssertionError(f"BA edge kernels not launched: {counts}")
    return summary, counts


CAM = (535.4, 539.2, 320.1, 247.6, 40.0)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    try:
        from eao_fusion_tpu_torch import kernels
        from eao_fusion_tpu_torch.config import SolverConfig
    except ImportError as e:
        print(f"chip_smoke: the port package is missing ({e})",
              file=sys.stderr)
        return 2
    try:
        dev = torch.device("cuda")
        name = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
        smi_line = smi[0] if smi else "nvidia-smi: no output"
        log(f"device: {name} x{count}; torch {torch.__version__}, CUDA "
            f"{torch.version.cuda}; {smi_line}")

        t0 = time.perf_counter()
        built = kernels.build_all()
        log(f"kernels built in {time.perf_counter() - t0:.1f} s: "
            + json.dumps({k: round(v, 1) for k, v in built.items()}))
        for lib in kernels.SOURCES:
            path = kernels.lib_path(lib)
            logf = kernels.BUILD_DIR / f"{path.stem}.log"
            if logf.exists():
                for line in logf.read_text().splitlines():
                    if "registers" in line or "spill" in line:
                        log(f"  {lib}: {line.strip()}")

        cfg = SolverConfig()
        k1 = phase_pose(dev, cfg)
        k2, k3 = phase_edges(dev, cfg)
        summary, counts = phase_main_path(dev)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1

    rows = [
        dict(name="pose_opt", route="cuda",
             source="eao_fusion_tpu_torch/csrc/pose_opt.cu",
             replaces="eao_fusion_tpu/solvers/pose_opt_pallas.py:376",
             launches=counts["pose_opt"], **k1),
        dict(name="ba_edge_full", route="cuda",
             source="eao_fusion_tpu_torch/csrc/ba_edge.cu",
             replaces="eao_fusion_tpu/solvers/ba_edge_pallas.py:171",
             launches=counts["ba_edge_full"], **k2),
        dict(name="ba_edge_chi2", route="cuda",
             source="eao_fusion_tpu_torch/csrc/ba_edge.cu",
             replaces="eao_fusion_tpu/solvers/ba_edge_pallas.py:195",
             launches=counts["ba_edge_chi2"], **k3),
    ]
    for r in rows:
        r["library_ms"] = None   # no single PyTorch call computes these
    print(json.dumps({"kernels": rows}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
