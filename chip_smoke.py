#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (`eao_fusion_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. the device: name, count, `nvidia-smi` name and power limit;
  2. build every CUDA kernel of the main path from `eao_fusion_tpu_torch/csrc`
     (one `nvcc` per source, all started together);
  3. the pose kernel (K1) against its plain PyTorch version, M = 1024,
     with no planes, two planes, and the eight plane slots (three
     unmatched) that the main path's second solve of a frame gets; timed
     at Q = 0 and Q = 8, and held to one device kernel per call;
  4. the BA edge kernels against their plain versions at E = 8192, C = 32,
     Pw = 2048, with the edges in random and in camera order, through the
     binding local BA makes once per call: K2 (the full pass with its
     [C, 42] / [Pw, 12] segment sums, and Y), K3's chi2 sum (also the
     same bits over 10 calls) and K3's per-edge chi2; each held to one
     device kernel per call (K2 and its memset);
  5. the Cholesky kernel (K4) against its plain version and a float64
     solve at D = 192: local BA's reduced camera system of one LM
     iteration on phase 4's window, and a random SPD matrix; at D = 72 (the
     compaction phase's window); at the ragged and edge sizes D = 1, 5,
     31, 33, 190 and 256; and on an indefinite matrix, whose clamped pivot
     gives a huge finite step; its time at D = 192 and 72 beside
     `torch.linalg.solve`, the call it replaces;
  6. RGBD tracking with keyframe-rate local BA at full width
     (`tum_fr3_config` with planes, objects and loop closing off: 640x480,
     1024 keypoint slots, 256 keyframes, 16384 points) on the port's own
     20-frame synthetic arc;
  7. the slice's main path, the default RGBD configuration with planes on
     (objects and loop closing off), on the same arc: plane segmentation
     every frame, plane factors in K1 and in local BA, K4 solving local
     BA's reduced camera system;
  8. keyframe compaction: the 24-frame arc into a 12-slot keyframe table;
  9. objects, the new main path: the JAX package's default RGBD
     configuration with planes and objects on (`tum_fr3_config(
     use_loop_closing=False)`) on the 20-frame arc, the renderer's boxes
     passed as offline boxes; the object lane's ms per stage;
 10. the detector: the port's YOLOX lane with the shipped
     `data/yolox_synth.npz` on six frames of the class-textured 24-frame
     arc, on the card against the same module on the CPU, its recall, and
     the forward and decode + NMS ms beside the forward's bound;
 11. online: the objects configuration with `semantic_online=True` on the
     first 20 frames of the class-textured arc and no boxes;
 12. one JSON line with every kernel's numbers (launches from phase 7),
     the `nvidia-smi` line, and as the last line {"ok": true, "device":
     {...}}.
Phases 6-9 and 11 each set the launch counts to 0 just before they drive
the System and read them just after. No phase falls back to the CPU or to
random weights.

All times are measured on the card in this run (CUDA events for kernels,
the host clock around synchronized work for frames). `bound_ms` is the
larger of the bytes the function must move over 3.35 TB/s and its
operations over 67 TFLOP/s (H100 SXM float32 without tensor cores).
"""

from __future__ import annotations

import contextlib
import functools
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
# and per plane slot: rotate the normal, 4 residuals, a 4x6 Jacobian, 21 H
# + 6 b sums; its chi2
POSE_FLOPS_PER_PLANE_ITER = 200
POSE_FLOPS_PER_PLANE_CHI2 = 30
# flops of the edge kernels per edge (camera rotation, projection, Huber,
# 3x9 Jacobian; the full pass adds the 63 Gram entries and 9 rhs sums, and
# its segment sums one add for each of the 54 summed channels)
EDGE_FLOPS_FULL = 600
EDGE_FLOPS_SUMS = 54
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


def device_events(fn, reps: int):
    """(name, device µs) of every device event (kernels and memsets) that
    `reps` calls of fn() ran, from the profiler's CUPTI trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [(e.name, e.device_time_total) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def device_kernels(fn, reps: int):
    """Names of the device events that `reps` calls of fn() ran."""
    return [n for n, _ in device_events(fn, reps)]


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


# five planes of the scene (floor, back wall, side walls, ceiling) and the
# eight plane slots of the second solve of track_frame (Q =
# max_planes_per_frame): -1 marks an unmatched slot (valid False), whose
# landmark is slot 0's, as build_plane_obs clamps the index
PLANES_W = np.array([[0, -1, 0, 1.2], [0, 0, -1, 4.5], [1, 0, 0, 2.5],
                     [-1, 0, 0, 2.5], [0, 1, 0, 1.5]], np.float32)
SLOTS8 = [0, 1, -1, 2, -1, 3, 4, -1]


def pose_problem(rng, dev, n=1024, noise=0.3, outlier_frac=0.2):
    """The problem of tests/test_pose_opt.py: points in front of a perturbed
    camera, 20% gross outliers, every 3rd edge mono, every 17th invalid;
    plane factors measured under the true pose, as {name: PlaneObs}: the
    two planes of that test, and eight slots as the main path's second
    solve gets them, three of them unmatched. The unmatched slots hold
    wrong measurements inside the plane chi2 gate, so that a solve that
    used them would move."""
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
    R = lie.quat_to_rotmat(pose_gt[:4]).cpu().numpy()
    tr = pose_gt[4:7].cpu().numpy()
    n_c = PLANES_W[:, :3] @ R.T
    d_c = PLANES_W[:, 3] - n_c @ tr
    meas = np.concatenate([n_c, d_c[:, None]], 1).astype(np.float32)
    # unmatched slots: the back wall 15 cm off, the floor 15 cm off, a side
    # wall's normal tilted by 0.25 rad
    tilt = np.r_[meas[2, :3] + [0, 0.25, 0], meas[2, 3]]
    wrong = np.stack([meas[1] + [0, 0, 0, 0.15], meas[0] + [0, 0, 0, 0.15],
                      tilt / np.r_[np.linalg.norm(tilt[:3]).repeat(3), 1]])
    pobs = {}
    for name, slots in (("2 planes", [0, 1]),
                        ("8 slots, 3 unmatched", SLOTS8)):
        idx = np.maximum(slots, 0)
        bad = np.asarray(slots) < 0
        meas_c = meas[idx]
        meas_c[bad] = wrong[:int(bad.sum())]
        pobs[name] = pose_opt.PlaneObs(
            plane_w=t(PLANES_W[idx]), meas_c=t(meas_c),
            valid=torch.as_tensor(~bad, device=dev))
    pose0 = lie.se3_retract(pose_gt, t([0.02, -0.01, 0.02, 0.06, -0.04, 0.05]))
    return pose0, obs, pobs


def pose_err(a, b) -> float:
    import torch
    from eao_fusion_tpu_torch.ops import lie
    d = lie.se3_compose(lie.se3_inverse(a.cpu()), b.cpu())
    return float(torch.linalg.norm(lie.se3_log(d)))


def phase_pose(dev, cfg):
    """K1 against optimize_pose_plain with no planes, two planes and the
    main path's eight plane slots; timed at both shapes the main path
    launches it with (Q = 0 for the first solve of a frame, Q = 8 for the
    second). Returns the kernel's numbers: per shape, and as the mean over
    the main path's launches, half of them at each shape."""
    from eao_fusion_tpu_torch.solvers import pose_opt
    rng = np.random.default_rng(7)
    pose0, obs, pobs = pose_problem(rng, dev)
    cam5 = CAM
    max_err = 0.0
    for tag, planes in (("no planes", None), *pobs.items()):
        ref = pose_opt.optimize_pose_plain(pose0, obs, planes, cam=cam5,
                                           cfg=cfg)
        ker = pose_opt.optimize_pose_cuda(pose0, obs, planes, cam=cam5,
                                          cfg=cfg)
        err = pose_err(ref.pose, ker.pose)
        agree = float((ref.inliers == ker.inliers).float().mean())
        dn = abs(int(ref.n_inliers) - int(ker.n_inliers))
        log(f"K1 pose_opt ({tag}): pose err {err:.3g} (< 1e-3), inlier "
            f"agreement {agree:.4f} (> 0.995), n_inliers {int(ref.n_inliers)}"
            f" vs {int(ker.n_inliers)} (within 5)")
        if not (err < 1e-3 and agree > 0.995 and dn <= 5):
            raise AssertionError(f"K1 disagrees with its plain version "
                                 f"({tag})")
        if planes is not None and not bool(planes.valid.all()):
            # the unmatched slots must change nothing: the kernel with them
            # left out gives the same pose
            keep = planes.valid
            only = pose_opt.PlaneObs(*[x[keep] for x in planes])
            ker5 = pose_opt.optimize_pose_cuda(pose0, obs, only, cam=cam5,
                                               cfg=cfg)
            e5 = pose_err(ker5.pose, ker.pose)
            log(f"K1 pose_opt ({tag}): the unmatched slots left out, pose "
                f"err {e5:.3g} (< 1e-4)")
            if not e5 < 1e-4:
                raise AssertionError("K1 uses unmatched plane slots")
        max_err = max(max_err, float((ref.pose - ker.pose).abs().max()))
    M = obs.valid.shape[0]
    shapes = {}
    for Q, planes in ((0, None), (8, pobs["8 slots, 3 unmatched"])):
        stats = {}
        pose_opt.optimize_pose_plain(pose0, obs, planes, cam=cam5, cfg=cfg,
                                     stats=stats)
        ms = cuda_ms(lambda: pose_opt.optimize_pose_cuda(
            pose0, obs, planes, cam=cam5, cfg=cfg), 50)
        plain_ms = cuda_ms(lambda: pose_opt.optimize_pose_plain(
            pose0, obs, planes, cam=cam5, cfg=cfg), 5, warmup=1)
        dev_us = device_us(lambda: pose_opt.optimize_pose_cuda(
            pose0, obs, planes, cam=cam5, cfg=cfg), 20, "pose_opt_kernel")
        for attempt in range(1, 4):
            names = device_kernels(lambda: pose_opt.optimize_pose_cuda(
                pose0, obs, planes, cam=cam5, cfg=cfg), 10)
            log(f"K1 (Q = {Q}): {len(names)} device kernels in 10 calls "
                f"(1 per call): {sorted(set(names))}")
            if (len(names) > 10
                    or not all("pose_opt_kernel" in n for n in names)):
                raise AssertionError("K1 is not one device kernel per call")
            if len(names) == 10:
                break
            # the profiler's trace lost an event: trace again
        else:
            raise AssertionError("K1: three traces short of 10 kernels")
        # in: the pose; per observation pts_w, uv, uright, inv_sigma2 (7
        # floats) and valid (1 byte); per plane slot plane_w, meas_c (8
        # floats) and valid; out: the pose, the inlier bytes, n_inliers and
        # the chi2
        nbytes = 7 * 4 + M * 29 + Q * 33 + 7 * 4 + M + 8
        n_iter = stats["gn_iters"]
        flops = (M * (POSE_FLOPS_PER_OBS_ITER * n_iter
                      + POSE_FLOPS_PER_OBS_CHI2 * (cfg.pose_rounds + 1))
                 + Q * (POSE_FLOPS_PER_PLANE_ITER * n_iter
                        + POSE_FLOPS_PER_PLANE_CHI2 * (cfg.pose_rounds + 1)))
        b_ms, b_by = bound(nbytes, flops)
        log(f"K1 timing (M = {M}, Q = {Q}): kernel {ms:.4f} ms per call, "
            f"device time {_us(dev_us)}, plain {plain_ms:.3f} ms, bound "
            f"{b_ms:.6f} ms ({b_by}; {n_iter} GN iterations)")
        shapes[f"Q={Q}"] = dict(ms=ms, device_us=dev_us, plain_ms=plain_ms,
                                bound_ms=b_ms, bound_by=b_by)
    a, b = shapes.values()
    return dict(max_abs_err=max_err, ms=(a["ms"] + b["ms"]) / 2,
                plain_ms=(a["plain_ms"] + b["plain_ms"]) / 2,
                bound_ms=(a["bound_ms"] + b["bound_ms"]) / 2,
                bound_by=b["bound_by"], per_shape=shapes)


def edge_problem(rng, dev, C=32, Pw=2048, E=8192):
    """A local-BA window: C cameras on an arc, Pw points in front, E edges
    (the last 5% empty padding), a third mono, a quarter of the cameras
    fixed."""
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
    free[-(C // 4):] = 0.0
    x = ba_edge.EdgeInputs(
        cam_pose=cams.contiguous(), pt_xyz=t(pts), obs_cam=t(obs_cam,
                                                             torch.int32),
        obs_pt=t(np.clip(obs_pt, 0, None), torch.int32),
        obs_uv=t(uv.astype(np.float32)), obs_ur=t(ur.astype(np.float32)),
        obs_inv_sigma2=t((1.2 ** (-2.0 * lvl)).astype(np.float32)),
        free_cam=t(free))
    active = t((obs_pt >= 0).astype(np.float32))
    return x, active


def edge_orders(x, active):
    """The phase-4 window in two edge orders: random camera order, as
    `edge_problem` draws it, and camera order (a stable sort by camera),
    as local mapping hands the edges to local BA."""
    import torch
    perm = torch.argsort(x.obs_cam.long(), stable=True)
    by_cam = x._replace(**{k: getattr(x, k)[perm].contiguous() for k in (
        "obs_cam", "obs_pt", "obs_uv", "obs_ur", "obs_inv_sigma2")})
    return {"random": (x, active),
            "camera": (by_cam, active[perm].contiguous())}


def _stage_device(fn, kernel: str, reps: int = 20):
    """Device kernels per call of fn() other than memsets, memsets per
    call, and the device µs per call of the kernel named `kernel` and of
    all the call's device work, from the profiler's CUPTI trace."""
    for _ in range(3):
        ev = device_events(fn, reps)
        kern = [n for n, _ in ev if "memset" not in n.lower()]
        if not all(kernel in n for n in kern):
            raise AssertionError(f"{kernel}: other device kernels in its "
                                 f"call: {sorted(set(kern))}")
        if len(kern) >= reps:
            break
        # fewer kernels than calls: the profiler's trace lost an event
        log(f"{kernel}: {len(kern)} kernels traced in {reps} calls; again")
    return (len(kern) / reps, (len(ev) - len(kern)) / reps,
            sum(us for n, us in ev if kernel in n) / reps,
            sum(us for _, us in ev) / reps)


def phase_edges(dev, cfg):
    """K2 (the full pass with its segment sums) and K3 (the chi2 sum and
    the per-edge chi2) against their plain versions, on the window in
    random and in camera order, through the binding local BA uses
    (`ba_edge.EdgePass`); each held to one device kernel per call (K2 may
    add its memset). Returns their numbers: camera order, the main path's,
    at the top level, both orders under "per_order"."""
    import torch
    from eao_fusion_tpu_torch.solvers import ba_edge
    x0, active0 = edge_problem(np.random.default_rng(11), dev)
    kw = dict(cam=CAM, chi2_mono=cfg.chi2_mono, chi2_stereo=cfg.chi2_stereo)
    C, Pw, E = x0.cam_pose.shape[0], x0.pt_xyz.shape[0], x0.obs_cam.shape[0]
    orders2, orders3 = {}, {}
    for order, (x, active) in edge_orders(x0, active0).items():
        tgt = torch.where(active > 0, x.obs_pt, Pw).to(torch.int32)
        edges = ba_edge.EdgePass(x, tgt, **kw)
        args = (x.cam_pose, x.pt_xyz, active)

        # K2: the sums per channel over their rows, Y per channel over E
        ref = ba_edge.edge_sums_plain(x, active, tgt, **kw)
        ker = edges.full(*args)
        err2 = 0.0
        for name, a, b, dim in zip(("acc_c", "acc_p", "Y"), ref, ker,
                                   (0, 0, 1)):
            scale = a.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
            rel = float(((a - b).abs() / scale).max())
            err2 = max(err2, float((a - b).abs().max()))
            log(f"K2 ba_edge_full ({order} order) {name}: max err / channel"
                f" max {rel:.3g} (< 1e-4)")
            if not rel < 1e-4:
                raise AssertionError(f"K2 disagrees with its plain version "
                                     f"({name}, {order} order)")

        # K3's sum: within 1e-5 of Σ|terms| (a float32 sum of E terms in
        # another order), and the same bits on every call
        terms = ba_edge.edge_pass_chi2_plain(x, active, **kw)[0]
        sums = [edges.chi2_sum(*args).item() for _ in range(10)]
        d = abs(sums[0] - terms.sum().item())
        lim = 1e-5 * terms.abs().sum().item()
        log(f"K3 ba_edge_chi2 sum ({order} order): {sums[0]!r} against "
            f"{terms.sum().item()!r}, |diff| {d:.3g} (<= {lim:.3g}); "
            f"{len(set(sums))} distinct value(s) in 10 calls (1)")
        if not d <= lim:
            raise AssertionError(f"K3's sum disagrees ({order} order)")
        if len(set(sums)) != 1:
            raise AssertionError(f"K3's sum is not bit-identical over "
                                 f"repeats ({order} order)")

        # K3 per edge. Tolerance: a residual is the difference of two pixel
        # coordinates of size ~600, which float32 resolves to ~6e-5 px; the
        # kernel's fused multiply-adds move it by that much, so chi2 =
        # r²/σ² moves by about 2|r|·6e-5 — relative 1e-3 of max(chi2, 1)
        # covers it
        ref3 = ba_edge.edge_pass_chi2_plain(x, active, **kw)
        ker3 = edges.chi2_edges(*args)
        err3e = 0.0
        for name, a, b in zip(("robust", "raw"), ref3[:2], ker3[:2]):
            rel = float(((a - b).abs() / a.abs().clamp(min=1.0)).max())
            err3e = max(err3e, float((a - b).abs().max()))
            log(f"K3 ba_edge_chi2 per edge ({order} order) {name} chi2: max "
                f"err / max(chi2, 1) {rel:.3g} (< 1e-3)")
            if not rel < 1e-3:
                raise AssertionError(f"K3 disagrees with its plain version "
                                     f"({name}, {order} order)")
        if not bool((ref3[2] == ker3[2]).all()):
            raise AssertionError("K3 behind flags differ from the plain "
                                 "version")
        log(f"K3 ba_edge_chi2 per edge ({order} order) behind flags: "
            f"identical")

        n2, m2, us2, all2 = _stage_device(lambda: edges.full(*args),
                                          "ba_edge_full_kernel")
        n3, m3, us3, _ = _stage_device(lambda: edges.chi2_sum(*args),
                                       "ba_edge_chi2_kernel")
        n3e, _, us3e, _ = _stage_device(lambda: edges.chi2_edges(*args),
                                        "ba_edge_chi2_kernel")
        log(f"K2 ({order} order): {n2:g} device kernel(s) and {m2:g} "
            f"memset(s) per call (1 and <= 1); K3 sum: {n3:g} kernel(s), "
            f"{m3:g} memset(s) (1 and 0); K3 per edge: {n3e:g} kernel(s)")
        if n2 != 1 or m2 > 1 or n3 != 1 or m3 != 0 or n3e != 1:
            raise AssertionError("K2 or K3 is not one device kernel per call")

        ms2 = cuda_ms(lambda: edges.full(*args), 200)
        plain2 = cuda_ms(lambda: ba_edge.edge_sums_plain(x, active, tgt,
                                                          **kw), 20)
        ms3 = cuda_ms(lambda: edges.chi2_sum(*args), 200)
        plain3 = cuda_ms(lambda: ba_edge.chi2_sum_plain(x, active, **kw), 20)
        ms3e = cuda_ms(lambda: edges.chi2_edges(*args), 200)
        plain3e = cuda_ms(lambda: ba_edge.edge_pass_chi2_plain(x, active,
                                                                **kw), 20)
        # bytes: each input read once, each output written once; K3 needs
        # no free-camera flags and no point targets
        cams, pts = C * 7 * 4, Pw * 3 * 4
        edge_in = 4 + 4 + 8 + 4 + 4 + 4        # cam, pt, uv, ur, 1/σ², active
        b2 = bound(cams + pts + C * 4 + E * (edge_in + 4 + 18 * 4)
                   + (C * 42 + Pw * 12) * 4,
                   E * (EDGE_FLOPS_FULL + EDGE_FLOPS_SUMS))
        b3 = bound(cams + pts + E * edge_in + 4, E * (EDGE_FLOPS_CHI2 + 1))
        b3e = bound(cams + pts + E * (edge_in + 3 * 4), E * EDGE_FLOPS_CHI2)
        log(f"K2 timing ({order} order): {ms2:.4f} ms per call, device "
            f"{_us(us2)} kernel, {_us(all2)} with its memset, plain "
            f"{plain2:.3f} ms, bound {b2[0]:.6f} ms ({b2[1]})")
        log(f"K3 timing ({order} order): sum {ms3:.4f} ms per call, device "
            f"{_us(us3)}, plain {plain3:.3f} ms, bound {b3[0]:.6f} ms "
            f"({b3[1]}); per edge {ms3e:.4f} ms per call, device "
            f"{_us(us3e)}, plain {plain3e:.3f} ms, bound {b3e[0]:.6f} ms "
            f"({b3e[1]})")
        orders2[order] = dict(max_abs_err=err2, ms=ms2, device_us=us2,
                              device_us_with_memset=all2, plain_ms=plain2,
                              bound_ms=b2[0], bound_by=b2[1])
        orders3[order] = dict(max_abs_err=max(d, err3e), ms=ms3,
                              device_us=us3, plain_ms=plain3,
                              bound_ms=b3[0], bound_by=b3[1],
                              per_edge=dict(max_abs_err=err3e, ms=ms3e,
                                            device_us=us3e, plain_ms=plain3e,
                                            bound_ms=b3e[0],
                                            bound_by=b3e[1]))
    # the rows: camera order's numbers (K3's of its sum variant), and the
    # largest error of any order and variant
    k2 = dict(orders2["camera"], per_order=orders2)
    k3 = dict(orders3["camera"], per_order=orders3)
    for k in (k2, k3):
        k["max_abs_err"] = max(o["max_abs_err"] for o in k["per_order"].values())
    return k2, k3


def schur_system(dev, C=32):
    """The reduced camera system (M [6C, 6C], rhs [6C]) of the first LM
    iteration of local BA on phase 4's window (C = 32 cameras, 8 fixed;
    C = 12 is the window of the compaction phase), taken where
    `bundle_adjust_coo` hands it to the Cholesky solve."""
    import torch
    from eao_fusion_tpu_torch.config import SolverConfig
    from eao_fusion_tpu_torch.solvers import ba, chol
    x, active = edge_problem(np.random.default_rng(11), dev, C=C)
    C, Pw = x.cam_pose.shape[0], x.pt_xyz.shape[0]
    ok = active > 0
    prob = ba.BACooProblem(
        cam_pose=x.cam_pose, cam_valid=torch.ones(C, dtype=torch.bool,
                                                  device=dev),
        cam_fixed=x.free_cam == 0, pt_xyz=x.pt_xyz,
        pt_valid=torch.ones(Pw, dtype=torch.bool, device=dev),
        obs_cam=x.obs_cam, obs_pt=torch.where(ok, x.obs_pt, -1),
        obs_uv=x.obs_uv, obs_ur=x.obs_ur, obs_inv_sigma2=x.obs_inv_sigma2,
        obs_valid=ok)
    taken = []
    solve = chol.cholesky_solve

    def take(M, rhs):
        taken.append((M.clone(), rhs.clone()))
        return solve(M, rhs)

    chol.cholesky_solve = take
    try:
        ba.bundle_adjust_coo(prob, cam=CAM, cfg=SolverConfig(), n_iters1=1,
                             n_iters2=0)
    finally:
        chol.cholesky_solve = solve
    return taken[0]


def _rel(a, ref) -> float:
    import torch
    a = a.detach().cpu().to(torch.float64)
    ref = ref.detach().cpu().to(torch.float64)
    return float(torch.linalg.norm(a - ref) / torch.linalg.norm(ref))


def _chol_check(name, Mi, bi) -> float:
    """K4 on (Mi, bi) against its plain version and a float64 solve;
    returns the largest absolute difference from the plain version."""
    import torch
    from eao_fusion_tpu_torch.solvers import chol
    D = Mi.shape[0]
    xk = chol.cholesky_solve(Mi, bi)
    xp = chol.cholesky_solve_plain(Mi, bi)
    # K4 solves the SPD system of M's lower triangle; the Schur matrix is
    # symmetric only up to the rounding of its float32 products
    M64 = torch.tril(Mi.cpu().double())
    M64 = M64 + torch.tril(M64, -1).T
    b64 = bi.cpu().double()
    x64 = torch.linalg.solve(M64, b64)
    e_plain, e64, e64p = _rel(xk, xp), _rel(xk, x64), _rel(xp, x64)
    d = torch.sqrt(torch.diagonal(M64))
    cond = float(torch.linalg.cond(M64 / d[:, None] / d[None, :]))
    asym = float((Mi - Mi.T).abs().max() / Mi.abs().max())
    e_lu = _rel(xk, torch.linalg.solve(Mi.cpu().double(), b64))
    log(f"K4 chol_solve ({name}, D = {D}, cond {cond:.3g} after "
        f"diagonal scaling): relative error {e_plain:.3g} against the "
        f"plain version, {e64:.3g} against float64 (plain: {e64p:.3g}); "
        f"both < 1e-4. M's asymmetry {asym:.3g} of its largest entry "
        f"moves the solution by {e_lu:.3g} from the float64 LU of all "
        f"of M (the solve K4 replaces)")
    if not (e_plain < 1e-4 and e64 < 1e-4):
        raise AssertionError(f"K4 disagrees ({name}, D = {D})")
    return float((xk - xp).abs().max())


def spd_problem(D, seed, cond, dev):
    """SPD [D, D] float32 with eigenvalues log-spaced over `cond`, and a
    right-hand side (as tests/test_torch_chol.py makes them)."""
    import torch
    r = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(r.normal(size=(D, D)))
    A = (Q * np.logspace(0, np.log10(cond), D)) @ Q.T
    A = (0.5 * (A + A.T)).astype(np.float32)
    b = r.normal(size=D).astype(np.float32)
    return (torch.as_tensor(A, device=dev), torch.as_tensor(b, device=dev))


def _chol_indefinite(dev):
    """The indefinite case of tests/test_torch_chol.py: the last pivot of
    an SPD matrix negated. The clamp sqrt(max(dsq, 1e-20)) makes the step
    huge but finite; K4 must agree with its plain version within rtol
    1e-3 (the step is ~1e20·b, so float32 rounding of the last pivot's
    sum moves it relatively, not absolutely)."""
    import torch
    from eao_fusion_tpu_torch.solvers import chol
    A, b = spd_problem(24, seed=3, cond=10.0, dev=dev)
    A[-1, -1] = -A[-1, -1]
    xk = chol.cholesky_solve(A, b).cpu()
    xp = chol.cholesky_solve_plain(A, b).cpu()
    rel = float(((xk - xp).abs() / xp.abs().clamp(min=1e-30)).max())
    log(f"K4 chol_solve (indefinite, D = 24): finite "
        f"{bool(torch.isfinite(xk).all())}, max |x| {float(xk.abs().max()):.3g}"
        f" (> 1e6), relative difference from the plain version {rel:.3g} "
        f"(< 1e-3)")
    if not (bool(torch.isfinite(xk).all()) and float(xk.abs().max()) > 1e6
            and rel < 1e-3):
        raise AssertionError("K4 mishandles an indefinite pivot")


def phase_chol(dev):
    """K4 against its plain version and a float64 solve at the two sizes
    the System phases give it: D = 192 (local BA's 32-keyframe window) and
    D = 72 (the 12-keyframe window of the compaction phase); then at the
    sizes that leave the kernel's last 32-wide panel ragged or that reach
    the TPU kernel's limit of 256, and on an indefinite matrix. Returns
    its numbers at D = 192, the size of the main path, with D = 72 beside
    them."""
    import torch
    from eao_fusion_tpu_torch.solvers import chol
    M, rhs = schur_system(dev)
    D = M.shape[0]
    A, b = spd_problem(D, seed=5, cond=1e3, dev=dev)
    M72, rhs72 = schur_system(dev, C=12)
    max_err = max(_chol_check("Schur system", M, rhs),
                  _chol_check("random SPD, cond 1e3", A, b))
    err72 = _chol_check("Schur system", M72, rhs72)
    # the ragged and edge sizes: the kernel's panels are 32 wide
    for Di in (1, 5, 31, 33, 190, 256):
        Ai, bi = spd_problem(Di, seed=Di, cond=1e3, dev=dev)
        _chol_check("random SPD, cond 1e3", Ai, bi)
    _chol_indefinite(dev)

    shapes = {}
    for Mi, bi in ((M, rhs), (M72, rhs72)):
        Di = Mi.shape[0]
        ms = cuda_ms(lambda: chol.cholesky_solve(Mi, bi), 200)
        dev_us = device_us(lambda: chol.cholesky_solve(Mi, bi), 50,
                           "chol_solve_kernel")
        plain_ms = cuda_ms(lambda: chol.cholesky_solve_plain(Mi, bi), 3,
                           warmup=1)
        lib_ms = cuda_ms(lambda: torch.linalg.solve(Mi, bi), 50)
        lib_us = device_us(lambda: torch.linalg.solve(Mi, bi), 20, "getrf")
        # the kernel reads M's lower triangle and b, and writes x
        nbytes = 4 * (Di * (Di + 1) // 2 + 2 * Di)
        flops = Di ** 3 / 3 + 2 * Di * Di
        b_ms, b_by = bound(nbytes, flops)
        log(f"K4 timing (D = {Di}): kernel {ms:.4f} ms per call, device "
            f"time {_us(dev_us)}, plain {plain_ms:.3f} ms, "
            f"torch.linalg.solve {lib_ms:.4f} ms per call (its getrf "
            f"{_us(lib_us)}), bound {b_ms:.6f} ms ({b_by}); like K1 it is "
            f"latency-bound: a chain of {-(-Di // 32)} dependent panels "
            f"and {2 * -(-Di // 32)} substitution tiles")
        shapes[f"D={Di}"] = dict(ms=ms, device_us=dev_us, plain_ms=plain_ms,
                                 bound_ms=b_ms, bound_by=b_by,
                                 library_ms=lib_ms, library_getrf_us=lib_us)
    main = shapes[f"D={D}"]
    shapes["D=72"]["max_abs_err"] = err72
    return dict(max_abs_err=max_err, ms=main["ms"],
                plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"], library_ms=main["library_ms"],
                per_shape=shapes)


# the object lane's stages, as the System calls them: (module, function)
LANE_STAGES = {
    "build": ("eao_fusion_tpu_torch.objects.object_map",
              "build_frame_objects"),
    "merge_frame": ("eao_fusion_tpu_torch.objects.object_map",
                    "merge_frame_objects"),
    "associate": ("eao_fusion_tpu_torch.objects.association",
                  "ensemble_associate"),
    "update": ("eao_fusion_tpu_torch.objects.update", "object_update"),
    "merge_and_overlap": ("eao_fusion_tpu_torch.objects.merge",
                          "merge_and_overlap"),
}


@contextlib.contextmanager
def lane_timers(frame_of):
    """Time every call of the object lane's stages on the host clock, with
    the card synchronized before and after: yields a list of (frame id,
    stage, ms), the frame id read from `frame_of()` at the call."""
    import importlib

    import torch
    calls, saved = [], []

    def timed(stage, fn):
        @functools.wraps(fn)
        def run(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            calls.append((frame_of(), stage, (time.perf_counter() - t) * 1e3))
            return out
        return run

    for stage, (mod, name) in LANE_STAGES.items():
        m = importlib.import_module(mod)
        saved.append((m, name, getattr(m, name)))
        setattr(m, name, timed(stage, getattr(m, name)))
    try:
        yield calls
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


def lane_summary(calls):
    """Median ms per tracked frame that ran the lane: build + merge_frame,
    associate, update; and merge_and_overlap per keyframe."""
    per = {}
    for fid, stage, ms in calls:
        key = "merge_and_overlap" if stage == "merge_and_overlap" else fid
        per.setdefault(key, {}).setdefault(stage, []).append(ms)
    mao = per.pop("merge_and_overlap", {}).get("merge_and_overlap", [])
    frames = list(per.values())

    def med(stages):
        v = [sum(sum(f.get(st, [])) for st in stages) for f in frames]
        return float(np.median(v)) if v else None

    out = {"lane_frames": len(frames),
           "build_and_merge_frame_ms": med(("build", "merge_frame")),
           "associate_ms": med(("associate",)),
           "update_ms": med(("update",)),
           "lane_total_ms": med(("build", "merge_frame", "associate",
                                 "update")),
           "merge_and_overlap_calls": len(mao),
           "merge_and_overlap_ms": float(np.median(mao)) if mao else None}
    return out


def run_system(cfg, seq, tag: str, corrected: bool = False,
               boxes: bool = False, timers: bool = False):
    """Drive `System(cfg)` on the card over `seq`, the launch counts set to
    0 just before and read just after; `boxes` passes each frame's
    rendered boxes as offline boxes, `timers` times the object lane's
    stages. Returns the System, its summary (ATE of the raw or, with
    `corrected`, the keyframe-corrected trajectory) and the counts."""
    import torch
    from eao_fusion_tpu_torch import kernels
    from eao_fusion_tpu_torch.io import tum
    from eao_fusion_tpu_torch.pipeline.system import System

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
    frame_ms, is_kf = [], []
    timing = (lane_timers(lambda: s.frame_id) if timers
              else contextlib.nullcontext([]))
    with timing as calls:
        torch.cuda.synchronize()
        kernels.reset_launches()
        for f in seq.frames:
            n_kf = s.n_keyframes
            t = time.perf_counter()
            s.process_frame(f.gray, f.depth, f.timestamp,
                            boxes=f.boxes if boxes else None)
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t) * 1e3)
            is_kf.append(s.n_keyframes > n_kf)
        counts = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated()

    n = len(seq.frames)
    err = tum.evaluate_ate_rpe(s.trajectory_tcw(corrected=corrected),
                               seq.gt_tcw())
    n_ba = len(kf_ms) - 2 if len(kf_ms) >= 2 else 0   # from the 3rd KF on
    track_ms = [m for m, k in zip(frame_ms[1:], is_kf[1:]) if not k]
    kf_frame_ms = [m for m, k in zip(frame_ms[1:], is_kf[1:]) if k]
    summary = {
        "frames": n, "tracked_frames": len(s.diags),
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
        "fps_after_first": (n - 2) / (sum(frame_ms[2:]) / 1e3),
        "max_memory_allocated_mb": peak / 2 ** 20,
        "map_planes": int(s.map.pl_valid.sum()),
        "kf_compactions": s.n_kf_compactions,
        "kf_evictions": s.n_kf_evictions,
        "map_objects": int(s.objects.valid.sum()),
        "object_keyframes": s.n_obj_keyframes,
        "launches": counts,
    }
    if timers:
        summary["object_lane"] = lane_summary(calls)
    log(f"{tag}: " + json.dumps(summary))
    log(f"{tag} per-frame ms: " + json.dumps([round(m, 2) for m in frame_ms]))
    return s, summary, counts


def _arc(n_frames, cfg, class_textures: bool = False):
    return _render(n_frames, cfg.camera, class_textures)


@functools.lru_cache(maxsize=None)
def _render(n_frames, camera, class_textures):
    """The seed-0 arc, rendered once per run for each length (and texture
    set) the phases ask for."""
    from eao_fusion_tpu_torch.io import synthetic
    t0 = time.perf_counter()
    seq = synthetic.generate_sequence(n_frames=n_frames, seed=SEED,
                                      style="arc", camera=camera,
                                      class_textures=class_textures)
    log(f"rendered {n_frames} frames of the seed-{SEED} arc"
        f"{' (class textures)' if class_textures else ''} in "
        f"{time.perf_counter() - t0:.1f} s (host)")
    return seq


def _check_tracking(summary, counts, ate_cm):
    """ATE below `ate_cm`, local BA ran, no reset, and the launch counts of
    the run: K1 twice per tracked frame, K4 once per LM iteration (as
    often as K2)."""
    if not summary["ate_cm"] < ate_cm:
        raise AssertionError(f"ATE {summary['ate_cm']:.2f} cm >= {ate_cm} cm")
    if summary["keyframes"] < 3 or summary["local_ba_runs"] < 1:
        raise AssertionError("local BA did not run")
    if summary["resets"]:
        raise AssertionError("tracking was lost and reset")
    tracked = summary["tracked_frames"]
    if counts["pose_opt"] != 2 * tracked:
        raise AssertionError(f"pose kernel launched {counts['pose_opt']} "
                             f"times for {tracked} tracked frames")
    if counts["ba_edge_full"] < 1 or counts["ba_edge_chi2"] < 1:
        raise AssertionError(f"BA edge kernels not launched: {counts}")
    if counts["chol_solve"] != counts["ba_edge_full"]:
        raise AssertionError(f"K4 launched {counts['chol_solve']} times for "
                             f"{counts['ba_edge_full']} LM iterations")


def phase_main_path():
    """The port's System on the card at full width, planes off; returns
    its summary and the launch counts of the run."""
    from eao_fusion_tpu_torch.config import tum_fr3_config
    cfg = tum_fr3_config(use_planes=False, use_objects=False,
                         use_loop_closing=False)
    seq = _arc(N_FRAMES, cfg)
    _, summary, counts = run_system(cfg, seq, "main path, planes off")
    _check_tracking(summary, counts, ate_cm=2.0)
    return summary, counts


def phase_planes_path():
    """The slice's main path: the default RGBD configuration with planes
    on (`tum_fr3_config(use_objects=False, use_loop_closing=False)`) at
    full width on the 20-frame arc. Holds it to the JAX package's
    full-config bound (ATE < 1.5 cm), finds the floor (y = 1.2 m) and the
    back wall (z = 4.5 m) among the map planes, and checks that planes
    were matched on most tracked frames and that every LM iteration of
    local BA went through K4."""
    from eao_fusion_tpu_torch.config import tum_fr3_config
    cfg = tum_fr3_config(use_objects=False, use_loop_closing=False)
    if not cfg.use_planes:
        raise AssertionError("the default configuration has planes off")
    seq = _arc(N_FRAMES, cfg)
    s, summary, counts = run_system(cfg, seq, "main path, planes on")
    _check_tracking(summary, counts, ate_cm=1.5)
    if counts["chol_solve"] < 1:
        raise AssertionError("K4 was not launched")
    pl = s.map.pl_coeff[s.map.pl_valid].cpu().numpy()
    if len(pl) < 2:
        raise AssertionError(f"{len(pl)} map planes, expected >= 2")
    for name, g in (("back wall", [0, 0, 1, -4.5]),
                    ("floor", [0, 1, 0, -1.2])):
        g = np.asarray(g, np.float32)
        e = min(min(np.linalg.norm(p - g), np.linalg.norm(p + g)) for p in pl)
        log(f"map plane nearest the {name}: coefficient error {e:.4f} "
            f"(< 0.02)")
        if not e < 0.02:
            raise AssertionError(f"no map plane at the {name}")
    matched = [d["n_planes_matched"] > 0 for d in s.diags]
    log(f"planes matched on {sum(matched)} of {len(matched)} tracked frames")
    if sum(matched) < 0.8 * len(matched):
        raise AssertionError("planes matched on too few tracked frames")
    return summary, counts


def phase_compaction():
    """Keyframe compaction at full image width and 1024 keypoint slots,
    planes on: the 24-frame arc with a keyframe allowed every frame into a
    12-slot keyframe table (local-BA window 12, so K4 runs at D = 72). The
    capacity is cut from 256 only so that compaction fires within 24
    frames; the bounds are those of tests/test_kf_lifecycle.py (lifetime
    keyframes > 12, next_kf <= 12, no reset, corrected-trajectory ATE
    < 5 cm), and the launch counts are held as in the other System
    phases."""
    import dataclasses

    import torch
    from eao_fusion_tpu_torch.config import tum_fr3_config
    from eao_fusion_tpu_torch.ops import lie
    base = tum_fr3_config(use_objects=False, use_loop_closing=False)
    cfg = dataclasses.replace(
        base,
        capacity=dataclasses.replace(base.capacity, max_keyframes=12,
                                     max_local_ba_kfs=12),
        tracking=dataclasses.replace(base.tracking, max_frames_between_kf=1))
    seq = _arc(24, cfg)
    s, summary, counts = run_system(cfg, seq, "keyframe compaction",
                                    corrected=True)
    if not (s.n_keyframes > 12 and int(s.map.next_kf) <= 12
            and s.n_kf_compactions >= 1):
        raise AssertionError(f"compaction did not fire: {s.n_keyframes} "
                             f"keyframes, next_kf {int(s.map.next_kf)}")
    _check_tracking(summary, counts, ate_cm=5.0)
    log("keyframe events: " + json.dumps(s.events))
    # the first frame's true pose is the identity, so the System's world
    # is the true world: camera-centre error per frame, unaligned
    centre = [lie.se3_inverse(torch.as_tensor(t))[:, 4:7].numpy()
              for t in (s.trajectory_tcw(corrected=True), seq.gt_tcw())]
    err_cm = np.linalg.norm(centre[0] - centre[1], axis=1) * 100.0
    log("keyframe compaction per-frame position error cm: "
        + json.dumps([round(float(e), 2) for e in err_cm]))
    return summary, counts


def check_objects(s, seq):
    """The JAX package's bounds on the map objects (tests/test_objects.py:
    51-71, 89-97): 3 to 6 valid objects, each centre within 40 cm of a
    scene box's centre and seen in >= max(3, frames / 4) frames, at least 3
    scene classes matched, and every cuboid holding its centre."""
    ot = s.objects
    valid = ot.valid.cpu().numpy()
    cen = ot.center.cpu().numpy()[valid]
    cls = ot.cls.cpu().numpy()[valid]
    lo, hi = ot.cub_min.cpu().numpy()[valid], ot.cub_max.cpu().numpy()[valid]
    nfr = ot.n_frames.cpu().numpy()[valid]
    gt_c = np.stack([(b.lo + b.hi) / 2 for b in seq.scene.boxes])
    gt_cls = {b.class_id for b in seq.scene.boxes}
    err = [float(np.linalg.norm(gt_c - c, axis=1).min()) for c in cen]
    log(f"map objects: {len(cen)} (3 to 6), classes {sorted(cls.tolist())}"
        f" (scene {sorted(gt_cls)}), centre error cm "
        f"{[round(e * 100, 1) for e in err]} (< 40), frames seen "
        f"{nfr.tolist()} (>= {max(3, len(seq.frames) // 4)})")
    if not 3 <= len(cen) <= 6:
        raise AssertionError(f"{len(cen)} map objects")
    if not all(e < 0.4 for e in err):
        raise AssertionError("a map object is far from every scene box")
    if not (nfr >= max(3, len(seq.frames) // 4)).all():
        raise AssertionError("a map object was seen in too few frames")
    if len(set(cls.tolist()) & gt_cls) < 3:
        raise AssertionError("fewer than 3 scene classes matched")
    if not (np.all(lo <= cen + 1e-5) and np.all(cen <= hi + 1e-5)
            and np.all(hi - lo < 1.5)):
        raise AssertionError("a cuboid does not hold its centre")


def phase_objects():
    """The new main path: the JAX package's default RGBD configuration
    with planes and objects on, at full width on the 20-frame arc, the
    renderer's boxes passed as offline boxes. Held to ATE < 1.5 cm, local
    BA, no reset, the launch counts, and the object bounds of
    `check_objects`; the object lane is timed by stage."""
    from eao_fusion_tpu_torch.config import tum_fr3_config
    cfg = tum_fr3_config(use_loop_closing=False)
    if not (cfg.use_planes and cfg.use_objects):
        raise AssertionError("the default configuration has planes or "
                             "objects off")
    seq = _arc(N_FRAMES, cfg)
    s, summary, counts = run_system(cfg, seq, "objects (main path)",
                                    boxes=True, timers=True)
    _check_tracking(summary, counts, ate_cm=1.5)
    check_objects(s, seq)
    summary["object_lane_device"] = lane_device_profile(s, seq.frames[-1],
                                                        cfg)
    lane = summary["object_lane"]
    log(f"objects: {s.n_obj_keyframes} keyframe(s) triggered by a new "
        f"object; object lane per tracked frame (median of "
        f"{lane['lane_frames']}, host clock, synchronized): build + "
        f"merge_frame {lane['build_and_merge_frame_ms']:.2f} ms, associate "
        f"{lane['associate_ms']:.2f} ms, update {lane['update_ms']:.2f} ms,"
        f" total {lane['lane_total_ms']:.2f} ms; merge_and_overlap "
        f"{lane['merge_and_overlap_ms']:.2f} ms per keyframe "
        f"({lane['merge_and_overlap_calls']} calls)")
    return summary, counts


def device_per_call(fn, reps: int = 3):
    """(device events, device µs) per call of fn(), from the profiler's
    CUPTI trace (kernels and memsets, all streams)."""
    ev = device_events(fn, reps)
    return len(ev) / reps, sum(us for _, us in ev) / reps


def lane_device_profile(s, frame, cfg):
    """Each stage of the object lane once more on the System's final state
    and its last frame (pure functions: the System is not changed): device
    events and device µs per call from the profiler, and ms per call over
    back-to-back calls (CUDA events). Says how far the lane is from its
    device time, i.e. how much of it is launching."""
    import torch
    from eao_fusion_tpu_torch.objects import association, merge
    from eao_fusion_tpu_torch.objects import object_map as om
    from eao_fusion_tpu_torch.objects import update
    m, ts = s.map, s.track
    boxes = om.boxes_tensor(frame.boxes, s.device)
    g = torch.Generator(device=s.device)
    g.manual_seed(0)
    fo = om.build_frame_objects(boxes, ts.last_feats, ts.kp_pt, m.pt_xyz,
                                m.pt_valid, ts.pose, cfg=cfg)
    assoc = association.ensemble_associate(s.objects, fo, m.pt_xyz, ts.pose,
                                           s.frame_id, cfg=cfg)
    stages = {
        "build": lambda: om.build_frame_objects(
            boxes, ts.last_feats, ts.kp_pt, m.pt_xyz, m.pt_valid, ts.pose,
            cfg=cfg),
        "merge_frame": lambda: om.merge_frame_objects(fo, fo, m.pt_valid,
                                                      cfg=cfg),
        "associate": lambda: association.ensemble_associate(
            s.objects, fo, m.pt_xyz, ts.pose, s.frame_id, cfg=cfg),
        "update": lambda: update.object_update(
            s.objects, fo, assoc, m.pt_xyz, ts.pose, s.frame_id, g, cfg=cfg),
        "merge_and_overlap": lambda: merge.merge_and_overlap(
            s.objects, m.pt_xyz, g, cfg=cfg),
    }
    out = {}
    for name, fn in stages.items():
        n, us = device_per_call(fn)
        ms = cuda_ms(fn, 10, warmup=2)
        out[name] = dict(device_events=n, device_us=us, ms=ms)
        log(f"object lane {name}: {n:g} device events, device {us:.1f} us, "
            f"{ms:.3f} ms per call back to back")
    return out


def _box_iou(det, b):
    """IoU of detections [n, 6] against one (class, x, y, w, h) box."""
    ix0 = np.maximum(det[:, 1], b[1])
    iy0 = np.maximum(det[:, 2], b[2])
    ix1 = np.minimum(det[:, 1] + det[:, 3], b[1] + b[3])
    iy1 = np.minimum(det[:, 2] + det[:, 4], b[2] + b[4])
    inter = np.maximum(ix1 - ix0, 0) * np.maximum(iy1 - iy0, 0)
    return inter / np.maximum(det[:, 3] * det[:, 4] + b[3] * b[4] - inter,
                              1e-9)


DETECTOR_FRAMES = (0, 4, 8, 12, 16, 20)


def phase_detector():
    """The port's YOLOX lane with the shipped weights on the card: the raw
    head outputs against the same module on the CPU (within 1e-4 of their
    largest value: float32 convolutions, TF32 off, in other orders), the
    decoded detections (same kept rows and classes, boxes within 0.5 px),
    recall >= 0.6 at IoU 0.4 and class accuracy >= 0.8 on hits over six
    frames (tests/test_yolox_train.py:80-109), and the forward and decode +
    NMS times beside the forward's bound."""
    import torch
    from eao_fusion_tpu_torch.config import tum_fr3_config
    from eao_fusion_tpu_torch.frontend import yolox
    from eao_fusion_tpu_torch.pipeline.system import REPO_ROOT
    path = f"{REPO_ROOT}/data/yolox_synth.npz"
    pg = yolox.load_params(path, "cuda")
    pc = yolox.load_params(path, "cpu")
    depth_mult, n_classes = yolox.infer_arch(pg)
    seq = _arc(24, tum_fr3_config(), class_textures=True)
    det_lane = yolox.Detector(pg, depth_mult=depth_mult, n_classes=n_classes)
    n_gt = hits = cls_hits = 0
    rel_max = box_max = 0.0
    for i in DETECTOR_FRAMES:
        f = seq.frames[i]
        rgb = np.repeat(np.asarray(f.gray, np.float32)[..., None], 3, -1)
        xc, scale = yolox.letterbox(torch.from_numpy(rgb))
        rc = yolox.yolox_forward(pc, xc, depth_mult)
        rg = yolox.yolox_forward(pg, xc.cuda(), depth_mult)
        rel = float((rg.cpu() - rc).abs().max() / rc.abs().max())
        dc = yolox.decode_and_nms(rc, scale, n_classes).numpy()
        dg = yolox.decode_and_nms(rg, scale, n_classes).cpu().numpy()
        if not (rel < 1e-4 and np.array_equal(dg[:, 5] > 0, dc[:, 5] > 0)
                and np.array_equal(dg[:, 0], dc[:, 0])):
            raise AssertionError(f"detector on the card differs from the "
                                 f"CPU on frame {i} (raw rel {rel:.3g})")
        box = float(np.abs(dg[:, 1:5] - dc[:, 1:5]).max())
        if not box < 0.5:
            raise AssertionError(f"boxes differ by {box} px on frame {i}")
        rel_max, box_max = max(rel_max, rel), max(box_max, box)
        det_lane.submit(rgb)
        det = det_lane.result()
        for b in f.boxes:
            n_gt += 1
            if det is None or not len(det):
                continue
            iou = _box_iou(det, b)
            j = int(np.argmax(iou))
            if iou[j] >= 0.4:
                hits += 1
                cls_hits += int(det[j, 0]) == int(b[0])
    log(f"detector (width {pg['stem']['conv']['w'].shape[0] / 64:g}, "
        f"{n_classes} classes): raw outputs on the card against the CPU, "
        f"max |diff| / max |raw| {rel_max:.3g} (< 1e-4); decoded boxes "
        f"within {box_max:.3g} px (< 0.5), same kept rows and classes; "
        f"recall {hits}/{n_gt} (>= 0.6), class accuracy {cls_hits}/{hits} "
        f"(>= 0.8)")
    if not (hits >= 0.6 * n_gt and cls_hits >= 0.8 * hits):
        raise AssertionError("detector recall or class accuracy too low")

    # times on one frame at the main path's shapes
    f = seq.frames[DETECTOR_FRAMES[2]]
    rgb = np.repeat(np.asarray(f.gray, np.float32)[..., None], 3, -1)
    x = torch.from_numpy(rgb).cuda()
    img, scale = yolox.letterbox(x)
    raw = yolox.yolox_forward(pg, img, depth_mult)
    fwd_ms = cuda_ms(lambda: yolox.yolox_forward(pg, img, depth_mult), 20)
    nms_ms = cuda_ms(lambda: yolox.decode_and_nms(raw, scale, n_classes), 20)
    lb_ms = cuda_ms(lambda: yolox.letterbox(x), 20)

    def lane():
        det_lane.submit(rgb)
        det_lane.result()
    lane_ms = cuda_ms(lane, 10)
    flops = yolox.forward_flops(pg, depth_mult)
    n_par = sum(t.numel() for t in _leaves(pg))
    b_ms, b_by = bound(4 * (n_par + img.numel() + raw.numel()), flops)
    fwd_n, fwd_us = device_per_call(
        lambda: yolox.yolox_forward(pg, img, depth_mult))
    nms_n, nms_us = device_per_call(
        lambda: yolox.decode_and_nms(raw, scale, n_classes))
    log(f"detector timing (640x640, float32, TF32 off): forward {fwd_ms:.3f}"
        f" ms per call ({fwd_n:g} device events, device {fwd_us:.1f} us), "
        f"bound {b_ms:.4f} ms ({b_by}: {flops / 1e9:.2f} GFLOP, {n_par} "
        f"parameters); decode + NMS {nms_ms:.3f} ms ({nms_n:g} device "
        f"events, device {nms_us:.1f} us; 128 greedy steps); letterbox "
        f"{lb_ms:.3f} ms; submit + result (with the host copies) "
        f"{lane_ms:.3f} ms per frame")
    return dict(forward_ms=fwd_ms, forward_bound_ms=b_ms,
                forward_device_us=fwd_us, decode_nms_ms=nms_ms,
                decode_nms_device_us=nms_us, letterbox_ms=lb_ms,
                lane_ms=lane_ms, recall=hits / n_gt)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def phase_online(objects_summary):
    """The online lane: the objects configuration with
    `semantic_online=True` on the first 20 frames of the class-textured
    arc, no boxes passed. Held to ATE < 3 cm, at least one map object, no
    reset and the launch counts (tests/test_yolox_train.py:115-142)."""
    from eao_fusion_tpu_torch.config import tum_fr3_config
    from eao_fusion_tpu_torch.io import synthetic
    cfg = tum_fr3_config(use_loop_closing=False, semantic_online=True)
    full = _arc(24, cfg, class_textures=True)
    seq = synthetic.SyntheticSequence(frames=full.frames[:N_FRAMES],
                                      camera=full.camera, scene=full.scene)
    s, summary, counts = run_system(cfg, seq, "online detector lane")
    if s.detector is None or s.detector.device.type != "cuda":
        raise AssertionError("the online detector is not on the card")
    _check_tracking(summary, counts, ate_cm=3.0)
    if summary["map_objects"] < 1:
        raise AssertionError("online detections made no map object")
    log(f"online: {summary['map_objects']} map objects, median frame "
        f"{summary['median_frame_ms']:.1f} ms against "
        f"{objects_summary['median_frame_ms']:.1f} ms with offline boxes")
    return summary


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
        k4 = phase_chol(dev)
        phase_main_path()
        _, counts = phase_planes_path()
        phase_compaction()
        obj_summary, _ = phase_objects()
        phase_detector()
        phase_online(obj_summary)
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
        dict(name="chol_solve", route="cuda",
             source="eao_fusion_tpu_torch/csrc/chol_solve.cu",
             replaces="eao_fusion_tpu/solvers/chol_pallas.py:117",
             launches=counts["chol_solve"], **k4),
    ]
    for r in rows[:3]:
        r["library_ms"] = None   # no single PyTorch call computes these
    print(json.dumps({"kernels": rows}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
