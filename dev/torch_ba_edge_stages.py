"""Times the local-BA edge stages of the port as they stood at commit
5786a33, before K2 and K3 took their sums inside the kernels, on one GPU:

  K2 stage = edge_pass_full + 2 torch.zeros + 2 index_add_ (gn_iter)
  K3 stage = edge_pass_chi2 + torch.sum (robust_chi2)

on chip_smoke.py's phase-4 window (E = 8192, C = 32, Pw = 2048), with the
edges in random camera order and in camera order. Prints the card, the
kernel's `-Xptxas -v` lines, and per stage the device kernels per call,
their device µs (profiler) and the per-call ms (CUDA events).

Run it from the root of that commit's tree:

    git archive 5786a33 | tar -x -C build/archive/parent
    cd build/archive/parent && python3 ../../../dev/torch_ba_edge_stages.py
"""
import json, subprocess, sys, time
sys.path.insert(0, ".")
import numpy as np, torch
import chip_smoke as cs
from eao_fusion_tpu_torch import kernels
from eao_fusion_tpu_torch.config import SolverConfig
from eao_fusion_tpu_torch.solvers import ba_edge
from torch.profiler import ProfilerActivity, profile
from torch.autograd import DeviceType

print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout.strip())
kernels.build_all(["ba_edge"])
p = kernels.lib_path("ba_edge")
for line in (kernels.BUILD_DIR / f"{p.stem}.log").read_text().splitlines():
    if "registers" in line or "spill" in line or "Compiling" in line or "Function properties" in line:
        print("ptxas", line.strip())
dev = torch.device("cuda")
cfg = SolverConfig()
kw = dict(cam=cs.CAM, chi2_mono=cfg.chi2_mono, chi2_stereo=cfg.chi2_stereo)


def prof(fn, reps=50):
    fn(); torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as pr:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in pr.events() if e.device_type == DeviceType.CUDA]
    per = {}
    for e in ev:
        k = e.name[:80]
        d = per.setdefault(k, [0, 0.0])
        d[0] += 1
        d[1] += e.device_time if hasattr(e, "device_time") else e.cuda_time
    return len(ev) / reps, {k: dict(count_per_call=v[0] / reps, us=v[1] / v[0]) for k, v in per.items()}, \
        sum(v[1] for v in per.values()) / reps


for order in ("random", "camera"):
    x, active = cs.edge_problem(np.random.default_rng(11), dev)
    if order == "camera":
        perm = torch.argsort(x.obs_cam.long(), stable=True)
        x = x._replace(obs_cam=x.obs_cam[perm].contiguous(), obs_pt=x.obs_pt[perm].contiguous(),
                       obs_uv=x.obs_uv[perm].contiguous(), obs_ur=x.obs_ur[perm].contiguous(),
                       obs_inv_sigma2=x.obs_inv_sigma2[perm].contiguous())
        active = active[perm].contiguous()
    C, Pw, E = x.cam_pose.shape[0], x.pt_xyz.shape[0], x.obs_cam.shape[0]
    cam_idx = x.obs_cam.long()
    tgt0 = torch.where(active > 0, x.obs_pt.long(), Pw)

    def k2_stage():
        payc, payp, y = ba_edge.edge_pass_full(x, active, **kw)
        acc_c = torch.zeros((C, 42), device=dev).index_add_(0, cam_idx, payc.T)
        acc = torch.zeros((Pw + 1, 12), device=dev).index_add_(0, tgt0, payp.T)[:Pw]
        return acc_c, acc, y

    def k3_stage():
        c2r, _, _ = ba_edge.edge_pass_chi2(x, active, **kw)
        return torch.sum(c2r)

    def k3_item():
        return k3_stage().item()

    for name, fn in (("K2 stage", k2_stage), ("K3 stage", k3_stage)):
        ms = cs.cuda_ms(fn, 200)
        n, per, dev_us = prof(fn)
        print(json.dumps(dict(order=order, stage=name, per_call_ms=ms, device_kernels_per_call=n,
                              device_us_per_call=dev_us, kernels=per)))
    for _ in range(5):
        k3_item()
    t = time.perf_counter()
    for _ in range(200):
        k3_item()
    print(json.dumps(dict(order=order, stage="K3 stage + .item()", host_ms=(time.perf_counter() - t) / 200 * 1e3)))
    # the kernel alone, for reference
    print(json.dumps(dict(order=order, k2_kernel_ms=cs.cuda_ms(lambda: ba_edge.edge_pass_full(x, active, **kw), 200),
                          k3_kernel_ms=cs.cuda_ms(lambda: ba_edge.edge_pass_chi2(x, active, **kw), 200))))
