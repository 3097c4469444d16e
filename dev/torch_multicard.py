"""The port's distributed paths with one rank per card over NCCL, held to
the one-card results (`chip_smoke.py`'s phase workloads on several
cards). Run it on a machine with 2 or 4 cards:

    python3 dev/torch_multicard.py --out FILE
    python3 dev/torch_multicard.py --probe

Workloads (each held to its one-card bounds; a failure is recorded, the
others still run, and the script exits non-zero):
  (a) phase 20's GBA (phase 12's first closure, full width, free planes)
      on 1, 2 and 4 NCCL ranks, one card each, against the dense solver on
      card 0 and against 2 gloo ranks sharing card 0 (within 1e-5, or the
      same bits); ms per LM iteration, the all-reduce's ms and bytes;
  (b) phase 21's loop cell with gba_mesh_devices = 2 and 4: rank 0's
      System on card 0, `serve_gba` on cards 1..N-1 (NCCL);
  (c) phase 24's sharded step at full width on (2, 1), (4, 1) and (2, 2)
      meshes, one NCCL rank per card, against the unsharded step's bits;
  (d) phase 22's `evaluate_sequences` with its default devices (every
      card), each sequence on its own card, against a serial run;
  (e) `apps/dryrun_multicard` on 2 and 4 cards, held to the same run on
      gloo CPU ranks by `chip_smoke.py`'s phase 32.
The record (the cards' names and power limits, the NCCL version, every
workload's numbers) goes to FILE as JSON.

`--probe` is the short first call on a new machine: the card count, an
NCCL group of one rank per card with one all-reduce of every dtype and
operation the port uses, a broadcast, a barrier; then K1-K4 on the last
card against their plain versions while the process stays on card 0
(K4 on card 0 first).
"""

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

# phases 12, 20, 21, 22 and 24 on one card, as PERF.md records them
ONE_CARD = {
    "phase20": {"dense_ms_per_iter": 39.63, "rank1_nccl_ms_per_iter": 30.90,
                "rank2_gloo_ms_per_iter": 55.64, "allreduce_ms_gloo2": 17.77},
    "phase12": {"tracking_frame_ms_gba_inflight": 189.0,
                "tracking_frame_ms_no_gba": 44.2},
    "phase21": {"tracking_frame_ms_gba_inflight": 48.2,
                "tracking_frame_ms_no_gba": 35.4, "gba_whole_ms": 2311,
                "gba_whole_ms_phase12": 1571},
    "phase22": {"threads_s": 4.15, "serial_s": 2.32},
    "phase24": {"unsharded_tracked_ms": 67.3, "unsharded_keyframe_ms": 232.2,
                "gloo2x2_tracked_ms": 107.3, "gloo2x2_keyframe_ms": 531.4,
                "keyframe_collective_bytes": 86319876},
}


def cards_info() -> dict:
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=index,name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    nccl = torch.cuda.nccl.version()
    return {"count": torch.cuda.device_count(), "nvidia_smi": smi,
            "names": [torch.cuda.get_device_name(i)
                      for i in range(torch.cuda.device_count())],
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "nccl": ".".join(str(v) for v in nccl)
            if isinstance(nccl, tuple) else str(nccl)}


# ------------------------------------------------------------------ probe

def _probe_rank(rank, world, tmp):
    """One NCCL rank on cuda:{rank}: an all-reduce of every dtype and op
    the port's collectives use, each against its exact value."""
    import torch
    import torch.distributed as dist
    cs._join_group(rank, world, os.path.join(tmp, "store"), "nccl",
                   f"cuda:{rank}")
    dev = torch.device("cuda", rank)
    got = {"backend": dist.get_backend(),
           "current": torch.cuda.current_device()}
    for dt, op, val, want in (
            (torch.float64, "SUM", rank + 0.5, world * world / 2.0),
            (torch.float32, "SUM", rank + 0.5, world * world / 2.0),
            (torch.uint8, "SUM", rank + 1, world * (world + 1) // 2),
            (torch.int64, "MIN", 7 - rank, 7 - (world - 1)),
            (torch.int64, "MAX", 7 - rank, 7)):
        t = torch.full((1000,), val, dtype=dt, device=dev)
        dist.all_reduce(t, op=getattr(dist.ReduceOp, op))
        ok = bool((t == want).all())
        got[f"{dt}_{op}"] = ok
    b = torch.arange(10, dtype=torch.int32, device=dev) * (rank == 0)
    dist.broadcast(b, src=0)
    got["broadcast_int32"] = bool((b == torch.arange(10, device=dev)).all())
    dist.barrier()
    torch.cuda.synchronize(dev)
    with open(os.path.join(tmp, f"probe_{rank}.json"), "w") as f:
        json.dump(got, f)
    dist.destroy_process_group()


def probe() -> int:
    import tempfile
    import torch
    from eao_fusion_tpu_torch import kernels
    from eao_fusion_tpu_torch.config import SolverConfig
    from eao_fusion_tpu_torch.solvers import ba_edge, chol, pose_opt
    info = cards_info()
    cs.log("cards: " + json.dumps(info))
    n = info["count"]
    faults = []
    if n > 1:
        with tempfile.TemporaryDirectory() as tmp:
            cs.run_ranks(_probe_rank, n, (tmp,), timeout=180)
            ranks = [json.load(open(os.path.join(tmp, f"probe_{r}.json")))
                     for r in range(n)]
        cs.log("NCCL probe: " + json.dumps(ranks))
        faults += [f"rank {r}: {k}" for r, g in enumerate(ranks)
                   for k, v in g.items() if v is False]
    kernels.build_all()
    last = torch.device("cuda", n - 1)
    cfg = SolverConfig()
    torch.cuda.set_device(0)

    def check(name, fn):
        try:
            msg = fn()
            cs.log(f"probe {name}: ok {msg or ''}")
        except Exception as e:
            cs.log(f"probe {name}: FAULT {type(e).__name__}: {e}")
            faults.append(name)

    def k4(dev, D):
        M, b = cs.spd_problem(D, D, 1e3, dev)
        x = chol.cholesky_solve_cuda(M, b)
        xp = chol.cholesky_solve_plain(M, b)
        torch.cuda.synchronize(dev)
        rel = float((x - xp).norm() / xp.norm())
        assert rel < 1e-4, rel
        return f"rel {rel:.3g}"

    def k1():
        pose0, obs, pobs = cs.pose_problem(np.random.default_rng(7), last)
        for planes in (None, pobs["8 slots, 3 unmatched"]):
            ref = pose_opt.optimize_pose_plain(pose0, obs, planes,
                                               cam=cs.CAM, cfg=cfg)
            ker = pose_opt.optimize_pose_cuda(pose0, obs, planes,
                                              cam=cs.CAM, cfg=cfg)
            e = cs.pose_err(ref.pose, ker.pose)
            assert e < 1e-3, e
        return f"pose err {e:.3g}"

    def k23():
        x, active = cs.edge_problem(np.random.default_rng(11), last)
        kw = dict(cam=cs.CAM, chi2_mono=cfg.chi2_mono,
                  chi2_stereo=cfg.chi2_stereo)
        tgt = torch.where(active > 0, x.obs_pt,
                          x.pt_xyz.shape[0]).to(torch.int32)
        edges = ba_edge.EdgePass(x, tgt, **kw)
        args = (x.cam_pose, x.pt_xyz, active)
        ref = ba_edge.edge_sums_plain(x, active, tgt, **kw)
        for a, k, dim in zip(ref, edges.full(*args), (0, 0, 1)):
            scale = a.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
            assert float(((a - k).abs() / scale).max()) < 1e-4
        terms = ba_edge.edge_pass_chi2_plain(x, active, **kw)[0]
        d = abs(edges.chi2_sum(*args).item() - terms.sum().item())
        assert d <= 1e-5 * terms.abs().sum().item(), d
        return f"K3 sum diff {d:.3g}"

    check(f"K1 on {last}", k1)
    check(f"K2/K3 on {last}", k23)
    check("K4 D=192 on cuda:0", lambda: k4(torch.device("cuda", 0), 192))
    check(f"K4 D=192 on {last} after cuda:0", lambda: k4(last, 192))
    check(f"K4 D=72 on {last}", lambda: k4(last, 72))
    cs.log(f"memory allocated per card: "
           f"{[torch.cuda.memory_allocated(i) for i in range(n)]}")
    cs.log(f"probe faults: {faults}")
    return 1 if faults else 0


# -------------------------------------------------------------- workloads

def workload_a(n, record):
    loop_out, problem = record["_phase12"]
    runs = [("gloo", 2, False), ("nccl", 1, False)]
    runs += [("nccl", k, True) for k in (2, 4) if k <= n]
    return cs.phase_dist_ba(problem, cs._loop_cfg(), runs=runs)


def workload_b(n, record):
    loop_out, _ = record["_phase12"]
    out = {"phase12_this_run": {
        k: loop_out[k] for k in ("gba_whole_ms_mean", "gba_stage_ms",
                                 "median_tracking_frame_ms_gba_inflight",
                                 "median_tracking_frame_ms_no_gba")}}
    for k in (2, 4):
        if k <= n:
            out[f"mesh{k}"] = cs.phase_loop_mesh(loop_out, world=k,
                                                 spread=True)
    return out


def workload_c(n, record):
    meshes = [("nccl", s) for s in ((2, 1), (4, 1), (2, 2))
              if s[0] * s[1] <= n]
    return cs.phase_sharded_step(record["cards"]["nvidia_smi"][0],
                                 meshes=meshes, spread=True)


def workload_d(n, record):
    return cs.phase_eval(devices=None)


def workload_e(n, record):
    smi = record["cards"]["nvidia_smi"][0]
    return {f"cards{k}": cs.phase_dryrun_multicard(smi, k)
            for k in (2, 4) if k <= n}


WORKLOADS = {"e": workload_e, "d": workload_d, "c": workload_c,
             "a": workload_a, "b": workload_b}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--out", help="the JSON record (needed without --probe)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_multicard: no CUDA device", file=sys.stderr)
        return 2
    if args.probe:
        return probe()
    if args.out is None:
        ap.error("--out is needed for the workloads")
    from eao_fusion_tpu_torch import kernels
    t0 = time.perf_counter()
    record = {"cards": cards_info(), "one_card": ONE_CARD, "workloads": {},
              "failed": {}}
    n = record["cards"]["count"]
    cs.log("cards: " + json.dumps(record["cards"]))
    if n < 2:
        print("torch_multicard: needs 2 or more cards", file=sys.stderr)
        return 2
    kernels.build_all()
    try:
        record["_phase12"] = cs.phase_loop()
    except Exception:
        traceback.print_exc()
        record["failed"]["phase12"] = traceback.format_exc()
    for name, fn in WORKLOADS.items():
        if name in "ab" and "_phase12" not in record:
            continue
        t = time.perf_counter()
        try:
            record["workloads"][name] = fn(n, record)
        except Exception:
            traceback.print_exc()
            record["failed"][name] = traceback.format_exc()
        cs.log(f"workload ({name}): {time.perf_counter() - t:.1f} s")
    record.pop("_phase12", None)
    record["wall_s"] = time.perf_counter() - t0
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1, default=lambda o: o.tolist()
                  if hasattr(o, "tolist") else str(o))
    cs.log(f"record: {args.out}; failed: {sorted(record['failed'])}")
    return 1 if record["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
