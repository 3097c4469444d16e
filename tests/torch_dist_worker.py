"""Ranks of the port's distributed tests: each test spawns a few processes
(`spawn`) that form a gloo group on the CPU through a file store in the
test's temporary directory, run one job and write what they found there.
Imports torch and the port only, never JAX, so a rank starts fast.

`start_ranks(job, world, tmp, args)` runs `job(rank, world, tmp, args)` in
`world` processes; `join_ranks` fails if one exits non-zero or outlives
its timeout. Several groups may run at once.
"""

from __future__ import annotations

import datetime
import json
import os
import time
import traceback

import numpy as np

TIMEOUT_S = 240.0


def _entry(job, rank, world, tmp, tag, group, args):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        if group:
            dist.init_process_group(
                "gloo", init_method=f"file://{os.path.join(tmp, tag)}",
                world_size=world, rank=rank,
                timeout=datetime.timedelta(seconds=TIMEOUT_S))
        job(rank, world, tmp, args)
    except BaseException:
        with open(os.path.join(tmp, f"{tag}_error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def start_ranks(job, world: int, tmp, args=None, group: bool = True):
    """Start `job` on `world` spawned ranks, in a gloo group of their own
    (unless `group` is False: the job forms it). Returns the handle
    `join_ranks` takes."""
    import torch.multiprocessing as mp
    tmp = str(tmp)
    tag = f"store_{time.time_ns()}"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry,
                         args=(job, r, world, tmp, tag, group, args))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, tmp, tag


def join_ranks(handle, timeout: float = TIMEOUT_S) -> None:
    """Wait for the ranks of `start_ranks`; raise with a rank's traceback
    if one fails or they do not finish within `timeout` seconds (the
    ranks left are killed)."""
    procs, tmp, tag = handle
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    errors = []
    for r in range(len(procs)):
        path = os.path.join(tmp, f"{tag}_error_{r}.txt")
        if os.path.exists(path):
            errors.append(f"rank {r}:\n" + open(path).read())
    if alive or errors or any(p.exitcode != 0 for p in procs):
        raise AssertionError(
            f"ranks {[p.exitcode for p in procs]}, {len(alive)} timed out\n"
            + "\n".join(errors))


# ----------------------------------------------------------------- problems

def save_problem(path, prob, plane_free=None) -> None:
    """A BA problem (either package's, fields as arrays) to an npz."""
    d = {f"prob_{k}": np.asarray(getattr(prob, k)) for k in prob._fields}
    if plane_free is not None:
        d.update({f"pf_{k}": np.asarray(getattr(plane_free, k))
                  for k in plane_free._fields})
    np.savez(path, **d)


def load_problem(path, device="cpu"):
    """The port's (BAProblem, PlaneFreeBlock or None) from `save_problem`."""
    import torch
    from eao_fusion_tpu_torch.solvers import ba
    z = np.load(path)
    t = lambda k: torch.as_tensor(z[k], device=device)
    prob = ba.BAProblem(*(t(f"prob_{k}") for k in ba.BAProblem._fields))
    pf = None
    if "pf_pl_coeff" in z:
        pf = ba.PlaneFreeBlock(*(t(f"pf_{k}")
                                 for k in ba.PlaneFreeBlock._fields))
    return prob, pf


def result_arrays(res) -> dict:
    out = {k: getattr(res, k).cpu().numpy() for k in
           ("cam_pose", "pt_xyz", "obs_inlier", "chi2")}
    if res.pl_coeff is not None:
        out["pl_coeff"] = res.pl_coeff.cpu().numpy()
    return out


# --------------------------------------------------------------------- jobs

def job_dist_ba(rank, world, tmp, args):
    """`distributed_bundle_adjust` on each problem of args["problems"];
    rank 0 writes each result to `<name>_w<world>.npz`."""
    from eao_fusion_tpu_torch.config import SolverConfig
    from eao_fusion_tpu_torch.parallel import dist_ba, mesh
    m = mesh.make_mesh()
    for name in args["problems"]:
        prob, pf = load_problem(os.path.join(tmp, f"{name}.npz"))
        res = dist_ba.distributed_bundle_adjust(
            prob, m, plane_free=pf, cam=tuple(args["cam"]),
            cfg=SolverConfig(), n_iters1=args["n_iters1"],
            n_iters=args["n_iters"])
        if rank == 0:
            np.savez(os.path.join(tmp, f"{name}_w{world}.npz"),
                     **result_arrays(res))


def job_multihost(rank, world, tmp, args):
    """`ensure_initialized` from the EAO_* variables, then the mesh; each
    rank writes what it saw to `multihost_<rank>.json`."""
    import torch.distributed as dist
    from eao_fusion_tpu_torch.parallel import mesh, multihost
    os.environ["EAO_COORDINATOR"] = args["coordinator"]
    os.environ["EAO_NUM_PROCESSES"] = str(world)
    os.environ["EAO_PROCESS_ID"] = str(rank)
    formed = multihost.ensure_initialized()
    again = multihost.ensure_initialized()
    m = mesh.make_mesh()
    m2 = mesh.make_mesh(n_landmark=1, n_kf=2)
    seen = {
        "formed": formed, "again": again,
        "world": dist.get_world_size(), "backend": dist.get_backend(),
        "primary": multihost.is_primary(),
        "devices": multihost.global_device_count(),
        "mesh_names": list(m.mesh_dim_names),
        "mesh_shape": list(m.mesh.shape),
        "lm_size": m.size(0), "lm_rank": m.get_local_rank("lm"),
        "mesh2_shape": list(m2.mesh.shape),
        "kf_rank": m2.get_local_rank("kf"),
    }
    with open(os.path.join(tmp, f"multihost_{rank}.json"), "w") as f:
        json.dump(seen, f)


def job_gba_mesh(rank, world, tmp, args):
    """Rank 0: a loop closer with gba_mesh_devices = world runs the
    synchronous `_global_ba` on the map in `map.npz` and writes the map to
    `map_mesh.npz`, then stops the server; the other ranks serve and
    write how many stages they served. args["cfg"]: the SystemConfig."""
    import torch
    from eao_fusion_tpu_torch.mapping import map_state, vocabulary
    from eao_fusion_tpu_torch.parallel import dist_ba, mesh
    from eao_fusion_tpu_torch.pipeline.loop_closing import LoopCloser
    cfg = args["cfg"]
    c = cfg.camera
    if rank == 0:
        lc = LoopCloser(cfg, vocabulary.Vocabulary.load(device="cpu"),
                        torch.Generator())
        m = map_state.from_numpy(dict(np.load(os.path.join(tmp,
                                                           "map.npz"))),
                                 "cpu")
        out = lc._global_ba(m)
        dist_ba.stop_gba_server(lc.gba_mesh)
        np.savez(os.path.join(tmp, "map_mesh.npz"),
                 **map_state.to_numpy(out))
    else:
        m = mesh.make_mesh(n_landmark=world)
        served = dist_ba.serve_gba(m, (c.fx, c.fy, c.cx, c.cy, c.bf),
                                   cfg.solver)
        with open(os.path.join(tmp, f"served_{rank}.json"), "w") as f:
            json.dump({"served": served}, f)


# ------------------------------------------------------------ sharded step

def save_steady(path, system) -> None:
    """A warmed System's state for `load_steady`: the checkpoint npz
    (`io/checkpoint`) and its generator's state beside it."""
    from eao_fusion_tpu_torch.io import checkpoint
    checkpoint.save_state(path, system)
    np.save(str(path)[:-4] + "_gen.npy",
            system.generator.get_state().numpy())


def load_steady(path, cfg, device="cpu"):
    """The steady carry (`steady.init_steady_state`) of a System on
    `device` restored from `save_steady`'s files; the same bits in every
    process."""
    import torch
    from eao_fusion_tpu_torch.io import checkpoint
    from eao_fusion_tpu_torch.pipeline import steady
    from eao_fusion_tpu_torch.pipeline.system import System
    s = System(cfg, device=device)
    checkpoint.load_state(str(path), s)
    s.generator.set_state(torch.from_numpy(np.load(str(path)[:-4]
                                                   + "_gen.npy")))
    return steady.init_steady_state(s)


def run_record(st) -> dict:
    """The final map, track and object arrays of a SteadyState."""
    from eao_fusion_tpu_torch.types import tree_to_numpy
    out = {f"map.{k}": v for k, v in tree_to_numpy(st.m).items()}
    out.update({f"objs.{k}": v for k, v in tree_to_numpy(st.objs).items()})
    out["pose"] = st.ts.pose.cpu().numpy()
    out["kp_pt"] = st.ts.kp_pt.cpu().numpy()
    return out


def _sharded_errors(cfg, world) -> dict:
    """What the sharded step raises on meshes and capacities that do not
    fit: {case: the ValueError's text, or None if none was raised}."""
    import dataclasses
    import types
    import torch
    from eao_fusion_tpu_torch.parallel import mesh, sharded_step

    def capacity(**kw):
        return cfg.replace(capacity=dataclasses.replace(cfg.capacity, **kw))

    cases = {
        "mesh_over_group": lambda: mesh.make_mesh(n_landmark=world + 1),
        "mesh_over_group_step": lambda: sharded_step.make_sharded_slam_step(
            types.SimpleNamespace(
                mesh=torch.arange(world + 2).reshape(world + 2, 1),
                mesh_dim_names=("lm", "kf"), device_type="cpu"), cfg),
        "max_points": lambda: sharded_step.make_sharded_slam_step(
            mesh.make_mesh(n_landmark=world, device_type="cpu"),
            capacity(max_points=cfg.capacity.max_points + 1)),
        "max_keyframes": lambda: sharded_step.make_sharded_slam_step(
            mesh.make_mesh(n_landmark=1, n_kf=world, device_type="cpu"),
            capacity(max_keyframes=cfg.capacity.max_keyframes + 1)),
    }
    out = {}
    for name, fn in cases.items():
        try:
            fn()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def job_sharded_step(rank, world, tmp, args):
    """`make_sharded_slam_step` on an args["mesh"] = (n_lm, n_kf) mesh of
    args["device"] ("cpu" or "cuda") from the state in `steady.npz` over
    the frames in `frames.npz` (kf_every = args["kf_every"]; the last three
    frames through `make_sharded_slam_chunk`, a chunk each), the
    replicated state checked across the ranks after every frame. Rank 0
    writes the per-frame poses, keyframe decisions and inlier counts and
    the gathered final state to `sharded_<n_lm>x<n_kf>.npz`; each rank the
    shapes of its blocks and whether its `kf_rows` read the gathered map's
    rows to `blocks_<n_lm>x<n_kf>_<rank>.json`; with args["errors"], rank
    0 also what the step raises on meshes and capacities that do not fit,
    to `errors.json`."""
    import torch
    from eao_fusion_tpu_torch.parallel import mesh, sharded_step
    from eao_fusion_tpu_torch.pipeline import tracking
    cfg, device = args["cfg"], args.get("device", "cpu")
    n_lm, n_kf = args["mesh"]
    tag = f"{n_lm}x{n_kf}"
    dm = mesh.make_mesh(n_lm, n_kf, device_type=device)
    st = load_steady(os.path.join(tmp, "steady.npz"), cfg, device)
    sst = sharded_step.shard_state(st, dm)
    step = sharded_step.make_sharded_slam_step(dm, cfg,
                                               kf_every=args["kf_every"])
    chunk = sharded_step.make_sharded_slam_chunk(dm, cfg,
                                                 kf_every=args["kf_every"])
    fr = np.load(os.path.join(tmp, "frames.npz"))
    per = {"pose": [], "kf_inserted": [], "n_inliers": []}
    n = len(fr["ts"])
    for t in range(n):
        if t < n - 3:
            sst, diag = step(sst, fr["gray"][t], fr["depth"][t],
                             fr["boxes"][t], fr["ts"][t])
        else:       # the last three frames through the chunk, one a chunk
            sst, diag = chunk(sst, *(fr[k][t:t + 1] for k in (
                "gray", "depth", "boxes", "ts")))
            diag = {k: v[0] for k, v in diag.items()}
            assert diag["pose"].equal(sst.ts.pose)
        sharded_step.assert_replicated(sst)
        per["pose"].append(sst.ts.pose.cpu().numpy())
        per["kf_inserted"].append(bool(diag["kf_inserted"]))
        per["n_inliers"].append(int(diag["n_inliers"]))
    whole = sharded_step.unshard_state(sst)
    names = ("kf_pt_idx", "kf_kp_valid", "kf_desc_pm1", "kf_kp_angle")
    K, K_loc = whole.m.max_kf, sst.maps.K_loc
    kf_rows_equal = all(
        torch.equal(a, b) for k in {0, K_loc - 1, K_loc % K, K - 1}
        for a, b in zip(sst.maps.kf_rows(sst.m, k, names),
                        tracking.WHOLE.kf_rows(whole.m, k, names)))
    with open(os.path.join(tmp, f"blocks_{tag}_{rank}.json"), "w") as f:
        json.dump({"pt_xyz": list(sst.m.pt_xyz.shape),
                   "pt_desc_pm1": list(sst.m.pt_desc_pm1.shape),
                   "kf_pose": list(sst.m.kf_pose.shape),
                   "kf_desc_pm1": list(sst.m.kf_desc_pm1.shape),
                   "obs_ind": list(sst.m.obs_ind.shape),
                   "pl_coeff": list(sst.m.pl_coeff.shape),
                   "coord": list(sst.maps.coord),
                   "kf_rows_equal": kf_rows_equal}, f)
    errors = _sharded_errors(cfg, world) if args.get("errors") else None
    if rank == 0:
        np.savez(os.path.join(tmp, f"sharded_{tag}.npz"),
                 **{f"per.{k}": np.asarray(v) for k, v in per.items()},
                 **run_record(whole))
        if errors is not None:
            with open(os.path.join(tmp, "errors.json"), "w") as f:
                json.dump(errors, f)


def job_allreduce_payload(rank, world, tmp, args):
    """`distributed_bundle_adjust` (one phase of args["n_iters"] LM
    iterations) on the problem in `<args["name"]>.npz`, with every call of
    `dist_ba._all_sum`, the module's one all-reduce, recorded; rank 0
    writes [dtype, numel, bytes] of each call, in order, to
    `<name>_payload.json`."""
    from eao_fusion_tpu_torch.config import SolverConfig
    from eao_fusion_tpu_torch.parallel import dist_ba, mesh
    calls = []
    all_sum = dist_ba._all_sum

    def recorded(t, group):
        calls.append([str(t.dtype), t.numel(), t.numel() * t.element_size()])
        return all_sum(t, group)

    dist_ba._all_sum = recorded
    try:
        prob, _ = load_problem(os.path.join(tmp, f"{args['name']}.npz"))
        dist_ba.distributed_bundle_adjust(
            prob, mesh.make_mesh(), cam=tuple(args["cam"]),
            cfg=SolverConfig(), n_iters=args["n_iters"])
    finally:
        dist_ba._all_sum = all_sum
    if rank == 0:
        with open(os.path.join(tmp, f"{args['name']}_payload.json"),
                  "w") as f:
            json.dump(calls, f)


# ------------------------------------------------------- cards of their own

def job_dist_ba_cards(rank, world, tmp, args):
    """`distributed_bundle_adjust` of the problem in `<args["name"]>.npz`
    on a group that `multihost.ensure_initialized` forms (start the ranks
    with group=False): backend args["backend"], rank r on
    args["devices"][r]. Rank 0 writes the result to
    `<name>_<args["tag"]>.npz`."""
    import torch
    import torch.distributed as dist
    from eao_fusion_tpu_torch.config import SolverConfig
    from eao_fusion_tpu_torch.parallel import dist_ba, mesh, multihost
    tag = args["tag"]
    dev = args["devices"][rank]
    multihost.ensure_initialized(multihost.MultihostSpec(
        coordinator_address=f"file://{os.path.join(tmp, 'store_' + tag)}",
        num_processes=world, process_id=rank, backend=args["backend"],
        device=dev))
    if dist.get_backend() != args["backend"]:
        raise RuntimeError(f"formed a {dist.get_backend()} group")
    prob, pf = load_problem(os.path.join(tmp, f"{args['name']}.npz"), dev)
    res = dist_ba.distributed_bundle_adjust(
        prob, mesh.make_mesh(device_type=torch.device(dev).type),
        plane_free=pf, cam=tuple(args["cam"]), cfg=SolverConfig(),
        n_iters1=args["n_iters1"], n_iters=args["n_iters"])
    if rank == 0:
        np.savez(os.path.join(tmp, f"{args['name']}_{tag}.npz"),
                 **result_arrays(res))


def job_system_on_card(rank, world, tmp, args):
    """A fresh process that never selects a card: `System(cfg,
    device=args["device"])` over the frames in `arc.npz`, then one GBA of
    the final map on a loop closer's thread (`launch_gba_async`, a
    blocking `poll_gba`). Writes `system_<card index>.npz`: the raw ATE
    (cm), the launch counts, every field of the merged map, and the bytes
    the caching allocator holds on each card."""
    import torch
    from eao_fusion_tpu_torch import kernels
    from eao_fusion_tpu_torch.io import tum
    from eao_fusion_tpu_torch.mapping import map_state, vocabulary
    from eao_fusion_tpu_torch.pipeline.loop_closing import LoopCloser
    from eao_fusion_tpu_torch.pipeline.system import System
    cfg, dev = args["cfg"], torch.device(args["device"])
    z = np.load(os.path.join(tmp, "arc.npz"))
    s = System(cfg, device=dev)
    kernels.reset_launches()
    for i in range(len(z["ts"])):
        s.process_frame(z["gray"][i], z["depth"][i], float(z["ts"][i]))
    torch.cuda.synchronize(dev)
    launches = dict(kernels.launches)
    ate = tum.evaluate_ate_rpe(s.trajectory_tcw(), z["tcw"]).ate_rmse
    lc = LoopCloser(cfg, vocabulary.Vocabulary.load(device=dev),
                    torch.Generator(device=dev))
    lc.launch_gba_async(s.map)
    m, merged = lc.poll_gba(s.map, blocking=True)
    torch.cuda.synchronize(dev)
    mem = [torch.cuda.memory_allocated(i)
           for i in range(torch.cuda.device_count())]
    np.savez(os.path.join(tmp, f"system_{dev.index}.npz"),
             ate_cm=ate * 100.0, launches=json.dumps(launches),
             merged=merged, current_device=torch.cuda.current_device(),
             memory_allocated=np.asarray(mem, np.int64),
             **{f"map.{k}": v for k, v in map_state.to_numpy(m).items()})


def job_build_kernels(rank, world, tmp, args):
    """`kernels.build_all(["chol_solve"])` into the shared
    args["build_dir"], with the compiler at args["bin"] first on PATH,
    every rank starting at the time args["start"]; writes whether this
    rank compiled and the size of the library it then finds to
    `built_<rank>.json`."""
    from pathlib import Path
    from eao_fusion_tpu_torch import kernels
    os.environ["PATH"] = args["bin"] + os.pathsep + os.environ["PATH"]
    kernels.BUILD_DIR = Path(args["build_dir"])
    while time.time() < args["start"]:
        time.sleep(0.005)
    built = kernels.build_all(["chol_solve"])
    with open(os.path.join(tmp, f"built_{rank}.json"), "w") as f:
        json.dump({"compiled": "chol_solve" in built,
                   "size": kernels.lib_path("chol_solve").stat().st_size},
                  f)
