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
