"""The JAX package's two multi-device checks (`dryrun_multichip` in
`__graft_entry__.py`) on the port, with one rank per card.

    python -m eao_fusion_tpu_torch.apps.dryrun_multicard --cards N
        [--device cpu]

N ranks are spawned; each joins the group through
`multihost.ensure_initialized` (a file store in a temporary directory):
on a machine with N cards the backend is NCCL and rank r works on
`cuda:r` (`multihost._default_backend`, `_rank_device`); with `--device
cpu` the ranks are gloo ranks on the CPU, which is how the tests run it.
With fewer cards than N it raises: ranks never share a card here. Every
rank then runs the JAX function's two checks on its own problem:

  1. the production distributed GBA over the ``lm`` axis of an N-rank
     mesh (`dist_ba.distributed_bundle_adjust`, the two-phase schedule
     with n_iters1 = 1, n_iters = 2): 4 cameras, the first fixed,
     max(32 N, 64) points seen in the first 64 slots of each camera, one
     free plane;
  2. the full sharded steady step (`sharded_step.make_sharded_slam_step`,
     kf_every = 1) of a 320x240, 32-keyframe, 2048-point configuration
     with planes and objects on, from an empty map, on an (N/2) x 2 mesh
     (N x 1 for odd N): one blank frame at 2 m depth.

`run` also takes another GBA problem and other frames in their place (the
tests give a perturbed problem and rendered frames, so that the GBA has
work to do and the step inserts keyframes and points): the first frame
then starts the map through a System's `process_frame`, and the sharded
step takes the rest.

Rank 0 writes what it found into the run's directory; this process
prints the two OK lines, with the GBA's chi2 and how many row blocks of
the point table the cards hold. A rank that fails, or a run that
outlives its time limit, raises here.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

CAM = (535.4, 539.2, 320.1, 247.6, 40.0)
N_CAMS, N_SLOTS = 4, 64
TIMEOUT_S = 600.0


def n_points(cards: int) -> int:
    return max(cards * 32, 64)


def mesh_shape(cards: int):
    """(n_lm, n_kf) of the sharded step's mesh, as the JAX function."""
    n_kf = 2 if cards % 2 == 0 else 1
    return cards // n_kf, n_kf


def dist_ba_problem(cards: int) -> dict:
    """The JAX function's GBA problem, as numpy arrays: BAProblem fields
    `prob_<name>`, PlaneFreeBlock fields `pf_<name>`."""
    from eao_fusion_tpu_torch.ops import lie
    r = np.random.default_rng(0)
    n_pts = n_points(cards)
    pts = np.stack([r.uniform(-2, 2, n_pts), r.uniform(-1, 1, n_pts),
                    r.uniform(3, 6, n_pts)], axis=1).astype(np.float32)
    cams = np.stack([lie.se3_exp(torch.tensor(
        [0, -0.05 * i, 0, 0.1 * i, 0, 0], dtype=torch.float32)).numpy()
        for i in range(N_CAMS)])
    fx, fy, cx, cy, bf = CAM
    obs_pt = np.full((N_CAMS, N_SLOTS), -1, np.int32)
    obs_uv = np.zeros((N_CAMS, N_SLOTS, 2), np.float32)
    obs_ur = np.full((N_CAMS, N_SLOTS), -1.0, np.float32)
    for c in range(N_CAMS):
        xc = lie.se3_apply(torch.from_numpy(cams[c]),
                           torch.from_numpy(pts)).numpy()
        uv = np.stack([fx * xc[:, 0] / xc[:, 2] + cx,
                       fy * xc[:, 1] / xc[:, 2] + cy], axis=1)
        ids = np.arange(min(n_pts, N_SLOTS))
        obs_pt[c, :len(ids)] = ids
        obs_uv[c, :len(ids)] = uv[ids]
        obs_ur[c, :len(ids)] = uv[ids, 0] - bf / xc[ids, 2]
    fixed = np.zeros(N_CAMS, bool)
    fixed[0] = True
    pl0 = np.array([[0.0, -1.0, 0.0, 1.5]], np.float32)
    meas = np.zeros((N_CAMS, 1, 4), np.float32)
    for c in range(N_CAMS):
        R = lie.quat_to_rotmat(torch.from_numpy(cams[c, :4])).numpy()
        n_c = pl0[:, :3] @ R.T
        meas[c] = np.concatenate(
            [n_c, (pl0[:, 3] - n_c @ cams[c, 4:7])[:, None]], axis=1)
    return {
        "prob_cam_pose": cams, "prob_cam_valid": np.ones(N_CAMS, bool),
        "prob_cam_fixed": fixed, "prob_pt_xyz": pts,
        "prob_pt_valid": np.ones(n_pts, bool), "prob_obs_pt": obs_pt,
        "prob_obs_uv": obs_uv, "prob_obs_ur": obs_ur,
        "prob_obs_inv_sigma2": np.ones((N_CAMS, N_SLOTS), np.float32),
        "prob_obs_valid": obs_pt >= 0,
        "pf_pl_coeff": pl0, "pf_pl_free": np.ones(1, bool),
        "pf_obs_pl": np.zeros((N_CAMS, 1), np.int32), "pf_obs_meas": meas,
        "pf_obs_valid": np.ones((N_CAMS, 1), bool)}


def to_problem(arrays: dict, device):
    """(BAProblem, PlaneFreeBlock) of `dist_ba_problem`'s arrays."""
    from eao_fusion_tpu_torch.solvers import ba
    t = lambda k: torch.as_tensor(arrays[k], device=device)
    return (ba.BAProblem(*(t(f"prob_{k}") for k in ba.BAProblem._fields)),
            ba.PlaneFreeBlock(*(t(f"pf_{k}")
                                for k in ba.PlaneFreeBlock._fields)))


def step_config():
    """The JAX function's sharded-step configuration."""
    from eao_fusion_tpu_torch.config import (CameraConfig, MapCapacity,
                                             ORBConfig, SystemConfig)
    return SystemConfig(
        camera=CameraConfig(width=320, height=240, fx=267.7, fy=269.6,
                            cx=160.0, cy=123.8),
        orb=ORBConfig(n_features=256, max_keypoints=256),
        capacity=MapCapacity(max_keyframes=32, max_points=2048),
        use_planes=True, use_objects=True)


def empty_steady_state(cfg, device):
    """The steady carry of an empty map at frame 1, the generator seeded
    with 0 (the JAX function's PRNGKey(0))."""
    from eao_fusion_tpu_torch.mapping import map_state as ms
    from eao_fusion_tpu_torch.objects import object_map as om
    from eao_fusion_tpu_torch.pipeline import steady, tracking
    m = ms.empty_map(cfg, device)
    ts = tracking.init_track_state(cfg, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return steady.SteadyState(
        m=m, ts=ts, objs=om.empty_table(cfg, device),
        last_fo=steady.empty_frame_objects(cfg, m, ts), frame_id=1,
        generator=gen)


def warm_state(cfg, device, frame):
    """The steady carry of a System (loop closing off) after
    `process_frame` on `frame` = (gray, depth, boxes, timestamp): the
    map's first keyframe and its points."""
    import dataclasses
    from eao_fusion_tpu_torch.pipeline import steady
    from eao_fusion_tpu_torch.pipeline.system import System
    s = System(dataclasses.replace(cfg, use_loop_closing=False),
               device=device)
    gray, depth, boxes, ts = frame
    s.process_frame(gray, depth, ts, boxes=boxes)
    return steady.init_steady_state(s)


def blank_frame(cfg):
    """(gray, depth, boxes, timestamp): a black image 2 m away, no box."""
    h, w = cfg.camera.height, cfg.camera.width
    return (np.zeros((h, w), np.float32), np.full((h, w), 2.0, np.float32),
            np.zeros((cfg.objects.max_objects_2d, 6), np.float32), 0.0)


def state_record(st) -> dict:
    """The pose, the tracked points and the map and object tables of a
    SteadyState, as numpy arrays."""
    from eao_fusion_tpu_torch.types import tree_to_numpy
    out = {f"map.{k}": v for k, v in tree_to_numpy(st.m).items()}
    out.update({f"objs.{k}": v for k, v in tree_to_numpy(st.objs).items()})
    out["pose"] = st.ts.pose.cpu().numpy()
    out["kp_pt"] = st.ts.kp_pt.cpu().numpy()
    return out


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _rank_main(rank: int, world: int, device_type: str, out: str,
               problem, frames) -> None:
    import torch.distributed as dist
    from eao_fusion_tpu_torch.config import SolverConfig
    from eao_fusion_tpu_torch.parallel import (dist_ba, mesh, multihost,
                                               sharded_step)
    cpu = device_type == "cpu"
    if cpu:
        torch.set_num_threads(1)
    multihost.ensure_initialized(multihost.MultihostSpec(
        coordinator_address=f"file://{os.path.join(out, 'store')}",
        num_processes=world, process_id=rank,
        backend="gloo" if cpu else None, device="cpu" if cpu else None))
    dev = multihost.local_device()
    backend = dist.get_backend()
    if not cpu and (backend != "nccl" or dev != torch.device("cuda", rank)):
        raise RuntimeError(f"rank {rank} formed a {backend} group on {dev}, "
                           f"not an NCCL group on cuda:{rank}")
    info = {"rank": rank, "device": str(dev), "backend": backend}

    # 1. the distributed GBA over the lm axis
    prob, pf = to_problem(dist_ba_problem(world) if problem is None
                          else problem, dev)
    lm = mesh.make_mesh(n_landmark=world, device_type=device_type)
    t = time.perf_counter()
    res = dist_ba.distributed_bundle_adjust(
        prob, lm, plane_free=pf, cam=CAM, cfg=SolverConfig(), n_iters1=1,
        n_iters=2)
    _sync(dev)
    info["dist_ba_s"] = time.perf_counter() - t
    if not (torch.isfinite(res.cam_pose).all()
            and torch.isfinite(res.pl_coeff).all()):
        raise AssertionError(f"rank {rank}: the distributed GBA is not "
                             f"finite")

    # 2. the full sharded steady step over the (lm, kf) mesh
    cfg = step_config()
    n_lm, n_kf = mesh_shape(world)
    dm = mesh.make_mesh(n_lm, n_kf, device_type=device_type)
    if frames is None:
        st, frames = empty_steady_state(cfg, dev), [blank_frame(cfg)]
    else:
        st, frames = warm_state(cfg, dev, frames[0]), frames[1:]
    sst = sharded_step.shard_state(st, dm)
    step = sharded_step.make_sharded_slam_step(dm, cfg, kf_every=1)
    t = time.perf_counter()
    kf_inserted, n_inliers = [], []
    for frame in frames:
        sst, diag = step(sst, *frame)
        kf_inserted.append(bool(diag["kf_inserted"]))
        n_inliers.append(int(diag["n_inliers"]))
    _sync(dev)
    info["step_s"] = time.perf_counter() - t
    sharded_step.assert_replicated(sst)
    if not torch.isfinite(sst.ts.pose).all():
        raise AssertionError(f"rank {rank}: the sharded step's pose is not "
                             f"finite")
    info.update(coord=list(sst.maps.coord),
                pt_rows=[sst.maps.pt_block.start, sst.maps.pt_block.stop],
                map_device=str(sst.m.pt_xyz.device))
    whole = sharded_step.unshard_state(sst)
    if rank == 0:
        np.savez(os.path.join(out, "dist_ba.npz"),
                 cam_pose=res.cam_pose.cpu().numpy(),
                 pt_xyz=res.pt_xyz.cpu().numpy(),
                 pl_coeff=res.pl_coeff.cpu().numpy(),
                 chi2=res.chi2.cpu().numpy())
        np.savez(os.path.join(out, "sharded.npz"),
                 kf_inserted=np.asarray(kf_inserted),
                 n_inliers=np.asarray(n_inliers), **state_record(whole))
    with open(os.path.join(out, f"rank_{rank}.json"), "w") as f:
        json.dump(info, f)
    dist.destroy_process_group()


def _rank_entry(rank: int, world: int, device_type: str, out: str,
                problem, frames) -> None:
    try:
        _rank_main(rank, world, device_type, out, problem, frames)
    except BaseException:
        with open(os.path.join(out, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _check_cards(cards: int, device_type: str) -> None:
    if cards < 1:
        raise ValueError(f"--cards {cards}: at least one rank")
    if device_type == "cpu":
        return
    if device_type != "cuda":
        raise ValueError(f"device {device_type!r}: cuda or cpu")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cards:
        raise RuntimeError(f"{cards} ranks need {cards} cards, one each; "
                           f"this machine has {have} (pass --device cpu for "
                           f"gloo ranks on the CPU)")


def run(cards: int, device: str = "cuda", timeout: float = TIMEOUT_S,
        quiet: bool = False, problem: dict = None, frames=None) -> dict:
    """Spawn `cards` ranks that run both checks; print the OK lines
    (unless `quiet`) and return what rank 0 found: {"dist_ba": arrays,
    "sharded": arrays (the per-frame keyframe decisions and inlier counts,
    the gathered state), "ranks": each rank's record, "backend", "chi2",
    "pt_blocks", "mesh", "wall_s"}. `problem` (arrays as
    `dist_ba_problem` makes them) and `frames` (a list of (gray, depth,
    boxes, timestamp), the first to start the map) replace the JAX
    function's. Raises if a rank fails or the run outlives `timeout`."""
    device_type = torch.device(device).type
    _check_cards(cards, device_type)
    with tempfile.TemporaryDirectory() as out:
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_rank_entry,
                             args=(r, cards, device_type, out, problem,
                                   frames))
                 for r in range(cards)]
        t = time.perf_counter()
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        late = [p for p in procs if p.is_alive()]
        for p in late:
            p.kill()
            p.join()
        wall = time.perf_counter() - t
        paths = [os.path.join(out, f"error_{r}.txt") for r in range(cards)]
        errors = [f"rank {r}:\n" + open(path).read()
                  for r, path in enumerate(paths) if os.path.exists(path)]
        codes = [p.exitcode for p in procs]
        if late or errors or any(c != 0 for c in codes):
            raise RuntimeError(f"dryrun_multicard: rank exit codes {codes}, "
                               f"{len(late)} killed after {timeout:.0f} s\n"
                               + "\n".join(errors))
        ranks = [json.load(open(os.path.join(out, f"rank_{r}.json")))
                 for r in range(cards)]
        got = {"dist_ba": dict(np.load(os.path.join(out, "dist_ba.npz"))),
               "sharded": dict(np.load(os.path.join(out, "sharded.npz")))}
    blocks = {tuple(r["pt_rows"]) for r in ranks}
    got.update(ranks=ranks, backend=ranks[0]["backend"], wall_s=wall,
               chi2=float(got["dist_ba"]["chi2"]), pt_blocks=len(blocks),
               mesh=list(mesh_shape(cards)))
    where = "cards" if device_type == "cuda" else "CPU ranks"
    if not quiet:
        print(f"dryrun_multicard dist-BA OK on {cards} {where} "
              f"({got['backend']}): chi2={got['chi2']:.6g}", flush=True)
        print(f"dryrun_multicard full-sharded-step OK on {cards} {where} "
              f"({got['backend']}, mesh {got['mesh'][0]} x {got['mesh'][1]}; "
              f"point table in {len(blocks)} row blocks across {cards} "
              f"{where})", flush=True)
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, required=True,
                    help="ranks to spawn, one per card")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu: gloo ranks on the CPU")
    args = ap.parse_args(argv)
    run(args.cards, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
