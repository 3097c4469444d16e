"""Distributed bundle adjustment: the observation-sharded Schur complement
over a `torch.distributed` mesh (port of
`eao_fusion_tpu/parallel/dist_ba.py`).

Map points are sharded over the ``lm`` axis of the mesh and the
observations are partitioned by point shard on the host, so each rank
computes residuals and Jacobians only for the observations of its own
points (~E/n). Each LM iteration:

  1. local: per-observation Jacobians, Hpp / bp of the point shard, the
     shard's Hcp block A, partial Hcc / bc, the partial reduced camera
     system S_k = Hcc_k - A Hpp⁻¹ Aᵀ and its right-hand side;
  2. one `all_reduce` over ``lm`` of S and the rhs (the JAX `psum`), and
     one of the robust chi2 of each candidate;
  3. the free-plane terms, replicated, added once after the reduce;
  4. a replicated dense solve for the camera update (`torch.linalg.solve`:
     the camera system is 6·C = 1536 wide at full width, beyond K4);
  5. local back-substitution for the shard's point update;
  6. LM accept / reject on the reduced chi2, so every rank branches the
     same way (`solvers/ba._lm_phase`, the schedule of the JAX loop).

The result does not depend on the number of ranks. Every per-observation
and per-point term is computed elementwise (`_dot3`), so it has the same
bits in any shard; the sums over a shard's observations and points (S,
the rhs, the chi2, the back-substitution's product over the cameras) and
the reduce run in float64, and are rounded to float32 after it (the JAX
package sums in float32). With float32 partial sums, 1 and 2 ranks parted
by 6e-5 in the poses of an ill-conditioned problem; now they agree to the
bit but for a rare rounding tie.

The function is SPMD: every rank of the ``lm`` group calls it with the
same problem. A JAX mesh is driven by one process; a process group has one
process per device, so the global BA of loop closing reaches the other
ranks through a small server: `serve_gba` on each non-primary rank
receives every stage by `broadcast` from rank 0 (`gba_stage`; a header on
the host's `gba_control` group, then the problem on the mesh) until
`stop_gba_server`.

Only `all_reduce`, `broadcast` and `barrier` are used: they are the
collectives gloo runs on CUDA tensors (its `all_gather` is CPU-only), so
ranks that share one card can use gloo. The full point table is therefore
an `all_reduce` of zero-padded shard slices, which is exact (x + 0 = x).
Collectives run on the caller's current stream (the GBA thread's own).
"""

from __future__ import annotations

import datetime
import weakref
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from eao_fusion_tpu_torch.config import SolverConfig
from eao_fusion_tpu_torch.ops import lie
from eao_fusion_tpu_torch.parallel import multihost
from eao_fusion_tpu_torch.solvers.ba import (BAProblem, BAResult,
                                             PlaneFreeBlock, _inv3x3,
                                             _lm_phase, _plane_free_terms,
                                             _residuals, _scatter_sum,
                                             plane_retract)


class ShardedObs(NamedTuple):
    """Per-rank observation lists bucketed by point shard: the leading axis
    is the ``lm`` axis; row d holds the observations whose point lives on
    rank d, padded with valid=False."""
    cam: torch.Tensor         # [D, E] int32 camera index
    pid_local: torch.Tensor   # [D, E] int32 point index within the shard
    uv: torch.Tensor          # [D, E, 2]
    ur: torch.Tensor          # [D, E]
    inv_sigma2: torch.Tensor  # [D, E]
    valid: torch.Tensor       # [D, E] bool


def partition_observations(prob: BAProblem, n_dev: int,
                           pad_multiple: int = 512) -> ShardedObs:
    """Bucket the dense [C, N] observation table by point shard, on the
    host in numpy (at GBA rate, not per frame). The padded width is the
    largest shard's load rounded up to `pad_multiple`."""
    P_total = prob.pt_xyz.shape[0]
    if P_total % n_dev:
        raise ValueError(f"{P_total} points do not split over {n_dev} "
                         f"shards")
    P_loc = P_total // n_dev

    obs_ok = (prob.obs_valid & (prob.obs_pt >= 0)
              & prob.cam_valid[:, None]).cpu().numpy()
    pid = prob.obs_pt.cpu().numpy()
    uv = prob.obs_uv.cpu().numpy()
    ur = prob.obs_ur.cpu().numpy()
    is2 = prob.obs_inv_sigma2.cpu().numpy()

    cam_i, slot = np.nonzero(obs_ok)
    p = pid[cam_i, slot]
    shard = p // P_loc
    counts = np.bincount(shard, minlength=n_dev)
    E = int(max(counts.max(), 1))
    E = -(-E // pad_multiple) * pad_multiple

    cam_a = np.zeros((n_dev, E), np.int32)
    lp_a = np.zeros((n_dev, E), np.int32)
    uv_a = np.zeros((n_dev, E, 2), np.float32)
    ur_a = np.full((n_dev, E), -1.0, np.float32)
    is2_a = np.ones((n_dev, E), np.float32)
    ok_a = np.zeros((n_dev, E), bool)
    order = np.argsort(shard, kind="stable")
    off = 0
    for d in range(n_dev):
        k = counts[d]
        sel = order[off:off + k]
        off += k
        cam_a[d, :k] = cam_i[sel]
        lp_a[d, :k] = p[sel] - d * P_loc
        uv_a[d, :k] = uv[cam_i[sel], slot[sel]]
        ur_a[d, :k] = ur[cam_i[sel], slot[sel]]
        is2_a[d, :k] = is2[cam_i[sel], slot[sel]]
        ok_a[d, :k] = True
    dev = prob.cam_pose.device
    return ShardedObs(*(torch.from_numpy(a).to(dev) for a in (
        cam_a, lp_a, uv_a, ur_a, is2_a, ok_a)))


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Σ_k a[..., k] b[..., k] over a last axis of 3 (broadcast), as three
    products and two adds: elementwise, so every result has the same bits
    whatever the batch. A batched product on the card picks its kernel,
    and with it the order of its adds, by the batch's size
    (`dev/torch_shard_invariance.py`)."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def _jtwj(Ja: torch.Tensor, w: torch.Tensor, Jb: torch.Tensor
          ) -> torch.Tensor:
    """Σ_r Ja[e,r,i] w[e] Jb[e,r,j] -> [E, i, j], elementwise (`_dot3`)."""
    At = (Ja * w[:, None, None]).transpose(1, 2)
    return _dot3(At[:, :, None, :], Jb.transpose(1, 2)[:, None, :, :])


def _jtwr(J: torch.Tensor, w: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Σ_r J[e,r,i] w[e] r[e,r] -> [E, i], elementwise (`_dot3`)."""
    return _dot3(J.transpose(1, 2), (w[:, None] * r)[:, None, :])


def _obs_residuals(cam_pose, pt_s, obs: ShardedObs, cam, jac: bool = True):
    """Per-observation residuals r [E,3], J_c [E,3,6], J_p [E,3,3] on one
    rank (obs fields already one row, [E, ...]), and the stereo and behind
    flags: (r, J_c, J_p, stereo, behind); without `jac` the Jacobians are
    None."""
    fx, fy, cx, cy, bf = cam
    pw = pt_s[obs.pid_local.long()]                    # [E, 3]
    poses = cam_pose[obs.cam.long()]                   # [E, 7]
    R = lie.quat_to_rotmat(poses[:, :4])               # [E, 3, 3]
    xc = _dot3(R, pw[:, None, :]) + poses[:, 4:7]
    x, y = xc[:, 0], xc[:, 1]
    z = torch.clamp(xc[:, 2], min=1e-6)
    iz = 1.0 / z
    iz2 = iz * iz
    u = fx * x * iz + cx
    v = fy * y * iz + cy
    urr = u - bf * iz
    stereo = obs.ur >= 0.0
    r = torch.stack([obs.uv[:, 0] - u, obs.uv[:, 1] - v,
                     torch.where(stereo, obs.ur - urr, 0.0)], dim=-1)
    behind = xc[:, 2] < 1e-3
    if not jac:
        return r, None, None, stereo, behind
    zero = torch.zeros_like(z)
    du = torch.stack([fx * iz, zero, -fx * x * iz2], dim=-1)
    dv = torch.stack([zero, fy * iz, -fy * y * iz2], dim=-1)
    dur = du + torch.stack([zero, zero, bf * iz2], dim=-1)
    dproj = torch.stack([du, dv, torch.where(stereo[:, None], dur, 0.0)],
                        dim=-2)                        # [E, 3, 3]
    eye = torch.eye(3, dtype=xc.dtype, device=xc.device).expand(
        xc.shape + (3,))
    dxc = torch.cat([-lie.so3_hat(xc), eye], dim=-1)  # [E, 3, 6]
    rows = dproj[:, :, None, :]
    J_c = -_dot3(rows, dxc.transpose(1, 2)[:, None, :, :])
    J_p = -_dot3(rows, R.transpose(1, 2)[:, None, :, :])
    return r, J_c, J_p, stereo, behind


def _all_sum(t: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def distributed_bundle_adjust(prob: BAProblem, mesh: DeviceMesh, *,
                              plane_free: Optional[PlaneFreeBlock] = None,
                              cam: Tuple[float, ...], cfg: SolverConfig,
                              n_iters: int = 10, n_iters1: int = 0,
                              damping: float = 1e-3,
                              obs: Optional[ShardedObs] = None) -> BAResult:
    """Every rank of the mesh's ``lm`` group calls this with the same
    problem; each returns the whole result. The point axis must divide by
    the ``lm`` size. With n_iters1 > 0 it runs the production two-phase
    schedule (n_iters1, outlier gate, n_iters); else one phase of n_iters
    over every valid observation. `plane_free` adds free plane vertices,
    whose small system is replicated and enters after the reduce."""
    C, N = prob.obs_pt.shape
    P_total = prob.pt_xyz.shape[0]
    group = mesh.get_group("lm")
    n_dev = mesh.size(0)
    rank = mesh.get_local_rank("lm")
    if P_total % n_dev:
        raise ValueError(f"{P_total} points do not split over {n_dev} "
                         f"ranks")
    P_loc = P_total // n_dev
    if obs is None:
        obs = partition_observations(prob, n_dev)
    dev = prob.cam_pose.device
    f32, f64 = torch.float32, torch.float64
    # this rank's row; its padding (valid False, weight 0) adds nothing
    keep = torch.nonzero(obs.valid[rank]).squeeze(1)
    o = ShardedObs(*(t[rank][keep] for t in obs))
    lo = rank * P_loc
    pt_valid_s = prob.pt_valid[lo:lo + P_loc]
    cam_idx = o.cam.long()

    free_cam = (prob.cam_valid & (~prob.cam_fixed)).to(f32)
    pl0 = (plane_free.pl_coeff if plane_free is not None
           else torch.zeros((1, 4), dtype=f32, device=dev))
    eye3 = torch.eye(3, dtype=f32, device=dev)
    eye6 = torch.eye(6, dtype=f32, device=dev)
    diag = torch.arange(C, device=dev)

    def robust_chi2(cam_pose, pt_s, pl, active):
        r, _, _, stereo, behind = _obs_residuals(cam_pose, pt_s, o, cam,
                                                 jac=False)
        c2 = _dot3(r, r) * o.inv_sigma2
        delta2 = torch.where(stereo, cfg.chi2_stereo, cfg.chi2_mono)
        c2r = torch.where(c2 <= delta2, c2,
                          2.0 * torch.sqrt(delta2 * c2) - delta2)
        w = active.to(f32) * (1.0 - behind.to(f32))
        total = _all_sum(torch.sum(c2r * w, dtype=f64).reshape(1),
                         group)[0].to(f32)
        if plane_free is not None:
            # the replicated plane cost, added once after the reduce
            total = total + _plane_free_terms(cam_pose, pl, plane_free,
                                              cfg)[-1]
        return total

    def gn_iter(cam_pose, pt_s, pl, active, lam: float):
        r, J_c, J_p, stereo, behind = _obs_residuals(cam_pose, pt_s, o, cam)
        c2 = _dot3(r, r) * o.inv_sigma2
        delta2 = torch.where(stereo, cfg.chi2_stereo, cfg.chi2_mono)
        w_rob = torch.clamp(torch.sqrt(delta2 / torch.clamp(c2, min=1e-12)),
                            max=1.0)
        w = (o.inv_sigma2 * w_rob * active.to(f32)
             * (1.0 - behind.to(f32)))
        w_c = w * free_cam[cam_idx]

        Hcc = _scatter_sum(C, cam_idx, _jtwj(J_c, w_c, J_c).to(f64))
        bc = -_scatter_sum(C, cam_idx, _jtwr(J_c, w_c, r).to(f64))
        tgt = torch.where(active, o.pid_local.long(), P_loc)
        Hpp = _scatter_sum(P_loc + 1, tgt, _jtwj(J_p, w, J_p))[:P_loc]
        bp = -_scatter_sum(P_loc + 1, tgt, _jtwr(J_p, w, r))[:P_loc]
        Hpp = Hpp + (lam + 1e-6) * eye3
        Hpp_inv = torch.where(pt_valid_s[:, None, None], _inv3x3(Hpp), 0.0)

        Y = _jtwj(J_c, w_c, J_p)                               # [E, 6, 3]
        A = _scatter_sum((C, P_loc + 1), (cam_idx, tgt), Y)[:, :P_loc]
        A2 = A.permute(0, 2, 1, 3).reshape(C * 6, P_loc, 3)
        del A
        AH2 = _dot3(A2[:, :, None, :], Hpp_inv.transpose(1, 2)[None])
        AH2 = AH2.reshape(C * 6, P_loc * 3).to(f64)
        A2 = A2.reshape(C * 6, P_loc * 3).to(f64)
        # the products over the shard's points in float64: the system and
        # the back-substitution are the same on any number of ranks
        S_part = -(AH2 @ A2.T).reshape(C, 6, C, 6).permute(0, 2, 1, 3)
        S_part[diag, diag] += Hcc
        rhs_part = bc - (AH2 @ bp.reshape(-1).to(f64)).reshape(C, 6)
        del AH2

        # the collective: the camera system summed over the shards, S and
        # its rhs in one buffer
        flat = _all_sum(torch.cat([S_part.reshape(-1),
                                   rhs_part.reshape(-1)]), group)
        S = flat[:C * C * 36].reshape(C, C, 6, 6).to(f32)
        rhs = flat[C * C * 36:].reshape(C, 6).to(f32)

        if plane_free is not None:
            # the replicated plane system, added once after the reduce;
            # planes are Schur-marginalized 3-DoF blocks as in ba.py
            L = pl.shape[0]
            (r_ang, r_dst, w_pl, Jca, Jcd, Jpa, Jpd,
             _) = _plane_free_terms(cam_pose, pl, plane_free, cfg)
            ai, di = cfg.plane_angle_info, cfg.plane_dist_info
            w_plc = w_pl * free_cam[:, None]
            Hcc_pl = (ai * torch.einsum("cfri,cf,cfrj->cij", Jca, w_plc, Jca)
                      + di * torch.einsum("cfi,cf,cfj->cij", Jcd, w_plc, Jcd))
            bc_pl = -(ai * torch.einsum("cfri,cf,cfr->ci", Jca, w_plc, r_ang)
                      + di * torch.einsum("cfi,cf,cf->ci", Jcd, w_plc,
                                          r_dst))
            Hll_obs = (ai * torch.einsum("cfri,cf,cfrj->cfij", Jpa, w_pl, Jpa)
                       + di * torch.einsum("cfi,cf,cfj->cfij", Jpd, w_pl,
                                           Jpd))
            bl_obs = -(ai * torch.einsum("cfri,cf,cfr->cfi", Jpa, w_pl, r_ang)
                       + di * torch.einsum("cfi,cf,cf->cfi", Jpd, w_pl,
                                           r_dst))
            pl_tgt = torch.where(plane_free.obs_valid
                                 & (plane_free.obs_pl >= 0),
                                 plane_free.obs_pl.long(), L).reshape(-1)
            Hll = _scatter_sum(L + 1, pl_tgt, Hll_obs.reshape(-1, 3, 3))[:L]
            bl = _scatter_sum(L + 1, pl_tgt, bl_obs.reshape(-1, 3))[:L]
            Acl_obs = (ai * torch.einsum("cfri,cf,cfrj->cfij", Jca, w_plc,
                                         Jpa)
                       + di * torch.einsum("cfi,cf,cfj->cfij", Jcd, w_plc,
                                           Jpd))
            F = plane_free.obs_pl.shape[1]
            cidx_pl = diag[:, None].expand(C, F).reshape(-1)
            Acl = _scatter_sum((C, L + 1), (cidx_pl, pl_tgt),
                               Acl_obs.reshape(-1, 6, 3))[:, :L]
            Hll = Hll + (lam + 1e-6) * eye3
            Hll_inv = torch.where(plane_free.pl_free[:, None, None],
                                  _inv3x3(Hll), 0.0)
            S[diag, diag] += Hcc_pl
            S = S - torch.einsum("clij,ljk,dlmk->cdim", Acl, Hll_inv, Acl)
            rhs = rhs + bc_pl - torch.einsum("clij,ljk,lk->ci", Acl, Hll_inv,
                                             bl)

        # anchor fixed / invalid cameras: identity rows
        S = S * free_cam[:, None, None, None] * free_cam[None, :, None, None]
        S[diag, diag] += eye6 * (1.0 - free_cam)[:, None, None] + eye6 * lam
        rhs = rhs * free_cam[:, None]
        M = S.permute(0, 2, 1, 3).reshape(C * 6, C * 6)
        delta_c = torch.linalg.solve(M, rhs.reshape(-1)).reshape(C, 6)
        good = torch.isfinite(delta_c).all()
        delta_c = torch.where(good, delta_c, 0.0)

        t = bp - (delta_c.reshape(-1).to(f64) @ A2).to(f32).reshape(P_loc, 3)
        delta_p = _dot3(Hpp_inv, t[:, None, :])
        delta_p = torch.clamp(torch.where(good & pt_valid_s[:, None],
                                          delta_p, 0.0), -10.0, 10.0)
        if plane_free is not None:
            t_l = bl - torch.einsum("clij,ci->lj", Acl, delta_c)
            delta_l = torch.einsum("lij,lj->li", Hll_inv, t_l)
            delta_l = torch.where(good & plane_free.pl_free[:, None],
                                  torch.clamp(delta_l, -2.0, 2.0), 0.0)
            pl = plane_retract(pl, delta_l)
        return lie.se3_retract(cam_pose, delta_c), pt_s + delta_p, pl

    def run_phase(state, active, iters):
        return _lm_phase(state, lambda st: robust_chi2(*st, active),
                         lambda st, lam: gn_iter(*st, active, lam),
                         iters, damping, 1e-4)

    state = (prob.cam_pose, prob.pt_xyz[lo:lo + P_loc], pl0)
    active = o.valid
    if n_iters1 > 0:
        state = run_phase(state, active, n_iters1)
        # outlier reclassification between the phases (chi2 gate)
        r, _, _, stereo, behind = _obs_residuals(state[0], state[1], o, cam,
                                                 jac=False)
        c2 = _dot3(r, r) * o.inv_sigma2
        thr = torch.where(stereo, cfg.chi2_stereo, cfg.chi2_mono)
        active = active & (c2 <= thr) & (~behind)
    cam_pose, pt_s, pl_out = run_phase(state, active, n_iters)

    # the whole point table on every rank: the sum of zero-padded slices
    pt_xyz = torch.zeros_like(prob.pt_xyz)
    pt_xyz[lo:lo + P_loc] = pt_s
    pt_xyz = _all_sum(pt_xyz, group)

    # final classification (replicated, dense layout, as ba.py)
    obs_ok = prob.obs_valid & (prob.obs_pt >= 0) & prob.cam_valid[:, None]
    r, _, _, stereo, behind = _residuals(prob, cam_pose, pt_xyz, cam,
                                         jac=False)
    chi2 = torch.sum(r * r, dim=-1) * prob.obs_inv_sigma2
    thr = torch.where(stereo, cfg.chi2_stereo, cfg.chi2_mono)
    inlier = obs_ok & (chi2 <= thr) & (~behind)
    return BAResult(cam_pose=cam_pose, pt_xyz=pt_xyz, obs_inlier=inlier,
                    chi2=torch.sum(torch.where(inlier, chi2, 0.0)),
                    pl_coeff=pl_out if plane_free is not None else None)


# --------------------------------------------------------------------------
# The GBA server: the primary rank drives, the others serve.
# --------------------------------------------------------------------------

_STOP, _STAGE = 0, 1
# header: op, C, N, P, L, F, n_iters1, n_iters, planes on
_HEADER = 9

# The stage headers travel on a group of their own: gloo on the host, with
# a timeout of days, since a serving rank waits for the next stage as long
# as the System runs between two loop closures (a peer that dies still
# fails the wait at once: gloo sees its connection close), and an idle
# NCCL broadcast would hold a kernel on the card. The mesh's ``lm`` group,
# with the process group's timeout, carries the problem and the solve.
_CONTROL_TIMEOUT = datetime.timedelta(days=7)
_controls: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def gba_control(mesh: DeviceMesh):
    """The stage headers' group of `mesh`, made on first use. Making it is
    collective: every rank calls this once per mesh, in the same order as
    its other groups (the loop closer when it makes its mesh, `serve_gba`
    when it starts)."""
    group = _controls.get(mesh)
    if group is None:
        ranks = dist.get_process_group_ranks(mesh.get_group("lm"))
        group = dist.new_group(ranks, backend="gloo",
                               timeout=_CONTROL_TIMEOUT)
        _controls[mesh] = group
    return group


def _send_header(mesh: DeviceMesh, hdr) -> None:
    dist.broadcast(torch.tensor(hdr, dtype=torch.int64),
                   group=gba_control(mesh), group_src=0)


def _mesh_device(mesh: DeviceMesh) -> torch.device:
    """The rank's device on the mesh: its card (`multihost.local_device`),
    or the mesh's device type."""
    if mesh.device_type == "cuda":
        return multihost.local_device()
    return torch.device(mesh.device_type)


def _broadcast(t: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    dist.broadcast(t, group=mesh.get_group("lm"), group_src=0)
    return t


def _pack(prob: BAProblem, pf: Optional[PlaneFreeBlock]):
    """The problem as one float32 and one int32 buffer (bools as 0 / 1)."""
    f = [prob.cam_pose, prob.pt_xyz, prob.obs_uv, prob.obs_ur,
         prob.obs_inv_sigma2]
    i = [prob.cam_valid, prob.cam_fixed, prob.pt_valid, prob.obs_pt,
         prob.obs_valid]
    if pf is not None:
        f += [pf.pl_coeff, pf.obs_meas]
        i += [pf.pl_free, pf.obs_pl, pf.obs_valid]
    return (torch.cat([t.reshape(-1).to(torch.float32) for t in f]),
            torch.cat([t.reshape(-1).to(torch.int32) for t in i]))


def _unpack(hdr, fbuf: torch.Tensor, ibuf: torch.Tensor):
    """(prob, plane_free) from `_pack`'s buffers and the header's shapes."""
    _, C, N, P, L, F, _, _, planes = hdr

    def take(buf, shapes):
        out, off = [], 0
        for s in shapes:
            n = int(np.prod(s))
            out.append(buf[off:off + n].reshape(s))
            off += n
        return out

    fs = [(C, 7), (P, 3), (C, N, 2), (C, N), (C, N)]
    is_ = [(C,), (C,), (P,), (C, N), (C, N)]
    if planes:
        fs += [(L, 4), (C, F, 4)]
        is_ += [(L,), (C, F), (C, F)]
    f = take(fbuf, fs)
    i = take(ibuf, is_)
    prob = BAProblem(cam_pose=f[0], cam_valid=i[0] != 0,
                     cam_fixed=i[1] != 0, pt_xyz=f[1], pt_valid=i[2] != 0,
                     obs_pt=i[3], obs_uv=f[2], obs_ur=f[3],
                     obs_inv_sigma2=f[4], obs_valid=i[4] != 0)
    pf = None
    if planes:
        pf = PlaneFreeBlock(pl_coeff=f[5], pl_free=i[5] != 0, obs_pl=i[6],
                            obs_meas=f[6], obs_valid=i[7] != 0)
    return prob, pf


def _buffer_sizes(hdr) -> Tuple[int, int]:
    _, C, N, P, L, F, _, _, planes = hdr
    nf = C * 7 + P * 3 + C * N * 4 + (L * 4 + C * F * 4 if planes else 0)
    ni = 2 * C + P + 2 * C * N + (L + 2 * C * F if planes else 0)
    return nf, ni


def gba_stage(mesh: DeviceMesh, prob: BAProblem,
              plane_free: Optional[PlaneFreeBlock], *,
              cam: Tuple[float, ...], cfg: SolverConfig, n_iters1: int,
              n_iters: int) -> BAResult:
    """On the primary rank: send one GBA stage to the serving ranks, then
    solve it with them (`distributed_bundle_adjust`)."""
    C, N = prob.obs_pt.shape
    L = plane_free.pl_coeff.shape[0] if plane_free is not None else 0
    F = plane_free.obs_pl.shape[1] if plane_free is not None else 0
    _send_header(mesh, [_STAGE, C, N, prob.pt_xyz.shape[0], L, F,
                        n_iters1, n_iters, int(plane_free is not None)])
    fbuf, ibuf = _pack(prob, plane_free)
    _broadcast(fbuf, mesh)
    _broadcast(ibuf, mesh)
    return distributed_bundle_adjust(prob, mesh, plane_free=plane_free,
                                     cam=cam, cfg=cfg, n_iters1=n_iters1,
                                     n_iters=n_iters)


def serve_gba(mesh: DeviceMesh, cam: Tuple[float, ...],
              cfg: SolverConfig) -> int:
    """On each non-primary rank of the mesh: receive GBA stages from rank 0
    and solve them with it until `stop_gba_server`. Returns the number of
    stages served."""
    dev = _mesh_device(mesh)
    control = gba_control(mesh)
    served = 0
    while True:
        hdr_t = torch.zeros(_HEADER, dtype=torch.int64)
        dist.broadcast(hdr_t, group=control, group_src=0)
        hdr = [int(x) for x in hdr_t]
        if hdr[0] == _STOP:
            return served
        nf, ni = _buffer_sizes(hdr)
        fbuf = _broadcast(torch.empty(nf, dtype=torch.float32, device=dev),
                          mesh)
        ibuf = _broadcast(torch.empty(ni, dtype=torch.int32, device=dev),
                          mesh)
        prob, pf = _unpack(hdr, fbuf, ibuf)
        distributed_bundle_adjust(prob, mesh, plane_free=pf, cam=cam,
                                  cfg=cfg, n_iters1=hdr[6], n_iters=hdr[7])
        served += 1


def stop_gba_server(mesh: DeviceMesh) -> None:
    """On the primary rank: end `serve_gba` on every other rank."""
    _send_header(mesh, [_STOP] + [0] * (_HEADER - 1))
