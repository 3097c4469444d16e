"""Bundle adjustment (port of `eao_fusion_tpu/solvers/ba.py`): local BA on
the COO edge layout, `bundle_adjust_coo`, with its fixed-plane camera
factors; and the global BA of loop closing, `bundle_adjust`, on the map's
dense [C, N] observation layout, with free plane landmarks
(`PlaneFreeBlock`).

Both run the two-phase Levenberg-Marquardt schedule: phase 1 (≤ n_iters1),
a chi2 / positive-depth outlier gate, phase 2 (≤ n_iters2), as
`Optimizer::LocalBundleAdjustment` / `BundleAdjustment` schedule it, the
arithmetic of the accept test and the stopping rule in float32, as the JAX
`while_loop` does it. Global BA reads the cost on the host once per
iteration (`_lm_phase`, a Python loop). Local BA keeps the test on the
device (`_lm_phase_device`): every iteration runs, those after the phase
is done change nothing, and the answer is the host loop's bit for bit.

`bundle_adjust_coo`: C cameras, a window of Pw points and E edges, in a
workspace of their shapes (`utils/graphs`) where the LM state lives and
the edge passes are bound once (`solvers/ba_edge.EdgePass`: the CUDA
kernels for CUDA tensors); on a card the stages between the kernel
launches are replays of CUDA graphs. Each iteration runs the full pass,
which also sums the camera and point blocks (the JAX package's one-hot [C,E] /
[Pw,E] matmuls; inside the kernel on the card, `index_add_` in the plain
version), and the chi2 sum of the accept test; it gathers the Hcp block
into a dense [C, Pw] grid through an edge-index table, solves the reduced
camera system with the Cholesky solve of `solvers/chol.py` (the CUDA
kernel K4 for CUDA tensors; the JAX function uses `jnp.linalg.solve`) and
back-substitutes the points.

`bundle_adjust`: every keyframe slot is a camera and every point slot a
point (C·6 = 1536 and 16384 points at full width). It is plain PyTorch,
as the JAX function is plain XLA: the JAX code scans the point axis in
chunks to bound TPU memory, the port scatters the Hcp block [C, P, 6, 3]
in one piece (302 MB at full width) — the same sums; the reduced camera
system is `torch.linalg.solve`, as JAX's is `jnp.linalg.solve` (beyond
K4's 256). Its scatters add in a fixed order (`ops/scatter.index_sum`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from eao_fusion_tpu_torch.config import SolverConfig
from eao_fusion_tpu_torch.ops import lie
from eao_fusion_tpu_torch.ops.scatter import index_sum
from eao_fusion_tpu_torch.solvers import ba_edge, chol
from eao_fusion_tpu_torch.utils import graphs, profiling


class BACooProblem(NamedTuple):
    cam_pose: torch.Tensor    # [C, 7] Tcw
    cam_valid: torch.Tensor   # [C] bool
    cam_fixed: torch.Tensor   # [C] bool
    pt_xyz: torch.Tensor      # [Pw, 3] window-compacted points
    pt_valid: torch.Tensor    # [Pw] bool
    obs_cam: torch.Tensor     # [E] int32 camera index
    obs_pt: torch.Tensor      # [E] int32 window-local point index (-1 none)
    obs_uv: torch.Tensor      # [E, 2]
    obs_ur: torch.Tensor      # [E] virtual right u, < 0 = mono
    obs_inv_sigma2: torch.Tensor  # [E]
    obs_valid: torch.Tensor   # [E] bool


class BAProblem(NamedTuple):
    """The dense observation layout of global BA."""
    cam_pose: torch.Tensor    # [C, 7] Tcw
    cam_valid: torch.Tensor   # [C] bool
    cam_fixed: torch.Tensor   # [C] bool — anchor cameras
    pt_xyz: torch.Tensor      # [P, 3]
    pt_valid: torch.Tensor    # [P] bool (points eligible for update)
    obs_pt: torch.Tensor      # [C, N] int32 global point id, -1 = none
    obs_uv: torch.Tensor      # [C, N, 2]
    obs_ur: torch.Tensor      # [C, N] virtual right u, < 0 = mono
    obs_inv_sigma2: torch.Tensor  # [C, N]
    obs_valid: torch.Tensor   # [C, N] bool


class PlaneFreeBlock(NamedTuple):
    """Free plane vertices for global BA (the reference's VertexPlane,
    `src/Optimizer.cc:210-250`): 3-DoF plane blocks marginalized by Schur
    like points."""
    pl_coeff: torch.Tensor    # [L, 4] world Hessian planes
    pl_free: torch.Tensor     # [L] bool — planes eligible for update
    obs_pl: torch.Tensor      # [C, F] int32 plane landmark id, -1 = none
    obs_meas: torch.Tensor    # [C, F, 4] measured camera-frame coeffs
    obs_valid: torch.Tensor   # [C, F] bool


class BAResult(NamedTuple):
    cam_pose: torch.Tensor
    pt_xyz: torch.Tensor
    obs_inlier: torch.Tensor  # [E] bool
    chi2: torch.Tensor        # [] total inlier chi2
    pl_coeff: Optional[torch.Tensor] = None


def _inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate / determinant)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-18, 1e-18, det)
    M = torch.stack([torch.stack([A11, A12, A13], -1),
                     torch.stack([A21, A22, A23], -1),
                     torch.stack([A31, A32, A33], -1)], -2)
    return M * inv_det[..., None, None]


def _plane_terms(cam_pose: torch.Tensor, plane_w: torch.Tensor,
                 meas_c: torch.Tensor, valid: torch.Tensor,
                 cfg: SolverConfig):
    """Per-camera fixed-plane factors: (Hcc_add [C,6,6], bc_add [C,6],
    cost []), with the residual and Jacobians of the pose solver's plane
    factor; each measurement is sign-aligned to its predicted normal."""
    R = lie.quat_to_rotmat(cam_pose[:, :4])                   # [C, 3, 3]
    n_c = torch.einsum("cij,cfj->cfi", R, plane_w[..., :3])   # [C, F, 3]
    d_c = plane_w[..., 3] - torch.einsum("cfi,ci->cf", n_c, cam_pose[:, 4:7])
    n_m = meas_c[..., :3]
    d_m = meas_c[..., 3]
    flip = torch.sum(n_c * n_m, dim=-1) < 0
    n_m = torch.where(flip[..., None], -n_m, n_m)
    d_m = torch.where(flip, -d_m, d_m)

    r_ang = lie.cross(n_c, n_m)                               # [C, F, 3]
    r_dst = d_c - d_m                                         # [C, F]
    chi2 = (cfg.plane_angle_info * torch.sum(r_ang * r_ang, dim=-1)
            + cfg.plane_dist_info * r_dst * r_dst)
    hub = torch.clamp(torch.sqrt(cfg.plane_chi2
                                 / torch.clamp(chi2, min=1e-12)), max=1.0)
    w = valid.float() * hub * (chi2 <= 4 * cfg.plane_chi2).float()

    J_ang_w = torch.einsum("cfij,cfjk->cfik", -lie.so3_hat(n_m),
                           -lie.so3_hat(n_c))
    J_ang = torch.cat([J_ang_w, torch.zeros_like(J_ang_w)], dim=-1)
    J_dst = torch.cat([torch.zeros_like(n_c), -n_c], dim=-1)  # [C, F, 6]
    Hcc = (cfg.plane_angle_info
           * torch.einsum("cfri,cf,cfrj->cij", J_ang, w, J_ang)
           + cfg.plane_dist_info
           * torch.einsum("cfi,cf,cfj->cij", J_dst, w, J_dst))
    bc = -(cfg.plane_angle_info
           * torch.einsum("cfri,cf,cfr->ci", J_ang, w, r_ang)
           + cfg.plane_dist_info
           * torch.einsum("cfi,cf,cf->ci", J_dst, w, r_dst))
    cost = torch.sum(torch.where(valid, torch.clamp(chi2, max=cfg.plane_chi2),
                                 0.0))
    return Hcc, bc, cost


def edge_lut(obs_cam: torch.Tensor, tgt: torch.Tensor, C: int, Pw: int
             ) -> torch.Tensor:
    """[C, Pw] edge index of each (camera, point) pair, E where none.
    A duplicate (camera, point) edge resolves to ONE edge, the one with the
    highest index (the JAX scatter's last write on the CPU); `tgt` is the
    point index, Pw for an edge that takes no part."""
    E = obs_cam.shape[0]
    dev = obs_cam.device
    key = obs_cam.long() * (Pw + 1) + tgt.long()
    lut = torch.full((C * (Pw + 1),), -1, dtype=torch.int64, device=dev)
    lut = lut.scatter_reduce(0, key, torch.arange(E, device=dev),
                             reduce="amax")
    lut = torch.where(lut < 0, E, lut)
    return lut.reshape(C, Pw + 1)[:, :Pw]


def _lm_phase(state, cost, step, iters: int, damping: float, ftol: float):
    """One Levenberg-Marquardt phase on the host, its arithmetic in float32
    as the JAX `while_loop` does it: `cost(state)` is a [] tensor,
    `step(state, lam)` a candidate state. The current cost is carried; the
    phase ends after `iters` iterations or two consecutive ones without a
    relative improvement of `ftol` (rejected steps count)."""
    lam = np.float32(damping)
    c_cur = np.float32(cost(state).item())
    it, stall = 0, 0
    while it < iters and stall < 2:
        with profiling.span("solvers.lm_iter"):
            cand = step(state, float(lam))
            c_new = np.float32(cost(cand).item())
        accept = bool(c_new < c_cur) and bool(np.isfinite(c_new))
        if accept:
            state = cand
            lam = max(lam * np.float32(0.5), np.float32(1e-6))
        else:
            lam = min(lam * np.float32(5.0), np.float32(1e3))
        improved = accept and bool(
            c_cur - c_new >= np.float32(ftol) * max(c_cur, np.float32(1e-9)))
        stall = 0 if improved else stall + 1
        if accept:
            c_cur = c_new
        it += 1
    return state


def _lm_start(ws: graphs.Workspace, c0: torch.Tensor, damping: float) -> None:
    """The device carry of an LM phase (`lm_c`, the current cost; `lm_lam`,
    the damping; `lm_stall`, the iterations in a row without a relative
    improvement of ftol; `lm_done`) at the phase's start."""
    dev = c0.device
    ws.put("lm_c", c0)
    ws.put("lm_lam", torch.full((), damping, dtype=torch.float32, device=dev))
    ws.put("lm_stall", torch.zeros((), dtype=torch.int32, device=dev))
    ws.put("lm_done", torch.zeros((), dtype=torch.bool, device=dev))


def _lm_accept(ws: graphs.Workspace, state, cand, c_new: torch.Tensor,
               ftol: float) -> None:
    """One iteration's accept test on the device carry, `_lm_phase`'s
    float32 arithmetic: a finite lower cost is accepted (the state takes
    the candidate, lam halves to at least 1e-6), else lam grows fivefold
    to at most 1e3; an accept that improves less than ftol, or a reject,
    is a stall, and two in a row end the phase. Once done the carry and
    the state stay as they are."""
    c, lam, stall, done = ws.lm_c, ws.lm_lam, ws.lm_stall, ws.lm_done
    live = ~done
    accept = live & (c_new < c) & torch.isfinite(c_new)
    improved = accept & (c - c_new >= torch.clamp(c, min=1e-9) * ftol)
    new_lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-6),
                          torch.clamp(lam * 5.0, max=1e3))
    new_stall = torch.where(improved, 0, stall + 1)
    for x, y in zip(state, cand):
        x.copy_(torch.where(accept, y, x))
    c.copy_(torch.where(accept, c_new, c))
    lam.copy_(torch.where(live, new_lam, lam))
    stall.copy_(torch.where(live, new_stall, stall))
    done.copy_(stall >= 2)


def _lm_phase_device(ws: graphs.Workspace, state, cost, step, iters: int,
                     damping: float, ftol: float, extra=None) -> None:
    """`_lm_phase` with its carry on the device, so that nothing is read on
    the host: `iters` iterations always run, and those after the phase is
    done leave the state as it is; the state is the same as the host
    loop's, bit for bit. `state` is a tuple of the workspace's tensors,
    updated in place; `cost(xs)` a [] tensor of the workspace's, to which
    `extra(xs)` adds inside the accept test's stage; `step(xs, lam)` a
    candidate of the workspace's, lam the carry's [] float32 tensor.
    Without graphs (on the CPU) the host reads the carry for free, and
    the loop ends once done, as the host loop does."""

    def total(xs, base):
        return base if extra is None else base + extra(xs)

    base = cost(state)
    ws.run("lm.start", lambda: _lm_start(ws, total(state, base), damping))
    for _ in range(iters):
        with profiling.span("solvers.lm_iter"):
            cand = step(state, ws.lm_lam)
            c_new = cost(cand)
            ws.run("lm.accept", lambda: _lm_accept(
                ws, state, cand, total(cand, c_new), ftol))
        if not ws.graphs_on and bool(ws.lm_done):
            break


def bundle_adjust_coo(prob: BACooProblem,
                      plane_block: Optional[Tuple[torch.Tensor, ...]] = None,
                      *, cam: Tuple[float, ...], cfg: SolverConfig,
                      n_iters1: int = 5, n_iters2: int = 10,
                      damping: float = 1e-3, ftol: float = 1e-4) -> BAResult:
    """Two-phase LM BA on the COO layout; obs_inlier is [E]. `plane_block`
    = (plane_w [C,F,4], meas_c [C,F,4], valid [C,F]) adds fixed-plane
    camera factors to the cost and, on the free cameras, to Hcc / bc.

    The problem is copied into the workspace of its shapes and constants
    (`utils/graphs`), where the LM state and carry live; an iteration is
    K2, the Schur assembly, K4, the back-substitution, K3 and the accept
    test (`_lm_phase_device`), the hand-written kernels launched eagerly
    and, on a card, the stages between them replayed as CUDA graphs. The
    result is new tensors."""
    C = prob.cam_pose.shape[0]
    Pw = prob.pt_xyz.shape[0]
    E = prob.obs_cam.shape[0]
    dev = prob.cam_pose.device
    f32 = torch.float32
    inputs = tuple(prob) + (tuple(plane_block) if plane_block is not None
                            else ())
    ws = graphs.workspace(
        ("bundle_adjust_coo", dev, tuple(cam), cfg, n_iters1, n_iters2,
         damping, ftol, plane_block is not None)
        + tuple((t.dtype, tuple(t.shape)) for t in inputs), dev)
    for i, t in enumerate(inputs):
        ws.put(f"in{i}", t)
    p = BACooProblem(*(getattr(ws, f"in{i}") for i in range(len(prob))))
    pb = (tuple(getattr(ws, f"in{i}") for i in range(len(prob), len(inputs)))
          or None)
    kw = dict(cam=cam, chi2_mono=cfg.chi2_mono, chi2_stereo=cfg.chi2_stereo)

    def setup():
        free_cam = (p.cam_valid & (~p.cam_fixed)).to(f32)
        obs_ok0 = p.obs_valid & (p.obs_pt >= 0) & p.cam_valid[p.obs_cam.long()]
        tgt0 = torch.where(obs_ok0, p.obs_pt.long(), Pw)
        ws.put("free_cam", free_cam)
        ws.put("obs_ok0", obs_ok0)
        ws.put("ok0_f", obs_ok0.to(f32))
        ws.put("active", obs_ok0.to(f32))
        ws.put("lut", edge_lut(p.obs_cam, tgt0, C, Pw))           # [C, Pw]
        ws.put("thr", torch.where(p.obs_ur >= 0.0, cfg.chi2_stereo,
                                  cfg.chi2_mono))
        ws.put("cam", p.cam_pose)
        ws.put("pt", p.pt_xyz)
        x = ba_edge.EdgeInputs(
            cam_pose=ws.cam, pt_xyz=ws.pt, obs_cam=p.obs_cam.to(torch.int32),
            obs_pt=torch.clamp(p.obs_pt, 0, Pw - 1).to(torch.int32),
            obs_uv=p.obs_uv, obs_ur=p.obs_ur,
            obs_inv_sigma2=p.obs_inv_sigma2, free_cam=ws.free_cam)
        # the edge passes' fixed tensors, refreshed in place
        ws.layout = {k: ws.put("edge_" + k, t) for k, t in
                     ba_edge.EdgePass.layout(x, tgt0).items()}

    ws.run("ba.setup", setup)
    if "edges" not in ws:
        # the edge passes, bound once to the workspace's tensors
        lay = ws.layout
        ws.edges = ba_edge.EdgePass(
            ba_edge.EdgeInputs(ws.cam, ws.pt, lay["obs_cam"], lay["obs_pt"],
                               lay["obs_uv"], lay["obs_ur"], lay["obs_is2"],
                               lay["free_cam"]), lay["tgt"], fixed=lay, **kw)
    edges = ws.edges
    if "edge_out" not in ws:
        ws.edge_out = torch.empty((3, E), dtype=f32, device=dev)

    def plane_cost(xs):
        return _plane_terms(xs[0], *pb, cfg)[-1]

    def cost(xs):
        return edges.chi2_sum(xs[0], xs[1], ws.active)

    def schur(xs, sums, lam):
        """The reduced camera system of one GN step (`M`, `rhs`) and what
        the back-substitution needs (`A2`, `bp`, `Hpp_inv`)."""
        # acc_c, acc and y are the binding's buffers: all used up here,
        # before the next K2 overwrites them
        acc_c, acc, y = sums
        eye3 = torch.eye(3, dtype=f32, device=dev)
        eye6 = torch.eye(6, dtype=f32, device=dev)
        free_cam = ws.free_cam
        Y = y.T.reshape(E, 6, 3)
        Hcc = acc_c[:, :36].reshape(C, 6, 6)
        bc = -acc_c[:, 36:]
        if pb is not None:
            Hp, bp_c, _ = _plane_terms(xs[0], *pb, cfg)
            Hcc = Hcc + Hp * free_cam[:, None, None]
            bc = bc + bp_c * free_cam[:, None]
        # (lam + 1e-6) in double, as the host loop's Python float
        Hpp = (acc[:, :9].reshape(Pw, 3, 3)
               + (lam.double() + 1e-6).float() * eye3)
        bp = -acc[:, 9:]
        Hpp_inv = torch.where(p.pt_valid[:, None, None], _inv3x3(Hpp), 0.0)

        # Hcp gathered into the dense [C, Pw] grid
        A = torch.cat([Y, Y.new_zeros((1, 6, 3))])[ws.lut]   # [C, Pw, 6, 3]
        AH = torch.einsum("cpij,pjk->cpik", A, Hpp_inv)
        AH2 = AH.permute(0, 2, 1, 3).reshape(C * 6, Pw * 3)
        A2 = A.permute(0, 2, 1, 3).reshape(C * 6, Pw * 3)
        S = -(AH2 @ A2.T).reshape(C, 6, C, 6).permute(0, 2, 1, 3)
        diag = torch.arange(C, device=dev)
        S[diag, diag] += Hcc
        rhs = bc - (AH2 @ bp.reshape(-1)).reshape(C, 6)
        S = S * free_cam[:, None, None, None] * free_cam[None, :, None, None]
        S[diag, diag] += (eye6 * (1.0 - free_cam)[:, None, None]
                          + eye6 * lam)
        rhs = rhs * free_cam[:, None]
        ws.put("M", S.permute(0, 2, 1, 3).reshape(C * 6, C * 6))
        ws.put("rhs", rhs.reshape(-1))
        ws.put("A2", A2)
        ws.put("bp", bp)
        ws.put("Hpp_inv", Hpp_inv)

    def back(xs):
        """The candidate (`cand_cam`, `cand_pt`) from the camera step."""
        delta_c = ws.dx.reshape(C, 6)
        good = torch.all(torch.isfinite(delta_c))
        delta_c = torch.where(good, delta_c, 0.0)
        t = ws.bp - (ws.A2.T @ delta_c.reshape(-1)).reshape(Pw, 3)
        delta_p = torch.einsum("pij,pj->pi", ws.Hpp_inv, t)
        delta_p = torch.clamp(torch.where(good & p.pt_valid[:, None],
                                          delta_p, 0.0), -10.0, 10.0)
        ws.put("cand_cam", lie.se3_retract(xs[0], delta_c))
        ws.put("cand_pt", xs[1] + delta_p)

    def step(xs, lam):
        sums = edges.full(xs[0], xs[1], ws.active)                   # K2
        ws.run("ba.schur", lambda: schur(xs, sums, lam))
        ws.put("dx", chol.cholesky_solve(ws.M, ws.rhs))              # K4
        ws.run("ba.back", lambda: back(xs))
        return ws.cand_cam, ws.cand_pt

    def classify():
        """The between-phase outlier gate on the raw chi2 and the behind
        flag of K3's per-edge pass; the inliers' chi2 sum."""
        _, chi2, behind = ws.edge_out
        inlier = ws.obs_ok0 & (chi2 <= ws.thr) & (behind < 0.5)
        ws.put("inlier", inlier)
        ws.put("active", inlier.to(f32))
        ws.put("total", torch.sum(torch.where(inlier, chi2, 0.0)))

    state = (ws.cam, ws.pt)
    for iters in (n_iters1, n_iters2):
        _lm_phase_device(ws, state, cost, step, iters, damping, ftol,
                         extra=plane_cost if pb is not None else None)
        edges.chi2_edges(ws.cam, ws.pt, ws.ok0_f, out=ws.edge_out)   # K3
        ws.run("ba.classify", classify)
    return BAResult(cam_pose=ws.cam.clone(), pt_xyz=ws.pt.clone(),
                    obs_inlier=ws.inlier.clone(), chi2=ws.total.clone())


# --------------------------------------------------------------------------
# Global BA on the dense [C, N] layout.
# --------------------------------------------------------------------------

def plane_tangent_basis(n: torch.Tensor):
    """Orthonormal basis (e1, e2) of the tangent plane at unit normal n —
    the chart of the minimal plane parameterization
    (`src/g2oAddition/Plane3D.h:68-93`)."""
    a = torch.where(torch.abs(n[..., :1]) < 0.9,
                    n.new_tensor([1.0, 0.0, 0.0]).expand(n.shape),
                    n.new_tensor([0.0, 1.0, 0.0]).expand(n.shape))
    e1 = lie.cross(n, a)
    e1 = e1 / torch.clamp(torch.linalg.norm(e1, dim=-1, keepdim=True),
                          min=1e-9)
    return e1, lie.cross(n, e1)


def plane_retract(coeff: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """coeff [.., 4] ⊕ delta [.., 3]: rotate the unit normal in its tangent
    chart, shift the distance."""
    n = coeff[..., :3]
    e1, e2 = plane_tangent_basis(n)
    n2 = n + e1 * delta[..., 0:1] + e2 * delta[..., 1:2]
    n2 = n2 / torch.clamp(torch.linalg.norm(n2, dim=-1, keepdim=True),
                          min=1e-9)
    return torch.cat([n2, (coeff[..., 3] + delta[..., 2])[..., None]], -1)


def _residuals(prob: BAProblem, cam_pose, pt_xyz, cam, jac: bool = True):
    """Per-observation residuals r [C,N,3], the stereo and behind flags,
    and (with `jac`) the Jacobians J_c [C,N,3,6], J_p [C,N,3,3] (point
    Jacobian in world coordinates): (r, J_c, J_p, stereo, behind)."""
    fx, fy, cx, cy, bf = cam
    pid = torch.clamp(prob.obs_pt.long(), 0, pt_xyz.shape[0] - 1)
    pw = pt_xyz[pid]                                          # [C, N, 3]
    R = lie.quat_to_rotmat(cam_pose[:, :4])                   # [C, 3, 3]
    xc = torch.einsum("cij,cnj->cni", R, pw) + cam_pose[:, None, 4:7]
    x, y = xc[..., 0], xc[..., 1]
    z = torch.clamp(xc[..., 2], min=1e-6)
    iz = 1.0 / z
    iz2 = iz * iz
    u = fx * x * iz + cx
    v = fy * y * iz + cy
    ur = u - bf * iz
    stereo = prob.obs_ur >= 0.0
    r = torch.stack([prob.obs_uv[..., 0] - u, prob.obs_uv[..., 1] - v,
                     torch.where(stereo, prob.obs_ur - ur, 0.0)], dim=-1)
    behind = xc[..., 2] < 1e-3
    if not jac:
        return r, None, None, stereo, behind
    zero = torch.zeros_like(z)
    du = torch.stack([fx * iz, zero, -fx * x * iz2], dim=-1)
    dv = torch.stack([zero, fy * iz, -fy * y * iz2], dim=-1)
    dur = du + torch.stack([zero, zero, bf * iz2], dim=-1)
    dproj = torch.stack([du, dv, torch.where(stereo[..., None], dur, 0.0)],
                        dim=-2)                               # [C,N,3,3]
    eye = torch.eye(3, dtype=xc.dtype, device=xc.device).expand(
        xc.shape + (3,))
    dxc = torch.cat([-lie.so3_hat(xc), eye], dim=-1)          # [C,N,3,6]
    J_c = -(dproj @ dxc)
    J_p = -torch.einsum("cnij,cjk->cnik", dproj, R)
    return r, J_c, J_p, stereo, behind


def _plane_free_terms(cam_pose, pl_coeff, pf: PlaneFreeBlock,
                      cfg: SolverConfig):
    """Residuals and Jacobians of the plane edges with free plane vertices
    (`src/g2oAddition/EdgePlane.h:29-45`): r_ang [C,F,3], r_dst [C,F],
    w [C,F] (validity and Huber, information not folded in), J_cam_ang
    [C,F,3,6], J_cam_dst [C,F,6], J_pl_ang [C,F,3,3], J_pl_dst [C,F,3],
    cost []. The plane tangent is (u1, u2) in the normal's chart and the
    distance."""
    L = pl_coeff.shape[0]
    plane_w = pl_coeff[torch.clamp(pf.obs_pl.long(), 0, L - 1)]  # [C,F,4]
    valid = pf.obs_valid & (pf.obs_pl >= 0)
    R = lie.quat_to_rotmat(cam_pose[:, :4])
    t = cam_pose[:, 4:7]
    n_w = plane_w[..., :3]
    n_c = torch.einsum("cij,cfj->cfi", R, n_w)
    d_c = plane_w[..., 3] - torch.einsum("cfi,ci->cf", n_c, t)
    n_m = pf.obs_meas[..., :3]
    d_m = pf.obs_meas[..., 3]
    flip = torch.sum(n_c * n_m, dim=-1) < 0
    n_m = torch.where(flip[..., None], -n_m, n_m)
    d_m = torch.where(flip, -d_m, d_m)

    r_ang = lie.cross(n_c, n_m)
    r_dst = d_c - d_m
    chi2 = (cfg.plane_angle_info * torch.sum(r_ang * r_ang, dim=-1)
            + cfg.plane_dist_info * r_dst * r_dst)
    hub = torch.clamp(torch.sqrt(cfg.plane_chi2
                                 / torch.clamp(chi2, min=1e-12)), max=1.0)
    w = valid.float() * hub * (chi2 <= 4 * cfg.plane_chi2).float()

    dra_dnc = -lie.so3_hat(n_m)
    J_ang_w = torch.einsum("cfij,cfjk->cfik", dra_dnc, -lie.so3_hat(n_c))
    J_cam_ang = torch.cat([J_ang_w, torch.zeros_like(J_ang_w)], dim=-1)
    J_cam_dst = torch.cat([torch.zeros_like(n_c), -n_c], dim=-1)
    e1, e2 = plane_tangent_basis(n_w)
    RE = torch.stack([torch.einsum("cij,cfj->cfi", R, e1),
                      torch.einsum("cij,cfj->cfi", R, e2)], -1)  # [C,F,3,2]
    J_ang_u = torch.einsum("cfij,cfjk->cfik", dra_dnc, RE)
    J_pl_ang = torch.cat([J_ang_u, torch.zeros_like(J_ang_u[..., :1])], -1)
    J_dst_u = -torch.einsum("ci,cfik->cfk", t, RE)
    J_pl_dst = torch.cat([J_dst_u, torch.ones_like(J_dst_u[..., :1])], -1)
    cost = torch.sum(torch.where(valid, torch.clamp(chi2, max=cfg.plane_chi2),
                                 0.0))
    return r_ang, r_dst, w, J_cam_ang, J_cam_dst, J_pl_ang, J_pl_dst, cost


def _weights(r, stereo, behind, prob: BAProblem, active, cfg: SolverConfig):
    chi2 = torch.sum(r * r, dim=-1) * prob.obs_inv_sigma2
    delta2 = torch.where(stereo, cfg.chi2_stereo, cfg.chi2_mono)
    w_rob = torch.clamp(torch.sqrt(delta2 / torch.clamp(chi2, min=1e-12)),
                        max=1.0)
    w = (prob.obs_inv_sigma2 * w_rob * active.float()
         * (1.0 - behind.float()))
    return w, chi2


def _scatter_sum(n, idx, vals: torch.Tensor) -> torch.Tensor:
    """Σ of vals [M, ...] into n rows by idx, each row's terms in order
    (`ops/scatter.index_sum`); with n = (R, S) and idx a pair of index
    tensors, into an [R, S, ...] table."""
    if isinstance(n, tuple):
        R, S = n
        flat = _scatter_sum(R * S, idx[0].long() * S + idx[1].long(), vals)
        return flat.reshape((R, S) + tuple(vals.shape[1:]))
    out = torch.zeros((n,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                      device=vals.device)
    return index_sum(out, idx, vals)


def bundle_adjust(prob: BAProblem, *,
                  plane_free: Optional[PlaneFreeBlock] = None,
                  cam: Tuple[float, ...], cfg: SolverConfig,
                  n_iters1: int = 5, n_iters2: int = 10,
                  damping: float = 1e-3) -> BAResult:
    """Two-phase global BA on the dense layout (`bundle_adjust` of the JAX
    package without its unused fixed-plane `plane_block`). With
    `plane_free`, plane landmarks are free 3-DoF vertices marginalized
    alongside the points; their steps are clamped to ±2, the points' to
    ±10, and a step with any non-finite camera entry is dropped."""
    C, N = prob.obs_pt.shape
    P = prob.pt_xyz.shape[0]
    dev = prob.cam_pose.device
    f32 = torch.float32
    obs_ok0 = (prob.obs_valid & (prob.obs_pt >= 0)
               & prob.cam_valid[:, None])
    free_cam = (prob.cam_valid & (~prob.cam_fixed)).to(f32)
    pl0 = (plane_free.pl_coeff if plane_free is not None
           else torch.zeros((1, 4), dtype=f32, device=dev))
    eye3 = torch.eye(3, dtype=f32, device=dev)
    eye6 = torch.eye(6, dtype=f32, device=dev)
    diag = torch.arange(C, device=dev)
    # the observations valid at the start, the only ones the scatters need
    # (an active set is always a subset): the other slots would all land on
    # one padding row, whose run of adds the card makes one after another
    obs_idx = torch.nonzero(obs_ok0.reshape(-1)).squeeze(1)
    cidx = diag[:, None].expand(C, N).reshape(-1)[obs_idx]

    def total_chi2(cam_pose, pt_xyz, pl_coeff, active):
        r, _, _, stereo, behind = _residuals(prob, cam_pose, pt_xyz, cam,
                                             jac=False)
        c2 = torch.sum(r * r, dim=-1) * prob.obs_inv_sigma2
        delta2 = torch.where(stereo, cfg.chi2_stereo, cfg.chi2_mono)
        c2r = torch.where(c2 <= delta2, c2,
                          2.0 * torch.sqrt(delta2 * c2) - delta2)
        total = torch.sum(c2r * active.float() * (1.0 - behind.float()))
        if plane_free is not None:
            total = total + _plane_free_terms(cam_pose, pl_coeff, plane_free,
                                              cfg)[-1]
        return total

    def gn_iter(cam_pose, pt_xyz, pl_coeff, active, lam: float):
        r, J_c, J_p, stereo, behind = _residuals(prob, cam_pose, pt_xyz, cam)
        w, _ = _weights(r, stereo, behind, prob, active, cfg)
        w_c = w * free_cam[:, None]
        Hcc = torch.einsum("cnri,cn,cnrj->cij", J_c, w_c, J_c)
        bc = -torch.einsum("cnri,cn,cnr->ci", J_c, w_c, r)
        if plane_free is not None:
            L = pl_coeff.shape[0]
            (r_ang, r_dst, w_pl, Jca, Jcd, Jpa, Jpd,
             _) = _plane_free_terms(cam_pose, pl_coeff, plane_free, cfg)
            ai, di = cfg.plane_angle_info, cfg.plane_dist_info
            w_plc = w_pl * free_cam[:, None]
            Hcc = Hcc + (ai * torch.einsum("cfri,cf,cfrj->cij", Jca, w_plc,
                                           Jca)
                         + di * torch.einsum("cfi,cf,cfj->cij", Jcd, w_plc,
                                             Jcd))
            bc = bc - (ai * torch.einsum("cfri,cf,cfr->ci", Jca, w_plc, r_ang)
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
        # point blocks, one padding row P for the inactive observations
        flat_pid = torch.where(active, prob.obs_pt.long(),
                               P).reshape(-1)[obs_idx]
        JtWJ_p = torch.einsum("cnri,cn,cnrj->cnij", J_p, w, J_p)
        JtWr_p = torch.einsum("cnri,cn,cnr->cni", J_p, w, r)
        Hpp = _scatter_sum(P + 1, flat_pid,
                           JtWJ_p.reshape(-1, 3, 3)[obs_idx])[:P]
        bp = -_scatter_sum(P + 1, flat_pid, JtWr_p.reshape(-1, 3)[obs_idx])[:P]
        Hpp = Hpp + (lam + 1e-6) * eye3
        Hpp_inv = torch.where(prob.pt_valid[:, None, None], _inv3x3(Hpp),
                              0.0)
        # Hcp = JcᵀWJp per observation, scattered into [C, P, 6, 3] (the
        # JAX chunked scan's sums in one piece), then laid out [6C, P, 3]
        Y = torch.einsum("cnri,cn,cnrj->cnij", J_c, w_c, J_p)
        A = _scatter_sum((C, P + 1), (cidx, flat_pid),
                         Y.reshape(-1, 6, 3)[obs_idx])[:, :P]
        A2 = A.permute(0, 2, 1, 3).reshape(C * 6, P, 3)
        del A
        AH2 = torch.einsum("xpj,pjk->xpk", A2, Hpp_inv).reshape(C * 6, P * 3)
        A2 = A2.reshape(C * 6, P * 3)
        S = -(AH2 @ A2.T).reshape(C, 6, C, 6).permute(0, 2, 1, 3)
        S[diag, diag] += Hcc
        rhs = bc - (AH2 @ bp.reshape(-1)).reshape(C, 6)
        del AH2
        if plane_free is not None:
            S = S - torch.einsum("clij,ljk,dlmk->cdim", Acl, Hll_inv, Acl)
            rhs = rhs - torch.einsum("clij,ljk,lk->ci", Acl, Hll_inv, bl)
        # anchor fixed / invalid cameras: identity rows
        S = S * free_cam[:, None, None, None] * free_cam[None, :, None, None]
        S[diag, diag] += eye6 * (1.0 - free_cam)[:, None, None] + eye6 * lam
        rhs = rhs * free_cam[:, None]
        M = S.permute(0, 2, 1, 3).reshape(C * 6, C * 6)
        delta_c = torch.linalg.solve(M, rhs.reshape(-1)).reshape(C, 6)
        good = torch.isfinite(delta_c).all()
        delta_c = torch.where(good, delta_c, 0.0)
        t = bp - (delta_c.reshape(-1) @ A2).reshape(P, 3)
        delta_p = torch.einsum("pij,pj->pi", Hpp_inv, t)
        delta_p = torch.clamp(torch.where(good & prob.pt_valid[:, None],
                                          delta_p, 0.0), -10.0, 10.0)
        if plane_free is not None:
            t_l = bl - torch.einsum("clij,ci->lj", Acl, delta_c)
            delta_l = torch.einsum("lij,lj->li", Hll_inv, t_l)
            delta_l = torch.where(good & plane_free.pl_free[:, None],
                                  torch.clamp(delta_l, -2.0, 2.0), 0.0)
            pl_coeff = plane_retract(pl_coeff, delta_l)
        return (lie.se3_retract(cam_pose, delta_c), pt_xyz + delta_p,
                pl_coeff)

    def run_phase(state, active, iters):
        return _lm_phase(state, lambda st: total_chi2(*st, active),
                         lambda st, lam: gn_iter(*st, active, lam),
                         iters, damping, 1e-4)

    def classify(state):
        r, _, _, stereo, behind = _residuals(prob, state[0], state[1], cam,
                                             jac=False)
        chi2 = torch.sum(r * r, dim=-1) * prob.obs_inv_sigma2
        thr = torch.where(stereo, cfg.chi2_stereo, cfg.chi2_mono)
        return obs_ok0 & (chi2 <= thr) & (~behind), chi2

    state = (prob.cam_pose, prob.pt_xyz, pl0)
    state = run_phase(state, obs_ok0, n_iters1)
    inlier, _ = classify(state)
    state = run_phase(state, inlier, n_iters2)
    inlier, chi2 = classify(state)
    return BAResult(cam_pose=state[0], pt_xyz=state[1], obs_inlier=inlier,
                    chi2=torch.sum(torch.where(inlier, chi2, 0.0)),
                    pl_coeff=state[2] if plane_free is not None else None)
