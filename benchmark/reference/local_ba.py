"""Plain reference of one local bundle adjustment (ORB-SLAM2's
`Optimizer::LocalBundleAdjustment` as the port states it): a window of
cameras (free, fixed or absent) and points observed by an edge list, each
edge a reprojection with a virtual right coordinate where it is stereo,
Huber-robust (5.991 / 7.815), with fixed-plane factors on the cameras.

Two Levenberg-Marquardt phases (at most `n_iters1` and `n_iters2`
iterations) with an outlier gate between them: an edge stays when its raw
chi2 is under its gate and its point lies in front of the camera. A phase
tries a step at damping lambda, keeps it if the cost falls (lambda halves,
to no less than 1e-6) or drops it (lambda times 5, to no more than 1e3),
and ends after two iterations in a row without a relative gain of `ftol`.
A step solves the Gauss-Newton normal equations of the robust cost, the
points eliminated by their Schur complement: lambda + 1e-6 on each point
block, lambda on each free camera block, fixed cameras held; where
several edges join one camera and one point, the coupling of the two is
taken from one of them, the last in the edge list (as the port states
it, after the JAX package's scatter). A point step is clamped to ±10 m
and a step whose camera part is not finite is dropped. The plane factors
add their cost, capped at the gate, and their Huber-weighted normal
equations (up to four times the gate) on free cameras; a measurement is
turned to face its predicted normal first.

Plain torch, dense per camera and per point, in the dtype it is given:
float64 for the reference, bfloat16 for the control (its linear solve in
float32)."""

from __future__ import annotations

import torch

from . import lie


def _edges(cam_pose, pt_xyz, e, cam):
    """Per edge: residual [E, 3], camera and point Jacobians [E, 3, 6] /
    [E, 3, 3], raw chi2, stereo flag, behind flag."""
    fx, fy, cx, cy, bf = cam
    pose = cam_pose[e["cam"]]
    R = lie.rotmat(pose[:, :4])
    xc = (R @ pt_xyz[e["pt"]][..., None])[..., 0] + pose[:, 4:7]
    x, y = xc[:, 0], xc[:, 1]
    z = torch.clamp(xc[:, 2], min=1e-6)
    u = fx * x / z + cx
    v = fy * y / z + cy
    st = e["stereo"]
    o = torch.zeros_like(z)
    r = torch.stack([e["uv"][:, 0] - u, e["uv"][:, 1] - v,
                     torch.where(st, e["ur"] - (u - bf / z), o)], -1)
    du = torch.stack([fx / z, o, -fx * x / z ** 2], -1)
    dv = torch.stack([o, fy / z, -fy * y / z ** 2], -1)
    dur = torch.where(st[:, None], du + torch.stack([o, o, bf / z ** 2], -1),
                      torch.zeros_like(du))
    dproj = torch.stack([du, dv, dur], -2)
    eye = torch.eye(3, dtype=xc.dtype, device=xc.device).expand(
        xc.shape[0], 3, 3)
    Jc = -(dproj @ torch.cat([-lie.hat(xc), eye], -1))
    Jp = -(dproj @ R)
    chi2 = (r * r).sum(-1) * e["is2"]
    return r, Jc, Jp, chi2, xc[:, 2] < 1e-3


def _planes(cam_pose, block, p):
    """(cost, H [C, 6, 6], g [C, 6]) of the fixed-plane factors."""
    plane_w, meas, valid = block
    ai, di, gate = p["plane_angle_info"], p["plane_dist_info"], p["plane_chi2"]
    R = lie.rotmat(cam_pose[:, :4])
    n_c = torch.einsum("cij,cfj->cfi", R, plane_w[..., :3])
    d_c = plane_w[..., 3] - torch.einsum("cfi,ci->cf", n_c, cam_pose[:, 4:7])
    n_m, d_m = meas[..., :3], meas[..., 3]
    flip = (n_c * n_m).sum(-1) < 0
    n_m = torch.where(flip[..., None], -n_m, n_m)
    d_m = torch.where(flip, -d_m, d_m)
    ra = torch.linalg.cross(n_c, n_m)
    rd = d_c - d_m
    chi2 = ai * (ra * ra).sum(-1) + di * rd * rd
    cost = torch.where(valid, torch.clamp(chi2, max=gate),
                       torch.zeros_like(chi2)).sum()
    w = (valid & (chi2 <= 4 * gate)).to(chi2.dtype) * torch.clamp(
        torch.sqrt(gate / torch.clamp(chi2, min=1e-12)), max=1.0)
    Ja = torch.cat([lie.hat(n_m) @ lie.hat(n_c),
                    torch.zeros(n_c.shape + (3,), dtype=n_c.dtype,
                                device=n_c.device)], -1)
    Jd = torch.cat([torch.zeros_like(n_c), -n_c], -1)
    H = (ai * torch.einsum("cfri,cf,cfrj->cij", Ja, w, Ja)
         + di * torch.einsum("cfi,cf,cfj->cij", Jd, w, Jd))
    g = (ai * torch.einsum("cfri,cf,cfr->ci", Ja, w, ra)
         + di * torch.einsum("cfi,cf,cf->ci", Jd, w, rd))
    return cost, H, g


def _robust(chi2, d2):
    return torch.where(chi2 <= d2, chi2, 2 * torch.sqrt(d2 * chi2) - d2)


def solve(prob: dict, plane_block, cam, p: dict, n_iters1: int,
          n_iters2: int, damping: float, ftol: float,
          dtype=torch.float64):
    """(camera poses [C, 7], points [Pw, 3]) after the two phases. `prob`
    holds the problem's tensors by the names of the port's BACooProblem;
    `plane_block` is (plane_w [C, F, 4], meas_c [C, F, 4], valid [C, F])
    or None; `p` the solver's gates and plane information."""
    c = lambda t: t.to(dtype)                                 # noqa: E731
    cam = tuple(float(x) for x in cam)
    C, Pw = prob["cam_pose"].shape[0], prob["pt_xyz"].shape[0]
    dev = prob["cam_pose"].device
    cam_valid = prob["cam_valid"]
    free = cam_valid & ~prob["cam_fixed"]
    pt_free = prob["pt_valid"]
    ok0 = (prob["obs_valid"] & (prob["obs_pt"] >= 0)
           & cam_valid[prob["obs_cam"].long()])
    idx = torch.nonzero(ok0)[:, 0]
    e = dict(cam=prob["obs_cam"].long()[idx], pt=prob["obs_pt"].long()[idx],
             uv=c(prob["obs_uv"][idx]), ur=c(prob["obs_ur"][idx]),
             is2=c(prob["obs_inv_sigma2"][idx]),
             stereo=prob["obs_ur"][idx] >= 0)
    d2 = torch.where(e["stereo"], p["chi2_stereo"], p["chi2_mono"]).to(dtype)
    # the one edge of each (camera, point) pair that couples them
    key = e["cam"] * Pw + e["pt"]
    last = torch.full((C * Pw,), -1, dtype=torch.long, device=dev)
    last.scatter_reduce_(0, key, torch.arange(len(idx), device=dev), "amax")
    coupling = last[key] == torch.arange(len(idx), device=dev)
    block = None if plane_block is None else (
        c(plane_block[0]), c(plane_block[1]), plane_block[2])
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    wide = torch.float64 if dtype == torch.float64 else torch.float32

    def cost(state, active):
        r, _, _, chi2, behind = _edges(*state, e, cam)
        total = (_robust(chi2, d2) * (active & ~behind).to(dtype)).sum()
        if block is not None:
            total = total + _planes(state[0], block, p)[0]
        return total

    def step(state, active, lam):
        cam_pose, pt_xyz = state
        r, Jc, Jp, chi2, behind = _edges(cam_pose, pt_xyz, e, cam)
        w = e["is2"] * torch.clamp(torch.sqrt(d2 / torch.clamp(
            chi2, min=1e-12)), max=1.0) * (active & ~behind).to(dtype)
        fm = free[e["cam"]].to(dtype)[:, None, None]
        Jc = Jc * fm
        Hcc = torch.zeros((C, 6, 6), dtype=dtype, device=dev).index_add_(
            0, e["cam"], torch.einsum("eri,e,erj->eij", Jc, w, Jc))
        gc = torch.zeros((C, 6), dtype=dtype, device=dev).index_add_(
            0, e["cam"], torch.einsum("eri,e,er->ei", Jc, w, r))
        Hpp = torch.zeros((Pw, 3, 3), dtype=dtype, device=dev).index_add_(
            0, e["pt"], torch.einsum("eri,e,erj->eij", Jp, w, Jp))
        gp = torch.zeros((Pw, 3), dtype=dtype, device=dev).index_add_(
            0, e["pt"], torch.einsum("eri,e,er->ei", Jp, w, r))
        Hcp = torch.zeros((C, Pw, 6, 3), dtype=dtype, device=dev)
        Hcp.index_put_((e["cam"][coupling], e["pt"][coupling]),
                       torch.einsum("eri,e,erj->eij", Jc[coupling],
                                    w[coupling], Jp[coupling]))
        if block is not None:
            _, Hpl, gpl = _planes(cam_pose, block, p)
            Hcc = Hcc + Hpl * free.to(dtype)[:, None, None]
            gc = gc + gpl * free.to(dtype)[:, None]
        bc, bp = -gc, -gp
        Hpp = Hpp + (lam + 1e-6) * eye3
        Hinv = torch.linalg.inv(Hpp.to(wide)).to(dtype)
        Hinv = torch.where(pt_free[:, None, None], Hinv,
                           torch.zeros_like(Hinv))
        AH = torch.einsum("cpij,pjk->cpik", Hcp, Hinv)
        S = -torch.einsum("cpik,dpjk->cdij", AH, Hcp)
        S[torch.arange(C), torch.arange(C)] += Hcc
        rhs = bc - torch.einsum("cpik,pk->ci", AH, bp)
        fr = free.to(dtype)
        S = S * fr[:, None, None, None] * fr[None, :, None, None]
        S[torch.arange(C), torch.arange(C)] += (
            eye6 * (1 - fr)[:, None, None] + lam * eye6)
        rhs = rhs * fr[:, None]
        M = S.permute(0, 2, 1, 3).reshape(C * 6, C * 6)
        dc = torch.linalg.solve(M.to(wide), rhs.reshape(-1).to(wide)).to(
            dtype).reshape(C, 6)
        if not bool(torch.isfinite(dc).all()):
            return cam_pose, pt_xyz
        t = bp - torch.einsum("cpik,ci->pk", Hcp, dc)
        dp = torch.einsum("pij,pj->pi", Hinv, t)
        dp = torch.clamp(torch.where(pt_free[:, None], dp,
                                     torch.zeros_like(dp)), -10.0, 10.0)
        return lie.retract(cam_pose, dc), pt_xyz + dp

    def phase(state, active, iters):
        lam = float(damping)
        c_cur = float(cost(state, active))
        it = stall = 0
        while it < iters and stall < 2:
            cand = step(state, active, lam)
            c_new = float(cost(cand, active))
            accept = c_new < c_cur and c_new == c_new and abs(c_new) < 1e300
            lam = max(lam * 0.5, 1e-6) if accept else min(lam * 5.0, 1e3)
            improved = accept and c_cur - c_new >= ftol * max(c_cur, 1e-9)
            stall = 0 if improved else stall + 1
            if accept:
                state, c_cur = cand, c_new
            it += 1
        return state

    state = (c(prob["cam_pose"]), c(prob["pt_xyz"]))
    active = torch.ones_like(idx, dtype=torch.bool)
    state = phase(state, active, n_iters1)
    _, _, _, chi2, behind = _edges(*state, e, cam)
    active = (chi2 <= d2) & ~behind
    state = phase(state, active, n_iters2)
    return state
