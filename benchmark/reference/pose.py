"""Plain reference of one frame's pose solve (ORB-SLAM2's
`Optimizer::PoseOptimization` as the port states it): rounds of at most
`iters` Gauss-Newton iterations with Huber IRLS weights, each round ended
early once |delta| <= 1e-6; between rounds every observation is gated
again by its chi2 (5.991 mono, 7.815 stereo) and by lying in front of the
camera, every plane by its chi2 (300). Optional fixed-plane factors
(angle and distance information). The update is T <- exp(delta) T.

Plain torch in the dtype it is given: float64 for the reference; the
control runs it in bfloat16 (its 6x6 solve in float32, since no solver
takes bfloat16)."""

from __future__ import annotations

import torch

from . import lie


def _solve(H, b):
    dt = H.dtype
    wide = torch.float64 if dt == torch.float64 else torch.float32
    return torch.linalg.solve(H.to(wide), b.to(wide)).to(dt)


def _points(pose, pts_w, uv, ur, cam):
    fx, fy, cx, cy, bf = cam
    xc = lie.apply(pose, pts_w)
    x, y = xc[:, 0], xc[:, 1]
    z = torch.clamp(xc[:, 2], min=1e-6)
    u = fx * x / z + cx
    v = fy * y / z + cy
    stereo = ur >= 0
    r = torch.stack([uv[:, 0] - u, uv[:, 1] - v,
                     torch.where(stereo, ur - (u - bf / z),
                                 torch.zeros_like(u))], -1)
    o = torch.zeros_like(z)
    du = torch.stack([fx / z, o, -fx * x / z ** 2], -1)
    dv = torch.stack([o, fy / z, -fy * y / z ** 2], -1)
    dur = du + torch.stack([o, o, bf / z ** 2], -1)
    dproj = torch.stack([du, dv, torch.where(stereo[:, None], dur,
                                             torch.zeros_like(dur))], -2)
    eye = torch.eye(3, dtype=xc.dtype, device=xc.device).expand(
        xc.shape[0], 3, 3)
    J = -(dproj @ torch.cat([-lie.hat(xc), eye], -1))
    return r, J, stereo, xc[:, 2] < 1e-3


def _planes(pose, plane_w, meas_c):
    R = lie.rotmat(pose[:4])
    n_c = plane_w[:, :3] @ R.T
    d_c = plane_w[:, 3] - n_c @ pose[4:7]
    n_m, d_m = meas_c[:, :3], meas_c[:, 3]
    r_ang = torch.linalg.cross(n_c, n_m)
    r_dst = d_c - d_m
    J_ang = torch.cat([lie.hat(n_m) @ lie.hat(n_c),
                       torch.zeros_like(n_c)[..., None].expand(-1, 3, 3)], -1)
    J_dst = torch.cat([torch.zeros_like(n_c), -n_c], -1)
    return r_ang, r_dst, J_ang, J_dst


def solve(pose0, pts_w, uv, ur, inv_sigma2, valid, planes, cam, p: dict,
          dtype=torch.float64):
    """The solved pose [7]. `planes` is (plane_w [Q, 4], meas_c [Q, 4],
    valid [Q]) or None; `p` holds the schedule and gates: pose_rounds,
    pose_iters_per_round, chi2_mono, chi2_stereo, plane_angle_info,
    plane_dist_info, plane_chi2."""
    c = lambda t: t.to(dtype)                                 # noqa: E731
    pose, pts_w, uv, ur, is2 = (c(t) for t in (pose0, pts_w, uv, ur,
                                               inv_sigma2))
    cam = tuple(float(x) for x in cam)
    if planes is not None:
        pl_w, pl_m, pl_valid = c(planes[0]), c(planes[1]), planes[2]
    ai, di, pc2 = p["plane_angle_info"], p["plane_dist_info"], p["plane_chi2"]
    inlier = valid.clone()
    pl_in = None if planes is None else pl_valid.clone()
    eye6 = torch.eye(6, dtype=dtype, device=pose.device)
    for _ in range(int(p["pose_rounds"])):
        for _ in range(int(p["pose_iters_per_round"])):
            r, J, stereo, behind = _points(pose, pts_w, uv, ur, cam)
            chi2 = (r * r).sum(-1) * is2
            d2 = torch.where(stereo, p["chi2_stereo"], p["chi2_mono"]).to(
                dtype)
            rob = torch.clamp(torch.sqrt(d2 / torch.clamp(chi2, min=1e-12)),
                              max=1.0)
            w = is2 * rob * (inlier & ~behind).to(dtype)
            H = torch.einsum("mri,m,mrj->ij", J, w, J)
            b = -torch.einsum("mri,m,mr->i", J, w, r)
            if planes is not None:
                ra, rd, Ja, Jd = _planes(pose, pl_w, pl_m)
                pchi = ai * (ra * ra).sum(-1) + di * rd * rd
                hub = torch.clamp(torch.sqrt(pc2 / torch.clamp(pchi,
                                                               min=1e-12)),
                                  max=1.0)
                pw = hub * pl_in.to(dtype)
                H = (H + ai * torch.einsum("qri,q,qrj->ij", Ja, pw, Ja)
                     + di * torch.einsum("qi,q,qj->ij", Jd, pw, Jd))
                b = (b - ai * torch.einsum("qri,q,qr->i", Ja, pw, ra)
                     - di * torch.einsum("qi,q,q->i", Jd, pw, rd))
            delta = _solve(H + 1e-6 * eye6, b)
            if not bool(torch.isfinite(delta).all()):
                delta = torch.zeros_like(delta)
            pose = lie.retract(pose, delta)
            if float(torch.linalg.norm(delta.double())) <= 1e-6:
                break
        r, _, stereo, behind = _points(pose, pts_w, uv, ur, cam)
        chi2 = (r * r).sum(-1) * is2
        thr = torch.where(stereo, p["chi2_stereo"], p["chi2_mono"]).to(dtype)
        inlier = (chi2 <= thr) & valid & ~behind
        if planes is not None:
            ra, rd, _, _ = _planes(pose, pl_w, pl_m)
            pl_in = ((ai * (ra * ra).sum(-1) + di * rd * rd) <= pc2) & pl_valid
    return pose
