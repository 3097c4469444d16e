"""Per-edge pass of the local-BA LM iteration (port of
`eao_fusion_tpu/solvers/ba_edge_pallas.py`).

For every edge: residual r[3], Huber weight, camera Jacobian J_c[3,6]
masked by the free-camera flag, point Jacobian J_p[3,3], and the packed
Gram payloads the Schur assembly consumes —
    pay_c [42] = (J_cᵀ W J_c)(36) ‖ (J_cᵀ W r)(6)
    pay_p [12] = (J_pᵀ W J_p)(9)  ‖ (J_pᵀ W r)(3)
    Y     [18] = (J_cᵀ W J_p)
— channel-major [ch, E] as the Pallas kernel returns them (its docstring's
[E, 42] is wrong); and a chi2-only variant: robust masked chi2, raw chi2,
behind-camera flag, [3, E].

Unlike the Pallas kernel, which reads a [20, E] block that one-hot matmuls
assembled, the camera and point are gathered by index: the inputs are the
camera poses [C, 7], the window points [Pw, 3] and the edge list.

`edge_pass_full` / `edge_pass_chi2` launch `csrc/ba_edge.cu` for CUDA
tensors and run the plain PyTorch version for CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from eao_fusion_tpu_torch import kernels
from eao_fusion_tpu_torch.ops import lie


class EdgeInputs(NamedTuple):
    """What the edge pass reads: cameras, window points and the edge list."""
    cam_pose: torch.Tensor     # [C, 7] Tcw
    pt_xyz: torch.Tensor       # [Pw, 3]
    obs_cam: torch.Tensor      # [E] int32
    obs_pt: torch.Tensor       # [E] int32 (clamped into range)
    obs_uv: torch.Tensor       # [E, 2]
    obs_ur: torch.Tensor       # [E]
    obs_inv_sigma2: torch.Tensor  # [E]
    free_cam: torch.Tensor     # [C] f32 0/1


def _edge_math(x: EdgeInputs, active, cam, chi2_mono, chi2_stereo):
    """Shared per-edge math (`_edge_math`). Returns (r [E,3], J [E,3,9],
    w, c2, delta2, mask, behind)."""
    fx, fy, cx, cy, bf = cam
    C, Pw = x.cam_pose.shape[0], x.pt_xyz.shape[0]
    ci = torch.clamp(x.obs_cam.long(), 0, C - 1)
    pi = torch.clamp(x.obs_pt.long(), 0, Pw - 1)
    pose = x.cam_pose[ci]
    R = lie.quat_to_rotmat(pose[:, :4])                       # [E, 3, 3]
    p0, p1, p2 = x.pt_xyz[pi].unbind(-1)
    # term by term, in the order of csrc/ba_edge.cu
    px = R[:, 0, 0] * p0 + R[:, 0, 1] * p1 + R[:, 0, 2] * p2 + pose[:, 4]
    py = R[:, 1, 0] * p0 + R[:, 1, 1] * p1 + R[:, 1, 2] * p2 + pose[:, 5]
    zr = R[:, 2, 0] * p0 + R[:, 2, 1] * p1 + R[:, 2, 2] * p2 + pose[:, 6]
    xc = torch.stack([px, py, zr], dim=-1)
    z = torch.clamp(zr, min=1e-6)
    iz = 1.0 / z
    iz2 = iz * iz
    u = fx * px * iz + cx
    v = fy * py * iz + cy
    urr = u - bf * iz
    s = (x.obs_ur >= 0.0).float()
    r = torch.stack([x.obs_uv[:, 0] - u, x.obs_uv[:, 1] - v,
                     s * (x.obs_ur - urr)], dim=-1)
    c2 = torch.sum(r * r, dim=-1) * x.obs_inv_sigma2
    delta2 = s * chi2_stereo + (1.0 - s) * chi2_mono
    w_rob = torch.clamp(torch.sqrt(delta2 / torch.clamp(c2, min=1e-12)),
                        max=1.0)
    behind = (zr < 1e-3).float()
    mask = active * (1.0 - behind)
    w = x.obs_inv_sigma2 * w_rob * mask

    zero = torch.zeros_like(z)
    du = torch.stack([fx * iz, zero, -fx * px * iz2], dim=-1)
    dv = torch.stack([zero, fy * iz, -fy * py * iz2], dim=-1)
    dur = torch.stack([s * du[:, 0], zero, s * (du[:, 2] + bf * iz2)],
                      dim=-1)
    dproj = torch.stack([du, dv, dur], dim=-2)                 # [E, 3, 3]
    eye = torch.eye(3, dtype=xc.dtype, device=xc.device).expand(
        xc.shape[:1] + (3, 3))
    fm = x.free_cam[ci][:, None, None]
    J_c = -(dproj @ torch.cat([-lie.so3_hat(xc), eye], dim=-1)) * fm
    J_p = -(dproj @ R)
    return r, torch.cat([J_c, J_p], dim=-1), w, c2, delta2, mask, behind


def edge_pass_full_plain(x: EdgeInputs, active: torch.Tensor, *, cam,
                         chi2_mono: float, chi2_stereo: float
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(pay_c [42, E], pay_p [12, E], Y [18, E])."""
    r, J, w, _, _, _, _ = _edge_math(x, active, cam, chi2_mono, chi2_stereo)
    E = r.shape[0]
    G = torch.einsum("eri,e,erj->eij", J, w, J)                # [E, 9, 9]
    g = torch.einsum("eri,e,er->ei", J, w, r)                  # [E, 9]
    pay_c = torch.cat([G[:, :6, :6].reshape(E, 36), g[:, :6]], dim=-1)
    pay_p = torch.cat([G[:, 6:, 6:].reshape(E, 9), g[:, 6:]], dim=-1)
    y = G[:, :6, 6:].reshape(E, 18)
    return pay_c.T.contiguous(), pay_p.T.contiguous(), y.T.contiguous()


def edge_pass_chi2_plain(x: EdgeInputs, active: torch.Tensor, *, cam,
                         chi2_mono: float, chi2_stereo: float
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(robust masked chi2 [E], raw chi2 [E], behind flag [E] f32)."""
    _, _, _, c2, delta2, mask, behind = _edge_math(x, active, cam, chi2_mono,
                                                   chi2_stereo)
    c2r = torch.where(c2 <= delta2, c2,
                      2.0 * torch.sqrt(delta2 * c2) - delta2)
    return c2r * mask, c2, behind


def _launch(mode: int, x: EdgeInputs, active: torch.Tensor, cam,
            chi2_mono: float, chi2_stereo: float, outs):
    C, Pw, E = x.cam_pose.shape[0], x.pt_xyz.shape[0], x.obs_cam.shape[0]
    f32, i32 = torch.float32, torch.int32
    for t, name, dt, shape in (
            (x.cam_pose, "cam_pose", f32, (C, 7)),
            (x.pt_xyz, "pt_xyz", f32, (Pw, 3)),
            (x.obs_cam, "obs_cam", i32, (E,)),
            (x.obs_pt, "obs_pt", i32, (E,)),
            (x.obs_uv, "obs_uv", f32, (E, 2)),
            (x.obs_ur, "obs_ur", f32, (E,)),
            (x.obs_inv_sigma2, "obs_inv_sigma2", f32, (E,)),
            (x.free_cam, "free_cam", f32, (C,)),
            (active, "active", f32, (E,))):
        kernels.require(t, name, dt, shape)
    if C < 1 or Pw < 1:
        raise ValueError("edge pass needs at least one camera and one point")
    ptrs = [o.data_ptr() for o in outs] + [0] * (3 - len(outs))
    fx, fy, cx, cy, bf = (float(c) for c in cam)
    lib = kernels.library("ba_edge")
    err = lib.ba_edge_launch(
        mode, x.cam_pose.data_ptr(), C, x.pt_xyz.data_ptr(), Pw,
        x.obs_cam.data_ptr(), x.obs_pt.data_ptr(), x.obs_uv.data_ptr(),
        x.obs_ur.data_ptr(), x.obs_inv_sigma2.data_ptr(),
        x.free_cam.data_ptr(), active.data_ptr(), E, fx, fy, cx, cy, bf,
        float(chi2_mono), float(chi2_stereo), *ptrs,
        kernels.stream_ptr(x.cam_pose.device))
    kernels.check(err, "ba_edge_launch")


def edge_pass_full(x: EdgeInputs, active: torch.Tensor, *, cam,
                   chi2_mono: float, chi2_stereo: float
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full edge pass: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if not x.cam_pose.is_cuda:
        return edge_pass_full_plain(x, active, cam=cam, chi2_mono=chi2_mono,
                                    chi2_stereo=chi2_stereo)
    E, dev = x.obs_cam.shape[0], x.cam_pose.device
    outs = (torch.empty((42, E), device=dev),
            torch.empty((12, E), device=dev),
            torch.empty((18, E), device=dev))
    _launch(0, x, active, cam, chi2_mono, chi2_stereo, outs)
    kernels.launches["ba_edge_full"] += 1
    return outs


def edge_pass_chi2(x: EdgeInputs, active: torch.Tensor, *, cam,
                   chi2_mono: float, chi2_stereo: float
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Chi2 edge pass: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if not x.cam_pose.is_cuda:
        return edge_pass_chi2_plain(x, active, cam=cam, chi2_mono=chi2_mono,
                                    chi2_stereo=chi2_stereo)
    E, dev = x.obs_cam.shape[0], x.cam_pose.device
    out = torch.empty((3, E), device=dev)
    _launch(1, x, active, cam, chi2_mono, chi2_stereo, (out,))
    kernels.launches["ba_edge_chi2"] += 1
    return out[0], out[1], out[2]
