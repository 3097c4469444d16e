"""Per-edge passes of the local-BA LM iteration (port of
`eao_fusion_tpu/solvers/ba_edge_pallas.py`, with the segment sums of
`eao_fusion_tpu/solvers/ba.py:bundle_adjust_coo` that follow it).

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

Plain versions: `edge_pass_full_plain` / `edge_pass_chi2_plain` (per
edge, as the Pallas kernels), `edge_sums_plain` (the full pass followed by
the [C, 42] / [Pw, 12] segment sums; K2's function) and `chi2_sum_plain`
(Σ robust masked chi2; K3's sum). `EdgePass` binds the fixed part of a BA
call's edge problem once and runs those functions per LM step: the kernels
of `csrc/ba_edge.cu` for CUDA tensors, the plain versions for CPU tensors.
"""

from __future__ import annotations

import ctypes
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


def edge_sums_plain(x: EdgeInputs, active: torch.Tensor, tgt: torch.Tensor,
                    *, cam, chi2_mono: float, chi2_stereo: float
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The full pass and its segment sums (K2's function): (acc_c [C, 42]
    per camera, acc_p [Pw, 12] per point, Y [18, E]). `tgt` [E] is the
    point row an edge's pay_p is summed into, Pw for none."""
    payc, payp, y = edge_pass_full_plain(x, active, cam=cam,
                                         chi2_mono=chi2_mono,
                                         chi2_stereo=chi2_stereo)
    C, Pw = x.cam_pose.shape[0], x.pt_xyz.shape[0]
    acc_c = torch.zeros((C, 42), dtype=payc.dtype,
                        device=payc.device).index_add_(
        0, x.obs_cam.long(), payc.T)
    acc_p = torch.zeros((Pw + 1, 12), dtype=payp.dtype,
                        device=payp.device).index_add_(
        0, tgt.long(), payp.T)[:Pw]
    return acc_c, acc_p, y


def edge_pass_chi2_plain(x: EdgeInputs, active: torch.Tensor, *, cam,
                         chi2_mono: float, chi2_stereo: float
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(robust masked chi2 [E], raw chi2 [E], behind flag [E] f32)."""
    _, _, _, c2, delta2, mask, behind = _edge_math(x, active, cam, chi2_mono,
                                                   chi2_stereo)
    c2r = torch.where(c2 <= delta2, c2,
                      2.0 * torch.sqrt(delta2 * c2) - delta2)
    return c2r * mask, c2, behind


def chi2_sum_plain(x: EdgeInputs, active: torch.Tensor, *, cam,
                   chi2_mono: float, chi2_stereo: float) -> torch.Tensor:
    """Σ robust masked chi2 (K3's sum), a 0-d tensor."""
    return torch.sum(edge_pass_chi2_plain(x, active, cam=cam,
                                          chi2_mono=chi2_mono,
                                          chi2_stereo=chi2_stereo)[0])


def segment_layout(keys: torch.Tensor, n: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CSR layout K2 sums by: (order [E] int32, the edge ids sorted
    stably by key, so that equal keys keep edge order; start [n + 1] int32,
    where key k's run begins in `order`). Keys outside [0, n) sort last and
    belong to no run. The order depends only on the keys, so every call of
    the kernel sums in the same order."""
    keys = keys.long()
    k = torch.where((keys >= 0) & (keys < n), keys, n)
    sk, order = torch.sort(k, stable=True)
    start = torch.searchsorted(sk, torch.arange(n + 1, device=keys.device))
    return order.to(torch.int32), start.to(torch.int32)


class _Args(ctypes.Structure):
    """`BaEdgeArgs` of csrc/ba_edge.cu, field for field."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "obs_cam", "obs_pt", "tgt", "obs_uv", "obs_ur", "obs_is2",
        "free_cam", "cam_order", "cam_start", "pt_order", "pt_start",
        "acc", "y", "partials", "ticket")] + [
        (n, ctypes.c_int) for n in ("C", "Pw", "E")] + [
        (n, ctypes.c_float) for n in (
            "fx", "fy", "cx", "cy", "bf", "chi2_mono", "chi2_stereo")]


class EdgePass:
    """The edge passes of one BA call, bound once to what stays fixed: the
    edge list, uv, ur, 1/σ², the free-camera flags and the point targets.
    Per LM step only the cameras, the points and the active mask change.

    On CUDA tensors, binding checks and copies the fixed tensors, sorts
    the edges by camera and by point target (`segment_layout`: K2 sums in
    that fixed order, so a call gives the same bits every time), packs the
    pointers and the scalars into one `BaEdgeArgs`, and allocates the
    outputs and scratch; a call then checks its three tensors and
    launches. `full` and `chi2_sum` return the binding's own buffers, which
    their next call overwrites: use the result before that. `chi2_edges`
    returns fresh tensors. On CPU tensors every call runs the plain
    version, and `kernels` is never touched."""

    def __init__(self, x: EdgeInputs, tgt: torch.Tensor, *, cam,
                 chi2_mono: float, chi2_stereo: float):
        self.C, self.Pw = x.cam_pose.shape[0], x.pt_xyz.shape[0]
        self.E = x.obs_cam.shape[0]
        self._kw = dict(cam=cam, chi2_mono=chi2_mono, chi2_stereo=chi2_stereo)
        self.device = x.cam_pose.device
        if not x.cam_pose.is_cuda:
            self._x, self._tgt = x, tgt
            self._lib = None
            return
        self._bind(x, tgt)

    def _bind(self, x: EdgeInputs, tgt: torch.Tensor) -> None:
        C, Pw, E, dev = self.C, self.Pw, self.E, self.device
        f32, i32 = torch.float32, torch.int32
        lib = kernels.library("ba_edge")
        if lib.ba_edge_args_size() != ctypes.sizeof(_Args):
            raise RuntimeError("ba_edge: BaEdgeArgs differs from _Args")
        if not 1 <= C <= lib.ba_edge_max_cameras() or Pw < 1:
            raise ValueError(f"edge pass takes 1 to "
                             f"{lib.ba_edge_max_cameras()} cameras and at "
                             f"least one point, got C = {C}, Pw = {Pw}")
        fixed = {}
        for t, name, dt, shape in (
                (x.obs_cam, "obs_cam", i32, (E,)),
                (x.obs_pt, "obs_pt", i32, (E,)),
                (tgt, "tgt", i32, (E,)),
                (x.obs_uv, "obs_uv", f32, (E, 2)),
                (x.obs_ur, "obs_ur", f32, (E,)),
                (x.obs_inv_sigma2, "obs_is2", f32, (E,)),
                (x.free_cam, "free_cam", f32, (C,))):
            kernels.require_device(t, name, dev)
            t = t.to(dt).contiguous()
            kernels.require_layout(t, name, dt, shape)
            fixed[name] = t
        if fixed["obs_uv"].data_ptr() % 8:      # the kernel reads float2
            fixed["obs_uv"] = fixed["obs_uv"].clone()
        # the fixed summation order: edges by camera (clamped into range, as
        # the kernel reads them) and by point target
        fixed["cam_order"], fixed["cam_start"] = segment_layout(
            torch.clamp(fixed["obs_cam"], 0, C - 1), C)
        fixed["pt_order"], fixed["pt_start"] = segment_layout(fixed["tgt"], Pw)
        blocks = -(-E // lib.ba_edge_threads())
        self._acc = torch.empty(C * 42 + Pw * 12, dtype=f32, device=dev)
        self._acc_c = self._acc[:C * 42].view(C, 42)
        self._acc_p = self._acc[C * 42:].view(Pw, 12)
        self._y = torch.empty((18, E), dtype=f32, device=dev)
        self._sum = torch.empty((), dtype=f32, device=dev)
        self._partials = torch.empty(max(blocks, 1), dtype=f32, device=dev)
        self._ticket = torch.zeros(1, dtype=i32, device=dev)
        ptrs = dict(fixed, acc=self._acc, y=self._y,
                    partials=self._partials, ticket=self._ticket)
        fx, fy, cx, cy, bf = (float(c) for c in self._kw["cam"])
        self._args = _Args(
            **{k: t.data_ptr() for k, t in ptrs.items()}, C=C, Pw=Pw, E=E,
            fx=fx, fy=fy, cx=cx, cy=cy, bf=bf,
            chi2_mono=float(self._kw["chi2_mono"]),
            chi2_stereo=float(self._kw["chi2_stereo"]))
        self._argp = ctypes.addressof(self._args)
        self._fixed = fixed        # the pointers in _args point into these
        self._lib = lib
        self._shapes = ((C, 7), (Pw, 3), (E,))

    def _plain_inputs(self, cam_pose, pt_xyz) -> EdgeInputs:
        return self._x._replace(cam_pose=cam_pose, pt_xyz=pt_xyz)

    def _check(self, cam_pose, pt_xyz, active) -> None:
        for t, name, shape in zip((cam_pose, pt_xyz, active),
                                  ("cam_pose", "pt_xyz", "active"),
                                  self._shapes):
            if not (t.dtype == torch.float32 and t.shape == shape
                    and t.device == self.device and t.is_contiguous()):
                kernels.require_layout(t, name, torch.float32, shape)
                kernels.require_device(t, name, self.device)

    def full(self, cam_pose: torch.Tensor, pt_xyz: torch.Tensor,
             active: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(acc_c [C, 42], acc_p [Pw, 12], Y [18, E]): K2, one kernel,
        summed in the bind-time order."""
        if self._lib is None:
            return edge_sums_plain(self._plain_inputs(cam_pose, pt_xyz),
                                   active, self._tgt, **self._kw)
        self._check(cam_pose, pt_xyz, active)
        err = self._lib.ba_edge_full_launch(
            self._argp, cam_pose.data_ptr(), pt_xyz.data_ptr(),
            active.data_ptr(), kernels.stream_ptr(self.device))
        kernels.check(err, "ba_edge_full_launch")
        kernels.launches["ba_edge_full"] += 1
        return self._acc_c, self._acc_p, self._y

    def chi2_sum(self, cam_pose: torch.Tensor, pt_xyz: torch.Tensor,
                 active: torch.Tensor) -> torch.Tensor:
        """Σ robust masked chi2, a 0-d tensor: K3's sum variant, one kernel,
        summed in a fixed order (the same bits on every call)."""
        if self._lib is None:
            return chi2_sum_plain(self._plain_inputs(cam_pose, pt_xyz),
                                  active, **self._kw)
        self._check(cam_pose, pt_xyz, active)
        err = self._lib.ba_edge_chi2_launch(
            self._argp, cam_pose.data_ptr(), pt_xyz.data_ptr(),
            active.data_ptr(), self._sum.data_ptr(), None,
            kernels.stream_ptr(self.device))
        kernels.check(err, "ba_edge_chi2_launch")
        kernels.launches["ba_edge_chi2"] += 1
        return self._sum

    def chi2_edges(self, cam_pose: torch.Tensor, pt_xyz: torch.Tensor,
                   active: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(robust masked chi2 [E], raw chi2 [E], behind flag [E] f32): K3's
        per-edge variant, into fresh tensors."""
        if self._lib is None:
            return edge_pass_chi2_plain(self._plain_inputs(cam_pose, pt_xyz),
                                        active, **self._kw)
        self._check(cam_pose, pt_xyz, active)
        out = torch.empty((3, self.E), dtype=torch.float32,
                          device=self.device)
        err = self._lib.ba_edge_chi2_launch(
            self._argp, cam_pose.data_ptr(), pt_xyz.data_ptr(),
            active.data_ptr(), None, out.data_ptr(),
            kernels.stream_ptr(self.device))
        kernels.check(err, "ba_edge_chi2_launch")
        kernels.launches["ba_edge_chi2"] += 1
        return out[0], out[1], out[2]
