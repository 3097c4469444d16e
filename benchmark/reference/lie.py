"""Rotations and rigid motions for the reference, in plain torch, in the
dtype of their inputs (float64 for the reference, bfloat16-rounded for
the control): quaternions [w, x, y, z], a pose [q(4), t(3)] acting as
x' = R x + t (Tcw), tangents [omega(3), v(3)], the left retraction
exp(tau) * T."""

from __future__ import annotations

import torch


def hat(w: torch.Tensor) -> torch.Tensor:
    x, y, z = w.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([o, -z, y, z, o, -x, -y, x, o], -1).reshape(
        w.shape[:-1] + (3, 3))


def quat_mul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], -1)


def rotmat(q: torch.Tensor) -> torch.Tensor:
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(q.shape[:-1] + (3, 3))


def apply(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """p (x): [..., 7] poses on [..., 3] points."""
    return (rotmat(p[..., :4]) @ x[..., None])[..., 0] + p[..., 4:7]


def exp(tau: torch.Tensor) -> torch.Tensor:
    """The SE(3) exponential as a pose: q = exp(omega), t = Jl(omega) v."""
    w, v = tau[..., :3], tau[..., 3:6]
    th2 = (w * w).sum(-1, keepdim=True)
    th = torch.sqrt(th2)
    small = th2 < 1e-12
    ths = torch.where(small, torch.ones_like(th), th)
    half_sinc = torch.where(small, 0.5 - th2 / 48, torch.sin(ths / 2) / ths)
    q = torch.cat([torch.cos(th / 2), half_sinc * w], -1)
    W = hat(w)
    a = torch.where(small, 0.5 - th2 / 24, (1 - torch.cos(ths)) / ths ** 2)
    b = torch.where(small, 1 / 6 - th2 / 120,
                    (ths - torch.sin(ths)) / ths ** 3)
    eye = torch.eye(3, dtype=tau.dtype, device=tau.device)
    Jl = eye + a[..., None] * W + b[..., None] * (W @ W)
    return torch.cat([q, (Jl @ v[..., None])[..., 0]], -1)


def compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a ∘ b)(x) = a(b(x))."""
    q = quat_mul(a[..., :4], b[..., :4])
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return torch.cat([q, apply(a, b[..., 4:7])], -1)


def inverse(p: torch.Tensor) -> torch.Tensor:
    qi = p[..., :4] * p.new_tensor([1.0, -1.0, -1.0, -1.0])
    return torch.cat([qi, -(rotmat(qi) @ p[..., 4:7, None])[..., 0]], -1)


def retract(p: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    return compose(exp(tau), p)


def pose_gap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """max(translation gap in m, rotation gap in rad) of poses a and b."""
    a, b = a.double(), b.double()
    dt = torch.linalg.norm(a[..., 4:7] - b[..., 4:7], dim=-1)
    dq = quat_mul(a[..., :4] * a.new_tensor([1.0, -1.0, -1.0, -1.0]),
                  b[..., :4])
    ang = 2 * torch.atan2(torch.linalg.norm(dq[..., 1:], dim=-1),
                          dq[..., 0].abs())
    return torch.maximum(dt, ang)
