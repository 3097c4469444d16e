"""SO(3) / SE(3) / Sim(3) operations on batched tensors (port of
`eao_fusion_tpu/ops/lie.py:30-285`).

Conventions are the JAX package's: quaternions ``[w, x, y, z]``; an SE(3)
pose is ``[qw qx qy qz tx ty tz]`` acting as ``x' = R x + t`` (Tcw); se3
tangents are ``[omega(3), v(3)]`` with the full exponential; a Sim(3)
element is ``[q(4), t(3), s]`` acting as ``x' = s R x + t``, its tangent
``[omega(3), v(3), sigma]``; every GN solver uses the left retraction
``exp(d) * T``. All functions broadcast
over leading axes and keep the input's device and dtype (f32).
"""

from __future__ import annotations

import torch

_EPS = 1e-8


# ---------------------------------------------------------------- quaternions

def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True),
                           min=_EPS)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v[..., 3] by quaternions q[..., 4]."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Shepperd's method via a 4-way select on the largest diagonal."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    one = torch.ones_like(tr)
    qw = torch.stack([one + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, one + m00 - m11 - m22, m01 + m10,
                      m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, one - m00 + m11 - m22,
                      m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21,
                      one - m00 - m11 + m22], dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)       # [..., 4(case), 4]
    scores = torch.stack([tr, m00, m11, m22], dim=-1)
    case = torch.argmax(scores, dim=-1)
    idx = case[..., None, None].expand(case.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = quat_normalize(q)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


# ----------------------------------------------------------------------- so3

def so3_hat(w: torch.Tensor) -> torch.Tensor:
    wx, wy, wz = w.unbind(-1)
    z = torch.zeros_like(wx)
    m = torch.stack([z, -wz, wy, wz, z, -wx, -wy, wx, z], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def so3_exp_quat(w: torch.Tensor) -> torch.Tensor:
    """exp: so3 tangent -> unit quaternion (stable near 0)."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    half = 0.5 * theta
    small = theta2 < 1e-8
    sinc = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    cw = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return torch.cat([cw, sinc * w], dim=-1)


def so3_log(q: torch.Tensor) -> torch.Tensor:
    """log: unit quaternion -> so3 tangent."""
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    v = q[..., 1:]
    vn = torch.linalg.norm(v, dim=-1, keepdim=True)
    theta = 2.0 * torch.atan2(vn, w)
    scale = torch.where(vn < 1e-7, 2.0 / torch.clamp(w, min=_EPS),
                        theta / torch.clamp(vn, min=_EPS))
    return scale * v


def so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian Jl(w) of SO(3)."""
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    W = so3_hat(w)
    W2 = W @ W
    I = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    small = theta2 < 1e-8
    a = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=_EPS))
    b = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta))
                    / torch.clamp(theta2 * theta, min=_EPS))
    return I + a * W + b * W2


# ----------------------------------------------------------------------- se3

def se3_identity(shape=(), device=None) -> torch.Tensor:
    p = torch.zeros(tuple(shape) + (7,), dtype=torch.float32, device=device)
    p[..., 0] = 1.0
    return p


def se3_from_Rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.cat([rotmat_to_quat(R), t], dim=-1)


def se3_matrix(p: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] homogeneous matrix."""
    R = quat_to_rotmat(p[..., :4])
    t = p[..., 4:7]
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = p.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(
        top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def se3_apply(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Apply pose to points x[..., 3]."""
    return quat_rotate(p[..., :4], x) + p[..., 4:7]


def se3_compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a*b)(x) = a(b(x))."""
    q = quat_mul(a[..., :4], b[..., :4])
    t = quat_rotate(a[..., :4], b[..., 4:7]) + a[..., 4:7]
    return torch.cat([quat_normalize(q), t], dim=-1)


def se3_inverse(p: torch.Tensor) -> torch.Tensor:
    qi = quat_conj(p[..., :4])
    ti = -quat_rotate(qi, p[..., 4:7])
    return torch.cat([qi, ti], dim=-1)


def se3_exp(tau: torch.Tensor) -> torch.Tensor:
    """exp: se3 tangent [omega(3), v(3)] -> pose (full exponential)."""
    w, v = tau[..., :3], tau[..., 3:6]
    q = so3_exp_quat(w)
    t = (so3_left_jacobian(w) @ v[..., :, None])[..., 0]
    return torch.cat([q, t], dim=-1)


def se3_log(p: torch.Tensor) -> torch.Tensor:
    w = so3_log(p[..., :4])
    Jl = so3_left_jacobian(w)
    v = torch.linalg.solve(Jl, p[..., 4:7][..., :, None])[..., 0]
    return torch.cat([w, v], dim=-1)


def se3_retract(p: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """Left-multiplicative retraction used by all GN solvers: exp(tau) * p."""
    return se3_compose(se3_exp(tau), p)


# ---------------------------------------------------------------------- sim3

def sim3_identity(shape=(), device=None) -> torch.Tensor:
    p = torch.zeros(tuple(shape) + (8,), dtype=torch.float32, device=device)
    p[..., 0] = 1.0
    p[..., 7] = 1.0
    return p


def sim3_from_se3(p: torch.Tensor, s=None) -> torch.Tensor:
    if s is None:
        s = torch.ones(p.shape[:-1] + (1,), dtype=p.dtype, device=p.device)
    else:
        s = torch.as_tensor(s, dtype=p.dtype, device=p.device).expand(
            p.shape[:-1] + (1,))
    return torch.cat([p, s], dim=-1)


def sim3_to_se3(g: torch.Tensor) -> torch.Tensor:
    """Drop the scale, translation rescaled t / s (`src/LoopClosing.cc:
    510-515`)."""
    return torch.cat([g[..., :4], g[..., 4:7] / g[..., 7:8]], dim=-1)


def sim3_apply(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return g[..., 7:8] * quat_rotate(g[..., :4], x) + g[..., 4:7]


def sim3_compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    q = quat_normalize(quat_mul(a[..., :4], b[..., :4]))
    t = a[..., 7:8] * quat_rotate(a[..., :4], b[..., 4:7]) + a[..., 4:7]
    s = a[..., 7:8] * b[..., 7:8]
    return torch.cat([q, t, s], dim=-1)


def sim3_inverse(g: torch.Tensor) -> torch.Tensor:
    qi = quat_conj(g[..., :4])
    si = 1.0 / torch.clamp(g[..., 7:8], min=_EPS)
    ti = -si * quat_rotate(qi, g[..., 4:7])
    return torch.cat([qi, ti, si], dim=-1)


def sim3_exp(tau: torch.Tensor) -> torch.Tensor:
    """exp for the sim3 tangent [omega(3), v(3), sigma]: R = exp(w),
    s = exp(sigma), t = Jl(w) v (the JAX package's simplified retraction,
    exact at sigma = 0)."""
    w, v, sig = tau[..., :3], tau[..., 3:6], tau[..., 6:7]
    q = so3_exp_quat(w)
    t = (so3_left_jacobian(w) @ v[..., :, None])[..., 0]
    return torch.cat([q, t, torch.exp(sig)], dim=-1)


def sim3_log(g: torch.Tensor) -> torch.Tensor:
    w = so3_log(g[..., :4])
    Jl = so3_left_jacobian(w)
    v = torch.linalg.solve(Jl, g[..., 4:7][..., :, None])[..., 0]
    sig = torch.log(torch.clamp(g[..., 7:8], min=_EPS))
    return torch.cat([w, v, sig], dim=-1)


def sim3_retract(g: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    return sim3_compose(sim3_exp(tau), g)


# ------------------------------------------------------------------- cameras

def project(cam_fx_fy_cx_cy: tuple, xc: torch.Tensor) -> torch.Tensor:
    """Pinhole projection of camera-frame points xc[..., 3] -> pixels."""
    fx, fy, cx, cy = cam_fx_fy_cx_cy
    z = torch.clamp(xc[..., 2:3], min=_EPS)
    return torch.cat([fx * xc[..., 0:1] / z + cx,
                      fy * xc[..., 1:2] / z + cy], dim=-1)


def backproject(cam_fx_fy_cx_cy: tuple, uv: torch.Tensor,
                depth: torch.Tensor) -> torch.Tensor:
    """Pixels + depth -> camera-frame 3D points."""
    fx, fy, cx, cy = cam_fx_fy_cx_cy
    d = depth[..., None] if depth.dim() == uv.dim() - 1 else depth
    x = (uv[..., 0:1] - cx) / fx * d
    y = (uv[..., 1:2] - cy) / fy * d
    return torch.cat([x, y, d], dim=-1)
