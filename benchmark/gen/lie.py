"""Quaternion and SE(3) arithmetic for the stream generator, in float32
numpy: quaternions [w, x, y, z], a pose [qw qx qy qz tx ty tz] acting as
x' = R x + t (Tcw). Each product is written term by term, so that the
torch renderer (`render_torch.py`), which repeats the same terms, rounds
the same way."""

from __future__ import annotations

import numpy as np

F32 = np.float32


def cross(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a, b = np.broadcast_arrays(np.asarray(a, F32), np.asarray(b, F32))
    return np.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                     a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                     a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], axis=-1)


def quat_conj(q: np.ndarray) -> np.ndarray:
    return q * np.array([1, -1, -1, -1], F32)


def quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    w = q[..., :1]
    u = q[..., 1:]
    uv = cross(u, v)
    return (v + F32(2.0) * (w * uv + cross(u, uv))).astype(F32)


def quat_to_rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = (q[..., i] for i in range(4))
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    one, two = F32(1), F32(2)
    m = np.stack([one - two * (yy + zz), two * (xy - wz), two * (xz + wy),
                  two * (xy + wz), one - two * (xx + zz), two * (yz - wx),
                  two * (xz - wy), two * (yz + wx), one - two * (xx + yy)],
                 axis=-1)
    return m.reshape(m.shape[:-1] + (3, 3)).astype(F32)


def so3_exp_quat(w: np.ndarray) -> np.ndarray:
    w = np.asarray(w, F32)
    theta2 = np.sum(w * w, axis=-1, keepdims=True)
    theta = np.sqrt(np.maximum(theta2, F32(1e-16)))
    small = theta2 < 1e-8
    sinc = np.where(small, F32(0.5) - theta2 / F32(48.0),
                    np.sin(F32(0.5) * theta) / theta)
    cw = np.where(small, F32(1.0) - theta2 / F32(8.0),
                  np.cos(F32(0.5) * theta))
    return np.concatenate([cw, sinc * w], axis=-1).astype(F32)


def se3_inverse(p: np.ndarray) -> np.ndarray:
    qi = quat_conj(p[..., :4])
    return np.concatenate([qi, -quat_rotate(qi, p[..., 4:7])], axis=-1)


def se3_apply(p: np.ndarray, x: np.ndarray) -> np.ndarray:
    return (quat_rotate(p[..., :4], x) + p[..., 4:7]).astype(F32)


def project(cam, xc: np.ndarray) -> np.ndarray:
    """Pinhole projection of camera-frame points [..., 3] -> pixels."""
    fx, fy, cx, cy = (F32(c) for c in cam)
    z = np.maximum(xc[..., 2:3], F32(1e-8))
    return np.concatenate([fx * xc[..., 0:1] / z + cx,
                           fy * xc[..., 1:2] / z + cy], axis=-1)
