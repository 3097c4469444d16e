"""IMU utilities: the gravity-aligned world at initialization and the
measurement sync (numpy copy of `eao_fusion_tpu/io/imu.py`, with the port's
`ops/lie.rotmat_to_quat`).

Re-design of `ros_test/src/message_flow.cc`:
  * `gravity_init_pose` reproduces `RGBDIMessageFlow::InitIMU` (:270-308):
    Gram-Schmidt with the first accelerometer sample as the gravity axis
    (column 2 or 3 of the world rotation), giving the INIT_POSE that
    StereoInitialization consumes (ConstraintType == 2,
    `src/Tracking.cc:1276-1308`).
  * `sync_imu` reproduces `IMUSyncData` (:133-204): linear interpolation
    of accel / gyro to an image timestamp, with the staleness guards
    (0.2 s before / 0.05 s after) of `ValidData`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from eao_fusion_tpu_torch.ops import lie


def gravity_init_pose(accel: np.ndarray, gravity_axis: int = 3) -> np.ndarray:
    """First accelerometer sample [3] -> initial world pose Tcw [7]
    (rotation only). The rotation maps camera axes into a world whose
    chosen axis (2 = y, 3 = z) is anti-parallel to gravity."""
    a1 = np.asarray(accel, np.float64)
    if gravity_axis == 2:
        a2, a3 = np.array([1.0, 0, 0]), np.array([0, 0, 1.0])
    else:
        a2, a3 = np.array([1.0, 0, 0]), np.array([0, 1.0, 0])

    def nrm(v):
        return v / max(np.linalg.norm(v), 1e-12)

    b1 = nrm(a1)
    b2 = nrm(a2 - b1.dot(a2) * b1)
    b3 = nrm(a3 - b1.dot(a3) * b1 - b2.dot(a3) * b2)
    R = np.eye(3)
    if gravity_axis == 2:
        R[:, 0], R[:, 1], R[:, 2] = b2, b1, b3
    else:
        R[:, 0], R[:, 1], R[:, 2] = b2, b3, b1
    if np.linalg.det(R) < 0:
        R = -R
    q = lie.rotmat_to_quat(torch.from_numpy(R.astype(np.float32))).numpy()
    return np.concatenate([q, np.zeros(3, np.float32)])


@dataclass
class ImuSample:
    timestamp: float
    accel: np.ndarray   # [3]
    gyro: np.ndarray    # [3]


def sync_imu(samples, t_img: float, max_before: float = 0.2,
             max_after: float = 0.05) -> Optional[ImuSample]:
    """Linear interpolation of the IMU stream to an image timestamp, with
    the reference's staleness windows; None if the guards reject."""
    if not samples:
        return None
    ts = np.array([s.timestamp for s in samples])
    i = int(np.searchsorted(ts, t_img))
    if i == 0:
        s = samples[0]
        if s.timestamp - t_img > max_after:
            return None
        return ImuSample(t_img, s.accel, s.gyro)
    if i >= len(samples):
        s = samples[-1]
        if t_img - s.timestamp > max_before:
            return None
        return ImuSample(t_img, s.accel, s.gyro)
    s0, s1 = samples[i - 1], samples[i]
    # bracketed timestamps interpolate; the staleness windows only guard
    # against a stream too sparse around the image time
    if (t_img - s0.timestamp > max_before
            and s1.timestamp - t_img > max_after):
        return None
    w = (t_img - s0.timestamp) / max(s1.timestamp - s0.timestamp, 1e-9)
    return ImuSample(t_img,
                     (1 - w) * s0.accel + w * s1.accel,
                     (1 - w) * s0.gyro + w * s1.gyro)
