"""TUM RGBD dataset I/O and trajectory evaluation (numpy copy of
`eao_fusion_tpu/io/tum.py`, with the port's own quaternion math on CPU
float32 tensors).

Formats, as the reference's:
  * image lists `rgb.txt` / `depth.txt`: `timestamp path` lines, `#`
    comments;
  * ground truth `groundtruth.txt`: `timestamp tx ty tz qx qy qz qw`,
    camera-to-world (`src/Tracking.cc:187-232`);
  * trajectory output as `System::SaveTrajectoryTUM` (`src/System.cc:
    274-327`) and `System::SaveTrajectoryKITTI` (`:367-414`);
  * offline YOLO boxes `<timestamp>.txt`: `class x y w h score` rows
    (`src/Tracking.cc:476-524`).

Evaluation: absolute trajectory error after Horn/Umeyama alignment and
relative pose error.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from eao_fusion_tpu_torch.ops import lie


# ------------------------------------------------------------------- parsing

def _rows(path: str):
    """The non-empty, non-comment lines of a text file, split."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line.split()


def read_image_list(path: str) -> List[Tuple[float, str]]:
    return [(float(v[0]), v[1]) for v in _rows(path)]


def read_groundtruth(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (timestamps [N], Twc poses [N, 7] as [qw qx qy qz tx ty tz]).
    File rows are `t tx ty tz qx qy qz qw` (camera-to-world); shorter rows
    are skipped."""
    ts, poses = [], []
    for row in _rows(path):
        v = [float(x) for x in row]
        if len(v) < 8:
            continue
        ts.append(v[0])
        tx, ty, tz, qx, qy, qz, qw = v[1:8]
        poses.append([qw, qx, qy, qz, tx, ty, tz])
    return np.array(ts), np.array(poses, np.float32)


def read_accelerometer(path: str) -> List:
    """TUM `accelerometer.txt` (`t ax ay az`) -> ImuSample list, gyro
    zeroed (the reference reads only the accelerometer for the gravity
    alignment, `ros_test/src/message_flow.cc:270-308`)."""
    from eao_fusion_tpu_torch.io.imu import ImuSample
    out = []
    for row in _rows(path):
        v = [float(x) for x in row]
        if len(v) < 4:
            continue
        out.append(ImuSample(v[0], np.array(v[1:4], np.float32),
                             np.zeros(3, np.float32)))
    return out


def read_yolo_boxes(path: str) -> np.ndarray:
    """Offline detection file -> [B, 6] rows (class, x, y, w, h, score); a
    missing file is a frame without detections."""
    if not os.path.exists(path):
        return np.zeros((0, 6), np.float32)
    rows = []
    with open(path) as f:
        for line in f:
            v = line.split()
            if len(v) >= 6:
                rows.append([float(x) for x in v[:6]])
    return np.array(rows, np.float32).reshape(-1, 6)


def associate_timestamps(ts_a: np.ndarray, ts_b: np.ndarray,
                         max_dt: float = 0.02) -> List[Tuple[int, int]]:
    """Greedy nearest-timestamp association (TUM associate.py semantics):
    each entry of `ts_a` takes the nearer of its two neighbours in the
    sorted `ts_b` within `max_dt` that no earlier entry took."""
    pairs = []
    used = set()
    for i, t in enumerate(ts_a):
        j = int(np.searchsorted(ts_b, t))
        best, best_dt = -1, max_dt
        for k in (j - 1, j):
            if 0 <= k < len(ts_b) and k not in used:
                dt = abs(ts_b[k] - t)
                if dt <= best_dt:
                    best, best_dt = k, dt
        if best >= 0:
            pairs.append((i, best))
            used.add(best)
    return pairs


# ------------------------------------------------------------------- writing

def _twc(tcw) -> torch.Tensor:
    return lie.se3_inverse(torch.from_numpy(
        np.array(tcw, np.float32)).reshape(-1, 7))


def write_trajectory_tum(path: str, timestamps: Sequence[float],
                         tcw: np.ndarray) -> None:
    """Camera trajectory in TUM format (Tcw converted to Twc), rows `t tx
    ty tz qx qy qz qw` as `System::SaveTrajectoryTUM` writes them."""
    twc = _twc(tcw).numpy()
    with open(path, "w") as f:
        for t, p in zip(timestamps, twc):
            qw, qx, qy, qz, tx, ty, tz = p
            f.write(f"{t:.6f} {tx:.7f} {ty:.7f} {tz:.7f} "
                    f"{qx:.7f} {qy:.7f} {qz:.7f} {qw:.7f}\n")


def write_trajectory_kitti(path: str, tcw: np.ndarray) -> None:
    """KITTI format: 12 numbers per row, the row-major 3x4 of Twc."""
    M = lie.se3_matrix(_twc(tcw))[:, :3, :].numpy()
    with open(path, "w") as f:
        for m in M:
            f.write(" ".join(f"{x:.9e}" for x in m.reshape(-1)) + "\n")


# ---------------------------------------------------------------- evaluation


@dataclass
class TrajectoryError:
    ate_rmse: float
    ate_mean: float
    ate_median: float
    ate_max: float
    rpe_trans_rmse: float
    rpe_rot_rmse: float  # radians per step
    n_poses: int


def umeyama_alignment(src: np.ndarray, dst: np.ndarray,
                      with_scale: bool = False
                      ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Least-squares rigid (or similarity) alignment dst ≈ s R src + t;
    returns (R, t, s)."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var = (xs ** 2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / max(var, 1e-12))
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return R, t, s


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def evaluate_ate_rpe(est_tcw: np.ndarray, gt_tcw: np.ndarray,
                     align: bool = True, with_scale: bool = False,
                     rpe_delta: int = 1) -> TrajectoryError:
    """ATE on aligned camera centres + RPE over `rpe_delta`-step motions."""
    est_twc = lie.se3_inverse(_t(est_tcw)).numpy()
    gt_twc = lie.se3_inverse(_t(gt_tcw)).numpy()
    pe = est_twc[:, 4:7]
    pg = gt_twc[:, 4:7]
    if align and len(pe) >= 3:
        R, t, s = umeyama_alignment(pe, pg, with_scale)
        pe = (s * (R @ pe.T)).T + t
    err = np.linalg.norm(pe - pg, axis=1)

    d = rpe_delta
    if len(est_twc) > d:
        rel_e = lie.se3_compose(lie.se3_inverse(_t(est_twc[:-d])),
                                _t(est_twc[d:]))
        rel_g = lie.se3_compose(lie.se3_inverse(_t(gt_twc[:-d])),
                                _t(gt_twc[d:]))
        dtrans = np.linalg.norm((rel_e[:, 4:7] - rel_g[:, 4:7]).numpy(),
                                axis=1)
        drel = lie.quat_mul(lie.quat_conj(rel_g[:, :4]), rel_e[:, :4])
        drot = np.linalg.norm(lie.so3_log(drel).numpy(), axis=1)
        rpe_t = float(np.sqrt(np.mean(dtrans ** 2)))
        rpe_r = float(np.sqrt(np.mean(drot ** 2)))
    else:
        rpe_t = rpe_r = float("nan")

    return TrajectoryError(
        ate_rmse=float(np.sqrt(np.mean(err ** 2))),
        ate_mean=float(np.mean(err)),
        ate_median=float(np.median(err)),
        ate_max=float(np.max(err)),
        rpe_trans_rmse=rpe_t,
        rpe_rot_rmse=rpe_r,
        n_poses=len(err),
    )
