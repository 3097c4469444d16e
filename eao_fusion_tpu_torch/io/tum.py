"""Trajectory evaluation: ATE after Horn/Umeyama alignment and RPE (numpy
copy of `eao_fusion_tpu/io/tum.py:150-209`, with the port's own quaternion
math). Dataset parsing and trajectory writing come with the I/O slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from eao_fusion_tpu_torch.ops import lie


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
