"""Offline visualization: matplotlib image files (port of
`eao_fusion_tpu/utils/viz.py`).

In place of the reference's Pangolin / HighGUI viewer thread
(`src/Viewer.cc`, `src/MapDrawer.cc`, `src/FrameDrawer.cc`) the same content
is written as image files: the map top view with the trajectory, points,
plane boundaries and object cuboids, and per-frame overlays with keypoints,
detector boxes and the map objects' projected quadrics (the reference's
`mQuadricImage`). Matplotlib is imported inside each function, so the
package imports without it.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from eao_fusion_tpu_torch.ops import lie
from eao_fusion_tpu_torch.types import to_numpy


def _mpl():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _twc(tcw) -> np.ndarray:
    return lie.se3_inverse(torch.from_numpy(
        np.array(tcw, np.float32))).numpy()


def _save(fig, plt, path: str) -> None:
    fig.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path)
    plt.close(fig)


def draw_frame_overlay(path: str, gray: np.ndarray, feats=None,
                       kp_pt=None, boxes: Optional[np.ndarray] = None,
                       title: str = "") -> None:
    """Keypoint and detection overlay (FrameDrawer::DrawFrame role)."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(8, 6), dpi=90)
    ax.imshow(gray, cmap="gray", vmin=0, vmax=1)
    if feats is not None:
        uv = to_numpy(feats.uv)
        valid = to_numpy(feats.valid)
        tracked = (to_numpy(kp_pt) >= 0) if kp_pt is not None else \
            np.zeros(len(uv), bool)
        ax.scatter(uv[valid & ~tracked, 0], uv[valid & ~tracked, 1],
                   s=4, c="tab:blue", alpha=0.6, label="keypoints")
        ax.scatter(uv[valid & tracked, 0], uv[valid & tracked, 1],
                   s=6, c="tab:green", label="tracked")
    if boxes is not None and len(boxes):
        for b in boxes:
            cls, x, y, w, h = b[0], b[1], b[2], b[3], b[4]
            ax.add_patch(plt.Rectangle((x, y), w, h, fill=False,
                                       ec="tab:red", lw=1.5))
            ax.text(x, y - 3, f"{int(cls)}", color="tab:red", fontsize=8)
    ax.set_title(title)
    ax.set_axis_off()
    _save(fig, plt, path)


def draw_map_topview(path: str, system, gt_tcw: Optional[np.ndarray] = None
                     ) -> None:
    """x / z top view: trajectory, map points, plane boundaries, object
    cuboids (MapDrawer::DrawObject / DrawMapPlanes roles)."""
    plt = _mpl()
    m = system.map
    fig, ax = plt.subplots(figsize=(8, 8), dpi=100)

    pts = to_numpy(m.pt_xyz)
    ok = to_numpy(m.pt_valid)
    ax.scatter(pts[ok, 0], pts[ok, 2], s=1, c="0.6", label="map points")

    est = system.trajectory_tcw()
    if len(est):
        twc = _twc(est)
        ax.plot(twc[:, 4], twc[:, 6], "-", c="tab:green", lw=1.5,
                label="estimate")
    if gt_tcw is not None and len(gt_tcw):
        twc = _twc(gt_tcw)
        ax.plot(twc[:, 4], twc[:, 6], "--", c="tab:orange", lw=1.0,
                label="ground truth")

    bd = to_numpy(m.pl_boundary)
    bok = to_numpy(m.pl_boundary_valid)
    pvalid = to_numpy(m.pl_valid)
    for li in range(bd.shape[0]):
        if pvalid[li] and bok[li].any():
            b = bd[li][bok[li]]
            ax.scatter(b[:, 0], b[:, 2], s=3, alpha=0.5,
                       label="plane" if li == 0 else None)

    ot = getattr(system, "objects", None)
    if ot is not None:
        ov = to_numpy(ot.valid)
        cmin = to_numpy(ot.cub_min)
        cmax = to_numpy(ot.cub_max)
        for o in range(len(ov)):
            if not ov[o]:
                continue
            x0, z0 = cmin[o, 0], cmin[o, 2]
            x1, z1 = cmax[o, 0], cmax[o, 2]
            ax.add_patch(plt.Rectangle((x0, z0), x1 - x0, z1 - z0,
                                       fill=False, ec="tab:red", lw=1.5))
            ax.text(x0, z0, f"obj{o}", color="tab:red", fontsize=8)

    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_aspect("equal")
    ax.legend(loc="upper right", fontsize=8)
    ax.set_title(f"map: {int(to_numpy(m.kf_valid).sum())} KFs, "
                 f"{int(ok.sum())} points")
    _save(fig, plt, path)


def quadric_conics(system, pose: Optional[np.ndarray] = None):
    """The map objects' ellipsoids projected into the camera at `pose`
    (Tcw [7]; the tracker's pose by default), as in
    `Tracking::DrawQuadricProject` (`src/Tracking.cc:3164`): the dual
    quadric Q* = T diag(1, 1, 1, -1) T^T with T = [diag(s) c], the image
    conic C* = P Q* P^T. Returns [(object id, conic C = C*^-1 normalized,
    projected centre (u, v) or None)], skipping objects behind the camera
    and degenerate conics."""
    cfg = system.cfg
    m_pose = to_numpy(pose if pose is not None else system.track.pose)
    R = lie.quat_to_rotmat(torch.from_numpy(
        np.asarray(m_pose[:4], np.float32))).numpy().astype(np.float64)
    t = np.asarray(m_pose[4:7], np.float64)
    K = np.array([[cfg.camera.fx, 0, cfg.camera.cx],
                  [0, cfg.camera.fy, cfg.camera.cy],
                  [0, 0, 1.0]])
    P = K @ np.concatenate([R, t[:, None]], axis=1)        # [3, 4]
    out = []
    ot = getattr(system, "objects", None)
    if ot is None:
        return out
    ov = to_numpy(ot.valid)
    cmin = to_numpy(ot.cub_min)
    cmax = to_numpy(ot.cub_max)
    cen = to_numpy(ot.center)
    for o in np.where(ov)[0]:
        s = np.maximum((cmax[o] - cmin[o]) / 2.0, 1e-3)
        Tq = np.eye(4)
        Tq[:3, :3] = np.diag(s)
        Tq[:3, 3] = cen[o]
        Qs = Tq @ np.diag([1.0, 1.0, 1.0, -1.0]) @ Tq.T
        Cs = P @ Qs @ P.T                                  # dual conic
        xc = R @ cen[o] + t
        if xc[2] < 0.3 or abs(np.linalg.det(Cs)) < 1e-12:
            continue
        Cc = np.linalg.inv(Cs)
        u = P @ np.r_[cen[o], 1.0]
        out.append((int(o), Cc / np.linalg.norm(Cc),
                    (u[0] / u[2], u[1] / u[2]) if u[2] > 0 else None))
    return out


def draw_quadric_overlay(path: str, gray: np.ndarray, system,
                         pose: Optional[np.ndarray] = None,
                         title: str = "") -> None:
    """The map objects' projected quadrics over the frame, drawn as the
    zero level set of x^T C x (`quadric_conics`)."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(8, 6), dpi=90)
    ax.imshow(gray, cmap="gray", vmin=0, vmax=1)
    H, W = gray.shape
    xs, ys = np.meshgrid(np.linspace(0, W - 1, 240),
                         np.linspace(0, H - 1, 180))
    for o, Cc, uv in quadric_conics(system, pose):
        val = (Cc[0, 0] * xs ** 2 + Cc[1, 1] * ys ** 2 + Cc[2, 2]
               + 2 * Cc[0, 1] * xs * ys + 2 * Cc[0, 2] * xs
               + 2 * Cc[1, 2] * ys)
        ax.contour(xs, ys, val, levels=[0.0], colors="tab:red",
                   linewidths=1.5)
        if uv is not None:
            ax.text(uv[0], uv[1], f"obj{o}", color="tab:red", fontsize=8)
    ax.set_title(title or "quadric projection")
    ax.set_axis_off()
    _save(fig, plt, path)
