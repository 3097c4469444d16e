"""The benchmark's stream: a frozen numpy copy of the port's synthetic
generator (`eao_fusion_tpu_torch/io/synthetic.py`: the primitives, the
block texture, the ray cast and the box projection), kept here so that
later changes to the program cannot move the benchmark's inputs. The
scenes and their trajectories are modules of their own
(`benchmark/gen/scenes/<scene>.py`).

The textures' random draws are taken here in the generator's order.
`render_frame` is the reference ray cast that `render_torch` repeats on
the card; every dot product is written term by term in the same order in
both.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from . import lie

F32 = np.float32
TEX_SIZE = 512


@dataclass(frozen=True)
class Camera:
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float


@dataclass
class RectPrim:
    """Finite textured rectangle: origin corner and two edge vectors."""
    origin: np.ndarray
    eu: np.ndarray
    ev: np.ndarray
    tex_id: int


@dataclass
class BoxPrim:
    """Axis-aligned textured box, an object of class `class_id`."""
    lo: np.ndarray
    hi: np.ndarray
    tex_id: int
    class_id: int = 0


@dataclass
class Scene:
    rects: List[RectPrim]
    boxes: List[BoxPrim]
    textures: list       # [S, S] float32 arrays


def vec(*a) -> np.ndarray:
    """A float32 vector."""
    return np.array(a, F32)


def blocky_texture(r: np.random.Generator, size: int = TEX_SIZE) -> np.ndarray:
    """Sharp-edged multi-scale block texture."""
    tex = np.zeros((size, size), F32)
    for cells, w in ((8, 0.35), (24, 0.4), (64, 0.25)):
        grid = r.uniform(0.0, 1.0, (cells, cells)).astype(F32)
        idx = np.arange(size) * cells // size
        tex += w * grid[np.ix_(idx, idx)]
    speck = r.uniform(0.0, 1.0, (size // 4, size // 4)) > 0.92
    tex[::4, ::4][speck] = 1.0
    return np.clip(tex, 0.0, 1.0)


def textures_numpy(scene: Scene) -> np.ndarray:
    return np.stack(scene.textures)


def poses(tx, ty, tz, pitch, yaw) -> np.ndarray:
    """Tcw poses [n, 7] of camera centres (tx, ty, tz) [n] and the angles
    pitch, yaw [n] (float64 arrays, rounded to float32 here): the one
    conversion that every scene's trajectories share."""
    w = np.stack([pitch, yaw, np.zeros_like(yaw)], axis=-1).astype(F32)
    q = lie.so3_exp_quat(w)
    twc = np.concatenate([q, np.stack([tx, ty, tz], -1).astype(F32)], -1)
    return lie.se3_inverse(twc).astype(F32)


def rect_constants(rect: RectPrim):
    """(unit normal [3], |eu|², |ev|²) of a rectangle, float32."""
    nrm = np.cross(rect.eu, rect.ev).astype(F32)
    nrm = (nrm / np.linalg.norm(nrm)).astype(F32)
    return nrm, F32(rect.eu @ rect.eu), F32(rect.ev @ rect.ev)


def dot3(a, b):
    """a · b for [..., 3] arrays or tensors, term by term."""
    return a[..., 0] * b[0] + a[..., 1] * b[1] + a[..., 2] * b[2]


def ray_dirs(cam: Camera) -> np.ndarray:
    """[H * W, 3] camera-frame ray directions through pixel centres."""
    uu, vv = np.meshgrid(np.arange(cam.width, dtype=F32) + F32(0.5),
                         np.arange(cam.height, dtype=F32) + F32(0.5))
    return np.stack([(uu - F32(cam.cx)) / F32(cam.fx),
                     (vv - F32(cam.cy)) / F32(cam.fy),
                     np.ones_like(uu)], axis=-1).reshape(-1, 3)


def world_rays(cam: Camera, tcw: np.ndarray):
    """(origin [3], rotation Rwc [3, 3]) of a frame's rays."""
    twc = lie.se3_inverse(np.asarray(tcw, F32))
    return twc[4:7].astype(F32), lie.quat_to_rotmat(twc[:4])


def rotate_dirs(dirs: np.ndarray, R: np.ndarray):
    """dirs @ R.T, term by term."""
    return np.stack([dot3(dirs, R[k]) for k in range(3)], axis=-1)


def render_frame(scene: Scene, textures: np.ndarray, cam: Camera,
                 tcw: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Ray-cast one frame: (gray [H, W] in [0, 1], z-depth [H, W] in m,
    0 where no surface is hit)."""
    dirs_c = ray_dirs(cam)
    o, R = world_rays(cam, tcw)
    d = rotate_dirs(dirs_c, R)
    n = d.shape[0]
    best_t = np.full(n, np.inf, F32)
    best_uv = np.zeros((n, 2), F32)
    best_tex = np.full(n, -1, np.int32)
    for rect in scene.rects:
        nrm, lu2, lv2 = rect_constants(rect)
        denom = dot3(d, nrm)
        denom = np.where(np.abs(denom) < 1e-9, F32(1e-9), denom)
        t = dot3((rect.origin - o)[None], nrm) / denom
        rel = (o + t[:, None] * d) - rect.origin
        u = dot3(rel, rect.eu) / lu2
        vq = dot3(rel, rect.ev) / lv2
        ok = ((t > 0.05) & (u >= 0) & (u <= 1) & (vq >= 0) & (vq <= 1)
              & (t < best_t))
        best_t = np.where(ok, t, best_t)
        best_uv = np.where(ok[:, None], np.stack([u, vq], -1), best_uv)
        best_tex = np.where(ok, rect.tex_id, best_tex)
    inv = F32(1.0) / np.where(np.abs(d) < 1e-9, F32(1e-9), d)
    for box in scene.boxes:
        t0 = (box.lo - o) * inv
        t1 = (box.hi - o) * inv
        tlo = np.minimum(t0, t1)
        tmin = tlo.max(axis=1)
        tmax = np.maximum(t0, t1).min(axis=1)
        ok = (tmax > tmin) & (tmin > 0.05) & (tmin < best_t)
        rel = ((o + tmin[:, None] * d) - box.lo) / np.maximum(
            box.hi - box.lo, F32(1e-9))
        axis = np.argmax(tlo, axis=1)
        uv = np.where((axis == 0)[:, None], rel[:, [1, 2]],
                      np.where((axis == 1)[:, None], rel[:, [0, 2]],
                               rel[:, [0, 1]]))
        best_t = np.where(ok, tmin, best_t)
        best_uv = np.where(ok[:, None], uv, best_uv)
        best_tex = np.where(ok, box.tex_id, best_tex)
    S = textures.shape[1]
    ti = np.clip((best_uv * F32(S - 1)).astype(np.int32), 0, S - 1)
    gray = np.where(best_tex >= 0,
                    textures[np.clip(best_tex, 0, None), ti[:, 1], ti[:, 0]],
                    F32(0.0)).astype(F32)
    z = np.where(np.isfinite(best_t), best_t * dirs_c[:, 2], F32(0.0))
    return (gray.reshape(cam.height, cam.width),
            z.astype(F32).reshape(cam.height, cam.width))


def project_boxes(scene: Scene, cam: Camera, tcw: np.ndarray,
                  min_area: float = 400.0) -> np.ndarray:
    """Ground-truth detections: each box's corners projected and clipped
    to the image; [B, 6] rows (class, x, y, w, h, score)."""
    out = []
    for box in scene.boxes:
        corners = np.array([[x, y, z] for x in (box.lo[0], box.hi[0])
                            for y in (box.lo[1], box.hi[1])
                            for z in (box.lo[2], box.hi[2])], F32)
        pc = lie.se3_apply(np.asarray(tcw, F32), corners)
        if np.any(pc[:, 2] < 0.1):
            continue
        uv = lie.project((cam.fx, cam.fy, cam.cx, cam.cy), pc)
        x0, y0 = uv.min(axis=0)
        x1, y1 = uv.max(axis=0)
        x0, y0 = max(x0, 0.0), max(y0, 0.0)
        x1, y1 = min(x1, cam.width - 1.0), min(y1, cam.height - 1.0)
        if (x1 - x0) * (y1 - y0) < min_area:
            continue
        out.append([box.class_id, x0, y0, x1 - x0, y1 - y0, 0.95])
    return np.array(out, F32).reshape(-1, 6)
