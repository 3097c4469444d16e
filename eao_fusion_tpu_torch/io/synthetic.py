"""Synthetic RGBD scene generator (numpy copy of
`eao_fusion_tpu/io/synthetic.py`: room and corridor scenes, ray casting,
trajectories, sequences, right-eye renders, and the sensor nuisance
model).

Plain numpy on the host; its quaternion math is the port's own
(`ops/lie.py` on CPU tensors). Renders and caches are those of the JAX
package bit for bit where the float32 math agrees, and `generate_sequence`
reads and writes the same cache files.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from eao_fusion_tpu_torch.config import CameraConfig
from eao_fusion_tpu_torch.ops import lie


def _np(fn, *arrays) -> np.ndarray:
    """Apply a port lie function to float32 numpy arrays on the CPU."""
    return fn(*(torch.from_numpy(np.ascontiguousarray(a, np.float32))
                for a in arrays)).numpy()


# ------------------------------------------------------------------ geometry

@dataclass
class RectPrim:
    """Finite textured rectangle: origin corner, two edge vectors, normal."""
    origin: np.ndarray   # [3]
    eu: np.ndarray       # [3] edge 1 (texture u axis)
    ev: np.ndarray       # [3] edge 2 (texture v axis)
    tex_id: int


@dataclass
class BoxPrim:
    """Axis-aligned textured box (an 'object' with a class id)."""
    lo: np.ndarray       # [3]
    hi: np.ndarray       # [3]
    tex_id: int
    class_id: int = 0


@dataclass
class Scene:
    rects: List[RectPrim]
    boxes: List[BoxPrim]
    textures: np.ndarray  # [T, S, S] float32 in [0,1]


@dataclass
class SyntheticFrame:
    gray: np.ndarray       # [H, W] float32 in [0,1]
    depth: np.ndarray      # [H, W] float32 meters (0 = invalid)
    tcw: np.ndarray        # [7] ground-truth world->camera pose
    timestamp: float
    boxes: np.ndarray      # [B, 6] (class, x, y, w, h, score); B may be 0


@dataclass
class SyntheticSequence:
    frames: List[SyntheticFrame]
    camera: CameraConfig
    scene: Scene

    def gt_tcw(self) -> np.ndarray:
        return np.stack([f.tcw for f in self.frames])

    def timestamps(self) -> np.ndarray:
        return np.array([f.timestamp for f in self.frames])


def _blocky_texture(r: np.random.Generator, size: int = 512) -> np.ndarray:
    """Sharp-edged multi-scale block texture: dense FAST corners everywhere."""
    tex = np.zeros((size, size), np.float32)
    for cells, w in ((8, 0.35), (24, 0.4), (64, 0.25)):
        grid = r.uniform(0.0, 1.0, (cells, cells)).astype(np.float32)
        idx = (np.arange(size) * cells // size)
        tex += w * grid[np.ix_(idx, idx)]
    # a few high-contrast speckles
    speck = r.uniform(0.0, 1.0, (size // 4, size // 4)) > 0.92
    tex[::4, ::4][speck] = 1.0
    return np.clip(tex, 0.0, 1.0)


def _voronoi_texture(r: np.random.Generator, size: int = 512,
                     n_seeds: int = 700) -> np.ndarray:
    """Aperiodic cell-noise texture: each pixel takes the value of its
    nearest random seed point. Cell borders are irregular polygons, so FAST
    corners land at Voronoi vertices with NO lattice structure — a shifted
    view cannot be self-consistent (unlike `_blocky_texture`, whose block
    grid makes 360°-revisit alignment ambiguous; see tests/test_loop_e2e)."""
    pts = r.uniform(0, size, (n_seeds, 2)).astype(np.float32)
    vals = r.uniform(0.05, 1.0, n_seeds).astype(np.float32)
    out = np.empty((size, size), np.float32)
    xs = np.arange(size, dtype=np.float32)
    for y0 in range(0, size, 64):
        yy = np.arange(y0, min(y0 + 64, size), dtype=np.float32)
        d = ((yy[:, None, None] - pts[:, 1]) ** 2
             + (xs[None, :, None] - pts[:, 0]) ** 2)
        out[y0:y0 + 64] = vals[np.argmin(d, axis=-1)]
    # high-contrast speckles at random (non-lattice) positions
    ys, xs_i = r.integers(0, size, (2, 400))
    out[ys, xs_i] = 1.0
    return out


def _class_texture(k: int) -> np.ndarray:
    """Canonical texture of object class k (fixed across scenes), so the 8
    classes are separable in GRAYSCALE — the property tools/train_yolox.py
    needs to learn the class head (random per-scene textures make class
    labels pure noise).

    The class signature is SPATIAL and LOW-FREQUENCY — k//2+1 full
    stripe cycles across the whole texture, oriented by k%2 — because it
    must survive BOTH the training-time photometric jitter (an intensity
    code does not: ±0.1 brightness shifts a band a full class step) and
    RENDERING SCALE: objects project to 40-130 px, so a fixed pixel-pitch
    stripe on the 512² texture (the round-3 12-52 px encoding) is far
    below Nyquist on screen and aliases to noise — measured as train-
    scene class accuracy 0.95 vs held-out 0.43 (the head could only
    memorize contexts). 1-4 broad bands stay readable at 40 px."""
    rc = np.random.default_rng(1000 + k)
    base = (_blocky_texture if k % 2 == 0 else _voronoi_texture)(rc)
    size = base.shape[0]
    n_cycles = (k // 2) % 4 + 1              # 1..4 cycles across the face
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    coord = xx if k % 2 == 0 else yy
    stripe = (np.sin(2.0 * np.pi * coord * n_cycles / size) > 0
              ).astype(np.float32)
    return np.clip(0.1 + 0.3 * base + 0.6 * stripe, 0.0, 1.0)


def make_room_scene(seed: int = 0, n_objects: int = 4,
                    closed: bool = False,
                    texture: str = "blocky",
                    class_textures: bool = False) -> Scene:
    """A room in the first-camera frame (x right, y down, z forward):
    floor at y=+1.2, back wall at z=+4.5, side walls, boxes on the floor.
    `closed` adds a wall behind the camera (needed for 360° spins).

    `class_textures` gives each object the CANONICAL texture of its class
    id (fixed across scenes) instead of a per-scene random texture — this
    makes class identity learnable from appearance, which the YOLOX
    training (tools/train_yolox.py) needs; default off keeps every
    existing render cache and test scene byte-identical."""
    r = np.random.default_rng(seed)
    tex_fn = _voronoi_texture if texture == "aperiodic" else _blocky_texture
    # the closed-room wall texture is drawn LAST so the RNG stream feeding
    # box geometry matches open-room scenes (keeps render caches valid)
    textures = [tex_fn(r) for _ in range(4 + n_objects)]
    if class_textures:
        for i in range(n_objects):
            textures[4 + i] = _class_texture(i % 8)

    def v(*a):
        return np.array(a, np.float32)

    rects = [
        # floor: spans x in [-3,3], z in [0.2, 4.5]
        RectPrim(v(-3.0, 1.2, 0.2), v(6.0, 0, 0), v(0, 0, 4.3), 0),
        # back wall: x in [-3,3], y in [-2,1.2]
        RectPrim(v(-3.0, -2.0, 4.5), v(6.0, 0, 0), v(0, 3.2, 0), 1),
        # left wall
        RectPrim(v(-3.0, -2.0, 0.2), v(0, 0, 4.3), v(0, 3.2, 0), 2),
        # right wall
        RectPrim(v(3.0, -2.0, 0.2), v(0, 0, 4.3), v(0, 3.2, 0), 3),
    ]
    boxes = []
    for i in range(n_objects):
        # at "table height" so their projection clears the image border
        # (the detector-edge suppression would otherwise reject them)
        cx = r.uniform(-1.5, 1.5)
        cz = r.uniform(2.9, 4.2)
        w, h, d = r.uniform(0.3, 0.55, 3)
        y_bottom = r.uniform(0.55, 0.9)
        lo = v(cx - w / 2, y_bottom - h, cz - d / 2)
        hi = v(cx + w / 2, y_bottom, cz + d / 2)
        boxes.append(BoxPrim(lo, hi, 4 + i, class_id=i % 8))
    if closed:
        wall_tex = len(textures)
        textures.append(tex_fn(r))
        rects.append(RectPrim(v(-3.0, -2.0, -1.5), v(6.0, 0, 0),
                              v(0, 3.2, 0), wall_tex))
        rects[0] = RectPrim(v(-3.0, 1.2, -1.5), v(6.0, 0, 0),
                            v(0, 0, 6.0), 0)   # floor extended backward
    return Scene(rects, boxes, np.stack(textures))


def make_corridor_scene(seed: int = 0, length_m: float = 15.0,
                        segment_m: float = 3.0, half_width: float = 1.5,
                        n_objects: int = 4) -> Scene:
    """A long corridor along +z for exploratory (non-revisiting)
    trajectories: floor and left / right wall segments every `segment_m`,
    each with its own texture, so new wall area keeps giving fresh,
    unambiguous features; boxes along the walls. The camera never
    revisits, so keyframes are never redundant and lifetime insertions
    exceed any fixed table size."""
    r = np.random.default_rng(seed)
    n_seg = int(np.ceil(length_m / segment_m)) + 1

    def v(*a):
        return np.array(a, np.float32)

    textures = []
    rects = []
    for i in range(n_seg):
        z0 = -1.0 + i * segment_m
        for (origin, eu, ev) in (
                # floor segment
                (v(-half_width, 1.2, z0), v(2 * half_width, 0, 0),
                 v(0, 0, segment_m)),
                # left wall segment
                (v(-half_width, -2.0, z0), v(0, 0, segment_m),
                 v(0, 3.2, 0)),
                # right wall segment
                (v(half_width, -2.0, z0), v(0, 0, segment_m),
                 v(0, 3.2, 0))):
            tex_fn = _blocky_texture if (len(textures) % 2 == 0) \
                else _voronoi_texture
            textures.append(tex_fn(r))
            rects.append(RectPrim(origin, eu, ev, len(textures) - 1))
    # far end wall
    textures.append(_voronoi_texture(r))
    z_end = -1.0 + n_seg * segment_m
    rects.append(RectPrim(v(-half_width, -2.0, z_end),
                          v(2 * half_width, 0, 0), v(0, 3.2, 0),
                          len(textures) - 1))
    boxes = []
    for i in range(n_objects):
        cz = r.uniform(1.0, length_m - 1.0)
        side = 1 if i % 2 == 0 else -1
        w, h, d = r.uniform(0.3, 0.5, 3)
        cx = side * (half_width - 0.4)
        y_bottom = r.uniform(0.6, 0.95)
        lo = v(cx - w / 2, y_bottom - h, cz - d / 2)
        hi = v(cx + w / 2, y_bottom, cz + d / 2)
        textures.append(_blocky_texture(r))
        boxes.append(BoxPrim(lo, hi, len(textures) - 1, class_id=i % 8))
    return Scene(rects, boxes, np.stack(textures))


# ---------------------------------------------------------------- ray casting

def _intersect_rects(o, d, rects) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batched ray/finite-rect intersection. o,d: [N,3]. Returns (t, tex_uv, tex_id)."""
    n = o.shape[0]
    best_t = np.full(n, np.inf, np.float32)
    best_uv = np.zeros((n, 2), np.float32)
    best_tex = np.full(n, -1, np.int32)
    for rect in rects:
        nrm = np.cross(rect.eu, rect.ev)
        nrm = nrm / np.linalg.norm(nrm)
        denom = d @ nrm
        denom = np.where(np.abs(denom) < 1e-9, 1e-9, denom)
        t = ((rect.origin - o) @ nrm) / denom
        hit = o + t[:, None] * d
        rel = hit - rect.origin
        lu2 = rect.eu @ rect.eu
        lv2 = rect.ev @ rect.ev
        u = (rel @ rect.eu) / lu2
        vq = (rel @ rect.ev) / lv2
        ok = (t > 0.05) & (u >= 0) & (u <= 1) & (vq >= 0) & (vq <= 1) & (t < best_t)
        best_t = np.where(ok, t, best_t)
        best_uv[ok] = np.stack([u[ok], vq[ok]], axis=-1)
        best_tex = np.where(ok, rect.tex_id, best_tex)
    return best_t, best_uv, best_tex


def _intersect_boxes(o, d, boxes) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    n = o.shape[0]
    best_t = np.full(n, np.inf, np.float32)
    best_uv = np.zeros((n, 2), np.float32)
    best_tex = np.full(n, -1, np.int32)
    inv = 1.0 / np.where(np.abs(d) < 1e-9, 1e-9, d)
    for box in boxes:
        t0 = (box.lo - o) * inv
        t1 = (box.hi - o) * inv
        tmin = np.minimum(t0, t1).max(axis=1)
        tmax = np.maximum(t0, t1).min(axis=1)
        hit_ok = (tmax > tmin) & (tmin > 0.05) & (tmin < best_t)
        t = tmin
        p = o + t[:, None] * d
        # face param: pick the two coords orthogonal to the entry axis
        entry_axis = np.argmax(np.minimum(t0, t1), axis=1)
        ext = box.hi - box.lo
        rel = (p - box.lo) / np.maximum(ext, 1e-9)
        uv = np.zeros((n, 2), np.float32)
        for ax in range(3):
            m = entry_axis == ax
            other = [a for a in range(3) if a != ax]
            uv[m] = rel[m][:, other]
        best_t = np.where(hit_ok, t, best_t)
        best_uv[hit_ok] = uv[hit_ok]
        best_tex = np.where(hit_ok, box.tex_id, best_tex)
    return best_t, best_uv, best_tex


def render_frame(scene: Scene, cam: CameraConfig, tcw: np.ndarray,
                 depth_noise: float = 0.0, rng: Optional[np.random.Generator] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Ray-cast one frame. tcw is the [7] world->camera pose."""
    H, W = cam.height, cam.width
    uu, vv = np.meshgrid(np.arange(W, dtype=np.float32) + 0.5,
                         np.arange(H, dtype=np.float32) + 0.5)
    dirs_c = np.stack([(uu - cam.cx) / cam.fx, (vv - cam.cy) / cam.fy,
                       np.ones_like(uu)], axis=-1).reshape(-1, 3)
    twc = _np(lie.se3_inverse, tcw.astype(np.float32))
    Rwc = _np(lie.quat_to_rotmat, twc[:4])
    o = np.broadcast_to(twc[4:7], dirs_c.shape).astype(np.float32)
    d = dirs_c @ Rwc.T

    t_r, uv_r, tex_r = _intersect_rects(o, d, scene.rects)
    t_b, uv_b, tex_b = _intersect_boxes(o, d, scene.boxes)
    use_box = t_b < t_r
    t = np.where(use_box, t_b, t_r)
    uv = np.where(use_box[:, None], uv_b, uv_r)
    tex = np.where(use_box, tex_b, tex_r)

    S = scene.textures.shape[1]
    ti = np.clip((uv * (S - 1)).astype(np.int32), 0, S - 1)
    gray = np.where(tex >= 0,
                    scene.textures[np.clip(tex, 0, None), ti[:, 1], ti[:, 0]],
                    0.0).astype(np.float32)
    # z-depth (not ray length): z component of camera-frame hit point
    z = t * dirs_c[:, 2]
    z = np.where(np.isfinite(t), z, 0.0).astype(np.float32)
    if depth_noise > 0 and rng is not None:
        z = np.where(z > 0, z + rng.normal(0, depth_noise, z.shape) * z, 0.0)
    return gray.reshape(H, W), z.reshape(H, W).astype(np.float32)


def project_boxes(scene: Scene, cam: CameraConfig, tcw: np.ndarray,
                  min_area: float = 400.0) -> np.ndarray:
    """GT 2D detections: project each object AABB's corners, clip to image.
    Returns [B, 6] rows (class, x, y, w, h, score)."""
    out = []
    for box in scene.boxes:
        corners = np.array([[x, y, z] for x in (box.lo[0], box.hi[0])
                            for y in (box.lo[1], box.hi[1])
                            for z in (box.lo[2], box.hi[2])], np.float32)
        pc = _np(lie.se3_apply, tcw.astype(np.float32), corners)
        if np.any(pc[:, 2] < 0.1):
            continue
        uv = lie.project((cam.fx, cam.fy, cam.cx, cam.cy),
                         torch.from_numpy(pc)).numpy()
        x0, y0 = uv.min(axis=0)
        x1, y1 = uv.max(axis=0)
        x0, y0 = max(x0, 0.0), max(y0, 0.0)
        x1, y1 = min(x1, cam.width - 1.0), min(y1, cam.height - 1.0)
        if (x1 - x0) * (y1 - y0) < min_area:
            continue
        out.append([box.class_id, x0, y0, x1 - x0, y1 - y0, 0.95])
    return np.array(out, np.float32).reshape(-1, 6)


def make_trajectory(n_frames: int, style: str = "arc") -> np.ndarray:
    """Smooth Twc trajectory; returns Tcw poses [N, 7]. Starts at identity."""
    poses = []
    for i in range(n_frames):
        s = i / max(n_frames - 1, 1)
        if style == "arc":
            # sideways arc with mild yaw, keeping the room in view
            tx = 0.9 * np.sin(s * np.pi * 0.9)
            ty = 0.08 * np.sin(s * np.pi * 2.0)
            tz = 0.5 * s
            yaw = -0.35 * np.sin(s * np.pi * 0.9)
            pitch = 0.05 * np.sin(s * np.pi * 1.7)
        elif style == "forward":
            tx, ty, tz, yaw, pitch = 0.0, 0.0, 1.5 * s, 0.0, 0.0
        elif style == "loop":
            # closed loop for loop-closure tests
            ang = 2 * np.pi * s
            tx = 0.6 * np.sin(ang)
            ty = 0.0
            tz = 0.4 * (1 - np.cos(ang))
            yaw = 0.25 * np.sin(ang)
            pitch = 0.0
        elif style == "spin":
            # full 360° yaw in place: start/end views coincide but mid-
            # sequence keyframes are NOT covisible with the start — a true
            # loop-closure scenario
            ang = 2 * np.pi * s
            tx = 0.15 * np.sin(ang)
            ty = 0.0
            tz = 0.15 * (1 - np.cos(ang))
            yaw = ang
            pitch = 0.0
        elif style == "corridor":
            # non-revisiting forward exploration: constant 5 cm/frame
            # along +z with gentle sway/yaw (see make_corridor_scene)
            tx = 0.25 * np.sin(i * 0.05)
            ty = 0.05 * np.sin(i * 0.083)
            tz = 0.05 * i
            yaw = 0.12 * np.sin(i * 0.05 + 1.0)
            pitch = 0.03 * np.sin(i * 0.031)
        elif style == "tour":
            # one closed LAP around the room with a full 360° yaw: mid-lap
            # views face away from the start (covisibility breaks, so a
            # revisit is a genuine loop-closure event), and the trajectory
            # is 2π-periodic/smooth at the wrap so the lap can be REPLAYED
            # k times for fr3_long_office-scale sequences (the renderer
            # cost is one lap; the engine sees n_frames * k frames).
            ang = 2 * np.pi * s
            tx = 0.5 * np.sin(ang)
            ty = 0.04 * np.sin(2 * ang)
            tz = 0.5 * (1 - np.cos(ang))
            yaw = ang
            pitch = 0.0
        elif style == "spin15":
            # 1.5 turns: the last third re-traverses already-mapped walls,
            # giving the loop detector several consecutive revisit keyframes
            # (its 3-consecutive consistency gate needs them)
            ang = 3 * np.pi * s
            tx = 0.15 * np.sin(ang)
            ty = 0.0
            tz = 0.15 * (1 - np.cos(ang))
            yaw = ang
            pitch = 0.0
        else:
            raise ValueError(style)
        w = np.array([pitch, yaw, 0.0], np.float32)
        q = _np(lie.so3_exp_quat, w)
        twc = np.concatenate([q, np.array([tx, ty, tz], np.float32)])
        poses.append(_np(lie.se3_inverse, twc))
    return np.stack(poses)


def _scene(style: str, seed: int, n_frames: int, n_objects: int,
           texture: str, class_textures: bool) -> Scene:
    if style == "corridor":
        return make_corridor_scene(seed=seed, length_m=0.05 * n_frames + 4.0,
                                   n_objects=n_objects)
    return make_room_scene(seed=seed, n_objects=n_objects,
                           closed=style in ("spin", "spin15", "tour"),
                           texture=texture, class_textures=class_textures)


def _cache_key(n_frames, seed, style, depth_noise, n_objects, texture,
               class_textures, cam: CameraConfig) -> str:
    tex_tag = "" if texture == "blocky" else f"_t{texture}"
    ct_tag = "_ct3" if class_textures else ""   # v3: low-freq band classes
    return (f"seq_v3_n{n_frames}_s{seed}_{style}_dn{depth_noise}"
            f"_o{n_objects}{tex_tag}{ct_tag}_{cam.width}x{cam.height}"
            f"_f{cam.fx:.1f}")


def _load_frames(path: str) -> List[SyntheticFrame]:
    z = np.load(path, allow_pickle=True)
    # materialize each array once: indexing the lazy NpzFile per frame
    # decompresses the whole stack again on every access
    gray, depth = z["gray"], z["depth"]
    tcw, ts = z["tcw"], z["ts"]
    return [SyntheticFrame(gray=gray[i], depth=depth[i], tcw=tcw[i],
                           timestamp=float(ts[i]), boxes=z["boxes_%d" % i])
            for i in range(int(z["n"]))]


def _save_frames(path: str, frames: List[SyntheticFrame]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {"n": len(frames),
               "gray": np.stack([f.gray for f in frames]),
               "depth": np.stack([f.depth for f in frames]),
               "tcw": np.stack([f.tcw for f in frames]),
               "ts": np.array([f.timestamp for f in frames])}
    for i, f in enumerate(frames):
        payload["boxes_%d" % i] = f.boxes
    np.savez_compressed(path, **payload)


def generate_sequence(n_frames: int = 30, seed: int = 0, style: str = "arc",
                      camera: Optional[CameraConfig] = None,
                      depth_noise: float = 0.0, n_objects: int = 4,
                      fps: float = 30.0, texture: str = "blocky",
                      class_textures: bool = False,
                      cache_dir: Optional[str] = None) -> SyntheticSequence:
    """Render (or load from `cache_dir`) a ground-truthed RGBD sequence.
    A cache directory, keyed on all generation parameters, saves the
    rendering on later calls."""
    cam = camera or CameraConfig()
    key = _cache_key(n_frames, seed, style, depth_noise, n_objects, texture,
                     class_textures, cam) + ".npz"
    path = os.path.join(cache_dir, key) if cache_dir else None
    scene = _scene(style, seed, n_frames, n_objects, texture, class_textures)
    if path and os.path.exists(path):
        return SyntheticSequence(frames=_load_frames(path), camera=cam,
                                 scene=scene)

    tcws = make_trajectory(n_frames, style)
    r = np.random.default_rng(seed + 1)
    frames = []
    for i in range(n_frames):
        gray, depth = render_frame(scene, cam, tcws[i], depth_noise, r)
        boxes = project_boxes(scene, cam, tcws[i])
        frames.append(SyntheticFrame(gray=gray, depth=depth, tcw=tcws[i],
                                     timestamp=i / fps, boxes=boxes))
    if path:
        _save_frames(path, frames)
    return SyntheticSequence(frames=frames, camera=cam, scene=scene)


_THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def _pool_init() -> None:
    torch.set_num_threads(1)


_worker_scene = functools.lru_cache(maxsize=4)(_scene)


def _pool_render(task):
    scene_args, cam, tcw = task
    scene = _worker_scene(*scene_args)
    gray, depth = render_frame(scene, cam, tcw)
    return gray, depth, project_boxes(scene, cam, tcw)


def render_sequences(specs: List[dict], workers: int = 8,
                     cache_dir: Optional[str] = None
                     ) -> List[SyntheticSequence]:
    """Several sequences in one pool of `workers` spawned processes. Each
    spec takes `generate_sequence`'s arguments but `depth_noise`
    (`n_frames`, `seed`, `style`, `camera`, `n_objects`, `fps`,
    `texture`, `class_textures`) and `frames`, the frame numbers to
    render (all by default). Frame i is `generate_sequence`'s frame i bit
    for bit, its timestamp i / fps: without depth noise `render_frame`
    draws no randoms, so the frames are independent. Each worker builds a
    scene once. A `cache_dir` keeps a whole sequence in
    `generate_sequence`'s own file, and a subset under that key and a
    digest of its frame list."""
    import hashlib
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    jobs, tasks, out = [], [], []
    for spec in specs:
        spec = dict(spec)
        n = spec.pop("n_frames")
        sel = spec.pop("frames", None)
        sel = list(range(n)) if sel is None else [int(i) for i in sel]
        if not all(0 <= i < n for i in sel):
            raise ValueError(f"frames outside 0..{n - 1}")
        cam = spec.pop("camera", None) or CameraConfig()
        fps = spec.pop("fps", 30.0)
        scene_args = (spec.pop("style", "arc"), spec.pop("seed", 0), n,
                      spec.pop("n_objects", 4), spec.pop("texture", "blocky"),
                      spec.pop("class_textures", False))
        if spec:
            raise TypeError(f"unknown arguments {sorted(spec)}")
        style, seed, _, n_obj, texture, ct = scene_args
        path = None
        if cache_dir:
            key = _cache_key(n, seed, style, 0.0, n_obj, texture, ct, cam)
            if sel != list(range(n)):
                digest = hashlib.sha1(np.asarray(sel, np.int64).tobytes())
                key += f"_sel{len(sel)}-{digest.hexdigest()[:10]}"
            path = os.path.join(cache_dir, key + ".npz")
        cached = bool(path) and os.path.exists(path)
        tcws = make_trajectory(n, style)
        jobs.append((scene_args, cam, sel, tcws, fps, path, cached,
                     len(tasks)))
        if not cached:
            tasks += [(scene_args, cam, tcws[i]) for i in sel]
    rendered = []
    if tasks:
        # one BLAS thread a worker: the workers are spawned with this
        # environment
        saved = {k: os.environ.get(k) for k in _THREAD_VARS}
        os.environ.update({k: "1" for k in _THREAD_VARS})
        try:
            # a worker that dies fails the call (BrokenProcessPool), where
            # a multiprocessing.Pool would wait for it forever
            with ProcessPoolExecutor(
                    max(1, min(workers, len(tasks))),
                    mp_context=multiprocessing.get_context("spawn"),
                    initializer=_pool_init) as pool:
                rendered = list(pool.map(_pool_render, tasks, chunksize=2))
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    for scene_args, cam, sel, tcws, fps, path, cached, first in jobs:
        scene = _scene(*scene_args)
        if cached:
            frames = _load_frames(path)
        else:
            frames = [SyntheticFrame(gray=g, depth=d, tcw=tcws[i],
                                     timestamp=i / fps, boxes=b)
                      for i, (g, d, b) in zip(
                          sel, rendered[first:first + len(sel)])]
            if path:
                _save_frames(path, frames)
        out.append(SyntheticSequence(frames=frames, camera=cam, scene=scene))
    return out


def apply_nuisance(gray: np.ndarray, depth: np.ndarray,
                   rng: np.random.Generator, *,
                   shot_noise: float = 0.0, read_noise: float = 0.0,
                   exposure: float = 1.0, blur_px: float = 0.0,
                   depth_holes: float = 0.0, depth_quant: float = 0.0
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Photometric and depth sensor nuisance on top of a clean render (the
    reference's workload is a real D435i, `ros_test/config/D435i.yaml`):

      shot_noise   Poisson-approx: std = shot_noise * sqrt(signal)
      read_noise   additive Gaussian std (dark floor)
      exposure     multiplicative gain (the caller drifts it per frame)
      blur_px      horizontal box motion blur of about that many pixels
      depth_holes  fraction of depth dropped in speckle blobs (stereo
                   dropouts on low-texture / oblique surfaces)
      depth_quant  disparity-style quantization: the step grows as q z^2
                   (the D435's error model), in metres at z = 1 m
    """
    g = gray.astype(np.float32)
    if blur_px >= 2.0:
        k = int(round(blur_px)) | 1
        ker = np.ones(k, np.float32) / k
        pad = k // 2
        gp = np.pad(g, ((0, 0), (pad, pad)), mode="edge")
        g = np.apply_along_axis(
            lambda row: np.convolve(row, ker, mode="valid"), 1, gp)
    g = g * exposure
    if shot_noise > 0:
        g = g + rng.normal(0.0, 1.0, g.shape) * shot_noise * np.sqrt(
            np.clip(g, 0.0, None))
    if read_noise > 0:
        g = g + rng.normal(0.0, read_noise, g.shape)
    g = np.clip(g, 0.0, 1.0).astype(np.float32)

    z = depth.astype(np.float32)
    if depth_quant > 0:
        step = depth_quant * np.maximum(z, 1e-6) ** 2
        z = np.where(z > 0, np.round(z / step) * step, z)
    if depth_holes > 0:
        H, W = z.shape
        blob = rng.random((H // 8 + 1, W // 8 + 1))
        blob = np.kron(blob, np.ones((8, 8)))[:H, :W]
        z = np.where(blob < depth_holes, 0.0, z)
    return g, z.astype(np.float32)


#: named nuisance profiles of the robustness runs
NUISANCE_PROFILES = {
    "shot":     dict(shot_noise=0.04, read_noise=0.01),
    "exposure": dict(),   # drift handled per frame by nuisance_sequence
    "blur":     dict(blur_px=5.0),
    "depth":    dict(depth_holes=0.15, depth_quant=0.0015),
    "combo":    dict(shot_noise=0.03, read_noise=0.008, blur_px=3.0,
                     depth_holes=0.10, depth_quant=0.0015),
}


def nuisance_sequence(seq: SyntheticSequence, profile: str,
                      seed: int = 0) -> SyntheticSequence:
    """A copy of `seq` with the named nuisance profile applied per frame;
    `exposure` and `combo` add a sinusoidal exposure drift (+-25% over
    about 40 frames: auto-exposure hunting)."""
    kw = dict(NUISANCE_PROFILES[profile])
    rng = np.random.default_rng(seed + 77)
    drift = profile in ("exposure", "combo")
    frames = []
    for i, f in enumerate(seq.frames):
        exp = 1.0 + (0.25 * np.sin(2 * np.pi * i / 40.0) if drift else 0.0)
        g, z = apply_nuisance(f.gray, f.depth, rng, exposure=exp, **kw)
        frames.append(SyntheticFrame(gray=g, depth=z, tcw=f.tcw,
                                     timestamp=f.timestamp, boxes=f.boxes))
    return SyntheticSequence(frames=frames, camera=seq.camera,
                             scene=seq.scene)


def render_right_images(seq: SyntheticSequence, seed: int = 0,
                        cache_dir: Optional[str] = None) -> np.ndarray:
    """Rectified right-eye grays [T, H, W] for an existing sequence: the
    right camera sits at +baseline along the left camera's x axis, so
    Tcw_right has the same rotation and t_r = t_l - b e_x (then uR = uL -
    bf / z, the virtual right coordinate of `src/Frame.cc:1016`). The cache
    file is the JAX package's, under the same key."""
    cam = seq.camera
    n = len(seq.frames)
    path = None
    if cache_dir:
        t0 = seq.frames[0].tcw
        key = (f"right_v1_n{n}_s{seed}_b{cam.baseline:.4f}"
               f"_{cam.width}x{cam.height}_f{cam.fx:.1f}"
               f"_h{hash(tuple(np.round(t0, 4))) & 0xffffffff:x}.npz")
        path = os.path.join(cache_dir, key)
        if os.path.exists(path):
            return np.load(path)["right"]
    rights = []
    for f in seq.frames:
        t = f.tcw.astype(np.float32).copy()
        t[4] -= cam.baseline
        rights.append(render_frame(seq.scene, cam, t)[0])
    out = np.stack(rights)
    if path:
        os.makedirs(cache_dir, exist_ok=True)
        np.savez_compressed(path, right=out)
    return out
