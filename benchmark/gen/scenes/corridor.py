"""The corridor (a frozen copy of the port's `make_corridor_scene`, its
length following the stream's, as the port's `generate_sequence` sets
it) and its trajectory `corridor`: forward exploration that never
revisits."""

from __future__ import annotations

import numpy as np

from benchmark.gen.synthetic import (F32, TEX_SIZE, BoxPrim, RectPrim,
                                     Scene, blocky_texture, poses, vec)

SEGMENT_M = 3.0
HALF_WIDTH = 1.5


def voronoi_texture(r: np.random.Generator, size: int = TEX_SIZE,
                    n_seeds: int = 700) -> np.ndarray:
    """Aperiodic cell noise: each pixel takes the value of its nearest
    random seed point, with speckles at random positions."""
    pts = r.uniform(0, size, (n_seeds, 2)).astype(F32)
    vals = r.uniform(0.05, 1.0, n_seeds).astype(F32)
    out = np.empty((size, size), F32)
    xs = np.arange(size, dtype=F32)
    for y0 in range(0, size, 64):
        yy = np.arange(y0, min(y0 + 64, size), dtype=F32)
        d = ((yy[:, None, None] - pts[:, 1]) ** 2
             + (xs[None, :, None] - pts[:, 0]) ** 2)
        out[y0:y0 + 64] = vals[np.argmin(d, axis=-1)]
    ys, xs_i = r.integers(0, size, (2, 400))
    out[ys, xs_i] = 1.0
    return out


def length_m(frames: int) -> float:
    """The corridor's length for a stream of `frames` frames at 5 cm a
    frame, with 4 m to spare."""
    return 0.05 * frames + 4.0


def make(layout_seed: int, n_objects: int, frames: int) -> Scene:
    """A corridor along +z: floor and left and right wall segments every
    3 m, each with a texture of its own (block and cell textures in
    turn), a wall at the far end, boxes along the walls."""
    r = np.random.default_rng(layout_seed)
    length = length_m(frames)
    n_seg = int(np.ceil(length / SEGMENT_M)) + 1
    textures, rects = [], []
    for i in range(n_seg):
        z0 = -1.0 + i * SEGMENT_M
        for origin, eu, ev in (
                (vec(-HALF_WIDTH, 1.2, z0), vec(2 * HALF_WIDTH, 0, 0),
                 vec(0, 0, SEGMENT_M)),
                (vec(-HALF_WIDTH, -2.0, z0), vec(0, 0, SEGMENT_M),
                 vec(0, 3.2, 0)),
                (vec(HALF_WIDTH, -2.0, z0), vec(0, 0, SEGMENT_M),
                 vec(0, 3.2, 0))):
            tex_fn = (blocky_texture if len(textures) % 2 == 0
                      else voronoi_texture)
            textures.append(tex_fn(r))
            rects.append(RectPrim(origin, eu, ev, len(textures) - 1))
    textures.append(voronoi_texture(r))
    z_end = -1.0 + n_seg * SEGMENT_M
    rects.append(RectPrim(vec(-HALF_WIDTH, -2.0, z_end),
                          vec(2 * HALF_WIDTH, 0, 0), vec(0, 3.2, 0),
                          len(textures) - 1))
    boxes = []
    for i in range(n_objects):
        cz = r.uniform(1.0, length - 1.0)
        side = 1 if i % 2 == 0 else -1
        w, h, d = r.uniform(0.3, 0.5, 3)
        cx = side * (HALF_WIDTH - 0.4)
        y_bottom = r.uniform(0.6, 0.95)
        textures.append(blocky_texture(r))
        boxes.append(BoxPrim(vec(cx - w / 2, y_bottom - h, cz - d / 2),
                             vec(cx + w / 2, y_bottom, cz + d / 2),
                             len(textures) - 1, class_id=i % 8))
    return Scene(rects, boxes, textures)


def corridor(n_frames: int) -> np.ndarray:
    """5 cm a frame along +z with a gentle sway and yaw."""
    i = np.arange(n_frames, dtype=np.float64)
    return poses(0.25 * np.sin(i * 0.05), 0.05 * np.sin(i * 0.083),
                 0.05 * i, 0.03 * np.sin(i * 0.031),
                 0.12 * np.sin(i * 0.05 + 1.0))


TRAJECTORIES = {"corridor": corridor}
