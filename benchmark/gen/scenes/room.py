"""The closed room (a frozen copy of the port's `make_room_scene` with
`closed=True`) and its trajectory `tour`."""

from __future__ import annotations

import numpy as np

from benchmark.gen.synthetic import (BoxPrim, RectPrim, Scene,
                                     blocky_texture, poses, vec)


def make(layout_seed: int, n_objects: int, frames: int) -> Scene:
    """A room in the first camera's frame (x right, y down, z forward):
    floor at y = 1.2, back wall at z = 4.5, side walls at x = -3 and 3, a
    wall behind the camera at z = -1.5 with the floor extended back to
    it, boxes at table height. The same room for any `frames`."""
    r = np.random.default_rng(layout_seed)
    textures = [blocky_texture(r) for _ in range(4 + n_objects)]
    rects = [RectPrim(vec(-3.0, 1.2, 0.2), vec(6.0, 0, 0), vec(0, 0, 4.3), 0),
             RectPrim(vec(-3.0, -2.0, 4.5), vec(6.0, 0, 0), vec(0, 3.2, 0), 1),
             RectPrim(vec(-3.0, -2.0, 0.2), vec(0, 0, 4.3), vec(0, 3.2, 0), 2),
             RectPrim(vec(3.0, -2.0, 0.2), vec(0, 0, 4.3), vec(0, 3.2, 0), 3)]
    boxes = []
    for i in range(n_objects):
        cx = r.uniform(-1.5, 1.5)
        cz = r.uniform(2.9, 4.2)
        w, h, d = r.uniform(0.3, 0.55, 3)
        y_bottom = r.uniform(0.55, 0.9)
        boxes.append(BoxPrim(vec(cx - w / 2, y_bottom - h, cz - d / 2),
                             vec(cx + w / 2, y_bottom, cz + d / 2), 4 + i,
                             class_id=i % 8))
    # the wall behind is drawn last, as the port draws it
    textures.append(blocky_texture(r))
    rects.append(RectPrim(vec(-3.0, -2.0, -1.5), vec(6.0, 0, 0),
                          vec(0, 3.2, 0), len(textures) - 1))
    rects[0] = RectPrim(vec(-3.0, 1.2, -1.5), vec(6.0, 0, 0),
                        vec(0, 0, 6.0), 0)
    return Scene(rects, boxes, textures)


def tour(n_frames: int) -> np.ndarray:
    """One closed lap around the room with a full turn of yaw, frame
    n - 1 at frame 0's pose, so that laps replay smoothly."""
    i = np.arange(n_frames, dtype=np.float64)
    ang = 2 * np.pi * (i / max(n_frames - 1, 1))
    return poses(0.5 * np.sin(ang), 0.04 * np.sin(2 * ang),
                 0.5 * (1 - np.cos(ang)), np.zeros_like(ang), ang)


TRAJECTORIES = {"tour": tour}
