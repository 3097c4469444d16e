"""A configuration's input stream, made from the seed on the device: the
scene and its textures (the seed deals them out), the trajectory, every
frame ray-cast on the card, and the boxes projected from the ground truth
as offline detections. Frames stay on the device for the run.

The configuration's `stream` names the scene, a module of
`benchmark/gen/scenes/` (or a whole module name), and one of its
trajectories; `replay` (default true) replays the stream lap after lap,
and false ends the run with an error at the first frame past its end."""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.gen import render_torch
from benchmark.gen import synthetic as syn

from .core import BenchError, find_module, log


class Stream:
    def __init__(self, stream: dict, camera: dict, seed: int, device,
                 n_box: int):
        cam = syn.Camera(**{k: camera[k] for k in (
            "width", "height", "fx", "fy", "cx", "cy")})
        self.cam = cam
        n = int(stream["frames"])
        t0 = time.perf_counter()
        scene_mod = find_module("benchmark.gen.scenes", stream["scene"])
        trajectory = scene_mod.TRAJECTORIES.get(stream["trajectory"])
        if trajectory is None:
            raise BenchError(
                f"scene {stream['scene']!r} has no trajectory "
                f"{stream['trajectory']!r}: {sorted(scene_mod.TRAJECTORIES)}")
        self.replay = bool(stream.get("replay", True))
        # the scene's geometry and its texture pool come from the
        # configuration's layout; the seed deals the textures out to the
        # surfaces and the boxes, so that every seed gives the same sizes
        # in another order
        self.scene = scene_mod.make(int(stream["layout_seed"]),
                                    int(stream["n_objects"]), n)
        perm = np.random.default_rng(seed).permutation(
            len(self.scene.textures))
        self.scene.textures = [self.scene.textures[j] for j in perm]
        self.tcw = trajectory(n)
        textures = render_torch.scene_textures(self.scene, device)
        self.gray, self.depth = render_torch.render(self.scene, textures,
                                                    cam, self.tcw)
        del textures
        self.boxes_host = [syn.project_boxes(self.scene, cam, t)
                           for t in self.tcw]
        pad = np.zeros((n, n_box, 6), np.float32)
        for i, b in enumerate(self.boxes_host):
            pad[i, :min(len(b), n_box)] = b[:n_box]
        self.boxes = torch.as_tensor(pad, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.n = n
        log(f"stream: {n} frames of {cam.width}x{cam.height} "
            f"({stream['scene']}, {stream['trajectory']}) rendered in "
            f"{time.perf_counter() - t0:.2f} s")

    def index(self, k: int) -> int:
        """The stream frame of the run's k-th frame: laps repeat, or, where
        the stream does not replay, a frame past its end is an error."""
        if not self.replay and k >= self.n:
            raise BenchError(f"frame {k} is past the end of the stream, "
                             f"which has {self.n} frames and does not "
                             f"replay")
        return k % self.n

    def chunk(self, k0: int, n: int):
        """(grays, depths, boxes) of run frames k0 .. k0 + n - 1 on the
        device: views where the frames are consecutive in the stream."""
        idx = [self.index(k) for k in range(k0, k0 + n)]
        if idx == list(range(idx[0], idx[0] + n)):
            s = slice(idx[0], idx[0] + n)
            return self.gray[s], self.depth[s], self.boxes[s]
        it = torch.tensor(idx, device=self.gray.device)
        return self.gray[it], self.depth[it], self.boxes[it]

    def host_frame(self, k: int):
        """(gray, depth, boxes) of run frame k as host arrays, for
        `System.process_frame`."""
        i = self.index(k)
        return (self.gray[i].cpu().numpy(), self.depth[i].cpu().numpy(),
                self.boxes_host[i])
