"""A configuration's input stream, made from the seed on the device: the
scene and its textures (the seed deals them out), the trajectory, every
frame ray-cast on the card, and the boxes projected from the ground truth
as offline detections. Frames stay on the device for the run, and the
stream replays lap after lap."""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.gen import render_torch
from benchmark.gen import synthetic as syn

from .core import BenchError, log


class Stream:
    def __init__(self, stream: dict, camera: dict, seed: int, device,
                 n_box: int):
        cam = syn.Camera(**{k: camera[k] for k in (
            "width", "height", "fx", "fy", "cx", "cy")})
        self.cam = cam
        n = int(stream["frames"])
        t0 = time.perf_counter()
        if stream["scene"] != "room":
            raise BenchError(f"unknown scene {stream['scene']!r}")
        # the room's geometry and its texture pool come from the
        # configuration's layout; the seed deals the textures out to the
        # walls, the floor and the boxes, so that every seed gives the
        # same sizes in another order
        self.scene = syn.make_room_scene(
            int(stream["layout_seed"]), n_objects=int(stream["n_objects"]),
            closed=True)
        perm = np.random.default_rng(seed).permutation(
            len(self.scene.textures))
        self.scene.textures = [self.scene.textures[j] for j in perm]
        self.tcw = syn.make_trajectory(n, stream["trajectory"])
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
        """The stream frame of the run's k-th frame: laps repeat."""
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
