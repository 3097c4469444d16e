"""The torch ray cast (`gen/render_torch.py`) against the frozen numpy copy
(`gen/synthetic.py`), on sample frames of each scene
(`gen/scenes/<scene>.py`) at a quarter of the configurations' width; the
corridor against the port's own generator (`io/synthetic.py`).

Tolerance: the torch version repeats the numpy copy's float32 terms in
the same order, so the frames should agree bit for bit; a texel index may
flip where a ray meets a texel edge within a rounding, so up to 1e-4 of
the gray pixels may differ, and depth may differ by 1e-6 relative. On the
CPU they agreed bit for bit; the card's (`-m gpu`) is the same test. The
port's generator takes its poses through torch and its ray directions
through a matrix product, so there poses may differ by 1e-6, depth by
1e-6 relative (2e-7 to 3.3e-7 was read), and a texel index flips more
often: one gray pixel of 4800 was read at 80x60, so up to 1e-3 of the
gray pixels may differ there."""

import numpy as np
import pytest
import torch

from benchmark.gen import render_torch, synthetic as syn
from benchmark.gen.scenes import corridor, room

CAM = syn.Camera(160, 120, 535.4 / 4, 539.2 / 4, 320.1 / 4, 247.6 / 4)
# name: (scene, trajectory, frames, the frames compared); the corridor of
# 200 frames is 14 m long, 18 wall and floor segments
SCENES = {
    "room": (room.make, room.tour, 625, (0, 97, 311, 600)),
    "corridor": (corridor.make, corridor.corridor, 200, (0, 57, 133, 199)),
}


def _agree(g_t, d_t, g, d, gray_share: float = 1e-4) -> None:
    assert (g_t != g).mean() <= gray_share
    assert np.all(np.abs(d_t - d) <= 1e-6 * np.maximum(d, 1e-3))
    assert (d > 0).mean() > 0.3


def _compare(name: str, device: str) -> None:
    make, trajectory, n, frames = SCENES[name]
    scene = make(11, 4, n)
    tcw = trajectory(n)
    tex_np = syn.textures_numpy(scene)
    tex = render_torch.scene_textures(scene, torch.device(device))
    assert bool((tex.cpu().numpy() == tex_np).all())
    gray, depth = render_torch.render(scene, tex, CAM, tcw[list(frames)],
                                      batch=2)
    for j, i in enumerate(frames):
        g, d = syn.render_frame(scene, tex_np, CAM, tcw[i])
        _agree(gray[j].cpu().numpy(), depth[j].cpu().numpy(), g, d)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_render_matches_numpy_on_cpu(name):
    _compare(name, "cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SCENES))
def test_render_matches_numpy_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _compare(name, "cuda")


def test_corridor_is_the_ports():
    from eao_fusion_tpu_torch.config import CameraConfig
    from eao_fusion_tpu_torch.io import synthetic as port
    n = 60
    ours = corridor.make(3, 4, n)
    theirs = port.make_corridor_scene(seed=3, length_m=0.05 * n + 4.0,
                                      n_objects=4)
    assert np.array_equal(syn.textures_numpy(ours), theirs.textures)
    for a, b in zip(ours.rects + ours.boxes, theirs.rects + theirs.boxes,
                    strict=True):
        assert vars(a).keys() == vars(b).keys()
        for k, v in vars(a).items():
            assert np.array_equal(v, vars(b)[k]), k
    tcw = corridor.corridor(n)
    tcw_port = port.make_trajectory(n, "corridor")
    assert np.abs(tcw - tcw_port).max() <= 1e-6
    cam = syn.Camera(160, 120, 615.45 / 4, 615.45 / 4, 319.5 / 4,
                     239.5 / 4)
    pcam = CameraConfig(width=cam.width, height=cam.height, fx=cam.fx,
                        fy=cam.fy, cx=cam.cx, cy=cam.cy)
    tex = syn.textures_numpy(ours)
    for i in (0, 31, 59):
        g, d = port.render_frame(theirs, pcam, tcw_port[i])
        _agree(*syn.render_frame(ours, tex, cam, tcw[i]), g, d, 1e-3)
        assert np.array_equal(syn.project_boxes(ours, cam, tcw[i]),
                              port.project_boxes(theirs, pcam, tcw_port[i]))


def test_boxes_and_trajectories():
    scene = room.make(11, 4, 625)
    tcw = room.tour(625)
    # the lap closes: its last frame is its first frame's pose (q and -q
    # are one rotation)
    R0, R1 = (syn.lie.quat_to_rotmat(p[:4]) for p in (tcw[0], tcw[-1]))
    assert np.abs(R1 - R0).max() < 1e-5
    assert np.abs(tcw[-1, 4:] - tcw[0, 4:]).max() < 1e-5
    boxes = syn.project_boxes(scene, CAM, tcw[0])
    assert boxes.shape[1] == 6 and len(boxes) >= 1
    assert np.all(boxes[:, 3:5] > 0)
    assert np.all(boxes[:, 5] == np.float32(0.95))
    # the corridor never comes back: its camera moves 5 cm a frame along
    # +z, and the corridor runs 4 m past the last frame
    twc = syn.lie.se3_inverse(corridor.corridor(2000))
    assert np.all(np.diff(twc[:, 6]) > 0.049)
    assert corridor.length_m(2000) - 1.0 - twc[-1, 6] > 3.0 - 1e-3
