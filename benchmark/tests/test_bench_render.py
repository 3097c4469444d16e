"""The torch ray cast (`gen/render_torch.py`) against the frozen numpy copy
(`gen/synthetic.py`), on sample frames of the room scene at a quarter of the
configurations' width.

Tolerance: the torch version repeats the numpy copy's float32 terms in
the same order, so the frames should agree bit for bit; a texel index may
flip where a ray meets a texel edge within a rounding, so up to 1e-4 of
the gray pixels may differ, and depth may differ by 1e-6 relative. On the
CPU they agreed bit for bit; the card's (`-m gpu`) is the same test."""

import numpy as np
import pytest
import torch

from benchmark.gen import render_torch, synthetic as syn

CAM = syn.Camera(160, 120, 535.4 / 4, 539.2 / 4, 320.1 / 4, 247.6 / 4)
SCENES = {
    "room": (lambda: syn.make_room_scene(11), 625, "tour",
             (0, 97, 311, 600)),
}


def _compare(name: str, device: str) -> None:
    make, n, style, frames = SCENES[name]
    scene = make()
    tcw = syn.make_trajectory(n, style)
    tex_np = syn.textures_numpy(scene)
    tex = render_torch.scene_textures(scene, torch.device(device))
    assert bool((tex.cpu().numpy() == tex_np).all())
    gray, depth = render_torch.render(scene, tex, CAM, tcw[list(frames)],
                                      batch=2)
    for j, i in enumerate(frames):
        g, d = syn.render_frame(scene, tex_np, CAM, tcw[i])
        g_t, d_t = gray[j].cpu().numpy(), depth[j].cpu().numpy()
        assert (g_t != g).mean() <= 1e-4
        assert np.all(np.abs(d_t - d) <= 1e-6 * np.maximum(d, 1e-3))
        assert (d > 0).mean() > 0.3


@pytest.mark.parametrize("name", sorted(SCENES))
def test_render_matches_numpy_on_cpu(name):
    _compare(name, "cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SCENES))
def test_render_matches_numpy_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _compare(name, "cuda")


def test_boxes_and_trajectories():
    scene = syn.make_room_scene(11)
    tcw = syn.make_trajectory(625, "tour")
    # the lap closes: its last frame is its first frame's pose (q and -q
    # are one rotation)
    R0, R1 = (syn.lie.quat_to_rotmat(p[:4]) for p in (tcw[0], tcw[-1]))
    assert np.abs(R1 - R0).max() < 1e-5
    assert np.abs(tcw[-1, 4:] - tcw[0, 4:]).max() < 1e-5
    boxes = syn.project_boxes(scene, CAM, tcw[0])
    assert boxes.shape[1] == 6 and len(boxes) >= 1
    assert np.all(boxes[:, 3:5] > 0)
    assert np.all(boxes[:, 5] == np.float32(0.95))
