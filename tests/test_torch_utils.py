"""The port's offline visual artifacts (`utils/viz.py`); the recorder of
`utils/profiling.py` is held by tests/test_torch_profiling.py."""

import numpy as np
import pytest
import torch

from eao_fusion_tpu_torch.utils import viz


class _Cam:
    fx, fy, cx, cy = 500.0, 500.0, 320.0, 240.0


class _Cfg:
    camera = _Cam()


class _Objects:
    def __init__(self, centre, half):
        c = torch.tensor([centre], dtype=torch.float32)
        h = torch.tensor([half], dtype=torch.float32)
        self.valid = torch.tensor([True])
        self.center, self.cub_min, self.cub_max = c, c - h, c + h


class _System:
    def __init__(self):
        self.cfg = _Cfg()
        self.objects = _Objects([0.2, -0.1, 3.0], [0.3, 0.3, 0.3])
        self.track = type("T", (), {"pose": torch.tensor(
            [1.0, 0, 0, 0, 0, 0, 0])})()


def test_quadric_conic_of_a_sphere_is_its_silhouette():
    """A sphere of radius r at depth z projects to a circle of radius
    f r / sqrt(z^2 - r^2) around the projected centre (for a centre on the
    axis; here off axis, checked on the points the conic passes through)."""
    (o, C, uv), = viz.quadric_conics(_System())
    assert o == 0
    u0, v0 = 500 * 0.2 / 3.0 + 320, 500 * -0.1 / 3.0 + 240
    np.testing.assert_allclose(uv, (u0, v0), atol=1e-3)

    def val(u, v):
        x = np.array([u, v, 1.0])
        return x @ C @ x
    assert val(u0, v0) * val(0.0, 0.0) < 0          # centre inside
    # rays tangent to the sphere: the conic vanishes on their image points
    c = np.array([0.2, -0.1, 3.0])
    r = 0.3
    d = np.linalg.norm(c)
    e = np.cross(c, [0.0, 1.0, 0.0])
    e /= np.linalg.norm(e)
    sin_a = r / d
    cos_a = np.sqrt(1 - sin_a ** 2)
    ray = cos_a * c / d + sin_a * e
    p = ray / ray[2]
    u, v = 500 * p[0] + 320, 500 * p[1] + 240
    scale = abs(val(u0, v0))
    assert abs(val(u, v)) < 1e-4 * scale


def test_overlays_write_pngs(tmp_path):
    pytest.importorskip("matplotlib")
    gray = np.random.default_rng(0).uniform(0, 1, (48, 64)).astype(
        np.float32)
    feats = type("F", (), {"uv": torch.tensor([[10.0, 10.0], [20.0, 30.0]]),
                           "valid": torch.tensor([True, True])})()
    viz.draw_frame_overlay(str(tmp_path / "f.png"), gray, feats,
                           kp_pt=torch.tensor([3, -1]),
                           boxes=np.array([[1, 5, 5, 20, 10, 0.9]]),
                           title="frame")
    viz.draw_quadric_overlay(str(tmp_path / "q" / "q.png"), gray, _System())
    for p in (tmp_path / "f.png", tmp_path / "q" / "q.png"):
        assert p.read_bytes()[:4] == b"\x89PNG"
