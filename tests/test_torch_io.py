"""The port's synthetic renderer and trajectory evaluation against the JAX
package (numpy copies with the port's quaternion math)."""

import dataclasses

import numpy as np
import pytest

from eao_fusion_tpu.config import CameraConfig
from eao_fusion_tpu.io import synthetic as JS
from eao_fusion_tpu.io import tum as JT
from eao_fusion_tpu_torch import config as TC
from eao_fusion_tpu_torch.io import synthetic as TS
from eao_fusion_tpu_torch.io import tum as TT

# a small camera with the fr3 field of view keeps the renders cheap
SMALL = dict(width=80, height=60, fx=535.4 / 8, fy=539.2 / 8, cx=320.1 / 8,
             cy=247.6 / 8)


@pytest.mark.parametrize("style", ["arc", "forward", "loop", "spin", "tour"])
def test_trajectories_match(style):
    np.testing.assert_allclose(TS.make_trajectory(12, style),
                               JS.make_trajectory(12, style), atol=1e-6)


def test_scene_and_render_match():
    js, ts = JS.make_room_scene(seed=3), TS.make_room_scene(seed=3)
    np.testing.assert_array_equal(ts.textures, js.textures)
    jcam, tcam = CameraConfig(**SMALL), TC.CameraConfig(**SMALL)
    for tcw in JS.make_trajectory(4, "arc"):
        gj, dj = JS.render_frame(js, jcam, tcw)
        gt, dt = TS.render_frame(ts, tcam, tcw)
        assert (gt == gj).mean() > 0.999
        np.testing.assert_allclose(dt, dj, atol=1e-5)
        np.testing.assert_allclose(TS.project_boxes(ts, tcam, tcw),
                                   JS.project_boxes(js, jcam, tcw), atol=1e-3)


def test_generate_sequence_matches():
    jcam, tcam = CameraConfig(**SMALL), TC.CameraConfig(**SMALL)
    a = JS.generate_sequence(n_frames=3, seed=1, camera=jcam)
    b = TS.generate_sequence(n_frames=3, seed=1, camera=tcam)
    np.testing.assert_allclose(b.gt_tcw(), a.gt_tcw(), atol=1e-6)
    np.testing.assert_allclose(b.timestamps(), a.timestamps())
    for fa, fb in zip(a.frames, b.frames):
        assert (fa.gray == fb.gray).mean() > 0.999
        np.testing.assert_allclose(fb.depth, fa.depth, atol=1e-5)


def test_cache_round_trip(tmp_path):
    cam = TC.CameraConfig(**SMALL)
    a = TS.generate_sequence(n_frames=2, seed=2, camera=cam,
                             cache_dir=str(tmp_path))
    b = TS.generate_sequence(n_frames=2, seed=2, camera=cam,
                             cache_dir=str(tmp_path))
    assert len(list(tmp_path.iterdir())) == 1
    np.testing.assert_array_equal(a.frames[1].gray, b.frames[1].gray)


@pytest.mark.parametrize("with_scale", [False, True])
def test_ate_rpe_matches(with_scale):
    r = np.random.default_rng(0)
    gt = JS.make_trajectory(15, "loop")
    noise = r.normal(0, 0.01, (15, 7)).astype(np.float32)
    est = gt + noise
    est[:, :4] /= np.linalg.norm(est[:, :4], axis=1, keepdims=True)
    a = JT.evaluate_ate_rpe(est, gt, with_scale=with_scale, rpe_delta=2)
    b = TT.evaluate_ate_rpe(est, gt, with_scale=with_scale, rpe_delta=2)
    for k, v in dataclasses.asdict(a).items():
        np.testing.assert_allclose(getattr(b, k), v, rtol=1e-5, atol=1e-7,
                                   err_msg=k)
