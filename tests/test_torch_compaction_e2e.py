"""Point-table compaction inside the port's `process_frame`
(tests/test_compaction.py:15-37 on the port): objects on with the
renderer's boxes as offline boxes, 64 keyframe and 1024 point slots, loop
closing off, over the cached 20-frame seed-0 arc. At least one compaction
(`next_pt` falls), ATE < 3 cm, > 60 inliers on the last frame; and the
JAX System on the same input compacts as often and on the same frames.
`slow`: about two minutes on one CPU thread, most of it the JAX System's
compiles; `chip_smoke.py` phase 26 runs the port's part on the card."""

import pytest
import torch

from eao_fusion_tpu.config import MapCapacity, ORBConfig, SystemConfig
from eao_fusion_tpu.io.synthetic import DEFAULT_CACHE
from eao_fusion_tpu.pipeline.system import System as JSystem
from eao_fusion_tpu_torch import kernels
from eao_fusion_tpu_torch.io import synthetic
from eao_fusion_tpu_torch.pipeline.system import System
import torch_contracts as C

pytestmark = pytest.mark.slow


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_compaction_preserves_tracking():
    seq = synthetic.generate_sequence(n_frames=20, seed=0, style="arc",
                                      cache_dir=DEFAULT_CACHE)
    s = System(C.compaction_cfg(), device="cpu")
    before = dict(kernels.launches)
    next_pts = []
    for f in seq.frames:
        s.process_frame(f.gray, f.depth, f.timestamp, boxes=f.boxes)
        next_pts.append(int(s.map.next_pt))
    assert kernels.launches == before
    out = C.check_compaction(s, seq, next_pts)

    # the JAX System of tests/test_compaction.py on the same frames
    js = JSystem(SystemConfig(
        orb=ORBConfig(n_features=500, max_keypoints=512),
        capacity=MapCapacity(max_keyframes=64, max_points=1024),
        use_planes=False, use_objects=True, use_loop_closing=False))
    jax_next_pts = []
    for f in seq.frames:
        js.process_frame(f.gray, f.depth, f.timestamp, boxes=f.boxes)
        jax_next_pts.append(int(js.map.next_pt))
    jax_frames = C.compaction_frames(jax_next_pts)
    print(f"[compaction] port {out}; JAX compaction frames {jax_frames}, "
          f"last frame inliers {int(js.diags[-1]['n_inliers'])}")
    assert out["compaction_frames"] == jax_frames
