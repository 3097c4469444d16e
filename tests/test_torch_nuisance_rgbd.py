"""The port's RGBD lane under each sensor-nuisance profile
(tests/test_nuisance_e2e.py:44-66 on the port): the cached 20-frame
seed-0 arc through the port's `nuisance_sequence` (seed 0), the JAX
test's configuration (512 keypoint slots, 32 keyframes, 8192 points,
planes and objects off, loop closing on); ATE from frame 2 under the
profile's floor, at most 2 frames with < 20 inliers. `slow`: about 30 s
a profile on one CPU thread; `chip_smoke.py` phase 27 runs them on the
card."""

import pytest
import torch

from eao_fusion_tpu.io.synthetic import DEFAULT_CACHE
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


@pytest.mark.parametrize("profile", sorted(C.RGBD_FLOORS))
def test_rgbd_ate_under_nuisance(profile):
    seq = synthetic.generate_sequence(n_frames=20, seed=0, style="arc",
                                      cache_dir=DEFAULT_CACHE)
    nseq = synthetic.nuisance_sequence(seq, profile, seed=0)
    s = System(C.nuisance_cfg(), device="cpu")
    for f in nseq.frames:
        s.process_frame(f.gray, f.depth, timestamp=f.timestamp)
    print(f"[nuisance:{profile}] {C.check_rgbd_nuisance(s, nseq, profile)}")
