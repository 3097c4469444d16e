"""The port's online detector under the combined nuisance
(tests/test_nuisance_e2e.py:138-183 on the port): `data/yolox_synth.npz`
on every fourth frame of the cached class-textured 24-frame arc, clean
and under `combo`; the nuisanced recall at IoU 0.4 keeps half the clean
one and is at least 0.4. `slow`; `chip_smoke.py` phase 27 runs it on the
card."""

import pytest
import torch

from eao_fusion_tpu.io.synthetic import DEFAULT_CACHE
from eao_fusion_tpu_torch.io import synthetic
import torch_contracts as C

pytestmark = pytest.mark.slow


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_detector_recall_under_nuisance():
    seq = synthetic.generate_sequence(
        n_frames=24, seed=0, style="arc", n_objects=4, class_textures=True,
        cache_dir=DEFAULT_CACHE)
    print(f"[nuisance:detector] {C.check_detector_nuisance('cpu', seq)}")
