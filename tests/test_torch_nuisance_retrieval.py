"""BoW retrieval of the port under the combined nuisance
(tests/test_nuisance_e2e.py:93-135 on the port): a System maps the clean
cached 20-frame arc (the nuisance suite's configuration, loop closing
on); each live keyframe's frame under `combo` must retrieve its own
keyframe or a covisible one as the top score of the loop closer's BoW
database, for 80% of them. `slow`; `chip_smoke.py` phase 27 runs it on
the card."""

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


def test_retrieval_survives_nuisance():
    seq = synthetic.generate_sequence(n_frames=20, seed=0, style="arc",
                                      cache_dir=DEFAULT_CACHE)
    s = System(C.nuisance_cfg(), device="cpu")
    for f in seq.frames:
        s.process_frame(f.gray, f.depth, timestamp=f.timestamp)
    nseq = synthetic.nuisance_sequence(seq, "combo", seed=0)
    print(f"[nuisance:retrieval] {C.check_retrieval_nuisance(s, nseq)}")
