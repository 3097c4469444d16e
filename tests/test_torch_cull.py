"""The port's keyframe culling (`pipeline/local_mapping.cull_keyframes`)
against the JAX function on the JAX package's own fixture: the redundant
map of tests/test_compaction.py (every keyframe observes the same points,
so every unprotected keyframe is a candidate), carried across with
`map_state.from_numpy`. The same surviving keyframes, and the JAX tests'
own asserts (tests/test_compaction.py:89-118). The port-side fixture
that `chip_smoke.py` phase 26 culls on the card is the JAX one, field
for field."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from eao_fusion_tpu.pipeline import local_mapping as JLM
from eao_fusion_tpu_torch.mapping import map_state as TMS
from eao_fusion_tpu_torch.pipeline import local_mapping as TLM
import torch_contracts as C
from test_compaction import _redundant_map


def _np(m):
    return jax.tree.map(np.asarray, m)._asdict()


@pytest.mark.parametrize("n_kf,max_cull", sorted(C.CULL_CASES))
def test_cull_keyframes_matches_jax(n_kf, max_cull):
    """(8 keyframes, max_cull 1, 3, 8): up to `max_cull` victims while
    candidates remain, never keyframe 0 nor the two newest (slots 6, 7),
    and three left when the budget outlasts the redundancy rule; (5, 4):
    culling stops after two victims, when a third would leave points with
    fewer than 3 other observers."""
    mj = _redundant_map(n_kf=n_kf)
    kj = np.asarray(JLM.cull_keyframes(mj, jnp.int32(n_kf - 1),
                                       max_cull=max_cull).kf_valid)
    mt = TMS.from_numpy(_np(mj), "cpu")
    kt = TLM.cull_keyframes(mt, n_kf - 1, max_cull=max_cull).kf_valid
    np.testing.assert_array_equal(kt.numpy(), kj)
    C.check_cull(kt.numpy(), n_kf, max_cull)


@pytest.mark.parametrize("n_kf", [5, 8])
def test_port_redundant_map_is_the_jax_fixture(n_kf):
    mt = C.redundant_map(n_kf)
    for k, v in _np(_redundant_map(n_kf=n_kf)).items():
        got = getattr(mt, k).numpy()
        np.testing.assert_array_equal(got, v, err_msg=k)
        assert got.dtype == v.dtype, k


@pytest.mark.gpu
def test_cull_keyframes_on_card_matches_cpu():
    """`chip_smoke.py` phase 26 (b): every case on the card, the same
    keyframes as on the CPU."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    C.check_cull_on("cuda")
