"""The port's monocular lane under the combined nuisance
(tests/test_nuisance_e2e.py:69-90 on the port): the cached 20-frame arc
under `combo`, no depth, a keyframe at least every 3 frames;
scale-aligned ATE < 8 cm from the first frame that moved. The JAX System
measured 7.36 cm on this input, so the bound is tight, and the port's own
two-view RANSAC draws (torch's generator, not `jax.random`) land
elsewhere. Fed the JAX System's draws, the port must match the JAX
System's pixels at every initialization attempt and its ATE within
0.01 cm: that separates a parity fault from the draw's spread. `slow`;
`chip_smoke.py` phase 27 runs the first test on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eao_fusion_tpu.config import (MapCapacity, ORBConfig, SystemConfig,
                                   TrackingConfig)
from eao_fusion_tpu.io.synthetic import DEFAULT_CACHE
from eao_fusion_tpu.ops import twoview as JT
from eao_fusion_tpu.pipeline.system import System as JSystem
from eao_fusion_tpu_torch.io import synthetic
from eao_fusion_tpu_torch.ops import twoview as TT
from eao_fusion_tpu_torch.pipeline.system import System
import torch_contracts as C

pytestmark = pytest.mark.slow


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def arcs():
    seq = synthetic.generate_sequence(n_frames=20, seed=0, style="arc",
                                      cache_dir=DEFAULT_CACHE)
    return seq, synthetic.nuisance_sequence(seq, "combo", seed=0)


def test_mono_ate_under_combo(arcs):
    seq, nseq = arcs
    s = System(C.nuisance_mono_cfg(), device="cpu")
    for f in nseq.frames:
        s.process_frame(f.gray, None, timestamp=f.timestamp)
    print(f"[nuisance:mono-combo] {C.check_mono_nuisance(s, seq)}")


def test_mono_combo_same_draws_as_jax(arcs, monkeypatch):
    seq, nseq = arcs
    # the JAX System, recording each two-view attempt's hypothesis indices
    # as `initialize_two_view` draws them, and the matches they index
    draws, jax_uv = [], []
    init = JT.initialize_two_view

    def spy(uv1, uv2, valid, key, *, cam, n_hypotheses=200):
        p = valid.astype(jnp.float32)
        p = p / jnp.maximum(p.sum(), 1.0)
        kf, kh = jax.random.split(key)
        n = uv1.shape[0]
        draws.append((
            np.asarray(jax.random.choice(kf, n, (n_hypotheses, 8), p=p)),
            np.asarray(jax.random.choice(kh, n, (n_hypotheses, 4), p=p))))
        jax_uv.append((np.asarray(uv1), np.asarray(uv2)))
        return init(uv1, uv2, valid, key, cam=cam, n_hypotheses=n_hypotheses)

    monkeypatch.setattr(JT, "initialize_two_view", spy)
    js = JSystem(SystemConfig(
        orb=ORBConfig(n_features=500, max_keypoints=512),
        capacity=MapCapacity(max_keyframes=32, max_points=8192,
                             max_local_ba_kfs=16),
        use_planes=False, use_objects=False, sensor="mono",
        tracking=TrackingConfig(max_frames_between_kf=3)))
    for f in nseq.frames:
        js.process_frame(f.gray, None, timestamp=f.timestamp)
    want = C.check_mono_nuisance(js, seq)

    # the port, each attempt fed the JAX draws in the same order
    port_uv, queue = [], list(draws)
    draw, port_init = TT.draw_two_view_hypotheses, TT.initialize_two_view

    def fed(valid, generator, n_hypotheses=200):
        draw(valid, generator, n_hypotheses)   # keeps the generator's stream
        return tuple(torch.from_numpy(a.copy()) for a in queue.pop(0))

    def port_spy(uv1, uv2, *a, **k):
        port_uv.append((uv1.numpy(), uv2.numpy()))
        return port_init(uv1, uv2, *a, **k)

    monkeypatch.setattr(TT, "draw_two_view_hypotheses", fed)
    monkeypatch.setattr(TT, "initialize_two_view", port_spy)
    s = System(C.nuisance_mono_cfg(), device="cpu")
    for f in nseq.frames:
        s.process_frame(f.gray, None, timestamp=f.timestamp)
    got = C.check_mono_nuisance(s, seq)
    print(f"[nuisance:mono-combo, JAX draws] port {got}; JAX {want}; "
          f"{len(draws)} attempts")
    assert len(port_uv) == len(jax_uv) and not queue
    for (a1, a2), (b1, b2) in zip(port_uv, jax_uv):
        np.testing.assert_array_equal(a1, b1)
        np.testing.assert_array_equal(a2, b2)
    assert got["init_frame"] == want["init_frame"]
    assert abs(got["ate_cm"] - want["ate_cm"]) < 0.01, (got, want)
