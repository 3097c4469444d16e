"""ORB front end of the port against the JAX package on a synthetic 640x480
frame: pyramid levels, extraction from the same pyramid, and the full
`extract_features`."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eao_fusion_tpu.config import ORBConfig, SystemConfig
from eao_fusion_tpu.frontend import extractor as JE
from eao_fusion_tpu.io import synthetic
from eao_fusion_tpu.ops import image as JI
from eao_fusion_tpu.ops import orb as JO
from eao_fusion_tpu_torch import config as TC
from eao_fusion_tpu_torch.frontend import extractor as TE
from eao_fusion_tpu_torch.ops import fast as TF
from eao_fusion_tpu_torch.ops import image as TI
from eao_fusion_tpu_torch.ops import orb as TO

JCFG = SystemConfig(orb=ORBConfig(n_features=500, max_keypoints=512))
TCFG = TC.SystemConfig(orb=TC.ORBConfig(n_features=500, max_keypoints=512))


@pytest.fixture(scope="module")
def frame():
    seq = synthetic.generate_sequence(n_frames=20, seed=0, style="arc",
                                      cache_dir=synthetic.DEFAULT_CACHE)
    return seq.frames[5]


@pytest.fixture(scope="module")
def jax_pyramid(frame):
    return [np.array(x) for x in JI.build_pyramid(     # writable copies
        jnp.asarray(frame.gray), JCFG.orb.n_levels, JCFG.orb.scale_factor)]


def test_pattern_is_the_reference_pattern():
    np.testing.assert_array_equal(TO.PATTERN, JO.PATTERN)
    np.testing.assert_array_equal(TO._blur_band_matrix(2.0, 3), JO._BLUR_B)


def test_pyramid_levels(frame, jax_pyramid):
    tp = TI.build_pyramid(torch.from_numpy(frame.gray), TCFG.orb.n_levels,
                          TCFG.orb.scale_factor)
    assert len(tp) == len(jax_pyramid)
    for a, b in zip(jax_pyramid, tp):
        assert a.shape == tuple(b.shape)
        np.testing.assert_allclose(b.numpy(), a, atol=1e-4)


def test_extract_from_same_pyramid(jax_pyramid):
    fj = JE.extract_from_pyramid([jnp.asarray(x) for x in jax_pyramid],
                                 orb_cfg=JCFG.orb)
    ft = TE.extract_from_pyramid([torch.from_numpy(x) for x in jax_pyramid],
                                 orb_cfg=TCFG.orb)
    np.testing.assert_array_equal(ft.uv.numpy(), np.asarray(fj.uv))
    np.testing.assert_array_equal(ft.level.numpy(), np.asarray(fj.level))
    np.testing.assert_array_equal(ft.valid.numpy(), np.asarray(fj.valid))
    np.testing.assert_allclose(ft.response.numpy(), np.asarray(fj.response),
                               atol=1e-6)
    np.testing.assert_allclose(ft.angle.numpy(), np.asarray(fj.angle),
                               atol=1e-4)
    valid = np.asarray(fj.valid)
    bits_j = np.asarray(fj.desc_pm1)[valid]
    bits_t = ft.desc_pm1.numpy()[valid]
    assert (bits_j == bits_t).mean() > 0.999
    # the packed words carry the same bits (int32 view of uint32)
    agree = ft.desc_packed.numpy().view(np.uint32) == np.asarray(
        fj.desc_packed)
    assert agree[valid].mean() > 0.99


def test_full_extract_features(frame):
    fj = JE.extract_features(jnp.asarray(frame.gray), jnp.asarray(frame.depth),
                             orb_cfg=JCFG.orb, cam_cfg=JCFG.camera)
    ft = TE.extract_features(torch.from_numpy(frame.gray),
                             torch.from_numpy(frame.depth),
                             orb_cfg=TCFG.orb, cam_cfg=TCFG.camera)
    same = ((ft.uv.numpy() == np.asarray(fj.uv)).all(1)
            & (ft.level.numpy() == np.asarray(fj.level)))
    assert same.mean() >= 0.99
    d_j, d_t = np.asarray(fj.depth)[same], ft.depth.numpy()[same]
    np.testing.assert_allclose(d_t, d_j, atol=1e-6)
    np.testing.assert_allclose(ft.uright.numpy()[same],
                               np.asarray(fj.uright)[same], atol=1e-3)


def test_fast_score_and_nms_exact(jax_pyramid):
    from eao_fusion_tpu.ops import fast as JF
    img = jax_pyramid[2]
    a = np.asarray(JF.nms3x3(JF.fast_score(jnp.asarray(img), 7 / 255.0)))
    b = TF.nms3x3(TF.fast_score(torch.from_numpy(img), 7 / 255.0)).numpy()
    np.testing.assert_array_equal(b, a)


def test_extract_patches_clamps_at_the_border():
    img = torch.arange(60 * 70, dtype=torch.float32).reshape(60, 70)
    yx = torch.tensor([[0, 0], [59, 69], [30, 35]], dtype=torch.int32)
    p = TO.extract_patches(img, yx)
    j = np.asarray(JO.extract_patches(jnp.asarray(img.numpy()),
                                      jnp.asarray(yx.numpy())))
    np.testing.assert_array_equal(p.numpy(), j)
