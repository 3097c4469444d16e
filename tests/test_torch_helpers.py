"""Small public helpers of the port against the JAX package on the same
inputs: the packed Hamming distance (exact), the SE3 accessors (exact),
grayscale, the Gaussian blur and the organized depth cloud (1e-6)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eao_fusion_tpu import config as JC
from eao_fusion_tpu.ops import hamming as JH
from eao_fusion_tpu.ops import image as JI
from eao_fusion_tpu.ops import lie as JL
from eao_fusion_tpu.ops import planes as JP
from eao_fusion_tpu_torch import config as TC
from eao_fusion_tpu_torch.ops import hamming as TH
from eao_fusion_tpu_torch.ops import image as TI
from eao_fusion_tpu_torch.ops import lie as TL
from eao_fusion_tpu_torch.ops import planes as TP


def test_hamming_packed_matches_jax_exactly():
    """Random packed pairs, the all-ones and all-equal words included."""
    r = np.random.default_rng(0)
    a = r.integers(0, 2 ** 32, (64, 8), dtype=np.uint64).astype(np.uint32)
    b = r.integers(0, 2 ** 32, (64, 8), dtype=np.uint64).astype(np.uint32)
    a[0], b[0] = 0xFFFFFFFF, 0
    b[1] = a[1]
    ref = np.asarray(JH.hamming_packed(jnp.asarray(a), jnp.asarray(b)))
    got = TH.hamming_packed(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref[0] == 256 and ref[1] == 0
    # the popcount of the unpacked bits
    bits = np.unpackbits((a ^ b).view(np.uint8), axis=1).sum(1)
    np.testing.assert_array_equal(got.numpy(), bits)


def test_se3_accessors_match_jax():
    p = np.random.default_rng(1).normal(size=(5, 3, 7)).astype(np.float32)
    for jf, tf in ((JL.se3_rotation, TL.se3_rotation),
                   (JL.se3_translation, TL.se3_translation)):
        np.testing.assert_array_equal(tf(torch.from_numpy(p)).numpy(),
                                      np.asarray(jf(jnp.asarray(p))))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_rgb_to_gray_matches_jax(dtype):
    r = np.random.default_rng(2)
    rgb = (r.integers(0, 256, (24, 32, 3)).astype(dtype) if dtype == np.uint8
           else r.random((24, 32, 3), dtype=np.float32))
    np.testing.assert_allclose(
        TI.rgb_to_gray(torch.from_numpy(rgb)).numpy(),
        np.asarray(JI.rgb_to_gray(jnp.asarray(rgb))), atol=1e-6)


@pytest.mark.parametrize("sigma,radius", [(2.0, 3), (1.2, 2)])
def test_gaussian_blur_matches_jax(sigma, radius):
    img = np.random.default_rng(3).random((37, 52), dtype=np.float32)
    np.testing.assert_allclose(
        TI.gaussian_blur(torch.from_numpy(img), sigma, radius).numpy(),
        np.asarray(JI.gaussian_blur(jnp.asarray(img), sigma, radius)),
        atol=1e-6)


def test_backproject_depth_matches_jax():
    depth = np.random.default_rng(4).uniform(0.0, 6.0, (48, 64)).astype(
        np.float32)
    depth[::7, ::5] = 0.0
    got = TP.backproject_depth(torch.from_numpy(depth), TC.CameraConfig())
    ref = np.asarray(JP.backproject_depth(jnp.asarray(depth),
                                          JC.CameraConfig()))
    assert got.shape == (48, 64, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)
