"""SO(3)/SE(3)/Sim(3) ops of the port against the JAX package on random
batches, small-angle branches included (atol 1e-6; 1e-5 where a Sim(3)
log solves with the left Jacobian, whose float32 LU differs in the last
bits between the two libraries)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eao_fusion_tpu.ops import lie as J
from eao_fusion_tpu_torch.ops import lie as T

ATOL = 1e-6


def _batch(seed, n=64):
    r = np.random.default_rng(seed)
    tau = r.normal(0, 0.6, (n, 6)).astype(np.float32)
    tau[: n // 4, :3] *= 1e-5          # theta^2 < 1e-8: small-angle branch
    tau[n // 4: n // 2, :3] = 0.0      # exactly zero rotation
    return tau


def _both(name, *arrays):
    a = np.asarray(getattr(J, name)(*[jnp.asarray(x) for x in arrays]))
    b = getattr(T, name)(*[torch.from_numpy(np.array(x)) for x in arrays])
    return a, b.numpy()


def _poses(seed):
    return np.asarray(J.se3_exp(jnp.asarray(_batch(seed))))


@pytest.mark.parametrize("name,make", [
    ("se3_exp", lambda s: (_batch(s),)),
    ("se3_log", lambda s: (_poses(s),)),
    ("se3_inverse", lambda s: (_poses(s),)),
    ("se3_compose", lambda s: (_poses(s), _poses(s + 1))),
    ("se3_retract", lambda s: (_poses(s), _batch(s + 1))),
    ("se3_apply", lambda s: (_poses(s), _batch(s + 1)[:, :3] * 5)),
    ("se3_matrix", lambda s: (_poses(s),)),
    ("quat_to_rotmat", lambda s: (_poses(s)[:, :4],)),
    ("quat_mul", lambda s: (_poses(s)[:, :4], _poses(s + 1)[:, :4])),
    ("quat_rotate", lambda s: (_poses(s)[:, :4], _batch(s + 1)[:, :3])),
    ("so3_exp_quat", lambda s: (_batch(s)[:, :3],)),
    ("so3_log", lambda s: (_poses(s)[:, :4],)),
    ("so3_left_jacobian", lambda s: (_batch(s)[:, :3],)),
    ("so3_hat", lambda s: (_batch(s)[:, :3],)),
])
def test_matches_jax(name, make):
    a, b = _both(name, *make(3))
    np.testing.assert_allclose(b, a, atol=ATOL)


def test_rotmat_to_quat_all_branches():
    # rotations near 180° about each axis exercise every Shepperd case
    q = np.concatenate([_poses(5)[:, :4],
                        np.array([[0.01, 1, 0, 0], [0.01, 0, 1, 0],
                                  [0.01, 0, 0, 1]], np.float32)])
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    R = np.asarray(J.quat_to_rotmat(jnp.asarray(q)))
    a, b = _both("rotmat_to_quat", R)
    np.testing.assert_allclose(b, a, atol=ATOL)


def test_project_backproject():
    cam = (535.4, 539.2, 320.1, 247.6)
    r = np.random.default_rng(1)
    xc = np.stack([r.uniform(-2, 2, 50), r.uniform(-1, 1, 50),
                   r.uniform(0.5, 6, 50)], 1).astype(np.float32)
    a = np.asarray(J.project(cam, jnp.asarray(xc)))
    b = T.project(cam, torch.from_numpy(xc)).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-6)
    a = np.asarray(J.backproject(cam, jnp.asarray(a), jnp.asarray(xc[:, 2])))
    b = T.backproject(cam, torch.from_numpy(b), torch.from_numpy(xc[:, 2]))
    np.testing.assert_allclose(b.numpy(), a, atol=1e-5)


def test_identity_and_roundtrip():
    p = _poses(9)
    t = torch.from_numpy(p)
    ident = T.se3_compose(t, T.se3_inverse(t))
    np.testing.assert_allclose(ident.numpy(),
                               np.tile(T.se3_identity().numpy(), (len(p), 1)),
                               atol=1e-6)


def _sim_tau(seed, n=64):
    """sim3 tangents [n, 7]: the se3 batch of `_batch` and log-scales up to
    about ±0.5."""
    r = np.random.default_rng(seed + 100)
    sig = r.normal(0, 0.2, (n, 1)).astype(np.float32)
    return np.concatenate([_batch(seed, n), sig], axis=1)


def _sims(seed):
    return np.asarray(J.sim3_exp(jnp.asarray(_sim_tau(seed))))


@pytest.mark.parametrize("name,make,atol", [
    ("sim3_exp", lambda s: (_sim_tau(s),), ATOL),
    ("sim3_log", lambda s: (_sims(s),), 1e-5),
    ("sim3_inverse", lambda s: (_sims(s),), ATOL),
    ("sim3_compose", lambda s: (_sims(s), _sims(s + 1)), ATOL),
    ("sim3_retract", lambda s: (_sims(s), _sim_tau(s + 1)), ATOL),
    ("sim3_apply", lambda s: (_sims(s), _batch(s + 1)[:, :3] * 5), 1e-5),
    ("sim3_to_se3", lambda s: (_sims(s),), ATOL),
    ("sim3_from_se3", lambda s: (_poses(s),), ATOL),
])
def test_sim3_matches_jax(name, make, atol):
    a, b = _both(name, *make(4))
    np.testing.assert_allclose(b, a, atol=atol)


def test_sim3_identity_and_roundtrip():
    g = torch.from_numpy(_sims(6))
    ident = T.sim3_compose(g, T.sim3_inverse(g))
    np.testing.assert_allclose(
        ident.numpy(), np.tile(T.sim3_identity().numpy(), (len(g), 1)),
        atol=2e-6)
    np.testing.assert_array_equal(T.sim3_identity((2,)).numpy(),
                                  np.asarray(J.sim3_identity((2,))))
    tau = torch.from_numpy(_sim_tau(7))
    np.testing.assert_allclose(T.sim3_log(T.sim3_exp(tau)).numpy(),
                               tau.numpy(), atol=1e-5)
