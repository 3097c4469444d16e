"""The Cholesky solve of the reduced camera system (K4) against the JAX
package: the plain PyTorch version against `cholesky_solve_pallas`
(interpreted) and a float64 solve, the clamped pivot of an indefinite
matrix, and the CUDA kernel against the plain version under the `gpu`
marker."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eao_fusion_tpu.solvers import chol_pallas as JCP
from eao_fusion_tpu_torch import config as TC
from eao_fusion_tpu_torch import kernels
from eao_fusion_tpu_torch.solvers import ba as TB
from eao_fusion_tpu_torch.solvers import chol as TCH
from test_ba import CAM, dense_to_coo, make_ba_problem


def _spd(D, seed=0, cond=1e3):
    """SPD [D, D] float32 with eigenvalues log-spaced over `cond`, and a
    right-hand side (seeded numpy)."""
    r = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(r.normal(size=(D, D)))
    M = (Q * np.logspace(0, np.log10(cond), D)) @ Q.T
    M = (0.5 * (M + M.T)).astype(np.float32)
    return M, r.normal(size=D).astype(np.float32)


def _rel(x, ref):
    return float(np.linalg.norm(np.asarray(x, np.float64) - ref)
                 / np.linalg.norm(ref))


@pytest.mark.parametrize("D", [24, 192])
def test_plain_matches_pallas_and_float64(D):
    """Condition number 1e3: relative error < 1e-4 against the float64
    solve, for the plain version and the interpreted Pallas kernel, and
    between the two."""
    M, b = _spd(D, seed=D)
    ref = np.linalg.solve(M.astype(np.float64), b.astype(np.float64))
    xt = TCH.cholesky_solve_plain(torch.from_numpy(M), torch.from_numpy(b))
    xp = np.asarray(JCP.cholesky_solve_pallas(jnp.asarray(M), jnp.asarray(b),
                                              interpret=True))
    assert _rel(xt.numpy(), ref) < 1e-4
    assert _rel(xp, ref) < 1e-4
    assert _rel(xt.numpy(), xp.astype(np.float64)) < 1e-4
    # on the CPU the wrapper is the plain version and launches nothing
    before = dict(kernels.launches)
    np.testing.assert_array_equal(
        TCH.cholesky_solve(torch.from_numpy(M), torch.from_numpy(b)).numpy(),
        xt.numpy())
    assert kernels.launches == before


def test_indefinite_pivot_is_clamped():
    """A negative pivot is clamped to sqrt(1e-20): the solve of an
    indefinite matrix is huge but finite, in both packages alike."""
    M, b = _spd(24, seed=3, cond=10.0)
    M[-1, -1] = -M[-1, -1]
    xt = TCH.cholesky_solve_plain(torch.from_numpy(M), torch.from_numpy(b))
    xp = np.asarray(JCP.cholesky_solve_pallas(jnp.asarray(M), jnp.asarray(b),
                                              interpret=True))
    assert torch.isfinite(xt).all()
    assert float(xt.abs().max()) > 1e6
    np.testing.assert_allclose(xt.numpy(), xp, rtol=1e-3)


def test_bundle_adjust_rejects_an_indefinite_step(monkeypatch):
    """Local BA whose reduced camera system is made indefinite: every
    camera's x translation is decoupled from the other unknowns and its
    diagonal negated, so its pivot is clamped and its step is rhs·1e20,
    finite. Every step of a camera with active edges is then huge, the LM
    accept test rejects each one, and BA returns its input. (A pivot left
    coupled to the rest spreads the huge step over every camera, which can
    move all of a camera's points behind it, where their cost is masked to
    0, and LM would accept that.)"""
    r = np.random.default_rng(7)
    prob, _, _ = make_ba_problem(r, noise_px=0.4)
    coo = dense_to_coo(prob)
    tp = TB.BACooProblem(*[torch.as_tensor(np.array(getattr(coo, k)))
                           for k in TB.BACooProblem._fields])
    steps = []

    def indefinite_solve(M, rhs):
        M = M.clone()
        for k in range(3, M.shape[0], 6):   # tangent order [omega, v]
            d = M[k, k].abs()
            M[k, :] = 0.0
            M[:, k] = 0.0
            M[k, k] = -d
        x = TCH.cholesky_solve_plain(M, rhs)
        steps.append(x)
        return x

    monkeypatch.setattr(TB.chol, "cholesky_solve", indefinite_solve)
    res = TB.bundle_adjust_coo(tp, cam=CAM, cfg=TC.SolverConfig())
    assert len(steps) >= 2
    assert all(bool(torch.isfinite(x).all()) for x in steps)
    assert max(float(x.abs().max()) for x in steps) > 1e3
    np.testing.assert_array_equal(res.cam_pose.numpy(), tp.cam_pose.numpy())
    np.testing.assert_array_equal(res.pt_xyz.numpy(), tp.pt_xyz.numpy())


def test_kernel_wrapper_rejects_what_it_cannot_hold():
    """A D whose tiles exceed a block's shared memory, and a CPU tensor,
    raise before anything launches."""
    before = dict(kernels.launches)
    assert TCH.shared_bytes(192) < TCH.MAX_SHARED_BYTES
    assert TCH.shared_bytes(289) > TCH.MAX_SHARED_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        TCH.cholesky_solve_cuda(torch.zeros(400, 400), torch.zeros(400))
    with pytest.raises(ValueError, match="shared memory"):
        TCH.cholesky_solve_cuda(torch.zeros(289, 289), torch.zeros(289))
    with pytest.raises(ValueError, match="CUDA"):
        TCH.cholesky_solve_cuda(torch.eye(8), torch.zeros(8))
    assert kernels.launches == before


@pytest.mark.parametrize("D", [1, 5, 31, 33, 72, 190, 192, 256])
def test_kernel_wrapper_holds_every_size_up_to_256(D):
    """Every D up to the TPU kernel's 256, ragged ones included, fits in a
    block's shared memory: the wrapper gets past its size check and stops
    only at the CPU tensor, launching nothing."""
    before = dict(kernels.launches)
    assert TCH.shared_bytes(D) <= TCH.MAX_SHARED_BYTES
    M, b = _spd(D, seed=D, cond=10.0)
    with pytest.raises(ValueError, match="CUDA"):
        TCH.cholesky_solve_cuda(torch.from_numpy(M), torch.from_numpy(b))
    assert kernels.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("D", [1, 24, 33, 72, 192, 256])
def test_cuda_kernel_matches_plain(D):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    M, b = _spd(D, seed=D)
    ref = np.linalg.solve(M.astype(np.float64), b.astype(np.float64))
    Mc, bc = torch.from_numpy(M).cuda(), torch.from_numpy(b).cuda()
    xk = TCH.cholesky_solve(Mc, bc)
    xp = TCH.cholesky_solve_plain(Mc, bc)
    torch.cuda.synchronize()
    assert _rel(xk.cpu().numpy(), ref) < 1e-4
    assert _rel(xk.cpu().numpy(), xp.cpu().numpy().astype(np.float64)) < 1e-4


@pytest.mark.gpu
def test_cuda_kernel_clamps_an_indefinite_pivot():
    """The indefinite case of test_indefinite_pivot_is_clamped on the card:
    finite, huge, and within rtol 1e-3 of the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    M, b = _spd(24, seed=3, cond=10.0)
    M[-1, -1] = -M[-1, -1]
    Mc, bc = torch.from_numpy(M).cuda(), torch.from_numpy(b).cuda()
    xk = TCH.cholesky_solve(Mc, bc).cpu()
    xp = TCH.cholesky_solve_plain(torch.from_numpy(M), torch.from_numpy(b))
    assert torch.isfinite(xk).all()
    assert float(xk.abs().max()) > 1e6
    np.testing.assert_allclose(xk.numpy(), xp.numpy(), rtol=1e-3)
