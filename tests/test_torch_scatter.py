"""`ops/scatter`: the fixed-order scatter-add and the assignment whose equal
indices resolve to the last one on every device (the JAX package's
`.at[].set` on the CPU), against a sequential loop."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eao_fusion_tpu_torch.ops.scatter import index_sum, put_last


def _case(seed: int, n: int = 64, m: int = 200, k: int = 3):
    """A table of n rows, m updates into 12 of its rows (so most indices
    repeat) with distinct values, and the sequential loop's result."""
    r = np.random.default_rng(seed)
    out = r.normal(size=(n, k)).astype(np.float32)
    idx = r.choice(r.choice(n, 12, replace=False), m).astype(np.int64)
    vals = r.normal(size=(m, k)).astype(np.float32)
    want = out.copy()
    for i, v in zip(idx, vals):
        want[i] = v
    return out, idx, vals, want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_put_last_takes_the_last_of_equal_indices(seed):
    """The last update of each index lands, as in a loop, and as in the
    JAX package's scatter (`.at[].set`) on the CPU."""
    out, idx, vals, want = _case(seed)
    got = put_last(torch.from_numpy(out.copy()), torch.from_numpy(idx),
                   torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(got, want)
    jax_set = np.asarray(jnp.asarray(out).at[jnp.asarray(idx)].set(
        jnp.asarray(vals)))
    np.testing.assert_array_equal(got, jax_set)


def test_index_sum_adds_in_row_order():
    """Each target's rows added in ascending row order: float32 sums of a
    loop, bit for bit."""
    out, idx, vals, _ = _case(3)
    want = out.copy()
    for i, v in zip(idx, vals):
        want[i] = want[i] + v
    got = index_sum(torch.from_numpy(out.copy()), torch.from_numpy(idx),
                    torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
def test_scatters_on_the_card():
    """On the card `put_last` gives the loop's bits, and `index_sum` the
    same bits in ten calls on the same inputs, within float32 rounding of
    the CPU's row-order sums (the bound of a float32 sum of n terms, n
    times 2^-24 of the sum of their magnitudes, each row). Prints how far
    the card's sums lie from the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in range(4):
        out, idx, vals, want = _case(seed, n=4096, m=200000, k=4)
        o, i, v = (torch.from_numpy(a) for a in (out, idx, vals))
        cpu_sum = index_sum(o.clone(), i, v)
        mag = index_sum(torch.zeros_like(o), i, v.abs()) + o.abs()
        n = torch.bincount(i, minlength=o.shape[0])[:, None] + 1
        sums = []
        for _ in range(10):
            got = put_last(o.cuda(), i.cuda(), v.cuda()).cpu().numpy()
            np.testing.assert_array_equal(got, want)
            sums.append(index_sum(o.cuda(), i.cuda(), v.cuda()).cpu())
        print({"seed": seed, "index_sum_card_minus_cpu_max": float(
            (sums[0] - cpu_sum).abs().max())})
        assert all(torch.equal(x, sums[0]) for x in sums[1:])
        assert bool(((sums[0] - cpu_sum).abs() <= n * 2.0 ** -24 * mag)
                    .all())
