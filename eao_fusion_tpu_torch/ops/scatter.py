"""Scatters whose result does not depend on the device or the run.

A float sum depends on its order. `index_add_` adds each target's rows in
row order on the CPU, but with atomics on the card, in whatever order the
threads come; an accumulating `index_put_` sorts the indices stably on
the card and adds each target's rows in row order, but runs in parallel
on the CPU. So each device takes the call that adds in row order there:
the same bits from run to run on each device. (The JAX package sums with
scatters or one-hot matmuls, both fixed-order under XLA.)

An assignment `out[idx] = vals` with equal indices is the same kind of
hazard: on the CPU the last of them lands, on the card whichever thread
writes last, which can change from run to run. `put_last` makes the last
one land on both.
"""

from __future__ import annotations

import torch


def index_sum(out: torch.Tensor, idx: torch.Tensor,
              vals: torch.Tensor) -> torch.Tensor:
    """out[idx[i]] += vals[i] along the first axis, in place, each target's
    rows added in ascending i. Returns out."""
    if out.is_cuda:
        return out.index_put_((idx.long(),), vals, accumulate=True)
    return out.index_add_(0, idx.long(), vals)


def put_last(out: torch.Tensor, idx: torch.Tensor,
             vals: torch.Tensor) -> torch.Tensor:
    """out[idx[i]] = vals[i] along the first axis, in place, where of equal
    indices the one with the largest i lands (what the assignment gives on
    the CPU, and the JAX package's scatter there), on every device.
    Returns out."""
    idx = idx.long()
    pos = torch.arange(idx.shape[0], device=idx.device)
    last = torch.full((out.shape[0],), -1, dtype=torch.int64,
                      device=idx.device).scatter_reduce(0, idx, pos, "amax")
    keep = last[idx] == pos
    out[idx[keep]] = vals[keep]
    return out
