"""Scatter-add in a fixed order on every device.

A float sum depends on its order. `index_add_` adds each target's rows in
row order on the CPU, but with atomics on the card, in whatever order the
threads come; an accumulating `index_put_` sorts the indices stably on
the card and adds each target's rows in row order, but runs in parallel
on the CPU. So each device takes the call that adds in row order there:
the same bits from run to run, and the same bits on both devices where
the rows agree. (The JAX package sums with scatters or one-hot matmuls,
both fixed-order under XLA.)
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
