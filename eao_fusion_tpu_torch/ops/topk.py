"""`lax.top_k` semantics in PyTorch.

`lax.top_k` breaks ties toward the lower index; `torch.topk` gives no such
order (on `[1, 3, 3, 2, 3]` JAX returns indices `[1, 2, 4]`, torch
`[2, 4, 1]`). Blocky synthetic textures give many equal FAST scores and
covisibility counts tie constantly, so every `top_k` whose indices are used
goes through this helper.
"""

from __future__ import annotations

from typing import Tuple

import torch


def top_k_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries along the last axis,
    equal values in ascending index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
