"""Student-t critical values (port of `eao_fusion_tpu/objects/ttable.py`).

The reference ships `data/t_test.txt` (122 rows x 9 cols: df, then two-sided
critical values at alpha = 0.5, 0.4, 0.2, 0.1, 0.05, 0.025, 0.01 and a
one-sided 0.001 column) and indexes column 5 (alpha=0.05) and column 8
(alpha=0.001) in the t-test association (`src/Object.cc:514-527`). The same
table is generated numerically at import."""

from __future__ import annotations

import functools

import numpy as np
import torch

N_DF = 122
COL_ALPHA_05 = 5
COL_ALPHA_001 = 8


def _build() -> np.ndarray:
    from scipy.stats import t as t_dist
    qs = [0.75, 0.80, 0.90, 0.95, 0.975, 0.9875, 0.995, 0.999]
    tab = np.zeros((N_DF, 9), np.float32)
    for df in range(1, N_DF):
        tab[df, 0] = df
        for j, q in enumerate(qs):
            tab[df, j + 1] = t_dist.ppf(q, df)
    tab[0] = tab[1]
    return tab


T_TABLE = _build()


@functools.lru_cache(maxsize=None)
def _column(device: torch.device, col: int) -> torch.Tensor:
    """One column of the table on `device`, copied there once."""
    return torch.as_tensor(T_TABLE[:, col], device=device)


def crit(df: torch.Tensor, col: int = COL_ALPHA_05) -> torch.Tensor:
    """Vectorized lookup, clamped like the reference's min(df-1, 121)."""
    return _column(df.device, col)[torch.clamp(df.long(), 1, N_DF - 1)]
