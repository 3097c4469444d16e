"""Flat visual vocabulary: bag of words as one ±1 matrix product (port of
`eao_fusion_tpu/mapping/vocabulary.py`).

Every descriptor is assigned to its nearest word by one [N, 256] x [256, W]
product of ±1 values (the largest dot product is the least Hamming
distance); a bow vector is the tf-idf weighted, L1-normalized word
histogram, and two are scored by DBoW2's L1 metric
s(v, w) = 1 − 0.5·|v − w|₁.

The product stays `torch.matmul`, as the JAX function leaves it to XLA
outside any Pallas kernel. It runs in float32 with TF32 off (the package
switches TF32 off on import), so the integer dot products are exact and
ties resolve to the first word, as `jnp.argmax` resolves them.

The vocabulary is the shipped `data/vocab.npz` (8192 words, trained in the
repo by `tools/train_vocab.py`). There is no random fallback: a missing
file raises `FileNotFoundError` (the JAX System falls back to a random
codebook).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

DEFAULT_VOCAB_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "data", "vocab.npz")


class Vocabulary:
    """words: [W, 256] int8 ±1 centroids; idf: [W] float32."""

    def __init__(self, words: np.ndarray, idf: np.ndarray, device):
        self.words = torch.as_tensor(np.asarray(words, np.int8),
                                     device=device)
        self.idf = torch.as_tensor(np.asarray(idf, np.float32),
                                   device=device)
        # the float32 [256, W] operand of the assignment product, made once
        self._words_t = self.words.float().T.contiguous()

    @property
    def n_words(self) -> int:
        return self.words.shape[0]

    @classmethod
    def load(cls, path: Optional[str] = None,
             device="cpu") -> "Vocabulary":
        """The vocabulary at `path` (by default the shipped file)."""
        path = DEFAULT_VOCAB_PATH if path is None else path
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"vocabulary {path} does not exist; train one with "
                f"tools/train_vocab.py")
        z = np.load(path)
        W = z["words"].shape[0]
        idf = z["idf"] if "idf" in z else np.ones(W, np.float32)
        return cls(z["words"], idf, device)


def assign_words(vocab: Vocabulary, desc_pm1: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """[N, 256] -> word id [N] int32 (−1 for invalid slots)."""
    sim = desc_pm1.float() @ vocab._words_t                    # [N, W]
    wid = torch.argmax(sim, dim=1).to(torch.int32)
    return torch.where(valid, wid, -1)


def bow_vector(vocab: Vocabulary, desc_pm1: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """tf-idf weighted, L1-normalized bow vector [W]."""
    W = vocab.n_words
    wid = assign_words(vocab, desc_pm1, valid)
    counts = torch.zeros((W + 1,), dtype=torch.float32,
                         device=desc_pm1.device).index_add_(
        0, torch.where(wid >= 0, wid, W).long(),
        torch.ones(wid.shape, dtype=torch.float32,
                   device=desc_pm1.device))[:W]
    v = counts * vocab.idf
    return v / torch.clamp(v.sum(), min=1e-9)


def l1_scores(query: torch.Tensor, db: torch.Tensor,
              db_valid: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 score of `query` [W] against the rows of `db` [K, W]:
    s = 1 − 0.5·Σ|q − d| (both L1-normalized). Invalid rows score 0."""
    s = 1.0 - 0.5 * torch.sum(torch.abs(db - query[None, :]), dim=1)
    return torch.where(db_valid, s, 0.0)
