"""Hamming distances for 256-bit ORB descriptors as one ±1 product (port
of `eao_fusion_tpu/ops/hamming.py`).

For a, b in {−1,+1}^256, hamming(a, b) = (256 − a·b) / 2, so an N×M
distance matrix is one [N,256]x[256,M] product. Invalid descriptor slots
are all-zero and score 128 > TH_HIGH, so they never win a match. The JAX
package leaves this product to XLA (no Pallas kernel), and the port leaves
it to `torch.matmul`.
"""

from __future__ import annotations

import torch

N_BITS = 256
INVALID_DIST = N_BITS // 2


def hamming_matrix(pm1_a: torch.Tensor, pm1_b: torch.Tensor) -> torch.Tensor:
    """[N, 256] x [M, 256] ±1 int8 -> [N, M] int32 Hamming distances.

    On the card the product runs in fp16 (±1 inputs and sums of at most 256
    terms are exact in it); on the CPU in f32."""
    dt = torch.float16 if pm1_a.is_cuda else torch.float32
    dot = torch.matmul(pm1_a.to(dt), pm1_b.to(dt).T).float()
    return ((N_BITS - dot) * 0.5).to(torch.int32)


def hamming_packed(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Popcount XOR distance of packed [.., 8] uint32 descriptor pairs
    (elementwise, not a matrix); for small oracle checks. The words are
    widened to int64, where the SWAR popcount's products cannot wrap."""
    m = 0xFFFFFFFF
    x = torch.bitwise_xor(a.to(torch.int64), b.to(torch.int64)) & m
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    cnt = ((x * 0x01010101) & m) >> 24
    return torch.sum(cnt, dim=-1).to(torch.int32)
