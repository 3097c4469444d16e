"""Dense SPD solve for the reduced camera system of local BA (port of
`eao_fusion_tpu/solvers/chol_pallas.py:cholesky_solve_pallas`).

M x = b by the unblocked left-looking column Cholesky of M's lower
triangle, with each pivot clamped as sqrt(max(dsq, 1e-20)), then forward
and back substitution. On an indefinite M the clamp gives a huge but finite
step, which the LM accept test of `bundle_adjust_coo` rejects.

`cholesky_solve` launches the CUDA kernel `csrc/chol_solve.cu` (K4, a
blocked Cholesky on one thread block, the lower triangle in shared memory
as padded 32 x 32 tiles) for CUDA tensors, and runs the plain PyTorch
version `cholesky_solve_plain`, the column recurrence, for CPU tensors.
"""

from __future__ import annotations

import torch

from eao_fusion_tpu_torch import kernels

PIVOT_FLOOR = 1e-20
TILE = 32          # the kernel's panel width and tile size
# a block may use at most 227 KB of shared memory on Hopper
MAX_SHARED_BYTES = 227 * 1024


def shared_bytes(D: int) -> int:
    """Shared memory the kernel takes for a D x D system, padded to Dp =
    T·32 (T tiles a side): the T(T+1)/2 tiles of the lower triangle, each
    32 x 33 floats; the transposed diagonal tile (32 x 32) and panel
    (32 x (Dp - 32 + 4), its last columns for b's segment); the right-hand
    side and the reciprocal pivots (Dp each). D <= 288 fits in a block. The wrapper checks it against the
    block limit and hands it to the launch, which sizes the block's shared
    memory with it."""
    T = -(-D // TILE)
    Dp = T * TILE
    return 4 * (T * (T + 1) // 2 * TILE * (TILE + 1) + TILE * TILE
                + TILE * (Dp - TILE + 4) + 2 * Dp)


def cholesky_solve(M: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve M x = rhs for SPD M [D, D]: the kernel for CUDA tensors, the
    plain version for CPU tensors; there is no fallback between them."""
    if M.is_cuda:
        return cholesky_solve_cuda(M, rhs)
    return cholesky_solve_plain(M, rhs)


def cholesky_solve_plain(M: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: the kernel's recurrence, one column (or
    one substitution step) at a time."""
    D = M.shape[0]
    A = M.to(torch.float32)
    L = torch.zeros_like(A)
    for j in range(D):
        c = A[j:, j] - L[j:, :j] @ L[j, :j]
        d = torch.sqrt(torch.clamp(c[0], min=PIVOT_FLOOR))
        L[j, j] = d
        L[j + 1:, j] = c[1:] / d
    r = rhs.to(torch.float32).clone()
    for i in range(D):                       # L y = b
        yi = r[i] / L[i, i]
        r[i + 1:] -= L[i + 1:, i] * yi
        r[i] = yi
    for i in range(D - 1, -1, -1):           # Lᵀ x = y
        xi = r[i] / L[i, i]
        r[:i] -= L[i, :i] * xi
        r[i] = xi
    return r


def cholesky_solve_cuda(M: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """One launch of `csrc/chol_solve.cu`. Raises on what the kernel does
    not take: a D whose tiles do not fit in a block's shared memory, a CPU
    tensor, another dtype or layout."""
    D = M.shape[0]
    smem = shared_bytes(D)
    if D < 1 or smem > MAX_SHARED_BYTES:
        raise ValueError(f"cholesky kernel: D = {D} does not fit in shared "
                         f"memory ({smem} > {MAX_SHARED_BYTES} "
                         "bytes)")
    f32 = torch.float32
    kernels.require(M, "M", f32, (D, D))
    kernels.require(rhs, "rhs", f32, (D,))
    x = torch.empty(D, dtype=f32, device=M.device)
    lib = kernels.library("chol_solve")
    kernels.launch("chol_solve", lib.chol_solve_launch, M.device,
                   M.data_ptr(), rhs.data_ptr(), x.data_ptr(), D, smem)
    return x
