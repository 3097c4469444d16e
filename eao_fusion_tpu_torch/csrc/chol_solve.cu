// Dense SPD solve M x = b in one launch, for Hopper (sm_90a): Cholesky
// factor, forward substitution and back substitution on one thread block.
//
// Replaces eao_fusion_tpu/solvers/chol_pallas.py: cholesky_solve_pallas, the
// single-dispatch solve of local BA's reduced camera system (D = C·6 = 192).
// It computes the same function: the unblocked left-looking column Cholesky
// of the lower triangle of M, each pivot clamped as sqrt(max(dsq, 1e-20)),
// then L y = b and Lᵀ x = y.
//
// What bounds it on this card: neither bytes nor operations. The function
// reads D(D+1)/2 + D floats and writes D (~74 KB at D = 192, ~0.02 µs at
// 3.35 TB/s) and does ~D³/3 + 2D² flops (~2.4 MFLOP, ~0.04 µs at 67
// TFLOP/s); what it costs is its serial chain of D dependent column steps
// and 2D dependent substitution steps. The design keeps that chain on one
// block and in shared memory, with no launch between steps:
//  - the lower triangle is packed row by row (row i at i(i+1)/2), so a
//    block holds D ≤ 339 in the 227 KB that Hopper gives one block (the
//    TPU kernel's 256x256 padded tile would need 256 KB). The wrapper
//    (solvers/chol.py: shared_bytes) sizes the shared memory, tri(D) + D
//    + 1 floats, rejects a larger D, and passes the size to the launch;
//  - factor column j: one warp per row i >= j forms the dot of rows i and
//    j over the finished columns k < j (lanes stride k, a shuffle sum) and
//    subtracts it from M[i][j]; the warp of row j also takes the pivot.
//    A barrier, the column is scaled by the pivot in parallel, a barrier:
//    two barriers per column;
//  - the substitutions run on one warp, column by column: each step is
//    one division and an update of the remaining right-hand side, with
//    __syncwarp in between.
// wgmma, TMA or blocked panels are left for a later change.
//
// Plain C interface (ctypes): chol_solve_launch returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr float kPivotFloor = 1e-20f;

__host__ __device__ __forceinline__ int tri(int i) { return i * (i + 1) / 2; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
chol_solve_kernel(const float* __restrict__ M, const float* __restrict__ b,
                  float* __restrict__ x, int D) {
  extern __shared__ float smem[];
  float* L = smem;               // packed lower triangle; M, then L in place
  float* r = smem + tri(D);      // right-hand side, then y, then x
  float* piv = r + D;            // the current column's pivot
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // the lower triangle of M, one warp per row (coalesced reads), and b
  for (int i = warp; i < D; i += kWarps)
    for (int k = lane; k <= i; k += 32) L[tri(i) + k] = M[(size_t)i * D + k];
  for (int i = threadIdx.x; i < D; i += kThreads) r[i] = b[i];
  __syncthreads();

  // factor: column j from the finished columns k < j
  for (int j = 0; j < D; ++j) {
    const float* Lj = L + tri(j);
    for (int i = j + warp; i < D; i += kWarps) {
      const float* Li = L + tri(i);
      float s = 0.f;
      for (int k = lane; k < j; k += 32) s += Li[k] * Lj[k];
      s = warp_sum(s);
      if (lane == 0) {
        const float c = Li[j] - s;
        if (i == j) {
          const float d = sqrtf(fmaxf(c, kPivotFloor));
          L[tri(i) + j] = d;
          *piv = d;
        } else {
          L[tri(i) + j] = c;
        }
      }
    }
    __syncthreads();
    const float d = *piv;
    for (int i = j + 1 + threadIdx.x; i < D; i += kThreads) L[tri(i) + j] /= d;
    __syncthreads();
  }

  if (warp != 0) return;
  // forward: L y = b, column by column
  for (int i = 0; i < D; ++i) {
    const float yi = r[i] / L[tri(i) + i];
    __syncwarp();
    for (int k = i + 1 + lane; k < D; k += 32) r[k] -= L[tri(k) + i] * yi;
    if (lane == 0) r[i] = yi;
    __syncwarp();
  }
  // back: Lᵀ x = y, column by column of Lᵀ (rows of L)
  for (int i = D - 1; i >= 0; --i) {
    const float xi = r[i] / L[tri(i) + i];
    __syncwarp();
    for (int k = lane; k < i; k += 32) r[k] -= L[tri(i) + k] * xi;
    if (lane == 0) r[i] = xi;
    __syncwarp();
  }
  for (int i = lane; i < D; i += 32) x[i] = r[i];
}

}  // namespace

// `bytes`: the shared memory of the block, tri(D) + D + 1 floats, from the
// wrapper.
extern "C" int chol_solve_launch(const float* M, const float* b, float* x,
                                 int D, int bytes, void* stream) {
  if (D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      chol_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  chol_solve_kernel<<<1, kThreads, bytes,
                      static_cast<cudaStream_t>(stream)>>>(M, b, x, D);
  return static_cast<int>(cudaGetLastError());
}
