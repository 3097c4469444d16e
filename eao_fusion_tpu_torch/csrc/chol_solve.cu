// Dense SPD solve M x = b in one launch, for Hopper (sm_90a): a blocked
// Cholesky factor with the forward substitution folded in, then a blocked
// back substitution, on one thread block of 512 threads.
//
// Replaces eao_fusion_tpu/solvers/chol_pallas.py: cholesky_solve_pallas, the
// single-dispatch solve of local BA's reduced camera system (D = C·6 = 192
// on the main path, 72 in a 12-keyframe window). It computes the same
// function: the Cholesky factor of the lower triangle of M, each pivot
// clamped as sqrt(max(dsq, 1e-20)), then L y = b and Lᵀ x = y. Only the
// order of the float32 sums and the rounding of the pivot's square root
// and reciprocal (rsqrtf) differ from the column recurrence of the plain
// version (solvers/chol.py: cholesky_solve_plain).
//
// What bounds it on this card: latency, not bytes or operations. The
// function reads D(D+1)/2 + D floats and writes D (~74 KB at D = 192,
// ~0.02 µs at 3.35 TB/s) and does ~D³/3 + 2D² flops (~2.4 MFLOP, ~0.04 µs
// at 67 TFLOP/s over the whole card). On one SM its D³/6 multiply-adds
// alone take ~5 µs; the rest is the chain of dependent panel steps and the
// block barriers between them. The design keeps that chain short:
//  - storage: the lower triangle as T(T+1)/2 tiles of kNb x kNb (T =
//    ceil(D / kNb)), each row padded by one float, so a lane reading row
//    `lane` or column `lane` of a tile hits its own bank. A ragged last
//    panel is padded with the identity (and b with 0): the padded system is
//    block diagonal, its padded rows of L are exactly 0, and the real part
//    of the solve is the same arithmetic as without the padding. The load
//    keeps 8 tiles in flight per thread;
//  - each panel k, three block barriers: one warp factors the diagonal
//    tile in registers, lane i holding row i, with shuffles and no block
//    barrier (pivots by rsqrtf: IEEE sqrtf and division doubled this
//    chain), while the other warps finish the previous panel's trailing
//    update (lookahead: the tile column the factor needs was updated
//    first); the
//    rows below the tile are solved against it, one thread per row in
//    registers, reading the factored tile as broadcast float4s of a
//    transposed copy (LT); b's segment is one more such row, which makes
//    it y_k, so the forward substitution costs no barrier of its own; each
//    solved row also goes into a transposed panel (PT), from which the
//    trailing update reads float4s without bank conflicts, every thread
//    owning 4x4 register tiles (tiles above the diagonal skipped);
//  - back substitution, one barrier per tile row: a warp solves the tile's
//    triangle with shuffles while the other warps apply the previous
//    tile's solution to the rows before it; the warp whose threads updated
//    the next tile's rows goes on to solve it without waiting for the
//    block.
// At D = 192 that is 6 panels and 17 + 6 block barriers (the unblocked
// column design had 384, and 384 dependent one-warp substitution steps).
// Float32 throughout: no tensor cores, no TF32.
// Spreading the factor over a thread block cluster and TMA loads are left
// for later.
//
// Shared memory (floats): LT [kNb·kNb], PT [kNb · (Dp − kNb + 4)], r [Dp],
// dinv [Dp], tiles [T(T+1)/2 · kNb·(kNb+1)], Dp = T·kNb; the wrapper
// (solvers/chol.py: shared_bytes) computes the same size, rejects a D it
// cannot hold (D ≤ 288 fits in the 227 KB of one block) and passes it.
//
// Plain C interface (ctypes): chol_solve_launch returns cudaGetLastError().

#include <atomic>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kNb = 32;              // panel width and tile size
constexpr int kLd = kNb + 1;         // padded tile row
constexpr int kTile = kNb * kLd;     // floats per tile
constexpr int kThreads = 512;
constexpr float kPivotFloor = 1e-20f;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ __forceinline__ int tiles_before(int i) {
  return i * (i + 1) / 2;
}

// the transposed panel: kNb rows of the panel's Dp - kNb rows below the
// diagonal tile, then 4 columns, the first of which holds y_k
__host__ __device__ __forceinline__ int panel_ld(int Dp) { return Dp - kNb + 4; }

__host__ __device__ __forceinline__ size_t smem_floats(int D) {
  const int T = (D + kNb - 1) / kNb, Dp = T * kNb;
  return static_cast<size_t>(kNb) * kNb + static_cast<size_t>(kNb) * panel_ld(Dp) +
         2 * static_cast<size_t>(Dp) + static_cast<size_t>(tiles_before(T)) * kTile;
}

// tile index t of a lower triangle of tiles -> (i, j), j <= i
__device__ __forceinline__ void tile_ij(int t, int& i, int& j) {
  i = 0;
  j = t;
  while (j > i) j -= ++i;
}

// Factor the diagonal tile A in place (one warp; lane i holds row i, and
// lane k hands L[k][j] to the lanes below it by a shuffle). Each finished
// column also goes into LT (the tile transposed), the reciprocal pivots
// into dk.
__device__ __forceinline__ void factor_diag(float* A, float* LT, float* dk, int lane) {
  float a[kNb];
#pragma unroll
  for (int c = 0; c < kNb; ++c) a[c] = A[lane * kLd + c];
#pragma unroll
  for (int j = 0; j < kNb; ++j) {
    const float dsq = fmaxf(__shfl_sync(kFull, a[j], j), kPivotFloor);
    const float inv = rsqrtf(dsq);
    a[j] = (lane == j) ? dsq * inv : a[j] * inv;   // column j of L (rows >= j)
    LT[j * kNb + lane] = a[j];
#pragma unroll
    for (int k = j + 1; k < kNb; ++k) {
      const float lkj = __shfl_sync(kFull, a[j], k);
      if (lane >= k) a[k] = fmaf(-a[j], lkj, a[k]);
    }
    if (lane == j) dk[j] = inv;
  }
  // entries above the diagonal (and LT's below it) are never read again
#pragma unroll
  for (int c = 0; c < kNb; ++c) A[lane * kLd + c] = a[c];
}

// Solve a row vector against the factored diagonal tile, row <- row · L_kk⁻ᵀ
// (the rows below the tile, and the right-hand side's segment, which this
// turns into y_k), in place and into column `pt` of the transposed panel.
__device__ __forceinline__ void panel_row(float* row, const float* LT, const float* dk,
                                          float* pt, int ldp) {
  float a[kNb];
#pragma unroll
  for (int c = 0; c < kNb; ++c) a[c] = row[c];
#pragma unroll
  for (int c = 0; c < kNb; ++c) {
    a[c] *= dk[c];
#pragma unroll
    for (int q = (c + 1) / 4; q < kNb / 4; ++q) {
      const float4 l = reinterpret_cast<const float4*>(LT + c * kNb)[q];
      if (4 * q + 0 > c) a[4 * q + 0] = fmaf(-a[c], l.x, a[4 * q + 0]);
      if (4 * q + 1 > c) a[4 * q + 1] = fmaf(-a[c], l.y, a[4 * q + 1]);
      if (4 * q + 2 > c) a[4 * q + 2] = fmaf(-a[c], l.z, a[4 * q + 2]);
      if (4 * q + 3 > c) a[4 * q + 3] = fmaf(-a[c], l.w, a[4 * q + 3]);
    }
  }
#pragma unroll
  for (int c = 0; c < kNb; ++c) {
    row[c] = a[c];
    pt[c * ldp] = a[c];
  }
}

// A 4x4 register tile of the trailing update by the panel in PT: the tile
// whose panel rows start at pi (rows) and pj (columns), A -= P_i P_jᵀ.
__device__ __forceinline__ void update_4x4(float* A, const float* pi, const float* pj,
                                           int ldp) {
  float acc[4][4] = {};
#pragma unroll 8
  for (int m = 0; m < kNb; ++m) {
    const float4 u = *reinterpret_cast<const float4*>(pi + m * ldp);
    const float4 w = *reinterpret_cast<const float4*>(pj + m * ldp);
    const float uu[4] = {u.x, u.y, u.z, u.w};
    const float ww[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int p = 0; p < 4; ++p) acc[q][p] = fmaf(uu[q], ww[p], acc[q][p]);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int p = 0; p < 4; ++p) A[q * kLd + p] -= acc[q][p];
}

// One entry of the right-hand side's forward update: r_e -= y_k · L[e][k's
// columns], from the transposed panel (y_k in column py, row e in pe).
__device__ __forceinline__ void update_rhs(float* re, const float* py, const float* pe,
                                           int ldp) {
  float s = 0.f;
#pragma unroll 8
  for (int m = 0; m < kNb; ++m) s = fmaf(py[m * ldp], pe[m * ldp], s);
  *re -= s;
}

// Lᵀ_kk x = r_k in place (one warp; lane i holds entry i).
__device__ __forceinline__ void back_tile(const float* Lkk, float* rk, const float* dk,
                                          int lane) {
  float l[kNb];
#pragma unroll
  for (int c = 0; c < kNb; ++c) l[c] = Lkk[c * kLd + lane];   // L[c][lane]
  const float dl = dk[lane];
  float v = rk[lane];
#pragma unroll
  for (int c = kNb - 1; c >= 0; --c) {
    const float xc = __shfl_sync(kFull, v * dl, c);
    if (lane == c) v = xc;
    else if (lane < c) v = fmaf(-l[c], xc, v);
  }
  rk[lane] = v;
}

__global__ void __launch_bounds__(kThreads, 1)
chol_solve_kernel(const float* __restrict__ M, const float* __restrict__ b,
                  float* __restrict__ x, int D) {
  extern __shared__ __align__(16) float smem[];
  const int T = (D + kNb - 1) / kNb, Dp = T * kNb, ldp = panel_ld(Dp);
  float* LT = smem;                  // the factored diagonal tile, transposed
  float* PT = LT + kNb * kNb;        // the solved panel, transposed [kNb][ldp]
  float* r = PT + kNb * ldp;         // right-hand side, then y, then x
  float* dinv = r + Dp;              // reciprocal pivots
  float* L = dinv + Dp;              // the tiles of the lower triangle
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int py = Dp - kNb;           // the column of y_k in PT
  auto tile = [&](int i, int j) { return L + (tiles_before(i) + j) * kTile; };

  // M's lower triangle into the tiles (above the diagonal and in the
  // padding 0, the padding's diagonal 1), 8 tiles in flight at a time; b,
  // padded with 0
  {
    constexpr int kPer = kNb * kNb / kThreads;   // elements of a tile a thread
    constexpr int kBatch = 8;
    const int nt = tiles_before(T);
    int bi = 0, bj = 0;                          // the batch's first tile
    for (int t0 = 0; t0 < nt; t0 += kBatch) {
      float v[kBatch][kPer];
      int i = bi, j = bj;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
#pragma unroll
        for (int q = 0; q < kPer; ++q) {
          const int e = tid + q * kThreads;
          const int gr = i * kNb + e / kNb, gc = j * kNb + e % kNb;
          v[u][q] = (t0 + u < nt && gr < D && gc <= gr)
                        ? __ldg(M + static_cast<size_t>(gr) * D + gc)
                        : (gr == gc ? 1.f : 0.f);
        }
        if (++j > i) { ++i; j = 0; }
      }
      i = bi;
      j = bj;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (t0 + u < nt) {
#pragma unroll
          for (int q = 0; q < kPer; ++q) {
            const int e = tid + q * kThreads;
            tile(i, j)[(e / kNb) * kLd + e % kNb] = v[u][q];
          }
        }
        if (++j > i) { ++i; j = 0; }
      }
      bi = i;
      bj = j;
    }
  }
  for (int i = tid; i < Dp; i += kThreads) r[i] = i < D ? b[i] : 0.f;
  __syncthreads();

  // factor panel by panel; the forward substitution rides along, b being
  // one more row below each diagonal tile. Panel k, three barriers:
  //  A: warp 0 factors diagonal tile k while the other warps finish panel
  //     k-1's update of the tile columns after k (lookahead);
  //  B: the rows below tile k and b's segment k are solved against it;
  //  C: panel k updates tile column k+1 and b's segment k+1, which A of
  //     panel k+1 needs first.
  for (int k = 0; k < T; ++k) {
    if (warp == 0) {
      factor_diag(tile(k, k), LT, dinv + k * kNb, lane);
    } else if (k > 0) {
      const int n = T - k - 1;   // tile columns k+1 .. T-1 of panel k-1
      const int nsub = tiles_before(n) * 64;
      for (int s = tid - 32; s < nsub + n * kNb; s += kThreads - 32) {
        if (s < nsub) {
          int ti, tj;
          tile_ij(s >> 6, ti, tj);
          const int rb = ((s >> 3) & 7) * 4, cb = (s & 7) * 4;
          if (ti == tj && cb > rb) continue;   // above the diagonal
          update_4x4(tile(k + 1 + ti, k + 1 + tj) + rb * kLd + cb,
                     PT + (ti + 1) * kNb + rb, PT + (tj + 1) * kNb + cb, ldp);
        } else {
          const int e = s - nsub;          // b's segments k+1 ..
          update_rhs(r + (k + 1) * kNb + e, PT + py, PT + kNb + e, ldp);
        }
      }
    }
    __syncthreads();
    const int rows = Dp - (k + 1) * kNb;
    if (tid < rows) {
      panel_row(tile(k + 1 + tid / kNb, k) + (tid % kNb) * kLd, LT, dinv + k * kNb,
                PT + tid, ldp);
    } else if (tid == rows) {
      panel_row(r + k * kNb, LT, dinv + k * kNb, PT + py, ldp);
    }
    __syncthreads();
    if (k == T - 1) break;
    // tile column k+1 (tiles (k+1+ti, k+1)) and b's segment k+1
    const int n = T - k - 1;
    for (int s = tid; s < n * 64 + kNb; s += kThreads) {
      if (s < n * 64) {
        const int ti = s >> 6;
        const int rb = ((s >> 3) & 7) * 4, cb = (s & 7) * 4;
        if (ti == 0 && cb > rb) continue;
        update_4x4(tile(k + 1 + ti, k + 1) + rb * kLd + cb, PT + ti * kNb + rb, PT + cb,
                   ldp);
      } else {
        const int e = s - n * 64;
        update_rhs(r + (k + 1) * kNb + e, PT + py, PT + e, ldp);
      }
    }
    __syncthreads();
  }

  // back: Lᵀ x = y. Step k: thread t < k·kNb updates row t with x_k; warp
  // k-1, which holds tile k-1's rows, then solves tile k-1.
  if (warp == 0) back_tile(tile(T - 1, T - 1), r + (T - 1) * kNb, dinv + (T - 1) * kNb, lane);
  __syncthreads();
  for (int k = T - 1; k >= 1; --k) {
    if (tid < k * kNb) {
      const float* col = tile(k, tid / kNb) + tid % kNb;
      const float* xk = r + k * kNb;
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < kNb; ++c) s = fmaf(col[c * kLd], xk[c], s);
      r[tid] -= s;
    }
    if (warp == k - 1) {
      __syncwarp();
      back_tile(tile(k - 1, k - 1), r + (k - 1) * kNb, dinv + (k - 1) * kNb, lane);
    }
    __syncthreads();
  }
  for (int i = tid; i < D; i += kThreads) x[i] = r[i];
}

}  // namespace

constexpr int kMaxCards = 64;
constexpr int kMaxD = 288;   // the largest D whose tiles fit in 227 KB

// `bytes`: the shared memory of the block from the wrapper; it must hold
// smem_floats(D) floats. Launched on the current card (the wrapper enters
// the tensors' card first).
extern "C" int chol_solve_launch(const float* M, const float* b, float* x,
                                 int D, int bytes, void* stream) {
  const size_t max_bytes = sizeof(float) * smem_floats(kMaxD);
  if (D <= 0 || D > kMaxD ||
      static_cast<size_t>(bytes) < sizeof(float) * smem_floats(D) ||
      static_cast<size_t>(bytes) > max_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  // The shared-memory opt-in holds for the current card only, and is set
  // to the exact value given: so each card gets it once, at the size of
  // the largest D, and no launch on any thread ever lowers it.
  static std::atomic<bool> opted_in[kMaxCards];
  int card = 0;
  cudaError_t err = cudaGetDevice(&card);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (card >= kMaxCards) return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted_in[card].load()) {
    err = cudaFuncSetAttribute(chol_solve_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(max_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[card].store(true);
  }
  chol_solve_kernel<<<1, kThreads, bytes,
                      static_cast<cudaStream_t>(stream)>>>(M, b, x, D);
  return static_cast<int>(cudaGetLastError());
}
