// Per-edge passes of the local-BA Levenberg-Marquardt iteration, for Hopper
// (sm_90a). One edge-math device function, two kernels:
//
//   ba_edge_full_kernel  replaces eao_fusion_tpu/solvers/ba_edge_pallas.py:
//                        edge_pass_full (_full_kernel + _edge_math) AND the
//                        segment sums that follow it in
//                        eao_fusion_tpu/solvers/ba.py (the one-hot
//                        dot_generals of gn_iter): per edge the residual
//                        r[3], the Huber weight, the camera Jacobian J_c[3,6]
//                        masked by the free-camera flag and the point
//                        Jacobian J_p[3,3]; it writes Y[18] = JcᵀWJp per
//                        edge, channel-major [18, E], and the sums
//                        JcᵀWJc ‖ JcᵀWr into acc_c [C, 42] per camera and
//                        JpᵀWJp ‖ JpᵀWr into acc_p [Pw, 12] per point target.
//   ba_edge_chi2_kernel  replaces edge_pass_chi2 (_chi2_kernel), in two
//                        variants of one template: <true> writes the scalar
//                        Σ robust chi2 · mask (the LM accept test), <false>
//                        the per-edge robust masked chi2, raw chi2 and
//                        behind flag, channel-major [3, E].
//
// What bounds it on this card: neither bytes nor operations. At E = 8192 an
// edge reads 28-32 B of its own, does ~650 flops and, in the full pass,
// writes 72 B of Y: under a microsecond of either, below the latency of one
// launch. So the design cuts launches and host work:
//   - everything fixed during one BA call (the edge list, uv, ur, 1/σ², the
//     free-camera flags, the point targets and the two segment layouts
//     below, the output and scratch buffers, the camera and gate scalars)
//     is one BaEdgeArgs that the wrapper builds once; a launch passes it and
//     three pointers;
//   - the segment sums are fixed-order, so that repeated calls give the same
//     bits (the LM accept test compares costs, and a last-bit change of the
//     Schur system used to move the iteration count between runs). The
//     wrapper sorts the edges once per BA call, stably, by camera and by
//     point target (two CSR layouts: the edge ids in order, and where each
//     camera's or point's run starts). The full pass has two kinds of
//     block in one grid:
//       * one block per camera walks that camera's run: thread t takes the
//         run's edges t, t + 128, ..., writes each edge's Y and adds its 27
//         camera sums (Hcc's upper triangle ‖ JcᵀWr) in that order; the
//         block then reduces the threads' sums by a fixed tree (warp
//         shuffles, then the warps in order) and writes the camera's row;
//       * one thread per point walks that point's run (about 4 edges) and
//         writes the point's row, a zero row for a point with no edge.
//     No atomics, and no memset: every row is written once. A point's
//     edges are recomputed by its thread (the edge math is ~650 flops;
//     keeping the payloads in device memory between two passes would need
//     a second launch or a grid-wide barrier);
//   - the chi2 sum is reduced in a fixed order (warp shuffles, block
//     partials, and the last block to finish adds the partials in block
//     order), so repeated calls give the same bits;
//   - each block stages the C cameras in shared memory once (quaternion ->
//     R once per camera, not per edge), rows of 13 floats: an odd stride,
//     so lanes reading different cameras hit different banks;
//   - 128 threads a block.
//
// Plain C interface (ctypes). The launch functions return cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

extern "C" {

// What stays fixed during one BA call. The wrapper's ctypes.Structure has
// the same fields in the same order; ba_edge_args_size() lets it check.
struct BaEdgeArgs {
  const int* obs_cam;     // [E] camera of each edge
  const int* obs_pt;      // [E] window point, clamped into [0, Pw)
  const int* tgt;         // [E] point row of the sums; outside [0, Pw): none
  const float* obs_uv;    // [E, 2]
  const float* obs_ur;    // [E] virtual right u, < 0 = mono
  const float* obs_is2;   // [E] 1/σ²
  const float* free_cam;  // [C] 0/1
  const int* cam_order;   // [E] edge ids sorted (stably) by camera
  const int* cam_start;   // [C + 1] where each camera's run starts
  const int* pt_order;    // [E] edge ids sorted (stably) by point target
  const int* pt_start;    // [Pw + 1] where each point's run starts
  float* acc;             // [C * 42 + Pw * 12]: acc_c, then acc_p
  float* y;               // [18, E]
  float* partials;        // [blocks] chi2 sum: one partial per block
  unsigned int* ticket;   // chi2 sum: blocks done, 0 between launches
  int C, Pw, E;
  float fx, fy, cx, cy, bf, chi2_mono, chi2_stereo;
};

}  // extern "C"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kCamRow = 13;  // R row-major (9), t (3), free flag
constexpr int kAccC = 42;    // Hcc (36) ‖ JcᵀWr (6)
constexpr int kAccP = 12;    // Hpp (9) ‖ JpᵀWr (3)
constexpr int kCamSums = 27; // Hcc's upper triangle (21) ‖ JcᵀWr (6)

static_assert(kThreads % 32 == 0 && kThreads <= 1024, "block size");

__device__ __forceinline__ void stage_cameras(const BaEdgeArgs& a,
                                              const float* __restrict__ cam_pose,
                                              float* s_cam) {
  for (int c = threadIdx.x; c < a.C; c += kThreads) {
    const float* cp = cam_pose + 7 * c;
    const float qw = cp[0], qx = cp[1], qy = cp[2], qz = cp[3];
    const float xx = qx * qx, yy = qy * qy, zz = qz * qz;
    const float xy = qx * qy, xz = qx * qz, yz = qy * qz;
    const float wx = qw * qx, wy = qw * qy, wz = qw * qz;
    float* r = s_cam + kCamRow * c;
    r[0] = 1.f - 2.f * (yy + zz);
    r[1] = 2.f * (xy - wz);
    r[2] = 2.f * (xz + wy);
    r[3] = 2.f * (xy + wz);
    r[4] = 1.f - 2.f * (xx + zz);
    r[5] = 2.f * (yz - wx);
    r[6] = 2.f * (xz - wy);
    r[7] = 2.f * (yz + wx);
    r[8] = 1.f - 2.f * (xx + yy);
    r[9] = cp[4];
    r[10] = cp[5];
    r[11] = cp[6];
    r[12] = a.free_cam[c];
  }
}

// An edge's own inputs and its point, loaded before the block waits for
// its staged cameras, so that the two sets of loads overlap.
struct EdgeIn {
  int c;             // camera, clamped into [0, C)
  float p0, p1, p2;  // the window point
  float2 uv;
  float ur, is2, act;
};

__device__ __forceinline__ EdgeIn load_edge(const BaEdgeArgs& a,
                                            const float* __restrict__ pt_xyz,
                                            const float* __restrict__ active, int e) {
  EdgeIn in;
  in.c = min(max(__ldg(a.obs_cam + e), 0), a.C - 1);
  const int pi = min(max(__ldg(a.obs_pt + e), 0), a.Pw - 1);
  in.p0 = __ldg(pt_xyz + 3 * pi);
  in.p1 = __ldg(pt_xyz + 3 * pi + 1);
  in.p2 = __ldg(pt_xyz + 3 * pi + 2);
  in.uv = __ldg(reinterpret_cast<const float2*>(a.obs_uv) + e);
  in.ur = __ldg(a.obs_ur + e);
  in.is2 = __ldg(a.obs_is2 + e);
  in.act = __ldg(active + e);
  return in;
}

struct Edge {
  const float* cam;  // the camera's staged row
  float x, y, zr;    // camera-frame point, z unclamped
  float iz, iz2, s;  // 1/z (clamped), its square, stereo 0/1
  float r0, r1, r2, c2, delta2, behind, mask;
};

// The per-edge math of _edge_math, term by term in the plain version's order.
__device__ __forceinline__ Edge edge_math(const BaEdgeArgs& a, const float* s_cam,
                                          const EdgeIn& in) {
  Edge g;
  const float* R = s_cam + kCamRow * in.c;
  g.cam = R;
  g.x = R[0] * in.p0 + R[1] * in.p1 + R[2] * in.p2 + R[9];
  g.y = R[3] * in.p0 + R[4] * in.p1 + R[5] * in.p2 + R[10];
  g.zr = R[6] * in.p0 + R[7] * in.p1 + R[8] * in.p2 + R[11];
  const float z = fmaxf(g.zr, 1e-6f);
  g.iz = 1.f / z;
  g.iz2 = g.iz * g.iz;
  const float u = a.fx * g.x * g.iz + a.cx;
  const float v = a.fy * g.y * g.iz + a.cy;
  const float urr = u - a.bf * g.iz;
  g.s = in.ur >= 0.f ? 1.f : 0.f;
  g.r0 = in.uv.x - u;
  g.r1 = in.uv.y - v;
  g.r2 = g.s * (in.ur - urr);
  g.c2 = (g.r0 * g.r0 + g.r1 * g.r1 + g.r2 * g.r2) * in.is2;
  g.delta2 = g.s * a.chi2_stereo + (1.f - g.s) * a.chi2_mono;
  g.behind = g.zr < 1e-3f ? 1.f : 0.f;
  g.mask = in.act * (1.f - g.behind);
  return g;
}

// The edge's weighted Jacobian pieces: J[3][9] = [J_c (masked by the
// free-camera flag) | J_p], the residual and the robust weight w.
struct EdgeJac {
  float J[3][9];
  float res[3];
  float w;
};

__device__ __forceinline__ EdgeJac edge_jacobian(const BaEdgeArgs& a, const Edge& g,
                                                 const EdgeIn& in) {
  EdgeJac o;
  const float* R = g.cam;
  const float w_rob = fminf(1.f, sqrtf(g.delta2 / fmaxf(g.c2, 1e-12f)));
  o.w = in.is2 * w_rob * g.mask;
  const float fm = R[12];
  const float fx = a.fx, fy = a.fy, bf = a.bf, s = g.s;
  // projection Jacobian rows (du, dv, s*dur)
  const float dp[3][3] = {{fx * g.iz, 0.f, -fx * g.x * g.iz2},
                          {0.f, fy * g.iz, -fy * g.y * g.iz2},
                          {s * fx * g.iz, 0.f, s * (-fx * g.x * g.iz2 + bf * g.iz2)}};
  // -hat(xc), on the unclamped xc
  const float nh[3][3] = {{0.f, g.zr, -g.y}, {-g.zr, 0.f, g.x}, {g.y, -g.x, 0.f}};
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      o.J[r][i] = -(dp[r][0] * nh[0][i] + dp[r][1] * nh[1][i] + dp[r][2] * nh[2][i]) * fm;
      o.J[r][3 + i] = -dp[r][i] * fm;
      o.J[r][6 + i] = -(dp[r][0] * R[i] + dp[r][1] * R[3 + i] + dp[r][2] * R[6 + i]);
    }
  }
  o.res[0] = g.r0;
  o.res[1] = g.r1;
  o.res[2] = g.r2;
  return o;
}

#define GRAM(p, q) \
  (j.w * (j.J[0][p] * j.J[0][q] + j.J[1][p] * j.J[1][q] + j.J[2][p] * j.J[2][q]))
#define GRHS(p) \
  (j.w * (j.J[0][p] * j.res[0] + j.J[1][p] * j.res[1] + j.J[2][p] * j.res[2]))

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(kFull, x, off);
  return x;
}

// One camera's row: the block walks the camera's run of edges in layout
// order, writes their Y, and sums the 27 camera channels by a fixed tree.
__device__ __forceinline__ void camera_row(const BaEdgeArgs& a, const float* s_cam,
                                           float* s_red, const float* __restrict__ pt_xyz,
                                           const float* __restrict__ active, int c) {
  const int E = a.E;
  const int k0 = __ldg(a.cam_start + c), k1 = __ldg(a.cam_start + c + 1);
  float v[kCamSums];
#pragma unroll
  for (int k = 0; k < kCamSums; ++k) v[k] = 0.f;
  for (int k = k0 + threadIdx.x; k < k1; k += kThreads) {
    const int e = __ldg(a.cam_order + k);
    const EdgeIn in = load_edge(a, pt_xyz, active, e);
    const Edge g = edge_math(a, s_cam, in);
    const EdgeJac j = edge_jacobian(a, g, in);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int q = 0; q < 3; ++q) a.y[(i * 3 + q) * E + e] = GRAM(i, 6 + q);
    }
    int n = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int q = i; q < 6; ++q) v[n++] += GRAM(i, q);
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) v[21 + i] += GRHS(i);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kCamSums; ++k) {
    const float t = warp_sum(v[k]);
    if (lane == 0) s_red[warp * kCamSums + k] = t;
  }
  __syncthreads();
  // thread i < 42 writes channel i of the row (Hcc row-major ‖ JcᵀWr),
  // the warps' sums added in warp order
  if (threadIdx.x < kAccC) {
    const int ch = threadIdx.x;
    int slot;
    if (ch >= 36) {
      slot = 21 + ch - 36;
    } else {
      int i = ch / 6, q = ch - 6 * (ch / 6);
      if (i > q) {
        const int t = i;
        i = q;
        q = t;
      }
      slot = i * 6 - i * (i - 1) / 2 + q - i;
    }
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += s_red[w * kCamSums + slot];
    a.acc[kAccC * c + ch] = sum;
  }
}

// One point's row: the thread walks the point's run of edges in layout order.
__device__ __forceinline__ void point_row(const BaEdgeArgs& a, const float* s_cam,
                                          const float* __restrict__ pt_xyz,
                                          const float* __restrict__ active, int p) {
  const int k0 = __ldg(a.pt_start + p), k1 = __ldg(a.pt_start + p + 1);
  float h[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // upper 6 ‖ rhs 3
  for (int k = k0; k < k1; ++k) {
    const int e = __ldg(a.pt_order + k);
    const EdgeIn in = load_edge(a, pt_xyz, active, e);
    const Edge g = edge_math(a, s_cam, in);
    const EdgeJac j = edge_jacobian(a, g, in);
    int n = 0;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int q = i; q < 3; ++q) h[n++] += GRAM(6 + i, 6 + q);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) h[6 + i] += GRHS(6 + i);
  }
  float* ap = a.acc + kAccC * a.C + kAccP * p;
  ap[0] = h[0];
  ap[1] = h[1];
  ap[2] = h[2];
  ap[3] = h[1];
  ap[4] = h[3];
  ap[5] = h[4];
  ap[6] = h[2];
  ap[7] = h[4];
  ap[8] = h[5];
  ap[9] = h[6];
  ap[10] = h[7];
  ap[11] = h[8];
}

#undef GRAM
#undef GRHS

// Blocks [0, C) are camera blocks, the rest point blocks of 128 points.
__global__ void __launch_bounds__(kThreads)
ba_edge_full_kernel(BaEdgeArgs a, const float* __restrict__ cam_pose,
                    const float* __restrict__ pt_xyz, const float* __restrict__ active) {
  extern __shared__ float smem[];
  float* s_cam = smem;                    // [C, 13]
  __shared__ float s_red[kWarps * kCamSums];
  stage_cameras(a, cam_pose, s_cam);
  __syncthreads();
  if (static_cast<int>(blockIdx.x) < a.C) {
    camera_row(a, s_cam, s_red, pt_xyz, active, blockIdx.x);
  } else {
    const int p = (blockIdx.x - a.C) * kThreads + threadIdx.x;
    if (p < a.Pw) point_row(a, s_cam, pt_xyz, active, p);
  }
}

// Sum of the block's values in a fixed order, valid in thread 0.
__device__ __forceinline__ float block_sum(float x, float* s_warp) {
  x = warp_sum(x);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = x;
  __syncthreads();
  float b = 0.f;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kWarps; ++i) b += s_warp[i];
  }
  return b;
}

template <bool kSum>
__global__ void __launch_bounds__(kThreads)
ba_edge_chi2_kernel(BaEdgeArgs a, const float* __restrict__ cam_pose,
                    const float* __restrict__ pt_xyz, const float* __restrict__ active,
                    float* __restrict__ out) {
  extern __shared__ float smem[];
  float* s_cam = smem;  // [C, 13]
  __shared__ float s_warp[kWarps];
  __shared__ bool s_last;
  const int E = a.E;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  EdgeIn in;
  if (e < E) in = load_edge(a, pt_xyz, active, e);
  stage_cameras(a, cam_pose, s_cam);
  __syncthreads();

  float c2r_m = 0.f;
  if (e < E) {
    const Edge g = edge_math(a, s_cam, in);
    const float c2r = g.c2 <= g.delta2 ? g.c2 : 2.f * sqrtf(g.delta2 * g.c2) - g.delta2;
    c2r_m = c2r * g.mask;
    if (!kSum) {
      out[e] = c2r_m;
      out[E + e] = g.c2;
      out[2 * E + e] = g.behind;
    }
  }
  if (!kSum) return;

  // Σ c2r·mask: the block's partial, then the last block to finish adds
  // the partials in block order and sets the ticket back to 0.
  const float b = block_sum(c2r_m, s_warp);
  if (threadIdx.x == 0) {
    a.partials[blockIdx.x] = b;
    __threadfence();
    s_last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  float t = 0.f;
  for (int i = threadIdx.x; i < static_cast<int>(gridDim.x); i += kThreads)
    t += __ldcg(a.partials + i);
  const float total = block_sum(t, s_warp);
  if (threadIdx.x == 0) {
    *out = total;
    *a.ticket = 0u;
  }
}

size_t cam_smem(int C) { return sizeof(float) * kCamRow * C; }

// Dynamic shared memory above the default 48 KB needs the kernel's opt-in.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" int ba_edge_args_size() { return static_cast<int>(sizeof(BaEdgeArgs)); }

extern "C" int ba_edge_threads() { return kThreads; }

// Largest C whose staged cameras fit one block's shared memory beside the
// static reduction buffers.
extern "C" int ba_edge_max_cameras() {
  return static_cast<int>((200 * 1024) / cam_smem(1));
}

// K2: Y and the fixed-order segment sums, one kernel (C camera blocks and
// ceil(Pw / 128) point blocks); every output row is written, so nothing is
// zeroed first.
extern "C" int ba_edge_full_launch(const BaEdgeArgs* a, const float* cam_pose,
                                   const float* pt_xyz, const float* active, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = cam_smem(a->C);
  cudaError_t err = allow_smem(ba_edge_full_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = a->C + (a->Pw + kThreads - 1) / kThreads;
  ba_edge_full_kernel<<<blocks, kThreads, smem, st>>>(*a, cam_pose, pt_xyz, active);
  return static_cast<int>(cudaGetLastError());
}

// K3: with out_sum, the scalar Σ c2r·mask into out_sum[0]; else the
// per-edge [3, E] channels into out_edges.
extern "C" int ba_edge_chi2_launch(const BaEdgeArgs* a, const float* cam_pose,
                                   const float* pt_xyz, const float* active, float* out_sum,
                                   float* out_edges, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->E <= 0) {
    return out_sum ? static_cast<int>(cudaMemsetAsync(out_sum, 0, sizeof(float), st)) : 0;
  }
  const size_t smem = cam_smem(a->C);
  const int blocks = (a->E + kThreads - 1) / kThreads;
  cudaError_t err;
  if (out_sum) {
    err = allow_smem(ba_edge_chi2_kernel<true>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ba_edge_chi2_kernel<true><<<blocks, kThreads, smem, st>>>(*a, cam_pose, pt_xyz, active,
                                                              out_sum);
  } else {
    err = allow_smem(ba_edge_chi2_kernel<false>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ba_edge_chi2_kernel<false><<<blocks, kThreads, smem, st>>>(*a, cam_pose, pt_xyz, active,
                                                               out_edges);
  }
  return static_cast<int>(cudaGetLastError());
}
