// Per-frame pose optimization in one launch, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// eao_fusion_tpu/solvers/pose_opt_pallas.py:optimize_pose_pallas (kernel
// built by _make_kernel): 4 rounds x up to 10 Gauss-Newton iterations with
// Huber IRLS, 21 H sums + 6 b sums per iteration, a 1e-6-damped unrolled
// 6x6 Cholesky, the SE(3) left retraction, an early exit at |delta| <=
// 1e-6, chi2 reclassification between rounds (5.991 / 7.815), and up to
// 128 fixed-plane factors (angleInfo / disInfo / chi2 gate).
//
// What bounds it on this card: neither bytes (~37 KB of observations) nor
// operations (~0.2 MFLOP per iteration) but latency. The iterations are
// serial, and each one ends in a block-wide reduction of 27 sums and a
// serial 6x6 solve; a second call per frame repeats the whole chain. The
// design therefore keeps everything on chip for the whole call: one thread
// block, the M observations (9 channels) and the planes in shared memory
// from the first iteration to the last, every thread striding over the
// observations and keeping its share of the 27 sums in registers, a
// warp-shuffle + shared-memory reduction, and one thread doing the solve
// and the retraction and broadcasting the pose through shared memory.
// The early exit and the round reclassification happen on the device: no
// host round trip inside the call.
//
// Plain C interface (ctypes): pose_opt_launch returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 27;  // 21 upper-triangle H entries + 6 b entries
constexpr float kEps = 1e-8f;

struct Params {
  float fx, fy, cx, cy, bf;
  int rounds, iters;
  float chi2_mono, chi2_stereo;
  float angle_info, dist_info, plane_chi2;
};

__device__ __forceinline__ int hidx(int i, int j) {
  // row-major upper triangle of a 6x6 matrix, i <= j
  return i * 6 - (i * (i - 1)) / 2 + (j - i);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Block-wide sum of n <= kThreads values per thread; the totals land in
// out[0..n) (shared), visible to all threads on return.
template <int N>
__device__ void block_sum(float (&v)[N], float* red, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = warp_sum(v[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) red[warp * N + k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x < N) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w * N + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

__device__ __forceinline__ void rotmat(const float* q, float* r) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  r[0] = 1.f - 2.f * (yy + zz); r[1] = 2.f * (xy - wz); r[2] = 2.f * (xz + wy);
  r[3] = 2.f * (xy + wz); r[4] = 1.f - 2.f * (xx + zz); r[5] = 2.f * (yz - wx);
  r[6] = 2.f * (xz - wy); r[7] = 2.f * (yz + wx); r[8] = 1.f - 2.f * (xx + yy);
}

__device__ __forceinline__ void cross3(const float* a, const float* b, float* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

// pose <- exp(delta) * pose (lie.se3_retract; mirrors _se3_retract_s).
__device__ void se3_retract(float* pose, const float* d) {
  const float w[3] = {d[0], d[1], d[2]};
  const float v[3] = {d[3], d[4], d[5]};
  const float theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const float theta = sqrtf(fmaxf(theta2, kEps * kEps));
  const bool small = theta2 < 1e-8f;
  const float sinc = small ? 0.5f - theta2 / 48.f : sinf(0.5f * theta) / theta;
  const float cw = small ? 1.f - theta2 / 8.f : cosf(0.5f * theta);
  const float dq[4] = {cw, sinc * w[0], sinc * w[1], sinc * w[2]};
  const float a = small ? 0.5f - theta2 / 24.f
                        : (1.f - cosf(theta)) / fmaxf(theta2, kEps);
  const float b = small ? 1.f / 6.f - theta2 / 120.f
                        : (theta - sinf(theta)) / fmaxf(theta2 * theta, kEps);
  float wxv[3], wwxv[3];
  cross3(w, v, wxv);
  cross3(w, wxv, wwxv);
  float dt[3];
  for (int i = 0; i < 3; ++i) dt[i] = v[i] + a * wxv[i] + b * wwxv[i];
  // q = dq * q0, normalized
  const float* q0 = pose;
  float q[4] = {dq[0] * q0[0] - dq[1] * q0[1] - dq[2] * q0[2] - dq[3] * q0[3],
                dq[0] * q0[1] + dq[1] * q0[0] + dq[2] * q0[3] - dq[3] * q0[2],
                dq[0] * q0[2] - dq[1] * q0[3] + dq[2] * q0[0] + dq[3] * q0[1],
                dq[0] * q0[3] + dq[1] * q0[2] - dq[2] * q0[1] + dq[3] * q0[0]};
  const float qn = sqrtf(fmaxf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3], kEps));
  // t = rotate(dq, t0) + dt
  const float t0[3] = {pose[4], pose[5], pose[6]};
  const float u[3] = {dq[1], dq[2], dq[3]};
  float uv[3], uuv[3];
  cross3(u, t0, uv);
  cross3(u, uv, uuv);
  for (int i = 0; i < 4; ++i) pose[i] = q[i] / qn;
  for (int i = 0; i < 3; ++i) pose[4 + i] = t0[i] + 2.f * (dq[0] * uv[i] + uuv[i]) + dt[i];
}

// Solve H x = b (H symmetric 6x6 from its upper triangle) by an unrolled
// Cholesky; mirrors _cholesky6_solve.
__device__ void cholesky6_solve(const float* Hu, const float* b, float* x) {
  float L[6][6];
  for (int j = 0; j < 6; ++j) {
    float d = Hu[hidx(j, j)];
    for (int k = 0; k < j; ++k) d -= L[j][k] * L[j][k];
    L[j][j] = sqrtf(fmaxf(d, 1e-20f));
    const float inv = 1.f / L[j][j];
    for (int i = j + 1; i < 6; ++i) {
      float s = Hu[hidx(j, i)];
      for (int k = 0; k < j; ++k) s -= L[i][k] * L[j][k];
      L[i][j] = s * inv;
    }
  }
  float y[6];
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
    for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
    for (int k = i + 1; k < 6; ++k) s -= L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

struct PointTerms {
  float ru, rv, rur;
  float Ju[6], Jv[6], Jur[6];
  float chi2;
  bool stereo, behind;
};

// Residual and Jacobian rows of one observation at pose (R, t).
__device__ __forceinline__ void point_terms(const Params& p, const float* R, const float* t,
                                            float px, float py, float pz, float ou,
                                            float ov, float our, float is2, bool jac,
                                            PointTerms& o) {
  const float x = R[0] * px + R[1] * py + R[2] * pz + t[0];
  const float y = R[3] * px + R[4] * py + R[5] * pz + t[1];
  const float zr = R[6] * px + R[7] * py + R[8] * pz + t[2];
  const float z = fmaxf(zr, 1e-6f);
  const float iz = 1.f / z;
  const float iz2 = iz * iz;
  const float u = p.fx * x * iz + p.cx;
  const float v = p.fy * y * iz + p.cy;
  const float ur = u - p.bf * iz;
  o.stereo = our >= 0.f;
  const float s = o.stereo ? 1.f : 0.f;
  o.ru = ou - u;
  o.rv = ov - v;
  o.rur = (our - ur) * s;
  o.behind = zr < 1e-3f;
  o.chi2 = (o.ru * o.ru + o.rv * o.rv + o.rur * o.rur) * is2;
  if (!jac) return;
  const float du[3] = {p.fx * iz, 0.f, -p.fx * x * iz2};
  const float dv[3] = {0.f, p.fy * iz, -p.fy * y * iz2};
  const float dur[3] = {du[0], du[1], du[2] + p.bf * iz2};
  // columns of d xc / d delta = [-hat(xc) | I]
  const float c[3][3] = {{0.f, -zr, y}, {zr, 0.f, -x}, {-y, x, 0.f}};
  for (int k = 0; k < 3; ++k) {
    o.Ju[k] = -(du[0] * c[k][0] + du[1] * c[k][1] + du[2] * c[k][2]);
    o.Jv[k] = -(dv[0] * c[k][0] + dv[1] * c[k][1] + dv[2] * c[k][2]);
    o.Jur[k] = -(dur[0] * c[k][0] + dur[1] * c[k][1] + dur[2] * c[k][2]) * s;
    o.Ju[3 + k] = -du[k];
    o.Jv[3 + k] = -dv[k];
    o.Jur[3 + k] = -dur[k] * s;
  }
}

struct PlaneTerms {
  float nc[3], ra[3], rd, Ja[3][3], c2;
};

__device__ __forceinline__ void plane_terms(const Params& p, const float* R, const float* t,
                                            const float* pl, int Q, int q, PlaneTerms& o) {
  const float nw[3] = {pl[0 * Q + q], pl[1 * Q + q], pl[2 * Q + q]};
  const float dw = pl[3 * Q + q];
  const float nm[3] = {pl[4 * Q + q], pl[5 * Q + q], pl[6 * Q + q]};
  const float dm = pl[7 * Q + q];
  for (int i = 0; i < 3; ++i) o.nc[i] = R[3 * i] * nw[0] + R[3 * i + 1] * nw[1] + R[3 * i + 2] * nw[2];
  const float dc = dw - (o.nc[0] * t[0] + o.nc[1] * t[1] + o.nc[2] * t[2]);
  cross3(o.nc, nm, o.ra);
  o.rd = dc - dm;
  // J_ang (rotation block) = hat(n_m) hat(n_c) = n_c n_m^T - (n_m . n_c) I
  const float dot = o.nc[0] * nm[0] + o.nc[1] * nm[1] + o.nc[2] * nm[2];
  for (int r = 0; r < 3; ++r)
    for (int k = 0; k < 3; ++k) o.Ja[r][k] = o.nc[r] * nm[k] - (r == k ? dot : 0.f);
  o.c2 = p.angle_info * (o.ra[0] * o.ra[0] + o.ra[1] * o.ra[1] + o.ra[2] * o.ra[2]) +
         p.dist_info * o.rd * o.rd;
}

__global__ void __launch_bounds__(kThreads, 1)
pose_opt_kernel(const float* __restrict__ pose0, const float* __restrict__ obs, int M,
                const float* __restrict__ planes, int Q, Params p,
                float* __restrict__ pose_out, float* __restrict__ inl_out,
                float* __restrict__ stats) {
  extern __shared__ float smem[];
  // shared layout: 8 observation channels, inlier flags, 9 plane channels,
  // plane inlier flags
  float* so = smem;                 // [8, M] px py pz u v ur is2 valid
  float* s_inl = so + 8 * M;        // [M]
  float* s_pl = s_inl + M;          // [9, Q]
  float* s_plinl = s_pl + 9 * Q;    // [Q]
  __shared__ float red[kWarps * kSums];
  __shared__ float sums[kSums];
  __shared__ float s_pose[7];
  __shared__ float s_dn;
  __shared__ int s_iters;

  const int tid = threadIdx.x;
  for (int i = tid; i < 8 * M; i += kThreads) so[i] = obs[i];
  for (int m = tid; m < M; m += kThreads) s_inl[m] = obs[7 * M + m];  // = valid
  for (int i = tid; i < 9 * Q; i += kThreads) s_pl[i] = planes[i];
  for (int q = tid; q < Q; q += kThreads) s_plinl[q] = planes[8 * Q + q];
  if (tid < 7) s_pose[tid] = pose0[tid];
  if (tid == 0) s_iters = 0;
  __syncthreads();

  const float* spx = so;
  const float* spy = so + M;
  const float* spz = so + 2 * M;
  const float* sou = so + 3 * M;
  const float* sov = so + 4 * M;
  const float* sour = so + 5 * M;
  const float* sis2 = so + 6 * M;
  const float* sval = so + 7 * M;

  for (int round = 0; round < p.rounds; ++round) {
    if (tid == 0) s_dn = INFINITY;
    __syncthreads();
    for (int it = 0; it < p.iters && s_dn > 1e-6f; ++it) {
      float pose[7], R[9];
      for (int i = 0; i < 7; ++i) pose[i] = s_pose[i];
      rotmat(pose, R);
      const float* t = pose + 4;
      float acc[kSums];
#pragma unroll
      for (int k = 0; k < kSums; ++k) acc[k] = 0.f;
      for (int m = tid; m < M; m += kThreads) {
        PointTerms o;
        point_terms(p, R, t, spx[m], spy[m], spz[m], sou[m], sov[m], sour[m], sis2[m],
                    true, o);
        const float delta2 = o.stereo ? p.chi2_stereo : p.chi2_mono;
        const float w_rob = fminf(1.f, sqrtf(delta2 / fmaxf(o.chi2, 1e-12f)));
        const float w = sis2[m] * w_rob * s_inl[m] * sval[m] * (o.behind ? 0.f : 1.f);
        if (w == 0.f) continue;
#pragma unroll
        for (int i = 0; i < 6; ++i) {
#pragma unroll
          for (int j = i; j < 6; ++j)
            acc[hidx(i, j)] += w * (o.Ju[i] * o.Ju[j] + o.Jv[i] * o.Jv[j] + o.Jur[i] * o.Jur[j]);
          acc[21 + i] -= w * (o.Ju[i] * o.ru + o.Jv[i] * o.rv + o.Jur[i] * o.rur);
        }
      }
      for (int q = tid; q < Q; q += kThreads) {
        PlaneTerms o;
        plane_terms(p, R, t, s_pl, Q, q, o);
        const float hub = fminf(1.f, sqrtf(p.plane_chi2 / fmaxf(o.c2, 1e-12f)));
        const float pw = s_pl[8 * Q + q] * hub * s_plinl[q];
        if (pw == 0.f) continue;
        for (int i = 0; i < 3; ++i) {
          for (int j = i; j < 3; ++j) {
            acc[hidx(i, j)] += p.angle_info * pw *
                               (o.Ja[0][i] * o.Ja[0][j] + o.Ja[1][i] * o.Ja[1][j] +
                                o.Ja[2][i] * o.Ja[2][j]);
            acc[hidx(3 + i, 3 + j)] += p.dist_info * pw * o.nc[i] * o.nc[j];
          }
          acc[21 + i] -= p.angle_info * pw *
                         (o.Ja[0][i] * o.ra[0] + o.Ja[1][i] * o.ra[1] + o.Ja[2][i] * o.ra[2]);
          // the distance Jacobian's v block is -n_c
          acc[24 + i] += p.dist_info * pw * o.nc[i] * o.rd;
        }
      }
      block_sum<kSums>(acc, red, sums);
      if (tid == 0) {
        float Hu[21], b[6], d[6];
        for (int k = 0; k < 21; ++k) Hu[k] = sums[k];
        for (int i = 0; i < 6; ++i) {
          Hu[hidx(i, i)] += 1e-6f;
          b[i] = sums[21 + i];
        }
        cholesky6_solve(Hu, b, d);
        const float s = d[0] + d[1] + d[2] + d[3] + d[4] + d[5];
        const bool good = isfinite(s);
        float dn2 = 0.f;
        for (int i = 0; i < 6; ++i) {
          d[i] = good ? d[i] : 0.f;
          dn2 += d[i] * d[i];
        }
        for (int i = 0; i < 7; ++i) pose[i] = s_pose[i];
        se3_retract(pose, d);
        for (int i = 0; i < 7; ++i) s_pose[i] = pose[i];
        s_dn = sqrtf(dn2);
        s_iters += 1;
      }
      __syncthreads();
    }
    // reclassify the point and plane inliers for the next round
    float pose[7], R[9];
    for (int i = 0; i < 7; ++i) pose[i] = s_pose[i];
    rotmat(pose, R);
    for (int m = tid; m < M; m += kThreads) {
      PointTerms o;
      point_terms(p, R, pose + 4, spx[m], spy[m], spz[m], sou[m], sov[m], sour[m], sis2[m],
                  false, o);
      const float thresh = o.stereo ? p.chi2_stereo : p.chi2_mono;
      s_inl[m] = (o.chi2 <= thresh && !o.behind) ? sval[m] : 0.f;
    }
    for (int q = tid; q < Q; q += kThreads) {
      PlaneTerms o;
      plane_terms(p, R, pose + 4, s_pl, Q, q, o);
      s_plinl[q] = (o.c2 <= p.plane_chi2) ? s_pl[8 * Q + q] : 0.f;
    }
    __syncthreads();
  }

  // final chi2 over the final inlier set
  float pose[7], R[9];
  for (int i = 0; i < 7; ++i) pose[i] = s_pose[i];
  rotmat(pose, R);
  float acc[2] = {0.f, 0.f};
  for (int m = tid; m < M; m += kThreads) {
    PointTerms o;
    point_terms(p, R, pose + 4, spx[m], spy[m], spz[m], sou[m], sov[m], sour[m], sis2[m],
                false, o);
    acc[0] += s_inl[m];
    acc[1] += o.chi2 * s_inl[m];
    inl_out[m] = s_inl[m];
  }
  block_sum<2>(acc, red, sums);
  if (tid == 0) {
    for (int i = 0; i < 7; ++i) pose_out[i] = s_pose[i];
    pose_out[7] = static_cast<float>(s_iters);
    stats[0] = sums[0];
    stats[1] = sums[1];
  }
}

}  // namespace

extern "C" int pose_opt_launch(const float* pose0, const float* obs, int M, const float* planes,
                               int Q, float fx, float fy, float cx, float cy, float bf,
                               int rounds, int iters, float chi2_mono, float chi2_stereo,
                               float angle_info, float dist_info, float plane_chi2,
                               float* pose_out, float* inl_out, float* stats, void* stream) {
  Params p{fx, fy, cx, cy, bf, rounds, iters, chi2_mono, chi2_stereo,
           angle_info, dist_info, plane_chi2};
  const size_t shmem = sizeof(float) * (9 * static_cast<size_t>(M) + 10 * static_cast<size_t>(Q));
  if (shmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(pose_opt_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(shmem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  pose_opt_kernel<<<1, kThreads, shmem, static_cast<cudaStream_t>(stream)>>>(
      pose0, obs, M, planes, Q, p, pose_out, inl_out, stats);
  return static_cast<int>(cudaGetLastError());
}
