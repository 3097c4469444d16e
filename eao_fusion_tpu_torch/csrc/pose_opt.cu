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
// What bounds it on this card: neither bytes (~30 KB of observations) nor
// operations (~0.33 MFLOP per iteration) but latency. The iterations are
// serial, and each one ends in a block-wide sum of 27 values and a 6x6
// solve; a second call per frame repeats the whole chain. The design keeps
// that chain short:
//  - one block of 256 threads; thread t holds observations t, t + 256,
//    t + 512 and t + 768 (M <= 1024) and plane slot t (Q <= 128) in
//    registers for the whole call, loaded once from the caller's tensors
//    where they lie (pts_w [M,3], uv [M,2], uright, inv_sigma2, valid as
//    bytes; plane_w [Q,4], meas_c [Q,4], valid), with no packing launch
//    before the kernel. 256 threads, not 512 or 384: every warp repeats
//    the iteration's tail below, so fewer warps issue less of it;
//  - per observation the Jacobian is written out and its three structural
//    zeros are left out of the 27 sums at compile time;
//  - per iteration one block barrier: a warp sums its 27 partials by a
//    transposed butterfly (each of 5 shuffle steps halves the values a lane
//    carries, 31 shuffles, lane i ends with sum i), writes them to a
//    double-buffered shared array, and after the barrier every warp adds
//    the 8 warps' partials in the same order, broadcasts them by shuffles,
//    and solves the damped 6x6 system (unrolled Cholesky, rsqrtf pivots)
//    and the retraction (one sincosf) itself. Every thread thus holds the
//    same pose bit for bit, and the early-exit test is uniform without a
//    shared flag; there is no single-thread tail and no broadcast barrier;
//  - the reclassification between rounds touches only a thread's own
//    registers: no barrier;
//  - the outputs are what the caller reads: the pose [7], the inlier flags
//    as bool bytes, n_inliers as int32 and the chi2, so a call is exactly
//    one device kernel.
// Splitting M over a thread block cluster is left for later.
//
// Plain C interface (ctypes): pose_opt_launch returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kObsPerThread = 4;
constexpr int kMaxObs = kThreads * kObsPerThread;
constexpr int kMaxPlanes = 128;
constexpr int kSums = 27;  // 21 upper-triangle H entries + 6 b entries
constexpr float kEps = 1e-8f;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  float fx, fy, cx, cy, bf;
  int rounds, iters;
  float chi2_mono, chi2_stereo;
  float angle_info, dist_info, plane_chi2;
};

struct Inputs {
  const float* pose0;
  const float* pts_w;            // [M, 3]
  const float* uv;               // [M, 2]
  const float* uright;           // [M]
  const float* inv_sigma2;       // [M]
  const unsigned char* valid;    // [M] bool
  int M;
  const float* plane_w;          // [Q, 4]
  const float* meas_c;           // [Q, 4]
  const unsigned char* pvalid;   // [Q] bool
  int Q;
};

struct Outputs {
  float* pose;                   // [7]
  unsigned char* inliers;        // [M] bool
  int* n_inliers;                // []
  float* chi2;                   // []
};

// an observation as a thread holds it
struct Obs {
  float px, py, pz, u, v, ur, is2, valid, inl;
};

// a plane slot as a thread holds it
struct Plane {
  float nw[3], dw, nm[3], dm, valid, inl;
};

__host__ __device__ constexpr int hidx(int i, int j) {
  // row-major upper triangle of a 6x6 matrix, i <= j
  return i * 6 - (i * (i - 1)) / 2 + (j - i);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// One step of the transposed butterfly: the lanes with bit O set keep the
// upper half of v[0, 2O), the others the lower half, each adding the half
// its partner (lane ^ O) keeps.
template <int O>
__device__ __forceinline__ void fold(float (&v)[32], int lane) {
  const bool up = lane & O;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float keep = up ? v[O + i] : v[i];
    const float send = up ? v[i] : v[O + i];
    v[i] = keep + __shfl_xor_sync(kFull, send, O);
  }
}

// Warp sum of 32 values per lane; lane i returns the sum of value i.
__device__ __forceinline__ float warp_transpose_sum(float (&v)[32], int lane) {
  fold<16>(v, lane);
  fold<8>(v, lane);
  fold<4>(v, lane);
  fold<2>(v, lane);
  fold<1>(v, lane);
  return v[0];
}

__device__ __forceinline__ void rotmat(const float (&q)[7], float (&r)[9]) {
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

// pose <- exp(delta) * pose (lie.se3_retract; mirrors _se3_retract_s), with
// sin θ = 2 sin(θ/2) cos(θ/2) and 1 - cos θ = 2 sin²(θ/2) from one sincosf.
// It ends every GN iteration's serial chain, so it divides by reciprocal
// square roots and __fdividef (a few ulp) instead of IEEE sqrt and division.
__device__ __forceinline__ void se3_retract(float (&pose)[7], const float (&d)[6]) {
  const float w[3] = {d[0], d[1], d[2]};
  const float v[3] = {d[3], d[4], d[5]};
  const float theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const float theta2c = fmaxf(theta2, kEps * kEps);
  const float inv_theta = rsqrtf(theta2c);
  const float theta = theta2c * inv_theta;
  const bool small = theta2 < 1e-8f;
  float sh, ch;
  sincosf(0.5f * theta, &sh, &ch);
  const float sinc = small ? 0.5f - theta2 / 48.f : sh * inv_theta;
  const float cw = small ? 1.f - theta2 / 8.f : ch;
  const float dq[4] = {cw, sinc * w[0], sinc * w[1], sinc * w[2]};
  const float a = small ? 0.5f - theta2 / 24.f : __fdividef(2.f * sh * sh, fmaxf(theta2, kEps));
  const float b = small ? 1.f / 6.f - theta2 / 120.f
                        : __fdividef(theta - 2.f * sh * ch, fmaxf(theta2 * theta, kEps));
  float wxv[3], wwxv[3];
  cross3(w, v, wxv);
  cross3(w, wxv, wwxv);
  float dt[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) dt[i] = v[i] + a * wxv[i] + b * wwxv[i];
  // q = dq * q0, normalized
  const float q0[4] = {pose[0], pose[1], pose[2], pose[3]};
  const float q[4] = {dq[0] * q0[0] - dq[1] * q0[1] - dq[2] * q0[2] - dq[3] * q0[3],
                      dq[0] * q0[1] + dq[1] * q0[0] + dq[2] * q0[3] - dq[3] * q0[2],
                      dq[0] * q0[2] - dq[1] * q0[3] + dq[2] * q0[0] + dq[3] * q0[1],
                      dq[0] * q0[3] + dq[1] * q0[2] - dq[2] * q0[1] + dq[3] * q0[0]};
  const float inv_qn = rsqrtf(fmaxf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3], kEps));
  // t = rotate(dq, t0) + dt
  const float t0[3] = {pose[4], pose[5], pose[6]};
  const float u[3] = {dq[1], dq[2], dq[3]};
  float uv[3], uuv[3];
  cross3(u, t0, uv);
  cross3(u, uv, uuv);
#pragma unroll
  for (int i = 0; i < 4; ++i) pose[i] = q[i] * inv_qn;
#pragma unroll
  for (int i = 0; i < 3; ++i) pose[4 + i] = t0[i] + 2.f * (dq[0] * uv[i] + uuv[i]) + dt[i];
}

// Solve H x = b (H symmetric 6x6 from its upper triangle Hu) by a fully
// unrolled Cholesky; mirrors _cholesky6_solve. The pivots' square roots and
// reciprocals come from one rsqrtf each (a few ulp), the divisions are
// multiplications by them: the chain of the solve is the iteration's
// serial tail.
__device__ __forceinline__ void cholesky6_solve(const float (&Hu)[21], const float (&b)[6],
                                                float (&x)[6]) {
  float L[6][6], inv[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float d = Hu[hidx(j, j)];
#pragma unroll
    for (int k = 0; k < j; ++k) d -= L[j][k] * L[j][k];
    d = fmaxf(d, 1e-20f);
    inv[j] = rsqrtf(d);
    L[j][j] = d * inv[j];
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float s = Hu[hidx(j, i)];
#pragma unroll
      for (int k = 0; k < j; ++k) s -= L[i][k] * L[j][k];
      L[i][j] = s * inv[j];
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
    y[i] = s * inv[i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s -= L[k][i] * x[k];
    x[i] = s * inv[i];
  }
}

struct PointTerms {
  float ru, rv, rur;
  float Ju[6], Jv[6], Jur[6];
  float chi2;
  bool stereo, behind;
};

// Residual and Jacobian rows of one observation at the pose (R, its
// rotation). Arrays go by reference, so that they stay in registers.
__device__ __forceinline__ void point_terms(const Params& p, const float (&R)[9],
                                            const float (&pose)[7], const Obs& ob, bool jac,
                                            PointTerms& o) {
  const float x = R[0] * ob.px + R[1] * ob.py + R[2] * ob.pz + pose[4];
  const float y = R[3] * ob.px + R[4] * ob.py + R[5] * ob.pz + pose[5];
  const float zr = R[6] * ob.px + R[7] * ob.py + R[8] * ob.pz + pose[6];
  const float z = fmaxf(zr, 1e-6f);
  const float iz = 1.f / z;
  const float iz2 = iz * iz;
  const float u = p.fx * x * iz + p.cx;
  const float v = p.fy * y * iz + p.cy;
  const float ur = u - p.bf * iz;
  o.stereo = ob.ur >= 0.f;
  const float s = o.stereo ? 1.f : 0.f;
  o.ru = ob.u - u;
  o.rv = ob.v - v;
  o.rur = (ob.ur - ur) * s;
  o.behind = zr < 1e-3f;
  o.chi2 = (o.ru * o.ru + o.rv * o.rv + o.rur * o.rur) * ob.is2;
  if (!jac) return;
  // J = -d(u, v, ur)/d xc · [-hat(xc) | I], written out: d u/d xc = (fx/z,
  // 0, -fx x/z²), d v/d xc = (0, fy/z, -fy y/z²), d ur/d xc = d u/d xc +
  // (0, 0, bf/z²). Ju[4], Jv[3] and Jur[4] are 0 (see nz_u, nz_v).
  const float du0 = p.fx * iz, du2 = -p.fx * x * iz2;
  const float dv1 = p.fy * iz, dv2 = -p.fy * y * iz2;
  const float dr2 = du2 + p.bf * iz2;
  o.Ju[0] = -du2 * y;
  o.Ju[1] = du2 * x - du0 * zr;
  o.Ju[2] = du0 * y;
  o.Ju[3] = -du0;
  o.Ju[4] = 0.f;
  o.Ju[5] = -du2;
  o.Jv[0] = dv1 * zr - dv2 * y;
  o.Jv[1] = dv2 * x;
  o.Jv[2] = -dv1 * x;
  o.Jv[3] = 0.f;
  o.Jv[4] = -dv1;
  o.Jv[5] = -dv2;
  o.Jur[0] = -dr2 * y * s;
  o.Jur[1] = (dr2 * x - du0 * zr) * s;
  o.Jur[2] = du0 * y * s;
  o.Jur[3] = -du0 * s;
  o.Jur[4] = 0.f;
  o.Jur[5] = -dr2 * s;
}

// the entries of Ju and Jur (nz_u) and of Jv (nz_v) that can be nonzero;
// the products of the others are left out at compile time
__host__ __device__ constexpr bool nz_u(int i) { return i != 4; }
__host__ __device__ constexpr bool nz_v(int i) { return i != 3; }

// acc[0..21) += w JᵀJ (upper triangle), acc[21..27) -= w Jᵀr
__device__ __forceinline__ void accumulate_point(const PointTerms& o, float w,
                                                 float (&acc)[32]) {
  float wu[6], wv[6], wr[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    wu[i] = w * o.Ju[i];
    wv[i] = w * o.Jv[i];
    wr[i] = w * o.Jur[i];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j) {
      float h = acc[hidx(i, j)];
      if (nz_u(i) && nz_u(j)) h = fmaf(wu[i], o.Ju[j], h);
      if (nz_v(i) && nz_v(j)) h = fmaf(wv[i], o.Jv[j], h);
      if (nz_u(i) && nz_u(j)) h = fmaf(wr[i], o.Jur[j], h);
      acc[hidx(i, j)] = h;
    }
    float g = acc[21 + i];
    if (nz_u(i)) g = fmaf(-wu[i], o.ru, g);
    if (nz_v(i)) g = fmaf(-wv[i], o.rv, g);
    if (nz_u(i)) g = fmaf(-wr[i], o.rur, g);
    acc[21 + i] = g;
  }
}

struct PlaneTerms {
  float nc[3], ra[3], rd, Ja[3][3], c2;
};

__device__ __forceinline__ void plane_terms(const Params& p, const float (&R)[9],
                                            const float (&pose)[7], const Plane& pl,
                                            PlaneTerms& o) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    o.nc[i] = R[3 * i] * pl.nw[0] + R[3 * i + 1] * pl.nw[1] + R[3 * i + 2] * pl.nw[2];
  const float dc = pl.dw - (o.nc[0] * pose[4] + o.nc[1] * pose[5] + o.nc[2] * pose[6]);
  cross3(o.nc, pl.nm, o.ra);
  o.rd = dc - pl.dm;
  // J_ang (rotation block) = hat(n_m) hat(n_c) = n_c n_m^T - (n_m . n_c) I
  const float dot = o.nc[0] * pl.nm[0] + o.nc[1] * pl.nm[1] + o.nc[2] * pl.nm[2];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int k = 0; k < 3; ++k) o.Ja[r][k] = o.nc[r] * pl.nm[k] - (r == k ? dot : 0.f);
  o.c2 = p.angle_info * (o.ra[0] * o.ra[0] + o.ra[1] * o.ra[1] + o.ra[2] * o.ra[2]) +
         p.dist_info * o.rd * o.rd;
}

__global__ void __launch_bounds__(kThreads, 1)
pose_opt_kernel(Inputs in, Params p, Outputs out) {
  __shared__ float red[2][kWarps][32];   // per-warp partials, double-buffered
  __shared__ float fin[kWarps][2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // this thread's observations and plane slot, loaded once
  Obs ob[kObsPerThread];
#pragma unroll
  for (int s = 0; s < kObsPerThread; ++s) {
    const int m = tid + s * kThreads;
    Obs& o = ob[s];
    if (m < in.M) {
      o.px = in.pts_w[3 * m];
      o.py = in.pts_w[3 * m + 1];
      o.pz = in.pts_w[3 * m + 2];
      o.u = in.uv[2 * m];
      o.v = in.uv[2 * m + 1];
      o.ur = in.uright[m];
      o.is2 = in.inv_sigma2[m];
      o.valid = in.valid[m] ? 1.f : 0.f;
    } else {
      o.px = o.py = o.u = o.v = o.ur = o.is2 = o.valid = 0.f;
      o.pz = 1.f;
    }
    o.inl = o.valid;
  }
  Plane pl;
  const bool has_plane = tid < in.Q;
  if (has_plane) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      pl.nw[i] = in.plane_w[4 * tid + i];
      pl.nm[i] = in.meas_c[4 * tid + i];
    }
    pl.dw = in.plane_w[4 * tid + 3];
    pl.dm = in.meas_c[4 * tid + 3];
    pl.valid = in.pvalid[tid] ? 1.f : 0.f;
    pl.inl = pl.valid;
  }
  float pose[7];
#pragma unroll
  for (int i = 0; i < 7; ++i) pose[i] = in.pose0[i];

  int buf = 0;
  for (int round = 0; round < p.rounds; ++round) {
    float dn = INFINITY;
    for (int it = 0; it < p.iters && dn > 1e-6f; ++it) {
      float R[9];
      rotmat(pose, R);
      float acc[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) acc[k] = 0.f;
#pragma unroll
      for (int s = 0; s < kObsPerThread; ++s) {
        PointTerms o;
        point_terms(p, R, pose, ob[s], true, o);
        const float delta2 = o.stereo ? p.chi2_stereo : p.chi2_mono;
        const float w_rob = fminf(1.f, sqrtf(delta2 / fmaxf(o.chi2, 1e-12f)));
        const float w = ob[s].is2 * w_rob * ob[s].inl * ob[s].valid * (o.behind ? 0.f : 1.f);
        if (w != 0.f) accumulate_point(o, w, acc);
      }
      if (has_plane) {
        PlaneTerms o;
        plane_terms(p, R, pose, pl, o);
        const float hub = fminf(1.f, sqrtf(p.plane_chi2 / fmaxf(o.c2, 1e-12f)));
        const float pw = pl.valid * hub * pl.inl;
        if (pw != 0.f) {
#pragma unroll
          for (int i = 0; i < 3; ++i) {
#pragma unroll
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
      }
      // the block's 27 sums: warp butterfly, one barrier, every warp adds
      // the partials in the same order and broadcasts them
      const float mine = warp_transpose_sum(acc, lane);
      if (lane < kSums) red[buf][warp][lane] = mine;
      __syncthreads();
      float tot = 0.f;
      if (lane < kSums) {
#pragma unroll
        for (int w = 0; w < kWarps; ++w) tot += red[buf][w][lane];
      }
      buf ^= 1;
      float Hu[21], b[6], d[6];
#pragma unroll
      for (int k = 0; k < 21; ++k) Hu[k] = __shfl_sync(kFull, tot, k);
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        Hu[hidx(i, i)] += 1e-6f;
        b[i] = __shfl_sync(kFull, tot, 21 + i);
      }
      cholesky6_solve(Hu, b, d);
      const float sd = d[0] + d[1] + d[2] + d[3] + d[4] + d[5];
      const bool good = isfinite(sd);
      float dn2 = 0.f;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        d[i] = good ? d[i] : 0.f;
        dn2 += d[i] * d[i];
      }
      se3_retract(pose, d);
      dn = sqrtf(dn2);
    }
    // reclassify this thread's points and plane for the next round
    float R[9];
    rotmat(pose, R);
#pragma unroll
    for (int s = 0; s < kObsPerThread; ++s) {
      PointTerms o;
      point_terms(p, R, pose, ob[s], false, o);
      const float thresh = o.stereo ? p.chi2_stereo : p.chi2_mono;
      ob[s].inl = (o.chi2 <= thresh && !o.behind) ? ob[s].valid : 0.f;
    }
    if (has_plane) {
      PlaneTerms o;
      plane_terms(p, R, pose, pl, o);
      pl.inl = (o.c2 <= p.plane_chi2) ? pl.valid : 0.f;
    }
  }

  // final chi2 over the final inlier set
  float R[9];
  rotmat(pose, R);
  float n_in = 0.f, chi2 = 0.f;
#pragma unroll
  for (int s = 0; s < kObsPerThread; ++s) {
    const int m = tid + s * kThreads;
    PointTerms o;
    point_terms(p, R, pose, ob[s], false, o);
    n_in += ob[s].inl;
    chi2 += o.chi2 * ob[s].inl;
    if (m < in.M) out.inliers[m] = ob[s].inl > 0.5f;
  }
  n_in = warp_sum(n_in);
  chi2 = warp_sum(chi2);
  if (lane == 0) {
    fin[warp][0] = n_in;
    fin[warp][1] = chi2;
  }
  __syncthreads();
  if (tid == 0) {
    float n = 0.f, c = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      n += fin[w][0];
      c += fin[w][1];
    }
#pragma unroll
    for (int i = 0; i < 7; ++i) out.pose[i] = pose[i];
    *out.n_inliers = static_cast<int>(n);
    *out.chi2 = c;
  }
}

}  // namespace

extern "C" int pose_opt_launch(const float* pose0, const float* pts_w, const float* uv,
                               const float* uright, const float* inv_sigma2,
                               const unsigned char* valid, int M, const float* plane_w,
                               const float* meas_c, const unsigned char* plane_valid, int Q,
                               float fx, float fy, float cx, float cy, float bf, int rounds,
                               int iters, float chi2_mono, float chi2_stereo, float angle_info,
                               float dist_info, float plane_chi2, float* pose_out,
                               unsigned char* inl_out, int* n_inl_out, float* chi2_out,
                               void* stream) {
  if (M < 1 || M > kMaxObs || Q < 0 || Q > kMaxPlanes)
    return static_cast<int>(cudaErrorInvalidValue);
  const Inputs in{pose0, pts_w, uv, uright, inv_sigma2, valid, M,
                  plane_w, meas_c, plane_valid, Q};
  const Params p{fx, fy, cx, cy, bf, rounds, iters, chi2_mono, chi2_stereo,
                 angle_info, dist_info, plane_chi2};
  const Outputs out{pose_out, inl_out, n_inl_out, chi2_out};
  pose_opt_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(in, p, out);
  return static_cast<int>(cudaGetLastError());
}
