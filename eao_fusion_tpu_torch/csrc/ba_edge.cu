// Per-edge pass of the local-BA Levenberg-Marquardt iteration, for Hopper
// (sm_90a). One source, two entry points selected by `mode`:
//
//   mode 0 (full)  replaces eao_fusion_tpu/solvers/ba_edge_pallas.py:
//                  edge_pass_full (_full_kernel + _edge_math): per edge the
//                  residual r[3], the Huber weight, the camera Jacobian
//                  J_c[3,6] masked by the free-camera flag, the point
//                  Jacobian J_p[3,3], and the packed Gram payloads
//                  pay_c[42] = JcᵀWJc ‖ JcᵀWr, pay_p[12] = JpᵀWJp ‖ JpᵀWr,
//                  Y[18] = JcᵀWJp, written channel-major [ch, E].
//   mode 1 (chi2)  replaces edge_pass_chi2 (_chi2_kernel): the robust
//                  masked chi2, the raw chi2 and the behind-camera flag,
//                  channel-major [3, E].
//
// What bounds it on this card: bytes. An edge reads 28 B of its own
// (camera and point index, uv, ur, 1/sigma^2, active flag) plus its camera
// and point rows (cached: C = 32 cameras, Pw = 2048 points), does ~400
// flops, and writes 288 B (mode 0) or 12 B (mode 1) — ~2.6 MB per pass at
// E = 8192, below a microsecond at 3.35 TB/s. The design: one thread per
// edge; the camera (quaternion -> R) and the point are gathered by index
// inside the kernel, which replaces the JAX package's one-hot gather
// matmuls (ba.py build_ein); the outputs are channel-major so that
// neighbouring threads write neighbouring addresses. The [C,42] / [Pw,12]
// segment sums stay outside (index_add_).
//
// Plain C interface (ctypes): ba_edge_launch returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

struct Params {
  float fx, fy, cx, cy, bf, chi2_mono, chi2_stereo;
};

struct Inputs {
  const float* cam_pose;  // [C, 7]
  const float* pt_xyz;    // [Pw, 3]
  const int* obs_cam;     // [E]
  const int* obs_pt;      // [E]
  const float* obs_uv;    // [E, 2]
  const float* obs_ur;    // [E]
  const float* obs_is2;   // [E]
  const float* free_cam;  // [C] 0/1
  const float* active;    // [E] 0/1
  int C, Pw, E;
};

__global__ void __launch_bounds__(kThreads)
ba_edge_kernel(int mode, Inputs in, Params p, float* __restrict__ out_a,
               float* __restrict__ out_b, float* __restrict__ out_c) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const int E = in.E;
  if (e >= E) return;
  const int c = min(max(in.obs_cam[e], 0), in.C - 1);
  const int pi = min(max(in.obs_pt[e], 0), in.Pw - 1);
  const float* cp = in.cam_pose + 7 * c;
  const float qw = cp[0], qx = cp[1], qy = cp[2], qz = cp[3];
  const float xx = qx * qx, yy = qy * qy, zz = qz * qz;
  const float xy = qx * qy, xz = qx * qz, yz = qy * qz;
  const float wx = qw * qx, wy = qw * qy, wz = qw * qz;
  const float R[3][3] = {{1.f - 2.f * (yy + zz), 2.f * (xy - wz), 2.f * (xz + wy)},
                         {2.f * (xy + wz), 1.f - 2.f * (xx + zz), 2.f * (yz - wx)},
                         {2.f * (xz - wy), 2.f * (yz + wx), 1.f - 2.f * (xx + yy)}};
  const float p0 = in.pt_xyz[3 * pi], p1 = in.pt_xyz[3 * pi + 1], p2 = in.pt_xyz[3 * pi + 2];
  const float x = R[0][0] * p0 + R[0][1] * p1 + R[0][2] * p2 + cp[4];
  const float y = R[1][0] * p0 + R[1][1] * p1 + R[1][2] * p2 + cp[5];
  const float zr = R[2][0] * p0 + R[2][1] * p1 + R[2][2] * p2 + cp[6];
  const float z = fmaxf(zr, 1e-6f);
  const float iz = 1.f / z;
  const float iz2 = iz * iz;
  const float u = p.fx * x * iz + p.cx;
  const float v = p.fy * y * iz + p.cy;
  const float urr = u - p.bf * iz;
  const float ur = in.obs_ur[e];
  const float is2 = in.obs_is2[e];
  const float s = ur >= 0.f ? 1.f : 0.f;
  const float r0 = in.obs_uv[2 * e] - u;
  const float r1 = in.obs_uv[2 * e + 1] - v;
  const float r2 = s * (ur - urr);
  const float c2 = (r0 * r0 + r1 * r1 + r2 * r2) * is2;
  const float delta2 = s * p.chi2_stereo + (1.f - s) * p.chi2_mono;
  const float behind = zr < 1e-3f ? 1.f : 0.f;
  const float mask = in.active[e] * (1.f - behind);

  if (mode == 1) {
    const float c2r = c2 <= delta2 ? c2 : 2.f * sqrtf(delta2 * c2) - delta2;
    out_a[e] = c2r * mask;
    out_a[E + e] = c2;
    out_a[2 * E + e] = behind;
    return;
  }

  const float w_rob = fminf(1.f, sqrtf(delta2 / fmaxf(c2, 1e-12f)));
  const float w = is2 * w_rob * mask;
  const float fm = in.free_cam[c];
  // projection Jacobian rows (du, dv, s*dur)
  const float dp[3][3] = {{p.fx * iz, 0.f, -p.fx * x * iz2},
                          {0.f, p.fy * iz, -p.fy * y * iz2},
                          {s * p.fx * iz, 0.f, s * (-p.fx * x * iz2 + p.bf * iz2)}};
  // -hat(xc), on the unclamped xc
  const float nh[3][3] = {{0.f, zr, -y}, {-zr, 0.f, x}, {y, -x, 0.f}};
  float J[3][9];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      J[r][i] = -(dp[r][0] * nh[0][i] + dp[r][1] * nh[1][i] + dp[r][2] * nh[2][i]) * fm;
      J[r][3 + i] = -dp[r][i] * fm;
      J[r][6 + i] = -(dp[r][0] * R[0][i] + dp[r][1] * R[1][i] + dp[r][2] * R[2][i]);
    }
  }
  const float res[3] = {r0, r1, r2};
#define GRAM(a, b) (w * (J[0][a] * J[0][b] + J[1][a] * J[1][b] + J[2][a] * J[2][b]))
#define GRHS(a) (w * (J[0][a] * res[0] + J[1][a] * res[1] + J[2][a] * res[2]))
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j < 6; ++j) out_a[(i * 6 + j) * E + e] = GRAM(i, j);
    out_a[(36 + i) * E + e] = GRHS(i);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) out_b[(i * 3 + j) * E + e] = GRAM(6 + i, 6 + j);
    out_b[(9 + i) * E + e] = GRHS(6 + i);
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) out_c[(i * 3 + j) * E + e] = GRAM(i, 6 + j);
  }
#undef GRAM
#undef GRHS
}

}  // namespace

extern "C" int ba_edge_launch(int mode, const float* cam_pose, int C, const float* pt_xyz, int Pw,
                              const int* obs_cam, const int* obs_pt, const float* obs_uv,
                              const float* obs_ur, const float* obs_is2, const float* free_cam,
                              const float* active, int E, float fx, float fy, float cx, float cy,
                              float bf, float chi2_mono, float chi2_stereo, float* out_a,
                              float* out_b, float* out_c, void* stream) {
  if (E <= 0) return 0;
  Inputs in{cam_pose, pt_xyz, obs_cam, obs_pt, obs_uv, obs_ur, obs_is2, free_cam, active,
            C, Pw, E};
  Params p{fx, fy, cx, cy, bf, chi2_mono, chi2_stereo};
  const int blocks = (E + kThreads - 1) / kThreads;
  ba_edge_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      mode, in, p, out_a, out_b, out_c);
  return static_cast<int>(cudaGetLastError());
}
