// Camera side of one bundle-adjustment LM iteration in the camera-major
// row layout, fused, for Hopper (sm_90a).
//
// Replaces, on the row-native path of the JAX package's solver, the XLA
// code of xrsfm_tpu/optim/ba.py::_residuals_and_jacobians_rows (:570),
// _robust_cost_and_weight (:608) and _build_normal_blocks_ell(cam_only=True,
// return_cam_w=True) (:718).  No Pallas kernel is replaced.  Its plain
// PyTorch version is xrsfm_tpu_torch/optim/ba.py::cam_rows_plain.
//
// Input: the problem packed by pack_camera_major.  Camera c owns the
// consecutive rows starts[c] .. starts[c+1]-1 of Mc <= 128 slots; slot o of
// the table holds a pixel obs_uv[o], a base weight obs_w[o] (0 on padding)
// and a point id other[o].  For every slot:
//   pc = R(q_c) x + t_c, proj = pc_xy / z (z guarded at 1e-9),
//   r = f * distort(proj) + c - uv;
//   Huber IRLS weight w = obs_w * (1 or huber / |r|), 0 when z <= 1e-3
//   (the reference's negative-depth guard; its cost is 2 * 12^2);
//   Jc [2, D]: the analytic pose Jacobian (D = 6: -Jp [x]x, then
//   d pix / d pc) and, for D = 14, the 8 intrinsic columns (log fx, log fy
//   with the tied-focal rule, cx, cy, k1, k2, p1, p2);
//   Jcw = sqrt(w) Jc is written out (the Schur solve's cam_w), and
//   Jcwᵀ Jcw, -Jcwᵀ (sqrt(w) r) and obs_w * cost are summed.
// Outputs per camera: U [D, D] (no gauge mask), bc [D], the robust cost.
// The gauge masks are applied by the wrapper, at [C, D].
//
// What bounds it.  Per slot it reads 28 bytes (uv, w, point id, the
// gathered point) and writes 8 D bytes of Jcw (48 or 112), and does a few
// hundred float operations: bytes, at 3.35 TB/s.
//
// Design.  One thread block per camera, one thread per slot of a row; the
// block loops over the camera's rows in order.  Each thread keeps its
// running sums of the 21 (D = 6) or 105 (D = 14) unique entries of U, the
// D of bc and the cost in registers across the rows; at the end the block
// reduces them with a fixed tree (a xor-shuffle butterfly inside each warp,
// then the warps' partials added in warp order through shared memory).  No
// atomics: the sums repeat bit for bit from run to run.  The camera's
// rotation is formed once a thread from its quaternion; the point is
// rotated with multiply-adds in float32 (no reduced-precision unit).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxWidth = 128;
constexpr float kBadResidual = 12.0f;

template <int D>
__global__ void __launch_bounds__(kMaxWidth) cam_rows_kernel(
    const float* __restrict__ cam_q, const float* __restrict__ cam_t,
    const float* __restrict__ cam_intri, const float* __restrict__ tie_f,
    const float* __restrict__ points, const float* __restrict__ obs_uv,
    const float* __restrict__ obs_w, const int* __restrict__ other,
    const int* __restrict__ starts, int Mc, float huber,
    float* __restrict__ U, float* __restrict__ bc, float* __restrict__ cost,
    float* __restrict__ Jcw) {
  constexpr int NU = D * (D + 1) / 2;
  constexpr int NV = NU + D + 1;  // U's upper triangle, bc, cost
  __shared__ float part[kMaxWidth / 32][NV];

  const int c = blockIdx.x;
  const int s = threadIdx.x;
  const int lane = s & 31, warp = s >> 5;

  const float qw = cam_q[4 * c], qx = cam_q[4 * c + 1];
  const float qy = cam_q[4 * c + 2], qz = cam_q[4 * c + 3];
  float R[3][3];
  {
    const float xx = qx * qx, yy = qy * qy, zz = qz * qz;
    const float xy = qx * qy, xz = qx * qz, yz = qy * qz;
    const float wx = qw * qx, wy = qw * qy, wz = qw * qz;
    R[0][0] = 1.f - 2.f * (yy + zz);
    R[0][1] = 2.f * (xy - wz);
    R[0][2] = 2.f * (xz + wy);
    R[1][0] = 2.f * (xy + wz);
    R[1][1] = 1.f - 2.f * (xx + zz);
    R[1][2] = 2.f * (yz - wx);
    R[2][0] = 2.f * (xz - wy);
    R[2][1] = 2.f * (yz + wx);
    R[2][2] = 1.f - 2.f * (xx + yy);
  }
  const float t0 = cam_t[3 * c], t1 = cam_t[3 * c + 1], t2 = cam_t[3 * c + 2];
  const float* in = cam_intri + 8 * c;
  const float fx = in[0], fy = in[1], cx = in[2], cy = in[3];
  const float k1 = in[4], k2 = in[5], p1 = in[6], p2 = in[7];
  const float tie = (D > 6 && tie_f != nullptr) ? tie_f[c] : 0.f;

  float acc[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) acc[k] = 0.f;

  const int row_end = starts[c + 1];
  for (int row = starts[c]; row < row_end; ++row) {
    if (s >= Mc) continue;
    const long long o = static_cast<long long>(row) * Mc + s;
    const int pid = other[o];
    const float X = points[3 * pid], Y = points[3 * pid + 1];
    const float Z = points[3 * pid + 2];
    const float w0 = obs_w[o];
    float pc[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) pc[i] = R[i][0] * X + R[i][1] * Y + R[i][2] * Z;
    pc[0] += t0;
    pc[1] += t1;
    pc[2] += t2;
    const float z = pc[2];
    const float zs = fabsf(z) < 1e-9f ? 1e-9f : z;
    const float u = pc[0] / zs, v = pc[1] / zs;
    const float u2 = u * u, v2 = v * v, r2 = u2 + v2;
    const float radial = k1 * r2 + k2 * r2 * r2;
    const float d0 = u + (u * radial + 2.f * p1 * u * v + p2 * (r2 + 2.f * u2));
    const float d1 = v + (v * radial + 2.f * p2 * u * v + p1 * (r2 + 2.f * v2));
    const float r0 = fx * d0 + cx - obs_uv[2 * o];
    const float r1 = fy * d1 + cy - obs_uv[2 * o + 1];

    // Huber IRLS weight with the negative-depth guard
    const bool bad = z <= 1e-3f;
    const float rn2 = bad ? 2.f * kBadResidual * kBadResidual
                          : r0 * r0 + r1 * r1;
    const float rn = sqrtf(fmaxf(rn2, 1e-18f));
    const bool quad = rn <= huber;
    const float cst = quad ? rn2 : huber * (2.f * rn - huber);
    const float wirls = bad ? 0.f : (quad ? 1.f : huber / rn);
    const float sw = sqrtf(fmaxf(w0 * wirls, 0.f));

    // d pix / d pc = diag(f) Jdist(proj) d proj / d pc
    const float drad = 2.f * (k1 + 2.f * k2 * r2);
    const float j00 = 1.f + radial + u * (u * drad) + 2.f * p1 * v + 6.f * p2 * u;
    const float j01 = u * (v * drad) + 2.f * p1 * u + 2.f * p2 * v;
    const float j10 = v * (u * drad) + 2.f * p2 * v + 2.f * p1 * u;
    const float j11 = 1.f + radial + v * (v * drad) + 2.f * p2 * u + 6.f * p1 * v;
    const float A[2][2] = {{fx * j00, fx * j01}, {fy * j10, fy * j11}};
    const float iz = 1.f / zs;
    float J[2][D];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float B0 = A[i][0] * iz, B1 = A[i][1] * iz;
      const float B2 = -(A[i][0] * pc[0] + A[i][1] * pc[1]) * (iz * iz);
      float Jp[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) Jp[k] = B0 * R[0][k] + B1 * R[1][k] + B2 * R[2][k];
      // -Jp x X (the rotation columns), then d pix / d pc
      J[i][0] = -(Jp[1] * Z - Jp[2] * Y);
      J[i][1] = -(Jp[2] * X - Jp[0] * Z);
      J[i][2] = -(Jp[0] * Y - Jp[1] * X);
      J[i][3] = B0;
      J[i][4] = B1;
      J[i][5] = B2;
    }
    if constexpr (D == 14) {
      const float r4 = r2 * r2;
      J[0][6] = fx * d0;
      J[0][7] = 0.f;
      J[0][8] = 1.f;
      J[0][9] = 0.f;
      J[0][10] = fx * u * r2;
      J[0][11] = fx * u * r4;
      J[0][12] = fx * 2.f * u * v;
      J[0][13] = fx * (r2 + 2.f * u2);
      J[1][6] = tie * fy * d1;
      J[1][7] = (1.f - tie) * fy * d1;
      J[1][8] = 0.f;
      J[1][9] = 1.f;
      J[1][10] = fy * v * r2;
      J[1][11] = fy * v * r4;
      J[1][12] = fy * (r2 + 2.f * v2);
      J[1][13] = fy * 2.f * u * v;
    }
    float* out = Jcw + o * (2 * D);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int k = 0; k < D; ++k) {
        J[i][k] *= sw;
        out[i * D + k] = J[i][k];
      }
    }
    const float s0 = r0 * sw, s1 = r1 * sw;
    int k = 0;
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = i; j < D; ++j, ++k) acc[k] += J[0][i] * J[0][j] + J[1][i] * J[1][j];
    }
#pragma unroll
    for (int i = 0; i < D; ++i) acc[NU + i] -= J[0][i] * s0 + J[1][i] * s1;
    acc[NU + D] += w0 * cst;
  }

  // fixed-order block reduction: butterfly in each warp, then warp order
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    float x = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    if (lane == 0) part[warp][k] = x;
  }
  __syncthreads();
  const int n_warps = blockDim.x >> 5;
  for (int k = s; k < NV; k += blockDim.x) {
    float x = part[0][k];
    for (int w = 1; w < n_warps; ++w) x += part[w][k];
    if (k < NU) {
      int i = 0, rem = k;
      while (rem >= D - i) {
        rem -= D - i;
        ++i;
      }
      const int j = i + rem;
      U[(static_cast<long long>(c) * D + i) * D + j] = x;
      U[(static_cast<long long>(c) * D + j) * D + i] = x;
    } else if (k < NU + D) {
      bc[static_cast<long long>(c) * D + (k - NU)] = x;
    } else {
      cost[c] = x;
    }
  }
}

}  // namespace

// Launch on `stream`: C blocks of Mc rounded up to a warp.  D is 6 or 14;
// tie_f may be null (no tied focal).  Returns a cudaError_t.
extern "C" int ba_cam_rows_launch(const void* cam_q, const void* cam_t,
                                  const void* cam_intri, const void* tie_f,
                                  const void* points, const void* obs_uv,
                                  const void* obs_w, const void* other,
                                  const void* starts, int C, int Mc, int D,
                                  float huber, void* U, void* bc, void* cost,
                                  void* Jcw, void* stream) {
  if (C < 1 || Mc < 1 || Mc > kMaxWidth || (D != 6 && D != 14)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned threads = static_cast<unsigned>((Mc + 31) / 32 * 32);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto i = [](const void* p) { return static_cast<const int*>(p); };
  if (D == 6) {
    cam_rows_kernel<6><<<C, threads, 0, st>>>(
        f(cam_q), f(cam_t), f(cam_intri), f(tie_f), f(points), f(obs_uv),
        f(obs_w), i(other), i(starts), Mc, huber, static_cast<float*>(U),
        static_cast<float*>(bc), static_cast<float*>(cost),
        static_cast<float*>(Jcw));
  } else {
    cam_rows_kernel<14><<<C, threads, 0, st>>>(
        f(cam_q), f(cam_t), f(cam_intri), f(tie_f), f(points), f(obs_uv),
        f(obs_w), i(other), i(starts), Mc, huber, static_cast<float*>(U),
        static_cast<float*>(bc), static_cast<float*>(cost),
        static_cast<float*>(Jcw));
  }
  return static_cast<int>(cudaGetLastError());
}
