// Camera side of one bundle-adjustment LM iteration in the camera-major
// row layout, fused, for Hopper (sm_90a).
//
// Replaces, on the row-native path of the JAX package's solver, the XLA
// code of xrsfm_tpu/optim/ba.py::_residuals_and_jacobians_rows (:570),
// _robust_cost_and_weight (:608) and _build_normal_blocks_ell(cam_only=True,
// return_cam_w=True) (:718), with the gauge masks of _cam_colmask.  No
// Pallas kernel is replaced.  Its plain PyTorch version is
// xrsfm_tpu_torch/optim/ba.py::cam_rows_plain.
//
// Input: the problem packed by pack_camera_major.  Row r of Mc <= 128 slots
// belongs to camera seg[r]; camera c owns the consecutive rows starts[c] ..
// starts[c+1]-1.  Slot o of the table holds a pixel obs_uv[o], a base
// weight obs_w[o] (0 on padding) and a point id other[o].  For every slot:
//   pc = R(q_c) x + t_c, proj = pc_xy / z (z guarded at 1e-9),
//   r = f * distort(proj) + c - uv;
//   Huber IRLS weight w = obs_w * (1 or huber / |r|), 0 when z <= 1e-3
//   (the reference's negative-depth guard; its cost is 2 * 12^2);
//   Jc [2, D]: the analytic pose Jacobian (D = 6: -Jp [x]x, then
//   d pix / d pc) and, for D = 14, the 8 intrinsic columns (log fx, log fy
//   with the tied-focal rule, cx, cy, k1, k2, p1, p2);
//   Jcw = sqrt(w) Jc is written out (the Schur solve's cam_w), and
//   Jcwᵀ Jcw, -Jcwᵀ (sqrt(w) r) and obs_w * cost are summed.
// Outputs: U [C, D, D] and bc [C, D] with the gauge masks applied (column
// k of camera c is free unless frozen by fix_cam, fix_rot (rotation),
// fix_trans (translation), fix_intri, or tie_f (the log fy column of a
// tied focal)), and the robust cost of the table as one float.
//
// The residual r = pix - uv cancels two to three digits of pixels that
// reach 10^3, and bc = -Σ Jcwᵀ (sqrt(w) r) cancels more across a camera's
// slots.  The projection chain up to r is therefore evaluated in double
// precision from the float inputs (the rotation, pc, 1 / z, u, v and
// f d + c - uv; the distortion terms, a few % of u and v, in float), and
// r is rounded once: the kernel's r and bc stay closer to a float64
// evaluation than the float32 plain version's.  The Jacobians are
// float32.
//
// What bounds it.  Per slot it reads 28 bytes (uv, w, point id, the
// gathered point) and writes 8 D bytes of Jcw (48 or 112), and does a few
// hundred float operations: bytes, at 3.35 TB/s.  The first design (a
// block a camera, a thread a slot looping over the camera's rows, 28 or
// 120 running sums a thread, a shuffle butterfly at the end) ran at 5 to
// 17% of that: a grid of C blocks leaves most of the card idle, each
// thread's rows form one dependent chain, D = 14's sums need 199
// registers, and Jcw left as strided scalar stores.
//
// Design: the row, not the camera, is the unit of work; two launches.
//  1. rows_kernel: 256 threads a block hold 256 / Mc consecutive rows, a
//     thread a slot, so the grid grows with the row count.  Each thread
//     writes its slot's sqrt(w) Jc [2, D] (as D / 2 16-byte words, no bank
//     conflict within a quarter warp), sqrt(w) r and cost term into a
//     shared-memory tile.  The block's Jcw is one contiguous span and
//     leaves the tile as coalesced 16-byte stores.  The row sums are read
//     out of the same tile: item (row, chunk, i) sums row i of U (entries
//     j >= i) and bc_i over its chunk of the row's slots in slot order,
//     then thread (row, entry) adds the chunks in chunk order and writes
//     the row's NU + D + 1 partials to a scratch table [Rc, NV].
//  2. cams_kernel: a block a camera; thread e adds entry e over the
//     camera's rows in row order, applies the column masks and writes U
//     (both triangles) and bc.  One more block adds the rows' costs in a
//     fixed order (8 running sums a thread over a strided pass, then a
//     tree).  A ticket in its place (the last camera block adding the
//     cameras' costs) measured 1 to 2 µs slower at 140k.
// No atomics anywhere: every sum has one order, fixed by the shapes, and
// a second launch repeats the first bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // rows_kernel: slots a block
constexpr int kMaxWidth = 128;
constexpr int kCamThreads = 128;  // cams_kernel
constexpr float kBadResidual = 12.0f;

template <int D>
struct Sizes {
  static constexpr int NU = D * (D + 1) / 2;  // U's upper triangle
  static constexpr int NV = NU + D + 1;       // then bc, then the cost
  // (row, chunk) pairs of a block: kThreads / D, and at least 32 (rows of
  // 8 slots at D = 14 take one chunk a row)
  static constexpr int kPairs = kThreads / D > 32 ? kThreads / D : 32;
};

template <int D>
__global__ void __launch_bounds__(kThreads) rows_kernel(
    const float* __restrict__ cam_q, const float* __restrict__ cam_t,
    const float* __restrict__ cam_intri, const bool* __restrict__ tie_f,
    const float* __restrict__ points, const float* __restrict__ obs_uv,
    const float* __restrict__ obs_w, const int* __restrict__ other,
    const int* __restrict__ seg, int Rc, int Mc, int G, int K, float huber,
    float* __restrict__ part, float* __restrict__ Jcw) {
  using S = Sizes<D>;
  constexpr int W4 = D / 2;  // 16-byte words of a slot's sqrt(w) Jc
  __shared__ __align__(16) float4 tile[kThreads * W4];
  __shared__ float2 tile_r[kThreads];
  __shared__ float tile_c[kThreads];
  __shared__ float chunk_sum[S::kPairs * S::NV];

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * G;
  const int rows = min(G, Rc - r0);  // rows of this block

  // 1. every slot of the block's rows into the tile
  const int g = tid / Mc, s = tid - g * Mc;
  if (g < rows) {
    const int row = r0 + g;
    const int c = seg[row];
    const float qw = cam_q[4 * c], qx = cam_q[4 * c + 1];
    const float qy = cam_q[4 * c + 2], qz = cam_q[4 * c + 3];
    double R[3][3];
    {
      const double xx = double(qx) * qx, yy = double(qy) * qy;
      const double zz = double(qz) * qz, xy = double(qx) * qy;
      const double xz = double(qx) * qz, yz = double(qy) * qz;
      const double wx = double(qw) * qx, wy = double(qw) * qy;
      const double wz = double(qw) * qz;
      R[0][0] = 1.0 - 2.0 * (yy + zz);
      R[0][1] = 2.0 * (xy - wz);
      R[0][2] = 2.0 * (xz + wy);
      R[1][0] = 2.0 * (xy + wz);
      R[1][1] = 1.0 - 2.0 * (xx + zz);
      R[1][2] = 2.0 * (yz - wx);
      R[2][0] = 2.0 * (xz - wy);
      R[2][1] = 2.0 * (yz + wx);
      R[2][2] = 1.0 - 2.0 * (xx + yy);
    }
    const float* in = cam_intri + 8 * c;
    const float fx = in[0], fy = in[1], cx = in[2], cy = in[3];
    const float k1 = in[4], k2 = in[5], p1 = in[6], p2 = in[7];
    const float tie = (D > 6 && tie_f != nullptr && tie_f[c]) ? 1.f : 0.f;

    const long long o = static_cast<long long>(row) * Mc + s;
    const int pid = other[o];
    const float X = points[3 * pid], Y = points[3 * pid + 1];
    const float Z = points[3 * pid + 2];
    const float w0 = obs_w[o];
    const float2 uv = reinterpret_cast<const float2*>(obs_uv)[o];
    // the projection chain to r in double precision, r rounded once
    double pcd[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      pcd[i] = R[i][0] * X + R[i][1] * Y + R[i][2] * Z + cam_t[3 * c + i];
    }
    const float z = static_cast<float>(pcd[2]);
    const double izd = 1.0 / (fabsf(z) < 1e-9f ? 1e-9 : pcd[2]);
    const double ud = pcd[0] * izd, vd = pcd[1] * izd;
    // the distortion terms are a few % of u, v: float suffices for them
    const float u = static_cast<float>(ud), v = static_cast<float>(vd);
    const float u2 = u * u, v2 = v * v, r2 = u2 + v2;
    const float radial = k1 * r2 + k2 * r2 * r2;
    const double d0d = ud + (u * radial + 2.f * p1 * u * v + p2 * (r2 + 2.f * u2));
    const double d1d = vd + (v * radial + 2.f * p2 * u * v + p1 * (r2 + 2.f * v2));
    const float r0v = static_cast<float>(fx * d0d + (double(cx) - uv.x));
    const float r1v = static_cast<float>(fy * d1d + (double(cy) - uv.y));
    const float pc[3] = {static_cast<float>(pcd[0]),
                         static_cast<float>(pcd[1]), z};
    const float zs = fabsf(z) < 1e-9f ? 1e-9f : z;
    const float d0 = static_cast<float>(d0d), d1 = static_cast<float>(d1d);
    float Rf[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int k = 0; k < 3; ++k) Rf[i][k] = static_cast<float>(R[i][k]);
    }

    // Huber IRLS weight with the negative-depth guard
    const bool bad = z <= 1e-3f;
    const float rn2 = bad ? 2.f * kBadResidual * kBadResidual
                          : r0v * r0v + r1v * r1v;
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
    float J[2 * D];  // [2, D] row-major: Jcw's layout
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float B0 = A[i][0] * iz, B1 = A[i][1] * iz;
      const float B2 = -(A[i][0] * pc[0] + A[i][1] * pc[1]) * (iz * iz);
      float Jp[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) Jp[k] = B0 * Rf[0][k] + B1 * Rf[1][k] + B2 * Rf[2][k];
      // -Jp x X (the rotation columns), then d pix / d pc
      J[i * D + 0] = -(Jp[1] * Z - Jp[2] * Y);
      J[i * D + 1] = -(Jp[2] * X - Jp[0] * Z);
      J[i * D + 2] = -(Jp[0] * Y - Jp[1] * X);
      J[i * D + 3] = B0;
      J[i * D + 4] = B1;
      J[i * D + 5] = B2;
    }
    if constexpr (D == 14) {
      const float r4 = r2 * r2;
      J[6] = fx * d0;
      J[7] = 0.f;
      J[8] = 1.f;
      J[9] = 0.f;
      J[10] = fx * u * r2;
      J[11] = fx * u * r4;
      J[12] = fx * 2.f * u * v;
      J[13] = fx * (r2 + 2.f * u2);
      J[D + 6] = tie * fy * d1;
      J[D + 7] = (1.f - tie) * fy * d1;
      J[D + 8] = 0.f;
      J[D + 9] = 1.f;
      J[D + 10] = fy * v * r2;
      J[D + 11] = fy * v * r4;
      J[D + 12] = fy * (r2 + 2.f * v2);
      J[D + 13] = fy * 2.f * u * v;
    }
    float4* t4 = tile + tid * W4;
#pragma unroll
    for (int m = 0; m < W4; ++m) {
      t4[m] = make_float4(J[4 * m] * sw, J[4 * m + 1] * sw, J[4 * m + 2] * sw,
                          J[4 * m + 3] * sw);
    }
    tile_r[tid] = make_float2(r0v * sw, r1v * sw);
    tile_c[tid] = w0 * cst;
  }
  __syncthreads();

  // 2. the block's Jcw: one contiguous span, 16-byte coalesced stores
  {
    const int n4 = rows * Mc * W4;
    float4* dst = reinterpret_cast<float4*>(Jcw) +
                  static_cast<long long>(r0) * Mc * W4;
    for (int k = tid; k < n4; k += kThreads) dst[k] = tile[k];
  }

  // 3. item (row g, chunk k, i): U[i][j >= i] and bc[i] over the chunk's
  // slots in slot order (the cost with i = 0)
  const float* tf = reinterpret_cast<const float*>(tile);
  for (int it = tid; it < rows * K * D; it += kThreads) {
    const int i = it % D;
    const int k = (it / D) % K;
    const int gr = it / (D * K);
    const int lo = gr * Mc + k * Mc / K, hi = gr * Mc + (k + 1) * Mc / K;
    float acc[D], accb = 0.f, accc = 0.f;
#pragma unroll
    for (int j = 0; j < D; ++j) acc[j] = 0.f;
    for (int sl = lo; sl < hi; ++sl) {
      float Jr[2 * D];
#pragma unroll
      for (int m = 0; m < W4; ++m) {
        const float4 q = tile[sl * W4 + m];
        Jr[4 * m] = q.x;
        Jr[4 * m + 1] = q.y;
        Jr[4 * m + 2] = q.z;
        Jr[4 * m + 3] = q.w;
      }
      const float a0 = tf[sl * 2 * D + i], a1 = tf[sl * 2 * D + D + i];
      const float2 sr = tile_r[sl];
#pragma unroll
      for (int j = 0; j < D; ++j) acc[j] += a0 * Jr[j] + a1 * Jr[D + j];
      accb -= a0 * sr.x + a1 * sr.y;
      accc += tile_c[sl];
    }
    float* out = chunk_sum + (gr * K + k) * S::NV;
    const int e0 = i * D - i * (i - 1) / 2 - i;  // entry of (i, j) is e0 + j
#pragma unroll
    for (int j = 0; j < D; ++j) {
      if (j >= i) out[e0 + j] = acc[j];
    }
    out[S::NU + i] = accb;
    if (i == 0) out[S::NU + D] = accc;
  }
  __syncthreads();

  // 4. the row partials: the chunks added in chunk order
  for (int t = tid; t < rows * S::NV; t += kThreads) {
    const int gr = t / S::NV, e = t - gr * S::NV;
    const float* in = chunk_sum + gr * K * S::NV + e;
    float x = in[0];
    for (int k = 1; k < K; ++k) x += in[k * S::NV];
    part[static_cast<long long>(r0 + gr) * S::NV + e] = x;
  }
}

template <int D>
__global__ void __launch_bounds__(kCamThreads) cams_kernel(
    const float* __restrict__ part, const int* __restrict__ starts,
    const bool* __restrict__ fix_cam, const bool* __restrict__ fix_rot,
    const bool* __restrict__ fix_trans, const bool* __restrict__ fix_intri,
    const bool* __restrict__ tie_f, int C, int Rc, float* __restrict__ U,
    float* __restrict__ bc, float* __restrict__ cost) {
  using S = Sizes<D>;
  constexpr int kLanes = 8;  // the cost block's running sums a thread
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  if (c == C) {
    // the cost: thread t adds rows t + 128 k, k mod 8 into sum k mod 8 (so
    // 8 loads are in flight), then the 8 sums in order, then a tree
    __shared__ float red[kCamThreads];
    float acc[kLanes];
#pragma unroll
    for (int k = 0; k < kLanes; ++k) acc[k] = 0.f;
    for (int r0 = tid; r0 < Rc; r0 += kLanes * kCamThreads) {
#pragma unroll
      for (int k = 0; k < kLanes; ++k) {
        const int r = r0 + k * kCamThreads;
        if (r < Rc) acc[k] += part[static_cast<long long>(r) * S::NV + S::NV - 1];
      }
    }
    float x = acc[0];
#pragma unroll
    for (int k = 1; k < kLanes; ++k) x += acc[k];
    red[tid] = x;
    __syncthreads();
    for (int w = kCamThreads / 2; w > 0; w >>= 1) {
      if (tid < w) red[tid] += red[tid + w];
      __syncthreads();
    }
    if (tid == 0) cost[0] = red[0];
    return;
  }
  __shared__ float mask[D];
  if (tid < D) {
    bool frozen;
    if (tid < 3) {
      frozen = fix_cam[c] || (fix_rot != nullptr && fix_rot[c]);
    } else if (tid < 6) {
      frozen = fix_cam[c] || fix_trans[c];
    } else {
      frozen = fix_intri[8 * c + tid - 6] || (tid == 7 && tie_f != nullptr &&
                                              tie_f[c]);
    }
    mask[tid] = frozen ? 0.f : 1.f;
  }
  __syncthreads();
  const int r_lo = starts[c], r_hi = starts[c + 1];
  for (int e = tid; e < S::NU + D; e += kCamThreads) {
    float x = 0.f;  // the loads run ahead, the adds stay in row order
#pragma unroll 4
    for (int r = r_lo; r < r_hi; ++r) x += part[static_cast<long long>(r) * S::NV + e];
    if (e < S::NU) {
      int i = 0, rem = e;
      while (rem >= D - i) {
        rem -= D - i;
        ++i;
      }
      const int j = i + rem;
      x *= mask[i] * mask[j];
      U[(static_cast<long long>(c) * D + i) * D + j] = x;
      U[(static_cast<long long>(c) * D + j) * D + i] = x;
    } else {
      bc[static_cast<long long>(c) * D + (e - S::NU)] = x * mask[e - S::NU];
    }
  }
}

template <int D>
int launch(const void* cam_q, const void* cam_t, const void* cam_intri,
           const void* points, const void* obs_uv, const void* obs_w,
           const void* other, const void* seg, const void* starts,
           const void* fix_cam, const void* fix_rot, const void* fix_trans,
           const void* fix_intri, const void* tie_f, int C, int Rc, int Mc,
           float huber, void* U, void* bc, void* cost, void* Jcw, void* part,
           cudaStream_t st) {
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto i = [](const void* p) { return static_cast<const int*>(p); };
  const auto b = [](const void* p) { return static_cast<const bool*>(p); };
  const int G = kThreads / Mc < 32 ? kThreads / Mc : 32;  // rows a block
  // chunks a row: at most one item (row, chunk, i) a thread, each chunk
  // at least one slot
  int K = kThreads / (G * D);
  K = K < 1 ? 1 : (K > Mc ? Mc : K);
  if (G * K > Sizes<D>::kPairs) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((Rc + G - 1) / G);
  rows_kernel<D><<<blocks, kThreads, 0, st>>>(
      f(cam_q), f(cam_t), f(cam_intri), b(tie_f), f(points), f(obs_uv),
      f(obs_w), i(other), i(seg), Rc, Mc, G, K, huber,
      static_cast<float*>(part), static_cast<float*>(Jcw));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // one block a camera, and one for the cost
  cams_kernel<D><<<C + 1, kCamThreads, 0, st>>>(
      f(part), i(starts), b(fix_cam), b(fix_rot), b(fix_trans), b(fix_intri),
      b(tie_f), C, Rc, static_cast<float*>(U), static_cast<float*>(bc),
      static_cast<float*>(cost));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch both kernels on `stream`.  D is 6 or 14; fix_rot and tie_f may be
// null (nothing frozen by them), fix_intri may be null only when D is 6.
// part is scratch of Rc (D (D + 1) / 2 + D + 1) floats (the row partials).
// Jcw and obs_uv must be 16- and 8-byte aligned.  Returns a cudaError_t.
extern "C" int ba_cam_rows_launch(
    const void* cam_q, const void* cam_t, const void* cam_intri,
    const void* points, const void* obs_uv, const void* obs_w,
    const void* other, const void* seg, const void* starts,
    const void* fix_cam, const void* fix_rot, const void* fix_trans,
    const void* fix_intri, const void* tie_f, int C, int Rc, int Mc, int D,
    float huber, void* U, void* bc, void* cost, void* Jcw, void* part,
    void* stream) {
  if (C < 1 || Rc < 1 || Mc < 1 || Mc > kMaxWidth || (D != 6 && D != 14) ||
      (D == 14 && fix_intri == nullptr) ||
      reinterpret_cast<unsigned long long>(Jcw) % 16 ||
      reinterpret_cast<unsigned long long>(obs_uv) % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  if (D == 6) {
    return launch<6>(cam_q, cam_t, cam_intri, points, obs_uv, obs_w, other,
                     seg, starts, fix_cam, fix_rot, fix_trans, fix_intri,
                     tie_f, C, Rc, Mc, huber, U, bc, cost, Jcw, part, st);
  }
  return launch<14>(cam_q, cam_t, cam_intri, points, obs_uv, obs_w, other,
                    seg, starts, fix_cam, fix_rot, fix_trans, fix_intri, tie_f,
                    C, Rc, Mc, huber, U, bc, cost, Jcw, part, st);
}
