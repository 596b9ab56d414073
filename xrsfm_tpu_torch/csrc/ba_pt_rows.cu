// Point side of one bundle-adjustment LM iteration in the point-major row
// layout, fused, for Hopper (sm_90a).
//
// Replaces, on the row-native path of the JAX package's solver, the XLA
// code of xrsfm_tpu/optim/ba.py::_build_pt_blocks_native (:836): its three
// gathers, its quaternion chain and its segment sums.  No Pallas kernel is
// replaced.  Its plain PyTorch version is
// xrsfm_tpu_torch/optim/ba.py::pt_rows_plain.
//
// Input: pack_camera_major's point-major index.  Point p owns the
// consecutive rows starts[p] .. starts[p+1]-1 of Lw slots (8, 16 or 32);
// slot o holds a camera id other[o] (0 on padding) and the static
// point-major copies of its pixel pt_uv[o] and base weight pt_w[o] (0 on
// padding).  For every slot, with the camera's (q, t, intrinsics):
//   pc = q x q* + t, proj = pc_xy / z (z guarded at 1e-9),
//   r = f * distort(proj) + c - uv, the Huber IRLS weight w (0 when
//   z <= 1e-3), B = d pix / d pc [2, 3] and Jp = B R, each row rotated
//   back by q* (no rotation matrix);
//   Jpg = Jp [2, 3] and spg = (w, w r0, w r1, 0) are written out (the Schur
//   solve's pt_gathers), and w Jpᵀ Jp and -Jpᵀ (w r) are summed.
// Outputs per point: V [3, 3] and bp [3], zero where fix_pt freezes the
// point.  Padding slots are evaluated like the others against camera 0 and
// weigh 0, as in the plain version.
//
// The residual r = pix - uv cancels two to three digits of pixels that
// reach 10^3, and bp = -Σ Jpᵀ (w r) cancels more across a point's slots.
// The projection chain up to r is therefore evaluated in double precision
// from the float inputs (the rotation, pc, 1 / z, u, v and f d + c - uv;
// the distortion terms, a few % of u and v, in float), and r is rounded
// once: the kernel's r, spg and bp stay closer to a float64 evaluation
// than the float32 plain version's.  The Jacobians are float32.
//
// What bounds it.  Per slot it reads 16 bytes (uv, w, camera id; the
// camera table is a few KB and stays in cache, the point is one read a
// row) and writes 40 (Jpg, spg), with about two hundred float operations:
// bytes, at 3.35 TB/s.  The first design, a warp a point and a lane a slot,
// left 24 of 32 lanes idle at the usual row width of 8 and stored Jpg as
// six scalar stores at a 24-byte stride.
//
// Design.  A group of Lw lanes a point, 32 / Lw points a warp, 256 / Lw
// points a block of 256 threads.  The group loops over the point's rows in
// order, a lane a slot; each lane keeps running sums of the 6 unique
// entries of V and the 3 of bp.  A row's Jpg goes through a shared-memory
// tile of the group and leaves it as 16-byte coalesced stores (the row is
// one span of 24 Lw bytes); spg is one 16-byte store a lane.  At the end
// the group reduces its sums with xor shuffles at offsets Lw/2 .. 1, which
// stay inside the group and add in one fixed order.  No atomics: the sums
// repeat bit for bit from run to run.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kBadResidual = 12.0f;

template <typename T>
__device__ __forceinline__ void quat_rotate(T w, T x, T y, T z, const T v[3],
                                            T out[3]) {
  // v + 2 (w (u x v) + u x (u x v)), u = (x, y, z)
  const T a0 = y * v[2] - z * v[1];
  const T a1 = z * v[0] - x * v[2];
  const T a2 = x * v[1] - y * v[0];
  const T b0 = y * a2 - z * a1;
  const T b1 = z * a0 - x * a2;
  const T b2 = x * a1 - y * a0;
  out[0] = v[0] + T(2) * (w * a0 + b0);
  out[1] = v[1] + T(2) * (w * a1 + b1);
  out[2] = v[2] + T(2) * (w * a2 + b2);
}

__global__ void __launch_bounds__(kThreads) pt_rows_kernel(
    const float* __restrict__ cam_q, const float* __restrict__ cam_t,
    const float* __restrict__ cam_intri, const float* __restrict__ points,
    const float* __restrict__ pt_uv, const float* __restrict__ pt_w,
    const int* __restrict__ other, const int* __restrict__ starts,
    const bool* __restrict__ fix_pt, int P, int Lw, float huber,
    float* __restrict__ V, float* __restrict__ bp, float* __restrict__ Jpg,
    float* __restrict__ spg) {
  __shared__ __align__(16) float tile[kThreads * 6];  // a Jpg row a group
  const int tid = threadIdx.x;
  const int gi = tid / Lw, lane = tid - gi * Lw;
  const int pnt = blockIdx.x * (kThreads / Lw) + gi;
  if (pnt >= P) return;  // the whole group
  const int wl = tid & 31;
  const unsigned gmask = Lw == 32 ? 0xffffffffu
                                  : ((1u << Lw) - 1u) << (wl & ~(Lw - 1));
  float* gt = tile + gi * Lw * 6;
  const double xyz[3] = {points[3 * pnt], points[3 * pnt + 1],
                         points[3 * pnt + 2]};

  float acc[9];  // V00 V01 V02 V11 V12 V22, bp0 bp1 bp2
#pragma unroll
  for (int k = 0; k < 9; ++k) acc[k] = 0.f;

  const int row_end = starts[pnt + 1];
  for (int row = starts[pnt]; row < row_end; ++row) {
    const long long o = static_cast<long long>(row) * Lw + lane;
    const int c = other[o];
    const float qw = cam_q[4 * c], qx = cam_q[4 * c + 1];
    const float qy = cam_q[4 * c + 2], qz = cam_q[4 * c + 3];
    const float* in = cam_intri + 8 * c;
    const float fx = in[0], fy = in[1], cx = in[2], cy = in[3];
    const float k1 = in[4], k2 = in[5], p1 = in[6], p2 = in[7];
    const float2 uv = reinterpret_cast<const float2*>(pt_uv)[o];

    // the projection chain to r in double precision, r rounded once
    double pcd[3];
    quat_rotate<double>(qw, qx, qy, qz, xyz, pcd);
    pcd[0] += cam_t[3 * c];
    pcd[1] += cam_t[3 * c + 1];
    pcd[2] += cam_t[3 * c + 2];
    const float z = static_cast<float>(pcd[2]);
    const double izd = 1.0 / (fabsf(z) < 1e-9f ? 1e-9 : pcd[2]);
    const double ud = pcd[0] * izd, vd = pcd[1] * izd;
    // the distortion terms are a few % of u, v: float suffices for them
    const float u = static_cast<float>(ud), v = static_cast<float>(vd);
    const float u2 = u * u, v2 = v * v, r2 = u2 + v2;
    const float radial = k1 * r2 + k2 * r2 * r2;
    const double d0 = ud + (u * radial + 2.f * p1 * u * v + p2 * (r2 + 2.f * u2));
    const double d1 = vd + (v * radial + 2.f * p2 * u * v + p1 * (r2 + 2.f * v2));
    const float r0 = static_cast<float>(fx * d0 + (double(cx) - uv.x));
    const float r1 = static_cast<float>(fy * d1 + (double(cy) - uv.y));
    const float pc[3] = {static_cast<float>(pcd[0]),
                         static_cast<float>(pcd[1]), z};
    const float zs = fabsf(z) < 1e-9f ? 1e-9f : z;

    const bool bad = z <= 1e-3f;
    const float rn2 = bad ? 2.f * kBadResidual * kBadResidual
                          : r0 * r0 + r1 * r1;
    const float rn = sqrtf(fmaxf(rn2, 1e-18f));
    const float wirls = bad ? 0.f : (rn <= huber ? 1.f : huber / rn);
    const float w = pt_w[o] * wirls;

    const float drad = 2.f * (k1 + 2.f * k2 * r2);
    const float j00 = 1.f + radial + u * (u * drad) + 2.f * p1 * v + 6.f * p2 * u;
    const float j01 = u * (v * drad) + 2.f * p1 * u + 2.f * p2 * v;
    const float j10 = v * (u * drad) + 2.f * p2 * v + 2.f * p1 * u;
    const float j11 = 1.f + radial + v * (v * drad) + 2.f * p2 * u + 6.f * p1 * v;
    const float A[2][2] = {{fx * j00, fx * j01}, {fy * j10, fy * j11}};
    const float iz = 1.f / zs;
    float Jp[2][3];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float B[3] = {A[i][0] * iz, A[i][1] * iz,
                          -(A[i][0] * pc[0] + A[i][1] * pc[1]) * (iz * iz)};
      quat_rotate<float>(qw, -qx, -qy, -qz, B, Jp[i]);  // Rᵀ b
    }
    const float wr0 = w * r0, wr1 = w * r1;
    reinterpret_cast<float4*>(spg)[o] = make_float4(w, wr0, wr1, 0.f);
    float2* t2 = reinterpret_cast<float2*>(gt + lane * 6);
    t2[0] = make_float2(Jp[0][0], Jp[0][1]);
    t2[1] = make_float2(Jp[0][2], Jp[1][0]);
    t2[2] = make_float2(Jp[1][1], Jp[1][2]);
    __syncwarp(gmask);
    {  // the row's Jpg: 6 Lw floats, 1.5 Lw 16-byte words
      const float4* src = reinterpret_cast<const float4*>(gt);
      float4* dst = reinterpret_cast<float4*>(Jpg) + row * (Lw * 3 / 2);
      for (int k = lane; k < Lw * 3 / 2; k += Lw) dst[k] = src[k];
    }
    __syncwarp(gmask);
    int k = 0;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = a; b < 3; ++b, ++k) {
        acc[k] += w * (Jp[0][a] * Jp[0][b] + Jp[1][a] * Jp[1][b]);
      }
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) acc[6 + a] -= Jp[0][a] * wr0 + Jp[1][a] * wr1;
  }

  for (int off = Lw / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < 9; ++k) acc[k] += __shfl_xor_sync(gmask, acc[k], off);
  }
  if (lane == 0) {
    const float m = fix_pt[pnt] ? 0.f : 1.f;
    float* Vp = V + 9LL * pnt;
    Vp[0] = acc[0] * m;
    Vp[1] = Vp[3] = acc[1] * m;
    Vp[2] = Vp[6] = acc[2] * m;
    Vp[4] = acc[3] * m;
    Vp[5] = Vp[7] = acc[4] * m;
    Vp[8] = acc[5] * m;
    float* bpp = bp + 3LL * pnt;
    bpp[0] = acc[6] * m;
    bpp[1] = acc[7] * m;
    bpp[2] = acc[8] * m;
  }
}

}  // namespace

// Launch on `stream`: a group of Lw lanes a point, 256 / Lw points a block.
// Lw must be 8, 16 or 32; Jpg and spg must be 16-byte aligned, pt_uv
// 8-byte aligned.  Returns a cudaError_t.
extern "C" int ba_pt_rows_launch(const void* cam_q, const void* cam_t,
                                 const void* cam_intri, const void* points,
                                 const void* pt_uv, const void* pt_w,
                                 const void* other, const void* starts,
                                 const void* fix_pt, int P, int Lw,
                                 float huber, void* V, void* bp, void* Jpg,
                                 void* spg, void* stream) {
  if (P < 1 || (Lw != 8 && Lw != 16 && Lw != 32) ||
      reinterpret_cast<unsigned long long>(spg) % 16 ||
      reinterpret_cast<unsigned long long>(Jpg) % 16 ||
      reinterpret_cast<unsigned long long>(pt_uv) % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int per_block = kThreads / Lw;
  const unsigned blocks = static_cast<unsigned>((P + per_block - 1) / per_block);
  pt_rows_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cam_q), static_cast<const float*>(cam_t),
      static_cast<const float*>(cam_intri), static_cast<const float*>(points),
      static_cast<const float*>(pt_uv), static_cast<const float*>(pt_w),
      static_cast<const int*>(other), static_cast<const int*>(starts),
      static_cast<const bool*>(fix_pt), P, Lw, huber, static_cast<float*>(V),
      static_cast<float*>(bp), static_cast<float*>(Jpg),
      static_cast<float*>(spg));
  return static_cast<int>(cudaGetLastError());
}
