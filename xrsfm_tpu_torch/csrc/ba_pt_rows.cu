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
// consecutive rows starts[p] .. starts[p+1]-1 of Lw <= 32 slots; slot o
// holds a camera id other[o] (0 on padding) and the static point-major
// copies of its pixel pt_uv[o] and base weight pt_w[o] (0 on padding).
// For every slot, with the camera's (q, t, intrinsics):
//   pc = q x q* + t, proj = pc_xy / z (z guarded at 1e-9),
//   r = f * distort(proj) + c - uv, the Huber IRLS weight w (0 when
//   z <= 1e-3), B = d pix / d pc [2, 3] and Jp = B R, each row rotated
//   back by q* (no rotation matrix);
//   Jpg = Jp [2, 3] and spg = (w, w r0, w r1, 0) are written out (the Schur
//   solve's pt_gathers), and w Jpᵀ Jp and -Jpᵀ (w r) are summed.
// Outputs per point: V [3, 3] and bp [3] (no fix_pt mask; the wrapper
// applies it).  Padding slots are evaluated like the others against camera
// 0 and weigh 0, as in the plain version.
//
// What bounds it.  Per slot it reads 16 bytes (uv, w, camera id; the
// camera table is a few KB and stays in cache, the point is one read a
// row) and writes 40 (Jpg, spg), with about two hundred float operations:
// bytes, at 3.35 TB/s.
//
// Design.  One warp per point, one lane per slot of a row, looping over the
// point's rows in order; each lane keeps running sums of the 6 unique
// entries of V and the 3 of bp in registers, and the warp reduces them at
// the end with a xor-shuffle butterfly, whose order is fixed.  No atomics:
// the sums repeat bit for bit from run to run.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // points a block
constexpr float kBadResidual = 12.0f;

__device__ __forceinline__ void quat_rotate(float w, float x, float y, float z,
                                            const float v[3], float out[3]) {
  // v + 2 (w (u x v) + u x (u x v)), u = (x, y, z)
  const float a0 = y * v[2] - z * v[1];
  const float a1 = z * v[0] - x * v[2];
  const float a2 = x * v[1] - y * v[0];
  const float b0 = y * a2 - z * a1;
  const float b1 = z * a0 - x * a2;
  const float b2 = x * a1 - y * a0;
  out[0] = v[0] + 2.f * (w * a0 + b0);
  out[1] = v[1] + 2.f * (w * a1 + b1);
  out[2] = v[2] + 2.f * (w * a2 + b2);
}

__global__ void __launch_bounds__(32 * kWarps) pt_rows_kernel(
    const float* __restrict__ cam_q, const float* __restrict__ cam_t,
    const float* __restrict__ cam_intri, const float* __restrict__ points,
    const float* __restrict__ pt_uv, const float* __restrict__ pt_w,
    const int* __restrict__ other, const int* __restrict__ starts, int P,
    int Lw, float huber, float* __restrict__ V, float* __restrict__ bp,
    float* __restrict__ Jpg, float* __restrict__ spg) {
  const int pnt = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (pnt >= P) return;  // the whole warp
  const float xyz[3] = {points[3 * pnt], points[3 * pnt + 1],
                        points[3 * pnt + 2]};

  float acc[9];  // V00 V01 V02 V11 V12 V22, bp0 bp1 bp2
#pragma unroll
  for (int k = 0; k < 9; ++k) acc[k] = 0.f;

  const int row_end = starts[pnt + 1];
  for (int row = starts[pnt]; row < row_end; ++row) {
    if (lane >= Lw) continue;
    const long long o = static_cast<long long>(row) * Lw + lane;
    const int c = other[o];
    const float qw = cam_q[4 * c], qx = cam_q[4 * c + 1];
    const float qy = cam_q[4 * c + 2], qz = cam_q[4 * c + 3];
    const float* in = cam_intri + 8 * c;
    const float fx = in[0], fy = in[1], cx = in[2], cy = in[3];
    const float k1 = in[4], k2 = in[5], p1 = in[6], p2 = in[7];
    float pc[3];
    quat_rotate(qw, qx, qy, qz, xyz, pc);
    pc[0] += cam_t[3 * c];
    pc[1] += cam_t[3 * c + 1];
    pc[2] += cam_t[3 * c + 2];
    const float z = pc[2];
    const float zs = fabsf(z) < 1e-9f ? 1e-9f : z;
    const float u = pc[0] / zs, v = pc[1] / zs;
    const float u2 = u * u, v2 = v * v, r2 = u2 + v2;
    const float radial = k1 * r2 + k2 * r2 * r2;
    const float d0 = u + (u * radial + 2.f * p1 * u * v + p2 * (r2 + 2.f * u2));
    const float d1 = v + (v * radial + 2.f * p2 * u * v + p1 * (r2 + 2.f * v2));
    const float r0 = fx * d0 + cx - pt_uv[2 * o];
    const float r1 = fy * d1 + cy - pt_uv[2 * o + 1];

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
      quat_rotate(qw, -qx, -qy, -qz, B, Jp[i]);  // Rᵀ b
    }
    float* jo = Jpg + o * 6;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int k = 0; k < 3; ++k) jo[3 * i + k] = Jp[i][k];
    }
    const float wr0 = w * r0, wr1 = w * r1;
    float4 sc = make_float4(w, wr0, wr1, 0.f);
    reinterpret_cast<float4*>(spg)[o] = sc;
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

#pragma unroll
  for (int k = 0; k < 9; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
  }
  if (lane == 0) {
    float* Vp = V + 9LL * pnt;
    Vp[0] = acc[0];
    Vp[1] = Vp[3] = acc[1];
    Vp[2] = Vp[6] = acc[2];
    Vp[4] = acc[3];
    Vp[5] = Vp[7] = acc[4];
    Vp[8] = acc[5];
    float* bpp = bp + 3LL * pnt;
    bpp[0] = acc[6];
    bpp[1] = acc[7];
    bpp[2] = acc[8];
  }
}

}  // namespace

// Launch on `stream`: one warp per point, kWarps points a block.  Returns a
// cudaError_t.  spg must be 16-byte aligned.
extern "C" int ba_pt_rows_launch(const void* cam_q, const void* cam_t,
                                 const void* cam_intri, const void* points,
                                 const void* pt_uv, const void* pt_w,
                                 const void* other, const void* starts, int P,
                                 int Lw, float huber, void* V, void* bp,
                                 void* Jpg, void* spg, void* stream) {
  if (P < 1 || Lw < 1 || Lw > 32 ||
      reinterpret_cast<unsigned long long>(spg) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = static_cast<unsigned>((P + kWarps - 1) / kWarps);
  pt_rows_kernel<<<blocks, 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cam_q), static_cast<const float*>(cam_t),
      static_cast<const float*>(cam_intri), static_cast<const float*>(points),
      static_cast<const float*>(pt_uv), static_cast<const float*>(pt_w),
      static_cast<const int*>(other), static_cast<const int*>(starts), P, Lw,
      huber, static_cast<float*>(V), static_cast<float*>(bp),
      static_cast<float*>(Jpg), static_cast<float*>(spg));
  return static_cast<int>(cudaGetLastError());
}
