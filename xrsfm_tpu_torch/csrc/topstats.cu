// Fused descriptor-matcher statistics for Hopper (sm_90a).
//
// Replaces the TPU kernel xrsfm_tpu/ops/matching.py::_topstats_kernel
// (launched by _topstats_pallas).  For each pair b, with uint8 SIFT
// descriptors d1 [N,128] and d2 [M,128] and validity masks m1 [N], m2 [M]:
//
//   sim[i,j]  = <d1[i], d2[j]>                     (exact integer dot)
//   simr[i,j] = sim + (m2[j] - 1) * 1e9            (f32 add, invalid cols)
//   simc[i,j] = simr + (m1[i] - 1) * 1e9           (f32 add, invalid rows)
//   best[i]   = max_j simr[i,j]
//   best_j[i] = lowest j with simr[i,j] == best[i]
//   second[i] = max(-1e9, max_{j != best_j[i]} simr[i,j])
//   col_arg[j]= lowest i with simc[i,j] == max_i simc[i,j]
//
// The [N, M] similarity matrix never reaches device memory.
//
// Arithmetic.  Each descriptor's 128 bytes are read as 32 words of four
// bytes and multiplied with __dp4a (unsigned), accumulating in int32.  The
// dot is exact: 255^2 * 128 = 8,323,200 < 2^31, and since it is also below
// 2^24 its conversion to f32 is exact.  The TPU kernel computes the same
// integers (bf16 holds every byte exactly and the MXU accumulates in f32),
// so no bf16 or TF32 arithmetic is needed here to match it bit for bit.
// The sentinel adds are done with __fadd_rn in the same order as the TPU
// kernel, so invalid entries round to the same multiples of 64.
//
// Work and bounds.  At the main path's chunk shape, B = 16 and
// N = M = 4096, one pass is 16 * 2 * 4096^2 * 128 ~ 69 G int8 operations.
// __dp4a runs on the CUDA cores, not the tensor cores, so the kernel is
// bound by integer throughput and not by bytes: each pass reads every
// descriptor once per 64-row tile (a few hundred MB per chunk at most).
//
// Design.  TPU grid steps run in order, so the TPU kernel carried the
// column max across row tiles; Hopper blocks run concurrently, so this
// port uses two passes and no cross-block state or atomics:
//   pass ROW: grid (ceil(N/64), B); a block owns 64 rows of d1 and loops
//             over all of d2 in 64-column tiles -> best, second, best_j;
//   pass COL: grid (ceil(M/64), B); a block owns 64 columns of d2 and
//             loops over all of d1 in 64-row tiles -> col_arg.
// That doubles the dot work and is deterministic.  Each of the 256
// threads computes a 4x4 micro-tile (own index ty + 16 r, streamed index
// tx + 16 c); it streams its indices in ascending order, so a strict `>`
// keeps the lowest index, and the block merge breaks ties by index.
// A later version moves the dot products onto the tensor cores (wgmma
// s8/bf16 with TMA-fed tiles); that is not this file.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // own and streamed indices per tile
constexpr int kWords = 32;     // 128 bytes per descriptor, as 32-bit words
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kStride = kTile + 1;  // padded row of the transposed tiles
constexpr float kBig = 1e9f;

struct Stat {
  float best;
  int arg;
  float second;
};

// Merge two partial statistics over disjoint index sets: larger best wins,
// ties go to the lower index; the loser's best is a non-argmax value.
__device__ __forceinline__ Stat merge(Stat a, Stat b) {
  bool b_wins = (b.best > a.best) || (b.best == a.best && b.arg < a.arg);
  Stat w = b_wins ? b : a;
  Stat l = b_wins ? a : b;
  w.second = fmaxf(fmaxf(a.second, b.second), l.best);
  return w;
}

// Copy a 64 x 128-byte tile of descriptors (rows base.. of a [count,128]
// array) into shared memory transposed to [word][row]; rows past the end
// are zero.  The padded stride keeps the transposing stores conflict-free.
__device__ __forceinline__ void load_tile(uint32_t* dst,
                                          const uint8_t* __restrict__ src,
                                          int base, int count) {
  for (int c = threadIdx.x; c < kTile * (kWords / 4); c += kThreads) {
    int row = c / (kWords / 4);
    int w4 = (c % (kWords / 4)) * 4;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (base + row < count) {
      v = *reinterpret_cast<const uint4*>(
          src + (size_t)(base + row) * 128 + (size_t)w4 * 4);
    }
    dst[(w4 + 0) * kStride + row] = v.x;
    dst[(w4 + 1) * kStride + row] = v.y;
    dst[(w4 + 2) * kStride + row] = v.z;
    dst[(w4 + 3) * kStride + row] = v.w;
  }
}

// COL = false: own = rows of d1, streamed = columns of d2, value simr.
// COL = true:  own = columns of d2, streamed = rows of d1, value simc.
template <bool COL>
__global__ void __launch_bounds__(kThreads)
topstats_pass(const uint8_t* __restrict__ own, const uint8_t* __restrict__ str,
              const uint8_t* __restrict__ own_mask,
              const uint8_t* __restrict__ str_mask, int n_own, int n_str,
              float* __restrict__ best_out, float* __restrict__ second_out,
              int* __restrict__ arg_out) {
  __shared__ uint32_t s_own[kWords * kStride];
  __shared__ uint32_t s_str[kWords * kStride];
  __shared__ float s_pen[kTile];
  __shared__ Stat s_part[kTile][16];

  const int b = blockIdx.y;
  const int own0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  own += (size_t)b * n_own * 128;
  str += (size_t)b * n_str * 128;
  own_mask += (size_t)b * n_own;
  str_mask += (size_t)b * n_str;

  load_tile(s_own, own, own0, n_own);
  // Penalty of each owned index: only the column pass (own = columns)
  // adds it, before the streamed (row) penalty, as simc = simr + pen_row.
  float own_pen[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    int o = own0 + ty + 16 * r;
    own_pen[r] = (o < n_own && own_mask[o]) ? 0.0f : -kBig;
  }

  Stat st[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) st[r] = Stat{-INFINITY, 0x7fffffff, -kBig};

  for (int s0 = 0; s0 < n_str; s0 += kTile) {
    __syncthreads();  // previous tile fully consumed
    load_tile(s_str, str, s0, n_str);
    if (threadIdx.x < kTile) {
      int s = s0 + threadIdx.x;
      s_pen[threadIdx.x] = (s < n_str && str_mask[s]) ? 0.0f : -kBig;
    }
    __syncthreads();

    uint32_t acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0u;

#pragma unroll 8
    for (int k = 0; k < kWords; ++k) {
      uint32_t a[4], v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = s_own[k * kStride + ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) v[c] = s_str[k * kStride + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = __dp4a(a[r], v[c], acc[r][c]);
    }

#pragma unroll
    for (int c = 0; c < 4; ++c) {  // ascending streamed index
      int sl = tx + 16 * c;
      int s = s0 + sl;
      if (s >= n_str) continue;
      float pen_s = s_pen[sl];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float sim = __uint2float_rn(acc[r][c]);
        // row pass: simr = sim + pen_col; column pass: (sim + pen_col) +
        // pen_row, where the column is the owned index
        float val = COL ? __fadd_rn(__fadd_rn(sim, own_pen[r]), pen_s)
                        : __fadd_rn(sim, pen_s);
        if (val > st[r].best) {
          st[r].second = fmaxf(st[r].second, st[r].best);
          st[r].best = val;
          st[r].arg = s;
        } else {
          st[r].second = fmaxf(st[r].second, val);
        }
      }
    }
  }

  // Merge the 16 partial statistics of each owned index.
#pragma unroll
  for (int r = 0; r < 4; ++r) s_part[ty + 16 * r][tx] = st[r];
  __syncthreads();
  if (threadIdx.x < kTile) {
    int o = own0 + threadIdx.x;
    Stat m = s_part[threadIdx.x][0];
    for (int t = 1; t < 16; ++t) m = merge(m, s_part[threadIdx.x][t]);
    if (o < n_own) {
      size_t out = (size_t)b * n_own + o;
      arg_out[out] = m.arg;
      if (!COL) {
        best_out[out] = m.best;
        second_out[out] = m.second;
      }
    }
  }
}

}  // namespace

// d1 [B,N,128] u8, d2 [B,M,128] u8, m1 [B,N] and m2 [B,M] bool (one byte
// each); best, second f32 [B,N], best_j i32 [B,N], col_arg i32 [B,M].  All
// contiguous.  Launches both passes on `stream` and returns the first
// launch error (cudaSuccess = 0).
extern "C" int topstats_launch(const void* d1, const void* d2, const void* m1,
                               const void* m2, void* best, void* second,
                               void* best_j, void* col_arg, int B, int N,
                               int M, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 block(kThreads);
  topstats_pass<false><<<dim3((N + kTile - 1) / kTile, B), block, 0, s>>>(
      static_cast<const uint8_t*>(d1), static_cast<const uint8_t*>(d2),
      static_cast<const uint8_t*>(m1), static_cast<const uint8_t*>(m2), N, M,
      static_cast<float*>(best), static_cast<float*>(second),
      static_cast<int*>(best_j));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  topstats_pass<true><<<dim3((M + kTile - 1) / kTile, B), block, 0, s>>>(
      static_cast<const uint8_t*>(d2), static_cast<const uint8_t*>(d1),
      static_cast<const uint8_t*>(m2), static_cast<const uint8_t*>(m1), M, N,
      nullptr, nullptr, static_cast<int*>(col_arg));
  return static_cast<int>(cudaGetLastError());
}
