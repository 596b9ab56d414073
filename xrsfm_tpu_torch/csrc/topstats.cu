// Fused descriptor-matcher statistics for Hopper (sm_90a): unsigned-byte
// dot products on the tensor cores (wgmma), tiles fed by TMA.
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
// Arithmetic.  The dots run as wgmma.mma_async m64n128k32 .s32.u8.u8 on
// the descriptor bytes as they lie in memory: both operands are K-major
// ([rows, 128 bytes] row-major), which is what integer wgmma wants, and
// the unsigned form needs no bias.  The s32 sum is exact (255^2 * 128 =
// 8,323,200 < 2^31) and, being below 2^24, converts to f32 exactly.  The
// TPU kernel computes the same integers (bf16 holds every byte exactly and
// the MXU accumulates in f32).  The sentinel adds are __fadd_rn in the
// TPU kernel's order, so invalid entries round to the same multiples of
// 64.  bf16 wgmma was not taken: half the tensor-core rate, a conversion
// pass over the descriptors first, and twice the bytes in shared memory.
//
// What bounds it.  One pass over S is B * 2 * N * M * 128 int8 operations
// (69 G at B = 16, N = M = 4096) against a few MB of inputs and outputs:
// operations, not bytes.  With the dots on the tensor cores the CUDA-core
// epilogue takes most of the kernel, as softmax does in attention: the
// depth of the product is only 128, and every element of S costs two or
// three FMA-pipe instructions (scale, add) and, on the ALU pipe, which
// issues a warp instruction every other clock, 5 (row pass: compare, min,
// max, max, select) or 3 (column pass) instructions.
//
// Design.
//  * TPU grid steps run in order, so the TPU kernel carried the column max
//    across row tiles; Hopper blocks run concurrently, so there are two
//    passes and no cross-block state, scratch buffer or atomics.  Pass ROW
//    owns rows of d1 and streams d2 -> best, second, best_j; pass COL owns
//    columns of d2 and streams d1 -> col_arg (the row pass with the sides
//    swapped and no second best).  Both are blocks of one launch:
//    B * (ceil(N/128) + ceil(M/128)) blocks, a pair's blocks adjacent.
//  * A block owns 128 indices: two consumer warpgroups of 64 rows each,
//    plus one producer warp.  The producer loads the own tile once and the
//    streamed side in tiles of 128 descriptors through a ring of 4 stages
//    in dynamic shared memory, with cp.async.bulk.tensor (TMA) completing
//    on mbarriers; it also writes each stage's 128 sentinel addends
//    (0, -1e9, or -inf past the end of the pair, which can never win).
//  * The tensor maps are 3-D (128 bytes, rows, pair) with the 128-byte
//    swizzle, so a tile that reaches past the end of a pair is zero-filled
//    by the hardware and never reads the next pair's rows.  One descriptor
//    is exactly one 128-byte swizzle row; the wgmma shared-memory
//    descriptors use the same swizzle, 1,024 bytes between 8-row groups,
//    tile bases aligned to 1,024 bytes, and advance 32 bytes per k32 step.
//  * Statistics come straight from the accumulator fragment: a thread
//    holds rows 16*warp + lane/4 and +8 and, in every group of 8 columns,
//    columns 2*(lane%4) and +1.  It keeps a running (best, arg, second)
//    for its two rows, visiting its columns in ascending index, so that a
//    strict `>` keeps the lowest index; the four lanes of a quad merge by
//    two shuffles at the end (ties to the lower index, the loser's best
//    into second).  Nothing of S touches shared memory.
//  * Occupancy: 90 registers a thread (64 of them the s32 accumulator; the
//    launch bound allows 112) and 85,064 bytes of dynamic shared memory, so
//    two blocks, four consumer warpgroups, share an SM.
//  * Overlap of tensor-core and CUDA-core work is left to the four
//    warpgroups of an SM taking turns; measured on an H100 (PERF.md) the
//    kernel still takes about the dots' time plus the epilogue's.  Two
//    accumulators in one warpgroup, with the dots of tile k+1 issued
//    before the statistics of tile k (168 registers, one block an SM),
//    measured slower, so the loop has one accumulator.
//  * A persistent loop was not taken: at the matching stage's shapes the
//    grid is 512 to 1,024 blocks of equal work for 264 slots, and a block's
//    prologue (one 16 KB tile) is under 1% of its work.
//  * A barrier that never completes traps after about two seconds instead
//    of hanging the card.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kOwn = 128;      // own indices per block, 64 per warpgroup
constexpr int kStr = 128;      // streamed indices per ring stage (wgmma n)
constexpr int kRowBytes = 128; // one descriptor, one swizzle row
constexpr int kStages = 4;     // ring depth
constexpr int kConsumerWarps = 8;
constexpr int kThreads = (kConsumerWarps + 1) * 32;
constexpr int kTileBytes = kStr * kRowBytes;  // 16,384
constexpr float kBig = 1e9f;
constexpr long long kSpinLimit = 4000000000LL;  // clocks, about 2 s

// Dynamic shared memory, from a base aligned to 1,024 bytes.
constexpr int kOffOwn = 0;
constexpr int kOffRing = kOffOwn + kOwn * kRowBytes;
constexpr int kOffPen = kOffRing + kStages * kTileBytes;
constexpr int kOffBar = kOffPen + kStages * kStr * 4;
constexpr int kSmemBytes = 1024 + kOffBar + (2 * kStages + 1) * 8;

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

__device__ __forceinline__ Stat shuffle_xor(Stat s, int lane_mask) {
  Stat o;
  o.best = __shfl_xor_sync(0xffffffffu, s.best, lane_mask);
  o.arg = __shfl_xor_sync(0xffffffffu, s.arg, lane_mask);
  o.second = __shfl_xor_sync(0xffffffffu, s.second, lane_mask);
  return o;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase with this parity has completed; traps if
// it has not after kSpinLimit clocks.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  for (int polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls % 1024 == 1023) {
      if (t0 == 0) {
        t0 = clock64();
      } else if (clock64() - t0 > kSpinLimit) {
        __trap();
      }
    }
  }
}

// One box of the 3-D tensor map (128 bytes, kStr rows, 1 pair) into shared
// memory; completes `bytes` on the barrier.  Rows past the pair's end
// arrive as zeros.
__device__ __forceinline__ void tma_load_tile(uint32_t dst,
                                              const CUtensorMap* map,
                                              uint32_t bar, int row, int pair) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(row),
      "r"(pair)
      : "memory");
}

// Shared-memory matrix descriptor of a K-major tile of 128-byte rows under
// the 128-byte swizzle: start address / 16 in bits 0-13, leading byte
// offset (unused for this layout) in 16-29, stride byte offset 1,024 / 16
// (from one 8-row group to the next) in 32-45, layout 1 in 62-63.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFFu) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Waits until at most kPending committed groups are still in flight.
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma's issue and wait.
__device__ __forceinline__ void fence_acc(int32_t (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (+)= A[64 x 32 bytes] * B[128 x 32 bytes]^T on unsigned bytes, s32 sums;
// scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k32_u8(int32_t (&d)[64],
                                                    uint64_t desc_a,
                                                    uint64_t desc_b,
                                                    int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// The producer warp: the own tile once, then every streamed tile and its
// sentinel addends through the ring.
__device__ __forceinline__ void produce(const CUtensorMap* own_map,
                                        const CUtensorMap* str_map,
                                        const uint8_t* __restrict__ str_mask,
                                        int n_str, int own0, int pair,
                                        uint32_t smem, float* pen, int lane) {
  const uint32_t bars = smem + kOffBar;
  if (lane == 0) {
    const uint32_t own_bar = bars + 2 * kStages * 8;
    mbar_arrive_expect_tx(own_bar, kTileBytes);
    tma_load_tile(smem + kOffOwn, own_map, own_bar, own0, pair);
  }
  const int n_tiles = (n_str + kStr - 1) / kStr;
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it % kStages;
    const uint32_t phase = (it / kStages) & 1;
    const uint32_t full = bars + stage * 8;
    const uint32_t empty = bars + (kStages + stage) * 8;
    // passes at once on the first round
    mbar_wait(empty, phase ^ 1);
    float4 p;
    float* pv = reinterpret_cast<float*>(&p);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int s = it * kStr + lane * 4 + k;
      pv[k] = s >= n_str ? -INFINITY : (str_mask[s] ? 0.0f : -kBig);
    }
    reinterpret_cast<float4*>(pen + stage * kStr)[lane] = p;
    if (lane == 0) {
      mbar_arrive_expect_tx(full, kTileBytes);
      tma_load_tile(smem + kOffRing + stage * kTileBytes, str_map, full,
                    it * kStr, pair);
    } else {
      mbar_arrive(full);
    }
  }
}

// Issues the four k32 steps of one 64 x 128 tile of S into acc, as one
// committed group: this warpgroup's rows of the own tile against the
// streamed tile in `stage`.
__device__ __forceinline__ void issue_tile(int32_t (&acc)[64], uint64_t desc_a,
                                           uint32_t smem, int stage) {
  const uint64_t desc_b = wgmma_desc(smem + kOffRing + stage * kTileBytes);
  fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < kRowBytes / 32; ++k) {
    // 32 bytes along K = 2 units of the descriptor's start address
    wgmma_m64n128k32_u8(acc, desc_a + 2 * k, desc_b + 2 * k, k > 0);
  }
  wgmma_commit();
}

// Folds one finished tile into the thread's running statistics.
// acc[4j + 2h + e] = S[row0 + 8h][8j + 2 quad + e]; ascending j, e is
// ascending streamed index.  `base` is the streamed index of the thread's
// first column in this tile, pen2 its addends (pairs, 4 apart).
template <bool COL>
__device__ __forceinline__ void fold_tile(const int32_t (&acc)[64],
                                          const float2* pen2,
                                          const float (&own_pen)[2], int base,
                                          float (&best)[2], float (&second)[2],
                                          int (&arg)[2]) {
  // loc = 8j + e of the tile's last strict improvement of best, -1 if none
  int loc[2] = {-1, -1};
#pragma unroll
  for (int j = 0; j < kStr / 8; ++j) {
    const float2 p = pen2[4 * j];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // The s32 dot read as f32 bits is the denormal sim * 2^-149; two
        // exact scalings by powers of two give sim, the second one fused
        // with the first add (one rounding, as __fadd_rn(sim, addend)).
        // They run on the FMA pipe, where a conversion instruction would
        // compete with the compares and selects for the ALU pipe.
        // row pass: simr = sim + pen_col; column pass: (sim + pen_col) +
        // pen_row, where the column is the owned index
        float v = __fmul_rn(__int_as_float(acc[4 * j + 2 * h + e]), 0x1p100f);
        if (COL) {
          v = __fadd_rn(__fmaf_rn(v, 0x1p49f, own_pen[h]), e ? p.y : p.x);
        } else {
          v = __fmaf_rn(v, 0x1p49f, e ? p.y : p.x);
        }
        const bool up = v > best[h];
        if (!COL) second[h] = fmaxf(second[h], fminf(v, best[h]));
        best[h] = fmaxf(best[h], v);
        loc[h] = up ? 8 * j + e : loc[h];
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (loc[h] >= 0) arg[h] = base + loc[h];
  }
}

// A consumer warp of one of the two warpgroups.
// COL = false: own = rows of d1, streamed = columns of d2, value simr.
// COL = true:  own = columns of d2, streamed = rows of d1, value simc.
template <bool COL>
__device__ __forceinline__ void consume(
    const uint8_t* __restrict__ own_mask, int n_own, int n_str, int own0,
    uint32_t smem, const float* pen, int tid, float* __restrict__ best_out,
    float* __restrict__ second_out, int* __restrict__ arg_out) {
  const int lane = tid % 32;
  const int quad = lane % 4;
  // the thread's two own indices within the block: row0 and row0 + 8
  const int row0 = (tid / 32) * 16 + lane / 4;
  const uint32_t bars = smem + kOffBar;

  // Addend of each owned index: only the column pass (own = columns) adds
  // it, before the streamed (row) addend, as simc = simr + pen_row.
  float own_pen[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int o = own0 + row0 + 8 * h;
    own_pen[h] = (o < n_own && own_mask[o]) ? 0.0f : -kBig;
  }

  float best[2] = {-INFINITY, -INFINITY};
  float second[2] = {-kBig, -kBig};
  int arg[2] = {0x7fffffff, 0x7fffffff};

  // this warpgroup's 64 rows of the own tile
  const uint64_t desc_a =
      wgmma_desc(smem + kOffOwn + (tid / 128) * 64 * kRowBytes);
  const int n_tiles = (n_str + kStr - 1) / kStr;
  mbar_wait(bars + 2 * kStages * 8, 0);  // the own tile

  // The first k32 step of a tile overwrites the accumulator, so it is not
  // initialised.
  int32_t acc[64];
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it % kStages;
    mbar_wait(bars + stage * 8, (it / kStages) & 1);
    issue_tile(acc, desc_a, smem, stage);
    wgmma_wait<0>();
    fence_acc(acc);
    fold_tile<COL>(
        acc, reinterpret_cast<const float2*>(pen + stage * kStr) + quad,
        own_pen, it * kStr + 2 * quad, best, second, arg);
    // the stage goes back to the producer
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + (kStages + stage) * 8);
  }

  // Merge the four lanes that share each owned index.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    Stat m = Stat{best[h], arg[h], second[h]};
    m = merge(m, shuffle_xor(m, 1));
    m = merge(m, shuffle_xor(m, 2));
    const int o = own0 + row0 + 8 * h;
    if (quad == 0 && o < n_own) {
      arg_out[o] = m.arg;
      if (!COL) {
        best_out[o] = m.best;
        second_out[o] = m.second;
      }
    }
  }
}

// Block t of pair b: t < tiles_n is the row pass on rows t*128.., the rest
// the column pass on columns (t - tiles_n)*128...
__global__ void __launch_bounds__(kThreads, 2)
topstats_kernel(const __grid_constant__ CUtensorMap map1,
                const __grid_constant__ CUtensorMap map2,
                const uint8_t* __restrict__ m1, const uint8_t* __restrict__ m2,
                int N, int M, int tiles_n, int tiles_m,
                float* __restrict__ best, float* __restrict__ second,
                int* __restrict__ best_j, int* __restrict__ col_arg) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  const uint32_t smem = raw + pad;
  float* pen = reinterpret_cast<float*>(smem_raw + pad + kOffPen);

  const int tid = threadIdx.x;
  if (tid == 0) {
    const uint32_t bars = smem + kOffBar;
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + s * 8, 32);                          // full
      mbar_init(bars + (kStages + s) * 8, kConsumerWarps);  // empty
    }
    mbar_init(bars + 2 * kStages * 8, 1);  // own tile
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  const int per_pair = tiles_n + tiles_m;
  const int b = blockIdx.x / per_pair;
  const int t = blockIdx.x % per_pair;
  const uint8_t* mask1 = m1 + static_cast<size_t>(b) * N;
  const uint8_t* mask2 = m2 + static_cast<size_t>(b) * M;
  const bool producer = tid >= kConsumerWarps * 32;
  if (t < tiles_n) {
    const int own0 = t * kOwn;
    if (producer) {
      produce(&map1, &map2, mask2, M, own0, b, smem, pen, tid % 32);
    } else {
      const size_t out = static_cast<size_t>(b) * N;
      consume<false>(mask1, N, M, own0, smem, pen, tid, best + out,
                     second + out, best_j + out);
    }
  } else {
    const int own0 = (t - tiles_n) * kOwn;
    if (producer) {
      produce(&map2, &map1, mask1, N, own0, b, smem, pen, tid % 32);
    } else {
      consume<true>(mask2, M, N, own0, smem, pen, tid, nullptr, nullptr,
                    col_arg + static_cast<size_t>(b) * M);
    }
  }
}

typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, not in the CUDA runtime; the
// runtime hands out its address, so the library links against cudart
// alone.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(p);
    }
  }
  return fn;
}

// Tensor map over descriptors [pairs, rows, 128] u8 as (128 bytes, rows,
// pairs), box (128, kStr, 1), 128-byte swizzle, zeros out of bounds.
CUresult descriptor_map(EncodeTiledFn encode, CUtensorMap* map,
                        const void* ptr, int rows, int pairs) {
  const cuuint64_t dims[3] = {kRowBytes, static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(pairs)};
  const cuuint64_t strides[2] = {kRowBytes,
                                 static_cast<cuuint64_t>(rows) * kRowBytes};
  const cuuint32_t box[3] = {kRowBytes, kStr, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// More than 48 KB of dynamic shared memory has to be asked for, and the
// SM's split between L1 and shared memory set so that two blocks fit.  The
// attributes belong to the device, so they are set when it changes.
cudaError_t allow_shared_memory() {
  static int ready_device = -1;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || device == ready_device) return err;
  err = cudaFuncSetAttribute(topstats_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(topstats_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) ready_device = device;
  return err;
}

}  // namespace

// Offset of the codes that report a failed cuTensorMapEncodeTiled (the
// CUresult follows) or, at the offset itself, a libcuda without that call.
constexpr int kTensorMapError = 100000;

// d1 [B,N,128] u8, d2 [B,M,128] u8 (16-byte aligned), m1 [B,N] and m2 [B,M]
// bool (one byte each); best, second f32 [B,N], best_j i32 [B,N], col_arg
// i32 [B,M].  All contiguous.  Encodes the two tensor maps, launches the
// kernel on `stream` and returns 0, or the cudaError_t of a refused launch,
// or kTensorMapError + the CUresult of a refused tensor map.
extern "C" int topstats_launch(const void* d1, const void* d2, const void* m1,
                               const void* m2, void* best, void* second,
                               void* best_j, void* col_arg, int B, int N,
                               int M, void* stream) {
  const int tiles_n = (N + kOwn - 1) / kOwn;
  const int tiles_m = (M + kOwn - 1) / kOwn;
  const long long blocks = static_cast<long long>(B) * (tiles_n + tiles_m);
  if (B < 1 || N < 1 || M < 1 || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return kTensorMapError;
  CUtensorMap map1, map2;
  CUresult res = descriptor_map(encode, &map1, d1, N, B);
  if (res == CUDA_SUCCESS) res = descriptor_map(encode, &map2, d2, M, B);
  if (res != CUDA_SUCCESS) return kTensorMapError + static_cast<int>(res);

  cudaError_t err = allow_shared_memory();
  if (err != cudaSuccess) return static_cast<int>(err);
  topstats_kernel<<<static_cast<unsigned>(blocks), kThreads, kSmemBytes,
                    static_cast<cudaStream_t>(stream)>>>(
      map1, map2, static_cast<const uint8_t*>(m1),
      static_cast<const uint8_t*>(m2), N, M, tiles_n, tiles_m,
      static_cast<float*>(best), static_cast<float*>(second),
      static_cast<int*>(best_j), static_cast<int*>(col_arg));
  return static_cast<int>(cudaGetLastError());
}
