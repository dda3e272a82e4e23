// One model rank's share of a WN layer (tensor parallelism over the gate
// channels), for Hopper (sm_90a), CUDA C++ with a plain C interface (bound
// from Python with ctypes, see kernels/wn_layer.py::wn_layer_shard).
//
// Replaces what GSPMD makes of waveglow_tpu/kernels/wn_layer.py::
// _wn_layer_fused under a `model` mesh axis (waveglow_tpu/parallel/
// sharding.py: in_layers and cond column-parallel over the gate width C,
// res_skip row-parallel). A rank holds C' = C / model of the C gate
// channels and computes
//
//   pre     = sum_tap x[t + (tap-1)*d] @ w_in_s[tap]   (zero "same" padding)
//   g       = pre + b_in_s + cond_s                     (f32)
//   acts    = tanh(g[:C']) * sigmoid(g[C':])            (f32)
//   partial = acts @ w_rs_s                             (f32 accumulation)
//
// over the full C input channels of x. Built for C in {128, 256, 512} and
// C' = C / model, model in {2, 4, 8} (C' from 16 to 256). The partial is the
// rank's share of the res/skip sum, without b_rs and without the residual:
// the caller sums the ranks' partials in a fixed order, then adds b_rs, the
// residual, the valid_t row mask and the skip sum once
// (models/wn.py::wn_forward_tp).
//
// Layouts, row-major: x [B, T, C] f32; cond_s [B, T, 2C'] (tanh columns of
// this rank's channels, then its sigmoid columns); w_in_s [3, C, 2C']; b_in_s
// [2C'] f32; w_rs_s [C', 2C] ([C', C] for the last layer); partial [B, T, 2C]
// ([B, T, C]) f32. cond_s, w_in_s and w_rs_s are f32 (parity mode) or bf16
// (fast mode). In fast mode the taps of x and the acts are rounded to bf16
// before they enter a product, as wn_layer_kernel_mma rounds them, and every
// product accumulates in f32; the gate runs in f32. f32 mode is true FFMA,
// no TF32.
//
// What bounds it on an H100 SXM: a non-last layer at B=1, T=26,432 groups,
// C = 256 and C' = 128 does 2*T*(3*C*2C' + C'*2C) = 13.9 GFLOP, 0.21 ms at
// the 67 TFLOP/s f32 rate (operation-bound); in bf16 the same work is 0.014
// ms at 989 TFLOP/s, under the 0.028 ms its bytes take at 3.35 TB/s (x in,
// cond_s in, the f32 partial out: T*(4C + 2*2C' + 4*2C) = 95 MB), so bf16
// is byte-bound.
//
// Two kernels, one per mode.
//
// wn_shard_kernel (f32, FFMA on the CUDA cores, no TF32), after the f32
// forward kernel (csrc/wn_layer.cu, wn_layer_kernel_f32), whose cp.async
// ring, register-tile FMAs and one-wave grid it shares (csrc/f32_ring.cuh):
//   * One wave of blocks (SMs x blocks an SM, from the occupancy API), each
//     taking an equal share of the B*T rows, taken as one flat [B*T, C]
//     sequence, rounded up to a quantum of 4 warps' rows (one warp on each
//     scheduler), and walking it in tiles, the last one short: its warps
//     past the block's end skip the FMAs. Tap rows read x of their own
//     sequence only (zero-filled outside [0, T)).
//   * Register tile: a thread holds kR rows x 4 columns of an "a" half and
//     the same 4 columns of a "b" half: the tanh and sigmoid columns of 4
//     gate channels in the first product, so the gate (cond_s and b_in_s
//     added, tanh * sigmoid, f32) runs on the accumulators; 4 partial
//     columns and the 4 that lie C' further on in the second. kR = 8 at C'
//     >= 128 (12 warps, 168 registers), kR = 4 below (16 warps); at narrow
//     C' the lanes go to rows, not channels (a warp covers 16 rows x 64
//     channels at C' >= 128, 16 x 32 at 64 and 32, 32 x 16 at 16), so the
//     tile does not shrink with C': 48 rows at C' = 256 to 512 at 16. A
//     weight value read from shared memory feeds kR rows of FMAs.
//   * Ring: both products stream as one sequence of 16-row K chunks through
//     a 4-stage ring filled by cp.async, three chunks ahead, one barrier a
//     chunk, running on across tiles: 3C/16 chunks of w_in_s (all 2C'
//     columns) with the tile's tap rows of those 16 input channels, then
//     w_rs_s in passes of 2C' columns (N / 2C' passes of C'/16 chunks).
//   * The acts [tile rows][C'] are staged once a tile in shared memory; each
//     pass of the second product writes its columns from the accumulators
//     in 16-byte pieces, rows < T only.
// No atomics and no split K: each output is summed in one fixed order, so
// two launches give the same bits.
// Measured on an NVIDIA H100 80GB HBM3 (700 W) by chip_smoke.py, B=1, T =
// 26,432, d=1 (ms, share of the operation bound): C = 256, C' = 128 0.40
// (51%), 64 0.23 (44%), 32 0.15 (36%); C = 512, C' = 256 1.45 (57%), 128
// 0.79 (52%), 64 0.46 (45%); C = 128, C' = 64 / 32 / 16 0.12 / 0.079 /
// 0.055 (42% / 33% / 24%); the simple FFMA kernel it replaced took 0.63 ms
// at (256, 128) and 2.93 ms at (512, 256) on the same card. 117 to 168
// registers, no spills, 108,544 to 212,992 bytes of shared memory, one
// block an SM. At B=1 the narrow pairs hold fewer warps of work than the
// card has slots: a quantum of 32 to 128 rows against about 200 rows an
// SM. PERF.md keeps the times.
//
// wn_shard_kernel_mma (bf16, tensor cores): mma.sync m16n8k16 (bf16
// operands, f32 accumulators) fed by ldmatrix from padded shared memory.
// One block of 256 threads (8 warps) per (batch row, tile of 64 time rows);
// both products run as one sequence of K chunks through a 4-stage ring:
//   * first product, 3C/32 chunks of 32 K rows (tap = chunk / (C/32)): the
//     chunk's w_in_s rows (all 2C' columns) by cp.async, and its 64 tap
//     rows x 32 channels of x, loaded into registers one chunk ahead of
//     their slot (f32 cannot be cp.async'd into bf16), rounded to bf16 and
//     stored after the current chunk's products;
//   * the warp grid pairs gate columns: warp (rw, cw) holds rows
//     [rw*R, rw*R + R) and both the tanh and the sigmoid columns of the
//     same C'/kColWarps channels, so the gate runs on the accumulators
//     (cond_s and b_in_s added in f32), and the acts go to shared memory
//     rounded to bf16;
//   * second product, N/128 column blocks x C'/K2 chunks of w_rs_s (K2 =
//     min(32, C')): each warp holds 32 rows x 32 columns of the block, and
//     after the block's last chunk writes them straight from the
//     accumulators: lane pairs swap halves (one shuffle), so each lane
//     stores 4 adjacent f32 columns, 16 bytes, of one row.
// No atomics and no split K: every output is summed in one fixed order, so
// two launches give the same bits.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

#include "f32_ring.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---- the f32 kernel (FFMA) --------------------------------------------------

constexpr int kChunk = 16;               // K rows of a ring stage
constexpr int kTapStride = kChunk + 4;   // padded tap row: the 2-8 rows a
                                         // warp reads fall in distinct banks

// The f32 kernel's layout for (C, C', last). A thread holds kR rows x 4
// columns of an "a" half and the same 4 columns of a "b" half of a 2C'-wide
// block: in the first product the tanh and the sigmoid columns of 4 gate
// channels, in the second 4 partial columns and the 4 that lie C' further on.
// A warp spreads kQuads lanes over column quads and kRowLanes over rows
// (rows r0 + kRowLanes * i), so the tile does not shrink with C': at C' >=
// 128 (kR = 8) a warp covers 16 rows x 64 channels; at C' = 64 and 32 (kR =
// 4: at B=1 the narrow pairs have little work a warp) 16 rows x 32, at C' =
// 16 32 rows x 16. kThreads / 32 warps tile kTileRows rows; 4 of them (one
// a scheduler) cover a quantum of rows. Ring slot: the chunk's taps
// [kTileRows][kTapStride], then its weight rows [kChunk][2C']; acts
// [kTileRows][C' + 4]; all f32.
template <int kC, int kCP, bool kLast>
struct ShardF32 {
  static constexpr int kN = kLast ? kC : 2 * kC;          // partial columns
  static constexpr int kR = kCP >= 128 ? 8 : 4;           // rows a thread
  // lanes across column quads: 16 at kR = 8, at most 8 at kR = 4
  static constexpr int kQuads = kR == 8 ? 16 : (kCP / 4 < 8 ? kCP / 4 : 8);
  static constexpr int kRowLanes = 32 / kQuads;            // lanes down
  static constexpr int kWarpRows = kR * kRowLanes;
  static constexpr int kColWarps = kCP / (4 * kQuads);
  // 12 warps (3 a scheduler) under the 168 registers of kR = 8; 16 (4 a
  // scheduler) at kR = 4, whose threads fit in 128
  static constexpr int kThreads = kR == 8 ? 384 : 512;
  static constexpr int kRowWarps = kThreads / 32 / kColWarps;
  static constexpr int kTileRows = kRowWarps * kWarpRows;
  static constexpr int kQuantum = kTileRows * 128 / kThreads;  // 4 warps' rows
  static constexpr int kStages = 4;
  static constexpr int kAhead = kStages - 1;  // chunks in flight under the FMAs
  static constexpr int kInChunks = 3 * kC / kChunk;       // w_in_s and taps
  static constexpr int kChunksPerTap = kC / kChunk;
  static constexpr int kRsPerPass = kCP / kChunk;         // w_rs_s, a pass
  static constexpr int kPasses = kN / (2 * kCP);          // 2C' columns each
  static constexpr int kChunks = kInChunks + kPasses * kRsPerPass;  // a tile
  static constexpr int kTapFloats = kTileRows * kTapStride;
  // a tile row's taps of a chunk are 4 16-byte pieces, copied by kTapSplit
  // threads (threads past kTapSplit * kTileRows copy none)
  static constexpr int kTapSplit =
      kThreads / kTileRows < 4 ? kThreads / kTileRows : 4;
  static constexpr int kSlotFloats = kTapFloats + kChunk * 2 * kCP;
  static constexpr int kActsStride = kCP + 4;  // padded like the tap rows
  static constexpr int kSmemBytes =
      sizeof(float) * (kStages * kSlotFloats + kTileRows * kActsStride);
  static_assert(kColWarps * kRowWarps * 32 == kThreads, "warp grid");
  static_assert(kRowWarps * kColWarps % 4 == 0 && kQuantum * kColWarps ==
                4 * kWarpRows, "a quantum is 4 warps, one a scheduler");
  static_assert(4 * kQuads * kColWarps == kCP && kColWarps >= 1, "quads");
  static_assert(kPasses >= 1 && kTapSplit >= 1 && 4 % kTapSplit == 0,
                "passes, tap pieces");
  static_assert(kCP % kChunk == 0 && kN % (2 * kCP) == 0, "chunks");
  static_assert(kSmemBytes <= 232448, "over the 227 KB a block may use");
};

// Start the cp.async copies of chunk `chunk` of the block's sequence into its
// ring slot. Each tile of the block's rows takes kChunks chunks: kInChunks of
// w_in_s (16 K rows each, all 2C' columns) with the matching taps, then per
// pass p of the second product kRsPerPass of w_rs_s (16 K rows, columns
// [2C' p, 2C' p + 2C')). Taps are rows of the flat [B*T, C] x: tile row r is
// flat row R = b*T + t, and its tap reads row R + (tap-1)*d, zero unless t +
// (tap-1)*d lies in [0, T) (its own sequence) and R before the block's end.
// This thread copies pieces of tile row r = tid / kTapSplit; tap_t holds
// that row's t for the tile being loaded, set at its first chunk (a large
// negative past the block's end), so the division by T runs once a tile.
template <int kC, int kCP, bool kLast>
__device__ __forceinline__ void shard_load_chunk(
    uint32_t ring, int chunk, int row_begin, int row_end, const float* x,
    const float* w_in, const float* w_rs, int T, int dilation, int& tap_t) {
  using L = ShardF32<kC, kCP, kLast>;
  const int tile = chunk / L::kChunks;
  const int local = chunk % L::kChunks;
  const uint32_t slot = ring + (chunk % L::kStages) * L::kSlotFloats * 4;
  const int r = threadIdx.x / L::kTapSplit;
  const int row = row_begin + tile * L::kTileRows + r;  // flat row
  if (local == 0)
    tap_t = row < row_end
                ? row - static_cast<int>(static_cast<unsigned>(row) /
                                         static_cast<unsigned>(T)) * T
                : INT32_MIN / 2;
  const uint32_t wslot = slot + L::kTapFloats * 4;
  if (local >= L::kInChunks) {
    // 16 rows of w_rs_s, columns [2C' p, 2C' p + 2C') of pass p
    const int j = local - L::kInChunks;
    const int col = (j / L::kRsPerPass) * 2 * kCP;
    copy_rows<kChunk, L::kThreads, 2 * kCP, 2 * kCP>(
        wslot, w_rs + static_cast<int64_t>(j % L::kRsPerPass) * kChunk * L::kN,
        L::kN, col, 0);
  } else {
    const int off = (local / L::kChunksPerTap - 1) * dilation;
    const int k0 = (local % L::kChunksPerTap) * kChunk;
    if (r < L::kTileRows) {
      constexpr int kPieces = 4 / L::kTapSplit;
      const int t = tap_t + off;
      const bool valid = t >= 0 && t < T;
      const int q0 = (threadIdx.x % L::kTapSplit) * kPieces;
      const float* src =
          valid ? x + static_cast<int64_t>(row + off) * kC + k0 + q0 * 4 : x;
#pragma unroll
      for (int q = 0; q < kPieces; ++q)
        cp_async16_zfill(slot + (r * kTapStride + (q0 + q) * 4) * 4,
                         src + q * 4, valid);
    }
    // 16 rows of w_in_s, all 2C' columns
    copy_rows<kChunk, L::kThreads, 2 * kCP, 2 * kCP>(
        wslot, w_in + static_cast<int64_t>(local) * kChunk * 2 * kCP, 2 * kCP,
        0, 0);
  }
}

// One ring slot's kChunk k: acc_a[i][j] += a[row kRL*i][k] * w[k][j] and
// acc_b[i][j] += a[row kRL*i][k] * w[k][kBOff + j]. `a` points at the
// thread's first row (rows kStride floats apart), `w` at its first column
// (rows kN floats apart).
template <int kR, int kRL, int kStride, int kN, int kBOff>
__device__ __forceinline__ void shard_chunk_fma(float (&acc_a)[kR][4],
                                                float (&acc_b)[kR][4],
                                                const float* a,
                                                const float* w) {
#pragma unroll
  for (int kk = 0; kk < kChunk; kk += 4) {
    // no shared load moves above this step: hoisting a whole chunk's
    // weights made ptxas spill at C' = 16
    asm volatile("" ::: "memory");
    tile_fma4<kR, kRL, kStride, kN, kBOff, true>(acc_a, acc_b, a, w, kk);
  }
}

// Block i takes flat rows [i * rows_per_block, (i + 1) * rows_per_block) of
// the B*T rows, in tiles of kTileRows (the last one short: its warps past
// the block's end skip the FMAs).
template <int kC, int kCP, bool kLast>
__global__ void __launch_bounds__(ShardF32<kC, kCP, kLast>::kThreads, 1)
wn_shard_kernel(const float* __restrict__ x, const float* __restrict__ cond,
                const float* __restrict__ w_in, const float* __restrict__ b_in,
                const float* __restrict__ w_rs, float* __restrict__ out, int T,
                int dilation, int rows, int rows_per_block) {
  using L = ShardF32<kC, kCP, kLast>;
  constexpr int kR = L::kR;
  constexpr int kRL = L::kRowLanes;
  const int row_begin = blockIdx.x * rows_per_block;
  const int row_end = min(rows, row_begin + rows_per_block);
  if (row_begin >= row_end) return;
  const int n_chunks =
      (row_end - row_begin + L::kTileRows - 1) / L::kTileRows * L::kChunks;

  extern __shared__ float4 shard_smem[];
  float* smem = reinterpret_cast<float*>(shard_smem);
  const uint32_t ring = smem_u32(smem);
  float* acts = smem + L::kStages * L::kSlotFloats;  // [kTileRows][kActsStride]

  // Warp w: rows [kWarpRows (w / kColWarps), +kWarpRows) of the tile and
  // columns [4 kQuads (w % kColWarps), +4 kQuads) of each half; lane l:
  // rows r0 + kRL i and columns c0..c0+3 (and C' further on). The lanes of
  // a row read one piece of a weight row, which the other rows' lanes
  // share.
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int warp_row = (warp / L::kColWarps) * L::kWarpRows;
  const int r0 = warp_row + lane / L::kQuads;
  const int c0 = 4 * (L::kQuads * (warp % L::kColWarps) + lane % L::kQuads);

  int tap_t;
  const auto load_chunk = [&](int chunk) {
    shard_load_chunk<kC, kCP, kLast>(ring, chunk, row_begin, row_end, x, w_in,
                                     w_rs, T, dilation, tap_t);
  };
  ring_prologue<L::kAhead>(n_chunks, load_chunk);

  float acc_a[kR][4];  // tanh, then partial columns [c0, c0 + 4) of a pass
  float acc_b[kR][4];  // sigmoid, then the columns C' further on
  for (int chunk0 = 0; chunk0 < n_chunks; chunk0 += L::kChunks) {
    const int t0 = row_begin + chunk0 / L::kChunks * L::kTileRows;  // flat row
    const int tile_rows = min(L::kTileRows, row_end - t0);
    const bool busy = warp_row < tile_rows;

    // ---- first product: pre[rows, 2C'] = taps[rows, 3C] @ w_in_s --------
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc_a[i][j] = acc_b[i][j] = 0.f;
#pragma unroll 1
    for (int kc = 0; kc < L::kInChunks; ++kc) {
      ring_step<L::kAhead>(chunk0 + kc, n_chunks, load_chunk);
      if (kc == L::kInChunks - 16) {
        // cond_s's rows of the tile into L2, for the gate
        const float* src = cond + static_cast<int64_t>(t0) * 2 * kCP;
        for (int q = threadIdx.x; q < tile_rows * 2 * kCP / 32;
             q += L::kThreads)
          prefetch_l2(src + q * 32);
      }
      if (busy) {
        const float* slot =
            smem + ((chunk0 + kc) % L::kStages) * L::kSlotFloats;
        shard_chunk_fma<kR, kRL, kTapStride, 2 * kCP, kCP>(
            acc_a, acc_b, slot + r0 * kTapStride, slot + L::kTapFloats + c0);
      }
    }

    // ---- gate (f32) on the accumulators, acts to shared memory -----------
    // The previous tile's acts were last read before this tile's barriers;
    // rows past the tile's end get zero taps and cond (finite, never stored).
    if (busy) {
      float bt[4], bs[4];
      load4(bt, b_in + c0);
      load4(bs, b_in + kCP + c0);
#pragma unroll
      for (int i0 = 0; i0 < kR; i0 += 2) {
        float ct[2][4], cs[2][4];  // 2 rows' loads in flight
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + kRL * (i0 + h);
          if (r < tile_rows) {
            const float* crow = cond + static_cast<int64_t>(t0 + r) * 2 * kCP;
            load4(ct[h], crow + c0);
            load4(cs[h], crow + kCP + c0);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) ct[h][j] = cs[h][j] = 0.f;
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float gt = acc_a[i0 + h][j] + bt[j] + ct[h][j];
            const float gs = acc_b[i0 + h][j] + bs[j] + cs[h][j];
            v[j] = tanhf(gt) * (1.f / (1.f + expf(-gs)));
          }
          store4(acts + (r0 + kRL * (i0 + h)) * L::kActsStride + c0, v);
        }
      }
    }

    // ---- second product: partial[rows, N] = acts[rows, C'] @ w_rs_s ------
    // pass p: columns [2C' p, 2C' p + 2C'); the first step's barrier orders
    // the acts writes before their reads
#pragma unroll 1
    for (int p = 0; p < L::kPasses; ++p) {
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc_a[i][j] = acc_b[i][j] = 0.f;
#pragma unroll 1
      for (int kc = 0; kc < L::kRsPerPass; ++kc) {
        const int local = L::kInChunks + p * L::kRsPerPass + kc;
        ring_step<L::kAhead>(chunk0 + local, n_chunks, load_chunk);
        if (busy) {
          const float* slot =
              smem + ((chunk0 + local) % L::kStages) * L::kSlotFloats;
          shard_chunk_fma<kR, kRL, L::kActsStride, 2 * kCP, kCP>(
              acc_a, acc_b, acts + r0 * L::kActsStride + kc * kChunk,
              slot + L::kTapFloats + c0);
        }
      }
      // the pass's columns, from the accumulators: rows < the tile's end
      if (busy) {
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          const int r = r0 + kRL * i;
          if (r >= tile_rows) break;
          float* o = out + static_cast<int64_t>(t0 + r) * L::kN + p * 2 * kCP +
                     c0;
          store4(o, acc_a[i]);
          store4(o + kCP, acc_b[i]);
        }
      }
    }
  }
  cp_async_wait<0>();
}

// ---- the bf16 kernel (tensor cores) -----------------------------------------

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// register i of lane l holds row l/4, columns 2(l%4), 2(l%4)+1 of matrix i
// (of its transpose with .trans).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a @ b: one m16n8k16 product on the tensor cores, bf16 operands, f32
// accumulators. Fragments: a (16x16, row-major) a0 = (g, 2q..2q+1), a1 =
// (g+8, 2q..), a2 = (g, 2q+8..), a3 = (g+8, 2q+8..); b (16x8) b0 = (k
// 2q..2q+1, n g), b1 = (k 2q+8.., n g); d d0,d1 = (g, 2q..2q+1), d2,d3 =
// (g+8, 2q..), with g = lane/4, q = lane%4.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo at the lower address
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return make_float2(__uint_as_float(v << 16),
                     __uint_as_float(v & 0xffff0000u));
}

constexpr int kThreads = 256;    // 8 warps
constexpr int kMmaRows = 64;     // time rows a block
constexpr int kK1 = 32;          // K rows of a first-product chunk
constexpr int kNB = 128;         // columns of a second-product block
constexpr int kMmaStages = 4;    // ring depth
constexpr int kMmaAhead = kMmaStages - 1;  // chunks loading ahead

// Shared layout of the (C, C', last) instance, in bytes. Rows are padded
// by 16 bytes past a multiple of 128, so the 8 rows of an 8x8 ldmatrix fall
// in different banks.
template <int kC, int kCP, bool kLast>
struct ShardMma {
  static constexpr int kN = kLast ? kC : 2 * kC;   // partial columns
  static constexpr int kK2 = kCP < 32 ? kCP : 32;   // K rows of a w_rs chunk
  static constexpr int kColWarps = kCP / 8 < 4 ? kCP / 8 : 4;
  static constexpr int kRowWarps = 8 / kColWarps;
  static constexpr int kWarpRows = kMmaRows / kRowWarps;  // 32 or 16
  static constexpr int kM = kWarpRows / 16;               // m16 blocks
  static constexpr int kWarpCh = kCP / kColWarps;         // channels a warp
  static constexpr int kN8 = kWarpCh / 8;                 // n8 blocks a half
  static constexpr int kAStride = kK1 + 8;        // x chunk row (bf16)
  static constexpr int kWStride = 2 * kCP + 8;    // w_in_s chunk row
  static constexpr int kRStride = kNB + 8;        // w_rs_s chunk row
  static constexpr int kActStride = kCP + 8;      // acts row
  static constexpr int kABytes = kMmaRows * kAStride * 2;
  static constexpr int kIn1Bytes = kABytes + kK1 * kWStride * 2;
  static constexpr int kIn2Bytes = kK2 * kRStride * 2;
  static constexpr int kSlotBytes = kIn1Bytes > kIn2Bytes ? kIn1Bytes : kIn2Bytes;
  static constexpr int kActBytes = kMmaRows * kActStride * 2;
  static constexpr int kSmem = kMmaStages * kSlotBytes + kActBytes;
  static constexpr int kChunks1 = 3 * kC / kK1;
  static constexpr int kChunksPerBlock = kCP / kK2;
  static constexpr int kChunks = kChunks1 + kN / kNB * kChunksPerBlock;
  // float4 pieces of x a thread loads for a chunk: 64 rows x 32 channels
  static constexpr int kAPieces = kMmaRows * kK1 / 4 / kThreads;  // 2
  static_assert(kColWarps * kRowWarps == 8 && kM >= 1 && kN8 >= 1, "warps");
  static_assert(kN % kNB == 0 && kCP % kK2 == 0 && kK2 % 16 == 0, "shapes");
  static_assert(kSmem <= 232448, "over the 227 KB a block may use");
};

// Load, into registers, the x pieces of chunk `c` of the first product
// (tap c / (C/32), channels (c % (C/32)) * 32 + [0, 32)) for the tile's 64
// rows: zero outside [0, T).
template <int kC, int kPieces>
__device__ __forceinline__ void load_x_chunk(float4 (&v)[kPieces], int c,
                                             const float* xb, int t0, int T,
                                             int dilation) {
  const int tap = c / (kC / kK1);
  const int k0 = (c % (kC / kK1)) * kK1;
#pragma unroll
  for (int i = 0; i < kPieces; ++i) {
    const int p = threadIdx.x + i * kThreads;
    const int r = p / (kK1 / 4), q = p % (kK1 / 4);
    const int t = t0 + r + (tap - 1) * dilation;
    v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t >= 0 && t < T)
      v[i] = __ldg(reinterpret_cast<const float4*>(
          xb + static_cast<int64_t>(t) * kC + k0 + q * 4));
  }
}

// Round the loaded x pieces to bf16 into a slot's A area [64][kAStride].
template <int kAStride, int kPieces>
__device__ __forceinline__ void store_x_chunk(char* a_area,
                                              const float4 (&v)[kPieces]) {
#pragma unroll
  for (int i = 0; i < kPieces; ++i) {
    const int p = threadIdx.x + i * kThreads;
    const int r = p / (kK1 / 4), q = p % (kK1 / 4);
    *reinterpret_cast<uint2*>(a_area + (r * kAStride + q * 4) * 2) =
        make_uint2(pack_bf16(v[i].x, v[i].y), pack_bf16(v[i].z, v[i].w));
  }
}

// Start the cp.async copies of chunk `c`'s weights into its slot: for the
// first product the w_in_s rows [32c, 32c + 32) (all 2C' columns) after the
// A area; for the second, column block (c - kChunks1) / kChunksPerBlock of
// w_rs_s, rows of K chunk (c - kChunks1) % kChunksPerBlock.
template <int kC, int kCP, bool kLast>
__device__ __forceinline__ void load_w_chunk(uint32_t slot, int c,
                                             const bf16* w_in,
                                             const bf16* w_rs) {
  using L = ShardMma<kC, kCP, kLast>;
  if (c < L::kChunks1) {
    constexpr int kPerRow = 2 * kCP / 8;  // 16-byte pieces
    constexpr int kPieces = kK1 * kPerRow;
    const bf16* src = w_in + static_cast<int64_t>(c) * kK1 * 2 * kCP;
#pragma unroll
    for (int i = 0; i < (kPieces + kThreads - 1) / kThreads; ++i) {
      const int p = threadIdx.x + i * kThreads;
      if (kPieces % kThreads == 0 || p < kPieces) {
        const int r = p / kPerRow, q = p % kPerRow;
        cp_async16(slot + L::kABytes + (r * L::kWStride + q * 8) * 2,
                   src + r * 2 * kCP + q * 8);
      }
    }
  } else {
    const int j = c - L::kChunks1;
    const int n0 = (j / L::kChunksPerBlock) * kNB;
    const int k0 = (j % L::kChunksPerBlock) * L::kK2;
    constexpr int kPerRow = kNB / 8;
    constexpr int kPieces = L::kK2 * kPerRow;
#pragma unroll
    for (int i = 0; i < (kPieces + kThreads - 1) / kThreads; ++i) {
      const int p = threadIdx.x + i * kThreads;
      if (kPieces % kThreads == 0 || p < kPieces) {
        const int r = p / kPerRow, q = p % kPerRow;
        cp_async16(slot + (r * L::kRStride + q * 8) * 2,
                   w_rs + static_cast<int64_t>(k0 + r) * L::kN + n0 + q * 8);
      }
    }
  }
}

template <int kC, int kCP, bool kLast>
__global__ void __launch_bounds__(kThreads, 1)
wn_shard_kernel_mma(const float* __restrict__ x, const bf16* __restrict__ cond,
                    const bf16* __restrict__ w_in,
                    const float* __restrict__ b_in,
                    const bf16* __restrict__ w_rs, float* __restrict__ out,
                    int T, int dilation) {
  using L = ShardMma<kC, kCP, kLast>;
  extern __shared__ __align__(16) uint4 shard_mma_smem[];
  char* base = reinterpret_cast<char*>(shard_mma_smem);
  const uint32_t ring_s = smem_u32(base);
  char* acts = base + kMmaStages * L::kSlotBytes;  // [64][kActStride] bf16
  const uint32_t acts_s = smem_u32(acts);

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kMmaRows;
  const int rows = min(kMmaRows, T - t0);
  const int64_t row0 = static_cast<int64_t>(b) * T + t0;
  const float* xb = x + static_cast<int64_t>(b) * T * kC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q4 = lane % 4;

  // ---- prologue: chunks 0 .. kMmaAhead-1 (first-product chunks) ----------
  for (int c = 0; c < kMmaAhead; ++c) {
    float4 v[L::kAPieces];
    load_x_chunk<kC>(v, c, xb, t0, T, dilation);
    store_x_chunk<L::kAStride>(base + c * L::kSlotBytes, v);
    load_w_chunk<kC, kCP, kLast>(ring_s + c * L::kSlotBytes, c, w_in, w_rs);
    cp_async_commit();
  }

  // ---- first product: warp (rw, cw) holds rows [rw*R, +R) and channels
  // [cw*W, +W) of the tanh half and of the sigmoid half: m16 block mi, n8
  // block j, element e is row rw*R + 16mi + g + 8(e/2), channel cw*W + 8j +
  // 2q4 + e%2
  const int rw1 = warp / L::kColWarps, cw1 = warp % L::kColWarps;
  const int r1 = rw1 * L::kWarpRows;
  const int ch1 = cw1 * L::kWarpCh;
  float acc_t[L::kM][L::kN8][4], acc_s[L::kM][L::kN8][4];
#pragma unroll
  for (int mi = 0; mi < L::kM; ++mi)
#pragma unroll
    for (int j = 0; j < L::kN8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_t[mi][j][e] = acc_s[mi][j][e] = 0.f;

  // second product: warp (rw, cw) holds rows [32rw, +32) and columns
  // [32cw, +32) of the current 128-column block
  const int r2 = (warp / 4) * 32;
  const int n2 = (warp % 4) * 32;
  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;

#pragma unroll 1
  for (int c = 0; c < L::kChunks; ++c) {
    // chunk c landed for every thread; chunk c-1's slot is free
    cp_async_wait<kMmaAhead - 1>();
    __syncthreads();
    const int next = c + kMmaAhead;
    const uint32_t next_slot = ring_s + (next % kMmaStages) * L::kSlotBytes;
    float4 v[L::kAPieces];
    const bool next_x = next < L::kChunks1;
    if (next_x) load_x_chunk<kC>(v, next, xb, t0, T, dilation);
    if (next < L::kChunks) load_w_chunk<kC, kCP, kLast>(next_slot, next, w_in, w_rs);
    cp_async_commit();
    const uint32_t slot = ring_s + (c % kMmaStages) * L::kSlotBytes;

    if (c < L::kChunks1) {
#pragma unroll
      for (int kk = 0; kk < kK1; kk += 16) {
        uint32_t a[L::kM][4];
#pragma unroll
        for (int mi = 0; mi < L::kM; ++mi)
          ldsm_x4(a[mi], slot + ((r1 + 16 * mi + lane % 16) * L::kAStride +
                                 kk + (lane / 16) * 8) * 2);
        // matrices 0, 1: the tanh n8 block's k rows 0-7, 8-15; 2, 3: the
        // sigmoid block's
        const uint32_t brow =
            slot + L::kABytes +
            ((kk + lane % 8 + ((lane / 8) % 2) * 8) * L::kWStride + ch1 +
             (lane / 16) * kCP) * 2;
#pragma unroll
        for (int j = 0; j < L::kN8; ++j) {
          uint32_t bw[4];
          ldsm_x4_t(bw, brow + j * 8 * 2);
#pragma unroll
          for (int mi = 0; mi < L::kM; ++mi) {
            mma16816(acc_t[mi][j], a[mi], bw[0], bw[1]);
            mma16816(acc_s[mi][j], a[mi], bw[2], bw[3]);
          }
        }
      }
    } else {
      const int k0 = ((c - L::kChunks1) % L::kChunksPerBlock) * L::kK2;
#pragma unroll
      for (int kk = 0; kk < L::kK2; kk += 16) {
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldsm_x4(a[mi], acts_s + ((r2 + 16 * mi + lane % 16) * L::kActStride +
                                   k0 + kk + (lane / 16) * 8) * 2);
#pragma unroll
        for (int pb = 0; pb < 2; ++pb) {
          uint32_t bw[4];
          ldsm_x4_t(bw, slot + ((kk + lane % 8 + ((lane / 8) % 2) * 8) *
                                    L::kRStride +
                                n2 + pb * 16 + (lane / 16) * 8) * 2);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma16816(acc[mi][2 * pb], a[mi], bw[0], bw[1]);
            mma16816(acc[mi][2 * pb + 1], a[mi], bw[2], bw[3]);
          }
        }
      }
    }
    // chunk `next`'s x into its slot, now that this chunk's loads are done
    if (next_x) store_x_chunk<L::kAStride>(base + (next % kMmaStages) * L::kSlotBytes, v);

    if (c == L::kChunks1 - 1) {
      // ---- the gate (f32) on the accumulators, acts to shared as bf16 ----
      // Rows >= T have zero taps and cond: finite acts, never stored.
      // The next step's barrier orders these stores before their reads.
#pragma unroll
      for (int j = 0; j < L::kN8; ++j) {
        const int ch = ch1 + 8 * j + 2 * q4;
        const float2 bt = *reinterpret_cast<const float2*>(b_in + ch);
        const float2 bs = *reinterpret_cast<const float2*>(b_in + kCP + ch);
#pragma unroll
        for (int mi = 0; mi < L::kM; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = r1 + 16 * mi + g + 8 * h;
            float2 ct = make_float2(0.f, 0.f), cs = make_float2(0.f, 0.f);
            if (row < rows) {
              const bf16* cr = cond + (row0 + row) * 2 * kCP + ch;
              ct = unpack_bf16(*reinterpret_cast<const uint32_t*>(cr));
              cs = unpack_bf16(*reinterpret_cast<const uint32_t*>(cr + kCP));
            }
            const float gt0 = acc_t[mi][j][2 * h] + bt.x + ct.x;
            const float gt1 = acc_t[mi][j][2 * h + 1] + bt.y + ct.y;
            const float gs0 = acc_s[mi][j][2 * h] + bs.x + cs.x;
            const float gs1 = acc_s[mi][j][2 * h + 1] + bs.y + cs.y;
            const float v0 = tanhf(gt0) * (1.f / (1.f + expf(-gs0)));
            const float v1 = tanhf(gt1) * (1.f / (1.f + expf(-gs1)));
            *reinterpret_cast<uint32_t*>(acts + (row * L::kActStride + ch) * 2) =
                pack_bf16(v0, v1);
          }
      }
    } else if (c >= L::kChunks1 &&
               (c - L::kChunks1) % L::kChunksPerBlock == L::kChunksPerBlock - 1) {
      // ---- the column block is done: write it from the accumulators ------
      // Lanes q4 and q4^1 swap halves: the even lane then holds row g,
      // columns 4(q4/2)..+3 of an n8 block, the odd lane row g+8.
      const int n0 = ((c - L::kChunks1) / L::kChunksPerBlock) * kNB + n2;
      const bool odd = q4 & 1;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* d = acc[mi][j];
          const float s0 = __shfl_xor_sync(0xffffffffu, odd ? d[0] : d[2], 1);
          const float s1 = __shfl_xor_sync(0xffffffffu, odd ? d[1] : d[3], 1);
          const float4 o = odd ? make_float4(s0, s1, d[2], d[3])
                               : make_float4(d[0], d[1], s0, s1);
          const int row = r2 + 16 * mi + g + (odd ? 8 : 0);
          if (row < rows)
            *reinterpret_cast<float4*>(out + (row0 + row) * L::kN + n0 + 8 * j +
                                       4 * (q4 / 2)) = o;
#pragma unroll
          for (int e = 0; e < 4; ++e) d[e] = 0.f;
        }
    }
  }
  cp_async_wait<0>();
}

// ---- launch -----------------------------------------------------------------

// The f32 kernel's grid for `rows` flat rows: one wave of blocks (SMs x
// blocks an SM, the occupancy API, read once per instance and device after
// the shared-memory opt-in), each taking an equal share of the rows rounded
// up to the instance's quantum, so no SM runs more than one short tile.
struct F32Grid {
  int sms, per_sm, blocks, rows_per_block, tile_rows, quantum;
};

template <int kC, int kCP, bool kLast>
cudaError_t f32_grid(int rows, F32Grid* g) {
  using L = ShardF32<kC, kCP, kLast>;
  static std::atomic<int> cache[32];
  static std::atomic<uint32_t> opted_in{0};
  cudaError_t err = wave_slots(wn_shard_kernel<kC, kCP, kLast>, L::kThreads,
                               L::kSmemBytes, cache, &opted_in, &g->sms,
                               &g->per_sm);
  if (err != cudaSuccess) return err;
  g->rows_per_block = one_wave_rows(rows, g->sms * g->per_sm, L::kQuantum);
  g->blocks = (rows + g->rows_per_block - 1) / g->rows_per_block;
  g->tile_rows = L::kTileRows;
  g->quantum = L::kQuantum;
  return cudaSuccess;
}

// The (C, C', bf16, last) instance as a function pointer, and the dynamic
// shared bytes its launcher passes.
template <int kC, int kCP, bool kBf16, bool kLast>
const void* instance(int* smem_bytes) {
  if constexpr (kBf16) {
    *smem_bytes = ShardMma<kC, kCP, kLast>::kSmem;
    return reinterpret_cast<const void*>(wn_shard_kernel_mma<kC, kCP, kLast>);
  } else {
    *smem_bytes = ShardF32<kC, kCP, kLast>::kSmemBytes;
    return reinterpret_cast<const void*>(wn_shard_kernel<kC, kCP, kLast>);
  }
}

template <int kC, int kCP, bool kBf16, bool kLast>
cudaError_t launch(const float* x, const void* cond, const void* w_in,
                   const float* b_in, const void* w_rs, float* out, int batch,
                   int T, int dilation, cudaStream_t stream) {
  if constexpr (kBf16) {
    static std::atomic<uint32_t> opted_in{0};
    constexpr int smem = ShardMma<kC, kCP, kLast>::kSmem;
    auto kernel = wn_shard_kernel_mma<kC, kCP, kLast>;
    cudaError_t err = opt_in_smem(kernel, smem, &opted_in);
    if (err != cudaSuccess) return err;
    dim3 grid((T + kMmaRows - 1) / kMmaRows, batch);
    kernel<<<grid, kThreads, smem, stream>>>(
        x, static_cast<const bf16*>(cond), static_cast<const bf16*>(w_in), b_in,
        static_cast<const bf16*>(w_rs), out, T, dilation);
  } else {
    using L = ShardF32<kC, kCP, kLast>;
    const int rows = batch * T;
    F32Grid g;
    cudaError_t err = f32_grid<kC, kCP, kLast>(rows, &g);  // also opts in
    if (err != cudaSuccess) return err;
    wn_shard_kernel<kC, kCP, kLast><<<g.blocks, L::kThreads, L::kSmemBytes,
                                      stream>>>(
        x, static_cast<const float*>(cond), static_cast<const float*>(w_in),
        b_in, static_cast<const float*>(w_rs), out, T, dilation, rows,
        g.rows_per_block);
  }
  return cudaGetLastError();
}

struct Args {
  const float* x;
  const void* cond;
  const void* w_in;
  const float* b_in;
  const void* w_rs;
  float* out;
  int batch, T, dilation;
  cudaStream_t stream;
};

// Launch the (C, C') instance in the mode `bf16_mode` and variant `last`,
// or (with `a` null) return it as a function pointer and its shared bytes.
template <int kC, int kCP>
cudaError_t dispatch_pair(const Args* a, int bf16_mode, int last,
                          const void** kernel, int* smem_bytes) {
#define WN_SHARD_CASE(BF, LAST)                                              \
  if (a == nullptr) {                                                         \
    *kernel = instance<kC, kCP, BF, LAST>(smem_bytes);                        \
    return cudaSuccess;                                                       \
  }                                                                           \
  return launch<kC, kCP, BF, LAST>(a->x, a->cond, a->w_in, a->b_in, a->w_rs, \
                                   a->out, a->batch, a->T, a->dilation,      \
                                   a->stream)
  if (bf16_mode) {
    if (last) { WN_SHARD_CASE(true, true); }
    WN_SHARD_CASE(true, false);
  }
  if (last) { WN_SHARD_CASE(false, true); }
  WN_SHARD_CASE(false, false);
#undef WN_SHARD_CASE
}

// The built (C, C') pairs: C' = C / model, model in {2, 4, 8}.
template <int kC>
cudaError_t dispatch_width(int cp, const Args* a, int bf16_mode, int last,
                           const void** kernel, int* smem_bytes) {
  if (cp == kC / 2)
    return dispatch_pair<kC, kC / 2>(a, bf16_mode, last, kernel, smem_bytes);
  if (cp == kC / 4)
    return dispatch_pair<kC, kC / 4>(a, bf16_mode, last, kernel, smem_bytes);
  if (cp == kC / 8)
    return dispatch_pair<kC, kC / 8>(a, bf16_mode, last, kernel, smem_bytes);
  return cudaErrorInvalidValue;
}

cudaError_t dispatch(int c, int cp, const Args* a, int bf16_mode, int last,
                     const void** kernel, int* smem_bytes) {
  switch (c) {
    case 128: return dispatch_width<128>(cp, a, bf16_mode, last, kernel, smem_bytes);
    case 256: return dispatch_width<256>(cp, a, bf16_mode, last, kernel, smem_bytes);
    case 512: return dispatch_width<512>(cp, a, bf16_mode, last, kernel, smem_bytes);
    default: return cudaErrorInvalidValue;
  }
}

// The f32 grid of the (C, C', last) instance.
template <int kC, int kCP>
cudaError_t f32_grid_pair(int last, int rows, F32Grid* g) {
  return last ? f32_grid<kC, kCP, true>(rows, g)
              : f32_grid<kC, kCP, false>(rows, g);
}

template <int kC>
cudaError_t f32_grid_for(int cp, int last, int rows, F32Grid* g) {
  if (cp == kC / 2) return f32_grid_pair<kC, kC / 2>(last, rows, g);
  if (cp == kC / 4) return f32_grid_pair<kC, kC / 4>(last, rows, g);
  if (cp == kC / 8) return f32_grid_pair<kC, kC / 8>(last, rows, g);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Shapes: x [batch, T, c] f32; cond [batch, T, 2*cp]; w_in [3, c, 2*cp];
// b_in [2*cp] f32; w_rs [cp, 2c] or [cp, c] (last != 0); out [batch, T,
// 2c] or [batch, T, c] f32. cond/w_in/w_rs are bf16 when bf16 != 0, else
// f32. c must be 128, 256 or 512 and cp one of c/2, c/4, c/8. All pointers
// 16-byte aligned and contiguous. Launches on `stream`, does not
// synchronise; returns the launch error.
cudaError_t wn_layer_shard_forward(const float* x, const void* cond,
                                   const void* w_in, const float* b_in,
                                   const void* w_rs, float* out, int batch,
                                   int T, int c, int cp, int dilation, int bf16,
                                   int last, cudaStream_t stream) {
  if (T <= 0 || batch <= 0 || batch > 65535 ||
      static_cast<int64_t>(batch) * T > INT32_MAX)
    return cudaErrorInvalidValue;
  const Args a{x, cond, w_in, b_in, w_rs, out, batch, T, dilation, stream};
  return dispatch(c, cp, &a, bf16, last, nullptr, nullptr);
}

// What the loaded build of the (c, cp, bf16, last) kernel uses, read from
// the CUDA runtime: registers per thread, local (spill) bytes per thread,
// static shared bytes, and the dynamic shared bytes its launcher passes.
cudaError_t wn_layer_shard_kernel_info(int c, int cp, int bf16, int last,
                                       int* registers, int* local_bytes,
                                       int* static_smem_bytes,
                                       int* dynamic_smem_bytes) {
  const void* kernel = nullptr;
  cudaError_t err = dispatch(c, cp, nullptr, bf16, last, &kernel,
                             dynamic_smem_bytes);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  *registers = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *static_smem_bytes = static_cast<int>(attr.sharedSizeBytes);
  return cudaSuccess;
}

// The f32 kernel's grid for the (c, cp, last) instance at `batch` x T rows,
// as its launcher picks it: SMs, blocks an SM (occupancy API), blocks
// launched, rows a block takes, rows of a tile and the quantum the rows a
// block are rounded to.
cudaError_t wn_layer_shard_f32_schedule(int c, int cp, int batch, int T,
                                        int last, int* sms, int* blocks_per_sm,
                                        int* blocks, int* rows_per_block,
                                        int* tile_rows, int* quantum) {
  if (T <= 0 || batch <= 0 || static_cast<int64_t>(batch) * T > INT32_MAX)
    return cudaErrorInvalidValue;
  F32Grid g;
  cudaError_t err;
  switch (c) {
    case 128: err = f32_grid_for<128>(cp, last, batch * T, &g); break;
    case 256: err = f32_grid_for<256>(cp, last, batch * T, &g); break;
    case 512: err = f32_grid_for<512>(cp, last, batch * T, &g); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  *sms = g.sms;
  *blocks_per_sm = g.per_sm;
  *blocks = g.blocks;
  *rows_per_block = g.rows_per_block;
  *tile_rows = g.tile_rows;
  *quantum = g.quantum;
  return cudaSuccess;
}

}  // extern "C"
