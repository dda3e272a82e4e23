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
// before they enter a product, and every product accumulates in f32; the
// gate runs in f32. f32 mode is true FFMA, no TF32.
//
// What bounds it on an H100 SXM: a non-last layer at B=1, T=26,432 groups,
// C = 256 and C' = 128 does 2*T*(3*C*2C' + C'*2C) = 13.9 GFLOP, 0.21 ms at
// the 67 TFLOP/s f32 rate (operation-bound); in bf16 the same work is 0.014
// ms at 989 TFLOP/s, under the 0.028 ms its bytes take at 3.35 TB/s (x in,
// cond_s in, the f32 partial out: T*(4C + 2*2C' + 4*2C) = 95 MB), so bf16
// is byte-bound.
//
// This file holds the f32 kernel. A rank's bf16 share runs the wgmma
// kernels of wn_layer.cu (wn_layer_shard_wide_forward; its note says
// which, and their times): at C = 512 the layer's three kernels at gate
// width C' (x rounded once, the gate, the res/skip product storing the
// partial); at C <= 256 one, wn_layer_kernel_rank (the gate in one pass of
// every gate channel, on the f32 taps it rounds itself, then the res/skip
// product from its shared memory). They replaced wn_shard_kernel_mma,
// mma.sync m16n8k16 fed by ldmatrix, 64 time rows a block, which streamed
// all of w_in_s and w_rs_s from L2 for every 64 rows and rounded the f32
// taps on every chunk.

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

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "f32_ring.cuh"

namespace {

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

// The f32 kernel at (C, C', last), launched with `a`, or (with `a` null)
// returned as a function pointer with the dynamic shared bytes its launcher
// passes.
struct Args {
  const float* x;
  const float* cond;
  const float* w_in;
  const float* b_in;
  const float* w_rs;
  float* out;
  int batch, T, dilation;
  cudaStream_t stream;
};

template <int kC, int kCP, bool kLast>
cudaError_t launch(const Args* a, const void** kernel, int* smem_bytes) {
  using L = ShardF32<kC, kCP, kLast>;
  if (a == nullptr) {
    *kernel = reinterpret_cast<const void*>(wn_shard_kernel<kC, kCP, kLast>);
    *smem_bytes = L::kSmemBytes;
    return cudaSuccess;
  }
  const int rows = a->batch * a->T;
  F32Grid g;
  cudaError_t err = f32_grid<kC, kCP, kLast>(rows, &g);  // also opts in
  if (err != cudaSuccess) return err;
  wn_shard_kernel<kC, kCP, kLast><<<g.blocks, L::kThreads, L::kSmemBytes,
                                    a->stream>>>(
      a->x, a->cond, a->w_in, a->b_in, a->w_rs, a->out, a->T, a->dilation,
      rows, g.rows_per_block);
  return cudaGetLastError();
}

// The built (C, C') pairs: C' = C / model, model in {2, 4, 8}.
template <int kC>
cudaError_t dispatch_width(int cp, const Args* a, int last,
                           const void** kernel, int* smem_bytes) {
#define WN_SHARD_PAIR(CP)                                                   \
  if (cp == CP)                                                             \
    return last ? launch<kC, CP, true>(a, kernel, smem_bytes)               \
                : launch<kC, CP, false>(a, kernel, smem_bytes)
  WN_SHARD_PAIR(kC / 2);
  WN_SHARD_PAIR(kC / 4);
  WN_SHARD_PAIR(kC / 8);
#undef WN_SHARD_PAIR
  return cudaErrorInvalidValue;
}

cudaError_t dispatch(int c, int cp, const Args* a, int last,
                     const void** kernel, int* smem_bytes) {
  switch (c) {
    case 128: return dispatch_width<128>(cp, a, last, kernel, smem_bytes);
    case 256: return dispatch_width<256>(cp, a, last, kernel, smem_bytes);
    case 512: return dispatch_width<512>(cp, a, last, kernel, smem_bytes);
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

// Shapes, f32 throughout: x [batch, T, c]; cond [batch, T, 2*cp]; w_in [3,
// c, 2*cp]; b_in [2*cp]; w_rs [cp, 2c] or [cp, c] (last != 0); out [batch,
// T, 2c] or [batch, T, c]. c must be 128, 256 or 512 and cp one of c/2,
// c/4, c/8 (bf16 is wn_layer.cu's wn_layer_shard_wide_forward). All
// pointers 16-byte aligned and contiguous. Launches on `stream`, does not
// synchronise; returns the launch error.
cudaError_t wn_layer_shard_forward(const float* x, const float* cond,
                                   const float* w_in, const float* b_in,
                                   const float* w_rs, float* out, int batch,
                                   int T, int c, int cp, int dilation,
                                   int last, cudaStream_t stream) {
  if (T <= 0 || batch <= 0 || static_cast<int64_t>(batch) * T > INT32_MAX)
    return cudaErrorInvalidValue;
  const Args a{x, cond, w_in, b_in, w_rs, out, batch, T, dilation, stream};
  return dispatch(c, cp, &a, last, nullptr, nullptr);
}

// What the loaded build of the f32 (c, cp, last) kernel uses, read from
// the CUDA runtime: registers per thread, local (spill) bytes per thread,
// static shared bytes, and the dynamic shared bytes its launcher passes.
cudaError_t wn_layer_shard_kernel_info(int c, int cp, int last,
                                       int* registers, int* local_bytes,
                                       int* static_smem_bytes,
                                       int* dynamic_smem_bytes) {
  const void* kernel = nullptr;
  cudaError_t err = dispatch(c, cp, nullptr, last, &kernel,
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
