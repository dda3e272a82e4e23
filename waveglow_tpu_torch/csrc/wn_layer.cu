// Fused WN layer forward for Hopper (sm_90a), CUDA C++ with a plain C
// interface (bound from Python with ctypes, see kernels/wn_layer.py).
//
// Replaces waveglow_tpu/kernels/wn_layer.py::_wn_layer_fused (the Pallas TPU
// kernel, body _body). It computes the function, not the TPU block
// structure:
//
//   pre  = sum_tap x[t + (tap-1)*d] @ w_in[tap]      (zero "same" padding)
//   g    = pre + b_in + cond                         (f32)
//   acts = tanh(g[:C]) * sigmoid(g[C:])              (f32)
//   rs   = acts @ w_rs + b_rs                        (f32 accumulation)
//   x'   = x + rs[:C], skip = rs[C:]                 (last layer: x' = x, skip = rs)
//   skip_acc += skip in place (when accumulating), x' rows >= valid_t[b] = 0
//
// Built for C in {128, 256, 512} channels (the width is a template
// parameter; the launcher dispatches on it). Global layouts, both modes: x,
// x', skip [B, T, C], cond [B, T, 2C], w_in [3C, 2C], w_rs [C, 2C] (last
// layer [C, C]), all row-major.
//
// x, x', b_in, b_rs and the skip sum are float32 in both modes. cond, w_in and
// w_rs are float32 (parity mode) or bfloat16 (fast mode). In fast mode every
// product operand is bf16 (the taps of x and the gated acts are rounded to
// bf16 when staged) and every product is accumulated in f32; pre, the gate
// and rs stay f32. These are the rounding points of the Pallas body _body.
//
// What bounds it on an H100 SXM (published peaks: 67 TFLOP/s f32 on CUDA
// cores, 989 TFLOP/s bf16 on tensor cores, 3.35 TB/s HBM). A non-last layer at
// B=1, T=26,432 groups, C=256 does 2*T*C*(3*2C + 2C) = 27.7 GFLOP:
//   * f32 is operation-bound: 27.7 GFLOP / 67 TFLOP/s = 0.41 ms;
//   * bf16 is byte-bound: x in, x' out, skip read+write (f32) and cond (bf16)
//     are T*C*(4*4 + 2*2) = 135 MB / 3.35 TB/s = 0.040 ms, against 0.028 ms
//     of tensor-core time.
//
// Two kernels, one per mode.
//
// wn_layer_kernel_f32 (parity mode): true f32 FMAs on the CUDA cores, no
// TF32, so no tensor cores. One wave of blocks of 384 threads (12 warps),
// one block an SM: the B*T rows, taken as one flat [B*T, C] sequence, are
// cut into an equal share a block (a multiple of 16 rows), which the block
// walks in tiles of 48 rows, the last one short. There is no wave tail, and
// a short tile runs only the warps that have rows: one warp on each
// scheduler for each 16 rows, a third of a full tile's time.
//   * Register tile: a thread holds 8 rows x 4 channels of the tanh half and
//     the same 4 channels of the sigmoid half, 64 f32 accumulators, so the
//     gate runs on them. A weight value read from shared memory feeds 8 rows
//     of FMAs; the 16 lanes of a half warp read one 256-byte piece of a
//     weight row, which the other half warp shares, and one tap row.
//   * Ring: the 3C-deep first product and the C-deep second one stream as one
//     sequence of 16-row K chunks (48 of w_in, each with the tile's 48 tap
//     rows of those 16 channels, then 16 of w_rs) through a 4-stage ring
//     filled by cp.async, three chunks ahead of the FMAs, one barrier a
//     chunk. Tap rows outside [0, T) of their own sequence are zero-filled.
//     The ring runs on across tiles, so the next tile's first chunks load
//     during this tile's second product and epilogue.
//   * The acts are staged once a tile in shared memory for the second
//     product; cond's rows, then the residual's x rows and the skip sum, are
//     prefetched into L2 before the gate and the epilogue read them.
//   * Width: the warp grid covers 256 channels of each half (C = 128: 128
//     with 8 warps of 192-thread blocks). At C = 512 each product runs in
//     two passes of 256 channels: the gate's tanh and sigmoid columns of one
//     pass, then the res/skip columns of one pass, each over the whole K;
//     the ring has 3 stages there, so the acts [48][C] still fit.
//
// wn_layer_kernel_mma (fast mode): both products on the tensor cores, as
// wgmma (m64n128k16, bf16 operands from shared memory, f32 accumulators in
// registers). One block of two warpgroups per (batch row, tile of 64 time
// rows), one block per SM (229,376 bytes of shared memory):
//   * Taps: three windows of 64 rows, window k holding x[t0 + r + (k-1)*d]
//     rounded to bf16 (zero outside [0, T)), staged once per tile in wgmma's
//     K-major layout with the 128-byte swizzle; the 3C-deep K runs tap by
//     tap, so each window is done with after a third of the first product.
//   * Weights: w_in then w_rs stream as one sequence of 32-row K chunks (24
//     then 8) through a 4-stage ring filled by cp.async, into wgmma's N-major
//     layout with the 128-byte swizzle (read in their global [K, N] layout,
//     never repacked on the host). Two chunks load ahead; each warpgroup
//     leaves one chunk's wgmmas running across the next step's
//     __syncthreads.
//   * Prefetch into the freed windows, with the weight chunks: cond's tanh and
//     sigmoid halves (bf16) into windows 0 and 1 while the first product is
//     on taps 1 and 2 (each one step after its tap's last chunk, when the
//     ring's barrier proves that chunk's wgmmas done), and the skip sum to
//     add (f32) into windows 0-1 during the second product. The gate and the
//     epilogue then wait on global memory only for the residual's x rows.
//   * Gate on the accumulators: the block holds all 2C pre-activations of its
//     64 rows in registers (128 f32 a thread). Warpgroup w owns tanh columns
//     [128w, 128w+128) and sigmoid columns [C+128w, C+128w+128) as two
//     m64n128 products, so a thread holds the tanh and the sigmoid
//     accumulators of the same channels: cond and b_in are added in f32, the
//     gate is f32, and the acts are rounded to bf16 into window 2 as the
//     second product's A operand.
//   * The res/skip product pairs the same way (warpgroup w: residual columns
//     [128w, 128w+128), skip columns [C+128w, C+128w+128)); the epilogue adds
//     b_rs, the residual and the skip sum in f32, masks rows >= valid_t and
//     writes rows < T only (the ragged last tile).
//   * C = 128 runs the same code with one warpgroup (128 threads).
//   * C = 512 does not fit that layout (the three tap windows alone take
//     192 KB), so it streams the taps: 64-row x 64-channel blocks of one tap,
//     rounded to bf16 into a 3-block ring one block ahead of the wgmmas that
//     read them (ld.global, convert, st.shared while the previous chunk's
//     wgmmas run). Each product runs in two passes of 256 channels (the
//     block's 128 accumulators a thread hold one pass): the first product's
//     gate columns, then the res/skip columns (the last layer: all its C
//     skip columns in one pass). The acts [64][C] stay resident as the
//     second product's A operand; cond and the skip sum are read from global
//     memory by the gate and the epilogue. 221,184 bytes of shared memory.
// No atomics, no split K: the sums run in one fixed order, so two launches
// give the same bits.
//
// Measured on an NVIDIA H100 80GB HBM3 (700 W) by chip_smoke.py, at the
// shape above (d=1): the f32 kernel 0.75 ms against the 0.41 ms bound (55%;
// 1.01 ms for the 32-row design it replaced, in the same run), with 167
// registers, 193,280 bytes of shared memory and no spills; the bf16 kernel
// 0.17 ms against the 0.041 ms bound (24%). PERF.md keeps the times;
// wn_layer_kernel_info reports the registers, spills and shared memory of
// the loaded build.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

#include "f32_ring.cuh"

namespace {

// ---- the f32 kernel ------------------------------------------------------

constexpr int kRowPairs = 3;                   // warps down the tile's rows
constexpr int kTileRows = 16 * kRowPairs;      // 48 time rows per tile
constexpr int kRowsPerThread = 8;              // rows 2i + lane / 16 of a 16
constexpr int kPerLane = 4;                    // channels of each gate half
constexpr int kChunk = 16;                     // K rows per ring stage
// A block's rows are a multiple of this: a tile of 16 rows runs one warp on
// each scheduler and costs a third of a full tile.
constexpr int kRowQuantum = 16;
constexpr int kTapFloats = kTileRows * kChunk;  // 768

// The f32 kernel's layout at width kC. A pass covers kPC channels of each
// half (the warp grid's width); C = 512 takes two passes of each product.
// Ring slot: the chunk's taps [kTileRows][kChunk], then its weight rows
// [kChunk][2 kPC] (the last layer's w_rs: [kChunk][kPC]); acts
// [kTileRows][kActsStride]; f32.
template <int kC>
struct F32 {
  static constexpr int kPC = kC < 256 ? kC : 256;  // channels of a pass
  static constexpr int kPasses = kC / kPC;
  static constexpr int kColWarps = kPC / 64;       // warps across a pass
  static constexpr int kThreads = 32 * kColWarps * kRowPairs;  // 192 / 384
  static constexpr int kStages = kC > 256 ? 3 : 4;  // ring depth
  static constexpr int kAhead = kStages - 1;  // chunks in flight under the FMAs
  static constexpr int kInPerPass = 3 * kC / kChunk;  // w_in and the taps
  static constexpr int kRsPerPass = kC / kChunk;      // w_rs
  static constexpr int kInChunks = kPasses * kInPerPass;
  static constexpr int kChunks = kInChunks + kPasses * kRsPerPass;  // a tile
  static constexpr int kChunksPerTap = kC / kChunk;
  static constexpr int kActsStride = kC + 4;  // padded: rows 4 banks apart
  static constexpr int kSlotFloats = kTapFloats + kChunk * 2 * kPC;
  static constexpr int kSmemBytes =
      sizeof(float) * (kStages * kSlotFloats + kTileRows * kActsStride);
  static_assert(kSmemBytes <= 232448, "over the 227 KB a block may use");
  static_assert(kTileRows * kChunk / 4 <= kThreads, "one tap piece a thread");
  static_assert(kPC == kColWarps * 16 * kPerLane, "16 lanes a channel quarter");
};

// Start the cp.async copies of chunk `chunk` of the block's sequence into its
// ring slot. Each tile of the block's rows takes kChunks chunks: per pass p
// of the first product, kInPerPass of w_in (16 K rows each, the pass's tanh
// and sigmoid columns) with the matching taps; then per pass of the second,
// kRsPerPass of w_rs (its residual and skip columns; the last layer's
// columns of the pass). Taps are rows of the flat [B*T, C] x: tile row r is
// flat row R = b*T + t, and its tap reads row t + (tap-1)*d of the same
// sequence, zero outside [0, T) and past the block's last row.
template <int kC, bool kLast>
__device__ __forceinline__ void f32_load_chunk(
    uint32_t ring, int chunk, int row_begin, int row_end, const float* x,
    const float* w_in, const float* w_rs, int T, int dilation) {
  using L = F32<kC>;
  constexpr int kPC = L::kPC;
  constexpr int N_RS = kLast ? kC : 2 * kC;
  const int tile = chunk / L::kChunks;
  const int local = chunk % L::kChunks;
  const uint32_t slot = ring + (chunk % L::kStages) * L::kSlotFloats * 4;
  const uint32_t wslot = slot + kTapFloats * 4;
  if (local >= L::kInChunks) {
    const int j = local - L::kInChunks;
    const int pass = j / L::kRsPerPass;
    const float* src = w_rs + static_cast<int64_t>(j % L::kRsPerPass) * kChunk * N_RS;
    if constexpr (kLast)
      copy_rows<kChunk, L::kThreads, kPC, kPC>(wslot, src, N_RS, pass * kPC,
                                               0);
    else
      copy_rows<kChunk, L::kThreads, 2 * kPC, kPC>(wslot, src, N_RS,
                                                   pass * kPC, kC + pass * kPC);
    return;
  }
  const int pass = local / L::kInPerPass;
  const int kc = local % L::kInPerPass;
  const int r = threadIdx.x / (kChunk / 4);  // tap row, 16-byte piece q
  const int q = threadIdx.x % (kChunk / 4);
  if (r < kTileRows) {
    const int row = row_begin + tile * kTileRows + r;
    const float* src = x;
    bool valid = false;
    if (row < row_end) {
      const int b = static_cast<unsigned>(row) / static_cast<unsigned>(T);
      const int t = row - b * T + (kc / L::kChunksPerTap - 1) * dilation;
      if (t >= 0 && t < T) {
        valid = true;
        src = x + (static_cast<int64_t>(b) * T + t) * kC +
              (kc % L::kChunksPerTap) * kChunk + q * 4;
      }
    }
    cp_async16_zfill(slot + (r * kChunk + q * 4) * 4, src, valid);
  }
  copy_rows<kChunk, L::kThreads, 2 * kPC, kPC>(
      wslot, w_in + static_cast<int64_t>(kc) * kChunk * 2 * kC, 2 * kC,
      pass * kPC, kC + pass * kPC);
}

// One ring slot's kChunk k: acc_a[i][j] += a[row 2i][k] * w[k][j], and when
// kPaired acc_b[i][j] += a[row 2i][k] * w[k][kBOff + j]. `a` points at the
// thread's first row (rows 2 * kStride floats apart), `w` at its first
// column (rows kN floats apart). The row operand loads 4 k at a time.
template <bool kPaired, int kStride, int kN, int kBOff>
__device__ __forceinline__ void f32_chunk_fma(
    float (&acc_a)[kRowsPerThread][kPerLane],
    float (&acc_b)[kRowsPerThread][kPerLane], const float* a,
    const float* w) {
#pragma unroll
  for (int kk = 0; kk < kChunk; kk += 4)
    tile_fma4<kRowsPerThread, 2, kStride, kN, kBOff, kPaired>(acc_a, acc_b, a,
                                                              w, kk);
}

// kLast selects the [C, C] res/skip of the last layer. Block i takes flat
// rows [i * rows_per_block, (i + 1) * rows_per_block) of the B*T rows, in
// tiles of kTileRows (the last one short).
template <int kC, bool kLast>
__global__ void __launch_bounds__(F32<kC>::kThreads, 1)
wn_layer_kernel_f32(const float* __restrict__ x, const float* __restrict__ cond,
                    const float* __restrict__ w_in,
                    const float* __restrict__ b_in,
                    const float* __restrict__ w_rs,
                    const float* __restrict__ b_rs,
                    const int* __restrict__ valid_t, float* __restrict__ x_out,
                    float* skip_out, int accumulate, int T, int dilation,
                    int rows, int rows_per_block) {
  using L = F32<kC>;
  constexpr int C = kC;
  constexpr int kPC = L::kPC;
  constexpr int N_IN = 2 * C;                 // gate pre-activations
  constexpr int N_RS = kLast ? C : 2 * C;     // res/skip outputs
  constexpr int kThreads = L::kThreads;

  const int row_begin = blockIdx.x * rows_per_block;
  const int row_end = min(rows, row_begin + rows_per_block);
  if (row_begin >= row_end) return;
  const int n_chunks =
      (row_end - row_begin + kTileRows - 1) / kTileRows * L::kChunks;

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const uint32_t ring = smem_u32(smem);
  float* acts = smem + L::kStages * L::kSlotFloats;  // [kTileRows][kActsStride]

  // Warp w: rows [16 (w/kColWarps), +16) of the tile and channels
  // [64 (w%kColWarps), +64) of each gate half of a pass; lane l: rows
  // 16 (w/kColWarps) + 2i + l/16 and channels c0..c0+3, c0 = 64 (w%kColWarps)
  // + 4 (l%16). The 16 lanes of a half warp read one 256-byte piece of a
  // weight row (the other half reads the same bytes), and all of them the
  // same tap row.
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int pair = warp / L::kColWarps;
  const int r0 = 16 * pair + lane / 16;                  // first tile row
  const int c0 = 64 * (warp % L::kColWarps) + 4 * (lane % 16);

  const auto load_chunk = [&](int chunk) {
    f32_load_chunk<kC, kLast>(ring, chunk, row_begin, row_end, x, w_in, w_rs,
                              T, dilation);
  };
  ring_prologue<L::kAhead>(n_chunks, load_chunk);

  float acc_a[kRowsPerThread][kPerLane];  // tanh, then residual (last: skip)
  float acc_b[kRowsPerThread][kPerLane];  // sigmoid, then skip
  for (int chunk0 = 0; chunk0 < n_chunks; chunk0 += L::kChunks) {
    const int t0 = row_begin + chunk0 / L::kChunks * kTileRows;  // flat row
    const int tile_rows = min(kTileRows, row_end - t0);
    // the warps of a pair of 16 rows all past the block's end do no FMAs
    const bool busy = 16 * pair < tile_rows;

    // ---- first product: pre[rows, 2C] = taps[rows, 3C] @ w_in[3C, 2C] -----
    // pass p: the tanh and sigmoid columns of channels [p kPC, p kPC + kPC)
    // (unrolled: the pass's column offsets are constants, which keeps the
    // last-layer variant at C = 512 inside the 168 registers a thread has)
#pragma unroll
    for (int p = 0; p < L::kPasses; ++p) {
      const int ch = p * kPC + c0;  // this thread's channels of the pass
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) acc_a[i][j] = acc_b[i][j] = 0.f;
#pragma unroll 1
      for (int kc = 0; kc < L::kInPerPass; ++kc) {
        const int local = p * L::kInPerPass + kc;
        ring_step<L::kAhead>(chunk0 + local, n_chunks, load_chunk);
        if (kc == L::kInPerPass - 16) {
          // cond's rows of the tile into L2, for the gate
          const float* src = cond + static_cast<int64_t>(t0) * N_IN;
          for (int q = threadIdx.x; q < tile_rows * N_IN / 32; q += kThreads)
            prefetch_l2(src + q * 32);
        }
        if (busy) {
          const float* slot =
              smem + ((chunk0 + local) % L::kStages) * L::kSlotFloats;
          f32_chunk_fma<true, kChunk, 2 * kPC, kPC>(
              acc_a, acc_b, slot + r0 * kChunk, slot + kTapFloats + c0);
        }
      }

      // ---- gate (f32) on the accumulators, acts to shared memory ---------
      // the previous tile's acts were last read before this tile's barriers
      if (busy) {
        float bt[kPerLane], bs[kPerLane];
        load4(bt, b_in + ch);
        load4(bs, b_in + C + ch);
#pragma unroll
        for (int i0 = 0; i0 < kRowsPerThread; i0 += 2) {
          float ct[2][kPerLane], cs[2][kPerLane];  // 2 rows' loads in flight
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r0 + 2 * (i0 + h);
            if (r < tile_rows) {
              const float* crow = cond + static_cast<int64_t>(t0 + r) * N_IN;
              load4(ct[h], crow + ch);
              load4(cs[h], crow + C + ch);
            } else {
#pragma unroll
              for (int j = 0; j < kPerLane; ++j) ct[h][j] = cs[h][j] = 0.f;
            }
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float out[kPerLane];
#pragma unroll
            for (int j = 0; j < kPerLane; ++j) {
              const float gt = acc_a[i0 + h][j] + bt[j] + ct[h][j];
              const float gs = acc_b[i0 + h][j] + bs[j] + cs[h][j];
              out[j] = tanhf(gt) * (1.f / (1.f + expf(-gs)));
            }
            store4(acts + (r0 + 2 * (i0 + h)) * L::kActsStride + ch, out);
          }
        }
      }
    }

    // ---- second product: rs[rows, N_RS] = acts[rows, C] @ w_rs[C, N_RS] --
    // pass p: residual and skip columns [p kPC, p kPC + kPC) (the last
    // layer: skip columns)
#pragma unroll
    for (int p = 0; p < L::kPasses; ++p) {
      const int ch = p * kPC + c0;
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) acc_a[i][j] = acc_b[i][j] = 0.f;
#pragma unroll 1
      for (int kc = 0; kc < L::kRsPerPass; ++kc) {
        const int local = L::kInChunks + p * L::kRsPerPass + kc;
        // the first step's barrier also orders the acts writes before the
        // reads
        ring_step<L::kAhead>(chunk0 + local, n_chunks, load_chunk);
        if (kc == L::kRsPerPass - 8) {
          // the residual's x rows and the skip sum into L2, for the epilogue
          const int64_t off = static_cast<int64_t>(t0) * C;
          for (int q = threadIdx.x; q < tile_rows * C / 32; q += kThreads) {
            prefetch_l2(x + off + q * 32);
            if (accumulate) prefetch_l2(skip_out + off + q * 32);
          }
        }
        if (busy) {
          const float* slot =
              smem + ((chunk0 + local) % L::kStages) * L::kSlotFloats;
          f32_chunk_fma<!kLast, L::kActsStride, kLast ? kPC : 2 * kPC, kPC>(
              acc_a, acc_b, acts + r0 * L::kActsStride + kc * kChunk,
              slot + kTapFloats + c0);
        }
      }

      // ---- epilogue: residual, valid_t mask, skip accumulation -----------
      if (busy) {
        float br[kPerLane], bk[kPerLane];
        load4(br, b_rs + ch);
        if constexpr (!kLast) load4(bk, b_rs + C + ch);
#pragma unroll
        for (int i0 = 0; i0 < kRowsPerThread; i0 += 2) {
          float xv[2][kPerLane], prev[2][kPerLane];  // 2 rows' loads in flight
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r0 + 2 * (i0 + h);
            if (r >= tile_rows) continue;
            const int64_t off = static_cast<int64_t>(t0 + r) * C + ch;
            load4(xv[h], x + off);
            if (accumulate) load4(prev[h], skip_out + off);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = i0 + h;
            const int r = r0 + 2 * i;
            if (r >= tile_rows) continue;
            const int row = t0 + r;
            const int b = static_cast<unsigned>(row) / static_cast<unsigned>(T);
            const int valid = valid_t != nullptr ? valid_t[b] : T;
            const bool keep = row - b * T < valid;
            float skip[kPerLane];
#pragma unroll
            for (int j = 0; j < kPerLane; ++j) {
              if constexpr (kLast) {
                skip[j] = acc_a[i][j] + br[j];
              } else {
                xv[h][j] += acc_a[i][j] + br[j];
                skip[j] = acc_b[i][j] + bk[j];
              }
              if (!keep) xv[h][j] = 0.f;
              if (accumulate) skip[j] += prev[h][j];
            }
            const int64_t off = static_cast<int64_t>(row) * C + ch;
            store4(x_out + off, xv[h]);
            store4(skip_out + off, skip);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

// ---- the bf16 tensor-core kernel ------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kMmaRows = 64;                 // time rows per block
constexpr int kGroupCols = 128;              // columns of each half a warpgroup owns
constexpr int kAcc = kGroupCols / 2;         // 64 f32 a thread per m64n128 product
constexpr int kKChunk = 32;                  // K rows per weight stage (two k16 steps)
constexpr int kStages = 4;                   // weight ring depth
constexpr int kAhead = kStages - 2;          // chunks in flight under the mma
// Windows: [64 rows][C] bf16 in wgmma's K-major layout with the 128-byte
// swizzle (see tile_off); 64-channel blocks of kKBlockBytes.
constexpr int kKBlockBytes = kMmaRows * 128;                      // 8,192
// Ring slot: the chunk's 32 K rows in wgmma's N-major layout with the
// 128-byte swizzle: column block n (64 columns) at n * kBlockBytes, K row r
// at r * 128 within it, 16-byte piece q of that row at (q ^ (r % 8)) * 16.
constexpr int kBlockBytes = kKChunk * 128;                        // 4,096

// The layout at width kC with all three tap windows resident (C <= 256):
// one warpgroup per 128 channels of each half.
template <int kC>
struct Mma {
  static constexpr int kThreads = kC;                  // C / 128 warpgroups
  static constexpr int kInChunks = 3 * kC / kKChunk;   // 24 at C = 256: w_in
  static constexpr int kRsChunks = kC / kKChunk;       // 8: w_rs
  static constexpr int kChunksPerTap = kC / kKChunk;
  static constexpr int kWindowBytes = kC / 64 * kKBlockBytes;     // 32,768
  static constexpr int kTapBytes = 3 * kWindowBytes;              // 98,304
  static constexpr int kStageBytes = 2 * kC / 64 * kBlockBytes;   // 32,768
  static constexpr int kSmemBytes = kTapBytes + kStages * kStageBytes;  // 229,376
  static_assert(kSmemBytes <= 232448, "over the 227 KB a block may use");
  static_assert(kTapBytes % 1024 == 0, "swizzled slots need 1024-byte alignment");
  static_assert(kMmaRows * kC * 4 <= 2 * kWindowBytes,
                "the skip sum fits windows 0 and 1");
};

// The layout at C = 512, taps streamed: two warpgroups, passes of 256
// channels; a ring of kABlocks tap blocks [64 rows][64 channels], the
// weight ring, and the acts window [64 rows][C].
struct MmaWide {
  static constexpr int kC = 512;
  static constexpr int kThreads = 256;
  static constexpr int kPassC = 256;                       // channels a pass
  static constexpr int kPasses = kC / kPassC;
  static constexpr int kInPerPass = 3 * kC / kKChunk;      // 48
  static constexpr int kInChunks = kPasses * kInPerPass;   // 96
  static constexpr int kRsPerPass = kC / kKChunk;          // 16
  static constexpr int kChunksPerTap = kC / kKChunk;       // 16
  static constexpr int kABlocks = 3;                       // tap block ring
  static constexpr int kTapBlocks = kPasses * 3 * kC / 64;  // 48 a tile
  static constexpr int kARingBytes = kABlocks * kKBlockBytes;      // 24,576
  static constexpr int kStageBytes = 2 * kPassC / 64 * kBlockBytes;  // 32,768
  static constexpr int kActsBytes = kC / 64 * kKBlockBytes;        // 65,536
  static constexpr int kSmemBytes =
      kARingBytes + kStages * kStageBytes + kActsBytes;            // 221,184
  static_assert(kSmemBytes <= 232448, "over the 227 KB a block may use");
  static_assert(kARingBytes % 1024 == 0, "swizzled slots need 1024-byte alignment");
};

template <int kC>
constexpr int mma_threads() {
  if constexpr (kC <= 256) return Mma<kC>::kThreads;
  else return MmaWide::kThreads;
}

template <int kC>
constexpr int mma_smem_bytes() {
  if constexpr (kC <= 256) return Mma<kC>::kSmemBytes;
  else return MmaWide::kSmemBytes;
}

// Byte offset of (row, ch) in a window: K-major with the 128-byte swizzle,
// so channel block ch / 64 at (ch / 64) * kKBlockBytes, rows 128 bytes
// apart in it, and 16-byte piece p of a row at p ^ (row % 8). The 8 rows
// that one access pattern reads land in 8 different bank quads.
__device__ __forceinline__ int tile_off(int row, int ch) {
  return (ch / 64) * kKBlockBytes + row * 128 +
         ((((ch % 64) / 8) ^ (row % 8)) * 16) + (ch % 8) * 2;
}

// Byte offset of (row, ch) in the f32 skip sum held in windows 0-1: rows of
// 4C bytes, 16-byte piece p of a row at p ^ (row % 8).
template <int kC>
__device__ __forceinline__ int skip_off(int row, int ch) {
  return row * kC * 4 + (((ch / 4) ^ (row % 8)) * 16) + (ch % 4) * 4;
}

// Makes this thread's generic-proxy writes to shared memory (stores,
// cp.async) visible to the async proxy, where wgmma reads its operands.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma ordering: the fence before the first wgmma on freshly written
// accumulators, the commit of the wgmmas started so far as one group, and the
// wait until at most kPending groups are in flight.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Pins the accumulators at this point of the program: the compiler may not
// move their reads above a wait, nor copy them between wgmmas.
__device__ __forceinline__ void fence_acc(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Descriptor of A: 64 rows x 16 K of a window from `addr` (K-major, 128-byte
// swizzle, groups of 8 rows 1024 bytes apart; the leading offset is unused
// when K fits one swizzle row).
__device__ __forceinline__ uint64_t a_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// Descriptor of B: 16 K x 128 columns of a ring slot from `addr` (N-major,
// 128-byte swizzle, column blocks kBlockBytes apart, groups of 8 K rows
// 1024 bytes apart).
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(kBlockBytes >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d += A @ B, one m64n128k16 product of the warpgroup on the tensor cores,
// both operands from shared memory (A K-major, B N-major); bf16 operands,
// f32 accumulators.
__device__ __forceinline__ void wgmma_n128(float (&d)[kAcc], uint64_t desc_a,
                                           uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo at the lower address
  return *reinterpret_cast<uint32_t*>(&v);
}

// cp.async the kKChunk rows of a bf16 weight (rows `ld` elements apart from
// `src`) into `slot`, in the ring layout above: kN columns, the first kHalf
// of them from column `a` of the source row, the rest from column `b`.
template <int kThreads, int kN, int kHalf>
__device__ __forceinline__ void copy_chunk(uint32_t slot, const bf16* src,
                                           int ld, int a, int b) {
  constexpr int kPerRow = kN / 8;  // 16-byte pieces
  static_assert(kKChunk * kPerRow % kThreads == 0, "whole rounds");
#pragma unroll
  for (int i = 0; i < kKChunk * kPerRow / kThreads; ++i) {
    const int p = threadIdx.x + i * kThreads;
    const int r = p / kPerRow, q = p % kPerRow;
    const int col = q * 8 < kHalf ? a + q * 8 : b + q * 8 - kHalf;
    cp_async16(slot + (q / 8) * kBlockBytes + r * 128 + ((q % 8) ^ (r % 8)) * 16,
               src + r * ld + col);
  }
}

// Start the cp.async copies of K chunk `chunk` of the weight sequence (w_in
// rows for chunk < kInChunks, then w_rs rows) into its ring slot.
template <int kC, bool kLast>
__device__ __forceinline__ void load_chunk(uint32_t ring, int chunk,
                                            const bf16* w_in,
                                            const bf16* w_rs) {
  using L = Mma<kC>;
  constexpr int N_RS = kLast ? kC : 2 * kC;
  const uint32_t slot = ring + (chunk % kStages) * L::kStageBytes;
  if (chunk < L::kInChunks)
    copy_chunk<L::kThreads, 2 * kC, 2 * kC>(slot, w_in + chunk * kKChunk * 2 * kC,
                                            2 * kC, 0, 0);
  else
    copy_chunk<L::kThreads, N_RS, N_RS>(
        slot, w_rs + (chunk - L::kInChunks) * kKChunk * N_RS, N_RS, 0, 0);
}

// cp.async the tile's first `rows` rows of cond's half `half` (C bf16 from
// rows 2C apart) into a window, in the window layout.
template <int kC>
__device__ __forceinline__ void copy_cond_half(uint32_t window,
                                               const bf16* cond_rows, int half,
                                               int rows) {
  constexpr int kPerRow = kC / 8;
  constexpr int kThreads = Mma<kC>::kThreads;
#pragma unroll
  for (int i = 0; i < kMmaRows * kPerRow / kThreads; ++i) {
    const int p = threadIdx.x + i * kThreads;
    const int r = p / kPerRow, q = p % kPerRow;
    if (r < rows)
      cp_async16(window + tile_off(r, q * 8),
                 cond_rows + static_cast<int64_t>(r) * 2 * kC + half * kC + q * 8);
  }
}

// cp.async the tile's first `rows` rows of the skip sum (f32) into windows
// 0-1, in the skip_off layout.
template <int kC>
__device__ __forceinline__ void copy_skip(uint32_t dst, const float* skip_rows,
                                          int rows) {
  constexpr int kPerRow = kC / 4;
  constexpr int kThreads = Mma<kC>::kThreads;
#pragma unroll
  for (int i = 0; i < kMmaRows * kPerRow / kThreads; ++i) {
    const int p = threadIdx.x + i * kThreads;
    const int r = p / kPerRow, q = p % kPerRow;
    if (r < rows)
      cp_async16(dst + skip_off<kC>(r, q * 4),
                 skip_rows + static_cast<int64_t>(r) * kC + q * 4);
  }
}

// One step of the weight ring, at chunk `chunk`: wait for this thread's
// copies of it, hand its shared-memory writes to the async proxy, and make
// them block-wide. Each warpgroup leaves at most the wgmmas of one chunk in
// flight at the end of a step, so past this barrier those of chunk - 2 are
// done and its slot is free: start chunk + kAhead there. One commit group
// per step (empty past the last chunk), so the wait count stays kAhead - 1.
template <int kC, bool kLast>
__device__ __forceinline__ void ring_step(uint32_t ring, int chunk,
                                          const bf16* w_in, const bf16* w_rs) {
  using L = Mma<kC>;
  cp_async_wait<kAhead - 1>();
  fence_proxy_async();
  __syncthreads();
  if (chunk + kAhead < L::kInChunks + L::kRsChunks)
    load_chunk<kC, kLast>(ring, chunk + kAhead, w_in, w_rs);
}

// The kernel at C <= 256: three tap windows resident.
template <int kC, bool kLast>
__device__ __forceinline__ void mma_resident(
    const float* __restrict__ x, const bf16* __restrict__ cond,
    const bf16* __restrict__ w_in, const float* __restrict__ b_in,
    const bf16* __restrict__ w_rs, const float* __restrict__ b_rs,
    const int* __restrict__ valid_t, float* __restrict__ x_out,
    float* skip_out, int accumulate, int T, int dilation) {
  using L = Mma<kC>;
  constexpr int C = kC;
  constexpr int kThreads = L::kThreads;
  constexpr int kInChunks = L::kInChunks;
  constexpr int kChunksPerTap = L::kChunksPerTap;
  constexpr int kWindowBytes = L::kWindowBytes;
  constexpr int kStageBytes = L::kStageBytes;
  constexpr int kChunks = L::kInChunks + L::kRsChunks;
  extern __shared__ __align__(1024) uint4 smem_mma[];
  // Three windows of [kMmaRows][C] bf16, one per tap of x. Each is reused
  // once the first product is past it: window 0 takes cond's tanh half,
  // window 1 its sigmoid half, window 2 the acts; during the second product
  // windows 0-1 take the skip sum to add (f32).
  char* win = reinterpret_cast<char*>(smem_mma);
  const uint32_t win_s = smem_u32(win);
  const uint32_t ring_s = win_s + L::kTapBytes;  // kStages slots
  char* acts = win + 2 * kWindowBytes;

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kMmaRows;
  const int rows = min(kMmaRows, T - t0);         // rows < T in this tile
  const int64_t row0 = static_cast<int64_t>(b) * T + t0;  // first global row
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wg = warp / 4;           // warpgroup: its column block of each half
  const int r16 = (warp % 4) * 16;   // the warp's 16 rows of the accumulators
  const int g = lane / 4;    // accumulator rows r16 + g and r16 + g + 8
  const int tig = lane % 4;  // accumulator columns 2*tig, 2*tig + 1 of an n8
  const int col0 = wg * kGroupCols;  // the warpgroup's first column of each half

  // ---- prologue: the first weight chunks load while the taps are staged ---
  for (int c = 0; c < kAhead; ++c) {
    load_chunk<kC, kLast>(ring_s, c, w_in, w_rs);
    cp_async_commit();
  }
  {
    // window k, row r <- x[t0 + r + (k-1)*d], rounded to bf16; zero outside
    // [0, T)
    constexpr int kQ = C / 4;   // float4 per row
    constexpr int kUnroll = 8;  // loads in flight per thread
    constexpr int kTotal = 3 * kMmaRows * kQ;
    static_assert(kTotal % (kUnroll * kThreads) == 0, "whole rounds");
    const float* xb = x + static_cast<int64_t>(b) * T * C;
#pragma unroll 1
    for (int p0 = threadIdx.x; p0 < kTotal; p0 += kUnroll * kThreads) {
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int p = p0 + u * kThreads;
        const int i = p / kQ;
        const int t = t0 + i % kMmaRows + (i / kMmaRows - 1) * dilation;
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (t >= 0 && t < T)
          v[u] = *reinterpret_cast<const float4*>(
              xb + static_cast<int64_t>(t) * C + (p % kQ) * 4);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int p = p0 + u * kThreads;
        const int i = p / kQ;
        *reinterpret_cast<uint2*>(win + (i / kMmaRows) * kWindowBytes +
                                  tile_off(i % kMmaRows, (p % kQ) * 4)) =
            make_uint2(pack_bf16(v[u].x, v[u].y), pack_bf16(v[u].z, v[u].w));
      }
    }
  }

  // ---- first product: pre[64, 2C] = taps[64, 3C] @ w_in[3C, 2C] -----------
  // The warpgroup's tanh columns [col0, col0+128) accumulate in acc_a, its
  // sigmoid columns [C+col0, C+col0+128) in acc_b: element 4j + 2h + e of
  // either is row r16 + g + 8h, column 8j + 2 tig + e of the block, so a
  // thread holds both halves of the same channels.
  float acc_a[kAcc], acc_b[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc_a[i] = acc_b[i] = 0.f;

  const bf16* cond_rows = cond + row0 * 2 * C;
  const uint32_t b_a = (col0 / 64) * kBlockBytes;        // tanh / residual
  const uint32_t b_b = ((C + col0) / 64) * kBlockBytes;  // sigmoid / skip
#pragma unroll 1
  for (int chunk = 0; chunk < kInChunks; ++chunk) {
    ring_step<kC, kLast>(ring_s, chunk, w_in, w_rs);
    // window `half` is free once tap `half`'s wgmmas are done: its last
    // chunk, (half + 1) * kChunksPerTap - 1, may still run past the next
    // step's barrier and is known done past the one after it (chunk - 2),
    // so cond's half goes there one step after the tap ends
    for (int half = 0; half < 2; ++half)
      if (chunk == (half + 1) * kChunksPerTap + 1)
        copy_cond_half<kC>(win_s + half * kWindowBytes, cond_rows, half, rows);
    cp_async_commit();
    const int tap = chunk / kChunksPerTap;
    const int ci0 = (chunk % kChunksPerTap) * kKChunk;
    const uint32_t a0 = win_s + tap * kWindowBytes + (ci0 / 64) * kKBlockBytes +
                        (ci0 % 64) * 2;
    const uint32_t slot = ring_s + (chunk % kStages) * kStageBytes;
    fence_acc(acc_a);
    fence_acc(acc_b);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kKChunk / 16; ++k) {  // k16 steps: 32 bytes of A, 16 B rows
      const uint64_t da = a_desc(a0 + k * 32);
      wgmma_n128(acc_a, da, b_desc(slot + b_a + k * 16 * 128));
      wgmma_n128(acc_b, da, b_desc(slot + b_b + k * 16 * 128));
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(acc_a);
    fence_acc(acc_b);
  }
  wgmma_wait<0>();
  fence_acc(acc_a);
  fence_acc(acc_b);

  // ---- gate on the accumulators (f32), acts to window 2 as bf16 -----------
  // cond arrived in windows 0-1 with the weight chunks of the first product
  // (rows >= T hold stale values; their acts feed rows that are not stored)
  __syncthreads();  // every wgmma is done with window 2's taps
#pragma unroll
  for (int j = 0; j < kAcc / 4; ++j) {
    const int ch = col0 + 8 * j + 2 * tig;
    const float2 bt = *reinterpret_cast<const float2*>(b_in + ch);
    const float2 bs = *reinterpret_cast<const float2*>(b_in + C + ch);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r16 + g + 8 * h;
      const int off = tile_off(row, ch);
      const float2 ct = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(win + off));
      const float2 cs = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(win + kWindowBytes + off));
      const float gt0 = acc_a[4 * j + 2 * h] + bt.x + ct.x;
      const float gt1 = acc_a[4 * j + 2 * h + 1] + bt.y + ct.y;
      const float gs0 = acc_b[4 * j + 2 * h] + bs.x + cs.x;
      const float gs1 = acc_b[4 * j + 2 * h + 1] + bs.y + cs.y;
      const float v0 = tanhf(gt0) * (1.f / (1.f + expf(-gs0)));
      const float v1 = tanhf(gt1) * (1.f / (1.f + expf(-gs1)));
      *reinterpret_cast<uint32_t*>(acts + off) = pack_bf16(v0, v1);
    }
  }

  // ---- second product: rs[64, N_RS] = acts[64, C] @ w_rs[C, N_RS] ---------
  // acc_a: the residual (last layer: skip) columns [col0, col0+128); acc_b:
  // the skip columns [C+col0, C+col0+128), paired as in the first product
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc_a[i] = acc_b[i] = 0.f;

#pragma unroll 1
  for (int chunk = kInChunks; chunk < kChunks; ++chunk) {
    // also hands the acts to the async proxy and orders them
    ring_step<kC, kLast>(ring_s, chunk, w_in, w_rs);
    if (chunk == kInChunks && accumulate)
      copy_skip<kC>(win_s, skip_out + row0 * C, rows);
    cp_async_commit();
    const int k0 = (chunk - kInChunks) * kKChunk;
    const uint32_t a0 = win_s + 2 * kWindowBytes + (k0 / 64) * kKBlockBytes +
                        (k0 % 64) * 2;
    const uint32_t slot = ring_s + (chunk % kStages) * kStageBytes;
    fence_acc(acc_a);
    fence_acc(acc_b);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kKChunk / 16; ++k) {
      const uint64_t da = a_desc(a0 + k * 32);
      wgmma_n128(acc_a, da, b_desc(slot + b_a + k * 16 * 128));
      if constexpr (!kLast) wgmma_n128(acc_b, da, b_desc(slot + b_b + k * 16 * 128));
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(acc_a);
    fence_acc(acc_b);
  }
  wgmma_wait<0>();
  fence_acc(acc_a);
  fence_acc(acc_b);
  cp_async_wait<0>();
  __syncthreads();  // the skip sum is in windows 0-1 for every thread

  // ---- epilogue: residual, valid_t mask, skip accumulation (f32) ----------
  // The x rows of kBatch n8 blocks are loaded before any is used (one wait on
  // global memory per batch); the skip sum to add is in windows 0-1.
  const int valid = valid_t != nullptr ? valid_t[b] : T;
  constexpr int kBatch = 4;
#pragma unroll
  for (int j0 = 0; j0 < kAcc / 4; j0 += kBatch) {
    float2 xv[kBatch][2];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r16 + g + 8 * h;
        xv[j][h] = make_float2(0.f, 0.f);
        if (row < rows)
          xv[j][h] = *reinterpret_cast<const float2*>(
              x + (row0 + row) * C + col0 + 8 * (j0 + j) + 2 * tig);
      }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = 4 * (j0 + j);  // the n8 block's first accumulator
      const int ch = col0 + 8 * (j0 + j) + 2 * tig;
      const float2 br = *reinterpret_cast<const float2*>(b_rs + ch);
      float2 bk = make_float2(0.f, 0.f);
      if constexpr (!kLast) bk = *reinterpret_cast<const float2*>(b_rs + C + ch);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r16 + g + 8 * h;
        if (row >= rows) continue;
        const int64_t off = (row0 + row) * C + ch;
        float2 xo = xv[j][h];
        float2 skip;
        if constexpr (kLast) {
          skip = make_float2(acc_a[i + 2 * h] + br.x, acc_a[i + 2 * h + 1] + br.y);
        } else {
          xo.x += acc_a[i + 2 * h] + br.x;
          xo.y += acc_a[i + 2 * h + 1] + br.y;
          skip = make_float2(acc_b[i + 2 * h] + bk.x, acc_b[i + 2 * h + 1] + bk.y);
        }
        if (t0 + row >= valid) xo = make_float2(0.f, 0.f);
        *reinterpret_cast<float2*>(x_out + off) = xo;
        if (accumulate) {
          const float2 prev =
              *reinterpret_cast<const float2*>(win + skip_off<kC>(row, ch));
          skip.x += prev.x;
          skip.y += prev.y;
        }
        *reinterpret_cast<float2*>(skip_out + off) = skip;
      }
    }
  }
}

// ---- C = 512: the taps streamed ---------------------------------------------

// Start the cp.async copies of chunk `chunk` of the wide kernel's weight
// sequence into its ring slot: per pass p of the first product, w_in rows
// [32 kc, 32 kc + 32) (kc = chunk % kInPerPass) at the pass's tanh columns
// [256p, +256) then its sigmoid columns [C + 256p, +256); then per pass of
// the second, w_rs rows at the pass's residual and skip columns (the last
// layer: one pass, its skip columns [0, 256) then [256, 512)).
template <bool kLast>
__device__ __forceinline__ void wide_load_chunk(uint32_t ring, int chunk,
                                                const bf16* w_in,
                                                const bf16* w_rs) {
  using L = MmaWide;
  constexpr int C = L::kC;
  constexpr int N_RS = kLast ? C : 2 * C;
  const uint32_t slot = ring + (chunk % kStages) * L::kStageBytes;
  if (chunk < L::kInChunks) {
    const int p = chunk / L::kInPerPass, kc = chunk % L::kInPerPass;
    copy_chunk<L::kThreads, 2 * L::kPassC, L::kPassC>(
        slot, w_in + kc * kKChunk * 2 * C, 2 * C, p * L::kPassC,
        C + p * L::kPassC);
  } else {
    const int j = chunk - L::kInChunks;
    const int p = j / L::kRsPerPass, kc = j % L::kRsPerPass;
    copy_chunk<L::kThreads, 2 * L::kPassC, L::kPassC>(
        slot, w_rs + kc * kKChunk * N_RS, N_RS, p * L::kPassC,
        kLast ? L::kPassC : C + p * L::kPassC);
  }
}

// Stage tap block `blk` of the tile (pass-local block blk % 24: tap
// (blk % 24) / 8, channels 64 ((blk % 24) % 8) + [0, 64)) into A ring slot
// blk % kABlocks: x rows t0 + r + (tap-1)*d rounded to bf16, zero outside
// [0, T), in the window layout; two rounds of two 16-byte loads a thread.
__device__ __forceinline__ void wide_stage_taps(char* aring, int blk,
                                                const float* xb, int t0, int T,
                                                int dilation) {
  using L = MmaWide;
  constexpr int kQ = 64 / 4;  // float4 of a block row
  constexpr int kRound = 2;
  const int lb = blk % (3 * L::kC / 64);
  const int tap = lb / (L::kC / 64);
  const int cb = (lb % (L::kC / 64)) * 64;
  char* dst = aring + (blk % L::kABlocks) * kKBlockBytes;
#pragma unroll
  for (int p0 = 0; p0 < kMmaRows * kQ / L::kThreads; p0 += kRound) {
    float4 v[kRound];
#pragma unroll
    for (int u = 0; u < kRound; ++u) {
      const int p = threadIdx.x + (p0 + u) * L::kThreads;
      const int t = t0 + p / kQ + (tap - 1) * dilation;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t >= 0 && t < T)
        v[u] = *reinterpret_cast<const float4*>(
            xb + static_cast<int64_t>(t) * L::kC + cb + (p % kQ) * 4);
    }
#pragma unroll
    for (int u = 0; u < kRound; ++u) {
      const int p = threadIdx.x + (p0 + u) * L::kThreads;
      *reinterpret_cast<uint2*>(dst + tile_off(p / kQ, (p % kQ) * 4)) =
          make_uint2(pack_bf16(v[u].x, v[u].y), pack_bf16(v[u].z, v[u].w));
    }
  }
  fence_proxy_async();
}

// One step of the wide kernel's weight ring (as ring_step).
template <bool kLast>
__device__ __forceinline__ void wide_ring_step(uint32_t ring, int chunk,
                                               const bf16* w_in,
                                               const bf16* w_rs) {
  constexpr int kChunks = MmaWide::kInChunks +
                          (kLast ? 1 : MmaWide::kPasses) * MmaWide::kRsPerPass;
  cp_async_wait<kAhead - 1>();
  fence_proxy_async();
  __syncthreads();
  if (chunk + kAhead < kChunks)
    wide_load_chunk<kLast>(ring, chunk + kAhead, w_in, w_rs);
}

// The res/skip outputs of one n8 block of accumulators (columns ch, ch+1 of
// rows r16 + g and r16 + g + 8), as the resident kernel's epilogue forms
// them: `res` (null on the last layer) is the residual's accumulators, `skp`
// the skip's, `bk` the skip's bias offset.
template <bool kLast>
__device__ __forceinline__ void wide_store(
    const float* res, const float* skp, int ch, int bk, int r16, int g,
    int rows, int64_t row0, int t0, int valid, const float* x,
    const float* b_rs, float* x_out, float* skip_out, int accumulate) {
  constexpr int C = MmaWide::kC;
  const float2 brs = *reinterpret_cast<const float2*>(b_rs + bk + ch);
  float2 brr = make_float2(0.f, 0.f);
  if constexpr (!kLast) brr = *reinterpret_cast<const float2*>(b_rs + ch);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r16 + g + 8 * h;
    if (row >= rows) continue;
    const int64_t off = (row0 + row) * C + ch;
    float2 xo = *reinterpret_cast<const float2*>(x + off);
    if constexpr (!kLast) {
      xo.x += res[2 * h] + brr.x;
      xo.y += res[2 * h + 1] + brr.y;
    }
    float2 skip = make_float2(skp[2 * h] + brs.x, skp[2 * h + 1] + brs.y);
    if (t0 + row >= valid) xo = make_float2(0.f, 0.f);
    *reinterpret_cast<float2*>(x_out + off) = xo;
    if (accumulate) {
      const float2 prev = *reinterpret_cast<const float2*>(skip_out + off);
      skip.x += prev.x;
      skip.y += prev.y;
    }
    *reinterpret_cast<float2*>(skip_out + off) = skip;
  }
}

// The kernel at C = 512 (see the note at the top).
template <bool kLast>
__device__ __forceinline__ void mma_streamed(
    const float* __restrict__ x, const bf16* __restrict__ cond,
    const bf16* __restrict__ w_in, const float* __restrict__ b_in,
    const bf16* __restrict__ w_rs, const float* __restrict__ b_rs,
    const int* __restrict__ valid_t, float* __restrict__ x_out,
    float* skip_out, int accumulate, int T, int dilation) {
  using L = MmaWide;
  constexpr int C = L::kC;
  constexpr int kOutPasses = kLast ? 1 : L::kPasses;
  constexpr int kChunks = L::kInChunks + kOutPasses * L::kRsPerPass;
  extern __shared__ __align__(1024) uint4 smem_mma[];
  char* aring = reinterpret_cast<char*>(smem_mma);
  const uint32_t aring_s = smem_u32(aring);
  const uint32_t ring_s = aring_s + L::kARingBytes;
  char* acts = aring + L::kARingBytes + kStages * L::kStageBytes;
  const uint32_t acts_s = smem_u32(acts);

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kMmaRows;
  const int rows = min(kMmaRows, T - t0);
  const int64_t row0 = static_cast<int64_t>(b) * T + t0;
  const float* xb = x + static_cast<int64_t>(b) * T * C;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int r16 = (warp % 4) * 16;
  const int g = lane / 4;
  const int tig = lane % 4;
  const int col0 = wg * kGroupCols;  // of the pass's 256 columns of each half
  const uint32_t b_a = (col0 / 64) * kBlockBytes;
  const uint32_t b_b = ((L::kPassC + col0) / 64) * kBlockBytes;

  for (int c = 0; c < kAhead; ++c) {
    wide_load_chunk<kLast>(ring_s, c, w_in, w_rs);
    cp_async_commit();
  }
  wide_stage_taps(aring, 0, xb, t0, T, dilation);

  float acc_a[kAcc], acc_b[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc_a[i] = acc_b[i] = 0.f;

  // ---- first product, two passes: acc_a the tanh columns [256p + col0,
  // +128), acc_b the sigmoid columns [C + 256p + col0, +128); chunk c reads
  // tap block c / 2, staged at step c - 2 (one block ahead, every 2 steps)
#pragma unroll 1
  for (int chunk = 0; chunk < L::kInChunks; ++chunk) {
    wide_ring_step<kLast>(ring_s, chunk, w_in, w_rs);
    cp_async_commit();
    const int blk = chunk / 2;
    const uint32_t a0 = aring_s + (blk % L::kABlocks) * kKBlockBytes +
                        (chunk % 2) * kKChunk * 2;
    const uint32_t slot = ring_s + (chunk % kStages) * L::kStageBytes;
    fence_acc(acc_a);
    fence_acc(acc_b);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kKChunk / 16; ++k) {
      const uint64_t da = a_desc(a0 + k * 32);
      wgmma_n128(acc_a, da, b_desc(slot + b_a + k * 16 * 128));
      wgmma_n128(acc_b, da, b_desc(slot + b_b + k * 16 * 128));
    }
    wgmma_commit();
    // the next tap block, while this chunk's wgmmas run: its slot last held
    // block blk - 2, whose chunks the barrier proved done
    if (chunk % 2 == 0 && blk + 1 < L::kTapBlocks)
      wide_stage_taps(aring, blk + 1, xb, t0, T, dilation);
    wgmma_wait<1>();
    fence_acc(acc_a);
    fence_acc(acc_b);
    if (chunk % L::kInPerPass != L::kInPerPass - 1) continue;

    // ---- the pass's gate (f32) on the accumulators, acts as bf16 --------
    // rows >= T have zero taps and cond; their acts feed rows not stored
    wgmma_wait<0>();
    fence_acc(acc_a);
    fence_acc(acc_b);
    const int pc = (chunk / L::kInPerPass) * L::kPassC + col0;
#pragma unroll
    for (int j = 0; j < kAcc / 4; ++j) {
      const int ch = pc + 8 * j + 2 * tig;
      const float2 bt = *reinterpret_cast<const float2*>(b_in + ch);
      const float2 bs = *reinterpret_cast<const float2*>(b_in + C + ch);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r16 + g + 8 * h;
        float2 ct = make_float2(0.f, 0.f), cs = make_float2(0.f, 0.f);
        if (row < rows) {
          const bf16* cr = cond + (row0 + row) * 2 * C + ch;
          ct = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(cr));
          cs = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(cr + C));
        }
        const float gt0 = acc_a[4 * j + 2 * h] + bt.x + ct.x;
        const float gt1 = acc_a[4 * j + 2 * h + 1] + bt.y + ct.y;
        const float gs0 = acc_b[4 * j + 2 * h] + bs.x + cs.x;
        const float gs1 = acc_b[4 * j + 2 * h + 1] + bs.y + cs.y;
        const float v0 = tanhf(gt0) * (1.f / (1.f + expf(-gs0)));
        const float v1 = tanhf(gt1) * (1.f / (1.f + expf(-gs1)));
        *reinterpret_cast<uint32_t*>(acts + tile_off(row, ch)) = pack_bf16(v0, v1);
      }
    }
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc_a[i] = acc_b[i] = 0.f;
  }

  // ---- second product, per pass p: acc_a the residual columns [256p +
  // col0, +128), acc_b the skip columns [C + 256p + col0, +128) (the last
  // layer: skip columns [col0, +128) and [256 + col0, +128))
  const int valid = valid_t != nullptr ? valid_t[b] : T;
#pragma unroll 1
  for (int chunk = L::kInChunks; chunk < kChunks; ++chunk) {
    // also hands the acts to the async proxy and orders them
    wide_ring_step<kLast>(ring_s, chunk, w_in, w_rs);
    cp_async_commit();
    const int j = chunk - L::kInChunks;
    const int k0 = (j % L::kRsPerPass) * kKChunk;
    const uint32_t a0 = acts_s + (k0 / 64) * kKBlockBytes + (k0 % 64) * 2;
    const uint32_t slot = ring_s + (chunk % kStages) * L::kStageBytes;
    fence_acc(acc_a);
    fence_acc(acc_b);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kKChunk / 16; ++k) {
      const uint64_t da = a_desc(a0 + k * 32);
      wgmma_n128(acc_a, da, b_desc(slot + b_a + k * 16 * 128));
      wgmma_n128(acc_b, da, b_desc(slot + b_b + k * 16 * 128));
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(acc_a);
    fence_acc(acc_b);
    if (j % L::kRsPerPass != L::kRsPerPass - 1) continue;

    // ---- epilogue of the pass: residual, valid_t mask, skip sum (f32) ---
    wgmma_wait<0>();
    fence_acc(acc_a);
    fence_acc(acc_b);
    const int pc = (j / L::kRsPerPass) * L::kPassC + col0;
#pragma unroll
    for (int jj = 0; jj < kAcc / 4; ++jj) {
      const int ch = pc + 8 * jj + 2 * tig;
      if constexpr (kLast) {
        wide_store<true>(nullptr, acc_a + 4 * jj, ch, 0, r16, g, rows, row0, t0,
                         valid, x, b_rs, x_out, skip_out, accumulate);
        wide_store<true>(nullptr, acc_b + 4 * jj, ch + L::kPassC, 0, r16, g,
                         rows, row0, t0, valid, x, b_rs, x_out, skip_out,
                         accumulate);
      } else {
        wide_store<false>(acc_a + 4 * jj, acc_b + 4 * jj, ch, C, r16, g, rows,
                          row0, t0, valid, x, b_rs, x_out, skip_out,
                          accumulate);
      }
    }
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc_a[i] = acc_b[i] = 0.f;
  }
  cp_async_wait<0>();
}

template <int kC, bool kLast>
__global__ void __launch_bounds__(mma_threads<kC>(), 1)
wn_layer_kernel_mma(const float* __restrict__ x, const bf16* __restrict__ cond,
                    const bf16* __restrict__ w_in,
                    const float* __restrict__ b_in,
                    const bf16* __restrict__ w_rs,
                    const float* __restrict__ b_rs,
                    const int* __restrict__ valid_t, float* __restrict__ x_out,
                    float* skip_out, int accumulate, int T, int dilation) {
  if constexpr (kC <= 256)
    mma_resident<kC, kLast>(x, cond, w_in, b_in, w_rs, b_rs, valid_t, x_out,
                            skip_out, accumulate, T, dilation);
  else
    mma_streamed<kLast>(x, cond, w_in, b_in, w_rs, b_rs, valid_t, x_out,
                        skip_out, accumulate, T, dilation);
}

// ---- launch ---------------------------------------------------------------

// Blocks of the f32 kernel the device holds at once, as SMs and blocks an
// SM (the occupancy API, after the shared-memory opt-in); read once per
// variant and device.
template <int kC, bool kLast>
cudaError_t f32_slots(int* sms, int* per_sm) {
  static std::atomic<int> cache[32];
  static std::atomic<uint32_t> opted_in{0};
  return wave_slots(wn_layer_kernel_f32<kC, kLast>, F32<kC>::kThreads,
                    F32<kC>::kSmemBytes, cache, &opted_in, sms, per_sm);
}

struct Args {
  const float* x;
  const void* cond;
  const void* w_in;
  const float* b_in;
  const void* w_rs;
  const float* b_rs;
  const int* valid_t;
  float* x_out;
  float* skip_out;
  int accumulate, batch, T, dilation;
  cudaStream_t stream;
};

template <int kC, bool kBf16, bool kLast>
cudaError_t launch(const Args& a) {
  if constexpr (kBf16) {
    static std::atomic<uint32_t> opted_in{0};
    auto kernel = wn_layer_kernel_mma<kC, kLast>;
    constexpr int smem = mma_smem_bytes<kC>();
    cudaError_t err = opt_in_smem(kernel, smem, &opted_in);
    if (err != cudaSuccess) return err;
    dim3 grid((a.T + kMmaRows - 1) / kMmaRows, a.batch);
    kernel<<<grid, mma_threads<kC>(), smem, a.stream>>>(
        a.x, static_cast<const bf16*>(a.cond), static_cast<const bf16*>(a.w_in),
        a.b_in, static_cast<const bf16*>(a.w_rs), a.b_rs, a.valid_t, a.x_out,
        a.skip_out, a.accumulate, a.T, a.dilation);
  } else {
    int sms = 0, per_sm = 0;
    cudaError_t err = f32_slots<kC, kLast>(&sms, &per_sm);  // also opts in
    if (err != cudaSuccess) return err;
    const int rows = a.batch * a.T;
    const int per_block = one_wave_rows(rows, sms * per_sm, kRowQuantum);
    wn_layer_kernel_f32<kC, kLast><<<(rows + per_block - 1) / per_block,
                                     F32<kC>::kThreads, F32<kC>::kSmemBytes,
                                     a.stream>>>(
        a.x, static_cast<const float*>(a.cond),
        static_cast<const float*>(a.w_in), a.b_in,
        static_cast<const float*>(a.w_rs), a.b_rs, a.valid_t, a.x_out,
        a.skip_out, a.accumulate, a.T, a.dilation, rows, per_block);
  }
  return cudaGetLastError();
}

// The (kC, bf16, last) instance: launched with `a`, or (with `a` null) its
// function pointer and the dynamic shared bytes its launcher passes.
template <int kC>
cudaError_t dispatch_width(const Args* a, int bf16_mode, int last,
                           const void** kernel, int* smem_bytes) {
#define WN_CASE(BF, LAST, FN, SMEM)                                \
  if (a == nullptr) {                                              \
    *kernel = reinterpret_cast<const void*>(FN<kC, LAST>);         \
    *smem_bytes = SMEM;                                            \
    return cudaSuccess;                                            \
  }                                                                \
  return launch<kC, BF, LAST>(*a)
  if (bf16_mode) {
    if (last) { WN_CASE(true, true, wn_layer_kernel_mma, mma_smem_bytes<kC>()); }
    WN_CASE(true, false, wn_layer_kernel_mma, mma_smem_bytes<kC>());
  }
  if (last) { WN_CASE(false, true, wn_layer_kernel_f32, F32<kC>::kSmemBytes); }
  WN_CASE(false, false, wn_layer_kernel_f32, F32<kC>::kSmemBytes);
#undef WN_CASE
}

// The widths the kernels are built for.
cudaError_t dispatch(int c, const Args* a, int bf16_mode, int last,
                     const void** kernel, int* smem_bytes) {
  switch (c) {
    case 128: return dispatch_width<128>(a, bf16_mode, last, kernel, smem_bytes);
    case 256: return dispatch_width<256>(a, bf16_mode, last, kernel, smem_bytes);
    case 512: return dispatch_width<512>(a, bf16_mode, last, kernel, smem_bytes);
    default: return cudaErrorInvalidValue;
  }
}

template <int kC>
cudaError_t f32_slots_for(int last, int* sms, int* per_sm) {
  return last ? f32_slots<kC, true>(sms, per_sm)
              : f32_slots<kC, false>(sms, per_sm);
}

}  // namespace

extern "C" {

// Shapes: x, x_out, skip_out [batch, T, C] f32; cond [batch, T, 2C]; w_in
// [3C, 2C]; b_in [2C] f32; w_rs [C, 2C] or [C, C] (last); b_rs likewise f32;
// valid_t [batch] int32 or null. cond/w_in/w_rs are bf16 when bf16 != 0,
// else f32. accumulate != 0 adds into skip_out (in place). C must be 128,
// 256 or 512. All pointers 16-byte aligned and contiguous. Launches on
// `stream`, does not synchronise; returns the launch error.
cudaError_t wn_layer_forward(const float* x, const void* cond,
                             const void* w_in, const float* b_in,
                             const void* w_rs, const float* b_rs,
                             const int* valid_t, float* x_out,
                             float* skip_out, int accumulate, int batch,
                             int T, int C, int dilation, int bf16, int last,
                             cudaStream_t stream) {
  if (T <= 0 || batch <= 0 || batch > 65535 ||
      static_cast<int64_t>(batch) * T > INT32_MAX)
    return cudaErrorInvalidValue;
  const Args a{x, cond, w_in, b_in, w_rs, b_rs, valid_t, x_out, skip_out,
               accumulate, batch, T, dilation, stream};
  return dispatch(C, &a, bf16, last, nullptr, nullptr);
}

// What the loaded build of the (C, bf16, last) kernel uses, read from the
// CUDA runtime: registers per thread, local (spill) bytes per thread, static
// shared bytes, and the dynamic shared bytes its launcher passes.
cudaError_t wn_layer_kernel_info(int C, int bf16, int last, int* registers,
                                 int* local_bytes, int* static_smem_bytes,
                                 int* dynamic_smem_bytes) {
  const void* kernel = nullptr;
  cudaError_t err = dispatch(C, nullptr, bf16, last, &kernel, dynamic_smem_bytes);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  *registers = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *static_smem_bytes = static_cast<int>(attr.sharedSizeBytes);
  return cudaSuccess;
}

// The f32 kernel's grid at width C for `batch` x T rows, as its launcher
// picks it: SMs, blocks an SM (occupancy API), blocks launched, rows a
// block takes.
cudaError_t wn_layer_f32_schedule(int C, int batch, int T, int last, int* sms,
                                  int* blocks_per_sm, int* blocks,
                                  int* rows_per_block) {
  if (T <= 0 || batch <= 0 || static_cast<int64_t>(batch) * T > INT32_MAX)
    return cudaErrorInvalidValue;
  cudaError_t err;
  switch (C) {
    case 128: err = f32_slots_for<128>(last, sms, blocks_per_sm); break;
    case 256: err = f32_slots_for<256>(last, sms, blocks_per_sm); break;
    case 512: err = f32_slots_for<512>(last, sms, blocks_per_sm); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  const int rows = batch * T;
  *rows_per_block = one_wave_rows(rows, *sms * *blocks_per_sm, kRowQuantum);
  *blocks = (rows + *rows_per_block - 1) / *rows_per_block;
  return cudaSuccess;
}

}  // extern "C"
