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
// Two kernels, one per mode (at C = 512 in f32 two, and in bf16 three).
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
//     with 8 warps of 192-thread blocks). C = 512 runs two kernels of the
//     same register tile, wn_layer_kernel_f32_tiles and _rest (their
//     section below): 96-row tiles in four passes of 128 channels, so each
//     weight row copied into the ring feeds 96 rows, a block's rest of 48
//     rows or fewer in 16-row tiles of one 512-channel pass, and the acts
//     through a global f32 scratch instead of shared memory, which keeps
//     the ring at 4 stages.
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
//     192 KB, and a thread's 128 accumulators hold 256 of the 1,024 gate
//     columns of 64 rows). Streaming the taps through it, as a 64-row tile
//     whose products run in two passes, read all 4.19 MB of weights from L2
//     for every 64 rows and rounded the taps again on every pass. So C =
//     512 runs three kernels instead, all wgmma m64n128k16 through one
//     4-stage cp.async ring whose stage is a 64-deep K chunk (A [128
//     rows][64] K-major, B [64][256] MN-major; 196,608 bytes):
//       wn_layer_kernel_round - x rounded to bf16 once (a scratch the
//         wrapper allocates, with the acts'): every tap of every pass then
//         reads it as it is.
//       wn_layer_kernel_gate - a unit is 128 rows of the flat B*T rows (two
//         warpgroups of 64) x one pass of 128 channels: pre = the three
//         taps (rows of the row's own sequence, zero outside [0, T)) @
//         w_in at the pass's 128 tanh and 128 sigmoid columns, K = 3C in
//         (tap, 64-channel) chunks, so a weight chunk read from L2 feeds 128
//         rows; then the gate in f32 on the accumulators, the acts rounded
//         to bf16 into the scratch.
//       wn_layer_kernel_rs<last> - a unit is 128 rows x 256 of the n_rs
//         columns (the residual's 128 with the skip's 128 of the same
//         channels; the last layer's skip in two halves): rs = acts @ w_rs,
//         K = C; the epilogue of the C <= 256 kernel.
//     Each is one wave of persistent blocks (one an SM, as many as the
//     device holds, no more than units), each walking the units blockIdx +
//     k * gridDim; the four passes of a tile are neighbours, so its taps
//     are read from L2 while the other passes still hold them.
//   * A model rank's share of the C = 512 layer in bf16 (wn_layer_shard.cu's
//     contract: C' = 256, 128 or 64 gate channels, the f32 partial acts @
//     w_rs_s out) runs the same three kernels at gate width G = C'
//     (wn_layer_shard_wide_forward): the gate kernel makes G / 128 passes
//     (one of 64 tanh and 64 sigmoid columns, two m64n64 products, at C' =
//     64) over w_in_s [3C, 2C'] and cond_s [B*T, 2C'] into acts [B*T, C'];
//     the res/skip kernel's K is C' and its epilogue stores the partial as
//     it is. The mma.sync shard kernel it replaced there streamed all of
//     w_in_s and w_rs_s through its ring for every 64 rows and rounded the
//     f32 taps on every chunk.
//   * A rank's share below C = 512 in bf16 (C = 256 at C' = 128, 64, 32; C
//     = 128 at 64, 32, 16) is one kernel, wn_layer_kernel_rank<C, C',
//     last> (its section below). It is byte-bound: at (256, 128), B=1, T =
//     26,432, x in (27 MB f32), cond_s in and the f32 partial out (54 MB)
//     take 0.028 ms at 3.35 TB/s against 0.014 ms of tensor-core time; at
//     the narrow pairs the partial alone is most of the bytes. One pass of
//     the gate covers every channel there, so the kernel rounds the f32
//     taps itself (no rounding kernel, no rounded copy of x), and the acts
//     stay in shared memory for the res/skip product (no acts in global
//     memory, one launch): each unit of 128 flat rows reads its x rows
//     from L2 three times (once a tap) and w_in_s once, and writes its
//     partial rows once. w_rs_s sits in shared memory for the whole
//     kernel, where it fits beside the gate's buffers: at every pair but
//     (256, 128), whose gate kernel (the same gate) writes the acts for
//     wn_layer_kernel_rs. The ring runs on across units, so the next
//     unit's first copies land under this unit's last steps and its
//     stores.
// No atomics, no split K: the sums run in one fixed order, so two launches
// give the same bits.
//
// Measured on an NVIDIA H100 80GB HBM3 (700 W) by chip_smoke.py, at the
// shape above (d=1): the f32 kernel 0.75 ms against the 0.41 ms bound (55%;
// 1.01 ms for the 32-row design it replaced, in the same run), with 167
// registers, 193,280 bytes of shared memory and no spills; the bf16 kernel
// 0.17 ms against the 0.041 ms bound (24%). At C = 512 (phase 12, same
// shape) the three bf16 kernels take 0.43 ms (round 0.027, gate 0.244, rs
// 0.142) against the 0.112 ms bound (26%) and 0.79 ms for the streamed
// design they replaced; the gate kernel is bound by no one of its copies
// or wgmmas (fwd_ablation.py). A rank's share at C = 512 in bf16 takes
// 0.25 / 0.17 / 0.14 ms at C' = 256 / 128 / 64 against 0.40 / 0.26 / 0.19
// for the mma.sync kernel it replaced, the same bits (fwd_compare.py). A
// rank's share below 512 in bf16 (fwd_compare.py, other / this / this /
// other against the mma.sync kernel; B=1, T=26,432, d=1): (256, 128) 0.098
// ms (gate 0.061, rs 0.033: fwd_ablation.py) against 0.143, (256, 64)
// 0.064 against 0.106, (256, 32) 0.056-0.059 against 0.065-0.066, (128,
// 64) 0.043-0.046 against 0.063-0.064, against bounds of 0.028 / 0.026 /
// 0.025 / 0.014 ms; at (128, 32) and (128, 16) both designs' calls are
// host-bound (0.03-0.05 ms, the rank kernel alone 0.030 and 0.026 ms by
// fwd_ablation.py). Their bits differ from the mma.sync kernel's (another
// order of the K sums). The f32 layer at C = 512 takes 3.02 ms at d=1 and
// d=128 against the 1.65 ms bound (55%) and 3.44 ms for the 48-row design
// it replaced, the same bits, at the card's full 1,980 MHz clock
// (fwd_f32_ablation.py). PERF.md keeps the times;
// wn_layer_kernel_info reports the registers, spills and shared memory of
// the loaded build.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <type_traits>

#include "f32_ring.cuh"
#include "sm90_wgmma.cuh"

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

// The f32 kernel's layout at width kC <= 256 (C = 512 has the kernels of
// the next section). A pass covers the kPC = C channels of each half (the
// warp grid's width). Ring slot: the chunk's taps [kTileRows][kChunk],
// then its weight rows [kChunk][2 kPC] (the last layer's w_rs:
// [kChunk][kPC]); acts [kTileRows][kActsStride]; f32.
template <int kC>
struct F32 {
  static constexpr int kPC = kC;                   // channels of a pass
  static constexpr int kPasses = kC / kPC;
  static constexpr int kColWarps = kPC / 64;       // warps across a pass
  static constexpr int kThreads = 32 * kColWarps * kRowPairs;  // 192 / 384
  static constexpr int kStages = 4;                // ring depth
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
  static_assert(kC <= 256, "C = 512 runs wn_layer_kernel_f32_{tiles,rest}");
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

// ---- the f32 kernel at C = 512: 96-row tiles, the acts through a scratch

// At C = 512 the layout above holds a tile's acts [48][512] in 99 KB of
// shared memory, leaves a 3-stage ring, and copies every weight row of the
// layer into shared memory once for each 48 rows: those copies cost a fifth
// of its time (fwd_f32_ablation.py), and a deeper ring does not hide them.
// So the weight rows feed 96 rows here: a tile is 96 rows (6 pairs of 16)
// x a pass of 128 channels (2 warps across), four passes of each product,
// the same 8 x (4 + 4) register tile a thread; the acts go to a global f32
// scratch [B*T, C] (a block's own rows) and come back through the ring as
// the second product's rows, so the ring keeps 4 stages. A block's rows
// (the one-wave split of the C <= 256 kernel) are walked by
// wn_layer_kernel_f32_tiles in 96-row tiles, the last short; when 48 rows
// or fewer are left (16 of 208 at B=1, T=26,432), wn_layer_kernel_f32_rest
// takes them in tiles of 16 rows x all 512 channels in one pass, 8 warps
// for each 16 rows (2 in a 96-row tile), through a 3-stage ring.

// A tile layout of the C = 512 f32 kernels: a pass covers kPC channels of
// each gate half (kPC / 64 warps across), a tile kRowPairs x 16 rows; per
// pass of the first product kInPerPass 16-row K chunks of w_in (the pass's
// tanh and sigmoid columns) with the taps, then per pass of the second
// kRsPerPass of w_rs (its residual and skip columns; the last layer's
// columns of the pass) with the acts. Ring slot: the chunk's taps or acts
// [kTileRows][kChunk], then its weight rows [kChunk][2 kPC] (the last
// layer's w_rs: [kChunk][kPC]); kStages_ slots.
template <int kPC_, int kRowPairs, int kStages_ = 4>
struct F32Wide {
  static constexpr int kC = 512;
  static constexpr int kPC = kPC_;
  static constexpr int kPasses = kC / kPC;
  static constexpr int kTileRows = 16 * kRowPairs;
  static constexpr int kTapFloats = kTileRows * kChunk;
  static constexpr int kColWarps = kPC / 64;
  static constexpr int kThreads = 32 * kColWarps * kRowPairs;
  static constexpr int kStages = kStages_;
  static constexpr int kAhead = kStages - 1;
  static constexpr int kInPerPass = 3 * kC / kChunk;
  static constexpr int kRsPerPass = kC / kChunk;
  static constexpr int kInChunks = kPasses * kInPerPass;
  static constexpr int kChunks = kInChunks + kPasses * kRsPerPass;
  static constexpr int kChunksPerTap = kC / kChunk;
  static constexpr int kSlotFloats = kTapFloats + kChunk * 2 * kPC;
  static constexpr int kSmemBytes = sizeof(float) * kStages * kSlotFloats;
  static_assert(kPC == kColWarps * 16 * kPerLane, "16 lanes a channel quarter");
  static_assert(kTileRows * kChunk / 4 <= kThreads, "one tap piece a thread");
  static_assert(kSmemBytes <= 232448, "over the 227 KB a block may use");
};
using F32Tiles = F32Wide<128, 6>;    // wn_layer_kernel_f32_tiles: 384 threads
using F32Rest = F32Wide<512, 1, 3>;  // wn_layer_kernel_f32_rest: 256 threads
// The most rows of a block's rest left to the rest kernel.
constexpr int kF32RestRows = 48;

// A block of n rows: its 96-row tiles (the last short, when over
// kF32RestRows rows are left), and whether a rest of kF32RestRows rows or
// fewer is left to the rest kernel.
__host__ __device__ inline int f32_wide_tiles(int n) {
  const int rest = n % F32Tiles::kTileRows;
  return n / F32Tiles::kTileRows + (rest > kF32RestRows);
}

__host__ __device__ inline bool f32_wide_rest(int n) {
  const int rest = n % F32Tiles::kTileRows;
  return rest > 0 && rest <= kF32RestRows;
}

// Start the cp.async copies of chunk `local` of a tile of layout L whose
// first flat row is `tile0` into the ring slot at `slot`. Taps are rows of
// the flat [B*T, C] x: tile row r is flat row R = b*T + t, and its tap
// reads row R + (tap-1)*d, zero unless t + (tap-1)*d lies in [0, T) (its
// own sequence) and R before the block's end `row_end`; this thread's tap
// row's t is kept in `tap_t` from the tile's first chunk (a large negative
// past the block's end), so the division by T runs once a tile. The second
// product's chunks copy the tile's acts of their 16 channels from `acts`
// [B*T, C] (zero past the block's end).
template <typename L, bool kLast>
__device__ __forceinline__ void f32_wide_load(
    uint32_t slot, int local, int tile0, int row_end, const float* x,
    const float* acts, const float* w_in, const float* w_rs, int T,
    int dilation, int& tap_t) {
  constexpr int kC = L::kC;
  constexpr int kPC = L::kPC;
  constexpr int N_RS = kLast ? kC : 2 * kC;
  const uint32_t wslot = slot + L::kTapFloats * 4;
  const int r = threadIdx.x / (kChunk / 4);  // tap row, 16-byte piece q
  const int q = threadIdx.x % (kChunk / 4);
  const int row = tile0 + r;                 // flat row
  if (local == 0)
    tap_t = row < row_end
                ? row - static_cast<int>(static_cast<unsigned>(row) /
                                         static_cast<unsigned>(T)) * T
                : INT32_MIN / 2;
  if (local >= L::kInChunks) {
    const int j = local - L::kInChunks;
    const int pass = j / L::kRsPerPass;
    const int k0 = (j % L::kRsPerPass) * kChunk;
    if (r < L::kTileRows)
      cp_async16_zfill(
          slot + (r * kChunk + q * 4) * 4,
          row < row_end ? acts + static_cast<int64_t>(row) * kC + k0 + q * 4
                        : acts,
          row < row_end);
    const float* src = w_rs + static_cast<int64_t>(k0) * N_RS;
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
  const int off = (kc / L::kChunksPerTap - 1) * dilation;
  const int t = tap_t + off;
  const bool valid = t >= 0 && t < T;
  if (r < L::kTileRows)
    cp_async16_zfill(slot + (r * kChunk + q * 4) * 4,
                     valid ? x + static_cast<int64_t>(row + off) * kC +
                                 (kc % L::kChunksPerTap) * kChunk + q * 4
                           : x,
                     valid);
  copy_rows<kChunk, L::kThreads, 2 * kPC, kPC>(
      wslot, w_in + static_cast<int64_t>(kc) * kChunk * 2 * kC, 2 * kC,
      pass * kPC, kC + pass * kPC);
}

// `n_tiles` tiles of layout L from flat row `first` (the last one ending
// at `row_end`, the block's end): both products, the gate and the epilogue
// of the C <= 256 kernel, one sequence of K chunks through the ring.
template <typename L, bool kLast>
__device__ __forceinline__ void f32_wide_block(
    const float* __restrict__ x, const float* __restrict__ cond,
    const float* __restrict__ w_in, const float* __restrict__ b_in,
    const float* __restrict__ w_rs, const float* __restrict__ b_rs,
    const int* __restrict__ valid_t, float* __restrict__ x_out,
    float* skip_out, float* acts_g, int accumulate, int T, int dilation,
    int first, int n_tiles, int row_end) {
  constexpr int C = L::kC;
  constexpr int kPC = L::kPC;
  constexpr int N_IN = 2 * C;  // gate pre-activations
  constexpr int kThreads = L::kThreads;
  const int n_chunks = n_tiles * L::kChunks;

  extern __shared__ float4 smem_f32w[];
  float* smem = reinterpret_cast<float*>(smem_f32w);
  const uint32_t ring = smem_u32(smem);

  // Warp w: rows [16 (w/kColWarps), +16) of the tile and channels
  // [64 (w%kColWarps), +64) of each gate half of a pass; lane l: rows
  // 16 (w/kColWarps) + 2i + l/16 and channels c0..c0+3, c0 = 64 (w%kColWarps)
  // + 4 (l%16), as in the C <= 256 kernel.
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int pair = warp / L::kColWarps;
  const int r0 = 16 * pair + lane / 16;                  // first tile row
  const int c0 = 64 * (warp % L::kColWarps) + 4 * (lane % 16);

  int tap_t;
  const auto load_chunk = [&](int chunk) {
    f32_wide_load<L, kLast>(
        ring + (chunk % L::kStages) * L::kSlotFloats * 4, chunk % L::kChunks,
        first + chunk / L::kChunks * L::kTileRows, row_end, x, acts_g, w_in,
        w_rs, T, dilation, tap_t);
  };
  ring_prologue<L::kAhead>(n_chunks, load_chunk);

  float acc_a[kRowsPerThread][kPerLane];  // tanh, then residual (last: skip)
  float acc_b[kRowsPerThread][kPerLane];  // sigmoid, then skip
  for (int chunk0 = 0; chunk0 < n_chunks; chunk0 += L::kChunks) {
    const int t0 = first + chunk0 / L::kChunks * L::kTileRows;  // flat row
    const int tile_rows = min(L::kTileRows, row_end - t0);
    // the warps of a pair of 16 rows all past the block's end do no FMAs
    const bool busy = 16 * pair < tile_rows;
    // One gate pass (the rest kernel): the second product's first chunks
    // read acts that the pass's last step writes, so the ring loads nothing
    // past the gate until then. (With more passes they are the first
    // pass's channels, written a pass earlier.)
    constexpr bool kOnePass = L::kPasses == 1;
    const int gate_end = chunk0 + L::kInChunks;
    const int gate_limit = kOnePass ? gate_end : n_chunks;

    // ---- first product: pre[rows, 2C] = taps[rows, 3C] @ w_in[3C, 2C] -----
    // pass p: the tanh and sigmoid columns of channels [p kPC, p kPC + kPC)
    // (unrolled: the pass's column offsets are constants)
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
        ring_step<L::kAhead>(chunk0 + local, gate_limit, load_chunk);
        if (kc == L::kInPerPass - 16) {
          // the pass's cond columns of the tile's rows into L2, for the
          // gate: kLines 128-byte lines of each half a row
          constexpr int kLines = kPC / 32;
          const float* src = cond + static_cast<int64_t>(t0) * N_IN + p * kPC;
          for (int q = threadIdx.x; q < tile_rows * 2 * kLines; q += kThreads)
            prefetch_l2(src + q / (2 * kLines) * N_IN + q / kLines % 2 * C +
                        q % kLines * 32);
        }
        if (busy) {
          const float* slot =
              smem + ((chunk0 + local) % L::kStages) * L::kSlotFloats;
          f32_chunk_fma<true, kChunk, 2 * kPC, kPC>(
              acc_a, acc_b, slot + r0 * kChunk, slot + L::kTapFloats + c0);
        }
      }

      // ---- gate (f32) on the accumulators, acts to the scratch ------------
      // rows of the tile only: the second product reads them back through
      // the ring after this tile's next barriers
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
            const int r = r0 + 2 * (i0 + h);
            float out[kPerLane];
#pragma unroll
            for (int j = 0; j < kPerLane; ++j) {
              const float gt = acc_a[i0 + h][j] + bt[j] + ct[h][j];
              const float gs = acc_b[i0 + h][j] + bs[j] + cs[h][j];
              out[j] = tanhf(gt) * (1.f / (1.f + expf(-gs)));
            }
            if (r < tile_rows)
              store4(acts_g + static_cast<int64_t>(t0 + r) * C + ch, out);
          }
        }
      }
      // the ring's cp.async.cg reads the acts from L2: this thread's stores
      // reach it before the barriers that order those reads
      __threadfence();
    }
    if constexpr (kOnePass) {
      // the second product's first chunks, whose acts the gate has just
      // written, load now (each a commit group, as the steps' loads)
      __syncthreads();
      for (int c = gate_end; c < gate_end + L::kAhead; ++c) {
        if (c < n_chunks) load_chunk(c);
        cp_async_commit();
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
        ring_step<L::kAhead>(chunk0 + local, n_chunks, load_chunk);
        if (kc == L::kRsPerPass - 8) {
          // the pass's columns of the x rows and the skip sum into L2, for
          // the epilogue
          constexpr int kLines = kPC / 32;
          const int64_t off = static_cast<int64_t>(t0) * C + p * kPC;
          for (int q = threadIdx.x; q < tile_rows * kLines; q += kThreads) {
            const int64_t at = off + q / kLines * C + q % kLines * 32;
            prefetch_l2(x + at);
            if (accumulate) prefetch_l2(skip_out + at);
          }
        }
        if (busy) {
          const float* slot =
              smem + ((chunk0 + local) % L::kStages) * L::kSlotFloats;
          f32_chunk_fma<!kLast, kChunk, kLast ? kPC : 2 * kPC, kPC>(
              acc_a, acc_b, slot + r0 * kChunk, slot + L::kTapFloats + c0);
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

// C = 512, f32: block i's flat rows [i * rows_per_block, (i + 1) *
// rows_per_block) of the B*T rows in 96-row tiles (f32_wide_tiles).
template <bool kLast>
__global__ void __launch_bounds__(F32Tiles::kThreads, 1)
wn_layer_kernel_f32_tiles(
    const float* __restrict__ x, const float* __restrict__ cond,
    const float* __restrict__ w_in, const float* __restrict__ b_in,
    const float* __restrict__ w_rs, const float* __restrict__ b_rs,
    const int* __restrict__ valid_t, float* __restrict__ x_out,
    float* skip_out, float* acts_g, int accumulate, int T, int dilation,
    int rows, int rows_per_block) {
  const int row_begin = blockIdx.x * rows_per_block;
  const int row_end = min(rows, row_begin + rows_per_block);
  if (row_begin >= row_end) return;
  const int n_tiles = f32_wide_tiles(row_end - row_begin);
  if (n_tiles == 0) return;
  f32_wide_block<F32Tiles, kLast>(x, cond, w_in, b_in, w_rs, b_rs, valid_t,
                                  x_out, skip_out, acts_g, accumulate, T,
                                  dilation, row_begin, n_tiles, row_end);
}

// C = 512, f32: the rest of block i's rows past its 96-row tiles, when
// kF32RestRows or fewer (f32_wide_rest), in 16-row tiles of one 512-channel
// pass; the same grid as wn_layer_kernel_f32_tiles.
template <bool kLast>
__global__ void __launch_bounds__(F32Rest::kThreads, 1)
wn_layer_kernel_f32_rest(
    const float* __restrict__ x, const float* __restrict__ cond,
    const float* __restrict__ w_in, const float* __restrict__ b_in,
    const float* __restrict__ w_rs, const float* __restrict__ b_rs,
    const int* __restrict__ valid_t, float* __restrict__ x_out,
    float* skip_out, float* acts_g, int accumulate, int T, int dilation,
    int rows, int rows_per_block) {
  const int row_begin = blockIdx.x * rows_per_block;
  const int row_end = min(rows, row_begin + rows_per_block);
  if (row_begin >= row_end || !f32_wide_rest(row_end - row_begin)) return;
  const int first =
      row_begin + f32_wide_tiles(row_end - row_begin) * F32Tiles::kTileRows;
  f32_wide_block<F32Rest, kLast>(
      x, cond, w_in, b_in, w_rs, b_rs, valid_t, x_out, skip_out, acts_g,
      accumulate, T, dilation, first,
      (row_end - first + F32Rest::kTileRows - 1) / F32Rest::kTileRows,
      row_end);
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
      const uint64_t da = kmajor_desc(a0 + k * 32);
      wgmma_m64<128, 0, 1>(acc_a, da,
                           mnmajor_desc(slot + b_a + k * 16 * 128, kBlockBytes));
      wgmma_m64<128, 0, 1>(acc_b, da,
                           mnmajor_desc(slot + b_b + k * 16 * 128, kBlockBytes));
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
      const uint64_t da = kmajor_desc(a0 + k * 32);
      wgmma_m64<128, 0, 1>(acc_a, da,
                           mnmajor_desc(slot + b_a + k * 16 * 128, kBlockBytes));
      if constexpr (!kLast)
        wgmma_m64<128, 0, 1>(acc_b, da,
                             mnmajor_desc(slot + b_b + k * 16 * 128, kBlockBytes));
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

// ---- C = 512: the taps rounded once, 128-row units, a persistent grid ----

// The three kernels of the C = 512 layer (see the note at the top), which
// also run a model rank's share of it at C' = C / model gate channels
// (wn_layer_shard.cu's contract): the layout of a unit's ring. Two
// warpgroups, 64 rows each, hold a unit's 128 rows; a stage is one 64-deep
// K chunk: A [128 rows][64 K] K-major, then B [64 K][at most 256 N]
// MN-major in 64-column blocks, both with the 128-byte swizzle
// (sm90_wgmma.cuh).
struct Wide {
  static constexpr int kC = 512;
  static constexpr int kThreads = 256;
  static constexpr int kTile = 128;                   // rows of a unit
  static constexpr int kKC = 64;                      // K of a chunk
  static constexpr int kABytes = kTile * 128;         // 16,384
  static constexpr int kNBlock = 64 * 128;            // [64 K][64 N]: 8,192
  static constexpr int kStageBytes = kABytes + 4 * kNBlock;  // 49,152
  static constexpr int kStages = 4;
  static constexpr int kAhead = kStages - 2;          // chunks in flight
  static constexpr int kSmem = kStages * kStageBytes;  // 196,608
  static constexpr int kGateChunks = 3 * kC / kKC;    // 24
  static_assert(kSmem <= 232448, "over the 227 KB a block may use");
};

// The gate kernel at kG gate channels (C for the layer, C' for a rank): a
// pass takes kPW of them, its tanh and sigmoid columns side by side in B
// (kPW each: two m64nkPW products a chunk).
template <int kG>
struct WideGate {
  static constexpr int kPW = kG < 128 ? kG : 128;  // channels of a pass
  static constexpr int kPasses = kG / kPW;
  static_assert(kPW % 64 == 0 && kG % kPW == 0, "whole 64-column blocks");
};

// The res/skip product at width kC: passes of 2 kH of its n_rs columns (kH
// = 128; 64 at C = 128's last layer, whose n_rs is 128).
template <int kC, bool kLast>
struct WideRs {
  static constexpr int kNrs = kLast ? kC : 2 * kC;
  static constexpr int kH = kNrs / 2 < 128 ? kNrs / 2 : 128;
  static constexpr int kPasses = kNrs / (2 * kH);
};

// A unit's products: kChunks K chunks through the ring, `load(stage, j)`
// starting this thread's copies of chunk j (no commit) kAhead steps ahead
// of its wgmmas; acc_a += A @ B[:, 0:kN) and acc_b += A @ B[:, kN:2kN)
// over the warpgroup's 64 rows. Past each step's barrier every warpgroup
// has waited for the wgmmas of chunk j - 2, whose stage takes chunk j + 2.
// Returns with every wgmma and copy of the unit done.
template <int kChunks, int kN, typename Load>
__device__ __forceinline__ void wide_products(uint32_t ring,
                                              float (&acc_a)[kN / 2],
                                              float (&acc_b)[kN / 2],
                                              const Load& load) {
  using L = Wide;
  const uint32_t a_wg = (threadIdx.x / 128) * (L::kABytes / 2);
  for (int c = 0; c < L::kAhead; ++c) {
    if (c < kChunks) load(ring + c * L::kStageBytes, c);
    cp_async_commit();
  }
#pragma unroll 1
  for (int j = 0; j < kChunks; ++j) {
    cp_async_wait<L::kAhead - 1>();
    fence_proxy_async();
    __syncthreads();
    if (j + L::kAhead < kChunks)
      load(ring + ((j + L::kAhead) % L::kStages) * L::kStageBytes,
           j + L::kAhead);
    cp_async_commit();
    const uint32_t st = ring + (j % L::kStages) * L::kStageBytes;
    fence_acc(acc_a);
    fence_acc(acc_b);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < L::kKC / 16; ++k) {
      const uint64_t da = kmajor_desc(st + a_wg + k * 32);
      wgmma_m64<kN, 0, 1>(
          acc_a, da, mnmajor_desc(st + L::kABytes + k * 2048, L::kNBlock));
      wgmma_m64<kN, 0, 1>(
          acc_b, da,
          mnmajor_desc(st + L::kABytes + kN / 64 * L::kNBlock + k * 2048,
                       L::kNBlock));
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
}

// cp.async 64 K rows of a bf16 weight (rows `ld` elements apart from `src`)
// into the stage's B: its 2 kN columns are [a, a + kN) then [b, b + kN) of
// the source row.
template <int kN>
__device__ __forceinline__ void wide_load_b(uint32_t stage, const bf16* src,
                                            int ld, int a, int b) {
  using L = Wide;
  constexpr int kPieces = 2 * kN / 8;  // 16-byte pieces of a K row
#pragma unroll
  for (int i = 0; i < L::kKC * kPieces / L::kThreads; ++i) {
    const int p = threadIdx.x + i * L::kThreads;
    const int k = p / kPieces, n = (p % kPieces) * 8;
    const int col = n < kN ? a + n : b + n - kN;
    cp_async16(stage + L::kABytes + (n / 64) * L::kNBlock +
                   sw128_piece(k, (n % 64) / 8),
               src + static_cast<int64_t>(k) * ld + col);
  }
}

// x rounded to bf16, once a layer: the taps' operand of the gate kernel.
// A grid-stride loop over the float4 of x, a batch of loads in flight.
__global__ void __launch_bounds__(256)
wn_layer_kernel_round(const float* __restrict__ x, bf16* __restrict__ x_bf,
                      int64_t n4) {
  constexpr int kBatch = 8;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i0 = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
       i0 < n4; i0 += kBatch * stride) {
    float4 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int64_t i = i0 + u * stride;
      v[u] = i < n4 ? reinterpret_cast<const float4*>(x)[i]
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int64_t i = i0 + u * stride;
      if (i < n4)
        reinterpret_cast<uint2*>(x_bf)[i] =
            make_uint2(pack_bf16(v[u].x, v[u].y), pack_bf16(v[u].z, v[u].w));
    }
  }
}

// The gate at C = 512 and kG gate channels: unit u = (tile u / P of 128
// flat rows, pass u % P of kPW channels), P = kG / kPW; the block walks
// units blockIdx.x + k * gridDim.x. pre = the three taps of bf16 x (rows t
// + (tap-1)*d of the row's own sequence, zero outside [0, T)) @ w_in [3C, 2
// kG] at the pass's tanh columns (acc_a) and sigmoid columns (acc_b), K =
// 3C in chunks of (tap, 64 channels); then the gate in f32 on the
// accumulators (cond [B*T, 2 kG], b_in [2 kG]), the acts rounded to bf16
// into `acts` [B*T, kG].
template <int kG>
__device__ __forceinline__ void gate_rounded_x(const bf16* __restrict__ x_bf,
                                               const bf16* __restrict__ cond,
                                               const bf16* __restrict__ w_in,
                                               const float* __restrict__ b_in,
                                               bf16* __restrict__ acts,
                                               int total_rows, int T,
                                               int dilation) {
  using L = Wide;
  using P = WideGate<kG>;
  constexpr int C = L::kC;
  constexpr int kPW = P::kPW;
  constexpr int kAccN = kPW / 2;  // f32 accumulators a thread, each half
  extern __shared__ __align__(1024) uint4 smem_wide[];
  const uint32_t ring = smem_u32(smem_wide);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r16 = warp * 16;  // the warp's rows of the unit (both groups)
  const int g = lane / 4, tig = lane % 4;
  const int q = threadIdx.x % 8;
  const int units = (total_rows + L::kTile - 1) / L::kTile * P::kPasses;

#pragma unroll 1
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int p = u % P::kPasses;
    const int r0 = u / P::kPasses * L::kTile;
    const int rows = min(L::kTile, total_rows - r0);
    // this thread's A rows tid / 8 + 32i: flat row, and time in its
    // sequence (far negative past the last row)
    int64_t fr[4];
    int tt[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = threadIdx.x / 8 + 32 * i;
      fr[i] = r0 + r;
      tt[i] = r < rows ? r0 + r - (r0 + r) / T * T : -(1 << 30);
    }
    const auto load = [&](uint32_t stage, int j) {
      const int tap = j / (C / L::kKC), cb = (j % (C / L::kKC)) * L::kKC;
      const int shift = (tap - 1) * dilation;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = tt[i] + shift;
        const bool ok = s >= 0 && s < T;
        cp_async16_zfill(
            stage + sw128_piece(threadIdx.x / 8 + 32 * i, q),
            x_bf + (ok ? (fr[i] + shift) * C + cb + q * 8 : 0), ok);
      }
      wide_load_b<kPW>(stage,
                       w_in + static_cast<int64_t>(tap * C + cb) * 2 * kG,
                       2 * kG, kPW * p, kG + kPW * p);
    };
    // cond's rows of the pass's channels (both halves), into L2 under the
    // products: kLines 128-byte lines of each half a row
    constexpr int kLines = kPW * 2 / 128;
    for (int i = threadIdx.x; i < rows * 2 * kLines; i += L::kThreads)
      prefetch_l2(cond +
                  (r0 + i / (2 * kLines)) * static_cast<int64_t>(2 * kG) +
                  (i % (2 * kLines) / kLines) * kG + kPW * p +
                  (i % kLines) * 64);
    float acc_a[kAccN], acc_b[kAccN];
#pragma unroll
    for (int i = 0; i < kAccN; ++i) acc_a[i] = acc_b[i] = 0.f;
    __syncthreads();  // the previous unit is done with the ring
    wide_products<L::kGateChunks, kPW>(ring, acc_a, acc_b, load);

    // ---- the gate (f32) on the accumulators, acts to global as bf16 ----
    // cond of kBatch n8 blocks is loaded before any is used
    constexpr int kBatch = 4;
#pragma unroll
    for (int j0 = 0; j0 < kAccN / 4; j0 += kBatch) {
      uint32_t cv[kBatch][2][2];  // [n8][h][tanh, sigmoid] bf16 pairs
#pragma unroll
      for (int jj = 0; jj < kBatch; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r16 + g + 8 * h;
          const bf16* cr =
              cond + static_cast<int64_t>(r0 + min(row, rows - 1)) * 2 * kG +
              kPW * p + 8 * (j0 + jj) + 2 * tig;
          cv[jj][h][0] = *reinterpret_cast<const uint32_t*>(cr);
          cv[jj][h][1] = *reinterpret_cast<const uint32_t*>(cr + kG);
        }
#pragma unroll
      for (int jj = 0; jj < kBatch; ++jj) {
        const int j = j0 + jj;
        const int ch = kPW * p + 8 * j + 2 * tig;
        const float2 bt = *reinterpret_cast<const float2*>(b_in + ch);
        const float2 bs = *reinterpret_cast<const float2*>(b_in + kG + ch);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r16 + g + 8 * h;
          if (row >= rows) continue;
          const int64_t f = r0 + row;
          const float2 ct = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&cv[jj][h][0]));
          const float2 cs = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&cv[jj][h][1]));
          const float gt0 = acc_a[4 * j + 2 * h] + bt.x + ct.x;
          const float gt1 = acc_a[4 * j + 2 * h + 1] + bt.y + ct.y;
          const float gs0 = acc_b[4 * j + 2 * h] + bs.x + cs.x;
          const float gs1 = acc_b[4 * j + 2 * h + 1] + bs.y + cs.y;
          const float v0 = tanhf(gt0) * (1.f / (1.f + expf(-gs0)));
          const float v1 = tanhf(gt1) * (1.f / (1.f + expf(-gs1)));
          *reinterpret_cast<uint32_t*>(acts + f * kG + ch) =
              pack_bf16(v0, v1);
        }
      }
    }
  }
}

// An n8 block of m64 accumulators d[0..3] (row g: columns 2 tig, 2 tig +
// 1; row g + 8: the same) as 4 adjacent columns of one row: lanes tig and
// tig ^ 1 swap halves (one shuffle each), the even lane returning row g's
// columns 4 (tig / 2) + [0, 4), the odd lane row g + 8's. All lanes call.
__device__ __forceinline__ float4 swap_halves(const float* d, bool odd) {
  const float s0 = __shfl_xor_sync(0xffffffffu, odd ? d[0] : d[2], 1);
  const float s1 = __shfl_xor_sync(0xffffffffu, odd ? d[1] : d[3], 1);
  return odd ? make_float4(s0, s1, d[2], d[3])
             : make_float4(d[0], d[1], s0, s1);
}

// A rank's partial, acc_a's kH columns from col_a and acc_b's from col_b,
// into rows [r0, r0 + 128) of `out` [B*T, kNrs] (rows < r0 + rows only):
// 16 bytes a store, lanes tig and tig ^ 1 swapping halves (swap_halves).
template <int kH, int kNrs>
__device__ __forceinline__ void store_partial(float* __restrict__ out,
                                              const float (&acc_a)[kH / 2],
                                              const float (&acc_b)[kH / 2],
                                              int r0, int rows, int col_a,
                                              int col_b) {
  const int lane = threadIdx.x % 32, tig = lane % 4;
  const bool odd = tig & 1;
  const int row = (threadIdx.x / 32) * 16 + lane / 4 + (odd ? 8 : 0);
  float* o = out + (r0 + row) * static_cast<int64_t>(kNrs) + 4 * (tig / 2);
#pragma unroll
  for (int j = 0; j < kH / 8; ++j) {
    const float4 va = swap_halves(acc_a + 4 * j, odd);
    const float4 vb = swap_halves(acc_b + 4 * j, odd);
    if (row < rows) {
      *reinterpret_cast<float4*>(o + col_a + 8 * j) = va;
      *reinterpret_cast<float4*>(o + col_b + 8 * j) = vb;
    }
  }
}

// The res/skip product of acts [B*T, kK] at width kC (kK: C for the C =
// 512 layer, C' for a rank at C = 512 or at (256, 128)) and its epilogue:
// unit u = (tile u / P of 128 flat rows, pass u % P of 2 kH = 256
// columns), P = n_rs / 256 (WideRs). A non-last
// layer's pass p pairs the residual columns [kH p, +kH) (acc_a) with the
// skip columns [C + kH p, +kH) (acc_b); the last layer's, skip columns [2
// kH p, +kH) and [2 kH p + kH, +kH). The layer's epilogue: x' = x + res +
// b_rs (x on the last layer) into `out`, zero at rows t >= valid_t[b];
// skip = rs + b_rs, plus the sum when accumulating. A rank's (kK < C): the
// f32 partial rs as it is into `out` [B*T, n_rs] (x, b_rs, valid_t and
// skip_out unused). f32, rows < total_rows only.
template <int kC, int kK, bool kLast>
__global__ void __launch_bounds__(256, 1)
wn_layer_kernel_rs(const float* __restrict__ x, const bf16* __restrict__ acts,
                   const bf16* __restrict__ w_rs,
                   const float* __restrict__ b_rs,
                   const int* __restrict__ valid_t, float* __restrict__ out,
                   float* skip_out, int accumulate, int total_rows, int T) {
  using L = Wide;
  using R = WideRs<kC, kLast>;
  constexpr int C = kC;
  constexpr int N_RS = R::kNrs;
  constexpr int kH = R::kH;
  constexpr int kPasses = R::kPasses;
  constexpr int kAccN = kH / 2;  // f32 accumulators a thread, each half
  constexpr bool kPartial = kK < C;  // a rank's share
  static_assert(kH == 128 && kK % L::kKC == 0 && (kPartial || C == L::kC),
                "256-column passes of 64-deep chunks; the whole layer at "
                "512 only");
  extern __shared__ __align__(1024) uint4 smem_wide[];
  const uint32_t ring = smem_u32(smem_wide);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r16 = warp * 16;
  const int g = lane / 4, tig = lane % 4;
  const int q = threadIdx.x % 8;
  const int units = (total_rows + L::kTile - 1) / L::kTile * kPasses;

#pragma unroll 1
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int p = u % kPasses;
    const int r0 = u / kPasses * L::kTile;
    const int rows = min(L::kTile, total_rows - r0);
    const int col_a = kLast ? 2 * kH * p : kH * p;           // acc_a's columns
    const int col_b = kLast ? 2 * kH * p + kH : C + kH * p;  // acc_b's
    const auto load = [&](uint32_t stage, int j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = threadIdx.x / 8 + 32 * i;
        const bool ok = r < rows;
        cp_async16_zfill(stage + sw128_piece(r, q),
                         acts + (ok ? static_cast<int64_t>(r0 + r) * kK +
                                          j * L::kKC + q * 8
                                    : 0),
                         ok);
      }
      wide_load_b<kH>(stage, w_rs + static_cast<int64_t>(j) * L::kKC * N_RS,
                      N_RS, col_a, col_b);
    };
    if constexpr (!kPartial) {
      // the epilogue's rows of x and of the skip sum, into L2 under the
      // products: the unit's 128 (last layer: 256) channels of each row
      constexpr int kLines = (kLast ? 2 * kH : kH) * 4 / 128;  // 128-byte lines
      for (int i = threadIdx.x; i < rows * kLines; i += L::kThreads) {
        const int64_t off = (r0 + i / kLines) * static_cast<int64_t>(C) +
                            col_a + (i % kLines) * 32;
        prefetch_l2(x + off);
        if (accumulate) prefetch_l2(skip_out + off);
      }
    }
    float acc_a[kAccN], acc_b[kAccN];
#pragma unroll
    for (int i = 0; i < kAccN; ++i) acc_a[i] = acc_b[i] = 0.f;
    __syncthreads();  // the previous unit is done with the ring
    wide_products<kK / L::kKC, kH>(ring, acc_a, acc_b, load);

    if constexpr (kPartial) {
      // ---- a rank's epilogue: the partial's 2 kH columns as they are
      store_partial<kH, N_RS>(out, acc_a, acc_b, r0, rows, col_a, col_b);
    } else {
      // ---- the layer's epilogue: residual, valid_t mask, skip sum (f32)
      // The x and skip-sum values of kBatch n8 blocks are loaded before any
      // is used: one wait on memory (L2, prefetched) a batch, not a value.
      constexpr int kBatch = 4;
      constexpr int kE = kLast ? 2 : 1;  // channel pairs a thread writes
                                         // an n8
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r16 + g + 8 * h;
        if (row >= rows) continue;
        const int64_t f = r0 + row;
        const int b = static_cast<int>(f / T);
        const bool keep = valid_t == nullptr ||
                          static_cast<int>(f - static_cast<int64_t>(b) * T) <
                              valid_t[b];
#pragma unroll
        for (int j0 = 0; j0 < kAccN / 4; j0 += kBatch) {
          // (channel, skip value) pairs: the last layer's two skip channels,
          // or the residual's channel with its skip
          float2 xo[kBatch][kE], prev[kBatch][kE];
#pragma unroll
          for (int jj = 0; jj < kBatch; ++jj)
#pragma unroll
            for (int e = 0; e < kE; ++e) {
              const int64_t off =
                  f * C + col_a + 8 * (j0 + jj) + 2 * tig + kH * e;
              xo[jj][e] = *reinterpret_cast<const float2*>(x + off);
              prev[jj][e] = make_float2(0.f, 0.f);
              if (accumulate)
                prev[jj][e] =
                    *reinterpret_cast<const float2*>(skip_out + off);
            }
#pragma unroll
          for (int jj = 0; jj < kBatch; ++jj) {
            const int j = j0 + jj;
            const int ca = col_a + 8 * j + 2 * tig;  // acc_a's channel pair
            const float2 ba = *reinterpret_cast<const float2*>(b_rs + ca);
            const float2 bb =
                *reinterpret_cast<const float2*>(b_rs + ca + (col_b - col_a));
            const float2 ra = make_float2(acc_a[4 * j + 2 * h] + ba.x,
                                          acc_a[4 * j + 2 * h + 1] + ba.y);
            const float2 rb = make_float2(acc_b[4 * j + 2 * h] + bb.x,
                                          acc_b[4 * j + 2 * h + 1] + bb.y);
            float2 skip[kE];
            if constexpr (kLast) {
              skip[0] = ra;
              skip[kE - 1] = rb;
            } else {
              xo[jj][0].x += ra.x;
              xo[jj][0].y += ra.y;
              skip[0] = rb;
            }
#pragma unroll
            for (int e = 0; e < kE; ++e) {
              const int64_t off = f * C + ca + kH * e;
              *reinterpret_cast<float2*>(out + off) =
                  keep ? xo[jj][e] : make_float2(0.f, 0.f);
              *reinterpret_cast<float2*>(skip_out + off) = make_float2(
                  skip[e].x + prev[jj][e].x, skip[e].y + prev[jj][e].y);
            }
          }
        }
      }
    }
  }
}

// ---- a model rank's share at C <= 256: the gate on the f32 taps ---------

// A rank's share at width kC <= 256 and kG = C' <= 128 gate channels. One
// pass covers every gate channel (N = 2 kG <= 256), so each tap row feeds
// one pass only: the kernel reads the f32 x tap rows itself and rounds
// them to bf16 as its A operand, and no rounding kernel runs (at C = 512
// four passes share one rounding). A unit is 128 flat rows (two
// warpgroups of 64): the gate, K = 3C in chunks of (64-channel block,
// tap), the three taps of a block side by side, so a block's x rows are
// read from L2 three times in a row. Shared memory: two bf16 A slots [128
// rows][64] K-major (gate chunk j in slot j % 2); a ring of kStages weight
// stages [64 K][kNg] MN-major, w_in_s's tanh then sigmoid columns as they
// lie, zero-filled past 2 kG (kNg = max(64, 2 kG): the swizzle's 64-column
// block); kAhead f32 A chunks [128][64] that the tap copies land in (the
// rank backward's rows kernel's design, wn_layer_bwd.cu); and, where it
// fits (kFused: every pair but (256, 128)), all of w_rs_s [kG][n_rs],
// copied once a block, MN-major in 64-column blocks of kG K rows. There
// one kernel does the whole share (wn_layer_kernel_rank): the acts,
// rounded to bf16, go into the A slots (K-major, channel c in slot c /
// 64), and each res/skip pass of 2 kH partial columns is kG / 16 wgmma
// steps from shared memory alone, stored from the accumulators: no acts
// in global memory, one launch. At (256, 128) w_rs_s (128 KB) does not fit
// beside the gate's 224 KB, and streaming it through the ring would hold
// the gate's 128 accumulators and the res/skip product's state in one
// kernel of at most 255 registers: there the gate kernel writes the acts
// [B*T, C'] and wn_layer_kernel_rs follows.
template <int kC, int kG>
struct RankGate {
  using L = Wide;
  static constexpr int kNg = 2 * kG < 64 ? 64 : 2 * kG;  // the gate's N
  static constexpr int kChunks = 3 * kC / L::kKC;        // the gate's
  static constexpr int kBBytes = L::kKC * kNg * 2;
  static constexpr int kF32Bytes = L::kTile * L::kKC * 4;  // 32,768
  static constexpr int kRingOff = 2 * L::kABytes;
  // chunks in flight under the wgmmas: 2, as at C = 512
  static constexpr int kAhead = L::kAhead;
  static constexpr int kStages = L::kStages;
  static constexpr int kF32Off = kRingOff + kStages * kBBytes;
  static constexpr int kWrsOff = kF32Off + kAhead * kF32Bytes;
  static constexpr int kWrsBlock = kG * 128;  // 64 partial columns of w_rs_s
  // the res/skip product in this kernel when w_rs_s [kG][2 kC] fits
  static constexpr bool kFused = kWrsOff + kG * 2 * kC * 2 <= 232448;
  static constexpr int kSmem = kWrsOff + (kFused ? kG * 2 * kC * 2 : 0);
  static_assert(kC <= 256 && kG % 16 == 0 && kNg <= 256, "one pass");
  static_assert(kBBytes % 1024 == 0 && kWrsBlock % 1024 == 0,
                "swizzled tiles 1024-byte aligned");
  static_assert(kSmem <= 232448, "over the 227 KB a block may use");
};

// A rank at C <= 256: unit u is the flat rows [128u, 128u + 128); the block
// walks units blockIdx.x + k * gridDim.x. pre = the three taps of x (rows
// t + (tap-1)*d of the row's own sequence, zero outside [0, T)), rounded
// to bf16, @ w_in [3C, 2 kG]: the tanh pre-activation of channel c in
// accumulator column c, the sigmoid one in column kG + c, both in the same
// thread; then the gate in f32 on them (cond [B*T, 2 kG], b_in [2 kG]),
// the acts rounded to bf16: into the A slots, then partial = acts @ w_rs
// [kG, n_rs] into `out` [B*T, n_rs] f32, rows < B*T only (kFused); or
// into `acts` [B*T, kG] for wn_layer_kernel_rs.
//
// The ring runs on across units: chunk j of a unit is sequence position
// base + j, its weights in stage (base + j) % kStages, and the next unit's
// first kAhead chunks load under this unit's last steps, its gate and its
// res/skip product (its rows begun once every copy of this unit's taps is
// out). Step j: chunk j's A, rounded, sits in A slot j % 2. Start chunk j
// + kAhead's copies (weights into the stage chunk j - 2 left, this
// thread's f32 share of its taps into the f32 chunk j left), run chunk j's
// wgmmas, then wait for chunk j + 1's copies and, once this warpgroup's
// wgmmas of chunk j - 1 (the A slot's last reader) are done, round this
// thread's share of chunk j + 1 into the other A slot. A thread copies and
// rounds the same pieces (rows rb + 8i of its warpgroup's 64, columns c4 +
// [0, 4)), so it reads back only its own copies, and a warpgroup writes
// only its own rows of an A slot.
template <int kC, int kG, bool kLast>
__device__ __forceinline__ void rank_body(const float* __restrict__ x,
                                          const bf16* __restrict__ cond,
                                          const bf16* __restrict__ w_in,
                                          const float* __restrict__ b_in,
                                          const bf16* __restrict__ w_rs,
                                          bf16* __restrict__ acts,
                                          float* __restrict__ out,
                                          int total_rows, int T,
                                          int dilation) {
  using L = Wide;
  using S = RankGate<kC, kG>;
  using R = WideRs<kC, kLast>;
  constexpr int kNg = S::kNg;
  constexpr int kNB = kG / 8;  // n8 blocks of each half
  constexpr int kH = R::kH;  // a res/skip pass: 2 kH partial columns
  extern __shared__ __align__(1024) uint4 smem_wide[];
  char* base = reinterpret_cast<char*>(smem_wide);
  const uint32_t smem = smem_u32(base);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r16 = warp * 16;  // the warp's rows of the unit (both groups)
  const int g = lane / 4, tig = lane % 4;
  const int wg = threadIdx.x / 128, lt = threadIdx.x % 128;
  const int rb = wg * 64 + lt / 16;  // this thread's A rows: rb + 8i
  const int c4 = (lt % 16) * 4;      // and columns c4 + [0, 4)
  const uint32_t a_wg = wg * (L::kABytes / 2);
  const int units = (total_rows + L::kTile - 1) / L::kTile;
  if (static_cast<int>(blockIdx.x) >= units) return;

  if constexpr (S::kFused) {
    // w_rs_s once a block, into the first commit group (with chunk 0)
    constexpr int kPer = R::kNrs / 8;  // 16-byte pieces of a K row
    static_assert(kG * kPer % L::kThreads == 0, "whole rounds");
#pragma unroll
    for (int i = 0; i < kG * kPer / L::kThreads; ++i) {
      const int p = threadIdx.x + i * L::kThreads;
      const int k = p / kPer, n = (p % kPer) * 8;
      cp_async16(smem + S::kWrsOff + (n / 64) * S::kWrsBlock +
                     sw128_piece(k, (n % 64) / 8),
                 w_rs + k * R::kNrs + n);
    }
  }

  int r0 = 0, rows = 0;
  int tt[8];  // row rb + 8i's time in its sequence (far negative past rows)
  const auto begin = [&](int u) {
    r0 = u * L::kTile;
    rows = min(L::kTile, total_rows - r0);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = rb + 8 * i;
      tt[i] = r < rows ? (r0 + r) % T : -(1 << 30);
    }
  };
  int seq = 0;  // sequence position of the current unit's chunk 0
  bool next = true;  // a unit follows the current one (set at its begin)
  // the copies of chunk s of the current unit (s >= kChunks: chunk s -
  // kChunks of the next one, whose rows are begun), as one commit group;
  // empty when there is no such chunk
  const auto load = [&](int s) {
    const uint32_t stage =
        smem + S::kRingOff + ((seq + s) % S::kStages) * S::kBBytes;
    const int j = s < S::kChunks ? s : s - S::kChunks;
    if (s < S::kChunks || next) {
      // this thread's f32 taps and its weight copies
      const int tap = j % 3, cb = (j / 3) * L::kKC;
      const int shift = (tap - 1) * dilation;
      const uint32_t f32s = smem + S::kF32Off + (j % S::kAhead) * S::kF32Bytes;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = rb + 8 * i;
        const int t = tt[i] + shift;
        const bool ok = t >= 0 && t < T;
        cp_async16_zfill(
            f32s + (r * L::kKC + c4) * 4,
            x + (ok ? static_cast<int64_t>(r0 + r + shift) * kC + cb + c4 : 0),
            ok);
      }
      constexpr int kPer = kNg / 8;  // 16-byte pieces of a K row
      static_assert(L::kKC * kPer % L::kThreads == 0, "whole rounds");
#pragma unroll
      for (int i = 0; i < L::kKC * kPer / L::kThreads; ++i) {
        const int p = threadIdx.x + i * L::kThreads;
        const int k = p / kPer, n = (p % kPer) * 8;
        const bool live = n < 2 * kG;
        cp_async16_zfill(
            stage + (n / 64) * L::kNBlock + sw128_piece(k, (n % 64) / 8),
            w_in + static_cast<int64_t>(tap * kC + cb + k) * 2 * kG +
                (live ? n : 0),
            live);
      }
    }
    cp_async_commit();
  };
  // this thread's share of chunk j, from its f32 slot to bf16 in A slot j % 2
  const auto to_bf16 = [&](int j) {
    const char* f32s = base + S::kF32Off + (j % S::kAhead) * S::kF32Bytes;
    char* slot = base + (j % 2) * L::kABytes;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = rb + 8 * i;
      const float4 v =
          *reinterpret_cast<const float4*>(f32s + (r * L::kKC + c4) * 4);
      *reinterpret_cast<uint2*>(slot + sw128_piece(r, c4 / 8) +
                                (c4 % 8) * 2) =
          make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
    }
  };
  // the loads of step s (chunk s + kAhead), beginning the next unit's rows
  // where its first chunk is reached
  const auto load_ahead = [&](int s, int u) {
    if (s + S::kAhead == S::kChunks) {
      next = u + static_cast<int>(gridDim.x) < units;
      if (next) begin(u + gridDim.x);
    }
    load(s + S::kAhead);
  };

  begin(blockIdx.x);
  for (int c = 0; c < S::kAhead; ++c) load(c);
#pragma unroll 1
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int u0 = r0, n = rows;  // this unit's (begin moves on below)
    {
      // cond's rows of the unit into L2 under the products
      const char* src = reinterpret_cast<const char*>(
          cond + static_cast<int64_t>(u0) * 2 * kG);
      const int lines = (n * 4 * kG + 127) / 128;
      for (int i = threadIdx.x; i < lines; i += L::kThreads)
        prefetch_l2(src + i * 128);
    }
    float acc[kNg / 2];
#pragma unroll
    for (int i = 0; i < kNg / 2; ++i) acc[i] = 0.f;
    cp_async_wait<S::kAhead - 1>();  // this thread's copies of chunk 0
    to_bf16(0);
#pragma unroll 1
    for (int j = 0; j < S::kChunks; ++j) {
      fence_proxy_async();
      __syncthreads();
      load_ahead(j, u);
      const uint32_t a0 = smem + (j % 2) * L::kABytes + a_wg;
      const uint32_t b0 =
          smem + S::kRingOff + ((seq + j) % S::kStages) * S::kBBytes;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < L::kKC / 16; ++k)
        wgmma_m64<kNg, 0, 1>(acc, kmajor_desc(a0 + k * 32),
                             mnmajor_desc(b0 + k * 2048, L::kNBlock));
      wgmma_commit();
      if (j + 1 < S::kChunks) {
        cp_async_wait<S::kAhead - 1>();
        wgmma_wait<1>();
        fence_acc(acc);
        to_bf16(j + 1);
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);

    // ---- the gate (f32) on the accumulators, the acts as bf16 (fused:
    // into this warpgroup's rows of the A slots, its gate wgmmas done) ----
    // cond of kBatch n8 blocks is loaded before any is used; rows past the
    // unit's end (zero taps, a kept row's cond) give finite acts that no
    // stored row reads
    constexpr int kBatch = kNB < 4 ? kNB : 4;
#pragma unroll
    for (int j0 = 0; j0 < kNB; j0 += kBatch) {
      uint32_t cv[kBatch][2][2];  // [n8][h][tanh, sigmoid] bf16 pairs
#pragma unroll
      for (int jj = 0; jj < kBatch; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r16 + g + 8 * h;
          const bf16* cr = cond +
                           static_cast<int64_t>(u0 + min(row, n - 1)) * 2 * kG +
                           8 * (j0 + jj) + 2 * tig;
          cv[jj][h][0] = *reinterpret_cast<const uint32_t*>(cr);
          cv[jj][h][1] = *reinterpret_cast<const uint32_t*>(cr + kG);
        }
#pragma unroll
      for (int jj = 0; jj < kBatch; ++jj) {
        const int j = j0 + jj;
        const int ch = 8 * j + 2 * tig;
        const float2 bt = *reinterpret_cast<const float2*>(b_in + ch);
        const float2 bs = *reinterpret_cast<const float2*>(b_in + kG + ch);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r16 + g + 8 * h;
          if (!S::kFused && row >= n) continue;
          const float2 ct = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&cv[jj][h][0]));
          const float2 cs = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&cv[jj][h][1]));
          const float gt0 = acc[4 * j + 2 * h] + bt.x + ct.x;
          const float gt1 = acc[4 * j + 2 * h + 1] + bt.y + ct.y;
          const float gs0 = acc[4 * (j + kNB) + 2 * h] + bs.x + cs.x;
          const float gs1 = acc[4 * (j + kNB) + 2 * h + 1] + bs.y + cs.y;
          const float v0 = tanhf(gt0) * (1.f / (1.f + expf(-gs0)));
          const float v1 = tanhf(gt1) * (1.f / (1.f + expf(-gs1)));
          if constexpr (S::kFused)
            *reinterpret_cast<uint32_t*>(base + (ch / 64) * L::kABytes +
                                         sw128_piece(row, (ch % 64) / 8) +
                                         (ch % 8) * 2) = pack_bf16(v0, v1);
          else
            *reinterpret_cast<uint32_t*>(
                acts + static_cast<int64_t>(u0 + row) * kG + ch) =
                pack_bf16(v0, v1);
        }
      }
    }

    if constexpr (S::kFused) {
      // ---- the res/skip product: acts (A slots) @ w_rs_s (resident) ----
      // pass p of 2 kH partial columns: acc_a's from col_a, acc_b's from
      // col_b (the rs kernel's pairing); kG / 16 k16 steps
      fence_proxy_async();
      __syncthreads();  // the acts are in the A slots
      const uint32_t wrs = smem + S::kWrsOff;
#pragma unroll 1
      for (int p = 0; p < R::kPasses; ++p) {
        const int col_a = kLast ? 2 * kH * p : kH * p;
        const int col_b = kLast ? 2 * kH * p + kH : kC + kH * p;
        float acc_a[kH / 2], acc_b[kH / 2];
#pragma unroll
        for (int i = 0; i < kH / 2; ++i) acc_a[i] = acc_b[i] = 0.f;
        fence_acc(acc_a);
        fence_acc(acc_b);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < kG / 16; ++k) {
          const uint64_t da = kmajor_desc(smem + (k / 4) * L::kABytes + a_wg +
                                          (k % 4) * 32);
          wgmma_m64<kH, 0, 1>(
              acc_a, da,
              mnmajor_desc(wrs + (col_a / 64) * S::kWrsBlock + k * 2048,
                           S::kWrsBlock));
          wgmma_m64<kH, 0, 1>(
              acc_b, da,
              mnmajor_desc(wrs + (col_b / 64) * S::kWrsBlock + k * 2048,
                           S::kWrsBlock));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(acc_a);
        fence_acc(acc_b);
        store_partial<kH, R::kNrs>(out, acc_a, acc_b, u0, n, col_a, col_b);
      }
    }
    seq += S::kChunks;
  }
  cp_async_wait<0>();
}

// The gate kernel of the bf16 forward at width kC and gate width kG: the C
// = 512 layer's (kG = 512) and a rank's there (kG = C') on the rounded x
// (gate_rounded_x); a rank's at (256, 128) on the f32 x (rank_body), the
// acts to `acts` for wn_layer_kernel_rs.
template <int kC, int kG>
__global__ void __launch_bounds__(256, 1)
wn_layer_kernel_gate(const void* __restrict__ x, const bf16* __restrict__ cond,
                     const bf16* __restrict__ w_in,
                     const float* __restrict__ b_in, bf16* __restrict__ acts,
                     int total_rows, int T, int dilation) {
  if constexpr (kC == Wide::kC)
    gate_rounded_x<kG>(static_cast<const bf16*>(x), cond, w_in, b_in, acts,
                       total_rows, T, dilation);
  else
    rank_body<kC, kG, false>(static_cast<const float*>(x), cond, w_in, b_in,
                             nullptr, acts, nullptr, total_rows, T,
                             dilation);
}

// A rank's whole bf16 share below C = 512 where w_rs_s fits beside the gate
// (RankGate::kFused): the gate on the f32 x, then the res/skip product
// storing the f32 partial `out` [B*T, n_rs], one kernel.
template <int kC, int kG, bool kLast>
__global__ void __launch_bounds__(256, 1)
wn_layer_kernel_rank(const float* __restrict__ x,
                     const bf16* __restrict__ cond,
                     const bf16* __restrict__ w_in,
                     const float* __restrict__ b_in,
                     const bf16* __restrict__ w_rs, float* __restrict__ out,
                     int total_rows, int T, int dilation) {
  rank_body<kC, kG, kLast>(x, cond, w_in, b_in, w_rs, nullptr, out,
                           total_rows, T, dilation);
}

// Whether a bf16 call at (kC, kG) is a rank's one kernel
// (wn_layer_kernel_rank) rather than the gate and res/skip kernels.
template <int kC, int kG>
constexpr bool rank_fused() {
  if constexpr (kC == Wide::kC) return false;
  else return RankGate<kC, kG>::kFused;
}

// The dynamic shared bytes of the gate (or rank) kernel and its passes of
// a 128-row tile.
template <int kC, int kG>
constexpr int gate_smem() {
  if constexpr (kC == Wide::kC) return Wide::kSmem;
  else return RankGate<kC, kG>::kSmem;
}

template <int kC, int kG>
constexpr int gate_passes() {
  if constexpr (kC == Wide::kC) return WideGate<kG>::kPasses;
  else return 1;
}

// The bf16 kernel at C <= 256 (C = 512 runs the three kernels above).
template <int kC, bool kLast>
__global__ void __launch_bounds__(Mma<kC>::kThreads, 1)
wn_layer_kernel_mma(const float* __restrict__ x, const bf16* __restrict__ cond,
                    const bf16* __restrict__ w_in,
                    const float* __restrict__ b_in,
                    const bf16* __restrict__ w_rs,
                    const float* __restrict__ b_rs,
                    const int* __restrict__ valid_t, float* __restrict__ x_out,
                    float* skip_out, int accumulate, int T, int dilation) {
  mma_resident<kC, kLast>(x, cond, w_in, b_in, w_rs, b_rs, valid_t, x_out,
                          skip_out, accumulate, T, dilation);
}

// ---- launch ---------------------------------------------------------------

// Blocks of the f32 kernel the device holds at once, as SMs and blocks an
// SM (the occupancy API, after the shared-memory opt-in); read once per
// variant and device. At C = 512: those of wn_layer_kernel_f32_tiles, whose
// grid the rest kernel shares (its opt-in is made here too).
template <int kC, bool kLast>
cudaError_t f32_slots(int* sms, int* per_sm) {
  static std::atomic<int> cache[32];
  static std::atomic<uint32_t> opted_in{0};
  if constexpr (kC > 256) {
    static std::atomic<uint32_t> rest_opted_in{0};
    cudaError_t err = opt_in_smem(wn_layer_kernel_f32_rest<kLast>,
                                  F32Rest::kSmemBytes, &rest_opted_in);
    if (err != cudaSuccess) return err;
    return wave_slots(wn_layer_kernel_f32_tiles<kLast>, F32Tiles::kThreads,
                      F32Tiles::kSmemBytes, cache, &opted_in, sms, per_sm);
  } else {
    return wave_slots(wn_layer_kernel_f32<kC, kLast>, F32<kC>::kThreads,
                      F32<kC>::kSmemBytes, cache, &opted_in, sms, per_sm);
  }
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
  // C = 512: in bf16 x_bf [B*T, C], then acts [B*T, C or C'], bf16; in
  // f32 acts [B*T, C] f32
  void* scratch;
  int accumulate, batch, T, dilation;
  cudaStream_t stream;
};

// Blocks of the bf16 gate kernel at (kC, kG), and of its res/skip kernel,
// or of the fused rank kernel, the device holds at once (one an SM: 139,264
// to 229,376 bytes of shared memory a block).
template <int kC, int kG, bool kLast>
cudaError_t wide_slots(int* slots) {
  static std::atomic<int> cache[2][32];
  static std::atomic<uint32_t> opted[2];
  int sms = 0, per_sm = 0;
  if constexpr (rank_fused<kC, kG>()) {
    cudaError_t err = wave_slots(wn_layer_kernel_rank<kC, kG, kLast>,
                                 Wide::kThreads, gate_smem<kC, kG>(),
                                 cache[0], &opted[0], &sms, &per_sm);
    *slots = sms * per_sm;
    return err;
  } else {
    cudaError_t err = wave_slots(wn_layer_kernel_gate<kC, kG>, Wide::kThreads,
                                 gate_smem<kC, kG>(), cache[0], &opted[0],
                                 &sms, &per_sm);
    if (err != cudaSuccess) return err;
    const int n = sms * per_sm;
    err = wave_slots(wn_layer_kernel_rs<kC, kG, kLast>, Wide::kThreads,
                     Wide::kSmem, cache[1], &opted[1], &sms, &per_sm);
    if (err != cudaSuccess) return err;
    *slots = std::min(n, sms * per_sm);
    return cudaSuccess;
  }
}

// The grid of the gate and res/skip kernels: their 128-row tiles of the
// B*T rows, and the blocks of each (one wave each: no more blocks than
// units, nor than `slots`; the fused rank kernel's as the gate's, rs_passes
// 0).
void wide_grid(int64_t rows, int gate_passes, int rs_passes, int slots,
               int* tiles, int* gate_blocks, int* rs_blocks) {
  *tiles = static_cast<int>((rows + Wide::kTile - 1) / Wide::kTile);
  *gate_blocks = std::min(*tiles * gate_passes, slots);
  *rs_blocks = std::min(*tiles * rs_passes, slots);
}

// The C = 512 bf16 layer (kC = kG = 512), a rank's share of it (kG = C'),
// or a rank's share at C <= 256 (`a`'s x_out is a rank's partial, its b_rs,
// valid_t and skip_out unused): at C = 512 x rounded, then the gate and
// res/skip kernels, the scratch holding the rounded x [B*T, C], then the
// acts [B*T, kG], bf16; at C <= 256 the fused rank kernel, no scratch,
// or at (256, 128) the gate kernel on the f32 x, then the res/skip kernel,
// the scratch holding the acts alone.
template <int kC, int kG, bool kLast>
cudaError_t launch_wide(const Args& a) {
  using L = Wide;
  constexpr bool kFused = rank_fused<kC, kG>();
  if (!kFused && a.scratch == nullptr) return cudaErrorInvalidValue;
  int slots = 0;
  cudaError_t err = wide_slots<kC, kG, kLast>(&slots);  // also opts in
  if (err != cudaSuccess) return err;
  const int64_t rows = static_cast<int64_t>(a.batch) * a.T;
  int tiles = 0, gate_blocks = 0, rs_blocks = 0;
  wide_grid(rows, gate_passes<kC, kG>(),
            kFused ? 0 : WideRs<kC, kLast>::kPasses, slots, &tiles,
            &gate_blocks, &rs_blocks);
  if constexpr (kFused) {
    wn_layer_kernel_rank<kC, kG, kLast>
        <<<gate_blocks, L::kThreads, gate_smem<kC, kG>(), a.stream>>>(
            a.x, static_cast<const bf16*>(a.cond),
            static_cast<const bf16*>(a.w_in), a.b_in,
            static_cast<const bf16*>(a.w_rs), a.x_out,
            static_cast<int>(rows), a.T, a.dilation);
    return cudaGetLastError();
  } else {
    // at C = 512 x rounded first, the gate's operand
    bf16* acts = static_cast<bf16*>(a.scratch);
    const void* taps = a.x;
    if constexpr (kC == L::kC) {
      taps = acts;
      acts += rows * kC;
      const int64_t n4 = rows * kC / 4;
      const int round_blocks = static_cast<int>(std::min<int64_t>(
          (n4 + 255) / 256, static_cast<int64_t>(slots) * 16));
      wn_layer_kernel_round<<<round_blocks, 256, 0, a.stream>>>(
          a.x, static_cast<bf16*>(a.scratch), n4);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    wn_layer_kernel_gate<kC, kG>
        <<<gate_blocks, L::kThreads, gate_smem<kC, kG>(), a.stream>>>(
            taps, static_cast<const bf16*>(a.cond),
            static_cast<const bf16*>(a.w_in), a.b_in, acts,
            static_cast<int>(rows), a.T, a.dilation);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    wn_layer_kernel_rs<kC, kG, kLast>
        <<<rs_blocks, L::kThreads, L::kSmem, a.stream>>>(
            a.x, acts, static_cast<const bf16*>(a.w_rs), a.b_rs, a.valid_t,
            a.x_out, a.skip_out, a.accumulate, static_cast<int>(rows), a.T);
    return cudaGetLastError();
  }
}

// f(std::integral_constant<int, C>{}, std::integral_constant<int, G>{}) at
// a built (C, G) of the gate and res/skip kernels: the C = 512 layer's (G
// = 512), or a rank's G = C' = C / model, model in {2, 4, 8}, at C = 128,
// 256, 512.
template <typename F>
cudaError_t with_gate_width(int c, int g, const F& f) {
  using std::integral_constant;
  switch (c * 1024 + g) {
    case 512 * 1024 + 512:
      return f(integral_constant<int, 512>{}, integral_constant<int, 512>{});
    case 512 * 1024 + 256:
      return f(integral_constant<int, 512>{}, integral_constant<int, 256>{});
    case 512 * 1024 + 128:
      return f(integral_constant<int, 512>{}, integral_constant<int, 128>{});
    case 512 * 1024 + 64:
      return f(integral_constant<int, 512>{}, integral_constant<int, 64>{});
    case 256 * 1024 + 128:
      return f(integral_constant<int, 256>{}, integral_constant<int, 128>{});
    case 256 * 1024 + 64:
      return f(integral_constant<int, 256>{}, integral_constant<int, 64>{});
    case 256 * 1024 + 32:
      return f(integral_constant<int, 256>{}, integral_constant<int, 32>{});
    case 128 * 1024 + 64:
      return f(integral_constant<int, 128>{}, integral_constant<int, 64>{});
    case 128 * 1024 + 32:
      return f(integral_constant<int, 128>{}, integral_constant<int, 32>{});
    case 128 * 1024 + 16:
      return f(integral_constant<int, 128>{}, integral_constant<int, 16>{});
    default: return cudaErrorInvalidValue;
  }
}

// The f32 layer at C = 512: the tiles kernel over every block's 96-row
// tiles, then, when a block has a rest of 48 rows or fewer, the rest kernel
// on the same grid. The scratch holds the acts [B*T, C] f32.
template <bool kLast>
cudaError_t launch_f32_wide(const Args& a) {
  if (a.scratch == nullptr) return cudaErrorInvalidValue;
  int sms = 0, per_sm = 0;
  cudaError_t err = f32_slots<Wide::kC, kLast>(&sms, &per_sm);  // opts in
  if (err != cudaSuccess) return err;
  const int rows = a.batch * a.T;
  const int per_block = one_wave_rows(rows, sms * per_sm, kRowQuantum);
  const int blocks = (rows + per_block - 1) / per_block;
  const auto cond = static_cast<const float*>(a.cond);
  const auto w_in = static_cast<const float*>(a.w_in);
  const auto w_rs = static_cast<const float*>(a.w_rs);
  const auto acts = static_cast<float*>(a.scratch);
  wn_layer_kernel_f32_tiles<kLast>
      <<<blocks, F32Tiles::kThreads, F32Tiles::kSmemBytes, a.stream>>>(
          a.x, cond, w_in, a.b_in, w_rs, a.b_rs, a.valid_t, a.x_out,
          a.skip_out, acts, a.accumulate, a.T, a.dilation, rows, per_block);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (f32_wide_rest(per_block) ||
      f32_wide_rest(rows - (blocks - 1) * per_block))
    wn_layer_kernel_f32_rest<kLast>
        <<<blocks, F32Rest::kThreads, F32Rest::kSmemBytes, a.stream>>>(
            a.x, cond, w_in, a.b_in, w_rs, a.b_rs, a.valid_t, a.x_out,
            a.skip_out, acts, a.accumulate, a.T, a.dilation, rows,
            per_block);
  return cudaGetLastError();
}

template <int kC, bool kBf16, bool kLast>
cudaError_t launch(const Args& a) {
  if constexpr (kBf16 && kC > 256) {
    return launch_wide<kC, kC, kLast>(a);
  } else if constexpr (kBf16) {
    static std::atomic<uint32_t> opted_in{0};
    auto kernel = wn_layer_kernel_mma<kC, kLast>;
    constexpr int smem = Mma<kC>::kSmemBytes;
    cudaError_t err = opt_in_smem(kernel, smem, &opted_in);
    if (err != cudaSuccess) return err;
    dim3 grid((a.T + kMmaRows - 1) / kMmaRows, a.batch);
    kernel<<<grid, Mma<kC>::kThreads, smem, a.stream>>>(
        a.x, static_cast<const bf16*>(a.cond), static_cast<const bf16*>(a.w_in),
        a.b_in, static_cast<const bf16*>(a.w_rs), a.b_rs, a.valid_t, a.x_out,
        a.skip_out, a.accumulate, a.T, a.dilation);
  } else if constexpr (kC > 256) {
    return launch_f32_wide<kLast>(a);
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
// function pointer and the dynamic shared bytes its launcher passes (at C =
// 512 in bf16, the res/skip kernel's, which ends the layer).
template <int kC>
cudaError_t dispatch_width(const Args* a, int bf16_mode, int last,
                           const void** kernel, int* smem_bytes) {
#define WN_CASE(BF, LAST, FN, SMEM)                                \
  if (a == nullptr) {                                              \
    *kernel = reinterpret_cast<const void*>(FN);                   \
    *smem_bytes = SMEM;                                            \
    return cudaSuccess;                                            \
  }                                                                \
  return launch<kC, BF, LAST>(*a)
  if constexpr (kC > 256) {
    if (bf16_mode) {
      if (last) {
        WN_CASE(true, true, (wn_layer_kernel_rs<kC, kC, true>), Wide::kSmem);
      }
      WN_CASE(true, false, (wn_layer_kernel_rs<kC, kC, false>), Wide::kSmem);
    }
  } else {
    if (bf16_mode) {
      if (last) {
        WN_CASE(true, true, (wn_layer_kernel_mma<kC, true>), Mma<kC>::kSmemBytes);
      }
      WN_CASE(true, false, (wn_layer_kernel_mma<kC, false>), Mma<kC>::kSmemBytes);
    }
  }
  if constexpr (kC > 256) {
    if (last) {
      WN_CASE(false, true, wn_layer_kernel_f32_tiles<true>,
              F32Tiles::kSmemBytes);
    }
    WN_CASE(false, false, wn_layer_kernel_f32_tiles<false>,
            F32Tiles::kSmemBytes);
  } else {
    if (last) {
      WN_CASE(false, true, (wn_layer_kernel_f32<kC, true>),
              F32<kC>::kSmemBytes);
    }
    WN_CASE(false, false, (wn_layer_kernel_f32<kC, false>),
            F32<kC>::kSmemBytes);
  }
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
// 256 or 512. scratch: at C = 512 in bf16, 2 * batch * T * C bf16 (the
// rounded x, then the acts), in f32 batch * T * C f32 (the acts), else
// unused. All pointers 16-byte aligned and
// contiguous. Launches on `stream` (C = 512 in bf16: three kernels), does
// not synchronise; returns the first launch error.
cudaError_t wn_layer_forward(const float* x, const void* cond,
                             const void* w_in, const float* b_in,
                             const void* w_rs, const float* b_rs,
                             const int* valid_t, float* x_out,
                             float* skip_out, void* scratch, int accumulate,
                             int batch, int T, int C, int dilation, int bf16,
                             int last, cudaStream_t stream) {
  if (T <= 0 || batch <= 0 || batch > 65535 ||
      static_cast<int64_t>(batch) * T > INT32_MAX - Wide::kTile)
    return cudaErrorInvalidValue;
  const Args a{x,        cond,     w_in,    b_in,       w_rs,  b_rs,
               valid_t,  x_out,    skip_out, scratch,   accumulate,
               batch,    T,        dilation, stream};
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

// What the loaded build of the f32 rest kernel at C = 512 (`last` its
// variant) uses, as wn_layer_kernel_info reports it (which reports the
// tiles kernel for (512, f32)).
cudaError_t wn_layer_f32_rest_kernel_info(int last, int* registers,
                                          int* local_bytes,
                                          int* static_smem_bytes,
                                          int* dynamic_smem_bytes) {
  const void* kernel =
      last ? reinterpret_cast<const void*>(wn_layer_kernel_f32_rest<true>)
           : reinterpret_cast<const void*>(wn_layer_kernel_f32_rest<false>);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  *registers = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *static_smem_bytes = static_cast<int>(attr.sharedSizeBytes);
  *dynamic_smem_bytes = F32Rest::kSmemBytes;
  return cudaSuccess;
}

// The f32 kernel's grid at width C for `batch` x T rows, as its launcher
// picks it: SMs, blocks an SM (occupancy API), blocks launched, rows a
// block takes (at C = 512 the grid of both its kernels).
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

// What the loaded build of one of the bf16 gate and res/skip kernels at
// width `c` and gate width `g` (the C = 512 layer's g = 512, or a rank's
// C') uses (which: 0 the gate kernel, 1 the res/skip kernel (`last` its
// variant), 2 the rounding of x, which only C = 512 runs, 3 the fused rank
// kernel (`last` its variant), which runs alone where it applies), as
// wn_layer_kernel_info reports it.
cudaError_t wn_layer_wide_kernel_info(int c, int which, int g, int last,
                                      int* registers, int* local_bytes,
                                      int* static_smem_bytes,
                                      int* dynamic_smem_bytes) {
  const void* kernel = nullptr;
  cudaError_t err = with_gate_width(c, g, [&](auto width, auto gates) {
    constexpr int kC = decltype(width)::value;
    constexpr int kG = decltype(gates)::value;
    if constexpr (rank_fused<kC, kG>()) {
      if (which != 3) return cudaErrorInvalidValue;
      kernel = last ? reinterpret_cast<const void*>(
                          wn_layer_kernel_rank<kC, kG, true>)
                    : reinterpret_cast<const void*>(
                          wn_layer_kernel_rank<kC, kG, false>);
      *dynamic_smem_bytes = gate_smem<kC, kG>();
      return cudaSuccess;
    } else {
      switch (which) {
        case 0:
          kernel =
              reinterpret_cast<const void*>(wn_layer_kernel_gate<kC, kG>);
          *dynamic_smem_bytes = gate_smem<kC, kG>();
          return cudaSuccess;
        case 1:
          kernel = last ? reinterpret_cast<const void*>(
                              wn_layer_kernel_rs<kC, kG, true>)
                        : reinterpret_cast<const void*>(
                              wn_layer_kernel_rs<kC, kG, false>);
          *dynamic_smem_bytes = Wide::kSmem;
          return cudaSuccess;
        case 2:
          if (kC != Wide::kC) return cudaErrorInvalidValue;
          kernel = reinterpret_cast<const void*>(wn_layer_kernel_round);
          *dynamic_smem_bytes = 0;
          return cudaSuccess;
        default: return cudaErrorInvalidValue;
      }
    }
  });
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  *registers = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *static_smem_bytes = static_cast<int>(attr.sharedSizeBytes);
  return cudaSuccess;
}

// The grid of the bf16 gate and res/skip kernels at width `c` and gate
// width `g` for `batch` x T rows, as the launcher picks it: the blocks of
// either kernel the device holds at once, the 128-row tiles, and the
// blocks of each kernel (where the fused rank kernel runs alone, its
// blocks, and 0 res/skip blocks).
cudaError_t wn_layer_wide_schedule(int c, int g, int batch, int T, int last,
                                   int* slots, int* tiles, int* gate_blocks,
                                   int* rs_blocks) {
  if (T <= 0 || batch <= 0 || static_cast<int64_t>(batch) * T > INT32_MAX)
    return cudaErrorInvalidValue;
  return with_gate_width(c, g, [&](auto width, auto gates) {
    constexpr int kC = decltype(width)::value;
    constexpr int kG = decltype(gates)::value;
    cudaError_t err = last ? wide_slots<kC, kG, true>(slots)
                           : wide_slots<kC, kG, false>(slots);
    if (err != cudaSuccess) return err;
    const int rs_passes =
        rank_fused<kC, kG>() ? 0
        : last               ? WideRs<kC, true>::kPasses
                             : WideRs<kC, false>::kPasses;
    wide_grid(static_cast<int64_t>(batch) * T, gate_passes<kC, kG>(),
              rs_passes, *slots, tiles, gate_blocks, rs_blocks);
    return cudaSuccess;
  });
}

// A model rank's share of the bf16 layer (wn_layer_shard.cu's contract and
// layouts: x [batch, T, c] f32, c in {128, 256, 512}, C' = cp = c / model,
// model in {2, 4, 8}; the partial `out` [batch, T, n_rs] f32): at c = 512
// the layer's three kernels at gate width C', at c <= 256 the fused rank
// kernel (at (256, 128) the gate kernel on the f32 x and the res/skip
// kernel), the last epilogue storing the partial. scratch: batch * T * (512 + cp) bf16 at c = 512 (the rounded x,
// then the acts), batch * T * cp bf16 at (256, 128) (the acts), none (null)
// where the fused rank kernel runs. Launches on `stream`, does not
// synchronise; returns the first launch error.
cudaError_t wn_layer_shard_wide_forward(const float* x, const void* cond,
                                        const void* w_in, const float* b_in,
                                        const void* w_rs, float* out,
                                        void* scratch, int batch, int T,
                                        int c, int cp, int dilation, int last,
                                        cudaStream_t stream) {
  if (T <= 0 || batch <= 0 ||
      static_cast<int64_t>(batch) * T > INT32_MAX - Wide::kTile || cp >= c)
    return cudaErrorInvalidValue;
  const Args a{x,       cond,    w_in,    b_in,    w_rs,  nullptr,
               nullptr, out,     nullptr, scratch, 0,     batch,
               T,       dilation, stream};
  return with_gate_width(c, cp, [&](auto width, auto gates) {
    constexpr int kC = decltype(width)::value;
    constexpr int kG = decltype(gates)::value;
    return last ? launch_wide<kC, kG, true>(a) : launch_wide<kC, kG, false>(a);
  });
}

}  // extern "C"
