// The bf16 backward of a WN layer, whole or one model rank's share of it
// (the trainable tensor-parallel shard), for Hopper (sm_90a), CUDA C++ with
// a plain C interface (bound from Python with ctypes, see
// kernels/wn_layer.py::wn_layer_backward_fused and
// ::wn_layer_shard_backward_fused).
//
// Replaces waveglow_tpu/kernels/wn_layer.py::_wn_layer_trainable_bwd, the
// backward of the custom VJP wn_layer_trainable (XLA code on the TPU, not a
// kernel there), and what GSPMD makes of it under a `model` mesh axis
// (waveglow_tpu/parallel/sharding.py:44-67 places the weights). A rank
// holds C' = C / model of the C gate channels; the whole layer is C' = C.
// Its forward (csrc/wn_layer.cu, or csrc/wn_layer_shard.cu for a rank)
// gives acts @ w_rs (the rank's partial). Given g, the cotangent of that
// product, both compute at these rounding points:
//
//   taps    = bf16(x) shifted by (tap-1)*d, zero outside [0, T)
//   gates   = taps @ w_in + b_in + cond           (f32 accumulation and adds)
//   t = tanh(gates[:C']), s = sigmoid(gates[C':]), acts = t * s     (f32)
//   dacts   = bf16(g) @ w_rs^T                    (f32 accumulation)
//   dgates  = [dacts*s*(1-t^2) | dacts*t*s*(1-s)]                   (f32)
//   dcond   = bf16(dgates)
//   db_in   = sum_rows dgates                     (f32, not its rounding)
//   dw_in   = bf16(taps^T @ bf16(dgates))         (f32 sums, then bf16)
//   dw_rs   = bf16(bf16(acts)^T @ bf16(g))
//   dx      = sum_tap shift(bf16(dgates) @ w_in[tap]^T, -(tap-1)*d)  (f32)
//
// The whole layer (C' = C) takes the output cotangents dx_next and dskip
// and builds g itself:
//
//   g (drs) = [dx_next masked at rows >= valid_t | dskip]  (last: dskip)
//   db_rs   = sum_rows drs                        (f32, not its rounding)
//   dx      = dx_next masked + the taps' adjoint above         (f32)
//
// A rank's dx is its partial, the taps' adjoint over its C' channels: the
// caller sums the ranks' dx in rank order and adds the residual's
// cotangent; b_rs, the residual and the skip stay outside, in autograd
// (models/wn.py::wn_forward_train_tp). Summed over the ranks, dx is the
// whole layer's taps' adjoint, and the ranks' dw_in, dw_rs, db_in and
// dcond concatenate to the whole layer's.
//
// Why bf16 product operands are faithful: none of the dots of
// _wn_layer_trainable_bwd passes precision=, and on the JAX package's own
// chip an f32 dot without it runs as one bf16 pass with f32 accumulation
// (waveglow_tpu/ops/conv.py, docs/ARCHITECTURE.md). Parity (f32) mode keeps
// true f32 products and does not use this file.
//
// Layouts, row-major: x [B, T, C] f32; cond [B, T, 2C'], w_in [3C, 2C']
// (tanh columns of the channels, then their sigmoid columns), w_rs [C',
// n_rs] bf16 (n_rs = 2C, or C for the last layer); b_in [2C'] f32; g, or
// dx_next and dskip, f32. Built for C in {128, 256, 512}: the whole layer,
// and a rank at every pair of the forward shard kernel, C' = C / model,
// model in {2, 4, 8}.
//
// What bounds it on an H100 SXM: a non-last layer at B=12, T=2,000 does
// 2*R*(3C*2C' (gate recompute) + n_rs*C' (dacts) + C'*n_rs (dw_rs) +
// 3C*2C' (dw_in) + 2C'*3C (dx)) operations, R = B*T. The whole layer's
// gradients at C = 512 take 201 GFLOP of them (the gate recompute 75 more),
// 0.20 ms at 989 TFLOP/s, at 256 a quarter of that: operation-bound. A
// rank at (512, 256) is 100.7 GFLOP, 0.102 ms; at C' <= C/4 it is
// byte-bound: every rank reads the whole x (4C bytes a row) and g (4 n_rs)
// and writes a whole f32 partial dx (4C), whatever C' is: at (128, 16) 52
// MB, 0.016 ms.
//
// Every product is a wgmma (m64nNk16, bf16 operands from 128-byte-swizzled
// shared memory, f32 accumulators; sm90_wgmma.cuh) of two warpgroups, 64
// rows each, fed by 64-deep K chunks, with one chunk's wgmmas left running
// under the next chunk's loads. The kernels, launched in order on one
// stream (wn_bwd_* for the whole layer, wn_sbwd_* for a rank):
//   wn_bwd_prep_kernel<C, last> (whole layer only) - per 128-row tile (the
//     rows kernel's tiles): rounds x to bf16 once, builds drs from dx_next
//     (masked) and dskip, writes it as bf16, and writes the tile's f32
//     column sums of drs (for db_rs) into that tile's part_bias row.
//   rows - one block per (batch row, tile of 128 time rows, pass of P =
//     min(C', 64) channels): the gate recompute (K = 3C; N = [P tanh | P
//     sigmoid] columns, at least 64) then dacts (K = n_rs, N = P, w_rs read
//     K-major as it lies) into accumulators that sit in the same thread for
//     the same (row, channel), so the gate and its adjoint run on the
//     accumulators. Writes dcond, bf16 acts and per-tile f32 column sums
//     of dgates. The weights stream through a 4-stage cp.async ring. The
//     A operands:
//       whole layer (wn_bwd_rows_kernel<C, last>): the prep kernel's bf16 x
//         taps and drs, copied by cp.async into the ring's stages beside
//         the weights, as they are: C / 64 passes read the same rows, and
//         none rounds them again.
//       a rank (wn_sbwd_rows_kernel<C, C', last>): at most C' / 64 passes
//         (one at C' <= 64), so the f32 x taps and g go out by cp.async two
//         chunks ahead, and while the wgmmas of one chunk run each thread
//         rounds its own share of the next chunk's to bf16 into the other
//         of two A slots (its warpgroup's rows only, so the warpgroup's own
//         wgmma wait frees the slot). The pass-0 block also writes bf16 x
//         and bf16 g (the weights kernel's operands) from the rounded
//         values; no block reads them back.
//   dx - per 128 flat rows x min(C, 256) output channels: a product over K
//     = 3 x 2C' (the three taps' dgates rows, shifted by -(tap-1)*d,
//     against w_in[tap] read K-major); the whole layer adds dx_next masked
//     in its epilogue.
//   weights - dw_in (tiles of 128 of its 3C rows x min(2C', 256) columns, at
//     least 64) and dw_rs^T (tiles of 128 of its n_rs rows x min(C', 256)
//     columns, at least 64), both operands MN-major as they lie in memory:
//     long-K reductions over the rows, split per batch row into ranges that
//     the caller sizes to fill whole waves of the card; f32 partials go to
//     a workspace (dw_rs transposed back on the way out).
//   reduce - sums the partials and the per-tile bias sums in a fixed order,
//     then casts.
// Extents past 2C', C' or K are zero-filled. No atomics anywhere: two
// launches give the same bits.
//
// Measured on an NVIDIA H100 80GB HBM3 (700 W): a rank, by chip_smoke.py
// phase 13(a), B=12, T=2,000, d=1: 0.19 ms at (256, 128) (rows 0.098, dx
// 0.030, weights 0.041, reduce 0.007), 0.54 ms at (512, 256), against 0.29
// and 1.01 ms for the mma.sync design it replaced; its rows kernel is bound
// by the f32 x and g it streams (sbwd_ablation.py). The whole layer, by
// phases 5 and 12 at the same shape: 0.31 ms at C = 256 (prep 0.035, rows
// 0.121, dx 0.056, weights 0.066, reduce 0.019) and 0.83 ms at 512, against
// 0.47 and 1.76 ms for the mma.sync kernels it replaced; no one of its
// rows kernel's copies or wgmmas bounds it (bwd_ablation.py). PERF.md
// keeps the times; wn_layer_bwd_kernel_info reports each kernel's
// registers, spills and shared memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

#include "f32_ring.cuh"  // cp.async, opt_in_smem
#include "sm90_wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;             // two warpgroups
constexpr int kTileRows = 128;            // rows of a rows or dx tile
constexpr int kKC = 64;                   // K of a chunk: one swizzle row
constexpr int kBlockBytes = 64 * 128;     // 64 rows (or 64 K rows) x 128 B
constexpr int kABytes = 2 * kBlockBytes;  // an A chunk of two warpgroups
constexpr int kStages = 4;                // weight / operand ring depth
constexpr int kAhead = kStages - 2;       // chunks in flight under the wgmmas

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo at the lower address
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return make_float2(__uint_as_float(v << 16),
                     __uint_as_float(v & 0xffff0000u));
}

// One step of the dx and weights kernels' ring at chunk `c`: this thread's
// copies of chunk c have landed; hand them to the async proxy and make
// them block-wide. Past this barrier every warpgroup has waited for the
// wgmmas of chunk c - 2, so its slot is free for chunk c + kAhead.
__device__ __forceinline__ void ring_wait() {
  cp_async_wait<kAhead - 1>();
  fence_proxy_async();
  __syncthreads();
}

// ---- kernel 0 (whole layer): x rounded once, drs built and rounded --------

// One block per (tile of kTileRows time rows, batch row), the rows kernel's
// tiles: x_bf = bf16(x); drs = [dx_next masked at t >= valid_t | dskip]
// (last: dskip; a null cotangent is zero), written as bf16 g_bf; and the
// tile's f32 column sums of drs into columns [2C, 2C + n_rs) of its
// part_bias row (the rows kernel writes columns [0, 2C)). Memory-bound:
// each thread keeps a batch of 16-byte loads in flight.
template <int kC, bool kLast>
__global__ void __launch_bounds__(kThreads)
wn_bwd_prep_kernel(const float* __restrict__ x,
                   const float* __restrict__ dx_next,
                   const float* __restrict__ dskip,
                   const int* __restrict__ valid_t, bf16* __restrict__ x_bf,
                   bf16* __restrict__ g_bf, float* __restrict__ part_bias,
                   int T) {
  constexpr int kNrs = kLast ? kC : 2 * kC;
  constexpr int kXQ = kC / 4;                  // float4 of an x row
  constexpr int kXPer = kTileRows * kXQ / kThreads;
  constexpr int kQ = kNrs / 4;                 // float4 of a drs row
  constexpr int kPhases = kThreads / kQ;       // threads down a column
  constexpr int kRowsPer = kTileRows / kPhases;
  constexpr int kBatch = 8;                    // loads in flight a thread
  static_assert(kThreads % kQ == 0 && kRowsPer % kBatch == 0 &&
                kXPer % kBatch == 0, "whole rounds");
  __shared__ float4 red[kThreads];

  const int b = blockIdx.y;
  const int tile = blockIdx.x;
  const int t0 = tile * kTileRows;
  const int rows = min(kTileRows, T - t0);
  const int64_t row0 = static_cast<int64_t>(b) * T + t0;
  const int valid = valid_t != nullptr ? valid_t[b] : T;

#pragma unroll
  for (int i0 = 0; i0 < kXPer; i0 += kBatch) {
    float4 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int p = threadIdx.x + (i0 + u) * kThreads;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (p / kXQ < rows)
        v[u] = *reinterpret_cast<const float4*>(x + row0 * kC +
                                                static_cast<int64_t>(p) * 4);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int p = threadIdx.x + (i0 + u) * kThreads;
      if (p / kXQ < rows)
        *reinterpret_cast<uint2*>(x_bf + row0 * kC +
                                  static_cast<int64_t>(p) * 4) =
            make_uint2(pack_bf16(v[u].x, v[u].y), pack_bf16(v[u].z, v[u].w));
    }
  }

  // drs columns 4q + [0, 4) of rows ph + kPhases k, summed in row order
  const int q = threadIdx.x % kQ, ph = threadIdx.x / kQ;
  const int col = 4 * q;
  const bool from_next = !kLast && col < kC;
  const float* src = from_next ? dx_next : dskip;
  const int scol = kLast || from_next ? col : col - kC;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int k0 = 0; k0 < kRowsPer; k0 += kBatch) {
    float4 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int r = ph + (k0 + u) * kPhases;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (src != nullptr && r < rows && !(from_next && t0 + r >= valid))
        v[u] = *reinterpret_cast<const float4*>(src + (row0 + r) * kC + scol);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int r = ph + (k0 + u) * kPhases;
      s.x += v[u].x; s.y += v[u].y; s.z += v[u].z; s.w += v[u].w;
      if (r < rows)
        *reinterpret_cast<uint2*>(g_bf + (row0 + r) * kNrs + col) =
            make_uint2(pack_bf16(v[u].x, v[u].y), pack_bf16(v[u].z, v[u].w));
    }
  }
  red[threadIdx.x] = s;
  __syncthreads();
  // the phases' sums, in order
  float* out = part_bias +
               static_cast<int64_t>(b * gridDim.x + tile) * (2 * kC + kNrs) +
               2 * kC;
  for (int c = threadIdx.x; c < kNrs; c += kThreads) {
    const float* rc = reinterpret_cast<const float*>(red) + c;
    float sum = rc[0];
#pragma unroll
    for (int p = 1; p < kPhases; ++p) sum += rc[p * kNrs];
    out[c] = sum;
  }
}

// ---- kernel 1: rows (gate recompute, dacts, gate adjoint) -----------------

// The rows kernel's shape at (C, C'): passes of kP channels, the gate's N,
// and the chunks of its two products (3C / 64 of taps, then n_rs / 64 of
// g).
template <int kC, int kCP, bool kLast>
struct SRowsShape {
  static constexpr int kNrs = kLast ? kC : 2 * kC;
  static constexpr int kP = kCP < 64 ? kCP : 64;        // channels a pass
  static constexpr int kPasses = kCP / kP;
  static constexpr int kNg = 2 * kP < 64 ? 64 : 2 * kP;  // the gate's N
  static constexpr int kTapChunks = 3 * kC / kKC;
  static constexpr int kChunks = kTapChunks + kNrs / kKC;
};

// Its shared memory. A rank (kFull false): two bf16 A slots, the weight
// ring, an f32 A chunk for each chunk in flight, the column sums. The whole
// layer: the ring, each stage an A chunk then the chunk's weights, and the
// column sums.
template <int kC, int kCP, bool kLast, bool kFull>
struct SRows : SRowsShape<kC, kCP, kLast> {
  using S = SRowsShape<kC, kCP, kLast>;
  // the weights of a chunk: the gate's [64 K][Ng] MN-major (dacts' [P][64
  // K] is less)
  static constexpr int kBBytes = kKC * S::kNg * 2;
  static constexpr int kStageBytes = (kFull ? kABytes : 0) + kBBytes;
  static constexpr int kF32Bytes = kTileRows * kKC * 4;
  static constexpr int kRingOff = kFull ? 0 : 2 * kABytes;
  static constexpr int kF32Off = kRingOff + kStages * kStageBytes;
  static constexpr int kRedOff = kF32Off + (kFull ? 0 : kAhead * kF32Bytes);
  static constexpr int kSmem = kRedOff + 8 * 2 * S::kP * 4;
  // a part_bias row: the tile's dgates column sums (the whole layer: then
  // the prep kernel's drs column sums)
  static constexpr int kBiasStride = 2 * kCP + (kFull ? S::kNrs : 0);
  static_assert(S::kP * 128 <= kBBytes, "dacts' weights fit a slot");
  static_assert(kSmem <= 232448, "over 227 KB");
};

// A rank's A operands: this thread's share of an A chunk is 8 pieces of 4
// values, rows rb + lt/16 + 8i of its warpgroup's 64 (lt its index in the
// warpgroup), columns 4 (lt % 16) + [0, 4) of the chunk's 64. It copies
// them in f32 and rounds the same values, so it reads back only what it
// copied itself.

// Start the f32 copies of this thread's share of A chunk j of a pass into
// an f32 slot ([128 rows][64] f32): j < kTapChunks, tap j % 3, channels 64
// (j / 3) + [0, 64) of x rows t0 + r + (tap-1)*d, zero outside [0, T);
// then the g columns 64 (j - kTapChunks) + [0, 64) of rows r < rows, zero
// past them. The gate's K runs in the same order: K row tap * C + 64 (j /
// 3) + k of w_in.
template <int kC, int kNrs>
__device__ __forceinline__ void srows_load_a(uint32_t f32_slot, int j,
                                             const float* xb, const float* gb,
                                             int rb, int t0, int rows, int T,
                                             int dilation) {
  constexpr int kTapChunks = 3 * kC / kKC;
  const int lt = threadIdx.x % 128;
  const int c4 = (lt % 16) * 4;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = rb + lt / 16 + 8 * i;
    const uint32_t dst = f32_slot + (r * kKC + c4) * 4;
    if (j < kTapChunks) {
      const int t = t0 + r + (j % 3 - 1) * dilation;
      const bool ok = t >= 0 && t < T;
      cp_async16_zfill(dst,
                       xb + static_cast<int64_t>(ok ? t : 0) * kC +
                           (j / 3) * kKC + c4,
                       ok);
    } else {
      const bool ok = r < rows;
      cp_async16_zfill(dst,
                       gb + static_cast<int64_t>(t0 + (ok ? r : 0)) * kNrs +
                           (j - kTapChunks) * kKC + c4,
                       ok);
    }
  }
}

// Round this thread's share of A chunk j from its f32 slot to bf16 into an
// A slot (K-major); with `scratch`, also write the rows < rows of the
// unshifted tap and of g out as the weights kernel's bf16 x and g.
template <int kC, int kNrs>
__device__ __forceinline__ void srows_convert(char* slot, const char* f32_slot,
                                              int j, int rb, int rows,
                                              bool scratch, bf16* x_bf,
                                              bf16* g_bf, int64_t row0) {
  constexpr int kTapChunks = 3 * kC / kKC;
  const int lt = threadIdx.x % 128;
  const int c4 = (lt % 16) * 4;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = rb + lt / 16 + 8 * i;
    const float4 v =
        *reinterpret_cast<const float4*>(f32_slot + (r * kKC + c4) * 4);
    const uint2 pk = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
    *reinterpret_cast<uint2*>(slot + sw128_piece(r, c4 / 8) + (c4 % 8) * 2) =
        pk;
    if (scratch && r < rows) {
      if (j >= kTapChunks)
        *reinterpret_cast<uint2*>(g_bf + (row0 + r) * kNrs +
                                  (j - kTapChunks) * kKC + c4) = pk;
      else if (j % 3 == 1)
        *reinterpret_cast<uint2*>(x_bf + (row0 + r) * kC + (j / 3) * kKC +
                                  c4) = pk;
    }
  }
}

// Start the copies of the weights of chunk j of the pass at channel cb into
// a ring slot: j < kTapChunks, w_in rows tap * C + 64 (j / 3) + [0, 64)
// (tap = j % 3) at the pass's tanh columns [cb, cb + P) (slot columns [0,
// P)) and sigmoid columns [C' + cb, ...) (slot columns [P, 2P)), MN-major,
// zero past 2P; then w_rs rows [cb, cb + P), columns [64k, 64k + 64) of
// dacts' chunk k, K-major.
template <int kC, int kCP, bool kLast>
__device__ __forceinline__ void srows_load_b(uint32_t slot, int j,
                                             const bf16* w_in,
                                             const bf16* w_rs, int cb) {
  using L = SRowsShape<kC, kCP, kLast>;
  constexpr int kP = L::kP;
  if (j < L::kTapChunks) {
    constexpr int kPer = L::kNg / 8;  // 16-byte pieces of a K row
    static_assert(kKC * kPer % kThreads == 0, "whole rounds");
#pragma unroll
    for (int i = 0; i < kKC * kPer / kThreads; ++i) {
      const int p = threadIdx.x + i * kThreads;
      const int k = p / kPer, n = (p % kPer) * 8;
      const bool live = n < 2 * kP;
      const int col = n < kP ? cb + n : kCP + cb + n - kP;
      cp_async16_zfill(slot + (n / 64) * kBlockBytes + sw128_piece(k, n % 64 / 8),
                       w_in + ((j % 3) * kC + (j / 3) * kKC + k) * 2 * kCP +
                           (live ? col : 0),
                       live);
    }
  } else {
    const int k0 = (j - L::kTapChunks) * kKC;
    constexpr int kPieces = kP * 8;
#pragma unroll
    for (int i = 0; i < (kPieces + kThreads - 1) / kThreads; ++i) {
      const int p = threadIdx.x + i * kThreads;
      if (kPieces % kThreads != 0 && p >= kPieces) break;
      const int n = p / 8, q = p % 8;
      cp_async16(slot + sw128_piece(n, q),
                 w_rs + (cb + n) * L::kNrs + k0 + q * 8);
    }
  }
}

// What a pass of the rows kernel reads besides its chunk index.
struct SRowsPass {
  char* base;             // shared memory
  const bf16* w_in;
  const bf16* w_rs;
  const void* xb;         // the batch row's x (a rank: f32; the layer: bf16)
  const void* gb;         // and g
  bf16* x_bf;
  bf16* g_bf;
  int64_t row0;
  int cb, rb, t0, rows, T, dilation;
  uint32_t a_wg;          // the warpgroup's rows in an A slot
  bool scratch;           // a rank's pass 0 writes the bf16 x and g
};

// A rank: the copies of chunk j of a pass (its weights and this thread's
// f32 share of its A operand) as one commit group; empty past the last
// chunk.
template <int kC, int kCP, bool kLast>
__device__ __forceinline__ void srows_load(const SRowsPass& s, int j) {
  using L = SRows<kC, kCP, kLast, false>;
  const uint32_t smem = smem_u32(s.base);
  if (j < L::kChunks) {
    srows_load_b<kC, kCP, kLast>(
        smem + L::kRingOff + (j % kStages) * L::kStageBytes, j, s.w_in,
        s.w_rs, s.cb);
    srows_load_a<kC, L::kNrs>(smem + L::kF32Off + (j % kAhead) * L::kF32Bytes,
                              j, static_cast<const float*>(s.xb),
                              static_cast<const float*>(s.gb), s.rb, s.t0,
                              s.rows, s.T, s.dilation);
  }
  cp_async_commit();
}

// A rank: round this thread's f32 share of chunk j into A slot j % 2.
template <int kC, int kCP, bool kLast>
__device__ __forceinline__ void srows_round(const SRowsPass& s, int j) {
  using L = SRows<kC, kCP, kLast, false>;
  srows_convert<kC, L::kNrs>(s.base + (j % 2) * kABytes,
                             s.base + L::kF32Off + (j % kAhead) * L::kF32Bytes,
                             j, s.rb, s.rows, s.scratch, s.x_bf, s.g_bf,
                             s.row0);
}

// A rank: step j of a pass, on the product kN wide (the gate's, B
// MN-major, or dacts', B K-major). Chunk j's copies went out at step j - 2
// (its weights to ring slot j % 4, its f32 A share to f32 slot j % 2) and
// at step j - 1 this thread waited for them and rounded its A share into A
// slot j % 2. Now: start chunk j + 2's copies, run chunk j's wgmmas, wait
// for chunk j + 1's copies and, once this warpgroup's wgmmas of chunk j - 1
// (the A slot's last reader) are done, round chunk j + 1's share. Each
// warpgroup reads and writes only its own 64 rows of an A slot, and each
// thread only its own pieces of an f32 slot.
template <int kC, int kCP, bool kLast, int kN, int kTransB>
__device__ __forceinline__ void srows_step(const SRowsPass& s, int j,
                                           float (&acc)[kN / 2]) {
  using L = SRows<kC, kCP, kLast, false>;
  const uint32_t smem = smem_u32(s.base);
  fence_proxy_async();
  __syncthreads();
  srows_load<kC, kCP, kLast>(s, j + kAhead);
  const uint32_t a0 = smem + (j % 2) * kABytes + s.a_wg;
  const uint32_t b0 = smem + L::kRingOff + (j % kStages) * L::kStageBytes;
  fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < kKC / 16; ++k)
    wgmma_m64<kN, 0, kTransB>(acc, kmajor_desc(a0 + k * 32),
                              kTransB ? mnmajor_desc(b0 + k * 2048, kBlockBytes)
                                      : kmajor_desc(b0 + k * 32));
  wgmma_commit();
  cp_async_wait<kAhead - 1>();
  wgmma_wait<1>();
  fence_acc(acc);
  if (j + 1 < L::kChunks) srows_round<kC, kCP, kLast>(s, j + 1);
}

// The whole layer: the copies of chunk j into ring stage j % 4 as one
// commit group (empty past the last chunk): its weights, and its A chunk
// from the prep kernel's bf16 rows as they are, K-major, 16-byte pieces q
// = tid % 8 of rows tid / 8 + 32i: j < kTapChunks, tap j % 3, channels 64
// (j / 3) + [0, 64) of x rows t0 + r + (tap-1)*d, zero outside [0, T);
// then the drs columns 64 (j - kTapChunks) + [0, 64) of rows r < rows.
template <int kC, bool kLast>
__device__ __forceinline__ void frows_load(const SRowsPass& s, int j) {
  using L = SRows<kC, kC, kLast, true>;
  const uint32_t stage = smem_u32(s.base) + (j % kStages) * L::kStageBytes;
  if (j < L::kChunks) {
    srows_load_b<kC, kC, kLast>(stage + kABytes, j, s.w_in, s.w_rs, s.cb);
    const bf16* xb = static_cast<const bf16*>(s.xb);
    const bf16* gb = static_cast<const bf16*>(s.gb);
    const int q = threadIdx.x % 8;
#pragma unroll
    for (int i = 0; i < kTileRows * 8 / kThreads; ++i) {
      const int r = threadIdx.x / 8 + 32 * i;
      if (j < L::kTapChunks) {
        const int t = s.t0 + r + (j % 3 - 1) * s.dilation;
        const bool ok = t >= 0 && t < s.T;
        cp_async16_zfill(stage + sw128_piece(r, q),
                         xb + static_cast<int64_t>(ok ? t : 0) * kC +
                             (j / 3) * kKC + q * 8,
                         ok);
      } else {
        const bool ok = r < s.rows;
        cp_async16_zfill(stage + sw128_piece(r, q),
                         gb + static_cast<int64_t>(s.t0 + (ok ? r : 0)) *
                                  L::kNrs +
                             (j - L::kTapChunks) * kKC + q * 8,
                         ok);
      }
    }
  }
  cp_async_commit();
}

// The whole layer: step j, as the dx kernel's: wait for chunk j's copies
// (past the barrier every warpgroup is done with chunk j - 2's stage),
// start chunk j + 2's into that stage, run chunk j's wgmmas.
template <int kC, bool kLast, int kN, int kTransB>
__device__ __forceinline__ void frows_step(const SRowsPass& s, int j,
                                           float (&acc)[kN / 2]) {
  using L = SRows<kC, kC, kLast, true>;
  ring_wait();
  frows_load<kC, kLast>(s, j + kAhead);
  const uint32_t stage = smem_u32(s.base) + (j % kStages) * L::kStageBytes;
  const uint32_t a0 = stage + s.a_wg;
  const uint32_t b0 = stage + kABytes;
  fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < kKC / 16; ++k)
    wgmma_m64<kN, 0, kTransB>(acc, kmajor_desc(a0 + k * 32),
                              kTransB ? mnmajor_desc(b0 + k * 2048, kBlockBytes)
                                      : kmajor_desc(b0 + k * 32));
  wgmma_commit();
  wgmma_wait<1>();
  fence_acc(acc);
}

// The rows kernel of a rank (kFull false: xin, gin the f32 x and g; pass 0
// writes x_bf and g_bf) or of the whole layer (xin, gin the prep kernel's
// bf16 x and drs).
template <int kC, int kCP, bool kLast, bool kFull>
__device__ __forceinline__ void srows_body(
    const void* xin, const bf16* __restrict__ cond,
    const bf16* __restrict__ w_in, const float* __restrict__ b_in,
    const bf16* __restrict__ w_rs, const void* gin, bf16* __restrict__ dcond,
    bf16* __restrict__ acts_out, bf16* __restrict__ x_bf,
    bf16* __restrict__ g_bf, float* __restrict__ part_bias, int T,
    int dilation) {
  using L = SRows<kC, kCP, kLast, kFull>;
  constexpr int CP = kCP;
  constexpr int N_RS = L::kNrs;
  constexpr int kP = L::kP;
  constexpr int kNB = kP / 8;            // n8 blocks of the pass's channels
  constexpr int kXSize = kFull ? 2 : 4;  // bytes of an x or g element
  extern __shared__ __align__(1024) uint4 smem_srows[];
  char* base = reinterpret_cast<char*>(smem_srows);
  float* red = reinterpret_cast<float*>(base + L::kRedOff);

  const int b = blockIdx.y;
  const int tile = blockIdx.x / L::kPasses;
  const int tiles_t = gridDim.x / L::kPasses;
  const int cb = (blockIdx.x % L::kPasses) * kP;  // the pass's channels
  const int t0 = tile * kTileRows;
  const int rows = min(kTileRows, T - t0);
  const int64_t row0 = static_cast<int64_t>(b) * T + t0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int r16 = warp * 16;     // the warp's rows of the accumulators
  const int g = lane / 4, tig = lane % 4;
  const SRowsPass st{base, w_in, w_rs,
                     static_cast<const char*>(xin) +
                         static_cast<int64_t>(b) * T * kC * kXSize,
                     static_cast<const char*>(gin) +
                         static_cast<int64_t>(b) * T * N_RS * kXSize,
                     x_bf, g_bf, row0, cb, wg * 64, t0, rows, T, dilation,
                     static_cast<uint32_t>(wg * kBlockBytes),
                     !kFull && cb == 0};

  if constexpr (kFull) {
    for (int c = 0; c < kAhead; ++c) frows_load<kC, kLast>(st, c);
  } else {
    for (int c = 0; c < kAhead; ++c) srows_load<kC, kCP, kLast>(st, c);
    cp_async_wait<kAhead - 1>();
    srows_round<kC, kCP, kLast>(st, 0);
  }

  // acc_g: element 4j + 2h + e is row r16 + g + 8h, gate column 8j + 2 tig
  // + e: the tanh pre-activation of channel cb + 8j + 2 tig + e for j < kNB,
  // the sigmoid one of channel cb + 8(j - kNB) + 2 tig + e for j < 2 kNB;
  // acc_d: element 4j + 2h + e is dacts of the same row and that channel
  float acc_g[L::kNg / 2], acc_d[kP / 2];
#pragma unroll
  for (int i = 0; i < L::kNg / 2; ++i) acc_g[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kP / 2; ++i) acc_d[i] = 0.f;

  // ---- gates = taps @ w_in[:, pass columns] ------------------------------
#pragma unroll 1
  for (int j = 0; j < L::kTapChunks; ++j) {
    if constexpr (kFull) frows_step<kC, kLast, L::kNg, 1>(st, j, acc_g);
    else srows_step<kC, kCP, kLast, L::kNg, 1>(st, j, acc_g);
  }
  wgmma_wait<0>();
  fence_acc(acc_g);

  // cond of the pass's channels, read under the dacts product
  uint32_t cond_t[kNB][2], cond_g[kNB][2];
#pragma unroll
  for (int j = 0; j < kNB; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r16 + g + 8 * h;
      const bf16* cr = cond + (row0 + row) * 2 * CP + cb + 8 * j + 2 * tig;
      cond_t[j][h] = cond_g[j][h] = 0u;  // bf16 zeros
      if (row < rows) {
        cond_t[j][h] = *reinterpret_cast<const uint32_t*>(cr);
        cond_g[j][h] = *reinterpret_cast<const uint32_t*>(cr + CP);
      }
    }

  // ---- dacts = bf16(g) @ w_rs[pass rows]^T --------------------------------
#pragma unroll 1
  for (int j = L::kTapChunks; j < L::kChunks; ++j) {
    if constexpr (kFull) frows_step<kC, kLast, kP, 0>(st, j, acc_d);
    else srows_step<kC, kCP, kLast, kP, 0>(st, j, acc_d);
  }
  wgmma_wait<0>();
  fence_acc(acc_d);
  cp_async_wait<0>();

  // ---- gate and its adjoint on the accumulators (f32) -------------------
  // Rows >= T have zero g and cond: finite gates, zero dgates.
#pragma unroll
  for (int j = 0; j < kNB; ++j) {
    const int ch = cb + 8 * j + 2 * tig;
    const float2 bt = *reinterpret_cast<const float2*>(b_in + ch);
    const float2 bs = *reinterpret_cast<const float2*>(b_in + CP + ch);
    float sa0 = 0.f, sa1 = 0.f, sb0 = 0.f, sb1 = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r16 + g + 8 * h;
      const int64_t grow = row0 + row;
      const float2 ct = unpack_bf16(cond_t[j][h]);
      const float2 cs = unpack_bf16(cond_g[j][h]);
      float da[2], db[2], act[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float gt = acc_g[4 * j + 2 * h + e] + (e ? bt.y : bt.x) +
                         (e ? ct.y : ct.x);
        const float gs = acc_g[4 * (j + kNB) + 2 * h + e] +
                         (e ? bs.y : bs.x) + (e ? cs.y : cs.x);
        const float tv = tanhf(gt);
        const float sv = 1.f / (1.f + expf(-gs));
        const float dv = acc_d[4 * j + 2 * h + e];
        act[e] = tv * sv;
        da[e] = dv * sv * (1.f - tv * tv);
        db[e] = dv * tv * sv * (1.f - sv);
      }
      sa0 += da[0]; sa1 += da[1]; sb0 += db[0]; sb1 += db[1];
      if (row < rows) {
        *reinterpret_cast<uint32_t*>(acts_out + grow * CP + ch) =
            pack_bf16(act[0], act[1]);
        *reinterpret_cast<uint32_t*>(dcond + grow * 2 * CP + ch) =
            pack_bf16(da[0], da[1]);
        *reinterpret_cast<uint32_t*>(dcond + grow * 2 * CP + CP + ch) =
            pack_bf16(db[0], db[1]);
      }
    }
    // column sums over the warp's 16 rows (fixed butterfly order)
#pragma unroll
    for (int m = 4; m < 32; m *= 2) {
      sa0 += __shfl_xor_sync(0xffffffffu, sa0, m);
      sa1 += __shfl_xor_sync(0xffffffffu, sa1, m);
      sb0 += __shfl_xor_sync(0xffffffffu, sb0, m);
      sb1 += __shfl_xor_sync(0xffffffffu, sb1, m);
    }
    if (g == 0) {
      float* rw = red + warp * 2 * kP + 8 * j + 2 * tig;
      rw[0] = sa0;
      rw[1] = sa1;
      rw[kP] = sb0;
      rw[kP + 1] = sb1;
    }
  }

  // ---- the tile's dgates column sums over the 8 row warps, in order
  __syncthreads();
  float* out =
      part_bias + static_cast<int64_t>(b * tiles_t + tile) * L::kBiasStride;
  for (int col = threadIdx.x; col < 2 * kP; col += kThreads) {
    float sum = red[col];
#pragma unroll
    for (int w = 1; w < 8; ++w) sum += red[w * 2 * kP + col];
    out[col < kP ? cb + col : CP + cb + col - kP] = sum;
  }
}

template <int kC, int kCP, bool kLast>
__global__ void __launch_bounds__(kThreads, 1)
wn_sbwd_rows_kernel(const float* __restrict__ x,
                    const bf16* __restrict__ cond,
                    const bf16* __restrict__ w_in,
                    const float* __restrict__ b_in,
                    const bf16* __restrict__ w_rs,
                    const float* __restrict__ gin, bf16* __restrict__ dcond,
                    bf16* __restrict__ acts_out, bf16* __restrict__ x_bf,
                    bf16* __restrict__ g_bf, float* __restrict__ part_bias,
                    int T, int dilation) {
  srows_body<kC, kCP, kLast, false>(x, cond, w_in, b_in, w_rs, gin, dcond,
                                    acts_out, x_bf, g_bf, part_bias, T,
                                    dilation);
}

template <int kC, bool kLast>
__global__ void __launch_bounds__(kThreads, 1)
wn_bwd_rows_kernel(const bf16* __restrict__ x_bf,
                   const bf16* __restrict__ cond,
                   const bf16* __restrict__ w_in,
                   const float* __restrict__ b_in,
                   const bf16* __restrict__ w_rs,
                   const bf16* __restrict__ drs, bf16* __restrict__ dcond,
                   bf16* __restrict__ acts_out, float* __restrict__ part_bias,
                   int T, int dilation) {
  srows_body<kC, kC, kLast, true>(x_bf, cond, w_in, b_in, w_rs, drs, dcond,
                                  acts_out, nullptr, nullptr, part_bias, T,
                                  dilation);
}

// ---- kernel 2: dx, the taps' adjoint (a rank: over its channels) --------

template <int kC, int kCP>
struct SDx {
  static constexpr int kN = kC < 256 ? kC : 256;  // output channels a block
  static constexpr int kK = 3 * 2 * kCP;          // (tap, gate column)
  static constexpr int kChunks = (kK + kKC - 1) / kKC;
  static constexpr int kStageBytes = kABytes + kN * 128;
  static constexpr int kSmem = kStages * kStageBytes;
  static_assert(kSmem <= 232448, "over 227 KB");
};

// Start the copies of K chunk c into a ring slot, both K-major: A, the
// tile's 128 rows of dgates at K = (tap, column m), row t - (tap-1)*d of
// the same batch row (zero outside [0, T)); B, w_in_s[tap * C + n0 + n][m]
// for the block's kN output channels n. Zero past K. This thread's A rows
// are tid/8 + 32i: `rbase` their batch row's first flat row, `tt` their
// time (far negative past the last row).
template <int kC, int kCP>
__device__ __forceinline__ void sdx_load(uint32_t slot, int c,
                                         const bf16* dgates, const bf16* w_in,
                                         const int64_t (&rbase)[4],
                                         const int (&tt)[4], int n0, int T,
                                         int dilation) {
  using L = SDx<kC, kCP>;
  const int q = threadIdx.x % 8;
  const int k = c * kKC + q * 8;
  const bool kin = k < L::kK;
  const int tap = k / (2 * kCP), m = k % (2 * kCP);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = threadIdx.x / 8 + 32 * i;
    const int s = tt[i] - (tap - 1) * dilation;
    const bool ok = kin && s >= 0 && s < T;
    cp_async16_zfill(slot + sw128_piece(r, q),
                     dgates + (ok ? (rbase[i] + s) * 2 * kCP + m : 0), ok);
  }
#pragma unroll
  for (int i = 0; i < L::kN * 8 / kThreads; ++i) {
    const int n = threadIdx.x / 8 + 32 * i;
    cp_async16_zfill(slot + kABytes + sw128_piece(n, q),
                     w_in + (kin ? (tap * kC + n0 + n) * 2 * kCP + m : 0),
                     kin);
  }
}

// The dx kernel of a rank (kFull false) or of the whole layer, which adds
// dx_next (null: zero) at rows t < valid_t[b] (null: every row).
template <int kC, int kCP, bool kFull>
__device__ __forceinline__ void sdx_body(const bf16* __restrict__ dgates,
                                         const bf16* __restrict__ w_in,
                                         float* __restrict__ dx,
                                         const float* __restrict__ dx_next,
                                         const int* __restrict__ valid_t,
                                         int total_rows, int T, int dilation) {
  using L = SDx<kC, kCP>;
  extern __shared__ __align__(1024) uint4 smem_sdx[];
  const uint32_t ring_s = smem_u32(smem_sdx);
  const int rt0 = blockIdx.x * kTileRows;   // the tile's first flat row
  const int n0 = blockIdx.y * L::kN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int r16 = warp * 16;
  const int g = lane / 4, tig = lane % 4;

  int64_t rbase[4];
  int tt[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int fr = rt0 + threadIdx.x / 8 + 32 * i;
    const int bi = fr / T;
    rbase[i] = static_cast<int64_t>(bi) * T;
    tt[i] = fr < total_rows ? fr - bi * T : -(1 << 30);
  }

  for (int c = 0; c < kAhead; ++c) {
    if (c < L::kChunks)
      sdx_load<kC, kCP>(ring_s + c * L::kStageBytes, c, dgates, w_in, rbase,
                        tt, n0, T, dilation);
    cp_async_commit();
  }


  float acc[L::kN / 2];
#pragma unroll
  for (int i = 0; i < L::kN / 2; ++i) acc[i] = 0.f;

#pragma unroll 1
  for (int c = 0; c < L::kChunks; ++c) {
    ring_wait();
    if (c + kAhead < L::kChunks)
      sdx_load<kC, kCP>(ring_s + ((c + kAhead) % kStages) * L::kStageBytes,
                        c + kAhead, dgates, w_in, rbase, tt, n0, T, dilation);
    cp_async_commit();
    const uint32_t slot = ring_s + (c % kStages) * L::kStageBytes;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kKC / 16; ++k)
      wgmma_m64<L::kN, 0, 0>(acc, kmajor_desc(slot + wg * kBlockBytes + k * 32),
                             kmajor_desc(slot + kABytes + k * 32));
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(acc);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int fr = rt0 + r16 + g + 8 * h;
    if (fr >= total_rows) continue;
    const int64_t off = static_cast<int64_t>(fr) * kC + n0 + 2 * tig;
    bool add = false;
    if constexpr (kFull) {
      const int bi = fr / T;
      add = dx_next != nullptr &&
            (valid_t == nullptr || fr - bi * T < valid_t[bi]);
    }
#pragma unroll
    for (int j = 0; j < L::kN / 8; ++j) {
      float2 v = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      if (add) {
        const float2 n =
            *reinterpret_cast<const float2*>(dx_next + off + 8 * j);
        v = make_float2(n.x + v.x, n.y + v.y);
      }
      *reinterpret_cast<float2*>(dx + off + 8 * j) = v;
    }
  }
}

template <int kC, int kCP>
__global__ void __launch_bounds__(kThreads, 1)
wn_sbwd_dx_kernel(const bf16* __restrict__ dgates,
                  const bf16* __restrict__ w_in, float* __restrict__ dx,
                  int total_rows, int T, int dilation) {
  sdx_body<kC, kCP, false>(dgates, w_in, dx, nullptr, nullptr, total_rows, T,
                           dilation);
}

template <int kC>
__global__ void __launch_bounds__(kThreads, 1)
wn_bwd_dx_kernel(const bf16* __restrict__ dgates,
                 const bf16* __restrict__ w_in, float* __restrict__ dx,
                 const float* __restrict__ dx_next,
                 const int* __restrict__ valid_t, int total_rows, int T,
                 int dilation) {
  sdx_body<kC, kC, true>(dgates, w_in, dx, dx_next, valid_t, total_rows, T,
                         dilation);
}

// ---- kernel 3: weight gradients, row-split partials -----------------------

template <int kC, int kCP>
struct SW {
  static constexpr int kInN = 2 * kCP < 64 ? 64 : (2 * kCP > 256 ? 256 : 2 * kCP);
  static constexpr int kRsN = kCP < 64 ? 64 : (kCP > 256 ? 256 : kCP);
  static constexpr int kInNt = (2 * kCP + kInN - 1) / kInN;  // N tiles of dw_in
  static constexpr int kInTiles = 3 * kC / 128 * kInNt;
  static constexpr int kRsNt = (kCP + kRsN - 1) / kRsN;  // N tiles of dw_rs^T
  // A [64 K][128 M] and B [64 K][N], both MN-major; dw_rs^T's N <= dw_in's
  static constexpr int kStageBytes = kABytes + kInN * 128;
  static constexpr int kSmem = kStages * kStageBytes;
  static_assert(kRsN <= kInN && kSmem <= 232448, "slots");
};

// One output tile: out[m][n] (m < m_ext of 128, n < n_ext of kN) = sum over
// the split's rows t of A[t][m] B[t][n], A's row t read from row t + a_shift
// (zero outside [0, T)).
struct SWJob {
  const bf16* a;  // [rows][lda], from the tile's first M value
  const bf16* b;  // [rows][ldb], from its first N value
  int lda, ldb, a_shift, m_ext, n_ext;
  float* out;     // element (m, n) at out[m * ld_m + n * ld_n]
  int ld_m, ld_n;
};

// Start the copies of the split's rows [tb + 64c, +64) into a ring slot:
// A's 128 M values and B's kN N values of each row, zero past te and the
// extents.
template <int kN>
__device__ __forceinline__ void sw_load(uint32_t slot, int c, const SWJob& o,
                                        int64_t brow0, int tb, int te, int T) {
#pragma unroll
  for (int i = 0; i < kKC * 16 / kThreads; ++i) {
    const int p = threadIdx.x + i * kThreads;
    const int kr = p / 16, m = (p % 16) * 8;
    const int t = tb + c * kKC + kr;
    const int s = t + o.a_shift;
    const bool ok = t < te && s >= 0 && s < T && m < o.m_ext;
    cp_async16_zfill(slot + (m / 64) * kBlockBytes + sw128_piece(kr, m % 64 / 8),
                     o.a + (ok ? (brow0 + s) * o.lda + m : 0), ok);
  }
  constexpr int kPer = kN / 8;
#pragma unroll
  for (int i = 0; i < kKC * kPer / kThreads; ++i) {
    const int p = threadIdx.x + i * kThreads;
    const int kr = p / kPer, n = (p % kPer) * 8;
    const int t = tb + c * kKC + kr;
    const bool ok = t < te && n < o.n_ext;
    cp_async16_zfill(
        slot + kABytes + (n / 64) * kBlockBytes + sw128_piece(kr, n % 64 / 8),
        o.b + (ok ? (brow0 + t) * o.ldb + n : 0), ok);
  }
}

template <int kN>
__device__ __forceinline__ void sw_tile(const SWJob& o, uint32_t ring_s,
                                        int64_t brow0, int tb, int te, int T) {
  constexpr int kStage = kABytes + kN * 128;
  const int chunks = te > tb ? (te - tb + kKC - 1) / kKC : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int g = lane / 4, tig = lane % 4;
  for (int c = 0; c < kAhead; ++c) {
    if (c < chunks) sw_load<kN>(ring_s + c * kStage, c, o, brow0, tb, te, T);
    cp_async_commit();
  }
  float acc[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) acc[i] = 0.f;
#pragma unroll 1
  for (int c = 0; c < chunks; ++c) {
    ring_wait();
    if (c + kAhead < chunks)
      sw_load<kN>(ring_s + ((c + kAhead) % kStages) * kStage, c + kAhead, o,
                  brow0, tb, te, T);
    cp_async_commit();
    const uint32_t slot = ring_s + (c % kStages) * kStage;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kKC / 16; ++k)
      wgmma_m64<kN, 1, 1>(
          acc, mnmajor_desc(slot + wg * kBlockBytes + k * 2048, kBlockBytes),
          mnmajor_desc(slot + kABytes + k * 2048, kBlockBytes));
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(acc);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = warp * 16 + g + 8 * h;
    if (m >= o.m_ext) continue;
    float* out = o.out + static_cast<int64_t>(m) * o.ld_m;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      const int n = 8 * j + 2 * tig;
      if (n >= o.n_ext) break;
      if (o.ld_n == 1) {
        *reinterpret_cast<float2*>(out + n) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      } else {
        out[static_cast<int64_t>(n) * o.ld_n] = acc[4 * j + 2 * h];
        out[static_cast<int64_t>(n + 1) * o.ld_n] = acc[4 * j + 2 * h + 1];
      }
    }
  }
}

// blockIdx.x: output tile (dw_in_s's, then dw_rs_s^T's); blockIdx.y: split s
// = b * n_splits_t + ts over rows t of batch row b in [ts * split_rows, (ts
// + 1) * split_rows). Writes its f32 partial to ws[s][...] (dw_in_s then
// dw_rs_s, each in its own layout).
template <int kC, int kCP>
__device__ __forceinline__ void sw_body(const bf16* __restrict__ x_bf,
                                        const bf16* __restrict__ dgates,
                                        const bf16* __restrict__ acts,
                                        const bf16* __restrict__ g_bf,
                                        float* __restrict__ ws, int T,
                                        int dilation, int n_rs,
                                        int n_splits_t, int split_rows) {
  using L = SW<kC, kCP>;
  constexpr int kDwIn = 3 * kC * 2 * kCP;
  extern __shared__ __align__(1024) uint4 smem_sw[];
  const uint32_t ring_s = smem_u32(smem_sw);
  const int tile = blockIdx.x;
  const int split = blockIdx.y;
  const int b = split / n_splits_t;
  const int tb = (split % n_splits_t) * split_rows;
  const int te = min(T, tb + split_rows);
  const int64_t brow0 = static_cast<int64_t>(b) * T;
  float* wsp = ws + split * (kDwIn + static_cast<int64_t>(kCP) * n_rs);
  if (tile < L::kInTiles) {
    // dw_in_s rows (tap, ci0 + m), columns nt * kInN + n
    const int mt = tile / L::kInNt, nt = tile % L::kInNt;
    const int tap = mt * 128 / kC, ci0 = mt * 128 % kC;
    const SWJob o{x_bf + ci0, dgates + nt * L::kInN, kC, 2 * kCP,
                  (tap - 1) * dilation, 128,
                  min(L::kInN, 2 * kCP - nt * L::kInN),
                  wsp + (tap * kC + ci0) * 2 * kCP + nt * L::kInN, 2 * kCP, 1};
    sw_tile<L::kInN>(o, ring_s, brow0, tb, te, T);
  } else {
    // dw_rs^T rows mt * 128 + m (of n_rs), columns nt * kRsN + n (of C')
    const int mt = (tile - L::kInTiles) / L::kRsNt;
    const int nt = (tile - L::kInTiles) % L::kRsNt;
    const SWJob o{g_bf + mt * 128, acts + nt * L::kRsN, n_rs, kCP, 0, 128,
                  min(L::kRsN, kCP - nt * L::kRsN),
                  wsp + kDwIn + mt * 128 + static_cast<int64_t>(nt) *
                                               L::kRsN * n_rs,
                  1, n_rs};
    sw_tile<L::kRsN>(o, ring_s, brow0, tb, te, T);
  }
}

template <int kC, int kCP>
__global__ void __launch_bounds__(kThreads, 1)
wn_sbwd_weights_kernel(const bf16* __restrict__ x_bf,
                       const bf16* __restrict__ dgates,
                       const bf16* __restrict__ acts,
                       const bf16* __restrict__ g_bf, float* __restrict__ ws,
                       int T, int dilation, int n_rs, int n_splits_t,
                       int split_rows) {
  sw_body<kC, kCP>(x_bf, dgates, acts, g_bf, ws, T, dilation, n_rs,
                   n_splits_t, split_rows);
}

template <int kC>
__global__ void __launch_bounds__(kThreads, 1)
wn_bwd_weights_kernel(const bf16* __restrict__ x_bf,
                      const bf16* __restrict__ dgates,
                      const bf16* __restrict__ acts,
                      const bf16* __restrict__ drs, float* __restrict__ ws,
                      int T, int dilation, int n_rs, int n_splits_t,
                      int split_rows) {
  sw_body<kC, kC>(x_bf, dgates, acts, drs, ws, T, dilation, n_rs, n_splits_t,
                  split_rows);
}

// ---- kernel 4: fixed-order sums of the partials, then casts ----------------

// Blocks [0, n_bias / 8): one warp per bias column, its lanes summing every
// 32nd of the n_tiles rows of part_bias, then a butterfly: db_in's 2C'
// columns (the whole layer: then db_rs's n_rs). The blocks after them: one
// thread per element of dw_in then dw_rs, summing the n_splits partials of
// the weights kernel in order.
constexpr int kBiasColsPerBlock = kThreads / 32;

template <int kC, int kCP, bool kFull>
__device__ __forceinline__ void sreduce_body(
    const float* __restrict__ ws, int n_splits,
    const float* __restrict__ part_bias, int n_tiles, int n_rs,
    bf16* __restrict__ dw_in, bf16* __restrict__ dw_rs,
    float* __restrict__ db_in, float* __restrict__ db_rs) {
  constexpr int kDwIn = 3 * kC * 2 * kCP;
  const int n_bias = 2 * kCP + (kFull ? n_rs : 0);  // a part_bias row
  const int bias_blocks = n_bias / kBiasColsPerBlock;
  if (static_cast<int>(blockIdx.x) < bias_blocks) {
    const int col = blockIdx.x * kBiasColsPerBlock + threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    float s = 0.f;
    for (int i = lane; i < n_tiles; i += 32)
      s += part_bias[static_cast<int64_t>(i) * n_bias + col];
#pragma unroll
    for (int m = 16; m > 0; m /= 2) s += __shfl_xor_sync(0xffffffffu, s, m);
    if (lane == 0) {
      if (col < 2 * kCP) db_in[col] = s;
      else db_rs[col - 2 * kCP] = s;
    }
    return;
  }
  const int64_t ws_stride = kDwIn + static_cast<int64_t>(kCP) * n_rs;
  const int64_t w =
      static_cast<int64_t>(blockIdx.x - bias_blocks) * kThreads + threadIdx.x;
  if (w >= ws_stride) return;
  float s = 0.f;
  for (int i = 0; i < n_splits; ++i) s += ws[i * ws_stride + w];
  const bf16 v = __float2bfloat16(s);
  if (w < kDwIn) dw_in[w] = v;
  else dw_rs[w - kDwIn] = v;
}

template <int kC, int kCP>
__global__ void __launch_bounds__(kThreads)
wn_sbwd_reduce_kernel(const float* __restrict__ ws, int n_splits,
                      const float* __restrict__ part_bias, int n_tiles,
                      int n_rs, bf16* __restrict__ dw_in,
                      bf16* __restrict__ dw_rs, float* __restrict__ db_in) {
  sreduce_body<kC, kCP, false>(ws, n_splits, part_bias, n_tiles, n_rs, dw_in,
                               dw_rs, db_in, nullptr);
}

template <int kC>
__global__ void __launch_bounds__(kThreads)
wn_bwd_reduce_kernel(const float* __restrict__ ws, int n_splits,
                     const float* __restrict__ part_bias, int n_tiles,
                     int n_rs, bf16* __restrict__ dw_in,
                     bf16* __restrict__ dw_rs, float* __restrict__ db_in,
                     float* __restrict__ db_rs) {
  sreduce_body<kC, kC, true>(ws, n_splits, part_bias, n_tiles, n_rs, dw_in,
                             dw_rs, db_in, db_rs);
}

// ---- launch ----------------------------------------------------------------

struct SArgs {
  const float* x;
  const bf16* cond;
  const bf16* w_in;
  const float* b_in;
  const bf16* w_rs;
  const float* g;
  float* dx;
  bf16* dcond;
  bf16* dw_in;
  float* db_in;
  bf16* dw_rs;
  bf16* acts;
  bf16* x_bf;
  bf16* g_bf;
  float* part_bias;
  float* ws;
  int batch, T, dilation, n_splits_t, split_rows;
  // the whole layer only
  const float* dx_next;
  const float* dskip;
  const int* valid_t;
  float* db_rs;
};

template <int kC, int kCP, bool kLast>
cudaError_t launch_srows(const SArgs& a, cudaStream_t stream) {
  static std::atomic<uint32_t> opted_in{0};
  using L = SRows<kC, kCP, kLast, false>;
  auto kernel = wn_sbwd_rows_kernel<kC, kCP, kLast>;
  cudaError_t err = opt_in_smem(kernel, L::kSmem, &opted_in);
  if (err != cudaSuccess) return err;
  const int tiles_t = (a.T + kTileRows - 1) / kTileRows;
  kernel<<<dim3(tiles_t * L::kPasses, a.batch), kThreads, L::kSmem, stream>>>(
      a.x, a.cond, a.w_in, a.b_in, a.w_rs, a.g, a.dcond, a.acts, a.x_bf,
      a.g_bf, a.part_bias, a.T, a.dilation);
  return cudaGetLastError();
}

// The whole layer's prep and rows kernels.
template <int kC, bool kLast>
cudaError_t launch_frows(const SArgs& a, cudaStream_t stream) {
  const int tiles_t = (a.T + kTileRows - 1) / kTileRows;
  wn_bwd_prep_kernel<kC, kLast><<<dim3(tiles_t, a.batch), kThreads, 0,
                                  stream>>>(a.x, a.dx_next, a.dskip,
                                            a.valid_t, a.x_bf, a.g_bf,
                                            a.part_bias, a.T);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  static std::atomic<uint32_t> opted_in{0};
  using L = SRows<kC, kC, kLast, true>;
  auto kernel = wn_bwd_rows_kernel<kC, kLast>;
  err = opt_in_smem(kernel, L::kSmem, &opted_in);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(tiles_t * L::kPasses, a.batch), kThreads, L::kSmem, stream>>>(
      a.x_bf, a.cond, a.w_in, a.b_in, a.w_rs, a.g_bf, a.dcond, a.acts,
      a.part_bias, a.T, a.dilation);
  return cudaGetLastError();
}

// Output tiles of the weights kernel: dw_in's, then dw_rs^T's.
template <int kC, int kCP>
int weight_tiles(int n_rs) {
  return SW<kC, kCP>::kInTiles + n_rs / 128 * SW<kC, kCP>::kRsNt;
}

// The backward of a rank at (kC, kCP) (kFull false: four launches) or of
// the whole layer (kCP = kC: five launches), in order on `stream`.
template <int kC, int kCP, bool kFull>
cudaError_t backward(const SArgs& a, int last, cudaStream_t stream) {
  const int n_rs = last ? kC : 2 * kC;
  cudaError_t err;
  if constexpr (kFull)
    err = last ? launch_frows<kC, true>(a, stream)
               : launch_frows<kC, false>(a, stream);
  else
    err = last ? launch_srows<kC, kCP, true>(a, stream)
               : launch_srows<kC, kCP, false>(a, stream);
  if (err != cudaSuccess) return err;

  static std::atomic<uint32_t> dx_opted{0}, w_opted{0};
  using D = SDx<kC, kCP>;
  const int total_rows = a.batch * a.T;
  const dim3 dx_grid((total_rows + kTileRows - 1) / kTileRows, kC / D::kN);
  if constexpr (kFull) {
    err = opt_in_smem(wn_bwd_dx_kernel<kC>, D::kSmem, &dx_opted);
    if (err != cudaSuccess) return err;
    wn_bwd_dx_kernel<kC><<<dx_grid, kThreads, D::kSmem, stream>>>(
        a.dcond, a.w_in, a.dx, a.dx_next, a.valid_t, total_rows, a.T,
        a.dilation);
  } else {
    err = opt_in_smem(wn_sbwd_dx_kernel<kC, kCP>, D::kSmem, &dx_opted);
    if (err != cudaSuccess) return err;
    wn_sbwd_dx_kernel<kC, kCP><<<dx_grid, kThreads, D::kSmem, stream>>>(
        a.dcond, a.w_in, a.dx, total_rows, a.T, a.dilation);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  using W = SW<kC, kCP>;
  const dim3 w_grid(weight_tiles<kC, kCP>(n_rs), a.batch * a.n_splits_t);
  if constexpr (kFull) {
    err = opt_in_smem(wn_bwd_weights_kernel<kC>, W::kSmem, &w_opted);
    if (err != cudaSuccess) return err;
    wn_bwd_weights_kernel<kC><<<w_grid, kThreads, W::kSmem, stream>>>(
        a.x_bf, a.dcond, a.acts, a.g_bf, a.ws, a.T, a.dilation, n_rs,
        a.n_splits_t, a.split_rows);
  } else {
    err = opt_in_smem(wn_sbwd_weights_kernel<kC, kCP>, W::kSmem, &w_opted);
    if (err != cudaSuccess) return err;
    wn_sbwd_weights_kernel<kC, kCP><<<w_grid, kThreads, W::kSmem, stream>>>(
        a.x_bf, a.dcond, a.acts, a.g_bf, a.ws, a.T, a.dilation, n_rs,
        a.n_splits_t, a.split_rows);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int tiles_t = (a.T + kTileRows - 1) / kTileRows;
  const int64_t n_w = 3 * kC * 2 * kCP + static_cast<int64_t>(kCP) * n_rs;
  const int n_bias = 2 * kCP + (kFull ? n_rs : 0);
  const int blocks = n_bias / kBiasColsPerBlock +
                     static_cast<int>((n_w + kThreads - 1) / kThreads);
  if constexpr (kFull)
    wn_bwd_reduce_kernel<kC><<<blocks, kThreads, 0, stream>>>(
        a.ws, a.batch * a.n_splits_t, a.part_bias, a.batch * tiles_t, n_rs,
        a.dw_in, a.dw_rs, a.db_in, a.db_rs);
  else
    wn_sbwd_reduce_kernel<kC, kCP><<<blocks, kThreads, 0, stream>>>(
        a.ws, a.batch * a.n_splits_t, a.part_bias, a.batch * tiles_t, n_rs,
        a.dw_in, a.dw_rs, a.db_in);
  return cudaGetLastError();
}

// The kernel `which` (0 rows, 1 dx, 2 weights, 3 reduce, 4 prep; `last`
// picks the rows and prep kernels' variants) of a rank at (kC, kCP), or of
// the whole layer (kFull), as a function pointer, and its dynamic shared
// bytes.
template <int kC, int kCP, bool kFull>
const void* kernel_for(int which, int last, int* smem_bytes) {
  *smem_bytes = 0;
  switch (which) {
    case 0:
      *smem_bytes = last ? SRows<kC, kCP, true, kFull>::kSmem
                         : SRows<kC, kCP, false, kFull>::kSmem;
      if constexpr (kFull)
        return last ? reinterpret_cast<const void*>(wn_bwd_rows_kernel<kC, true>)
                    : reinterpret_cast<const void*>(wn_bwd_rows_kernel<kC, false>);
      else
        return last ? reinterpret_cast<const void*>(
                          wn_sbwd_rows_kernel<kC, kCP, true>)
                    : reinterpret_cast<const void*>(
                          wn_sbwd_rows_kernel<kC, kCP, false>);
    case 1:
      *smem_bytes = SDx<kC, kCP>::kSmem;
      if constexpr (kFull) return reinterpret_cast<const void*>(wn_bwd_dx_kernel<kC>);
      else return reinterpret_cast<const void*>(wn_sbwd_dx_kernel<kC, kCP>);
    case 2:
      *smem_bytes = SW<kC, kCP>::kSmem;
      if constexpr (kFull) return reinterpret_cast<const void*>(wn_bwd_weights_kernel<kC>);
      else return reinterpret_cast<const void*>(wn_sbwd_weights_kernel<kC, kCP>);
    case 3:
      if constexpr (kFull) return reinterpret_cast<const void*>(wn_bwd_reduce_kernel<kC>);
      else return reinterpret_cast<const void*>(wn_sbwd_reduce_kernel<kC, kCP>);
    default:
      if constexpr (kFull)
        return last ? reinterpret_cast<const void*>(wn_bwd_prep_kernel<kC, true>)
                    : reinterpret_cast<const void*>(wn_bwd_prep_kernel<kC, false>);
      else
        return nullptr;
  }
}

cudaError_t kernel_attributes(const void* kernel, int* registers,
                              int* local_bytes, int* static_smem_bytes) {
  if (kernel == nullptr) return cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  *registers = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *static_smem_bytes = static_cast<int>(attr.sharedSizeBytes);
  return cudaSuccess;
}

bool bad_split(int batch, int T, int n_splits_t, int split_rows) {
  return T <= 0 || batch <= 0 || batch > 65535 || n_splits_t <= 0 ||
         split_rows <= 0 || split_rows % kKC != 0 ||
         static_cast<int64_t>(batch) * n_splits_t > 65535 ||
         static_cast<int64_t>(n_splits_t) * split_rows < T ||
         static_cast<int64_t>(batch) * T > (1ll << 31) - 1 - kTileRows;
}

// The built (C, C') pairs of a rank (those of the forward shard kernel), for
// the dispatch below.
#define WN_SBWD_PAIRS(X)                                                   \
  X(128, 64) X(128, 32) X(128, 16) X(256, 128) X(256, 64) X(256, 32)        \
  X(512, 256) X(512, 128) X(512, 64)

// The built widths of the whole layer.
#define WN_BWD_WIDTHS(X) X(128) X(256) X(512)

}  // namespace

extern "C" {

// The bf16 backward of one whole layer, five launches on `stream`, no
// synchronisation; returns the first launch error.
// Inputs (C = 128, 256 or 512): x [batch, T, C] f32; cond [batch, T, 2C],
// w_in [3C, 2C], w_rs [C, n_rs] bf16 (n_rs = C when last, else 2C); b_in
// [2C] f32; dx_next, dskip [batch, T, C] f32 or null (zero); valid_t
// [batch] int32 or null. Outputs: dx f32 like x, dcond bf16 like cond,
// dw_in / dw_rs bf16 like the weights, db_in / db_rs f32. Scratch, from the
// caller: acts, x_bf [batch*T, C] bf16; drs [batch*T, n_rs] bf16;
// part_bias [batch * ceil(T/tile), 2C + n_rs] f32 (tile:
// wn_layer_bwd_tile_rows(C)); ws [batch * n_splits_t, 3C*2C + C*n_rs] f32.
// The weights kernel splits each batch row's T into n_splits_t ranges of
// split_rows rows (a multiple of 64), over wn_layer_bwd_weight_tiles(C,
// last) output tiles. Pointers 16-byte aligned, contiguous.
cudaError_t wn_layer_backward_bf16(
    const float* x, const void* cond, const void* w_in, const float* b_in,
    const void* w_rs, const float* dx_next, const float* dskip,
    const int* valid_t, float* dx, void* dcond, void* dw_in, float* db_in,
    void* dw_rs, float* db_rs, void* acts, void* x_bf, void* drs,
    float* part_bias, float* ws, int batch, int T, int C, int dilation,
    int last, int n_splits_t, int split_rows, cudaStream_t stream) {
  if (bad_split(batch, T, n_splits_t, split_rows)) return cudaErrorInvalidValue;
  const SArgs a{x, static_cast<const bf16*>(cond),
                static_cast<const bf16*>(w_in), b_in,
                static_cast<const bf16*>(w_rs), nullptr, dx,
                static_cast<bf16*>(dcond), static_cast<bf16*>(dw_in), db_in,
                static_cast<bf16*>(dw_rs), static_cast<bf16*>(acts),
                static_cast<bf16*>(x_bf), static_cast<bf16*>(drs), part_bias,
                ws, batch, T, dilation, n_splits_t, split_rows, dx_next,
                dskip, valid_t, db_rs};
#define WN_BWD_CALL(WIDTH) \
  if (C == WIDTH) return backward<WIDTH, WIDTH, true>(a, last, stream);
  WN_BWD_WIDTHS(WN_BWD_CALL)
#undef WN_BWD_CALL
  return cudaErrorInvalidValue;
}

// The bf16 backward of one model rank's share of a layer, four launches on
// `stream`, no synchronisation; returns the first launch error.
// Inputs ((C, C') a built pair): x [batch, T, C] f32; cond [batch, T, 2C'],
// w_in [3C, 2C'], w_rs [C', n_rs] bf16 (n_rs = C when last, else 2C); b_in
// [2C'] f32; g [batch, T, n_rs] f32. Outputs: dx f32 like x (the rank's
// partial), dcond bf16 like cond, dw_in / dw_rs bf16 like the weights,
// db_in f32. Scratch, from the caller: acts [batch*T, C'], x_bf [batch*T,
// C], g_bf [batch*T, n_rs] bf16; part_bias [batch * ceil(T/tile), 2C'] f32
// (tile: wn_layer_bwd_tile_rows(C, C')); ws [batch * n_splits_t,
// 3C*2C' + C'*n_rs] f32. The weights kernel splits each batch row's T into
// n_splits_t ranges of split_rows rows (a multiple of 64), over
// wn_layer_bwd_weight_tiles(C, C', last) output tiles. Pointers
// 16-byte aligned, contiguous.
cudaError_t wn_layer_shard_backward_bf16(
    const float* x, const void* cond, const void* w_in, const float* b_in,
    const void* w_rs, const float* g, float* dx, void* dcond, void* dw_in,
    float* db_in, void* dw_rs, void* acts, void* x_bf, void* g_bf,
    float* part_bias, float* ws, int batch, int T, int C, int cp,
    int dilation, int last, int n_splits_t, int split_rows,
    cudaStream_t stream) {
  if (bad_split(batch, T, n_splits_t, split_rows)) return cudaErrorInvalidValue;
  const SArgs a{x, static_cast<const bf16*>(cond),
                static_cast<const bf16*>(w_in), b_in,
                static_cast<const bf16*>(w_rs), g, dx,
                static_cast<bf16*>(dcond), static_cast<bf16*>(dw_in), db_in,
                static_cast<bf16*>(dw_rs), static_cast<bf16*>(acts),
                static_cast<bf16*>(x_bf), static_cast<bf16*>(g_bf), part_bias,
                ws, batch, T, dilation, n_splits_t, split_rows, nullptr,
                nullptr, nullptr, nullptr};
#define WN_SBWD_CALL(WIDTH, CP) \
  if (C == WIDTH && cp == CP) return backward<WIDTH, CP, false>(a, last, stream);
  WN_SBWD_PAIRS(WN_SBWD_CALL)
#undef WN_SBWD_CALL
  return cudaErrorInvalidValue;
}

// Time rows of the rows kernel's tile (its part_bias rows a batch row are
// ceil(T / this)): of the whole layer at width C (cp = C) or of a rank at
// (C, C'); -1 for what it is not built for.
int wn_layer_bwd_tile_rows(int C, int cp) {
#define WN_BWD_TILE(WIDTH) \
  if (C == WIDTH && cp == WIDTH) return kTileRows;
  WN_BWD_WIDTHS(WN_BWD_TILE)
#undef WN_BWD_TILE
#define WN_SBWD_TILE(WIDTH, CP) \
  if (C == WIDTH && cp == CP) return kTileRows;
  WN_SBWD_PAIRS(WN_SBWD_TILE)
#undef WN_SBWD_TILE
  return -1;
}

// Output tiles of the weights kernel (each a block for each of the
// n_splits_t ranges of each batch row): of the whole layer at width C (cp
// = C) or of a rank at (C, C'); -1 for what it is not built for.
int wn_layer_bwd_weight_tiles(int C, int cp, int last) {
#define WN_BWD_WTILES(WIDTH) \
  if (C == WIDTH && cp == WIDTH) return weight_tiles<WIDTH, WIDTH>(last ? C : 2 * C);
  WN_BWD_WIDTHS(WN_BWD_WTILES)
#undef WN_BWD_WTILES
#define WN_SBWD_WTILES(WIDTH, CP) \
  if (C == WIDTH && cp == CP) return weight_tiles<WIDTH, CP>(last ? C : 2 * C);
  WN_SBWD_PAIRS(WN_SBWD_WTILES)
#undef WN_SBWD_WTILES
  return -1;
}

// What the loaded build of backward kernel `which` (0 rows, 1 dx, 2
// weights, 3 reduce, 4 prep; `last` picks the rows and prep variants) uses,
// from the CUDA runtime: registers and local (spill) bytes per thread,
// static shared bytes, and the dynamic shared bytes its launcher passes; of
// the whole layer at width C (cp = C) or of a rank at (C, C') (no prep).
cudaError_t wn_layer_bwd_kernel_info(int C, int cp, int which, int last,
                                     int* registers, int* local_bytes,
                                     int* static_smem_bytes,
                                     int* dynamic_smem_bytes) {
  const void* kernel = nullptr;
#define WN_BWD_INFO(WIDTH)                                            \
  if (C == WIDTH && cp == WIDTH)                                      \
    kernel = kernel_for<WIDTH, WIDTH, true>(which, last, dynamic_smem_bytes);
  WN_BWD_WIDTHS(WN_BWD_INFO)
#undef WN_BWD_INFO
#define WN_SBWD_INFO(WIDTH, CP)                                       \
  if (C == WIDTH && cp == CP)                                         \
    kernel = kernel_for<WIDTH, CP, false>(which, last, dynamic_smem_bytes);
  WN_SBWD_PAIRS(WN_SBWD_INFO)
#undef WN_SBWD_INFO
  return kernel_attributes(kernel, registers, local_bytes, static_smem_bytes);
}

}  // extern "C"
