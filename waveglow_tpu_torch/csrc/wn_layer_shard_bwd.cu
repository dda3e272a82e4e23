// The bf16 backward of one model rank's share of a WN layer (the trainable
// tensor-parallel shard), for Hopper (sm_90a), CUDA C++ with a plain C
// interface (bound from Python with ctypes, see
// kernels/wn_layer.py::wn_layer_shard_backward_fused).
//
// Replaces what GSPMD makes of the autodiff of the WN layer under a `model`
// mesh axis in the JAX package (waveglow_tpu/parallel/sharding.py:44-67
// places the weights; waveglow_tpu/kernels/wn_layer.py::
// _wn_layer_trainable_bwd is the full layer's VJP). A rank holds C' = C /
// model of the C gate channels; its forward (csrc/wn_layer_shard.cu) gives
// the partial res/skip sum acts @ w_rs_s. Given g, the cotangent of that
// partial (the same tensor on every rank), this computes the rank's
// adjoints at csrc/wn_layer_bwd.cu's rounding points:
//
//   taps    = bf16(x) shifted by (tap-1)*d, zero outside [0, T)
//   gates   = taps @ w_in_s + b_in_s + cond_s      (f32 accumulation and adds)
//   t = tanh(gates[:C']), s = sigmoid(gates[C':]), acts = t * s     (f32)
//   dacts   = bf16(g) @ w_rs_s^T                   (f32 accumulation)
//   dgates  = [dacts*s*(1-t^2) | dacts*t*s*(1-s)]                   (f32)
//   dcond_s = bf16(dgates)
//   db_in_s = sum_rows dgates                      (f32, not its rounding)
//   dw_in_s = bf16(taps^T @ bf16(dgates))          (f32 sums, then bf16)
//   dw_rs_s = bf16(bf16(acts)^T @ bf16(g))
//   dx      = sum_tap shift(bf16(dgates) @ w_in_s[tap]^T, -(tap-1)*d)  (f32)
//
// dx is the rank's partial: the taps' adjoint over its C' channels only.
// The caller sums the ranks' dx in rank order and adds the residual's
// cotangent; b_rs, the residual and the skip stay outside, in autograd
// (models/wn.py::wn_forward_train_tp). Summed over the ranks, dx is the
// full layer's taps' adjoint, and the ranks' dw_in_s, dw_rs_s, db_in_s and
// dcond_s concatenate to the full layer's.
//
// Layouts, row-major: x [B, T, C] f32; cond_s [B, T, 2C'], w_in_s [3C, 2C']
// (tanh columns of the rank's channels, then its sigmoid columns), w_rs_s
// [C', n_rs] bf16 (n_rs = 2C, or C for the last layer); b_in_s [2C'] f32;
// g [B, T, n_rs] f32. Built for every pair of the forward shard kernel: C in
// {128, 256, 512}, C' = C / model, model in {2, 4, 8}.
//
// What bounds it on an H100 SXM: a non-last layer at B=12, T=2,000 does
// 2*R*(3C*2C' (gate recompute) + n_rs*C' (dacts) + C'*n_rs (dw_rs) +
// 3C*2C' (dw_in) + 2C'*3C (dx)) operations, R = B*T. At (512, 256) that is
// 100.7 GFLOP, 0.102 ms at 989 TFLOP/s, over the 0.079 ms of its bytes: it
// is operation-bound. At C' <= C/4 it is byte-bound: every rank reads the
// whole x (4C bytes a row) and g (4 n_rs) and writes a whole f32 partial dx
// (4C), whatever C' is: at (128, 16) 52 MB, 0.016 ms.
//
// Four kernels, launched in order on one stream, after the full layer's
// backward (csrc/wn_layer_bwd.cu), with the tiles generalised to narrow C':
//   wn_sbwd_rows_kernel<C, C', last> - per tile of time rows (one block per
//     SM, 8 warps): stages the three bf16 tap windows in shared memory and
//     bf16(g) into a global scratch, then in passes over blocks of
//     min(C', 128) channels recomputes the tanh and sigmoid pre-activations
//     (K = 3C) and dacts (K = n_rs, g read back through the ring) of the
//     same channels into accumulators that sit in the same thread, so the
//     gate and its adjoint run on the accumulators. Writes dcond_s, bf16
//     acts and bf16 x (scratch operands of the weights kernel) and per-tile
//     f32 column sums of dgates. The warp grid follows the block's width:
//     a warp holds 32 x 32, 32 x 16 or 16 x 16 rows x channels, and the
//     tile 64 rows (32 at C = 512, whose three tap windows would not fit
//     at 64; 128 at C' = 16, where a pass of 16 channels leaves eight row
//     warps).
//   wn_sbwd_dx_kernel<C, C'> - per 128 rows x 128 of the C output channels:
//     dx = a 3-tap dilated product over bf16 dgates with the offsets
//     negated (K = 3*2C').
//   wn_sbwd_weights_kernel<C, C'> - dw_in_s (3C/128 x ceil(2C'/128) tiles)
//     and dw_rs_s (ceil(C'/128) x n_rs/128 tiles) of 128 x 128, whose
//     extent past 2C' or C' is zero-filled and skipped by whole warps:
//     long-K reductions over the rows, split into row ranges (per batch
//     row) over the grid's y; f32 partials go to a workspace.
//   wn_sbwd_reduce_kernel<C, C'> - sums the partials and the per-tile bias
//     sums in a fixed order, then casts.
// Every product is mma.sync m16n8k16 (bf16 operands, f32 accumulators) fed
// by ldmatrix from padded shared memory (row strides 16 bytes past a
// multiple of 128), every operand chunk streams through a cp.async ring
// (zero-filled outside [0, T)). No atomics anywhere: two launches give the
// same bits. PERF.md keeps the times; wn_layer_shard_bwd_kernel_info
// reports each kernel's registers, spills and shared memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;          // 8 warps
constexpr int kK = 32;                 // K rows of one pipeline chunk
constexpr int kKStride = kK + 8;       // a [rows][32] chunk row: 80 bytes
constexpr int kWTile = 128;            // weights kernel output tile edge
constexpr int kWStride = kWTile + 8;   // [32][128] chunk row: 272 bytes

// ---- PTX helpers ------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled (nothing read) when !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Four 8x8 b16 matrices (of their transposes with .trans); lanes 8i..8i+7
// give the row addresses of matrix i.
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

// d += a @ b: one m16n8k16 product, bf16 operands, f32 accumulators; d0,d1
// = (g, 2q..2q+1), d2,d3 = (g+8, 2q..), g = lane/4, q = lane%4.
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

// ---- kernel 1: rows (gate recompute, dacts, gate adjoint) -----------------

// The rows kernel's layout at (kC, kCP). A pass covers kBlk = min(C', 128)
// channels; 8 warps = kRowWarps x kColWarps, a warp kMi m16 row blocks x
// kWarpCh channels (32 x 32 where the tile has room, else 32 x 16, else
// 16 x 16).
template <int kC, int kCP, bool kLast>
struct SRows {
  static constexpr int kNrs = kLast ? kC : 2 * kC;
  static constexpr int kBlk = kCP < 128 ? kCP : 128;
  static constexpr int kPasses = kCP / kBlk;
  static constexpr int kTileRows = kC > 256 ? 32 : (kBlk == 16 ? 128 : 64);
  static constexpr int kWarpArea = kTileRows * kBlk / 8;
  static constexpr int kWarpCh = kWarpArea >= 1024 ? 32 : 16;
  static constexpr int kMi = kWarpArea / (16 * kWarpCh);
  static constexpr int kColWarps = kBlk / kWarpCh;
  static constexpr int kRowWarps = 8 / kColWarps;
  static constexpr int kNB = kWarpCh / 8;                  // n8 blocks
  static constexpr int kInStride = 2 * kBlk + 8;           // w_in chunk row
  static constexpr int kWinStride = kC + 8;                // tap window row
  static constexpr int kTapBytes = 3 * kTileRows * kWinStride * 2;
  static constexpr int kInChunkBytes = kK * kInStride * 2;
  static constexpr int kRsChunkBytes = kBlk * kKStride * 2;
  static constexpr int kGChunkBytes = kTileRows * kKStride * 2;
  static constexpr int kStageBytes =
      kInChunkBytes > kRsChunkBytes + kGChunkBytes
          ? kInChunkBytes : kRsChunkBytes + kGChunkBytes;
  static constexpr int kStages = 6;
  static constexpr int kAhead = kStages - 1;
  static constexpr int kRedBytes = kRowWarps * 2 * kCP * 4;
  static constexpr int kSmem = kTapBytes + kStages * kStageBytes + kRedBytes;
  static constexpr int kInChunks = 3 * kC / kK;
  static constexpr int kRsChunks = kNrs / kK;
  static constexpr int kPerPass = kInChunks + kRsChunks;
  static constexpr int kChunks = kPasses * kPerPass;
  static_assert(kMi >= 1 && kMi <= 2 && kRowWarps * kColWarps == 8 &&
                    kRowWarps * 16 * kMi == kTileRows && kNB % 2 == 0,
                "warp grid");
  static_assert(kAhead <= kInChunks,
                "the prologue's chunks must not read the g scratch");
  static_assert(kSmem <= 232448, "over 227 KB");
};

// Start the copies of chunk `c` into ring slot `slot`: in pass c / kPerPass
// (channel block cb), first the w_in_s rows [k0, k0+32) restricted to the
// tanh columns [cb, cb+kBlk) (stored at 0..kBlk-1) and the sigmoid columns
// [C'+cb, ...) (stored at kBlk..), as [k][n]; then w_rs_s rows [cb,
// cb+kBlk), columns [k0, k0+32), as [n][k], and beside them the tile's bf16
// g rows, columns [k0, k0+32), from the scratch this block wrote (zero past
// T).
template <int kC, int kCP, bool kLast>
__device__ __forceinline__ void srows_load(uint32_t slot, int c,
                                           const bf16* w_in, const bf16* w_rs,
                                           const bf16* g_bf, int64_t row0,
                                           int rows) {
  using L = SRows<kC, kCP, kLast>;
  const int j = c % L::kPerPass;
  const int cb = (c / L::kPerPass) * L::kBlk;
  if (j < L::kInChunks) {
    const int k0 = j * kK;
    constexpr int kRowPieces = L::kBlk / 4;       // 16-byte pieces a row
    constexpr int kPieces = kK * kRowPieces;
#pragma unroll
    for (int i = 0; i < (kPieces + kThreads - 1) / kThreads; ++i) {
      const int p = threadIdx.x + i * kThreads;
      if (kPieces % kThreads != 0 && p >= kPieces) break;
      const int r = p / kRowPieces, q = p % kRowPieces;
      const int half = kRowPieces / 2;
      const int col = q < half ? cb + q * 8 : kCP + cb + (q - half) * 8;
      cp_async16(slot + (r * L::kInStride + q * 8) * 2,
                 w_in + (k0 + r) * 2 * kCP + col, true);
    }
  } else {
    const int k0 = (j - L::kInChunks) * kK;
    constexpr int kWPieces = L::kBlk * 4;
#pragma unroll
    for (int i = 0; i < (kWPieces + kThreads - 1) / kThreads; ++i) {
      const int p = threadIdx.x + i * kThreads;
      if (kWPieces % kThreads != 0 && p >= kWPieces) break;
      const int n = p / 4, q = p % 4;
      cp_async16(slot + (n * kKStride + q * 8) * 2,
                 w_rs + (cb + n) * L::kNrs + k0 + q * 8, true);
    }
    constexpr int kGPieces = L::kTileRows * 4;
#pragma unroll
    for (int i = 0; i < (kGPieces + kThreads - 1) / kThreads; ++i) {
      const int p = threadIdx.x + i * kThreads;
      if (kGPieces % kThreads != 0 && p >= kGPieces) break;
      const int r = p / 4, q = p % 4;
      cp_async16(slot + L::kRsChunkBytes + (r * kKStride + q * 8) * 2,
                 g_bf + (row0 + (r < rows ? r : 0)) * L::kNrs + k0 + q * 8,
                 r < rows);
    }
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
  using L = SRows<kC, kCP, kLast>;
  constexpr int C = kC;
  constexpr int CP = kCP;
  constexpr int N_RS = L::kNrs;
  constexpr int kTile = L::kTileRows;
  constexpr int kMi = L::kMi;
  constexpr int kNB = L::kNB;
  extern __shared__ __align__(16) uint4 smem_srows[];
  char* base = reinterpret_cast<char*>(smem_srows);
  bf16* taps = reinterpret_cast<bf16*>(base);
  const uint32_t taps_s = smem_u32(taps);
  const uint32_t ring_s = taps_s + L::kTapBytes;
  float* red = reinterpret_cast<float*>(base + L::kTapBytes +
                                        L::kStages * L::kStageBytes);

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTile;
  const int rows = min(kTile, T - t0);
  const int64_t row0 = static_cast<int64_t>(b) * T + t0;
  const int tile_id = b * gridDim.x + blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q4 = lane % 4;
  const int wr = warp % L::kRowWarps;
  const int rw0 = wr * 16 * kMi;                      // the warp's rows
  const int cw = (warp / L::kRowWarps) * L::kWarpCh;  // its channels of a
                                                      // pass block

  // the first chunks (w_in_s only) load while the tile is staged
  for (int c = 0; c < L::kAhead; ++c) {
    srows_load<kC, kCP, kLast>(ring_s + c * L::kStageBytes, c, w_in, w_rs,
                               g_bf, row0, rows);
    cp_async_commit();
  }

  // ---- taps: window w, row r <- bf16(x[t0 + r + (w-1)*d]), zero outside
  // [0, T); window 1 (rows < T) also goes out as the bf16 x scratch
  {
    constexpr int kQ = C / 4;  // float4 per row
    constexpr int kTotal = 3 * kTile * kQ;
    constexpr int kUnroll = kTotal % (16 * kThreads) == 0 ? 16 : 8;
    static_assert(kTotal % (kUnroll * kThreads) == 0, "whole rounds");
    const float* xb = x + static_cast<int64_t>(b) * T * C;
#pragma unroll 1
    for (int p0 = threadIdx.x; p0 < kTotal; p0 += kUnroll * kThreads) {
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int p = p0 + u * kThreads;
        const int i = p / kQ;
        const int t = t0 + i % kTile + (i / kTile - 1) * dilation;
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (t >= 0 && t < T)
          v[u] = *reinterpret_cast<const float4*>(
              xb + static_cast<int64_t>(t) * C + (p % kQ) * 4);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int p = p0 + u * kThreads;
        const int i = p / kQ, c4 = (p % kQ) * 4;
        const uint2 pk = make_uint2(pack_bf16(v[u].x, v[u].y),
                                    pack_bf16(v[u].z, v[u].w));
        *reinterpret_cast<uint2*>(taps + i * L::kWinStride + c4) = pk;
        const int r = i - kTile;
        if (r >= 0 && r < rows)
          *reinterpret_cast<uint2*>(x_bf + (row0 + r) * C + c4) = pk;
      }
    }
  }

  // ---- bf16(g) into the scratch (read back through the ring as dacts' A
  // operand), rows < T
  {
    constexpr int kQuads = N_RS / 4;
    const int live = rows * kQuads;
#pragma unroll 4
    for (int p = threadIdx.x; p < live; p += kThreads) {
      const int r = p / kQuads, c = (p % kQuads) * 4;
      const float4 v =
          *reinterpret_cast<const float4*>(gin + (row0 + r) * N_RS + c);
      *reinterpret_cast<uint2*>(g_bf + (row0 + r) * N_RS + c) =
          make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
    }
    // other threads read the scratch back with cp.async.cg, which bypasses
    // L1: make the stores visible in L2 before the ring's first barrier
    __threadfence();
  }

  // ---- passes over blocks of kBlk channels: acc_t / acc_s the tanh and
  // sigmoid pre-activations, acc_d dacts, of the same (row, channel) in the
  // same thread: m16 block mi, n8 block nb, element e is row rw0 + 16mi + g
  // + 8(e/2), channel cb + cw + 8nb + 2q4 + e%2
  float acc_t[kMi][kNB][4], acc_s[kMi][kNB][4], acc_d[kMi][kNB][4];
#pragma unroll
  for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc_t[mi][nb][e] = acc_s[mi][nb][e] = acc_d[mi][nb][e] = 0.f;

  // cond_s of the pass's epilogue, fetched during its dacts chunks
  uint32_t cond_t[kMi][kNB][2], cond_g[kMi][kNB][2];

#pragma unroll 1
  for (int c = 0; c < L::kChunks; ++c) {
    // chunk c landed for every thread; chunk c-1's slot is free (and, past
    // the first barrier, the g scratch is written for every thread)
    cp_async_wait<L::kAhead - 1>();
    __syncthreads();
    if (c + L::kAhead < L::kChunks)
      srows_load<kC, kCP, kLast>(
          ring_s + ((c + L::kAhead) % L::kStages) * L::kStageBytes,
          c + L::kAhead, w_in, w_rs, g_bf, row0, rows);
    cp_async_commit();
    const uint32_t slot = ring_s + (c % L::kStages) * L::kStageBytes;
    const int j = c % L::kPerPass;
    if (j == L::kInChunks) {
      const int cb = (c / L::kPerPass) * L::kBlk;
#pragma unroll
      for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
        for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = rw0 + 16 * mi + g + 8 * h;
            const bf16* cr = cond + (row0 + row) * 2 * CP + cb + cw + 8 * nb +
                             2 * q4;
            cond_t[mi][nb][h] = cond_g[mi][nb][h] = 0u;  // bf16 zeros
            if (row < rows) {
              cond_t[mi][nb][h] = *reinterpret_cast<const uint32_t*>(cr);
              cond_g[mi][nb][h] = *reinterpret_cast<const uint32_t*>(cr + CP);
            }
          }
    }
    if (j < L::kInChunks) {
      const int tap = j / (C / kK);
      const int kin = (j % (C / kK)) * kK;
#pragma unroll
      for (int kk = 0; kk < kK; kk += 16) {
        uint32_t a[kMi][4];
#pragma unroll
        for (int mi = 0; mi < kMi; ++mi)
          ldsm_x4(a[mi], taps_s + ((tap * kTile + rw0 + 16 * mi + lane % 16) *
                                       L::kWinStride + kin + kk +
                                   (lane / 16) * 8) * 2);
        const uint32_t brow =
            slot + ((kk + lane % 8 + ((lane / 8) % 2) * 8) * L::kInStride +
                    cw + (lane / 16) * 8) * 2;
#pragma unroll
        for (int pb = 0; pb < kNB / 2; ++pb) {
          uint32_t bt[4], bs[4];
          ldsm_x4_t(bt, brow + pb * 16 * 2);
          ldsm_x4_t(bs, brow + (L::kBlk + pb * 16) * 2);
#pragma unroll
          for (int mi = 0; mi < kMi; ++mi) {
            mma16816(acc_t[mi][2 * pb], a[mi], bt[0], bt[1]);
            mma16816(acc_t[mi][2 * pb + 1], a[mi], bt[2], bt[3]);
            mma16816(acc_s[mi][2 * pb], a[mi], bs[0], bs[1]);
            mma16816(acc_s[mi][2 * pb + 1], a[mi], bs[2], bs[3]);
          }
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < kK; kk += 16) {
        uint32_t a[kMi][4];
#pragma unroll
        for (int mi = 0; mi < kMi; ++mi)
          ldsm_x4(a[mi], slot + L::kRsChunkBytes +
                             ((rw0 + 16 * mi + lane % 16) * kKStride + kk +
                              (lane / 16) * 8) * 2);
#pragma unroll
        for (int pb = 0; pb < kNB / 2; ++pb) {
          uint32_t bd[4];
          ldsm_x4(bd, slot + ((cw + pb * 16 + lane % 8 + (lane / 16) * 8) *
                                  kKStride + kk + ((lane / 8) % 2) * 8) * 2);
#pragma unroll
          for (int mi = 0; mi < kMi; ++mi) {
            mma16816(acc_d[mi][2 * pb], a[mi], bd[0], bd[1]);
            mma16816(acc_d[mi][2 * pb + 1], a[mi], bd[2], bd[3]);
          }
        }
      }
    }
    if (j != L::kPerPass - 1) continue;

    // ---- gate and its adjoint on the accumulators (f32) -------------------
    // Rows >= T have zero taps, cond and g: finite gates, zero dgates.
    const int cb = (c / L::kPerPass) * L::kBlk;
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
      const int ch = cb + cw + 8 * nb + 2 * q4;
      const float2 bt = *reinterpret_cast<const float2*>(b_in + ch);
      const float2 bs = *reinterpret_cast<const float2*>(b_in + CP + ch);
      float sa0 = 0.f, sa1 = 0.f, sb0 = 0.f, sb1 = 0.f;
#pragma unroll
      for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = rw0 + 16 * mi + g + 8 * h;
          const int64_t grow = row0 + row;
          const float2 ct = unpack_bf16(cond_t[mi][nb][h]);
          const float2 cs = unpack_bf16(cond_g[mi][nb][h]);
          float da[2], db[2], act[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float gt = acc_t[mi][nb][2 * h + e] + (e ? bt.y : bt.x) +
                             (e ? ct.y : ct.x);
            const float gs = acc_s[mi][nb][2 * h + e] + (e ? bs.y : bs.x) +
                             (e ? cs.y : cs.x);
            const float tv = tanhf(gt);
            const float sv = 1.f / (1.f + expf(-gs));
            const float dv = acc_d[mi][nb][2 * h + e];
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
      // column sums over the warp's rows (fixed butterfly order)
#pragma unroll
      for (int m = 4; m < 32; m *= 2) {
        sa0 += __shfl_xor_sync(0xffffffffu, sa0, m);
        sa1 += __shfl_xor_sync(0xffffffffu, sa1, m);
        sb0 += __shfl_xor_sync(0xffffffffu, sb0, m);
        sb1 += __shfl_xor_sync(0xffffffffu, sb1, m);
      }
      if (g == 0) {
        float* rw = red + wr * 2 * CP;
        rw[ch] = sa0;
        rw[ch + 1] = sa1;
        rw[CP + ch] = sb0;
        rw[CP + ch + 1] = sb1;
      }
    }
#pragma unroll
    for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc_t[mi][nb][e] = acc_s[mi][nb][e] = acc_d[mi][nb][e] = 0.f;
  }
  cp_async_wait<0>();

  // ---- the tile's dgates column sums over the row warps, in order
  __syncthreads();
  float* out = part_bias + static_cast<int64_t>(tile_id) * 2 * CP;
  for (int col = threadIdx.x; col < 2 * CP; col += kThreads) {
    float sum = red[col];
#pragma unroll
    for (int w = 1; w < L::kRowWarps; ++w) sum += red[w * 2 * CP + col];
    out[col] = sum;
  }
}

// ---- kernel 2: dx, the taps' adjoint over the rank's channels -------------

// Block tile: 128 rows x 128 output channels; warp tile 64 x 32. K runs
// tap-major over 3 x 2C' in chunks of 32.
constexpr int kRT = 128;
constexpr int kRingStages = 4;                    // dx and weights rings
constexpr int kRingAhead = kRingStages - 1;
constexpr int kDxChunkBytes = kRT * kKStride * 2;  // 10,240: [128][32]
constexpr int kDxStage = 2 * kDxChunkBytes;       // A then B
constexpr int kDxSmem = kRingStages * kDxStage;   // 81,920

template <int kCP>
constexpr int kDxChunks = 3 * 2 * kCP / kK;

// Chunk c: tap c / (2C'/32), gate columns m0. A: dgates rows t0 + r -
// (tap-1)*d (zero outside [0, T)); B: w_in_s[tap*C + n0 + n][m0..+32) as
// [n][k].
template <int kC, int kCP>
__device__ __forceinline__ void sdx_load(uint32_t slot, int c,
                                         const bf16* dgates, const bf16* w_in,
                                         int64_t brow0, int t0, int n0, int T,
                                         int dilation) {
  const int tap = c / (2 * kCP / kK);
  const int m0 = (c % (2 * kCP / kK)) * kK;
#pragma unroll
  for (int i = 0; i < kRT * 4 / kThreads; ++i) {  // 4 pieces a row
    const int p = threadIdx.x + i * kThreads;
    const int r = p / 4, q = p % 4;
    const int s = t0 + r - (tap - 1) * dilation;
    const bool ok = s >= 0 && s < T;
    cp_async16(slot + (r * kKStride + q * 8) * 2,
               dgates + (brow0 + (ok ? s : 0)) * 2 * kCP + m0 + q * 8, ok);
    cp_async16(slot + kDxChunkBytes + (r * kKStride + q * 8) * 2,
               w_in + (tap * kC + n0 + r) * 2 * kCP + m0 + q * 8, true);
  }
}

template <int kC, int kCP>
__global__ void __launch_bounds__(kThreads, 2)
wn_sbwd_dx_kernel(const bf16* __restrict__ dgates,
                  const bf16* __restrict__ w_in, float* __restrict__ dx,
                  int T, int dilation) {
  static_assert(kDxChunks<kCP> >= kRingAhead, "the prologue's chunks");
  extern __shared__ __align__(16) uint4 smem_sdx[];
  const uint32_t ring_s = smem_u32(smem_sdx);
  const int b = blockIdx.z;
  const int t0 = blockIdx.x * kRT;
  const int n0 = blockIdx.y * kRT;
  const int rows = min(kRT, T - t0);
  const int64_t brow0 = static_cast<int64_t>(b) * T;
  const int64_t row0 = brow0 + t0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q4 = lane % 4;
  const int m0 = (warp % 2) * 64;
  const int nw = n0 + (warp / 2) * 32;

  for (int c = 0; c < kRingAhead; ++c) {
    sdx_load<kC, kCP>(ring_s + c * kDxStage, c, dgates, w_in, brow0, t0, n0,
                      T, dilation);
    cp_async_commit();
  }

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;

#pragma unroll 1
  for (int c = 0; c < kDxChunks<kCP>; ++c) {
    cp_async_wait<kRingAhead - 1>();
    __syncthreads();
    if (c + kRingAhead < kDxChunks<kCP>)
      sdx_load<kC, kCP>(ring_s + ((c + kRingAhead) % kRingStages) * kDxStage,
                        c + kRingAhead, dgates, w_in, brow0, t0, n0, T,
                        dilation);
    cp_async_commit();
    const uint32_t slot = ring_s + (c % kRingStages) * kDxStage;
#pragma unroll
    for (int kk = 0; kk < kK; kk += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4(a[mi], slot + ((m0 + 16 * mi + lane % 16) * kKStride + kk +
                               (lane / 16) * 8) * 2);
#pragma unroll
      for (int pb = 0; pb < 2; ++pb) {
        uint32_t bw[4];
        const int n = (warp / 2) * 32 + pb * 16 + lane % 8 + (lane / 16) * 8;
        ldsm_x4(bw, slot + kDxChunkBytes +
                        (n * kKStride + kk + ((lane / 8) % 2) * 8) * 2);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          mma16816(acc[mi][2 * pb], a[mi], bw[0], bw[1]);
          mma16816(acc[mi][2 * pb + 1], a[mi], bw[2], bw[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mh = 0; mh < 8; ++mh) {
    const int mi = mh / 2, h = mh % 2;
    const int row = m0 + 16 * mi + g + 8 * h;
    if (row >= rows) continue;
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      const int64_t off = (row0 + row) * kC + nw + 8 * nj + 2 * q4;
      *reinterpret_cast<float2*>(dx + off) =
          make_float2(acc[mi][nj][2 * h], acc[mi][nj][2 * h + 1]);
    }
  }
}

// ---- kernel 3: weight gradients, row-split partials -----------------------

constexpr int kWChunk = kK * kWStride * 2;       // 8,704: [32 rows][128]
constexpr int kWStage = 2 * kWChunk;
constexpr int kWSmem = kRingStages * kWStage;    // 69,632

struct SWOperands {
  const bf16* a;  // [rows][a_ld], the tile's output rows along its columns
  const bf16* b;  // [rows][b_ld], the tile's output columns
  int a_ld, b_ld, a_shift;
  int m_ext, n_ext;  // the tile's live output rows and columns (<= 128)
};

// Rows [t, t+32) of the split (t from tb + 32c) into A and B chunks, each
// [32 rows][128], with row t of A read from row t + a_shift; zero outside
// [0, T), past the split's end te, and past the tile's extents.
__device__ __forceinline__ void sw_load(uint32_t slot, int c,
                                        const SWOperands& o, int64_t brow0,
                                        int tb, int te, int T) {
#pragma unroll
  for (int i = 0; i < kK * 16 / kThreads; ++i) {  // 16 pieces a row
    const int p = threadIdx.x + i * kThreads;
    const int r = p / 16, q = p % 16;
    const int t = tb + c * kK + r;
    const int s = t + o.a_shift;
    const bool ok_b = t < te && q * 8 < o.n_ext;
    const bool ok_a = t < te && s >= 0 && s < T && q * 8 < o.m_ext;
    cp_async16(slot + (r * kWStride + q * 8) * 2,
               o.a + (brow0 + (ok_a ? s : 0)) * o.a_ld + (ok_a ? q * 8 : 0),
               ok_a);
    cp_async16(slot + kWChunk + (r * kWStride + q * 8) * 2,
               o.b + (brow0 + (ok_b ? t : 0)) * o.b_ld + (ok_b ? q * 8 : 0),
               ok_b);
  }
}

// Output tiles of dw_in_s [3C][2C'] and dw_rs_s [C'][n_rs].
template <int kC, int kCP>
constexpr int kSInNt = (2 * kCP + kWTile - 1) / kWTile;
template <int kC, int kCP>
constexpr int kSInTiles = (3 * kC / kWTile) * kSInNt<kC, kCP>;
template <int kC, int kCP>
constexpr int kSRsMt = (kCP + kWTile - 1) / kWTile;

// blockIdx.x: output tile (dw_in_s's, then dw_rs_s's); blockIdx.y: split s
// = b * n_splits_t + ts over rows t of batch row b in [ts * split_rows, (ts
// + 1) * split_rows). Writes its f32 partial to ws[s][...] (dw_in_s then
// dw_rs_s).
template <int kC, int kCP>
__global__ void __launch_bounds__(kThreads, 2)
wn_sbwd_weights_kernel(const bf16* __restrict__ x_bf,
                       const bf16* __restrict__ dgates,
                       const bf16* __restrict__ acts,
                       const bf16* __restrict__ g_bf, float* __restrict__ ws,
                       int T, int dilation, int n_rs, int n_splits_t,
                       int split_rows) {
  constexpr int C = kC;
  constexpr int CP = kCP;
  constexpr int kDwIn = 3 * C * 2 * CP;
  extern __shared__ __align__(16) uint4 smem_sw[];
  const uint32_t ring_s = smem_u32(smem_sw);
  const int tile = blockIdx.x;
  const int split = blockIdx.y;
  const int b = split / n_splits_t;
  const int tb = (split % n_splits_t) * split_rows;
  const int te = min(T, tb + split_rows);
  const int64_t brow0 = static_cast<int64_t>(b) * T;
  const int64_t ws_stride = kDwIn + static_cast<int64_t>(CP) * n_rs;
  SWOperands o;
  float* out;
  int out_ld;
  if (tile < kSInTiles<C, CP>) {
    constexpr int kNt = kSInNt<C, CP>, kCt = C / kWTile;
    const int mt = tile / kNt, nt = tile % kNt;
    const int tap = mt / kCt, ci0 = (mt % kCt) * kWTile;
    o = {x_bf + ci0, dgates + nt * kWTile, C, 2 * CP, (tap - 1) * dilation,
         kWTile, min(kWTile, 2 * CP - nt * kWTile)};
    out = ws + split * ws_stride + (tap * C + ci0) * 2 * CP + nt * kWTile;
    out_ld = 2 * CP;
  } else {
    const int n_nt = n_rs / kWTile;
    const int mt = (tile - kSInTiles<C, CP>) / n_nt;
    const int nt = (tile - kSInTiles<C, CP>) % n_nt;
    o = {acts + mt * kWTile, g_bf + nt * kWTile, CP, n_rs, 0,
         min(kWTile, CP - mt * kWTile), kWTile};
    out = ws + split * ws_stride + kDwIn + mt * kWTile * n_rs + nt * kWTile;
    out_ld = n_rs;
  }
  const int chunks = te > tb ? (te - tb + kK - 1) / kK : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q4 = lane % 4;
  const int m0 = (warp % 2) * 64;  // the warp's 64 output rows
  const int n0 = (warp / 2) * 32;  // and 32 output columns
  // warps wholly past the tile's extents only help load; the extents are
  // multiples of 16 (rows) and 32 (columns)
  const bool live = m0 < o.m_ext && n0 < o.n_ext;

  for (int c = 0; c < kRingAhead; ++c) {
    if (c < chunks) sw_load(ring_s + c * kWStage, c, o, brow0, tb, te, T);
    cp_async_commit();
  }

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;

#pragma unroll 1
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kRingAhead - 1>();
    __syncthreads();
    if (c + kRingAhead < chunks)
      sw_load(ring_s + ((c + kRingAhead) % kRingStages) * kWStage,
              c + kRingAhead, o, brow0, tb, te, T);
    cp_async_commit();
    if (!live) continue;
    const uint32_t slot = ring_s + (c % kRingStages) * kWStage;
#pragma unroll
    for (int kk = 0; kk < kK; kk += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4_t(a[mi], slot + ((kk + lane % 8 + (lane / 16) * 8) * kWStride +
                                 m0 + mi * 16 + ((lane / 8) % 2) * 8) * 2);
#pragma unroll
      for (int pb = 0; pb < 2; ++pb) {
        uint32_t bq[4];
        ldsm_x4_t(bq, slot + kWChunk +
                          ((kk + lane % 8 + ((lane / 8) % 2) * 8) * kWStride +
                           n0 + pb * 16 + (lane / 16) * 8) * 2);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          if (m0 + mi * 16 >= o.m_ext) break;
          mma16816(acc[mi][2 * pb], a[mi], bq[0], bq[1]);
          mma16816(acc[mi][2 * pb + 1], a[mi], bq[2], bq[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  if (!live) return;

#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    if (m0 + mi * 16 >= o.m_ext) break;
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(
            out + (m0 + mi * 16 + g + 8 * h) * out_ld + n0 + nj * 8 + 2 * q4) =
            make_float2(acc[mi][nj][2 * h], acc[mi][nj][2 * h + 1]);
  }
}

// ---- kernel 4: fixed-order sums of the partials, then casts ----------------

// Blocks [0, 2C' / 8): one warp per db_in_s column, its lanes summing every
// 32nd of the rows kernel's n_tiles tiles, then a butterfly. The blocks
// after them: one thread per element of dw_in_s then dw_rs_s, summing the
// n_splits partials of the weights kernel in order.
constexpr int kBiasColsPerBlock = kThreads / 32;

template <int kC, int kCP>
__global__ void __launch_bounds__(kThreads)
wn_sbwd_reduce_kernel(const float* __restrict__ ws, int n_splits,
                      const float* __restrict__ part_bias, int n_tiles,
                      int n_rs, bf16* __restrict__ dw_in,
                      bf16* __restrict__ dw_rs, float* __restrict__ db_in) {
  constexpr int kNb = 2 * kCP;
  constexpr int kDwIn = 3 * kC * 2 * kCP;
  constexpr int kBiasBlocks = kNb / kBiasColsPerBlock;
  if (static_cast<int>(blockIdx.x) < kBiasBlocks) {
    const int col = blockIdx.x * kBiasColsPerBlock + threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    float s = 0.f;
    for (int i = lane; i < n_tiles; i += 32)
      s += part_bias[static_cast<int64_t>(i) * kNb + col];
#pragma unroll
    for (int m = 16; m > 0; m /= 2) s += __shfl_xor_sync(0xffffffffu, s, m);
    if (lane == 0) db_in[col] = s;
    return;
  }
  const int64_t ws_stride = kDwIn + static_cast<int64_t>(kCP) * n_rs;
  const int64_t w =
      static_cast<int64_t>(blockIdx.x - kBiasBlocks) * kThreads + threadIdx.x;
  if (w >= ws_stride) return;
  float s = 0.f;
  for (int i = 0; i < n_splits; ++i) s += ws[i * ws_stride + w];
  const bf16 v = __float2bfloat16(s);
  if (w < kDwIn) dw_in[w] = v;
  else dw_rs[w - kDwIn] = v;
}

// ---- launch ----------------------------------------------------------------

// The opt-in to more than 48 KB of dynamic shared memory, made once per
// kernel and device (bit `device` of `*done`).
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, int bytes, std::atomic<uint32_t>* done) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const uint32_t bit = 1u << (device & 31);
  if (done->load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done->fetch_or(bit, std::memory_order_release);
  return err;
}

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
};

template <int kC, int kCP, bool kLast>
cudaError_t launch_srows(const SArgs& a, cudaStream_t stream) {
  static std::atomic<uint32_t> opted_in{0};
  using L = SRows<kC, kCP, kLast>;
  auto kernel = wn_sbwd_rows_kernel<kC, kCP, kLast>;
  cudaError_t err = opt_in_smem(kernel, L::kSmem, &opted_in);
  if (err != cudaSuccess) return err;
  dim3 grid((a.T + L::kTileRows - 1) / L::kTileRows, a.batch);
  kernel<<<grid, kThreads, L::kSmem, stream>>>(
      a.x, a.cond, a.w_in, a.b_in, a.w_rs, a.g, a.dcond, a.acts, a.x_bf,
      a.g_bf, a.part_bias, a.T, a.dilation);
  return cudaGetLastError();
}

template <int kC, int kCP>
cudaError_t shard_backward(const SArgs& a, int last, cudaStream_t stream) {
  const int n_rs = last ? kC : 2 * kC;
  cudaError_t err = last ? launch_srows<kC, kCP, true>(a, stream)
                         : launch_srows<kC, kCP, false>(a, stream);
  if (err != cudaSuccess) return err;

  static std::atomic<uint32_t> dx_opted{0}, w_opted{0};
  err = opt_in_smem(wn_sbwd_dx_kernel<kC, kCP>, kDxSmem, &dx_opted);
  if (err != cudaSuccess) return err;
  wn_sbwd_dx_kernel<kC, kCP>
      <<<dim3((a.T + kRT - 1) / kRT, kC / kRT, a.batch), kThreads, kDxSmem,
         stream>>>(a.dcond, a.w_in, a.dx, a.T, a.dilation);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = opt_in_smem(wn_sbwd_weights_kernel<kC, kCP>, kWSmem, &w_opted);
  if (err != cudaSuccess) return err;
  const int n_tiles_w = kSInTiles<kC, kCP> + kSRsMt<kC, kCP> * (n_rs / kWTile);
  wn_sbwd_weights_kernel<kC, kCP>
      <<<dim3(n_tiles_w, a.batch * a.n_splits_t), kThreads, kWSmem, stream>>>(
          a.x_bf, a.dcond, a.acts, a.g_bf, a.ws, a.T, a.dilation, n_rs,
          a.n_splits_t, a.split_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int kTile = SRows<kC, kCP, false>::kTileRows;
  const int tiles_t = (a.T + kTile - 1) / kTile;
  const int64_t n_w = 3 * kC * 2 * kCP + static_cast<int64_t>(kCP) * n_rs;
  const int blocks = 2 * kCP / kBiasColsPerBlock +
                     static_cast<int>((n_w + kThreads - 1) / kThreads);
  wn_sbwd_reduce_kernel<kC, kCP><<<blocks, kThreads, 0, stream>>>(
      a.ws, a.batch * a.n_splits_t, a.part_bias, a.batch * tiles_t, n_rs,
      a.dw_in, a.dw_rs, a.db_in);
  return cudaGetLastError();
}

// The kernel `which` (0 rows, 1 dx, 2 weights, 3 reduce; `last` picks the
// rows kernel's variant) at (kC, kCP) as a function pointer, and its
// dynamic shared bytes.
template <int kC, int kCP>
const void* sbwd_kernel_for(int which, int last, int* smem_bytes) {
  switch (which) {
    case 0:
      *smem_bytes = last ? SRows<kC, kCP, true>::kSmem
                         : SRows<kC, kCP, false>::kSmem;
      return last ? reinterpret_cast<const void*>(
                        wn_sbwd_rows_kernel<kC, kCP, true>)
                  : reinterpret_cast<const void*>(
                        wn_sbwd_rows_kernel<kC, kCP, false>);
    case 1:
      *smem_bytes = kDxSmem;
      return reinterpret_cast<const void*>(wn_sbwd_dx_kernel<kC, kCP>);
    case 2:
      *smem_bytes = kWSmem;
      return reinterpret_cast<const void*>(wn_sbwd_weights_kernel<kC, kCP>);
    default:
      *smem_bytes = 0;
      return reinterpret_cast<const void*>(wn_sbwd_reduce_kernel<kC, kCP>);
  }
}

// The built (C, C') pairs (those of the forward shard kernel), for the
// dispatch below.
#define WN_SBWD_PAIRS(X)                                                   \
  X(128, 64) X(128, 32) X(128, 16) X(256, 128) X(256, 64) X(256, 32)        \
  X(512, 256) X(512, 128) X(512, 64)

}  // namespace

extern "C" {

// The bf16 backward of one model rank's share of a layer, four launches on
// `stream`, no synchronisation; returns the first launch error.
// Inputs ((C, C') a built pair): x [batch, T, C] f32; cond [batch, T, 2C'],
// w_in [3C, 2C'], w_rs [C', n_rs] bf16 (n_rs = C when last, else 2C); b_in
// [2C'] f32; g [batch, T, n_rs] f32. Outputs: dx f32 like x (the rank's
// partial), dcond bf16 like cond, dw_in / dw_rs bf16 like the weights,
// db_in f32. Scratch, from the caller: acts [batch*T, C'], x_bf [batch*T,
// C], g_bf [batch*T, n_rs] bf16; part_bias [batch * ceil(T/tile), 2C'] f32
// (tile: wn_layer_shard_bwd_tile_rows(C, C')); ws [batch * n_splits_t,
// 3C*2C' + C'*n_rs] f32. The weights kernel splits each batch row's T into
// n_splits_t ranges of split_rows rows. Pointers 16-byte aligned,
// contiguous.
cudaError_t wn_layer_shard_backward_bf16(
    const float* x, const void* cond, const void* w_in, const float* b_in,
    const void* w_rs, const float* g, float* dx, void* dcond, void* dw_in,
    float* db_in, void* dw_rs, void* acts, void* x_bf, void* g_bf,
    float* part_bias, float* ws, int batch, int T, int C, int cp,
    int dilation, int last, int n_splits_t, int split_rows,
    cudaStream_t stream) {
  if (T <= 0 || batch <= 0 || batch > 65535 || n_splits_t <= 0 ||
      split_rows <= 0 || static_cast<int64_t>(batch) * n_splits_t > 65535 ||
      static_cast<int64_t>(n_splits_t) * split_rows < T)
    return cudaErrorInvalidValue;
  const SArgs a{x,
                static_cast<const bf16*>(cond),
                static_cast<const bf16*>(w_in),
                b_in,
                static_cast<const bf16*>(w_rs),
                g,
                dx,
                static_cast<bf16*>(dcond),
                static_cast<bf16*>(dw_in),
                db_in,
                static_cast<bf16*>(dw_rs),
                static_cast<bf16*>(acts),
                static_cast<bf16*>(x_bf),
                static_cast<bf16*>(g_bf),
                part_bias,
                ws,
                batch,
                T,
                dilation,
                n_splits_t,
                split_rows};
#define WN_SBWD_CALL(WIDTH, CP) \
  if (C == WIDTH && cp == CP) return shard_backward<WIDTH, CP>(a, last, stream);
  WN_SBWD_PAIRS(WN_SBWD_CALL)
#undef WN_SBWD_CALL
  return cudaErrorInvalidValue;
}

// Time rows of the rows kernel's tile at (C, C') (its part_bias rows a
// batch row are ceil(T / this)), or -1 for a pair it is not built for.
int wn_layer_shard_bwd_tile_rows(int C, int cp) {
#define WN_SBWD_TILE(WIDTH, CP) \
  if (C == WIDTH && cp == CP) return SRows<WIDTH, CP, false>::kTileRows;
  WN_SBWD_PAIRS(WN_SBWD_TILE)
#undef WN_SBWD_TILE
  return -1;
}

// What the loaded build of shard-backward kernel `which` (0 rows, 1 dx, 2
// weights, 3 reduce; `last` picks the rows variant) at (C, C') uses, from
// the CUDA runtime: registers and local (spill) bytes per thread, static
// shared bytes, and the dynamic shared bytes its launcher passes.
cudaError_t wn_layer_shard_bwd_kernel_info(int C, int cp, int which, int last,
                                           int* registers, int* local_bytes,
                                           int* static_smem_bytes,
                                           int* dynamic_smem_bytes) {
  const void* kernel = nullptr;
#define WN_SBWD_INFO(WIDTH, CP)                                       \
  if (C == WIDTH && cp == CP)                                         \
    kernel = sbwd_kernel_for<WIDTH, CP>(which, last, dynamic_smem_bytes);
  WN_SBWD_PAIRS(WN_SBWD_INFO)
#undef WN_SBWD_INFO
  if (kernel == nullptr) return cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  *registers = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *static_smem_bytes = static_cast<int>(attr.sharedSizeBytes);
  return cudaSuccess;
}

}  // extern "C"
