// Fused WN layer backward for Hopper (sm_90a), bf16 (fast) mode only, CUDA
// C++ with a plain C interface (bound from Python with ctypes, see
// kernels/wn_layer.py::wn_layer_backward_fused).
//
// Replaces waveglow_tpu/kernels/wn_layer.py::_wn_layer_trainable_bwd, the
// backward of the custom VJP wn_layer_trainable (XLA code on the TPU, not a
// kernel there). It computes the function, at these rounding points:
//
//   taps   = bf16(x) shifted by (tap-1)*d, zero outside [0, T)
//   gates  = taps @ w_in + b_in + cond          (f32 accumulation, f32 adds)
//   t = tanh(gates[:C]), s = sigmoid(gates[C:]), acts = t * s      (f32)
//   drs    = [dx_next masked at rows >= valid_t | dskip]   (last: dskip)
//   dacts  = bf16(drs) @ w_rs^T                  (f32 accumulation)
//   dgates = [dacts*s*(1-t^2) | dacts*t*s*(1-s)]                   (f32)
//   dcond  = bf16(dgates)
//   db_in  = sum_rows dgates, db_rs = sum_rows drs (f32, not their roundings)
//   dw_in  = bf16(cast of) taps^T @ bf16(dgates)  (f32 sums, then bf16)
//   dw_rs  = bf16(cast of) bf16(acts)^T @ bf16(drs)
//   dx     = dx_next masked + sum_tap shift(bf16(dgates) @ w_in[tap]^T,
//            -(tap-1)*d)                         (f32)
//
// Why bf16 product operands are faithful: none of the dots of
// _wn_layer_trainable_bwd passes precision=, and on the JAX package's own
// chip an f32 dot without it runs as one bf16 pass with f32 accumulation
// (waveglow_tpu/ops/conv.py, docs/ARCHITECTURE.md). Parity (f32) mode keeps
// true f32 products and does not use this file.
//
// What bounds it on an H100 SXM: at B=12, T=2,000, C=256 (a non-last layer)
// the gradients need 50.3 GFLOP of products (dacts, dw_rs, dw_in and the
// taps' adjoint; the gate recompute adds 18.9), 0.051 ms at 989 TFLOP/s on
// the tensor cores, above the 0.045 ms of its ~150 MB of HBM traffic. So it
// is operation-bound, and every product runs on the tensor cores as
// mma.sync m16n8k16 (bf16 operands, f32 accumulators) fed by ldmatrix from
// padded shared memory (row strides of 16 bytes past a multiple of 128, so
// the 8 rows of an 8x8 matrix fall in different banks).
//
// Four kernels, launched in order on one stream:
//   wn_bwd_rows_kernel<last> - per 64-row time tile (one block per SM, 8
//     warps of 32 rows x 32 channels; 32 rows and 16 channels at C = 512): stages the three bf16 tap windows
//     in shared memory and bf16(drs) into a global scratch, then in two
//     passes over 128-channel blocks recomputes the tanh and sigmoid
//     pre-activations (K = 3C) and dacts (K = n_rs, drs read back through
//     the ring) of the same channels into accumulators that sit in the
//     same thread, so the gate and its adjoint run on the accumulators
//     (cond prefetched into registers during the pass's dacts chunks).
//     Writes dcond, bf16 acts and bf16 x (scratch operands of the weights
//     kernel) and per-tile f32 column sums of dgates and drs.
//   wn_bwd_dx_kernel - per 128 rows x 128 channels (two blocks per SM):
//     dx = dx_next masked + a 3-tap dilated product over bf16 dgates with
//     the offsets negated (K = 3*2C), same halo and ragged-T contract as
//     the forward.
//   wn_bwd_weights_kernel - dw_in (6 x 4 tiles of 128x128) and dw_rs
//     (2 x n_rs/128 tiles): long-K reductions over the rows, split into
//     row ranges (per batch row) over the grid's y; f32 partials go to a
//     workspace, one slice per range.
//   wn_bwd_reduce_kernel - sums the partials and the per-tile bias sums in
//     a fixed order, then casts. No atomics anywhere: two launches give the
//     same bits.
// All operand chunks stream through cp.async rings (zero-filled rows
// outside [0, T)): 6 stages in the rows kernel, 4 in the dx and weights
// kernels. Built for C in {128, 256, 512} (the width is a template
// parameter; the rows kernel runs C / 128 passes of 128 channels). At
// C = 512 three 64-row tap windows would take 199,680 bytes of shared
// memory, so the rows kernel's tile there holds 32 rows (one row warp,
// eight column warps of 16 channels; 213,504 bytes).
//
// Measured on an NVIDIA H100 80GB HBM3 (700 W) by chip_smoke.py at the
// shape above (d=1): the four kernels 0.47 ms against the 0.051 ms bound,
// the rows kernel about half of it. Its main loop is not bound by the
// tensor cores: each wave of tiles first stages its taps and drs from HBM
// all at once, and the epilogues run with the tensor cores idle. PERF.md
// keeps the times; wn_layer_bwd_kernel_info reports each kernel's
// registers, spills and shared memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;          // 8 warps
constexpr int kK = 32;                 // K rows of one pipeline chunk
constexpr int kBlockCh = 128;          // channels of one rows-kernel pass
constexpr int kInStride = 2 * kBlockCh + 8;  // w_in chunk row (tanh|sigmoid)
constexpr int kKStride = kK + 8;       // a [rows][32] chunk row: 80 bytes
constexpr int kWTile = 128;            // weights kernel output tile edge
constexpr int kWStride = kWTile + 8;   // [32][128] chunk row: 272 bytes
// Elements of dw_in, and its output tiles (24 at C = 256).
template <int kC>
constexpr int kDwIn = 3 * kC * 2 * kC;
template <int kC>
constexpr int kDwInTiles = (3 * kC / kWTile) * (2 * kC / kWTile);

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

// The two bf16 of a packed pair (the lower address first) as f32, exactly.
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return make_float2(__uint_as_float(v << 16),
                     __uint_as_float(v & 0xffff0000u));
}

// Lane offsets of ldmatrix.x4 row addresses, in (row, column) of the
// stored tile, for the three operand shapes used here:
//   A row-major [rows][k]:  rows +lane%16, k +8*(lane/16)
//   B stored [n][k] (no .trans), two n8 blocks: n +lane%8 +8*(lane/16),
//     k +8*((lane/8)%2)
//   stored [k][n] (.trans; B, or A^T), two 8-blocks of the free axis:
//     k +lane%8 +8*((lane/8)%2) for B, +8*(lane/16) for A^T; and the free
//     axis +8*(lane/16) for B, +8*((lane/8)%2) for A^T.

// ---- kernel 1: rows (gate recompute, dacts, gate adjoint) -----------------

// The rows kernel's layout at width kC. A tile holds 64 time rows (two
// row warps of 32, four column warps of 32 channels) at C <= 256; at
// C = 512, 32 rows (one row warp, eight column warps of 16 channels), so
// the three tap windows fit in shared memory beside the ring.
template <int kC, bool kLast>
struct RowsLayout {
  static constexpr int kNrs = kLast ? kC : 2 * kC;
  static constexpr int kTileRows = kC > 256 ? 32 : 64;
  static constexpr int kRowWarps = kTileRows / 32;
  static constexpr int kWarpCh = kBlockCh * kRowWarps / 8;  // 32 or 16
  static constexpr int kNB = kWarpCh / 8;                   // n8 blocks
  static constexpr int kWinStride = kC + 8;  // tap window row: 528 bytes
  static constexpr int kTapBytes = 3 * kTileRows * kWinStride * 2;  // 101,376
  static constexpr int kInChunkBytes = kK * kInStride * 2;        // 16,896
  static constexpr int kRsChunkBytes = kBlockCh * kKStride * 2;   // 10,240
  static constexpr int kDrsChunkBytes = kTileRows * kKStride * 2;  // 5,120
  static constexpr int kStageBytes =
      kInChunkBytes > kRsChunkBytes + kDrsChunkBytes
          ? kInChunkBytes : kRsChunkBytes + kDrsChunkBytes;
  static constexpr int kStages = 6;              // ring depth
  static constexpr int kAhead = kStages - 1;     // chunks loading ahead
  // dgates column sums of the two row warps, then drs column sums of the
  // staging's row groups (kGroups of them, see the drs staging)
  static constexpr int kRedBytes = 2 * 2 * kC * 4;                // 4,096
  static constexpr int kQuads = kNrs / 4;           // float4 columns of drs
  static constexpr int kGroups = kThreads / kQuads;  // 2 (last: 4)
  static constexpr int kGroupRows = kTileRows / kGroups;
  static constexpr int kDrsSumBytes = kGroups * kNrs * 4;         // 4,096
  static constexpr int kSmem =
      kTapBytes + kStages * kStageBytes + kRedBytes + kDrsSumBytes;
  static constexpr int kInChunks = 3 * kC / kK;   // 24 K chunks of w_in
  static constexpr int kRsChunks = kNrs / kK;     // 16 (last: 8) of w_rs
  static constexpr int kPerPass = kInChunks + kRsChunks;
  static constexpr int kPasses = kC / kBlockCh;   // 128-channel passes
  static constexpr int kChunks = kPasses * kPerPass;
  static_assert(kAhead <= kInChunks,
                "the prologue's chunks must not read the drs scratch");
  static_assert(kSmem <= 232448, "over 227 KB");
};

// Start the copies of chunk `c` of the rows kernel into ring slot `slot`:
// in pass c / kPerPass (channel block cb), first the w_in rows [k0, k0+32)
// restricted to the tanh columns [cb, cb+128) (stored at 0..127) and the
// sigmoid columns [C+cb, C+cb+128) (stored at 128..255), as [k][n]; then
// w_rs rows [cb, cb+128), columns [k0, k0+32), as [n][k], and beside them
// the tile's bf16 drs rows, columns [k0, k0+32), from the scratch this
// block wrote before its first chunk (zero past T).
template <int kC, bool kLast>
__device__ __forceinline__ void rows_load(uint32_t slot, int c,
                                          const bf16* w_in, const bf16* w_rs,
                                          const bf16* drs, int64_t row0,
                                          int rows) {
  using L = RowsLayout<kC, kLast>;
  const int j = c % L::kPerPass;
  const int cb = (c / L::kPerPass) * kBlockCh;
  if (j < L::kInChunks) {
    const int k0 = j * kK;
#pragma unroll
    for (int i = 0; i < kK * 32 / kThreads; ++i) {  // 32 pieces a row
      const int p = threadIdx.x + i * kThreads;
      const int r = p / 32, q = p % 32;
      const int col = q < 16 ? cb + q * 8 : kC + cb + (q - 16) * 8;
      cp_async16(slot + (r * kInStride + q * 8) * 2,
                 w_in + (k0 + r) * 2 * kC + col, true);
    }
  } else {
    const int k0 = (j - L::kInChunks) * kK;
#pragma unroll
    for (int i = 0; i < kBlockCh * 4 / kThreads; ++i) {  // 4 pieces a row
      const int p = threadIdx.x + i * kThreads;
      const int n = p / 4, q = p % 4;
      cp_async16(slot + (n * kKStride + q * 8) * 2,
                 w_rs + (cb + n) * L::kNrs + k0 + q * 8, true);
    }
    const int r = threadIdx.x / 4, q = threadIdx.x % 4;  // tile rows x 4
    if (r < L::kTileRows)
      cp_async16(slot + L::kRsChunkBytes + (r * kKStride + q * 8) * 2,
                 drs + (row0 + (r < rows ? r : 0)) * L::kNrs + k0 + q * 8,
                 r < rows);
  }
}

template <int kC, bool kLast>
__global__ void __launch_bounds__(kThreads, 1)
wn_bwd_rows_kernel(const float* __restrict__ x, const bf16* __restrict__ cond,
                   const bf16* __restrict__ w_in,
                   const float* __restrict__ b_in,
                   const bf16* __restrict__ w_rs,
                   const float* __restrict__ dx_next,
                   const float* __restrict__ dskip,
                   const int* __restrict__ valid_t, bf16* __restrict__ dcond,
                   bf16* __restrict__ acts_out, bf16* __restrict__ x_bf,
                   bf16* __restrict__ drs_out, float* __restrict__ part_bias,
                   int T, int dilation) {
  using L = RowsLayout<kC, kLast>;
  constexpr int C = kC;
  constexpr int N_RS = L::kNrs;
  constexpr int kWinStride = L::kWinStride;
  constexpr int kTile = L::kTileRows;
  constexpr int kNB = L::kNB;
  extern __shared__ __align__(16) uint4 smem_rows[];
  char* base = reinterpret_cast<char*>(smem_rows);
  bf16* taps = reinterpret_cast<bf16*>(base);
  const uint32_t taps_s = smem_u32(taps);
  const uint32_t ring_s = taps_s + L::kTapBytes;
  float* red = reinterpret_cast<float*>(base + L::kTapBytes +
                                        L::kStages * L::kStageBytes);
  float* drs_sum = red + L::kRedBytes / 4;

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTile;
  const int rows = min(kTile, T - t0);
  const int64_t row0 = static_cast<int64_t>(b) * T + t0;
  const int tile_id = b * gridDim.x + blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q4 = lane % 4;
  const int wr = warp % L::kRowWarps, r32 = wr * 32;  // the warp's 32 rows
  const int cw = (warp / L::kRowWarps) * L::kWarpCh;  // its channels of a
                                                      // pass block

  // the first chunks (w_in only) load while the tile is staged
  for (int c = 0; c < L::kAhead; ++c) {
    rows_load<kC, kLast>(ring_s + c * L::kStageBytes, c, w_in, w_rs, drs_out,
                         row0, rows);
    cp_async_commit();
  }

  // ---- taps: window w, row r <- bf16(x[t0 + r + (w-1)*d]), zero outside
  // [0, T); window 1 (rows < T) also goes out as the bf16 x scratch
  {
    constexpr int kQ = C / 4;  // float4 per row
    constexpr int kTotal = 3 * kTile * kQ;
    // loads in flight per thread: 16, or 8 where 16 leave a partial round
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
        *reinterpret_cast<uint2*>(taps + i * kWinStride + c4) = pk;
        const int r = i - kTile;
        if (r >= 0 && r < rows)
          *reinterpret_cast<uint2*>(x_bf + (row0 + r) * C + c4) = pk;
      }
    }
  }

  // ---- drs = [dx_next masked | dskip] (None = zero), rounded to bf16 into
  // the scratch (read back through the ring as dacts' A operand). Thread:
  // 4 columns of one of kGroups row groups; f32 column sums over the
  // group's rows, in row order
  {
    const int valid = valid_t != nullptr ? valid_t[b] : T;
    const int c = (threadIdx.x % L::kQuads) * 4;
    const int grp = threadIdx.x / L::kQuads;
    const bool from_dxn = !kLast && c < C;
    const float* src = from_dxn ? dx_next : dskip;
    const int col = from_dxn || kLast ? c : c - C;
    const int live_rows = from_dxn ? max(0, min(rows, valid - t0)) : rows;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 16
    for (int i = 0; i < L::kGroupRows; ++i) {
      const int r = grp * L::kGroupRows + i;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (src != nullptr && r < live_rows)
        v = *reinterpret_cast<const float4*>(src + (row0 + r) * C + col);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
      if (r < rows)
        *reinterpret_cast<uint2*>(drs_out + (row0 + r) * N_RS + c) =
            make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
    }
    *reinterpret_cast<float4*>(drs_sum + grp * N_RS + c) = sum;
    // other threads of the block read the scratch back with cp.async.cg,
    // which bypasses L1: make the stores visible in L2 before the ring's
    // first barrier
    __threadfence();
  }

  // ---- C / 128 passes over 128-channel blocks: acc_t / acc_s the tanh and
  // sigmoid pre-activations, acc_d dacts, of the same (row, channel) in
  // the same thread: m16 block mi, n8 block nb, element e is row
  // r32 + 16mi + g + 8(e/2), channel cb + cw + 8nb + 2q4 + e%2
  float acc_t[2][kNB][4], acc_s[2][kNB][4], acc_d[2][kNB][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc_t[mi][nb][e] = acc_s[mi][nb][e] = acc_d[mi][nb][e] = 0.f;

  // cond of the pass's epilogue, fetched during its dacts chunks:
  // [mi][nb][h] the tanh and sigmoid pairs of the thread's channels
  uint32_t cond_t[2][kNB][2], cond_s[2][kNB][2];

#pragma unroll 1
  for (int c = 0; c < L::kChunks; ++c) {
    // chunk c landed for every thread; chunk c-1's slot is free (and, past
    // the first barrier, the drs scratch is written for every thread)
    cp_async_wait<L::kAhead - 1>();
    __syncthreads();
    if (c + L::kAhead < L::kChunks)
      rows_load<kC, kLast>(
          ring_s + ((c + L::kAhead) % L::kStages) * L::kStageBytes,
          c + L::kAhead, w_in, w_rs, drs_out, row0, rows);
    cp_async_commit();
    const uint32_t slot = ring_s + (c % L::kStages) * L::kStageBytes;
    const int j = c % L::kPerPass;
    if (j == L::kInChunks) {
      const int cb = (c / L::kPerPass) * kBlockCh;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = r32 + 16 * mi + g + 8 * h;
            const bf16* cr = cond + (row0 + row) * 2 * C + cb + cw + 8 * nb +
                             2 * q4;
            cond_t[mi][nb][h] = cond_s[mi][nb][h] = 0u;  // bf16 zeros
            if (row < rows) {
              cond_t[mi][nb][h] = *reinterpret_cast<const uint32_t*>(cr);
              cond_s[mi][nb][h] = *reinterpret_cast<const uint32_t*>(cr + C);
            }
          }
    }
    if (j < L::kInChunks) {
      const int tap = j / (C / kK);
      const int kin = (j % (C / kK)) * kK;
#pragma unroll
      for (int kk = 0; kk < kK; kk += 16) {
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldsm_x4(a[mi], taps_s + ((tap * kTile + r32 + 16 * mi + lane % 16) *
                                       kWinStride + kin + kk +
                                   (lane / 16) * 8) * 2);
        const uint32_t brow =
            slot + ((kk + lane % 8 + ((lane / 8) % 2) * 8) * kInStride +
                    cw + (lane / 16) * 8) * 2;
#pragma unroll
        for (int pb = 0; pb < kNB / 2; ++pb) {
          uint32_t bt[4], bs[4];
          ldsm_x4_t(bt, brow + pb * 16 * 2);
          ldsm_x4_t(bs, brow + (kBlockCh + pb * 16) * 2);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
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
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldsm_x4(a[mi], slot + L::kRsChunkBytes +
                             ((r32 + 16 * mi + lane % 16) * kKStride + kk +
                              (lane / 16) * 8) * 2);
#pragma unroll
        for (int pb = 0; pb < kNB / 2; ++pb) {
          uint32_t bd[4];
          ldsm_x4(bd, slot + ((cw + pb * 16 + lane % 8 + (lane / 16) * 8) *
                                  kKStride + kk + ((lane / 8) % 2) * 8) * 2);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma16816(acc_d[mi][2 * pb], a[mi], bd[0], bd[1]);
            mma16816(acc_d[mi][2 * pb + 1], a[mi], bd[2], bd[3]);
          }
        }
      }
    }
    if (j != L::kPerPass - 1) continue;

    // ---- gate and its adjoint on the accumulators (f32) -------------------
    // Rows >= T have zero taps, cond and drs: finite gates, zero dgates.
    const int cb = (c / L::kPerPass) * kBlockCh;
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
      const int ch = cb + cw + 8 * nb + 2 * q4;
      const float2 bt = *reinterpret_cast<const float2*>(b_in + ch);
      const float2 bs = *reinterpret_cast<const float2*>(b_in + C + ch);
      float sa0 = 0.f, sa1 = 0.f, sb0 = 0.f, sb1 = 0.f;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r32 + 16 * mi + g + 8 * h;
          const int64_t grow = row0 + row;
          const float2 ct = unpack_bf16(cond_t[mi][nb][h]);
          const float2 cs = unpack_bf16(cond_s[mi][nb][h]);
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
            *reinterpret_cast<uint32_t*>(acts_out + grow * C + ch) =
                pack_bf16(act[0], act[1]);
            *reinterpret_cast<uint32_t*>(dcond + grow * 2 * C + ch) =
                pack_bf16(da[0], da[1]);
            *reinterpret_cast<uint32_t*>(dcond + grow * 2 * C + C + ch) =
                pack_bf16(db[0], db[1]);
          }
        }
      // column sums over the warp's 32 rows (fixed butterfly order)
#pragma unroll
      for (int m = 4; m < 32; m *= 2) {
        sa0 += __shfl_xor_sync(0xffffffffu, sa0, m);
        sa1 += __shfl_xor_sync(0xffffffffu, sa1, m);
        sb0 += __shfl_xor_sync(0xffffffffu, sb0, m);
        sb1 += __shfl_xor_sync(0xffffffffu, sb1, m);
      }
      if (g == 0) {
        float* rw = red + wr * 2 * C;
        rw[ch] = sa0;
        rw[ch + 1] = sa1;
        rw[C + ch] = sb0;
        rw[C + ch + 1] = sb1;
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc_t[mi][nb][e] = acc_s[mi][nb][e] = acc_d[mi][nb][e] = 0.f;
  }

  // ---- the tile's column sums: dgates over the row warps, drs over the
  // staging's row groups, in order
  __syncthreads();
  float* out = part_bias + static_cast<int64_t>(tile_id) * (2 * C + N_RS);
  for (int col = threadIdx.x; col < 2 * C; col += kThreads) {
    if constexpr (L::kRowWarps == 2) out[col] = red[col] + red[2 * C + col];
    else out[col] = red[col];
  }
  for (int col = threadIdx.x; col < N_RS; col += kThreads) {
    float sum = drs_sum[col];
#pragma unroll
    for (int grp = 1; grp < L::kGroups; ++grp) sum += drs_sum[grp * N_RS + col];
    out[2 * C + col] = sum;
  }
}

// ---- kernel 2: dx, the taps' adjoint ----------------------------------------

// Block tile: 128 rows x 128 output channels; warp tile 64 x 32 (4 m16 x 4
// n8: 6 ldmatrix for 16 mma). K runs tap-major over 3 x 2C in chunks of 32.
constexpr int kRT = 128;                          // rows and channels a block
constexpr int kRingStages = 4;                    // dx and weights rings
constexpr int kRingAhead = kRingStages - 1;       // chunks loading ahead
constexpr int kDxChunkBytes = kRT * kKStride * 2;  // 10,240: [128][32]
constexpr int kDxStage = 2 * kDxChunkBytes;       // A then B
constexpr int kDxSmem = kRingStages * kDxStage;   // 81,920
template <int kC>
constexpr int kDxChunks = 3 * 2 * kC / kK;        // 48 at C = 256

// Chunk c: tap c / 16, gate channels m0 = (c % 16) * 32. A: dgates rows
// t0 + r - (tap-1)*d (zero outside [0, T)); B: w_in[tap*C + n0 + n][m0..+32)
// as [n][k].
template <int kC>
__device__ __forceinline__ void dx_load(uint32_t slot, int c,
                                        const bf16* dgates, const bf16* w_in,
                                        int64_t brow0, int t0, int n0, int T,
                                        int dilation) {
  const int tap = c / (2 * kC / kK);
  const int m0 = (c % (2 * kC / kK)) * kK;
#pragma unroll
  for (int i = 0; i < kRT * 4 / kThreads; ++i) {  // 4 pieces a row
    const int p = threadIdx.x + i * kThreads;
    const int r = p / 4, q = p % 4;
    const int s = t0 + r - (tap - 1) * dilation;
    const bool ok = s >= 0 && s < T;
    cp_async16(slot + (r * kKStride + q * 8) * 2,
               dgates + (brow0 + (ok ? s : 0)) * 2 * kC + m0 + q * 8, ok);
    cp_async16(slot + kDxChunkBytes + (r * kKStride + q * 8) * 2,
               w_in + (tap * kC + n0 + r) * 2 * kC + m0 + q * 8, true);
  }
}

template <int kC>
__global__ void __launch_bounds__(kThreads, 2)
wn_bwd_dx_kernel(const bf16* __restrict__ dgates, const bf16* __restrict__ w_in,
                 const float* __restrict__ dx_next,
                 const int* __restrict__ valid_t, float* __restrict__ dx,
                 int T, int dilation) {
  constexpr int C = kC;
  extern __shared__ __align__(16) uint4 smem_dx[];
  const uint32_t ring_s = smem_u32(smem_dx);
  const int b = blockIdx.z;
  const int t0 = blockIdx.x * kRT;
  const int n0 = blockIdx.y * kRT;  // the block's output channels
  const int rows = min(kRT, T - t0);
  const int64_t brow0 = static_cast<int64_t>(b) * T;
  const int64_t row0 = brow0 + t0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q4 = lane % 4;
  const int m0 = (warp % 2) * 64;        // the warp's 64 rows
  const int nw = n0 + (warp / 2) * 32;   // and 32 output channels

  for (int c = 0; c < kRingAhead; ++c) {
    dx_load<kC>(ring_s + c * kDxStage, c, dgates, w_in, brow0, t0, n0, T,
                dilation);
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
  for (int c = 0; c < kDxChunks<kC>; ++c) {
    // chunk c landed for every thread; chunk c-1's slot is free
    cp_async_wait<kRingAhead - 1>();
    __syncthreads();
    if (c + kRingAhead < kDxChunks<kC>)
      dx_load<kC>(ring_s + ((c + kRingAhead) % kRingStages) * kDxStage,
              c + kRingAhead, dgates, w_in, brow0, t0, n0, T, dilation);
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

  // ---- epilogue: + dx_next (zero at rows >= valid_t, or None), rows < T --
  const int valid = valid_t != nullptr ? valid_t[b] : T;
#pragma unroll
  for (int mh = 0; mh < 8; ++mh) {
    const int mi = mh / 2, h = mh % 2;
    const int row = m0 + 16 * mi + g + 8 * h;
    if (row >= rows) continue;
    const bool live = dx_next != nullptr && t0 + row < valid;
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      const int64_t off = (row0 + row) * C + nw + 8 * nj + 2 * q4;
      float2 v = make_float2(acc[mi][nj][2 * h], acc[mi][nj][2 * h + 1]);
      if (live) {
        const float2 dn = *reinterpret_cast<const float2*>(dx_next + off);
        v.x += dn.x;
        v.y += dn.y;
      }
      *reinterpret_cast<float2*>(dx + off) = v;
    }
  }
}

// ---- kernel 3: weight gradients, row-split partials -----------------------

constexpr int kWChunk = kK * kWStride * 2;       // 8,704: [32 rows][128]
constexpr int kWStage = 2 * kWChunk;
constexpr int kWSmem = kRingStages * kWStage;    // 69,632

struct WOperands {
  const bf16* a;  // [rows][a_ld], the tile's 128 columns
  const bf16* b;  // [rows][b_ld]
  int a_ld, b_ld, a_shift;
};

// Rows [t, t+32) of the split (t from tb + 32c) into A and B chunks, each
// [32 rows][128] with row t of A read from row t + a_shift; zero outside
// [0, T) and past the split's end te.
__device__ __forceinline__ void w_load(uint32_t slot, int c, const WOperands& o,
                                       int64_t brow0, int tb, int te, int T) {
#pragma unroll
  for (int i = 0; i < kK * 16 / kThreads; ++i) {  // 16 pieces a row
    const int p = threadIdx.x + i * kThreads;
    const int r = p / 16, q = p % 16;
    const int t = tb + c * kK + r;
    const int s = t + o.a_shift;
    const bool ok_b = t < te;
    const bool ok_a = ok_b && s >= 0 && s < T;
    cp_async16(slot + (r * kWStride + q * 8) * 2,
               o.a + (brow0 + (ok_a ? s : 0)) * o.a_ld + q * 8, ok_a);
    cp_async16(slot + kWChunk + (r * kWStride + q * 8) * 2,
               o.b + (brow0 + (ok_b ? t : 0)) * o.b_ld + q * 8, ok_b);
  }
}

// blockIdx.x: output tile (dw_in's 24, then dw_rs's 2 * n_rs / 128);
// blockIdx.y: split s = b * n_splits_t + ts over rows t of batch row b in
// [ts * split_rows, (ts + 1) * split_rows). Writes its f32 partial to
// ws[s][...] (dw_in [3C][2C] then dw_rs [C][n_rs]).
template <int kC>
__global__ void __launch_bounds__(kThreads, 2)
wn_bwd_weights_kernel(const bf16* __restrict__ x_bf,
                      const bf16* __restrict__ dgates,
                      const bf16* __restrict__ acts,
                      const bf16* __restrict__ drs, float* __restrict__ ws,
                      int T, int dilation, int n_rs, int n_splits_t,
                      int split_rows) {
  constexpr int C = kC;
  extern __shared__ __align__(16) uint4 smem_w[];
  const uint32_t ring_s = smem_u32(smem_w);
  const int tile = blockIdx.x;
  const int split = blockIdx.y;
  const int b = split / n_splits_t;
  const int tb = (split % n_splits_t) * split_rows;
  const int te = min(T, tb + split_rows);
  const int64_t brow0 = static_cast<int64_t>(b) * T;
  const int64_t ws_stride = kDwIn<C> + static_cast<int64_t>(C) * n_rs;
  WOperands o;
  float* out;
  int out_ld;
  if (tile < kDwInTiles<C>) {
    constexpr int kNt = 2 * C / kWTile, kCt = C / kWTile;
    const int mt = tile / kNt, nt = tile % kNt;
    const int tap = mt / kCt, ci0 = (mt % kCt) * kWTile;
    o = {x_bf + ci0, dgates + nt * kWTile, C, 2 * C, (tap - 1) * dilation};
    out = ws + split * ws_stride + (tap * C + ci0) * 2 * C + nt * kWTile;
    out_ld = 2 * C;
  } else {
    const int n_nt = n_rs / kWTile;
    const int mt = (tile - kDwInTiles<C>) / n_nt;
    const int nt = (tile - kDwInTiles<C>) % n_nt;
    o = {acts + mt * kWTile, drs + nt * kWTile, C, n_rs, 0};
    out = ws + split * ws_stride + kDwIn<C> + mt * kWTile * n_rs + nt * kWTile;
    out_ld = n_rs;
  }
  const int chunks = te > tb ? (te - tb + kK - 1) / kK : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q4 = lane % 4;
  const int m0 = (warp % 2) * 64;  // the warp's 64 output rows
  const int n0 = (warp / 2) * 32;  // and 32 output columns

  for (int c = 0; c < kRingAhead; ++c) {
    if (c < chunks) w_load(ring_s + c * kWStage, c, o, brow0, tb, te, T);
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
      w_load(ring_s + ((c + kRingAhead) % kRingStages) * kWStage,
             c + kRingAhead, o, brow0, tb, te, T);
    cp_async_commit();
    const uint32_t slot = ring_s + (c % kRingStages) * kWStage;
#pragma unroll
    for (int kk = 0; kk < kK; kk += 16) {
      // A = (the chunk's A rows)^T: output rows along the stored columns
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
          mma16816(acc[mi][2 * pb], a[mi], bq[0], bq[1]);
          mma16816(acc[mi][2 * pb + 1], a[mi], bq[2], bq[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(
            out + (m0 + mi * 16 + g + 8 * h) * out_ld + n0 + nj * 8 + 2 * q4) =
            make_float2(acc[mi][nj][2 * h], acc[mi][nj][2 * h + 1]);
}

// ---- kernel 4: fixed-order sums of the partials, then casts ----------------

// Blocks [0, (2C + n_rs) / 8): one warp per bias column (db_in then
// db_rs), its lanes summing every 32nd of the rows kernel's n_tiles tiles,
// then a butterfly. The blocks after them: one thread per element of dw_in
// then dw_rs, summing the n_splits partials of the weights kernel in order.
constexpr int kBiasColsPerBlock = kThreads / 32;

template <int kC>
__global__ void __launch_bounds__(kThreads)
wn_bwd_reduce_kernel(const float* __restrict__ ws, int n_splits,
                     const float* __restrict__ part_bias, int n_tiles, int n_rs,
                     bf16* __restrict__ dw_in, bf16* __restrict__ dw_rs,
                     float* __restrict__ db_in, float* __restrict__ db_rs) {
  const int nb = 2 * kC + n_rs;
  const int bias_blocks = nb / kBiasColsPerBlock;
  if (static_cast<int>(blockIdx.x) < bias_blocks) {
    const int col = blockIdx.x * kBiasColsPerBlock + threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    float s = 0.f;
    for (int i = lane; i < n_tiles; i += 32)
      s += part_bias[static_cast<int64_t>(i) * nb + col];
#pragma unroll
    for (int m = 16; m > 0; m /= 2) s += __shfl_xor_sync(0xffffffffu, s, m);
    if (lane == 0) {
      if (col < 2 * kC) db_in[col] = s;
      else db_rs[col - 2 * kC] = s;
    }
    return;
  }
  const int64_t ws_stride = kDwIn<kC> + static_cast<int64_t>(kC) * n_rs;
  const int64_t w =
      static_cast<int64_t>(blockIdx.x - bias_blocks) * kThreads + threadIdx.x;
  if (w >= ws_stride) return;
  float s = 0.f;
  for (int i = 0; i < n_splits; ++i) s += ws[i * ws_stride + w];
  const bf16 v = __float2bfloat16(s);
  if (w < kDwIn<kC>) dw_in[w] = v;
  else dw_rs[w - kDwIn<kC>] = v;
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

template <int kC, bool kLast>
cudaError_t launch_rows(const float* x, const bf16* cond, const bf16* w_in,
                        const float* b_in, const bf16* w_rs,
                        const float* dx_next, const float* dskip,
                        const int* valid_t, bf16* dcond, bf16* acts,
                        bf16* x_bf, bf16* drs, float* part_bias, int batch,
                        int T, int dilation, cudaStream_t stream) {
  static std::atomic<uint32_t> opted_in{0};
  auto kernel = wn_bwd_rows_kernel<kC, kLast>;
  constexpr int smem = RowsLayout<kC, kLast>::kSmem;
  cudaError_t err = opt_in_smem(kernel, smem, &opted_in);
  if (err != cudaSuccess) return err;
  constexpr int kTile = RowsLayout<kC, kLast>::kTileRows;
  dim3 grid((T + kTile - 1) / kTile, batch);
  kernel<<<grid, kThreads, smem, stream>>>(x, cond, w_in, b_in, w_rs, dx_next,
                                           dskip, valid_t, dcond, acts, x_bf,
                                           drs, part_bias, T, dilation);
  return cudaGetLastError();
}

// The kernel `which` (0 rows, 1 dx, 2 weights, 3 reduce; `last` picks the
// rows kernel's variant) at width kC as a function pointer, and its dynamic
// shared bytes.
template <int kC>
const void* bwd_kernel_for(int which, int last, int* smem_bytes) {
  switch (which) {
    case 0:
      *smem_bytes = last ? RowsLayout<kC, true>::kSmem
                         : RowsLayout<kC, false>::kSmem;
      return last ? reinterpret_cast<const void*>(wn_bwd_rows_kernel<kC, true>)
                  : reinterpret_cast<const void*>(wn_bwd_rows_kernel<kC, false>);
    case 1:
      *smem_bytes = kDxSmem;
      return reinterpret_cast<const void*>(wn_bwd_dx_kernel<kC>);
    case 2:
      *smem_bytes = kWSmem;
      return reinterpret_cast<const void*>(wn_bwd_weights_kernel<kC>);
    default:
      *smem_bytes = 0;
      return reinterpret_cast<const void*>(wn_bwd_reduce_kernel<kC>);
  }
}

template <int kC>
cudaError_t backward(const float* x, const bf16* cond, const bf16* w_in,
                     const float* b_in, const bf16* w_rs,
                     const float* dx_next, const float* dskip,
                     const int* valid_t, float* dx, bf16* dcond, bf16* dw_in,
                     float* db_in, bf16* dw_rs, float* db_rs, bf16* acts,
                     bf16* x_bf, bf16* drs, float* part_bias, float* ws,
                     int batch, int T, int dilation, int last, int n_splits_t,
                     int split_rows, cudaStream_t stream) {
  const int n_rs = last ? kC : 2 * kC;
  cudaError_t err =
      last ? launch_rows<kC, true>(x, cond, w_in, b_in, w_rs, dx_next, dskip,
                                   valid_t, dcond, acts, x_bf, drs, part_bias,
                                   batch, T, dilation, stream)
           : launch_rows<kC, false>(x, cond, w_in, b_in, w_rs, dx_next, dskip,
                                    valid_t, dcond, acts, x_bf, drs, part_bias,
                                    batch, T, dilation, stream);
  if (err != cudaSuccess) return err;

  static std::atomic<uint32_t> dx_opted{0}, w_opted{0};
  err = opt_in_smem(wn_bwd_dx_kernel<kC>, kDxSmem, &dx_opted);
  if (err != cudaSuccess) return err;
  constexpr int kTile = RowsLayout<kC, false>::kTileRows;
  const int tiles_t = (T + kTile - 1) / kTile;
  wn_bwd_dx_kernel<kC><<<dim3((T + kRT - 1) / kRT, kC / kRT, batch), kThreads,
                         kDxSmem, stream>>>(dcond, w_in, dx_next, valid_t, dx,
                                            T, dilation);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = opt_in_smem(wn_bwd_weights_kernel<kC>, kWSmem, &w_opted);
  if (err != cudaSuccess) return err;
  const int n_tiles_w = kDwInTiles<kC> + (kC / kWTile) * (n_rs / kWTile);
  wn_bwd_weights_kernel<kC><<<dim3(n_tiles_w, batch * n_splits_t), kThreads,
                              kWSmem, stream>>>(x_bf, dcond, acts, drs, ws, T,
                                                dilation, n_rs, n_splits_t,
                                                split_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int64_t n_w = kDwIn<kC> + static_cast<int64_t>(kC) * n_rs;
  const int blocks = (2 * kC + n_rs) / kBiasColsPerBlock +
                     static_cast<int>((n_w + kThreads - 1) / kThreads);
  wn_bwd_reduce_kernel<kC><<<blocks, kThreads, 0, stream>>>(
      ws, batch * n_splits_t, part_bias, batch * tiles_t, n_rs, dw_in, dw_rs,
      db_in, db_rs);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The bf16 backward of one layer, four launches on `stream`, no
// synchronisation; returns the first launch error.
// Inputs (C = 128, 256 or 512): x [batch, T, C] f32; cond [batch, T, 2C], w_in [3C, 2C], w_rs
// [C, n_rs] bf16 (n_rs = C when last, else 2C); b_in [2C] f32; dx_next,
// dskip [batch, T, C] f32 or null (zero); valid_t [batch] int32 or null.
// Outputs: dx f32 like x, dcond bf16 like cond, dw_in / dw_rs bf16 like
// the weights, db_in / db_rs f32. Scratch, from the caller: acts, x_bf
// [batch*T, C] bf16; drs [batch*T, n_rs] bf16; part_bias [batch *
// ceil(T/tile), 2C + n_rs] f32 (tile: wn_layer_bwd_tile_rows(C)); ws
// [batch * n_splits_t, 3C*2C + C*n_rs] f32. The weights kernel splits each
// batch row's T into n_splits_t ranges of split_rows rows. Pointers
// 16-byte aligned, contiguous.
cudaError_t wn_layer_backward_bf16(
    const float* x, const void* cond, const void* w_in, const float* b_in,
    const void* w_rs, const float* dx_next, const float* dskip,
    const int* valid_t, float* dx, void* dcond, void* dw_in, float* db_in,
    void* dw_rs, float* db_rs, void* acts, void* x_bf, void* drs,
    float* part_bias, float* ws, int batch, int T, int C, int dilation,
    int last, int n_splits_t, int split_rows, cudaStream_t stream) {
  if (T <= 0 || batch <= 0 || batch > 65535 || n_splits_t <= 0 ||
      split_rows <= 0 || static_cast<int64_t>(batch) * n_splits_t > 65535 ||
      static_cast<int64_t>(n_splits_t) * split_rows < T)
    return cudaErrorInvalidValue;
#define WN_BWD(WIDTH)                                                        \
  return backward<WIDTH>(                                                    \
      x, static_cast<const bf16*>(cond), static_cast<const bf16*>(w_in),     \
      b_in, static_cast<const bf16*>(w_rs), dx_next, dskip, valid_t, dx,     \
      static_cast<bf16*>(dcond), static_cast<bf16*>(dw_in), db_in,           \
      static_cast<bf16*>(dw_rs), db_rs, static_cast<bf16*>(acts),            \
      static_cast<bf16*>(x_bf), static_cast<bf16*>(drs), part_bias, ws,      \
      batch, T, dilation, last, n_splits_t, split_rows, stream)
  switch (C) {
    case 128: WN_BWD(128);
    case 256: WN_BWD(256);
    case 512: WN_BWD(512);
    default: return cudaErrorInvalidValue;
  }
#undef WN_BWD
}

// Time rows of the rows kernel's tile at width C (its part_bias rows a
// batch row are ceil(T / this)), or -1 for a width it is not built for.
int wn_layer_bwd_tile_rows(int C) {
  switch (C) {
    case 128: return RowsLayout<128, false>::kTileRows;
    case 256: return RowsLayout<256, false>::kTileRows;
    case 512: return RowsLayout<512, false>::kTileRows;
    default: return -1;
  }
}

// What the loaded build of backward kernel `which` (0 rows, 1 dx, 2
// weights, 3 reduce; `last` picks the rows variant) at width C uses, from
// the CUDA runtime: registers and local (spill) bytes per thread, static
// shared bytes, and the dynamic shared bytes its launcher passes.
cudaError_t wn_layer_bwd_kernel_info(int C, int which, int last,
                                     int* registers, int* local_bytes,
                                     int* static_smem_bytes,
                                     int* dynamic_smem_bytes) {
  const void* kernel;
  switch (C) {
    case 128: kernel = bwd_kernel_for<128>(which, last, dynamic_smem_bytes); break;
    case 256: kernel = bwd_kernel_for<256>(which, last, dynamic_smem_bytes); break;
    case 512: kernel = bwd_kernel_for<512>(which, last, dynamic_smem_bytes); break;
    default: return cudaErrorInvalidValue;
  }
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  *registers = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *static_smem_bytes = static_cast<int>(attr.sharedSizeBytes);
  return cudaSuccess;
}

}  // extern "C"
