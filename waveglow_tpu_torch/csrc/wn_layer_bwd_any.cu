// The bf16 backward of a whole WN layer at any even width C and any odd
// kernel size K, for Hopper (sm_90a), CUDA C++ with a plain C interface
// (bound from Python with ctypes, see
// kernels/wn_layer.py::wn_layer_backward_any).
//
// Replaces, at the shapes wn_layer_bwd.cu's kernels are not built for (C
// outside {128, 256, 512}, or K != 3):
//   * waveglow_tpu/kernels/wn_layer.py::_wn_layer_trainable_bwd (the
//     backward of the custom VJP wn_layer_trainable, XLA on the TPU), which
//     the JAX package runs at K = 3 and any C, and
//   * the autodiff of the XLA layer body of waveglow_tpu/models/wn.py::
//     wn_forward, through which the JAX package trains at kernel_size != 3.
// It computes what wn_layer_bwd.cu's whole-layer backward computes, at the
// same rounding points, over K taps (K/2 = K // 2):
//
//   taps    = bf16(x) shifted by (k - K/2)*d, zero outside [0, T)
//   gates   = taps @ w_in + b_in + cond          (f32 accumulation and adds)
//   t = tanh(gates[:C]), s = sigmoid(gates[C:]), acts = t * s     (f32)
//   drs     = [dx_next masked at rows >= valid_t | dskip]  (last: dskip)
//   dacts   = bf16(drs) @ w_rs^T                 (f32 accumulation)
//   dgates  = [dacts*s*(1-t^2) | dacts*t*s*(1-s)]                  (f32)
//   dcond   = bf16(dgates)
//   db_in   = sum_rows dgates, db_rs = sum_rows drs   (f32, not roundings)
//   dw_in   = bf16(taps^T @ bf16(dgates))        (f32 sums, then bf16)
//   dw_rs   = bf16(bf16(acts)^T @ bf16(drs))
//   dx      = dx_next masked + sum_k shift(bf16(dgates) @ w_in[k]^T,
//                                          -(k - K/2)*d)          (f32)
//
// and a model rank's share of it (kernels/wn_layer.py::
// wn_layer_shard_backward_any), the adjoint of wn_layer_any.cu's partial
// mode, which replaces the per-rank cut of the same backward that GSPMD
// makes under a `model` mesh axis (waveglow_tpu/parallel/sharding.py): the
// same sums over the rank's G = C' gate channels, with the cotangent g of
// its partial [B, T, n_rs] in the place of drs (no mask), no dx_next added
// to its partial dx (the residual's cotangent is outside) and no db_rs:
//
//   dx_s    = sum_k shift(bf16(dgates) @ w_in_s[k]^T, ...)   [B, T, C]
//   dcond_s, db_in_s [2G], dw_in_s [K*C, 2G], dw_rs_s [G, n_rs]
//
// The ranks' dx_s summed, plus the residual's cotangent, is the whole
// layer's dx; their other gradients are its columns (rows of dw_rs).
//
// C, G (= C but for a rank), K, the dilation d, B and T are runtime
// arguments. Layouts, row-major (a rank's with G for the gate's C):
// x, dx_next, dskip, dx [B, T, C] f32; cond, dcond [B, T, 2C] bf16; w_in,
// dw_in [K*C, 2C] bf16 (tanh columns, then sigmoid columns); w_rs, dw_rs
// [C, n_rs] bf16 (n_rs = 2C: residual columns, then skip columns; the last
// layer's n_rs = C); b_in, db_in [2C], db_rs [n_rs] f32; valid_t [B] int32
// or null; a null cotangent is zero and is never read.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 on the tensor cores,
// 3.35 TB/s HBM): the gradients' products take 2*R*(2*C*n_rs (dacts, dw_rs)
// + 2*K*C*2C (dw_in, the taps' adjoint)) operations, R = B*T, and the gate's
// recompute 2*R*K*C*2C more. At B=12, T=2,000 the gradients' products are
// 50.3 GFLOP at (C, K) = (256, 3), 0.051 ms; 75.5 at (256, 5), 0.076 ms;
// 113.2 at (384, 3), 0.114 ms. The bytes, about 24*C a row, take less:
// every shape is operation-bound.
//
// Design: wn_layer_bwd.cu's whole-layer design at run-time C and K. Every
// product is a wgmma (bf16 operands from 128-byte-swizzled shared memory,
// f32 accumulators; sm90_wgmma.cuh) of two warpgroups, 64 rows each, fed
// by 64-deep K chunks through a cp.async ring of as many stages as shared
// memory holds, up to six (rows six; dx and weights six at N = 128, five
// at 192, four at 256), all but two of them chunks in flight, one chunk's
// wgmmas left running under the next chunk's loads.
// The operands are read in layouts padded to Cp = C rounded up to 64
// channels and Gp = G rounded up to 64 gate channels, zero past C and G,
// so every copy is a 16-byte piece of a swizzle row
// and every channel tail is zero: C = 48 and C = 50, or a rank's G = 25,
// are exact. Where C = Cp and G = Gp the weights and dcond are those
// layouts already and are read as they are; elsewhere the pad kernel
// copies the weights and, where G != Gp, the rows kernel writes the padded
// dgates beside dcond. (Below, 2Cp deep gate columns and Cp of acts read
// 2Gp and Gp for a rank.) A rank with an odd G reads and writes the
// sigmoid halves of cond, b_in and dcond one value at a time. Each tap's
// rows are loaded on their own: taps reach +-(K/2)*d rows (+-384 at K = 7
// and d = 128), further than T at T = 17; rows outside [0, T) are
// zero-filled, and the adjoint's shifts run the other way. The kernels,
// in order on one stream:
//   pad     - (C != Cp only) w_in into w_in_p [K*Cp, 2Cp] and w_rs into
//             w_rs_p [Cp, n_rsp] (n_rsp = 2Cp, the last layer's Cp), each
//             half of the columns from column 0 and from column Cp.
//   prep    - per (batch row, tile of 128 time rows): x_p = bf16(x) [R, Cp]
//             and g_p = bf16(drs) [R, n_rsp], each rounded once, with
//             16-byte loads where C % 4 == 0 (else 8-byte ones, C = 50);
//             the tile's f32 column sums of drs (db_rs) into its part_bias
//             row. Memory-bound: eight loads in flight a thread.
//   rows    - per (batch row, tile of 128 time rows, pass of 64 channels):
//             the gate recompute (K*Cp deep in (channel block, tap) chunks;
//             N = the pass's 64 tanh and 64 sigmoid columns, m64n128k16)
//             then dacts (n_rsp deep, w_rs read K-major as it lies,
//             m64n64k16) into accumulators that sit in the same thread for
//             the same (row, channel), so the gate and its adjoint run on
//             them in f32: dcond, acts_p = bf16(acts) [R, Cp], the padded
//             dgates dg_p [R, 2Cp] (C != Cp) and the tile's f32 column sums
//             of dgates (db_in) into its part_bias row.
//   dx      - per 128 flat rows x N output channels (the widest of 192,
//             128, 64 dividing Cp): one product K*2Cp deep, tap k's chunks the
//             dgates rows at t - (k - K/2)*d against w_in's tap-k rows read
//             K-major; adds dx_next at rows t < valid_t, its loads issued
//             before any store.
//   weights - per (output tile, range of rows): dw_in's tiles of 128 of its
//             K*Cp rows x N of its 2Cp columns (N the widest of 256, 192,
//             128, 64 dividing Cp; a tile's two 64-row halves may take two
//             taps) and dw_rs^T's of 128 of its n_rsp rows x N of its Cp
//             columns, both operands MN-major as they lie; the f32
//             partials to a workspace, a slot a range. A range is a part of
//             one batch row or a run of whole batch rows, whichever the cut
//             needs to fill the card's waves (kernels/wn_layer.py's
//             any_bwd_splits), so the workspace holds as many slots as that
//             cut has ranges, not one a batch row at least.
//   reduce  - sums the partials over the ranges and the column sums over
//             the tiles in a fixed order (a warp a bias column: lanes over
//             every 32nd tile, then a butterfly), drops the padding, casts
//             dw_in and dw_rs to bf16.
// At C = Cp every output's sums run in the order of wn_layer_bwd.cu's (the
// same tiles, chunks, cut and reduce), so at K = 3 and a built width the
// two give the same bits. No atomics anywhere: two launches give the same
// bits. PERF.md keeps the times (chip_smoke.py phase 17, fwd_compare.py
// --any-bwd, any_bwd_ablation.py); wn_layer_bwd_any_kernel_info reports
// each kernel's registers, spills and shared memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

#include "f32_ring.cuh"  // cp.async, opt_in_smem
#include "sm90_wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxC = 1280;               // the wrapper's cap (ANY_MAX_C)
constexpr int kThreads = 256;             // two warpgroups; every kernel
constexpr int kTile = 128;                // rows of a prep, rows or dx tile
constexpr int kKC = 64;                   // K of a chunk: one swizzle row
constexpr int kBlock = 64 * 128;          // [64 rows][64 bf16], swizzled
constexpr int kABytes = 2 * kBlock;       // an A chunk of two warpgroups
constexpr int kSmemMax = 232448;          // the 227 KB a block may use
constexpr int kPass = 64;                 // channels of a rows pass

// Stages of a product's ring of `stage`-byte stages beside `extra` bytes:
// as many as a block's shared memory holds, at most 6; and the chunks in
// flight under the wgmmas of a ring of `stages` (ring_step).
__host__ __device__ constexpr int ring_stages(int stage, int extra) {
  return (kSmemMax - extra) / stage < 6 ? (kSmemMax - extra) / stage : 6;
}
__host__ __device__ constexpr int ring_ahead(int stages) { return stages - 2; }

// The rows kernel's stage: an A chunk, then the gate's B [64 K][2 x 64 N]
// MN-major (dacts' [64 N][64 K] K-major takes half of it); after the ring,
// the column sums [8 warps][2 x 64]. Six stages, four chunks in flight.
constexpr int kRowsStage = kABytes + 2 * kBlock;
constexpr int kRowsRedBytes = 8 * 2 * kPass * 4;
constexpr int kRowsStages = ring_stages(kRowsStage, kRowsRedBytes);
constexpr int kRowsRed = kRowsStages * kRowsStage;
constexpr int kRowsSmem = kRowsRed + kRowsRedBytes;
static_assert(kRowsSmem <= kSmemMax, "over 227 KB");

// The dx and weights kernels' stage at N = n: an A chunk, then B ([n][64
// K] K-major, or [64 K][n] MN-major in 64-column blocks); their ring: 4
// stages at N = 256, 5 at 192, 6 at 128 and 64.
__host__ __device__ constexpr int nt_stage(int n) { return kABytes + n * 128; }
__host__ __device__ constexpr int nt_stages(int n) {
  return ring_stages(nt_stage(n), 0);
}
__host__ __device__ constexpr int nt_smem(int n) {
  return nt_stages(n) * nt_stage(n);
}
static_assert(nt_smem(256) <= kSmemMax && nt_smem(192) <= kSmemMax &&
                  nt_smem(128) <= kSmemMax && nt_smem(64) <= kSmemMax,
              "over 227 KB");

__host__ __device__ __forceinline__ int pad64(int c) {
  return (c + 63) / 64 * 64;
}

// N of the weights kernel's tiles at padded width Cp: the widest of 256,
// 192, 128 and 64 that divides Cp (and so 2Cp). The dx kernel's: the
// widest of 192, 128 and 64; at N = 256 its blocks fill the card's waves
// worse (at B=12, T=2,000 and C = 256, 188 blocks, the second wave 42%
// full, against 376 in three waves 95% full at N = 128) in a shallower
// ring (four stages, not six).
__host__ __device__ __forceinline__ int n_tile(int cp) {
  return cp % 256 == 0 ? 256 : cp % 192 == 0 ? 192 : cp % 128 == 0 ? 128 : 64;
}
__host__ __device__ __forceinline__ int dx_tile(int cp) {
  return cp % 192 == 0 ? 192 : cp % 128 == 0 ? 128 : 64;
}

// n / d for 0 <= n < 2^31 by a multiply and a shift (the round-up method
// of Granlund and Montgomery, as in wn_layer_any.cu), made on the host: the
// rows and dx kernels divide a block or row index by a run-time size (the
// passes, T).
struct FastDiv {
  uint64_t m;
  int shift, d;
};

FastDiv fast_div(int d) {
  int l = 0;
  while ((int64_t{1} << l) < d) ++l;
  return {(uint64_t{1} << (31 + l)) / static_cast<uint64_t>(d) + 1, 31 + l,
          d};
}

__device__ __forceinline__ int div_by(int n, const FastDiv& f) {
  return static_cast<int>((static_cast<uint64_t>(n) * f.m) >> f.shift);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo at the lower address
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return make_float2(__uint_as_float(v << 16),
                     __uint_as_float(v & 0xffff0000u));
}

// What every kernel of a call reads, as one parameter in the constant bank
// (the derived sizes too, so a kernel spends no register on them).
struct BwdArgs {
  const float* x;          // [R, C]
  const bf16* cond;        // [R, 2G]
  const bf16* w_in;        // [K*C, 2G]
  const float* b_in;       // [2G]
  const bf16* w_rs;        // [G, n_rs]
  const float* dx_next;    // [R, C] or null: added to dx
  const float* drs_a;      // drs's residual half: dx_next, or a rank's g
  const float* drs_b;      // its skip half (the last layer's drs): dskip,
                           // or g (+ C); either null for zero
  int drs_ld;              // their rows' stride: C, or a rank's n_rs
  const int* valid_t;      // [B] or null
  float* dx;               // [R, C]
  bf16* dcond;             // [R, 2G]
  bf16* dw_in;             // [K*C, 2G]
  float* db_in;            // [2G]
  bf16* dw_rs;             // [G, n_rs]
  float* db_rs;            // [n_rs], or null (a rank)
  bf16* x_p;               // [R, Cp]: bf16(x), zero past C
  bf16* g_p;               // [R, n_rsp]: bf16(drs), zero past C
  bf16* acts_p;            // [R, Gp]: bf16(acts)
  bf16* dg_p;              // [R, 2Gp]: bf16(dgates); dcond where G = Gp
  bf16* w_in_p;            // [K*Cp, 2Gp], the pad kernel's
  bf16* w_rs_p;            // [Gp, n_rsp], likewise
  const bf16* w_in_k;      // what the products read: w_in_p, or w_in
  const bf16* w_rs_k;      // w_rs_p, or w_rs
  float* part_bias;        // [B * tiles_t, 2Gp + n_rsp]: dgates', drs' sums
  float* ws;               // [n_splits, K*Cp*2Gp + Gp*n_rsp]: the partials
  int batch, T, C, G, K, dilation, last;
  int rows;                // R = B*T
  int cp, gp, n_rs, n_rsp;
  int pad, pad_g;          // weights padded (C != Cp or G != Gp); G != Gp
  int in_blocks;           // Cp / kKC: a tap's chunks of the gate product
  int tiles_t, passes;     // ceil(T / kTile); Gp / kPass
  int dx_n, w_n;           // N of the dx and weights tiles
  int in_mt, in_nt;        // the weights kernel's dw_in_p tiles: M x N
  int rs_mt, rs_nt;        // and its dw_rs_p^T tiles
  int n_splits_t, split_rows, split_batches;  // its ranges (see the kernel)
  FastDiv div_passes, div_t;  // passes, T
};

// One step at chunk j of a product's ring of kStages stages, `stage` bytes
// apart from `ring`, kAhead chunks in flight: wait for this thread's
// copies of chunk j and hand the block's to the async proxy; past the
// barrier every warpgroup has waited for its wgmmas of chunk j - 2, so
// `load(j + kAhead)` may fill the stage of chunk j + kAhead - kStages (one
// commit group, empty past the last chunk); then start chunk j's wgmmas
// on this warpgroup's 64 rows (acc += A @ B; kTransA / kTransB 1 for an
// MN-major operand, whose 64-value blocks lie kBlock apart) and wait until
// only they are in flight.
template <int kN, int kTransA, int kTransB, int kStages, typename Load>
__device__ __forceinline__ void ring_step(uint32_t ring, int stage, int j,
                                          float (&acc)[kN / 2],
                                          const Load& load) {
  constexpr int kAhead = ring_ahead(kStages);
  cp_async_wait<kAhead - 1>();
  fence_proxy_async();
  __syncthreads();
  load(j + kAhead);
  const uint32_t st = ring + (j % kStages) * stage;
  const uint32_t a = st + (threadIdx.x / 128) * kBlock;
  fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < kKC / 16; ++k)
    wgmma_m64<kN, kTransA, kTransB>(
        acc,
        kTransA ? mnmajor_desc(a + k * 2048, kBlock) : kmajor_desc(a + k * 32),
        kTransB ? mnmajor_desc(st + kABytes + k * 2048, kBlock)
                : kmajor_desc(st + kABytes + k * 32));
  wgmma_commit();
  wgmma_wait<1>();
  fence_acc(acc);
}

// ---- pad: the weights into padded layouts (C != Cp) ------------------------

// One block a padded row: rows [0, K*Cp) of w_in_p, then rows [0, Gp) of
// w_rs_p.
__global__ void __launch_bounds__(kThreads)
wn_bwd_any_pad_kernel(const __grid_constant__ BwdArgs a) {
  const int C = a.C, G = a.G, cp = a.cp, gp = a.gp;
  const bf16 zero = __float2bfloat16(0.f);
  const int row = blockIdx.x;
  if (row < a.K * cp) {
    const int tap = row / cp, ci = row % cp;
    const bf16* src = a.w_in + static_cast<int64_t>(tap * C + ci) * 2 * G;
    bf16* dst = a.w_in_p + static_cast<int64_t>(row) * 2 * gp;
    for (int col = threadIdx.x; col < 2 * gp; col += kThreads) {
      const int h = col / gp, co = col % gp;
      dst[col] = ci < C && co < G ? src[h * G + co] : zero;
    }
  } else {
    const int c = row - a.K * cp;
    const bf16* src = a.w_rs + static_cast<int64_t>(c) * a.n_rs;
    bf16* dst = a.w_rs_p + static_cast<int64_t>(c) * a.n_rsp;
    for (int col = threadIdx.x; col < a.n_rsp; col += kThreads) {
      const int h = col / cp, co = col % cp;
      dst[col] = c < G && co < C ? src[h * C + co] : zero;
    }
  }
}

// ---- prep: x and drs rounded once, drs's column sums ------------------------

// kV consecutive f32 values (16- or 8-byte aligned).
template <int kV>
struct Piece {
  float v[kV];
};

template <int kV>
__device__ __forceinline__ Piece<kV> load_piece(const float* src) {
  Piece<kV> p;
  if constexpr (kV == 4) {
    const float4 f = *reinterpret_cast<const float4*>(src);
    p.v[0] = f.x;
    p.v[1] = f.y;
    p.v[2] = f.z;
    p.v[3] = f.w;
  } else {
    const float2 f = *reinterpret_cast<const float2*>(src);
    p.v[0] = f.x;
    p.v[1] = f.y;
  }
  return p;
}

template <int kV>
__device__ __forceinline__ void store_piece(bf16* dst, const Piece<kV>& p) {
  if constexpr (kV == 4)
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(pack_bf16(p.v[0], p.v[1]), pack_bf16(p.v[2], p.v[3]));
  else
    *reinterpret_cast<uint32_t*>(dst) = pack_bf16(p.v[0], p.v[1]);
}

// One (tile of kTile time rows, batch row), the rows kernel's tiles, in
// pieces of kV channels: x_p = bf16(x), zero past C; drs = [dx_next masked
// at t >= valid_t | dskip] (last: dskip) as bf16 g_p; and drs's f32 column
// sums into columns [2Gp, 2Gp + n_rsp) of the tile's part_bias row. A drs
// column piece is summed down the tile's rows by `phases` threads (rows ph
// + phases*k, in order), whose sums add in phase order: at C = Cp the
// whole-layer prep kernel's order.
template <int kV>
__device__ __forceinline__ void prep_body(const BwdArgs& a, float* red) {
  constexpr int kBatch = 8;  // loads in flight a thread
  const int C = a.C, cp = a.cp, gp = a.gp, n_rsp = a.n_rsp, T = a.T;
  const int tile = blockIdx.x, b = blockIdx.y;
  const int t0 = tile * kTile;
  const int rows = min(kTile, T - t0);
  const int64_t row0 = static_cast<int64_t>(b) * T + t0;
  const int valid = a.valid_t != nullptr ? a.valid_t[b] : T;

  const int xq = cp / kV;  // pieces of an x_p row
  const int n = rows * xq;
  for (int i0 = threadIdx.x; i0 < n; i0 += kThreads * kBatch) {
    Piece<kV> v[kBatch];
    int r[kBatch], c[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int p = i0 + u * kThreads;
      r[u] = p / xq;
      c[u] = (p - r[u] * xq) * kV;
#pragma unroll
      for (int e = 0; e < kV; ++e) v[u].v[e] = 0.f;
      if (p < n && c[u] < C)
        v[u] = load_piece<kV>(a.x + (row0 + r[u]) * C + c[u]);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (i0 + u * kThreads < n)
        store_piece<kV>(a.x_p + (row0 + r[u]) * cp + c[u], v[u]);
  }

  const int kq = n_rsp / kV;  // pieces of a g_p row
  const int phases = kq < kThreads ? kThreads / kq : 1;
  const int per = (kTile + phases - 1) / phases;  // rows of a phase
  const int rounds = (kq + kThreads - 1) / kThreads;  // 1 where phases > 1
  float* out = a.part_bias +
               (static_cast<int64_t>(b) * a.tiles_t + tile) *
                   (2 * gp + n_rsp) +
               2 * gp;
  for (int round = 0; round < rounds; ++round) {
    const int ph = phases > 1 ? threadIdx.x / kq : 0;
    const int q = phases > 1 ? threadIdx.x - ph * kq
                             : threadIdx.x + round * kThreads;
    if (ph >= phases || q >= kq) continue;
    const int col = kV * q;
    const int h = col >= cp, co = col - h * cp;
    const bool from_next = !a.last && h == 0;
    const float* src = from_next ? a.drs_a : a.drs_b;
    const bool live = src != nullptr && co < C;
    float s[kV];
#pragma unroll
    for (int e = 0; e < kV; ++e) s[e] = 0.f;
    for (int k0 = 0; k0 < per; k0 += kBatch) {
      Piece<kV> v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int r = ph + (k0 + u) * phases;
#pragma unroll
        for (int e = 0; e < kV; ++e) v[u].v[e] = 0.f;
        if (live && k0 + u < per && r < rows &&
            !(from_next && t0 + r >= valid))
          v[u] = load_piece<kV>(src + (row0 + r) * a.drs_ld + co);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int r = ph + (k0 + u) * phases;
        if (k0 + u >= per) continue;
#pragma unroll
        for (int e = 0; e < kV; ++e) s[e] += v[u].v[e];
        if (r < rows) store_piece<kV>(a.g_p + (row0 + r) * n_rsp + col, v[u]);
      }
    }
#pragma unroll
    for (int e = 0; e < kV; ++e) {
      if (phases > 1) red[threadIdx.x * kV + e] = s[e];
      else out[col + e] = s[e];
    }
  }
  if (phases > 1) {
    // the phases' sums, in order
    __syncthreads();
    for (int c = threadIdx.x; c < n_rsp; c += kThreads) {
      float sum = red[c];
      for (int p = 1; p < phases; ++p) sum += red[p * n_rsp + c];
      out[c] = sum;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
wn_bwd_any_prep_kernel(const __grid_constant__ BwdArgs a) {
  __shared__ float red[kThreads * 4];
  if (a.C % 4 == 0) prep_body<4>(a, red);
  else prep_body<2>(a, red);
}

// ---- rows: the gate recompute, dacts, the gate's adjoint --------------------

// A pair of bf16 values at `p` as one word: one 4-byte load where
// `aligned`, else two loads (a rank's odd G), the second zero unless
// `second`.
__device__ __forceinline__ uint32_t load_pair(const bf16* p, bool aligned,
                                              bool second) {
  if (aligned) return *reinterpret_cast<const uint32_t*>(p);
  const uint32_t lo = *reinterpret_cast<const uint16_t*>(p);
  const uint32_t hi = second ? *reinterpret_cast<const uint16_t*>(p + 1) : 0u;
  return lo | hi << 16;
}

// Stores a pair of bf16 values (`v` as pack_bf16 made it) at `p`: one
// 4-byte store where `aligned`, else the first alone and, where `second`,
// the second.
__device__ __forceinline__ void store_pair(bf16* p, uint32_t v, bool aligned,
                                           bool second) {
  if (aligned) {
    *reinterpret_cast<uint32_t*>(p) = v;
    return;
  }
  *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(v & 0xffffu);
  if (second)
    *reinterpret_cast<uint16_t*>(p + 1) = static_cast<uint16_t>(v >> 16);
}

// One block per (tile of 128 time rows x pass of 64 gate channels, batch
// row): blockIdx.x = tile * passes + pass. Chunk j < K * Cp / 64 of the
// gate is tap j % K, input channels 64 (j / K) + [0, 64) (wn_layer_bwd.cu's
// order at K = 3); then dacts' chunks, 64 drs columns each. What the
// loops read is held in registers (a field of the parameter would be read
// again past every accumulator fence), the chunk's tap and channel block
// are counters. kRank: a rank's instance (G != C); the whole layer's holds
// one width and its pairs aligned.
template <bool kRank>
__global__ void __launch_bounds__(kThreads, 1)
wn_bwd_any_rows_kernel(const __grid_constant__ BwdArgs a) {
  extern __shared__ __align__(1024) uint4 smem_rows[];
  const uint32_t ring = smem_u32(smem_rows);
  float* red = reinterpret_cast<float*>(reinterpret_cast<char*>(smem_rows) +
                                        kRowsRed);
  const int cp = a.cp, n_rsp = a.n_rsp, K = a.K;
  const int G = kRank ? a.G : a.C, gp = kRank ? a.gp : cp;
  const int T = a.T, dilation = a.dilation;
  const int tile = div_by(blockIdx.x, a.div_passes);
  const int cb = (blockIdx.x - tile * a.passes) * kPass;  // the pass's
  const int b = blockIdx.y;
  const int t0 = tile * kTile;
  const int rows = min(kTile, T - t0);
  const int64_t row0 = static_cast<int64_t>(b) * T + t0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r16 = warp * 16;  // the warp's rows of the tile (both groups)
  const int g = lane / 4, tig = lane % 4;
  const int gate_chunks = K * (kRank ? a.in_blocks : a.passes);
  const int chunks = gate_chunks + n_rsp / kKC;

  // This thread's copies of a chunk. A: rows ra + 32i, piece q (K-major).
  // The gate's B: K rows kb + 16i of w_in at column nb of the pass's 64
  // tanh (nb < 64) or sigmoid columns, MN-major. dacts' B: w_rs rows cb +
  // ra + 32i, piece q, K-major.
  const int q = threadIdx.x % 8, ra = threadIdx.x / 8;
  const int kb = threadIdx.x / 16, nb = (threadIdx.x % 16) * 8;
  const uint32_t a_dst = sw128_piece(ra, q);
  const uint32_t wg_dst =
      kABytes + nb / 64 * kBlock + sw128_piece(kb, nb % 64 / 8);
  const bf16* __restrict__ xa = a.x_p + (row0 + ra) * cp + q * 8;
  const bf16* __restrict__ ga = a.g_p + (row0 + ra) * n_rsp + q * 8;
  const bf16* __restrict__ wga = a.w_in_k + static_cast<int64_t>(kb) * 2 * gp +
                                 nb / 64 * gp + cb + nb % 64;
  const bf16* __restrict__ wra =
      a.w_rs_k + static_cast<int64_t>(cb + ra) * n_rsp + q * 8;
  const int64_t x_step = static_cast<int64_t>(32) * cp;    // 32 x_p rows
  const int64_t g_step = static_cast<int64_t>(32) * n_rsp;  // 32 g_p rows
  const int64_t wg_step = static_cast<int64_t>(16) * 2 * gp;
  const bf16* __restrict__ cond = a.cond;
  int ld_tap = 0, ld_c0 = 0;  // the next gate chunk's tap and channels

  // chunk j into its stage (called for j = 0, 1, 2, ... in turn)
  const auto load = [&](int j) {
    if (j < chunks) {
      const uint32_t st = ring + (j % kRowsStages) * kRowsStage;
      if (j < gate_chunks) {
        const int shift = (ld_tap - K / 2) * dilation;
        const bf16* x0 = xa + static_cast<int64_t>(shift) * cp + ld_c0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + ra + 32 * i + shift;
          const bool ok = t >= 0 && t < T;
          cp_async16_zfill(st + a_dst + i * 4096, ok ? x0 + i * x_step : xa,
                           ok);
        }
        const bf16* w0 =
            wga + static_cast<int64_t>(ld_tap * cp + ld_c0) * 2 * gp;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          cp_async16(st + wg_dst + i * 2048, w0 + i * wg_step);
        if (++ld_tap == K) {
          ld_tap = 0;
          ld_c0 += kKC;
        }
      } else {
        const int c0 = (j - gate_chunks) * kKC;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool ok = ra + 32 * i < rows;
          cp_async16_zfill(st + a_dst + i * 4096,
                           ok ? ga + c0 + i * g_step : ga, ok);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
          cp_async16(st + kABytes + a_dst + i * 4096,
                     wra + c0 + i * g_step);
      }
    }
    cp_async_commit();
  };

  for (int c = 0; c < ring_ahead(kRowsStages); ++c) load(c);

  // acc_g: element 4j + 2h + e is row r16 + g + 8h, gate column 8j + 2 tig
  // + e: the tanh pre-activation of channel cb + 8j + 2 tig + e for j < 8,
  // the sigmoid one of channel cb + 8(j - 8) + 2 tig + e for j < 16; acc_d:
  // element 4j + 2h + e is dacts of the same row and that channel
  float acc_g[kPass], acc_d[kPass / 2];
#pragma unroll
  for (int i = 0; i < kPass; ++i) acc_g[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kPass / 2; ++i) acc_d[i] = 0.f;

  // ---- gates = taps @ w_in[:, the pass's columns]
#pragma unroll 1
  for (int j = 0; j < gate_chunks; ++j)
    ring_step<2 * kPass, 0, 1, kRowsStages>(ring, kRowsStage, j, acc_g,
                                            load);
  wgmma_wait<0>();
  fence_acc(acc_g);

  // cond of the pass's channels (zero past G and past the tile's rows),
  // read under the dacts product
  // cond's, b_in's and dcond's pairs aligned
  const bool pairs = !kRank || G % 2 == 0;
  uint32_t cond_t[kPass / 8][2], cond_s[kPass / 8][2];
#pragma unroll
  for (int j = 0; j < kPass / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r16 + g + 8 * h;
      const int ch = cb + 8 * j + 2 * tig;
      cond_t[j][h] = cond_s[j][h] = 0u;  // bf16 zeros
      if (row < rows && ch < G) {  // G even: ch + 1 < G too
        const bf16* cr = cond + (row0 + row) * 2 * G + ch;
        cond_t[j][h] = load_pair(cr, pairs, ch + 1 < G);
        cond_s[j][h] = load_pair(cr + G, pairs, ch + 1 < G);
      }
    }

  // ---- dacts = bf16(drs) @ w_rs[the pass's rows]^T
#pragma unroll 1
  for (int j = gate_chunks; j < chunks; ++j)
    ring_step<kPass, 0, 0, kRowsStages>(ring, kRowsStage, j, acc_d, load);
  wgmma_wait<0>();
  fence_acc(acc_d);
  cp_async_wait<0>();

  // ---- the gate and its adjoint on the accumulators (f32). Rows past the
  // tile's have zero drs: finite gates, zero dgates. Channels past G have
  // zero weights, bias and cond: zero acts and dgates. The bias is loaded
  // before any store (the outputs are fields the compiler cannot tell
  // apart from it).
  float2 b_t[kPass / 8], b_s[kPass / 8];
#pragma unroll
  for (int j = 0; j < kPass / 8; ++j) {
    const int ch = cb + 8 * j + 2 * tig;
    b_t[j] = b_s[j] = make_float2(0.f, 0.f);
    if (ch < G) {
      if (pairs) {
        b_t[j] = *reinterpret_cast<const float2*>(a.b_in + ch);
        b_s[j] = *reinterpret_cast<const float2*>(a.b_in + G + ch);
      } else {
        const bool second = ch + 1 < G;
        b_t[j] = make_float2(a.b_in[ch], second ? a.b_in[ch + 1] : 0.f);
        b_s[j] = make_float2(a.b_in[G + ch],
                             second ? a.b_in[G + ch + 1] : 0.f);
      }
    }
  }
  bf16* __restrict__ acts_p = a.acts_p;
  bf16* __restrict__ dcond = a.dcond;
  bf16* __restrict__ dg_p = a.dg_p;
  const bool pad_g = kRank ? a.pad_g : a.pad;
#pragma unroll
  for (int j = 0; j < kPass / 8; ++j) {
    const int ch = cb + 8 * j + 2 * tig;
    const bool ch_ok = ch < G, second = ch + 1 < G;
    const float2 bt = b_t[j], bs = b_s[j];
    float sa0 = 0.f, sa1 = 0.f, sb0 = 0.f, sb1 = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r16 + g + 8 * h;
      const int64_t grow = row0 + row;
      const float2 ct = unpack_bf16(cond_t[j][h]);
      const float2 cs = unpack_bf16(cond_s[j][h]);
      float da[2], db[2], act[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float gt = acc_g[4 * j + 2 * h + e] + (e ? bt.y : bt.x) +
                         (e ? ct.y : ct.x);
        const float gs = acc_g[4 * (j + kPass / 8) + 2 * h + e] +
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
        *reinterpret_cast<uint32_t*>(acts_p + grow * gp + ch) =
            pack_bf16(act[0], act[1]);
        if (ch_ok) {
          bf16* dc = dcond + grow * 2 * G + ch;
          store_pair(dc, pack_bf16(da[0], da[1]), pairs, second);
          store_pair(dc + G, pack_bf16(db[0], db[1]), pairs, second);
        }
        if (pad_g) {
          bf16* dg = dg_p + grow * 2 * gp + ch;
          *reinterpret_cast<uint32_t*>(dg) = pack_bf16(da[0], da[1]);
          *reinterpret_cast<uint32_t*>(dg + gp) = pack_bf16(db[0], db[1]);
        }
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
      float* rw = red + warp * 2 * kPass + 8 * j + 2 * tig;
      rw[0] = sa0;
      rw[1] = sa1;
      rw[kPass] = sb0;
      rw[kPass + 1] = sb1;
    }
  }

  // ---- the tile's dgates column sums over the 8 row warps, in order
  __syncthreads();
  float* out = a.part_bias + (static_cast<int64_t>(b) * a.tiles_t + tile) *
                                 (2 * gp + n_rsp);
  for (int col = threadIdx.x; col < 2 * kPass; col += kThreads) {
    float sum = red[col];
#pragma unroll
    for (int w = 1; w < 8; ++w) sum += red[w * 2 * kPass + col];
    out[col < kPass ? cb + col : gp + cb + col - kPass] = sum;
  }
}

// ---- dx: the taps' adjoint --------------------------------------------------

// One block per (128 flat rows, kN output channels): a product over K * 2Gp,
// chunk c the (tap c / (2Gp / 64), gate columns 64 (c % (2Gp / 64)) + [0,
// 64)) of dgates rows t - (tap - K/2)*d of each row's own batch row (zero
// outside [0, T)), against w_in rows tap*Cp + n0 + n, both K-major. As in
// the rows kernel, the loops read registers and count the chunk's tap and
// columns.
template <int kN>
__device__ __forceinline__ void dx_body(const BwdArgs& a, uint32_t ring) {
  constexpr int kStage = nt_stage(kN), kStages = nt_stages(kN);
  const int C = a.C, cp = a.cp, gp = a.gp, K = a.K, T = a.T, R = a.rows;
  const int chunks = K * (2 * gp / kKC);
  const int rt0 = blockIdx.x * kTile;  // the tile's first flat row
  const int n0 = blockIdx.y * kN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r16 = warp * 16;
  const int g = lane / 4, tig = lane % 4;
  const int q = threadIdx.x % 8;

  // This thread's copies of a chunk: A rows tid / 8 + 32i (their dgates
  // rows from `arow`, their time `tt`, far negative past the last row),
  // piece q; B w_in rows n0 + tid / 8 + 32i, piece q, both K-major.
  const bf16* __restrict__ dg = a.dg_p;
  const int dilation = a.dilation;
  const bf16* arow[4];
  int64_t tt[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int fr = rt0 + threadIdx.x / 8 + 32 * i;
    const int bi = div_by(fr, a.div_t);
    arow[i] = dg + static_cast<int64_t>(bi) * T * 2 * gp + q * 8;
    tt[i] = fr < R ? fr - static_cast<int64_t>(bi) * T : -(int64_t{1} << 40);
  }
  const uint32_t a_dst = sw128_piece(threadIdx.x / 8, q);
  const bf16* __restrict__ wa =
      a.w_in_k + static_cast<int64_t>(n0 + threadIdx.x / 8) * 2 * gp + q * 8;
  const int64_t w_step = static_cast<int64_t>(32) * 2 * gp;  // 32 w_in rows
  int ld_tap = 0, ld_m0 = 0;  // the next chunk's tap and gate columns

  // chunk c into its stage (called for c = 0, 1, 2, ... in turn)
  const auto load = [&](int c) {
    if (c < chunks) {
      const uint32_t st = ring + (c % kStages) * kStage;
      // dx[t] takes dgates[t - (tap - K/2)*d]
      const int shift = (ld_tap - K / 2) * dilation;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int64_t s = tt[i] - shift;
        const bool ok = s >= 0 && s < T;
        cp_async16_zfill(st + a_dst + i * 4096,
                         ok ? arow[i] + s * 2 * gp + ld_m0 : dg, ok);
      }
      const bf16* w0 =
          wa + static_cast<int64_t>(ld_tap) * cp * 2 * gp + ld_m0;
#pragma unroll
      for (int i = 0; i < kN / 32; ++i)
        cp_async16(st + kABytes + a_dst + i * 4096, w0 + i * w_step);
      ld_m0 += kKC;
      if (ld_m0 == 2 * gp) {
        ld_m0 = 0;
        ++ld_tap;
      }
    }
    cp_async_commit();
  };

  for (int c = 0; c < ring_ahead(kStages); ++c) load(c);
  float acc[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) acc[i] = 0.f;
#pragma unroll 1
  for (int c = 0; c < chunks; ++c)
    ring_step<kN, 0, 0, kStages>(ring, kStage, c, acc, load);
  wgmma_wait<0>();
  fence_acc(acc);
  cp_async_wait<0>();

  // the epilogue: each row's dx_next loads all issued before any store
  // (dx_next and dx are distinct, but the compiler cannot know it of two
  // fields), channels past C dropped (C even: a pair's second too)
  const float* __restrict__ dx_next = a.dx_next;
  float* __restrict__ dx = a.dx;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int fr = rt0 + r16 + g + 8 * h;
    if (fr >= R) continue;
    const int bi = div_by(fr, a.div_t);
    const bool add = dx_next != nullptr &&
                     (a.valid_t == nullptr || fr - bi * T < a.valid_t[bi]);
    const int64_t off = static_cast<int64_t>(fr) * C + n0 + 2 * tig;
    if (add) {
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        if (n0 + 8 * j + 2 * tig >= C) continue;
        const float2 n =
            *reinterpret_cast<const float2*>(dx_next + off + 8 * j);
        acc[4 * j + 2 * h] = n.x + acc[4 * j + 2 * h];
        acc[4 * j + 2 * h + 1] = n.y + acc[4 * j + 2 * h + 1];
      }
    }
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      if (n0 + 8 * j + 2 * tig >= C) continue;
      *reinterpret_cast<float2*>(dx + off + 8 * j) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
wn_bwd_any_dx_kernel(const __grid_constant__ BwdArgs a) {
  extern __shared__ __align__(1024) uint4 smem_dx[];
  const uint32_t ring = smem_u32(smem_dx);
  switch (a.dx_n) {
    case 64: dx_body<64>(a, ring); break;
    case 128: dx_body<128>(a, ring); break;
    default: dx_body<192>(a, ring); break;
  }
}

// ---- weights: dw_in and dw_rs, f32 partials of row ranges -------------------

// Output tiles of 128 rows x N columns: dw_in_p's (ceil(K*Cp / 128) x 2Gp /
// N), then dw_rs_p^T's (ceil(n_rsp / 128) x Gp / N); N = n_tile(Gp).
struct WeightTiles {
  int n, in_mt, in_nt, rs_mt, rs_nt;
  int count() const { return in_mt * in_nt + rs_mt * rs_nt; }
};

WeightTiles weight_tiles(int C, int G, int K, int last) {
  const int cp = pad64(C), gp = pad64(G), n_rsp = last ? cp : 2 * cp;
  const int n = n_tile(gp);
  return {n, (K * cp + kTile - 1) / kTile, 2 * gp / n,
          (n_rsp + kTile - 1) / kTile, gp / n};
}

// blockIdx.x: the output tile; blockIdx.y: the range s, rows [tb, te) of
// batch rows [b0, b1): with bq = s / n_splits_t and ts = s % n_splits_t,
// b0 = bq * split_batches, b1 = min(B, b0 + split_batches), tb = ts *
// split_rows, te = min(T, tb + split_rows) (a part of one batch row, or
// whole batch rows where split_batches > 1 and n_splits_t = 1). Each batch
// row's rows run in 64-row chunks from tb. Writes its f32 partial of the
// tile into slot s of ws, each slot dw_in_p [K*Cp, 2Gp] then dw_rs_p [Gp,
// n_rsp]. out[m][n] = sum over the range's rows t of A[t + shift][m]
// B[t][n]: dw_in, A = x_p at tap-k columns (shift (k - K/2)*d; this
// thread's 8 M values (tid % 16) * 8 lie in one tap), B = dgates; dw_rs^T,
// A = g_p, B = acts_p.
template <int kN>
__device__ __forceinline__ void weights_body(const BwdArgs& a,
                                             uint32_t ring) {
  constexpr int kStage = nt_stage(kN), kStages = nt_stages(kN);
  constexpr int kPer = kN / 8;  // 16-byte pieces of a B row
  const int cp = a.cp, gp = a.gp, K = a.K, T = a.T, n_rsp = a.n_rsp;
  const int s = blockIdx.y;
  const int bq = s / a.n_splits_t, ts = s - bq * a.n_splits_t;
  const int b0 = bq * a.split_batches;
  const int b1 = min(a.batch, b0 + a.split_batches);
  const int tb = ts * a.split_rows, te = min(T, tb + a.split_rows);
  const int cpb = (te - tb + kKC - 1) / kKC;  // chunks of a batch row
  const int chunks = (b1 - b0) * cpb;
  const int64_t dw_in_size = static_cast<int64_t>(K) * cp * 2 * gp;
  float* wsp = a.ws + s * (dw_in_size + static_cast<int64_t>(gp) * n_rsp);

  const int m = (threadIdx.x % 16) * 8;  // this thread's A values of a row
  const bf16 *a_src, *b_src;
  int lda, ldb, m_ext, ld_m, ld_n;
  int64_t shift;
  float* out;
  if (static_cast<int>(blockIdx.x) < a.in_mt * a.in_nt) {
    // dw_in_p rows mt * 128 + m (tap, channel), columns nt * kN + n
    const int mt = blockIdx.x / a.in_nt, nt = blockIdx.x - mt * a.in_nt;
    const int mrow = mt * kTile + m;
    const int tap = mrow / cp;
    a_src = a.x_p + (mrow - tap * cp);
    lda = cp;
    shift = static_cast<int64_t>(tap - K / 2) * a.dilation;
    m_ext = min(kTile, K * cp - mt * kTile);
    b_src = a.dg_p + nt * kN;
    ldb = 2 * gp;
    out = wsp + static_cast<int64_t>(mt) * kTile * 2 * gp + nt * kN;
    ld_m = 2 * gp;
    ld_n = 1;
  } else {
    // dw_rs_p^T rows mt * 128 + m (of n_rsp), columns nt * kN + n (of Gp)
    const int tile = blockIdx.x - a.in_mt * a.in_nt;
    const int mt = tile / a.rs_nt, nt = tile - mt * a.rs_nt;
    a_src = a.g_p + mt * kTile + m;
    lda = n_rsp;
    shift = 0;
    m_ext = min(kTile, n_rsp - mt * kTile);
    b_src = a.acts_p + nt * kN;
    ldb = gp;
    out = wsp + dw_in_size + static_cast<int64_t>(nt) * kN * n_rsp +
          mt * kTile;
    ld_m = 1;
    ld_n = n_rsp;
  }
  const bool m_ok = m < m_ext;

  // Chunk c: the rows ld_t1 + [0, 64) of the batch row from flat row
  // ld_row0, zero at or past te (counters, the batch row's chunks in turn);
  // A [64 K][128 M] and B [64 K][kN], MN-major. This thread's A pieces: K
  // rows ka + 16i at its M values m.
  const int ka = threadIdx.x / 16;
  const uint32_t a_dst = m / 64 * kBlock + sw128_piece(ka, m % 64 / 8);
  int ld_t1 = tb;
  int64_t ld_row0 = static_cast<int64_t>(b0) * T;
  const auto load = [&](int c) {
    if (c < chunks) {
      const uint32_t st = ring + (c % kStages) * kStage;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ld_t1 + ka + 16 * i;
        const int64_t src_t = t + shift;
        const bool ok = m_ok && t < te && src_t >= 0 && src_t < T;
        cp_async16_zfill(st + a_dst + i * 2048,
                         ok ? a_src + (ld_row0 + src_t) * lda : a_src, ok);
      }
#pragma unroll
      for (int i = 0; i < kN / 32; ++i) {
        const int p = threadIdx.x + i * kThreads;
        const int kr = p / kPer, n = (p % kPer) * 8;
        const int t = ld_t1 + kr;
        const bool ok = t < te;
        cp_async16_zfill(
            st + kABytes + n / 64 * kBlock + sw128_piece(kr, n % 64 / 8),
            ok ? b_src + (ld_row0 + t) * ldb + n : b_src, ok);
      }
      ld_t1 += kKC;
      if (ld_t1 >= te) {
        ld_t1 = tb;
        ld_row0 += T;
      }
    }
    cp_async_commit();
  };

  for (int c = 0; c < ring_ahead(kStages); ++c) load(c);
  float acc[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) acc[i] = 0.f;
#pragma unroll 1
  for (int c = 0; c < chunks; ++c)
    ring_step<kN, 1, 1, kStages>(ring, kStage, c, acc, load);
  wgmma_wait<0>();
  fence_acc(acc);
  cp_async_wait<0>();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int mm = warp * 16 + g + 8 * h;
    if (mm >= m_ext) continue;
    float* o = out + static_cast<int64_t>(mm) * ld_m;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      const int n = 8 * j + 2 * tig;
      if (ld_n == 1) {
        *reinterpret_cast<float2*>(o + n) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      } else {
        o[static_cast<int64_t>(n) * ld_n] = acc[4 * j + 2 * h];
        o[static_cast<int64_t>(n + 1) * ld_n] = acc[4 * j + 2 * h + 1];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
wn_bwd_any_weights_kernel(const __grid_constant__ BwdArgs a) {
  extern __shared__ __align__(1024) uint4 smem_w[];
  const uint32_t ring = smem_u32(smem_w);
  switch (a.w_n) {
    case 64: weights_body<64>(a, ring); break;
    case 128: weights_body<128>(a, ring); break;
    case 192: weights_body<192>(a, ring); break;
    default: weights_body<256>(a, ring); break;
  }
}

// ---- reduce: fixed-order sums, the padding dropped, casts -------------------

// Blocks [0, bias blocks): one warp a bias column, db_in's 2G then db_rs's
// n_rs (none for a rank), its lanes summing every 32nd of the B * tiles_t
// rows of part_bias, then a butterfly. The blocks after them: one thread an
// element of dw_in [K*C, 2G] then dw_rs [G, n_rs], summing the ranges'
// partials in order.
constexpr int kBiasCols = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
wn_bwd_any_reduce_kernel(const __grid_constant__ BwdArgs a) {
  const int C = a.C, G = a.G, cp = a.cp, gp = a.gp, n_rs = a.n_rs;
  const int n_rsp = a.n_rsp;
  const int n_bias = 2 * G + (a.db_rs != nullptr ? n_rs : 0);
  const int bias_blocks = (n_bias + kBiasCols - 1) / kBiasCols;
  if (static_cast<int>(blockIdx.x) < bias_blocks) {
    const int col = blockIdx.x * kBiasCols + threadIdx.x / 32;
    if (col >= n_bias) return;  // the whole warp
    const int lane = threadIdx.x % 32;
    const bool in = col < 2 * G;
    const int c = in ? col : col - 2 * G;
    const int p = in ? c / G * gp + c % G : 2 * gp + c / C * cp + c % C;
    const int ld = 2 * gp + n_rsp;
    const int n_tiles = a.batch * a.tiles_t;
    float s = 0.f;
    for (int i = lane; i < n_tiles; i += 32)
      s += a.part_bias[static_cast<int64_t>(i) * ld + p];
#pragma unroll
    for (int m = 16; m > 0; m /= 2) s += __shfl_xor_sync(0xffffffffu, s, m);
    if (lane == 0) {
      if (in) a.db_in[c] = s;
      else a.db_rs[c] = s;
    }
    return;
  }
  const int n_in = a.K * C * 2 * G;
  const int n_w = n_in + G * n_rs;
  const int w = (blockIdx.x - bias_blocks) * kThreads + threadIdx.x;
  if (w >= n_w) return;
  const int dw_in_size = a.K * cp * 2 * gp;
  int p = w;  // C = Cp, G = Gp: the padded layouts are the outputs'
  if (a.pad) {
    if (w < n_in) {
      const int row = w / (2 * G), col = w - row * 2 * G;
      const int tap = row / C, ci = row - tap * C;
      p = (tap * cp + ci) * 2 * gp + col / G * gp + col % G;
    } else {
      const int c = (w - n_in) / n_rs, col = w - n_in - c * n_rs;
      p = dw_in_size + c * n_rsp + col / C * cp + col % C;
    }
  }
  const int64_t stride = dw_in_size + static_cast<int64_t>(gp) * n_rsp;
  const int n_splits = (a.batch + a.split_batches - 1) / a.split_batches *
                       a.n_splits_t;
  float s = 0.f;
  for (int i = 0; i < n_splits; ++i) s += a.ws[i * stride + p];
  const bf16 v = __float2bfloat16(s);
  if (w < n_in) a.dw_in[w] = v;
  else a.dw_rs[w - n_in] = v;
}

// The kernel `which` (0 rows, 1 dx, 2 weights, 3 reduce, 4 prep, 5 pad) and
// its dynamic shared bytes at width C and gate width G.
const void* kernel_for(int which, int C, int G, int* smem_bytes) {
  *smem_bytes = 0;
  switch (which) {
    case 0:
      *smem_bytes = kRowsSmem;
      return G != C ? reinterpret_cast<const void*>(
                          wn_bwd_any_rows_kernel<true>)
                    : reinterpret_cast<const void*>(
                          wn_bwd_any_rows_kernel<false>);
    case 1:
      *smem_bytes = nt_smem(dx_tile(pad64(C)));
      return reinterpret_cast<const void*>(wn_bwd_any_dx_kernel);
    case 2:
      *smem_bytes = nt_smem(n_tile(pad64(G)));
      return reinterpret_cast<const void*>(wn_bwd_any_weights_kernel);
    case 3:
      return reinterpret_cast<const void*>(wn_bwd_any_reduce_kernel);
    case 4:
      return reinterpret_cast<const void*>(wn_bwd_any_prep_kernel);
    case 5:
      return reinterpret_cast<const void*>(wn_bwd_any_pad_kernel);
    default:
      return nullptr;
  }
}

std::atomic<uint32_t> g_opted_in[4];  // rows, a rank's rows, dx, weights

bool bad_shape(int C, int G, int K) {
  return C <= 0 || C % 2 != 0 || C > kMaxC || G <= 0 || G > C || K <= 0 ||
         K % 2 != 1;
}

// One backward: `a`'s inputs, outputs and scratch set, the rest derived
// here; see the entry points.
cudaError_t launch(BwdArgs& a, int batch, int T, int C, int G, int K,
                   int dilation, int last, int n_splits_t, int split_rows,
                   int split_batches, cudaStream_t stream) {
  const int cp = pad64(C), gp = pad64(G);
  const bool pad = cp != C || gp != G, pad_g = gp != G;
  const int64_t rows = static_cast<int64_t>(batch) * T;
  if (T <= 0 || batch <= 0 || batch > 65535 ||
      rows >= (int64_t{1} << 31) - kTile || bad_shape(C, G, K) ||
      dilation < 0 ||
      static_cast<int64_t>(K) * cp * 2 * gp + 2 * cp * gp >=
          (int64_t{1} << 31) ||
      n_splits_t <= 0 || split_rows <= 0 || split_rows % kKC != 0 ||
      split_batches <= 0 || (split_batches > 1 && n_splits_t != 1) ||
      static_cast<int64_t>(n_splits_t) * split_rows < T ||
      static_cast<int64_t>((batch + split_batches - 1) / split_batches) *
              n_splits_t > 65535 ||
      a.x_p == nullptr || a.g_p == nullptr || a.acts_p == nullptr ||
      a.part_bias == nullptr || a.ws == nullptr ||
      (pad && (a.w_in_p == nullptr || a.w_rs_p == nullptr)) ||
      (pad_g && a.dg_p == nullptr))
    return cudaErrorInvalidValue;
  const WeightTiles wt = weight_tiles(C, G, K, last);
  if (!pad_g) a.dg_p = a.dcond;
  a.w_in_k = pad ? a.w_in_p : a.w_in;
  a.w_rs_k = pad ? a.w_rs_p : a.w_rs;
  a.batch = batch;
  a.T = T;
  a.C = C;
  a.G = G;
  a.K = K;
  a.dilation = dilation;
  a.last = last;
  a.rows = static_cast<int>(rows);
  a.cp = cp;
  a.gp = gp;
  a.n_rs = last ? C : 2 * C;
  a.n_rsp = last ? cp : 2 * cp;
  a.pad = pad;
  a.pad_g = pad_g;
  a.in_blocks = cp / kKC;
  a.tiles_t = (T + kTile - 1) / kTile;
  a.passes = gp / kPass;
  a.dx_n = dx_tile(cp);
  a.w_n = wt.n;
  a.in_mt = wt.in_mt;
  a.in_nt = wt.in_nt;
  a.rs_mt = wt.rs_mt;
  a.rs_nt = wt.rs_nt;
  a.n_splits_t = n_splits_t;
  a.split_rows = split_rows;
  a.split_batches = split_batches;
  a.div_passes = fast_div(a.passes);
  a.div_t = fast_div(T);

  cudaError_t err;
  if (pad) {
    wn_bwd_any_pad_kernel<<<K * cp + gp, kThreads, 0, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  wn_bwd_any_prep_kernel<<<dim3(a.tiles_t, batch), kThreads, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 rows_grid(a.tiles_t * a.passes, batch);
  if (G != C) {
    err = opt_in_smem(wn_bwd_any_rows_kernel<true>, kRowsSmem,
                      &g_opted_in[1]);
    if (err != cudaSuccess) return err;
    wn_bwd_any_rows_kernel<true><<<rows_grid, kThreads, kRowsSmem, stream>>>(
        a);
  } else {
    err = opt_in_smem(wn_bwd_any_rows_kernel<false>, kRowsSmem,
                      &g_opted_in[0]);
    if (err != cudaSuccess) return err;
    wn_bwd_any_rows_kernel<false><<<rows_grid, kThreads, kRowsSmem,
                                    stream>>>(a);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // both opted in at the most bytes of any N, launched with their own N's
  err = opt_in_smem(wn_bwd_any_dx_kernel, kSmemMax, &g_opted_in[2]);
  if (err != cudaSuccess) return err;
  wn_bwd_any_dx_kernel<<<dim3((a.rows + kTile - 1) / kTile, cp / a.dx_n),
                         kThreads, nt_smem(a.dx_n), stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = opt_in_smem(wn_bwd_any_weights_kernel, kSmemMax, &g_opted_in[3]);
  if (err != cudaSuccess) return err;
  const int ranges =
      (batch + split_batches - 1) / split_batches * n_splits_t;
  wn_bwd_any_weights_kernel<<<dim3(wt.count(), ranges), kThreads,
                              nt_smem(wt.n), stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int n_bias = 2 * G + (a.db_rs != nullptr ? a.n_rs : 0);
  const int n_w = K * C * 2 * G + G * a.n_rs;
  const int blocks = (n_bias + kBiasCols - 1) / kBiasCols +
                     (n_w + kThreads - 1) / kThreads;
  wn_bwd_any_reduce_kernel<<<blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Output tiles of the weights kernel at (C, K, last): each a block for each
// range of the cut; -1 for a shape the kernels do not take.
int wn_layer_bwd_any_weight_tiles(int C, int K, int last) {
  if (bad_shape(C, C, K)) return -1;
  return weight_tiles(C, C, K, last).count();
}

// The same for a rank's backward at gate width G.
int wn_layer_shard_bwd_any_weight_tiles(int C, int G, int K, int last) {
  if (bad_shape(C, G, K)) return -1;
  return weight_tiles(C, G, K, last).count();
}

// The bf16 backward of one whole layer at any even C up to 1,280 and odd K,
// on `stream` (pad where C is not a multiple of 64, then prep, rows, dx,
// weights, reduce), no synchronisation; returns the first launch error.
// Inputs: x [batch, T, C] f32; cond [batch, T, 2C], w_in [K*C, 2C], w_rs
// [C, n_rs] bf16 (n_rs = C when last, else 2C); b_in [2C] f32; dx_next,
// dskip [batch, T, C] f32 or null (zero); valid_t [batch] int32 or null.
// Outputs: dx f32 like x, dcond bf16 like cond, dw_in / dw_rs bf16 like the
// weights, db_in / db_rs f32. Scratch, from the caller (Cp = C rounded up
// to 64, n_rsp = Cp when last, else 2Cp; R = batch*T; tiles = batch *
// ceil(T / 128)): x_p, acts_p [R, Cp], g_p [R, n_rsp] bf16; part_bias
// [tiles, 2Cp + n_rsp] f32; where C != Cp (else null) w_in_p [K*Cp, 2Cp],
// w_rs_p [Cp, n_rsp], dg_p [R, 2Cp] bf16; ws [ranges, K*Cp*2Cp +
// Cp*n_rsp] f32. The weights kernel's ranges (see its kernel):
// ceil(batch / split_batches) * n_splits_t of them, each batch row's T cut
// into n_splits_t ranges of split_rows rows (a multiple of 64), or
// split_batches > 1 whole batch rows a range (n_splits_t = 1). Pointers
// 16-byte aligned, contiguous.
cudaError_t wn_layer_backward_any_bf16(
    const float* x, const void* cond, const void* w_in, const float* b_in,
    const void* w_rs, const float* dx_next, const float* dskip,
    const int* valid_t, float* dx, void* dcond, void* dw_in, float* db_in,
    void* dw_rs, float* db_rs, void* x_p, void* g_p, void* w_in_p,
    void* w_rs_p, void* acts_p, void* dg_p, float* part_bias, float* ws,
    int batch, int T, int C, int K, int dilation, int last, int n_splits_t,
    int split_rows, int split_batches, cudaStream_t stream) {
  if (db_rs == nullptr) return cudaErrorInvalidValue;
  BwdArgs a{};
  a.x = x;
  a.cond = static_cast<const bf16*>(cond);
  a.w_in = static_cast<const bf16*>(w_in);
  a.b_in = b_in;
  a.w_rs = static_cast<const bf16*>(w_rs);
  a.dx_next = dx_next;
  a.drs_a = dx_next;
  a.drs_b = dskip;
  a.drs_ld = C;
  a.valid_t = valid_t;
  a.dx = dx;
  a.dcond = static_cast<bf16*>(dcond);
  a.dw_in = static_cast<bf16*>(dw_in);
  a.db_in = db_in;
  a.dw_rs = static_cast<bf16*>(dw_rs);
  a.db_rs = db_rs;
  a.x_p = static_cast<bf16*>(x_p);
  a.g_p = static_cast<bf16*>(g_p);
  a.acts_p = static_cast<bf16*>(acts_p);
  a.dg_p = static_cast<bf16*>(dg_p);
  a.w_in_p = static_cast<bf16*>(w_in_p);
  a.w_rs_p = static_cast<bf16*>(w_rs_p);
  a.part_bias = part_bias;
  a.ws = ws;
  return launch(a, batch, T, C, C, K, dilation, last, n_splits_t, split_rows,
                split_batches, stream);
}

// The bf16 backward of one model rank's share of a layer at gate width G
// (1 <= G <= C; wn_layer_any.cu's partial mode): the whole layer's kernels
// with g [batch, T, n_rs] f32, the cotangent of the rank's partial, as drs
// (no mask), nothing added to dx and no db_rs. Inputs: x [batch, T, C] f32;
// cond_s [batch, T, 2G], w_in_s [K*C, 2G], w_rs_s [G, n_rs] bf16; b_in_s
// [2G] f32. Outputs: dx [batch, T, C] f32 (the rank's partial dx), dcond
// bf16 like cond_s, dw_in / dw_rs bf16 like the weights, db_in [2G] f32.
// Scratch as wn_layer_backward_any_bf16's with Gp = G rounded up to 64 for
// the gate's Cp: acts_p [R, Gp]; part_bias [tiles, 2Gp + n_rsp]; ws
// [ranges, K*Cp*2Gp + Gp*n_rsp]; w_in_p [K*Cp, 2Gp] and w_rs_p [Gp, n_rsp]
// where C != Cp or G != Gp, dg_p [R, 2Gp] where G != Gp (else null).
cudaError_t wn_layer_shard_backward_any_bf16(
    const float* x, const void* cond_s, const void* w_in_s,
    const float* b_in_s, const void* w_rs_s, const float* g, float* dx,
    void* dcond, void* dw_in, float* db_in, void* dw_rs, void* x_p,
    void* g_p, void* w_in_p, void* w_rs_p, void* acts_p, void* dg_p,
    float* part_bias, float* ws, int batch, int T, int C, int G, int K,
    int dilation, int last, int n_splits_t, int split_rows,
    int split_batches, cudaStream_t stream) {
  if (g == nullptr) return cudaErrorInvalidValue;
  BwdArgs a{};
  a.x = x;
  a.cond = static_cast<const bf16*>(cond_s);
  a.w_in = static_cast<const bf16*>(w_in_s);
  a.b_in = b_in_s;
  a.w_rs = static_cast<const bf16*>(w_rs_s);
  a.dx_next = nullptr;
  a.drs_a = last ? nullptr : g;
  a.drs_b = last ? g : g + C;
  a.drs_ld = last ? C : 2 * C;
  a.valid_t = nullptr;
  a.dx = dx;
  a.dcond = static_cast<bf16*>(dcond);
  a.dw_in = static_cast<bf16*>(dw_in);
  a.db_in = db_in;
  a.dw_rs = static_cast<bf16*>(dw_rs);
  a.db_rs = nullptr;
  a.x_p = static_cast<bf16*>(x_p);
  a.g_p = static_cast<bf16*>(g_p);
  a.acts_p = static_cast<bf16*>(acts_p);
  a.dg_p = static_cast<bf16*>(dg_p);
  a.w_in_p = static_cast<bf16*>(w_in_p);
  a.w_rs_p = static_cast<bf16*>(w_rs_p);
  a.part_bias = part_bias;
  a.ws = ws;
  return launch(a, batch, T, C, G, K, dilation, last, n_splits_t, split_rows,
                split_batches, stream);
}

// What the loaded build of kernel `which` (0 rows, 1 dx, 2 weights, 3
// reduce, 4 prep, 5 pad) uses, from the CUDA runtime: registers and local
// (spill) bytes per thread, static shared bytes, and the dynamic shared
// bytes its launcher passes at width C and gate width G (G = C: the whole
// layer's).
cudaError_t wn_layer_shard_bwd_any_kernel_info(int which, int C, int G,
                                               int* registers,
                                               int* local_bytes,
                                               int* static_smem_bytes,
                                               int* dynamic_smem_bytes) {
  if (bad_shape(C, G, 1)) return cudaErrorInvalidValue;
  const void* kernel = kernel_for(which, C, G, dynamic_smem_bytes);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  *registers = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *static_smem_bytes = static_cast<int>(attr.sharedSizeBytes);
  return cudaSuccess;
}

// The whole layer's (G = C).
cudaError_t wn_layer_bwd_any_kernel_info(int which, int C, int* registers,
                                         int* local_bytes,
                                         int* static_smem_bytes,
                                         int* dynamic_smem_bytes) {
  return wn_layer_shard_bwd_any_kernel_info(which, C, C, registers,
                                            local_bytes, static_smem_bytes,
                                            dynamic_smem_bytes);
}

}  // extern "C"
