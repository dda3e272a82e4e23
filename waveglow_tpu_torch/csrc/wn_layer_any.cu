// Fused WN layer forward at any even width C and any odd kernel size K, for
// Hopper (sm_90a), CUDA C++ with a plain C interface (bound from Python with
// ctypes, see kernels/wn_layer.py: wn_layer_any).
//
// Replaces, at the shapes wn_layer.cu's specialised kernels are not built
// for (C outside {128, 256, 512}, or K != 3):
//   * waveglow_tpu/kernels/wn_layer.py::_wn_layer_fused (the Pallas kernel,
//     which takes any C) at widths outside that set, and
//   * the XLA layer body of waveglow_tpu/models/wn.py::wn_forward, which the
//     JAX package runs at kernel_size != 3 (its K-tap im2col product, the
//     gate, the res/skip product and the residual and skip adds).
// It computes the same function as wn_layer.cu:
//
//   pre  = sum_k x[t + (k - K/2)*d] @ w_in[k]        (zero "same" padding)
//   g    = pre + b_in + cond                         (f32)
//   acts = tanh(g[:C]) * sigmoid(g[C:])              (f32)
//   rs   = acts @ w_rs + b_rs                        (f32 accumulation)
//   x'   = x + rs[:C], skip = rs[C:]                 (last layer: x' = x, skip = rs)
//   skip_acc += skip in place (when accumulating), x' rows >= valid_t[b] = 0
//
// and, in partial mode, one model rank's share of it (kernels/wn_layer.py:
// wn_layer_shard_any), which replaces the per-rank cut of the same Pallas
// kernel and XLA body that GSPMD makes of them under a `model` mesh axis
// (waveglow_tpu/parallel/sharding.py): the gate over the rank's G = C' of
// the gate channels, the res/skip product over the same G rows,
//
//   pre     = sum_k x[t + (k - K/2)*d] @ w_in_s[k]   (w_in_s [K*C, 2G])
//   acts    = tanh(pre[:G] + b_in_s[:G] + cond_s[:G]) * sigmoid(...[G:])
//   partial = acts @ w_rs_s                          (w_rs_s [G, n_rs], f32)
//
// with no b_rs, no residual, no skip sum and no row mask: the ranks'
// partials are summed outside, then those are added (models/wn.py). The
// whole layer is partial mode's arithmetic at G = C plus its epilogue, and
// a rank's kernels are the whole layer's at a run-time gate width G apart
// from the input and output width C.
//
// C, G, K, the dilation d, B and T are runtime arguments. Global layouts: x,
// x', skip [B, T, C], cond [B, T, 2G], w_in [K*C, 2G], w_rs [G, 2C] (last
// layer [G, C]), a rank's partial [B, T, n_rs] (n_rs = 2C, the last layer's
// C), all row-major; G = C but for a rank. x, x', b_in, b_rs, the skip sum
// and the partial are f32.
// cond, w_in and w_rs are f32 (parity mode) or bf16 (fast mode); in fast
// mode the taps of x and the acts are rounded to bf16 where they enter a
// product, every product accumulates in f32, and pre, the gate and rs stay
// f32: the rounding points of wn_layer.cu and of the plain version.
//
// What bounds it on an H100 SXM (67 TFLOP/s f32 on the CUDA cores, 989
// TFLOP/s bf16 on the tensor cores, 3.35 TB/s HBM). A non-last layer does
// 2*B*T*C*(K*2C + 2C) operations and must move x in, x' out and the skip
// sum in and out (f32: 16 bytes a row and channel) and cond in (two values
// a row and channel in the compute dtype). At B=1, T=26,432 groups (826
// frames):
//   * f32 is operation-bound: (256, 5) 41.6 GFLOP, 0.62 ms; (384, 3) 62.4
//     GFLOP, 0.93 ms;
//   * bf16 is balanced: (256, 5) 0.042 ms of tensor-core time against
//     0.040 ms of bytes; (384, 3) 0.063 ms against 0.061 ms.
//
// Design. Both modes read their operands in layouts padded to Cp = C
// rounded up to 64 channels and Gp = G rounded up to 64 gate channels
// (zero past C and G), so every copy into shared memory
// is an aligned 16-byte cp.async and every channel tail is zero: C = 48 and
// C = 50, or a rank's G = 25, are exact. Where C and G are multiples of 64
// the f32 operands are read
// as they are (their layout is the padded one); otherwise, and in bf16 for
// x always, wn_any_prep_kernel first writes them into scratch the wrapper
// allocates: x_p [B*T, Cp] (x rounded to bf16 in fast mode, so nothing is
// rounded on a K loop; only where C != Cp in f32), w_in_p [K*Cp, 2Gp] and
// w_rs_p [Gp, n_rsp] (each half of the columns from column 0 and from
// column Gp, or Cp; n_rsp = 2Cp, the last layer's Cp). The gate runs in
// passes of the Gp gate channels over a product K*Cp deep; the res/skip
// product in passes of the output channels over a product Gp deep; the
// acts lie between them in a scratch [B*T, Gp]. A rank with an odd G reads
// the sigmoid half of cond and b_in one value at a time (its pairs are not
// aligned). Taps are rows of the flat [B*T, Cp] rows: row R = b*T +
// t reads row R + (k - K/2)*d where t + (k - K/2)*d lies in [0, T) (its own
// sequence), else zero; taps reach +-(K/2)*d rows (+-384 at K = 7 and d =
// 128), so each tap's rows are copied on their own, no halo window. Both
// designs walk the channels in passes of 128 (the last one 64 when Cp is
// not a multiple of 128; the columns past Cp are zero-filled).
//   * wn_any_kernel_f32<last> (parity mode): true f32 FMAs on the CUDA
//     cores, no TF32. The register tile, ring and one-wave schedule of
//     wn_layer.cu's f32 kernel at C = 512 (f32_ring.cuh): one wave of
//     384-thread blocks, one an SM, each walking an equal share (a multiple
//     of 16 rows) of the flat B*T rows in tiles of 96 rows x passes of 128
//     channels; a thread holds 8 rows x (4 + 4) channels, 64 accumulators,
//     so a weight value read from shared memory feeds 8 rows and each
//     weight row copied into the ring feeds 96. A tile's two products (K*Cp
//     deep, then Cp deep) run as one sequence of 16-deep K chunks (tap, 16
//     channels) through a 4-stage ring, three chunks ahead of the FMAs, one
//     barrier a chunk, running on across tiles (32-deep chunks were slower
//     and spilled). A block's last tile of 16 rows or fewer (16 of its 208
//     rows at B=1, T=26,432), which busies one pair of warps in six, runs
//     its two passes at once at P = 2, and at Gp = 64 (one gate pass of 64
//     channels: the whole layer at C <= 64, and most ranks of a small
//     model) an instance of its own takes tiles of 192 rows, each column
//     of warps 96 of them, its res/skip product in passes of 64 output
//     channels (AnyF32's note). The gate of each
//     pass writes its acts (f32) to a global scratch [B*T, Cp] (a block's
//     own rows), which the res/skip chunks read back through the ring.
//     cond's rows, then the residual's x rows and the skip sum, are
//     prefetched into L2 before the gate and the epilogue read them.
//   * bf16 (fast mode), wn_layer.cu's C = 512 design at run-time C and K,
//     three kernels a call:
//       wn_any_prep_kernel<true> - x rounded to bf16 once into x_p (and the
//         weights padded where C is not a multiple of 64).
//       wn_any_gate_kernel - a unit is 128 flat rows (two warpgroups of 64)
//         x one pass of 128 gate channels: pre = the K taps of x_p @ w_in
//         at the pass's 128 tanh and 128 sigmoid columns (wgmma m64n128k16,
//         128 f32 accumulators a thread), K*Cp deep in (tap, 64-channel)
//         chunks, so a weight chunk read from L2 feeds 128 rows and the taps
//         are read Cp/128 times; then the gate in f32 on the accumulators,
//         the acts rounded to bf16 into the scratch acts [B*T, Cp].
//       wn_any_rs_kernel<last, partial> - a unit is 128 rows x a pass of
//         128 channels: rs = acts @ w_rs at the residual's 128 columns and
//         the skip's 128 of the same channels (the last layer: its 128 skip
//         columns), Gp deep; the epilogue stages the f32 sums in the
//         ring's shared memory and streams the pass's x, skip-sum and
//         output rows in 16-byte pieces, a batch of loads in flight (from
//         the accumulators' fragments, 8-byte pieces of 8 rows a warp,
//         it took twice the time); it adds b_rs, the residual and the skip
//         sum in f32, masks rows >= valid_t, writes rows < B*T only. In
//         partial mode it stores the staged sums as they are.
//     The two product kernels stream 64-deep K chunks (A [128 rows][64]
//     K-major, B [64][at most 256] MN-major, both in the 128-byte swizzle of
//     sm90_wgmma.cuh) through a 4-stage cp.async ring, two chunks ahead,
//     with one chunk's wgmmas left in flight across each barrier
//     (wgmma_wait<1>). Each is one wave of persistent blocks (one an SM,
//     no more than units) walking units blockIdx + k * gridDim; the passes
//     of a tile are neighbours, so its taps and acts are read from L2
//     while the other passes still hold them. cond (gate) and x and the
//     skip sum (epilogue) are prefetched into L2 under the products.
// No atomics, no split K: each output's sums run in one fixed order that
// depends on neither B, T nor where a row falls in a tile, so two launches
// give the same bits and a window of a stream gives its rows' bits.
//
// Neither design holds the acts in shared memory, so neither caps C; the
// wrapper keeps the caps of the first design (kernels/wn_layer.py's
// ANY_MAX_C: 704 in f32, 1,280 in bf16), the set of widths it has been held
// to. PERF.md keeps the times (chip_smoke.py phase 16, fwd_compare.py
// --any); wn_layer_any_kernel_info reports each kernel's registers, spills
// and shared memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <type_traits>

#include "f32_ring.cuh"
#include "sm90_wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxCF32 = 704;    // the wrapper's caps (ANY_MAX_C)
constexpr int kMaxCBf16 = 1280;
constexpr int kPass = 128;       // channels of a pass, both designs

__host__ __device__ __forceinline__ int pad64(int c) {
  return (c + 63) / 64 * 64;
}

// n / d for 0 <= n < 2^31 by a multiply and a shift (the round-up method
// of Granlund and Montgomery): m = floor(2^(31 + l) / d) + 1, l =
// ceil(log2 d), made on the host. The product kernels divide by run-time
// sizes (C, K, T) on every K chunk; a division by a run-time int is some
// twenty instructions, and the f32 kernel's three a chunk cost 8% of its
// time.
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

// What every kernel of a call reads, as one parameter in the constant bank
// (the derived sizes too, so a kernel spends no register on them).
struct AnyArgs {
  const float* x;        // [R, C] f32: the residual
  const void* x_src;     // the taps' rows, Cp apart: x_p, or x (f32, C = Cp)
  const void* cond;      // [R, 2G]
  const void* w_in;      // [K*Cp, 2Gp]: w_in_p, or w_in when C = Cp, G = Gp
  const float* b_in;     // [2G]
  const void* w_rs;      // [Gp, n_rsp]: w_rs_p, or w_rs likewise
  const float* b_rs;     // [n_rs]
  const int* valid_t;    // [B] or null
  float* x_out;          // [R, C]
  float* skip_out;       // [R, C]
  float* part;           // [R, n_rs]: a rank's partial (partial mode)
  void* acts;            // [R, Gp] scratch (bf16 or f32)
  int accumulate, T, C, G, K, dilation;
  int rows;              // R = B*T
  int cp, gp;            // Cp, Gp
  int passes;            // res/skip passes: ceil(Cp / kPass) (f32 at Gp =
                         // 64: Cp / 64)
  int gate_passes;       // ceil(Gp / kPass)
  int rows_per_block;    // f32: a block's flat rows
  // divisors: T; the res/skip and gate passes; bf16: the 64-deep chunks of
  // a tap; f32: the 16-deep chunks of a tap, of a res/skip pass, of a gate
  // pass and of a tile
  FastDiv div_t, div_passes, div_gate_passes, div_tap64, div_tap16,
      div_acts16, div_gate, div_tile;
};

__device__ __forceinline__ float sigmoidf(float v) {
  return 1.f / (1.f + expf(-v));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo at the lower address
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// ---- prep: the operands into their padded layouts ---------------------------

// One launch: blocks [0, w_rows) each pad one weight row (rows [0, K*Cp) of
// w_in_p, then rows [0, Gp) of w_rs_p; w_rows = 0 where C = Cp, G = Gp and
// the weights are read as they are); the others walk the channel pairs of x
// (C even keeps a pair's 8 bytes aligned) into x_p [R, Cp], rounded to bf16
// (kBf16) or as they are, zero past C. W is the weights' and x_p's type.
template <bool kBf16>
__global__ void __launch_bounds__(256)
wn_any_prep_kernel(const float* __restrict__ x, void* x_p,
                   const void* w_in, const void* w_rs, void* w_in_p,
                   void* w_rs_p, int64_t rows, int C, int G, int K, int last,
                   int w_rows) {
  using W = std::conditional_t<kBf16, bf16, float>;
  const int cp = pad64(C), gp = pad64(G);
  if (static_cast<int>(blockIdx.x) < w_rows) {
    const int n_rs = last ? C : 2 * C, n_rsp = last ? cp : 2 * cp;
    const int row = blockIdx.x;
    const W* src;
    W* dst;
    // the source row ci of its ci_n, its column halves h_n wide of which
    // co_n are real
    int ci, ci_n, h_n, co_n, width;
    if (row < K * cp) {
      const int tap = row / cp;
      ci = row % cp;
      src = static_cast<const W*>(w_in) +
            static_cast<int64_t>(tap * C + ci) * 2 * G;
      dst = static_cast<W*>(w_in_p) + static_cast<int64_t>(row) * 2 * gp;
      ci_n = C, h_n = gp, co_n = G, width = 2 * gp;
    } else {
      ci = row - K * cp;
      src = static_cast<const W*>(w_rs) + static_cast<int64_t>(ci) * n_rs;
      dst = static_cast<W*>(w_rs_p) + static_cast<int64_t>(ci) * n_rsp;
      ci_n = G, h_n = cp, co_n = C, width = n_rsp;
    }
    for (int col = threadIdx.x; col < width; col += blockDim.x) {
      const int h = col / h_n, co = col % h_n;
      W v;
      if constexpr (kBf16) v = __float2bfloat16(0.f);
      else v = 0.f;
      if (ci < ci_n && co < co_n) v = src[h * co_n + co];
      dst[col] = v;
    }
    return;
  }
  const int pairs = cp / 2;
  const int64_t n = rows * pairs;
  const int64_t stride =
      static_cast<int64_t>(gridDim.x - w_rows) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x - w_rows) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const int64_t r = i / pairs;
    const int c = 2 * static_cast<int>(i - r * pairs);
    float2 v = make_float2(0.f, 0.f);
    if (c < C) v = *reinterpret_cast<const float2*>(x + r * C + c);
    if constexpr (kBf16)
      *reinterpret_cast<uint32_t*>(static_cast<bf16*>(x_p) + r * cp + c) =
          pack_bf16(v.x, v.y);
    else
      *reinterpret_cast<float2*>(static_cast<float*>(x_p) + r * cp + c) = v;
  }
}

// ---- f32 (parity mode) ------------------------------------------------------

// Tile 96 rows (6 pairs of 16 rows) x a pass of 128 channels (2 warps
// across), wn_layer.cu's f32 layout at C = 512. Ring slot: the chunk's taps
// or acts [96][16], then kRestPasses blocks of weight rows [16][256] (a
// pass's tanh | sigmoid, residual | skip columns; the last layer's 128 skip
// columns in the first half), the second used by a rest tile alone.
//
// A block's share of the rows is a multiple of 16 that is not one of 96
// (208 at B=1, T=26,432: two tiles, then 16 rows), and a last tile of 16
// rows or fewer busies one pair of warps in 6: run pass by pass, it cost
// half a 96-row tile. So at P = 2 passes such a "rest tile" runs both
// passes at once, pair j on pass j of the same 16 rows: 4 warps work, and
// the tile takes one pass's chunks, each with both passes' weight rows.
// The sums of a row run in the same order either way. (A rank's instance
// has no rest tile: its gate and res/skip product have two passes each
// only at C' = C.) At Gp = 64 a gate pass is 64 channels and the second
// column of warps would have none: it takes 96 more rows instead, a tile of
// 192 rows, and the res/skip product runs in passes of 64 output channels
// (Cp / 64 of them).
struct AnyF32 {
  static constexpr int kRowPairs = 6;
  static constexpr int kTileRows = 16 * kRowPairs;
  static constexpr int kColWarps = kPass / 64;
  static constexpr int kThreads = 32 * kColWarps * kRowPairs;  // 384
  static constexpr int kChunk = 16;                            // K rows
  static constexpr int kStages = 4;
  static constexpr int kAhead = kStages - 1;
  static constexpr int kTapFloats = 2 * kTileRows * kChunk;  // Cp = 64
  static constexpr int kWLd = 2 * kPass;  // floats a weight row of a slot
  static constexpr int kWFloats = kChunk * kWLd;  // a pass's weight rows
  static constexpr int kRestPasses = 2;   // passes a rest tile runs at once
  static constexpr int kRestRows = 16;    // rows a rest tile holds at most
  static constexpr int kSlotFloats = kTapFloats + kRestPasses * kWFloats;
  static constexpr int kSmem = 4 * kStages * kSlotFloats;  // 180,224
  static constexpr int kRowQuantum = 16;
  static_assert(kTileRows * kChunk / 4 == kThreads,
                "one tap piece a thread and 96 rows (two at Cp = 64)");
  static_assert(kRestPasses <= kRowPairs, "a pair of warps a pass");
  static_assert(kSmem <= 232448, "over the 227 KB a block may use");
};

// cp.async 16 K rows of an f32 weight (rows `ld` floats apart from `src`)
// into a slot's weight rows: columns [a, a + 128) then (kPaired) [b, b +
// 128) of each, zero where a column's offset in its half is at or past
// `lim` (the channels past Cp in a pass of 64).
template <bool kPaired>
__device__ __forceinline__ void f32_copy_w(uint32_t wslot, const float* src,
                                           int64_t ld, int a, int b,
                                           int lim) {
  using L = AnyF32;
  constexpr int kPer = (kPaired ? 2 : 1) * kPass / 4;  // pieces a K row
  constexpr int kPieces = L::kChunk * kPer;
#pragma unroll
  for (int i = 0; i < (kPieces + L::kThreads - 1) / L::kThreads; ++i) {
    const int p = threadIdx.x + i * L::kThreads;
    if (kPieces % L::kThreads == 0 || p < kPieces) {
      const int k = p / kPer, n = (p % kPer) * 4;
      const int h = n / kPass, off = n % kPass;
      const bool ok = off < lim;
      cp_async16_zfill(wslot + (k * L::kWLd + n) * 4,
                       ok ? src + k * ld + (h ? b : a) + off : src, ok);
    }
  }
}

// Up to 4 floats from `src` (n of them valid, the rest zero): one 16-byte
// load when `vec` (src 16-byte aligned) and all 4 are valid, else pairs (8
// bytes; C even keeps a pair aligned and whole), or single values where
// `pairs` is false (a rank's odd G: its pairs are neither).
__device__ __forceinline__ void load4_upto(float (&d)[4], const float* src,
                                           int n, bool vec,
                                           bool pairs = true) {
  if (vec && n >= 4) {
    load4(d, src);
    return;
  }
  if (!pairs) {
#pragma unroll
    for (int j = 0; j < 4; ++j) d[j] = j < n ? src[j] : 0.f;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; j += 2) {
    const float2 v = j < n ? *reinterpret_cast<const float2*>(src + j)
                           : make_float2(0.f, 0.f);
    d[j] = v.x;
    d[j + 1] = v.y;
  }
}

__device__ __forceinline__ void store4_upto(float* dst, const float (&v)[4],
                                            int n, bool vec) {
  if (vec && n >= 4) {
    store4(dst, v);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; j += 2)
    if (j < n)
      *reinterpret_cast<float2*>(dst + j) = make_float2(v[j], v[j + 1]);
}

// Prefetch into L2 the lines of `n` values (n >= 1) from `src`: its first,
// every 32nd and its last value.
__device__ __forceinline__ void prefetch_span(const float* src, int n, int i) {
  prefetch_l2(src + min(32 * i, n - 1));
}

// kTwo: the instance for Gp = 64, its tiles 192 rows (AnyF32's note);
// kPartial: a rank's share, its epilogue the partial alone.
template <bool kTwo, bool kLast, bool kPartial>
__global__ void __launch_bounds__(AnyF32::kThreads, 1)
wn_any_kernel_f32(const __grid_constant__ AnyArgs a) {
  using L = AnyF32;
  // channels of a res/skip pass: 64 at Gp = 64, where a column of warps
  // takes rows, not channels
  constexpr int kPW = kTwo ? 64 : kPass;
  const float* __restrict__ x_src = static_cast<const float*>(a.x_src);
  const float* __restrict__ cond = static_cast<const float*>(a.cond);
  const float* __restrict__ w_in = static_cast<const float*>(a.w_in);
  const float* __restrict__ w_rs = static_cast<const float*>(a.w_rs);
  float* acts_g = static_cast<float*>(a.acts);
  // The whole layer's instances take G = C, Gp = Cp and one count of
  // passes for both products (at Gp = 64 also Cp = 64: one pass), so their
  // code holds one of each; a rank's reads both.
  const int C = a.C;
  const int G = kPartial ? a.G : C;
  const int cp = kTwo && !kPartial ? 64 : a.cp;
  const int gp = kTwo ? 64 : kPartial ? a.gp : cp;
  const int P = kTwo && !kPartial ? 1 : a.passes;  // res/skip passes of kPW
  const int PG = kTwo ? 1 : kPartial ? a.gate_passes : P;  // gate passes
  // K chunks of a tap: Cp / 16; of a res/skip pass: Gp / 16. A rank's
  // widths apart from the whole layer's (Gp, G, its gate passes and these
  // chunks) are read from the parameter where they are used: held in
  // registers across the FMA loops, they spilled.
  const int cpc = kTwo && !kPartial ? 4 : a.div_tap16.d;
  const auto gpc = [&] {
    return kTwo ? 4 : kPartial ? a.div_acts16.d : cpc;
  };
  const FastDiv& div_acts16 = kPartial ? a.div_acts16 : a.div_tap16;
  const int nin = a.div_gate.d;           // a gate pass's chunks: K cpc
  const int in_chunks = PG * nin;
  const int tile_chunks = a.div_tile.d;   // in_chunks + P gpc
  const int n_rsp = kLast ? cp : 2 * cp;

  const int row_begin = blockIdx.x * a.rows_per_block;
  const int row_end = min(a.rows, row_begin + a.rows_per_block);
  if (row_begin >= row_end) return;
  // the rows of a tile: 192 at Gp = 64 (a column of warps each), else 96
  constexpr int tile_h = kTwo ? 2 * L::kTileRows : L::kTileRows;
  const int n_tiles = (row_end - row_begin + tile_h - 1) / tile_h;
  // a last tile of kRestRows rows or fewer runs its passes at once (the
  // whole layer's: a rank's gate and res/skip product have two passes each
  // only at C' = C)
  const bool rest = !kTwo && !kPartial && P == L::kRestPasses &&
                    row_end - row_begin - (n_tiles - 1) * tile_h <=
                        L::kRestRows;
  const int full_end = (n_tiles - rest) * tile_chunks;  // full tiles' chunks
  const int n_chunks = full_end + (rest ? nin + gpc() : 0);

  extern __shared__ float4 smem_any_f32[];
  float* smem = reinterpret_cast<float*>(smem_any_f32);
  const uint32_t ring = smem_u32(smem);

  // Warp w: rows [16 (w / 2), +16) of the tile and channels [64 (w % 2),
  // +64) of each half of a pass; lane l: rows 16 (w / 2) + 2i + l / 16 and
  // channels c0..c0+3, c0 = 64 (w % 2) + 4 (l % 16) (wn_layer.cu's layout).
  // At Gp = 64, warp w takes channels [0, 64) of rows 96 (w % 2) + 16 (w /
  // 2) + ...; in a rest tile, pair j takes pass j of rows 2i + l / 16.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int pair = warp / L::kColWarps;
  const int cw = kTwo ? 0 : 64 * (warp % L::kColWarps);
  const int c0 = cw + 4 * (lane % 16);
  const int row16 = 16 * pair + (kTwo ? L::kTileRows * (warp % 2) : 0);
  // this thread's tap / acts piece: tile row ra, 16-byte piece q
  const int ra = threadIdx.x / 4, q = threadIdx.x % 4;

  int tap_t[2] = {0, 0};  // the times of this thread's tap rows
  const auto load_chunk = [&](int chunk) {
    // (a rank's instance has no rest tile)
    const bool rest_chunk = !kPartial && chunk >= full_end;
    const int tile = rest_chunk ? n_tiles - 1 : div_by(chunk, a.div_tile);
    const int local = chunk - tile * tile_chunks;
    const uint32_t slot = ring + (chunk % L::kStages) * L::kSlotFloats * 4;
    const uint32_t wslot = slot + L::kTapFloats * 4;
    const int row = row_begin + tile * tile_h + ra;  // flat row
    if (local == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row + h * L::kTileRows;
        tap_t[h] = r < row_end && (h == 0 || kTwo)
                       ? r - div_by(r, a.div_t) * a.T
                       : INT32_MIN / 2;
      }
    }
    // the passes whose weight rows the chunk holds: [p0, p0 + np)
    const int np = rest_chunk ? L::kRestPasses : 1;
    if (local < (rest_chunk ? nin
                            : kPartial ? a.gate_passes * a.div_gate.d
                                       : in_chunks)) {
      const int p0 = rest_chunk ? 0 : div_by(local, a.div_gate);
      const int kc = local - p0 * nin;
      const int tap = div_by(kc, a.div_tap16);
      const int ch = (kc - tap * cpc) * L::kChunk;
      const int64_t off = static_cast<int64_t>(tap - a.K / 2) * a.dilation;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h == 1 && !kTwo) break;
        const int64_t t = tap_t[h] + off;
        const bool ok = t >= 0 && t < a.T;
        const int r = ra + h * L::kTileRows;
        cp_async16_zfill(slot + (r * L::kChunk + q * 4) * 4,
                         ok ? x_src + (row - ra + r + off) * cp + ch + q * 4
                            : x_src,
                         ok);
      }
      const int gw = kPartial && !kTwo ? a.gp : gp;  // Gp
      const float* src = w_in + static_cast<int64_t>(tap * cp + ch) * 2 * gw;
      for (int p = p0; p < p0 + np; ++p)
        f32_copy_w<true>(wslot + (p - p0) * L::kWFloats * 4, src, 2 * gw,
                         p * kPass, gw + p * kPass, gw - p * kPass);
    } else {
      const int j = local - (rest_chunk ? nin
                             : kPartial ? a.gate_passes * a.div_gate.d
                                        : in_chunks);
      const int p0 = rest_chunk ? 0 : div_by(j, div_acts16);
      const int k0 = (j - p0 * gpc()) * L::kChunk;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h == 1 && !kTwo) break;
        const int r = ra + h * L::kTileRows;
        const bool ok = row - ra + r < row_end;
        cp_async16_zfill(slot + (r * L::kChunk + q * 4) * 4,
                         ok ? acts_g + static_cast<int64_t>(row - ra + r) * gp +
                                  k0 + q * 4
                            : acts_g,
                         ok);
      }
      const float* src = w_rs + static_cast<int64_t>(k0) * n_rsp;
      for (int p = p0; p < p0 + np; ++p)
        f32_copy_w<!kLast>(wslot + (p - p0) * L::kWFloats * 4, src, n_rsp,
                           p * kPW, cp + p * kPW,
                           kTwo ? kPW : cp - p * kPW);
    }
  };
  ring_prologue<L::kAhead>(n_chunks, load_chunk);

  const bool vec = C % 4 == 0;  // rows of x and of the partial
  float acc_a[8][4];  // tanh, then residual (last: skip)
  float acc_b[8][4];  // sigmoid, then skip
#pragma unroll 1
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int chunk0 = tile * tile_chunks;
    const int t0 = row_begin + tile * tile_h;
    const int tile_rows = min(tile_h, row_end - t0);
    const bool rest_tile = rest && tile == n_tiles - 1;
    // passes run one after another: PG then P, or one (all at once) in a
    // rest tile
    const int gseq = rest_tile ? 1 : PG, rseq = rest_tile ? 1 : P;
    // this thread's first row and its passes' weight block in a slot
    const int r0 = (rest_tile ? 0 : row16) + lane / 16;
    const int w_off = rest_tile ? pair * L::kWFloats : 0;
    const bool rows_busy =
        rest_tile ? pair < L::kRestPasses : row16 < tile_rows;
    // One gate pass in a row: the res/skip product's first chunks read
    // acts that the pass's last steps write, so the ring loads nothing past
    // the gate until then. (With more gate passes they are the first
    // pass's channels, written a pass earlier. A tile's gate is at least
    // K*64/16 = 4 chunks, more than the ring runs ahead, so the loads that
    // run on into the next tile stop short of its res/skip chunks.)
    const int gate_end = chunk0 + gseq * nin;
    const int gate_limit = gseq == 1 ? gate_end : n_chunks;
    // the lines of a step's columns prefetched, a row and half
    const int pf_lines = (rest_tile ? L::kRestPasses * kPass : kPass) / 32 + 1;

    // ---- gate product and gate, pass by pass --------------------------------
#pragma unroll 1
    for (int s = 0; s < gseq; ++s) {
      const int p = rest_tile ? pair : s;  // this thread's pass
      const int ch = p * kPass + c0;       // this thread's channels of it
      const bool busy = rows_busy && p * kPass + cw < gp;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc_a[i][j] = acc_b[i][j] = 0.f;
#pragma unroll 1
      for (int kc = 0; kc < nin; ++kc) {
        const int chunk = chunk0 + s * nin + kc;
        ring_step<L::kAhead>(chunk, gate_limit, load_chunk);
        if (kc == max(nin - 16, 0)) {
          // the step's cond columns of the tile's rows into L2
          const int c_lo = rest_tile ? 0 : s * kPass;
          const int gw = kPartial ? a.G : C;  // G
          const int n = rest_tile ? min(L::kRestPasses * kPass, gw)
                                  : min(kPass, gw - c_lo);
          for (int i = threadIdx.x; i < tile_rows * 2 * pf_lines;
               i += L::kThreads) {
            const int r = i / (2 * pf_lines), h = i / pf_lines % 2;
            prefetch_span(cond + static_cast<int64_t>(t0 + r) * 2 * gw +
                              h * gw + c_lo, n, i % pf_lines);
          }
        }
        if (busy) {
          const float* slot = smem + (chunk % L::kStages) * L::kSlotFloats;
#pragma unroll
          for (int kk = 0; kk < L::kChunk; kk += 4)
            tile_fma4<8, 2, L::kChunk, L::kWLd, kPass, true>(
                acc_a, acc_b, slot + r0 * L::kChunk,
                slot + L::kTapFloats + w_off + c0, kk);
        }
      }
      // the gate (f32) on the accumulators; the acts to the scratch, zero
      // past G
      if (busy) {
        // a rank's cond and b_in halves: 16-byte pieces of the tanh half
        // where its rows are 16-byte aligned, of the sigmoid half where G %
        // 4 == 0; pairs where G is even, else single values (the whole
        // layer's: C even)
        const bool vec_t = !kPartial || a.G % 2 == 0;
        const bool vec_s = kPartial ? a.G % 4 == 0 : vec;
        const bool pairs = !kPartial || a.G % 2 == 0;
        float bt[4], bs[4];
        load4_upto(bt, a.b_in + ch, G - ch, true, pairs);
        load4_upto(bs, a.b_in + G + ch, G - ch, vec_s, pairs);
#pragma unroll
        for (int i0 = 0; i0 < 8; i0 += 2) {
          float ct[2][4], cs[2][4];  // 2 rows' loads in flight
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r0 + 2 * (i0 + h);
            const int n = r < tile_rows ? G - ch : 0;
            const float* crow = cond + static_cast<int64_t>(t0 + r) * 2 * G;
            load4_upto(ct[h], crow + ch, n, vec_t, pairs);
            load4_upto(cs[h], crow + G + ch, n, vec_s, pairs);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r0 + 2 * (i0 + h);
            float out[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float gt = acc_a[i0 + h][j] + bt[j] + ct[h][j];
              const float gs = acc_b[i0 + h][j] + bs[j] + cs[h][j];
              out[j] = ch + j < G ? tanhf(gt) * sigmoidf(gs) : 0.f;
            }
            if (r < tile_rows)
              store4(acts_g + static_cast<int64_t>(t0 + r) * gp + ch, out);
          }
        }
      }
      // the ring's cp.async.cg reads the acts from L2: this thread's
      // stores reach it before the barriers that order those reads
      __threadfence();
    }
    if (gseq == 1) {
      // the res/skip product's first chunks, whose acts the gate has just
      // written, load now (each a commit group, as the steps' loads)
      __syncthreads();
      for (int c = gate_end; c < gate_end + L::kAhead; ++c) {
        if (c < n_chunks) load_chunk(c);
        cp_async_commit();
      }
    }

    // ---- res/skip product and epilogue, pass by pass ------------------------
#pragma unroll 1
    for (int s = 0; s < rseq; ++s) {
      const int p = rest_tile ? pair : s;
      const int ch = p * kPW + c0;
      const int n_ch = C - ch;  // this thread's channels below C (<= 0: none)
      const bool busy = rows_busy && p * kPW + cw < cp;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc_a[i][j] = acc_b[i][j] = 0.f;
#pragma unroll 1
      for (int kc = 0; kc < gpc(); ++kc) {
        const int chunk = gate_end + s * gpc() + kc;
        ring_step<L::kAhead>(chunk, n_chunks, load_chunk);
        if (!kPartial && kc == max(gpc() - 8, 0)) {
          // the step's columns of the x rows and the skip sum into L2
          const int c_lo = rest_tile ? 0 : s * kPW;
          const int n = rest_tile ? min(L::kRestPasses * kPass, C)
                                  : min(kPW, C - c_lo);
          for (int i = threadIdx.x; i < tile_rows * pf_lines;
               i += L::kThreads) {
            const int64_t off =
                static_cast<int64_t>(t0 + i / pf_lines) * C + c_lo;
            prefetch_span(a.x + off, n, i % pf_lines);
            if (a.accumulate)
              prefetch_span(a.skip_out + off, n, i % pf_lines);
          }
        }
        if (busy) {
          const float* slot = smem + (chunk % L::kStages) * L::kSlotFloats;
#pragma unroll
          for (int kk = 0; kk < L::kChunk; kk += 4)
            tile_fma4<8, 2, L::kChunk, L::kWLd, kPass, !kLast>(
                acc_a, acc_b, slot + r0 * L::kChunk,
                slot + L::kTapFloats + w_off + c0, kk);
        }
      }
      if (!busy || n_ch <= 0) continue;
      if constexpr (kPartial) {
        // ---- a rank's partial: the sums as they are (f32)
        const int n_rs = kLast ? C : 2 * C;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = r0 + 2 * i;
          if (r >= tile_rows) continue;
          const int64_t off = static_cast<int64_t>(t0 + r) * n_rs + ch;
          store4_upto(a.part + off, acc_a[i], n_ch, vec);
          if constexpr (!kLast) store4_upto(a.part + off + C, acc_b[i], n_ch,
                                            vec);
        }
      } else {
        // ---- epilogue: residual, valid_t mask, skip accumulation (f32)
        float br[4], bk[4];
        load4_upto(br, a.b_rs + ch, n_ch, true);
        if constexpr (!kLast) load4_upto(bk, a.b_rs + C + ch, n_ch, vec);
#pragma unroll
        for (int i0 = 0; i0 < 8; i0 += 2) {
          float xv[2][4], prev[2][4];  // 2 rows' loads in flight
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r0 + 2 * (i0 + h);
            const int n = r < tile_rows ? n_ch : 0;
            const int64_t off = static_cast<int64_t>(t0 + r) * C + ch;
            load4_upto(xv[h], a.x + off, n, vec);
            load4_upto(prev[h], a.skip_out + off, a.accumulate ? n : 0, vec);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = i0 + h;
            const int r = r0 + 2 * i;
            if (r >= tile_rows) continue;
            const int row = t0 + r;
            const int b = div_by(row, a.div_t);
            const int valid = a.valid_t != nullptr ? a.valid_t[b] : a.T;
            const bool keep = row - b * a.T < valid;
            float skip[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if constexpr (kLast) {
                skip[j] = acc_a[i][j] + br[j];
              } else {
                xv[h][j] += acc_a[i][j] + br[j];
                skip[j] = acc_b[i][j] + bk[j];
              }
              if (!keep) xv[h][j] = 0.f;
              if (a.accumulate) skip[j] += prev[h][j];
            }
            const int64_t off = static_cast<int64_t>(row) * C + ch;
            store4_upto(a.x_out + off, xv[h], n_ch, vec);
            store4_upto(a.skip_out + off, skip, n_ch, vec);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

// ---- bf16 (fast mode), wgmma ------------------------------------------------

// The ring of the gate and res/skip kernels: two warpgroups, 64 rows each,
// hold a unit's 128 rows; a stage is one 64-deep K chunk: A [128 rows][64
// K] K-major, then B [64 K][at most 256 N] MN-major in 64-column blocks.
struct AnyWide {
  static constexpr int kThreads = 256;
  static constexpr int kTile = 128;                   // rows of a unit
  static constexpr int kKC = 64;                      // K of a chunk
  static constexpr int kABytes = kTile * 128;         // 16,384
  static constexpr int kNBlock = 64 * 128;            // [64 K][64 N]: 8,192
  static constexpr int kStageBytes = kABytes + 4 * kNBlock;  // 49,152
  static constexpr int kStages = 4;
  static constexpr int kAhead = kStages - 2;          // chunks in flight
  static constexpr int kSmem = kStages * kStageBytes;  // 196,608
  static_assert(kSmem <= 232448, "over the 227 KB a block may use");
};

// A unit's product: n K chunks through the ring, `load(stage, j)` starting
// this thread's copies of chunk j (no commit) kAhead steps ahead of its
// wgmmas; acc_a += A @ B[:, 0:kN) and (kPaired) acc_b += A @ B[:, kN:2kN)
// over the warpgroup's 64 rows. Past each step's barrier every warpgroup
// has waited for the wgmmas of chunk j - 2, whose stage takes chunk j + 2.
// Returns with every wgmma and copy of the unit done.
template <int kN, bool kPaired, typename Load>
__device__ __forceinline__ void any_products(uint32_t ring, int n,
                                             float (&acc_a)[kN / 2],
                                             float (&acc_b)[kN / 2],
                                             const Load& load) {
  using L = AnyWide;
  const uint32_t a_wg = (threadIdx.x / 128) * (L::kABytes / 2);
  for (int c = 0; c < L::kAhead; ++c) {
    if (c < n) load(ring + c * L::kStageBytes, c);
    cp_async_commit();
  }
#pragma unroll 1
  for (int j = 0; j < n; ++j) {
    cp_async_wait<L::kAhead - 1>();
    fence_proxy_async();
    __syncthreads();
    if (j + L::kAhead < n)
      load(ring + ((j + L::kAhead) % L::kStages) * L::kStageBytes,
           j + L::kAhead);
    cp_async_commit();
    const uint32_t st = ring + (j % L::kStages) * L::kStageBytes;
    fence_acc(acc_a);
    if constexpr (kPaired) fence_acc(acc_b);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < L::kKC / 16; ++k) {
      const uint64_t da = kmajor_desc(st + a_wg + k * 32);
      wgmma_m64<kN, 0, 1>(
          acc_a, da, mnmajor_desc(st + L::kABytes + k * 2048, L::kNBlock));
      if constexpr (kPaired)
        wgmma_m64<kN, 0, 1>(
            acc_b, da,
            mnmajor_desc(st + L::kABytes + kN / 64 * L::kNBlock + k * 2048,
                         L::kNBlock));
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(acc_a);
    if constexpr (kPaired) fence_acc(acc_b);
  }
  wgmma_wait<0>();
  fence_acc(acc_a);
  if constexpr (kPaired) fence_acc(acc_b);
  cp_async_wait<0>();
}

// cp.async 64 K rows of a bf16 weight (rows `ld` values apart from `src`)
// into the stage's B: kN columns from column a and (kPaired) kN from column
// b of each row, zero where a column's offset in its half is at or past
// `lim` (the channels past Cp in a pass of 64).
template <int kN, bool kPaired>
__device__ __forceinline__ void any_load_b(uint32_t stage, const bf16* src,
                                           int64_t ld, int a, int b,
                                           int lim) {
  using L = AnyWide;
  constexpr int kPer = (kPaired ? 2 : 1) * kN / 8;  // 16-byte pieces a K row
#pragma unroll
  for (int i = 0; i < L::kKC * kPer / L::kThreads; ++i) {
    const int p = threadIdx.x + i * L::kThreads;
    const int k = p / kPer, n = (p % kPer) * 8;
    const int h = n / kN, off = n % kN;
    const bool ok = off < lim;
    cp_async16_zfill(
        stage + L::kABytes + (n / 64) * L::kNBlock + sw128_piece(k, n % 64 / 8),
        ok ? src + k * ld + (h ? b : a) + off : src, ok);
  }
}

// cp.async a unit's A chunk: row r (this thread's rows tid / 8 + 32i, piece
// q = tid % 8) is `src` + off[i] when ok[i], else zero.
__device__ __forceinline__ void any_load_a(uint32_t stage, const bf16* src,
                                           const int64_t (&off)[4],
                                           const bool (&ok)[4]) {
  const int q = threadIdx.x % 8;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    cp_async16_zfill(stage + sw128_piece(threadIdx.x / 8 + 32 * i, q),
                     src + (ok[i] ? off[i] + q * 8 : 0), ok[i]);
}

// A unit's accumulators staged in shared memory (the ring's bytes, free
// once every warpgroup's wgmmas are done), f32 rows kStageLd apart: acc_a
// as [128 rows][128] from `st`, then (kPaired) acc_b as the next [128][128].
// Element 4j + 2h + e of a thread is row 16 warp + g + 8h, column 8j + 2tig
// + e. kStageLd = 136 puts the 8-byte stores of a half warp in distinct
// banks.
constexpr int kStageLd = kPass + 8;
static_assert(2 * AnyWide::kTile * kStageLd * 4 <= AnyWide::kSmem,
              "the staged sums fit in the ring");

template <bool kPaired>
__device__ __forceinline__ void stage_acc(float* st,
                                          const float (&acc_a)[kPass / 2],
                                          const float (&acc_b)[kPass / 2]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
#pragma unroll
  for (int j = 0; j < kPass / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int off = (warp * 16 + g + 8 * h) * kStageLd + 8 * j + 2 * tig;
      *reinterpret_cast<float2*>(st + off) =
          make_float2(acc_a[4 * j + 2 * h], acc_a[4 * j + 2 * h + 1]);
      if constexpr (kPaired)
        *reinterpret_cast<float2*>(st + AnyWide::kTile * kStageLd + off) =
            make_float2(acc_b[4 * j + 2 * h], acc_b[4 * j + 2 * h + 1]);
    }
}

// A pair of bf16 values from `p` as one word: one 4-byte load where
// `aligned`, else two loads (a rank's odd G), the second zero unless
// `second`.
__device__ __forceinline__ uint32_t load_bf16_pair(const bf16* p, bool aligned,
                                                   bool second) {
  if (aligned) return *reinterpret_cast<const uint32_t*>(p);
  const uint32_t lo = *reinterpret_cast<const uint16_t*>(p);
  const uint32_t hi = second ? *reinterpret_cast<const uint16_t*>(p + 1) : 0u;
  return lo | hi << 16;
}

__device__ __forceinline__ float2 load_f32_pair(const float* p, bool aligned,
                                                bool second) {
  if (aligned) return *reinterpret_cast<const float2*>(p);
  return make_float2(p[0], second ? p[1] : 0.f);
}

// The gate: unit u = (tile u / PG of 128 flat rows, pass u % PG of 128
// gate channels); pre = the K taps of x_p @ w_in at the pass's tanh (acc_a)
// and sigmoid (acc_b) columns, K*Cp deep in (tap, 64-channel) chunks; then
// the gate in f32 (cond [R, 2G], b_in [2G]), the acts rounded to bf16 into
// acts [R, Gp], zero past G. kRank: a rank's instance; the whole layer's
// holds one width (G = C) and one count of passes, its pairs aligned.
template <bool kRank>
__global__ void __launch_bounds__(AnyWide::kThreads, 1)
wn_any_gate_kernel(const __grid_constant__ AnyArgs a) {
  using L = AnyWide;
  const bf16* __restrict__ x_p = static_cast<const bf16*>(a.x_src);
  const bf16* __restrict__ cond = static_cast<const bf16*>(a.cond);
  const bf16* __restrict__ w_in = static_cast<const bf16*>(a.w_in);
  bf16* __restrict__ acts = static_cast<bf16*>(a.acts);
  extern __shared__ __align__(1024) uint4 smem_any_wide[];
  const uint32_t ring = smem_u32(smem_any_wide);
  const int cp = a.cp;
  const int G = kRank ? a.G : a.C, gp = kRank ? a.gp : cp;
  const int P = kRank ? a.gate_passes : a.passes;
  const FastDiv& div_p = kRank ? a.div_gate_passes : a.div_passes;
  const int cpb = a.div_tap64.d;  // chunks of a tap: Cp / 64
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r16 = warp * 16;  // the warp's rows of the unit (both groups)
  const int g = lane / 4, tig = lane % 4;
  const int units = (a.rows + L::kTile - 1) / L::kTile * P;
  const bool pairs = !kRank || G % 2 == 0;  // cond's, b_in's pairs aligned

#pragma unroll 1
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int tile = div_by(u, div_p), p = u - tile * P;
    const int r0 = tile * L::kTile;
    const int rows = min(L::kTile, a.rows - r0);
    const int ch0 = p * kPass;
    // this thread's A rows tid / 8 + 32i: flat row, and time in its
    // sequence (far negative past the last row)
    int64_t fr[4], tt[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = threadIdx.x / 8 + 32 * i;
      fr[i] = r0 + r;
      tt[i] = r < rows ? r0 + r - div_by(r0 + r, a.div_t) * a.T
                       : -(int64_t{1} << 40);
    }
    const auto load = [&](uint32_t stage, int j) {
      const int tap = div_by(j, a.div_tap64);
      const int cb = (j - tap * cpb) * L::kKC;
      const int64_t shift = static_cast<int64_t>(tap - a.K / 2) * a.dilation;
      int64_t off[4];
      bool ok[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int64_t s = tt[i] + shift;
        ok[i] = s >= 0 && s < a.T;
        off[i] = (fr[i] + shift) * cp + cb;
      }
      any_load_a(stage, x_p, off, ok);
      any_load_b<kPass, true>(
          stage, w_in + static_cast<int64_t>(tap * cp + cb) * 2 * gp, 2 * gp,
          ch0, gp + ch0, gp - ch0);
    };
    // cond's rows of the pass's channels (both halves), into L2 under the
    // products: 3 lines a half a row cover its 128 bf16 channels
    {
      const int n = min(kPass, G - ch0);
      for (int i = threadIdx.x; i < rows * 6; i += L::kThreads) {
        const int r = i / 6, h = i / 3 % 2, e = i % 3;
        prefetch_l2(cond + static_cast<int64_t>(r0 + r) * 2 * G + h * G +
                    ch0 + min(64 * e, n - 1));
      }
    }
    float acc_a[kPass / 2], acc_b[kPass / 2];
#pragma unroll
    for (int i = 0; i < kPass / 2; ++i) acc_a[i] = acc_b[i] = 0.f;
    __syncthreads();  // the previous unit is done with the ring
    any_products<kPass, true>(ring, a.K * cpb, acc_a, acc_b, load);

    // ---- the gate (f32) on the accumulators, acts to global as bf16:
    // element 4j + 2h + e is row r16 + g + 8h, channel ch0 + 8j + 2tig + e;
    // cond of kBatch n8 blocks is loaded before any is used
    constexpr int kBatch = 4;
#pragma unroll
    for (int j0 = 0; j0 < kPass / 8; j0 += kBatch) {
      uint32_t cv[kBatch][2][2];  // [n8][h][tanh, sigmoid] bf16 pairs
#pragma unroll
      for (int jj = 0; jj < kBatch; ++jj) {
        const int ch = ch0 + 8 * (j0 + jj) + 2 * tig;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r16 + g + 8 * h;
          const bf16* cr =
              cond + static_cast<int64_t>(r0 + min(row, rows - 1)) * 2 * G + ch;
          // G even (the whole layer's): ch + 1 < G too
          const bool ok = ch < G, ok1 = kRank ? ch + 1 < G : ok;
          cv[jj][h][0] = ok ? load_bf16_pair(cr, pairs, ok1) : 0u;
          cv[jj][h][1] = ok ? load_bf16_pair(cr + G, pairs, ok1) : 0u;
        }
      }
#pragma unroll
      for (int jj = 0; jj < kBatch; ++jj) {
        const int j = j0 + jj;
        const int ch = ch0 + 8 * j + 2 * tig;
        if (ch >= gp) continue;  // a pass of 64: no acts column here
        const bool ok = ch < G, ok1 = kRank ? ch + 1 < G : ok;
        const float2 bt = ok ? load_f32_pair(a.b_in + ch, pairs, ok1)
                             : make_float2(0.f, 0.f);
        const float2 bs = ok ? load_f32_pair(a.b_in + G + ch, pairs, ok1)
                             : make_float2(0.f, 0.f);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r16 + g + 8 * h;
          if (row >= rows) continue;
          const float2 ct = unpack_bf16(cv[jj][h][0]);
          const float2 cs = unpack_bf16(cv[jj][h][1]);
          float v0 = 0.f, v1 = 0.f;
          if (ok)
            v0 = tanhf(acc_a[4 * j + 2 * h] + bt.x + ct.x) *
                 sigmoidf(acc_b[4 * j + 2 * h] + bs.x + cs.x);
          if (ok1)
            v1 = tanhf(acc_a[4 * j + 2 * h + 1] + bt.y + ct.y) *
                 sigmoidf(acc_b[4 * j + 2 * h + 1] + bs.y + cs.y);
          *reinterpret_cast<uint32_t*>(
              acts + static_cast<int64_t>(r0 + row) * gp + ch) =
              pack_bf16(v0, v1);
        }
      }
    }
  }
}

// The res/skip product of acts [R, Gp] and its epilogue: unit u = (tile u
// / P of 128 flat rows, pass u % P of 128 channels), Gp deep. A non-last
// layer's pass p pairs the residual columns [128p, +128) (acc_a) with the
// skip columns [Cp + 128p, +128) (acc_b) of w_rs_p; the last layer's, its
// skip columns [128p, +128) (acc_a alone). Epilogue: x' = x + res + b_rs (x
// on the last layer), zero at rows t >= valid_t[b]; skip = rs + b_rs, plus
// the sum when accumulating; f32, rows < R and channels < C only. A rank's
// (kPartial): the sums alone into its partial [R, n_rs], res then skip.
template <bool kLast, bool kPartial>
__global__ void __launch_bounds__(AnyWide::kThreads, 1)
wn_any_rs_kernel(const __grid_constant__ AnyArgs a) {
  using L = AnyWide;
  const bf16* __restrict__ acts = static_cast<const bf16*>(a.acts);
  const bf16* __restrict__ w_rs = static_cast<const bf16*>(a.w_rs);
  extern __shared__ __align__(1024) uint4 smem_any_wide[];
  const uint32_t ring = smem_u32(smem_any_wide);
  float* const staged = reinterpret_cast<float*>(smem_any_wide);
  const int C = a.C, cp = a.cp, gp = a.gp, P = a.passes;
  const int n_rsp = kLast ? cp : 2 * cp;
  const int units = (a.rows + L::kTile - 1) / L::kTile * P;

#pragma unroll 1
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int tile = div_by(u, a.div_passes), p = u - tile * P;
    const int r0 = tile * L::kTile;
    const int rows = min(L::kTile, a.rows - r0);
    const int ch0 = p * kPass;
    int64_t fr[4];
    bool in[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = threadIdx.x / 8 + 32 * i;
      fr[i] = static_cast<int64_t>(r0 + r) * gp;
      in[i] = r < rows;
    }
    const auto load = [&](uint32_t stage, int j) {
      int64_t off[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) off[i] = fr[i] + j * L::kKC;
      any_load_a(stage, acts, off, in);
      any_load_b<kPass, !kLast>(
          stage, w_rs + static_cast<int64_t>(j) * L::kKC * n_rsp, n_rsp, ch0,
          cp + ch0, cp - ch0);
    };
    // the epilogue's rows of x and of the skip sum, into L2 under the
    // products: 5 lines cover a row's 128 f32 channels of the pass
    if (!kPartial) {
      const int n = min(kPass, C - ch0);
      for (int i = threadIdx.x; i < rows * 5; i += L::kThreads) {
        const int64_t off = static_cast<int64_t>(r0 + i / 5) * C + ch0 +
                            min(32 * (i % 5), n - 1);
        prefetch_l2(a.x + off);
        if (a.accumulate) prefetch_l2(a.skip_out + off);
      }
    }
    float acc_a[kPass / 2], acc_b[kPass / 2];
#pragma unroll
    for (int i = 0; i < kPass / 2; ++i) acc_a[i] = acc_b[i] = 0.f;
    __syncthreads();  // the previous unit is done with the ring
    any_products<kPass, !kLast>(ring, gp / L::kKC, acc_a, acc_b, load);

    // ---- epilogue from the staged sums: residual, valid_t mask, skip sum
    // (f32), 4 channels a piece of the pass's channels below C; kBatch
    // pieces' loads in flight
    __syncthreads();  // every warpgroup's wgmmas are done with the ring
    stage_acc<!kLast>(staged, acc_a, acc_b);
    __syncthreads();
    const bool vec = C % 4 == 0;  // rows of x 16-byte aligned
    const int per_row = (min(kPass, C - ch0) + 3) / 4;
    const int pieces = rows * per_row;
    if constexpr (kPartial) {
      // a rank's partial: the staged sums as they are, res then skip
      const int n_rs = kLast ? C : 2 * C;
#pragma unroll 4
      for (int i = threadIdx.x; i < pieces; i += L::kThreads) {
        const int row = i / per_row, c = 4 * (i - row * per_row);
        const int ch = ch0 + c;
        const float* pa = staged + row * kStageLd + c;
        const float va[4] = {pa[0], pa[1], pa[2], pa[3]};
        const int64_t off = static_cast<int64_t>(r0 + row) * n_rs + ch;
        store4_upto(a.part + off, va, C - ch, vec);
        if constexpr (!kLast) {
          const float* pb = pa + L::kTile * kStageLd;
          const float vb[4] = {pb[0], pb[1], pb[2], pb[3]};
          store4_upto(a.part + off + C, vb, C - ch, vec);
        }
      }
      continue;
    }
    constexpr int kBatch = 4;
#pragma unroll 1
    for (int i0 = threadIdx.x; i0 < pieces; i0 += kBatch * L::kThreads) {
      float xv[kBatch][4], prev[kBatch][4];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = min(i0 + u * L::kThreads, pieces - 1);
        const int row = i / per_row, ch = ch0 + 4 * (i - row * per_row);
        const int64_t off = static_cast<int64_t>(r0 + row) * C + ch;
        load4_upto(xv[u], a.x + off, C - ch, vec);
        load4_upto(prev[u], a.skip_out + off, a.accumulate ? C - ch : 0, vec);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * L::kThreads;
        if (i >= pieces) break;
        const int row = i / per_row, c = 4 * (i - row * per_row);
        const int ch = ch0 + c, nv = C - ch;
        const int f = r0 + row, b = div_by(f, a.div_t);
        const bool keep = a.valid_t == nullptr || f - b * a.T < a.valid_t[b];
        const float* pa = staged + row * kStageLd + c;
        float ba[4], skip[4];
        load4_upto(ba, a.b_rs + ch, nv, true);
        if constexpr (kLast) {
#pragma unroll
          for (int e = 0; e < 4; ++e) skip[e] = pa[e] + ba[e];
        } else {
          const float* pb = pa + L::kTile * kStageLd;
          float bb[4];
          load4_upto(bb, a.b_rs + C + ch, nv, vec);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            xv[u][e] += pa[e] + ba[e];
            skip[e] = pb[e] + bb[e];
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!keep) xv[u][e] = 0.f;
          if (a.accumulate) skip[e] += prev[u][e];
        }
        const int64_t off = static_cast<int64_t>(f) * C + ch;
        store4_upto(a.x_out + off, xv[u], nv, vec);
        store4_upto(a.skip_out + off, skip, nv, vec);
      }
    }
  }
}

// ---- launch -----------------------------------------------------------------

// The kernel `which` of a mode (0: the kernel that ends a call, the f32
// layer kernel (its Gp = 64 instance where `two`) or the bf16 res/skip
// kernel, each in partial mode for a rank; 1: the bf16 gate; 2: the prep),
// its threads and dynamic shared bytes; null for the f32 mode's gate.
struct Instance {
  const void* fn;
  int threads, smem;
};

template <bool kTwo, bool kLast>
const void* f32_instance(int partial) {
  return partial ? reinterpret_cast<const void*>(
                       wn_any_kernel_f32<kTwo, kLast, true>)
                 : reinterpret_cast<const void*>(
                       wn_any_kernel_f32<kTwo, kLast, false>);
}

Instance instance(int bf16_mode, int which, int last, int partial, bool two) {
  if (which == 2)
    return {bf16_mode
                ? reinterpret_cast<const void*>(wn_any_prep_kernel<true>)
                : reinterpret_cast<const void*>(wn_any_prep_kernel<false>),
            256, 0};
  if (!bf16_mode) {
    if (which != 0) return {nullptr, 0, 0};
    const void* fn = two ? (last ? f32_instance<true, true>(partial)
                                 : f32_instance<true, false>(partial))
                         : (last ? f32_instance<false, true>(partial)
                                 : f32_instance<false, false>(partial));
    return {fn, AnyF32::kThreads, AnyF32::kSmem};
  }
  if (which == 1)
    return {partial
                ? reinterpret_cast<const void*>(wn_any_gate_kernel<true>)
                : reinterpret_cast<const void*>(wn_any_gate_kernel<false>),
            AnyWide::kThreads, AnyWide::kSmem};
  const void* fn =
      last ? (partial ? reinterpret_cast<const void*>(
                            wn_any_rs_kernel<true, true>)
                      : reinterpret_cast<const void*>(
                            wn_any_rs_kernel<true, false>))
           : (partial ? reinterpret_cast<const void*>(
                            wn_any_rs_kernel<false, true>)
                      : reinterpret_cast<const void*>(
                            wn_any_rs_kernel<false, false>));
  return {fn, AnyWide::kThreads, AnyWide::kSmem};
}

// Whether an f32 call at gate width G takes the instance with 192-row
// tiles (Gp = 64).
bool two_rows(int G) { return pad64(G) == 64; }

// One occupancy cache and opt-in flag per product kernel instance: (bf16,
// gate or res/skip, partial, last), (f32, Gp = 64 or not, partial, last).
std::atomic<int> g_slots[2 * 2 * 2 * 2][32];
std::atomic<uint32_t> g_opted_in[2 * 2 * 2 * 2];

// Blocks of one wave of instance (bf16_mode, which, last, partial, two) on
// the current device.
cudaError_t slots_of(int bf16_mode, int which, int last, int partial,
                     bool two, int* slots) {
  const Instance k = instance(bf16_mode, which, last, partial, two);
  const bool second = bf16_mode ? which == 1 : two;
  const int id = 8 * (bf16_mode != 0) + 4 * second + 2 * (partial != 0) +
                 (last != 0);
  int sms = 0, per_sm = 0;
  const cudaError_t err = wave_slots(k.fn, k.threads, k.smem, g_slots[id],
                                     &g_opted_in[id], &sms, &per_sm);
  *slots = sms * per_sm;
  return err;
}

// The grid of the kernels of one call at width C and gate width G: in bf16
// the gate's blocks (min(units, slots), units = 128-row tiles x gate
// passes) and the res/skip kernel's (likewise over its passes of the C
// output channels), in f32 the layer kernel's blocks and their rows (one
// wave, an equal share rounded up to 16 rows; gate_blocks the same).
cudaError_t schedule(int bf16_mode, int last, int partial, int64_t rows,
                     int C, int G, int* slots, int* gate_blocks, int* blocks,
                     int* rows_per_block) {
  const bool two = !bf16_mode && two_rows(G);
  cudaError_t err = slots_of(bf16_mode, 0, last, partial, two, slots);
  if (err != cudaSuccess) return err;
  if (bf16_mode) {
    const int64_t tiles = (rows + AnyWide::kTile - 1) / AnyWide::kTile;
    int gate_slots = 0;
    err = slots_of(1, 1, 0, partial, false, &gate_slots);
    if (err != cudaSuccess) return err;
    *slots = std::min(*slots, gate_slots);
    *blocks = static_cast<int>(std::min<int64_t>(
        tiles * ((pad64(C) + kPass - 1) / kPass), *slots));
    *gate_blocks = static_cast<int>(std::min<int64_t>(
        tiles * ((pad64(G) + kPass - 1) / kPass), *slots));
    *rows_per_block = AnyWide::kTile;
    return cudaSuccess;
  }
  *rows_per_block = one_wave_rows(static_cast<int>(rows), *slots,
                                  AnyF32::kRowQuantum);
  *blocks = static_cast<int>((rows + *rows_per_block - 1) / *rows_per_block);
  *gate_blocks = *blocks;
  return cudaSuccess;
}

bool bad_shape(int batch, int T, int C, int G, int K, int dilation,
               int bf16_mode) {
  const int64_t rows = static_cast<int64_t>(batch) * T;
  return T <= 0 || batch <= 0 || rows >= (int64_t{1} << 31) || C <= 0 ||
         C % 2 != 0 || C > (bf16_mode ? kMaxCBf16 : kMaxCF32) || G <= 0 ||
         G > C || K <= 0 || K % 2 != 1 || dilation < 0;
}

// One call: the whole layer (part null) or a rank's share (part set; no
// b_rs, valid_t, accumulation, x_out or skip_out); see the entry points.
cudaError_t launch(const float* x, const void* cond, const void* w_in,
                   const float* b_in, const void* w_rs, const float* b_rs,
                   const int* valid_t, float* x_out, float* skip_out,
                   float* part, void* acts, void* x_p, void* w_in_p,
                   void* w_rs_p, int accumulate, int batch, int T, int C,
                   int G, int K, int dilation, int bf16_mode, int last,
                   cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(batch) * T;
  const int cp = pad64(C), gp = pad64(G);
  const bool pad_x = cp != C, pad_w = pad_x || gp != G;
  const int partial = part != nullptr;
  const bool two = !bf16_mode && two_rows(G);
  if (bad_shape(batch, T, C, G, K, dilation, bf16_mode) || acts == nullptr ||
      ((bf16_mode || pad_x) && x_p == nullptr) ||
      (pad_w && (w_in_p == nullptr || w_rs_p == nullptr)))
    return cudaErrorInvalidValue;
  int slots = 0, gate_blocks = 0, blocks = 0, rows_per_block = 0;
  cudaError_t err = schedule(bf16_mode, last, partial, rows, C, G, &slots,
                             &gate_blocks, &blocks, &rows_per_block);
  if (err != cudaSuccess) return err;

  if (bf16_mode || pad_w) {
    const int w_rows = pad_w ? K * cp + gp : 0;
    const int64_t x_blocks =
        bf16_mode || pad_x
            ? std::min<int64_t>((rows * (cp / 2) + 255) / 256, 4096)
            : 0;
    const unsigned grid = static_cast<unsigned>(w_rows + x_blocks);
    if (bf16_mode)
      wn_any_prep_kernel<true><<<grid, 256, 0, stream>>>(
          x, x_p, w_in, w_rs, w_in_p, w_rs_p, rows, C, G, K, last, w_rows);
    else
      wn_any_prep_kernel<false><<<grid, 256, 0, stream>>>(
          x, x_p, w_in, w_rs, w_in_p, w_rs_p, rows, C, G, K, last, w_rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }

  AnyArgs a;
  a.x = x;
  a.x_src = bf16_mode || pad_x ? x_p : x;
  a.cond = cond;
  a.w_in = pad_w ? w_in_p : w_in;
  a.b_in = b_in;
  a.w_rs = pad_w ? w_rs_p : w_rs;
  a.b_rs = b_rs;
  a.valid_t = valid_t;
  a.x_out = x_out;
  a.skip_out = skip_out;
  a.part = part;
  a.acts = acts;
  a.accumulate = accumulate;
  a.T = T;
  a.C = C;
  a.G = G;
  a.K = K;
  a.dilation = dilation;
  a.rows = static_cast<int>(rows);
  a.cp = cp;
  a.gp = gp;
  a.passes = two ? cp / 64 : (cp + kPass - 1) / kPass;
  a.gate_passes = (gp + kPass - 1) / kPass;
  a.rows_per_block = rows_per_block;
  a.div_t = fast_div(T);
  a.div_passes = fast_div(a.passes);
  a.div_gate_passes = fast_div(a.gate_passes);
  a.div_tap64 = fast_div(cp / AnyWide::kKC);
  a.div_tap16 = fast_div(cp / AnyF32::kChunk);
  a.div_acts16 = fast_div(gp / AnyF32::kChunk);
  a.div_gate = fast_div(K * a.div_tap16.d);
  a.div_tile = fast_div(a.gate_passes * K * a.div_tap16.d +
                        a.passes * a.div_acts16.d);
  void* params[] = {&a};
  if (!bf16_mode) {
    const Instance k = instance(0, 0, last, partial, two);
    err = cudaLaunchKernel(k.fn, dim3(blocks), dim3(k.threads), params,
                           k.smem, stream);
    return err != cudaSuccess ? err : cudaGetLastError();
  }
  const Instance gate = instance(1, 1, 0, partial, false);
  err = cudaLaunchKernel(gate.fn, dim3(gate_blocks), dim3(gate.threads),
                         params, gate.smem, stream);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const Instance k = instance(1, 0, last, partial, false);
  err = cudaLaunchKernel(k.fn, dim3(blocks), dim3(k.threads), params, k.smem,
                         stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

cudaError_t kernel_info(int C, int G, int bf16_mode, int which, int last,
                        int partial, int* registers, int* local_bytes,
                        int* static_smem_bytes, int* dynamic_smem_bytes) {
  if (bad_shape(1, 1, C, G, 1, 0, bf16_mode) || which < 0 || which > 2)
    return cudaErrorInvalidValue;
  const Instance k = instance(bf16_mode, which, last, partial, two_rows(G));
  if (k.fn == nullptr) return cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, k.fn);
  if (err != cudaSuccess) return err;
  *registers = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *static_smem_bytes = static_cast<int>(attr.sharedSizeBytes);
  *dynamic_smem_bytes = k.smem;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The widest C each mode's wrapper takes.
int wn_layer_any_max_channels(int bf16_mode) {
  return bf16_mode ? kMaxCBf16 : kMaxCF32;
}

// The launch grid of one whole-layer call (see schedule): the slots of one
// wave, the blocks of each product kernel and, in f32, the rows a block
// takes (in bf16 the rows of a unit).
cudaError_t wn_layer_any_schedule(int C, int batch, int T, int bf16_mode,
                                  int last, int* slots, int* blocks,
                                  int* rows_per_block) {
  if (bad_shape(batch, T, C, C, 1, 0, bf16_mode)) return cudaErrorInvalidValue;
  int gate_blocks = 0;
  return schedule(bf16_mode, last, 0, static_cast<int64_t>(batch) * T, C, C,
                  slots, &gate_blocks, blocks, rows_per_block);
}

// The launch grid of a rank's call at gate width G: as
// wn_layer_any_schedule, with the bf16 gate kernel's blocks apart.
cudaError_t wn_layer_shard_any_schedule(int C, int G, int batch, int T,
                                        int bf16_mode, int last, int* slots,
                                        int* gate_blocks, int* blocks,
                                        int* rows_per_block) {
  if (bad_shape(batch, T, C, G, 1, 0, bf16_mode)) return cudaErrorInvalidValue;
  return schedule(bf16_mode, last, 1, static_cast<int64_t>(batch) * T, C, G,
                  slots, gate_blocks, blocks, rows_per_block);
}

// Shapes: x, x_out, skip_out [batch, T, C] f32; cond [batch, T, 2C]; w_in
// [K*C, 2C]; b_in [2C] f32; w_rs [C, 2C] or [C, C] (last); b_rs likewise
// f32; valid_t [batch] int32 or null. cond/w_in/w_rs are bf16 when bf16_mode
// != 0, else f32. C even, at most wn_layer_any_max_channels(bf16_mode); K
// odd; dilation >= 0. accumulate != 0 adds into skip_out (in place).
// Scratch from the caller (Cp = C rounded up to 64, R = batch*T, n_rsp =
// 2Cp, the last layer's Cp; bf16 in bf16 mode, else f32): acts [R, Cp];
// x_p [R, Cp] in bf16 mode or where C != Cp, else null; w_in_p [K*Cp, 2Cp]
// and w_rs_p [Cp, n_rsp] where C != Cp, else null. All pointers 16-byte
// aligned and contiguous. Launches the prep kernel (bf16, or C != Cp), then
// the layer kernel (f32) or the gate and res/skip kernels (bf16), on
// `stream`, does not synchronise; returns the first launch error.
cudaError_t wn_layer_any_forward(const float* x, const void* cond,
                                 const void* w_in, const float* b_in,
                                 const void* w_rs, const float* b_rs,
                                 const int* valid_t, float* x_out,
                                 float* skip_out, void* acts, void* x_p,
                                 void* w_in_p, void* w_rs_p, int accumulate,
                                 int batch, int T, int C, int K, int dilation,
                                 int bf16_mode, int last,
                                 cudaStream_t stream) {
  if (x_out == nullptr || skip_out == nullptr) return cudaErrorInvalidValue;
  return launch(x, cond, w_in, b_in, w_rs, b_rs, valid_t, x_out, skip_out,
                nullptr, acts, x_p, w_in_p, w_rs_p, accumulate, batch, T, C, C,
                K, dilation, bf16_mode, last, stream);
}

// One model rank's share of a layer at gate width G (1 <= G <= C): x
// [batch, T, C] f32; cond_s [batch, T, 2G]; w_in_s [K*C, 2G]; b_in_s [2G]
// f32; w_rs_s [G, n_rs] (n_rs = 2C, the last layer's C); cond_s, w_in_s and
// w_rs_s bf16 when bf16_mode != 0, else f32. Writes the f32 partial
// acts @ w_rs_s into out [batch, T, n_rs]. Scratch (Gp = G rounded up to
// 64, in the mode's element type): acts [R, Gp]; x_p [R, Cp] in bf16 mode
// or where C != Cp, else null; w_in_p [K*Cp, 2Gp] and w_rs_p [Gp, n_rsp]
// where C != Cp or G != Gp, else null. Launches as wn_layer_any_forward.
cudaError_t wn_layer_shard_any_forward(const float* x, const void* cond_s,
                                       const void* w_in_s,
                                       const float* b_in_s,
                                       const void* w_rs_s, float* out,
                                       void* acts, void* x_p, void* w_in_p,
                                       void* w_rs_p, int batch, int T, int C,
                                       int G, int K, int dilation,
                                       int bf16_mode, int last,
                                       cudaStream_t stream) {
  if (out == nullptr) return cudaErrorInvalidValue;
  return launch(x, cond_s, w_in_s, b_in_s, w_rs_s, nullptr, nullptr, nullptr,
                nullptr, out, acts, x_p, w_in_p, w_rs_p, 0, batch, T, C, G, K,
                dilation, bf16_mode, last, stream);
}

// What the loaded build of kernel `which` (0: the f32 layer kernel or the
// bf16 res/skip kernel, 1: the bf16 gate, 2: the prep) of a mode uses, read
// from the CUDA runtime: registers per thread, local (spill) bytes per
// thread, static shared bytes, and the dynamic shared bytes its launcher
// passes (the same at every C).
cudaError_t wn_layer_any_kernel_info(int C, int bf16_mode, int which,
                                     int last, int* registers,
                                     int* local_bytes,
                                     int* static_smem_bytes,
                                     int* dynamic_smem_bytes) {
  return kernel_info(C, C, bf16_mode, which, last, 0, registers, local_bytes,
                     static_smem_bytes, dynamic_smem_bytes);
}

// The same for a rank's call at gate width G: kernel 0 is its partial-mode
// instance (in f32 the Gp = 64 one where G <= 64).
cudaError_t wn_layer_shard_any_kernel_info(int C, int G, int bf16_mode,
                                           int which, int last,
                                           int* registers, int* local_bytes,
                                           int* static_smem_bytes,
                                           int* dynamic_smem_bytes) {
  return kernel_info(C, G, bf16_mode, which, last, 1, registers, local_bytes,
                     static_smem_bytes, dynamic_smem_bytes);
}

}  // extern "C"
