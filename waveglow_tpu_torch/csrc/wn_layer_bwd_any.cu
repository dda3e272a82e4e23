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
// C, K, the dilation d, B and T are runtime arguments. Layouts, row-major:
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
// Design: right and simple; nothing is tuned, making it fast is later work.
// Every product is a wgmma (m64n64k16 or m64n128k16, bf16 operands from
// 128-byte-swizzled shared memory, f32 accumulators; sm90_wgmma.cuh) of
// one warpgroup on a tile of 64 rows, fed by 64-deep K chunks that
// cp.async double-buffers (nothing staged in registers), each chunk's
// wgmmas waited for before the chunk's barrier, so none is in flight
// across the loop's back edge. Any even C: the first two kernels copy the
// operands once into layouts padded to Cp = C rounded up to 64 channels,
// zero past C, so every later copy is a 16-byte piece of a swizzle row
// and every channel tail is zero: C = 48 and C = 50 are exact, and C = 50,
// whose rows allow no 16-byte copy, is read in pairs by those two kernels
// alone. Each tap's rows are loaded on their own: taps reach +-(K/2)*d
// rows (+-384 at K = 7 and d = 128), further than T at T = 17; rows outside
// [0, T) are zero-filled, and the adjoint's shifts run the other way. The
// kernels, in order on one stream:
//   pad     - w_in into w_in_p [K*Cp, 2Cp] and w_rs into w_rs_p [Cp, n_rsp]
//             (n_rsp = 2Cp, the last layer's Cp), each half of the columns
//             from column 0 and from column Cp, zero past C.
//   prep    - per (batch row, tile of 64 time rows): x_p = bf16(x) [R, Cp];
//             drs from the cotangents and valid_t, written as g_p = bf16(drs)
//             [R, n_rsp]; the tile's f32 column sums of drs (db_rs) into
//             part_rs. Memory-bound.
//   rows    - per (batch row, tile of 64 time rows, pass of 64 channels):
//             the gate recompute (K*Cp deep; the pass's tanh and sigmoid
//             columns, two m64n64 products), then dacts (n_rsp deep, w_rs_p
//             read K-major as it lies) into accumulators that sit in the
//             same thread for the same (row, channel), so the gate and its
//             adjoint run on them in f32: dcond, acts_p = bf16(acts) [R, Cp],
//             dg_p = bf16(dgates) [R, 2Cp], and the tile's f32 column sums
//             of dgates (db_in) into part_in.
//   dx      - per (batch row, tile of 64 time rows, 64 output channels):
//             one product K*2Cp deep, tap k's chunks the dg_p rows at t -
//             (k - K/2)*d against w_in_p's tap-k rows read K-major; adds
//             dx_next at rows t < valid_t.
//   weights - per (output tile of 64 x 128, range of a batch row's rows):
//             dw_in (x_p rows at t + (k - K/2)*d against dg_p) and dw_rs
//             (acts_p against g_p), both operands MN-major as they lie;
//             the f32 partials to a workspace, a slot for each range (the
//             caller sizes the ranges to fill the card: kernels/wn_layer.py's
//             bwd_splits).
//   reduce  - sums the partials over the ranges and the column sums over
//             the tiles in a fixed order, drops the padding, casts dw_in and
//             dw_rs to bf16.
// No atomics anywhere: two launches give the same bits. PERF.md keeps its
// times (chip_smoke.py phase 17), wn_layer_bwd_any_kernel_info each
// kernel's registers, spills and shared memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

#include "f32_ring.cuh"  // cp.async, opt_in_smem
#include "sm90_wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;                 // time rows of a tile
constexpr int kKC = 64;                   // K of a chunk: one swizzle row
constexpr int kThreads = 128;             // one warpgroup
constexpr int kBlock = 64 * 128;          // [64 rows][64 bf16], swizzled
constexpr int kWN = 128;                  // N of a weights tile
constexpr int kElemThreads = 256;         // pad, prep, reduce
// Dynamic shared bytes: two A buffers and two B buffers (the rows kernel's
// B holds the gate's tanh and sigmoid blocks; it adds its column sums).
constexpr int kRowsSmem = 2 * kBlock + 2 * 2 * kBlock + 4 * 2 * 64 * 4;
constexpr int kDxSmem = 2 * kBlock + 2 * kBlock;
constexpr int kWeightsSmem = 2 * kBlock + 2 * (kWN / 64) * kBlock;

__host__ __device__ __forceinline__ int pad64(int c) {
  return (c + 63) / 64 * 64;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo at the lower address
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return make_float2(__uint_as_float(v << 16),
                     __uint_as_float(v & 0xffff0000u));
}

// The K loop of one product: n chunks in two shared buffers. `issue(j,
// buf)` starts chunk j's cp.async copies into buffer `buf`; `mul(j, buf)`
// runs chunk j's wgmmas from buffer `buf` and waits for them. Chunk j + 1
// copies while chunk j is multiplied; one barrier a chunk, before which the
// thread's copies have landed and are handed to the async proxy. Returns
// after a barrier, with every chunk multiplied.
template <typename Issue, typename Mul>
__device__ __forceinline__ void chunks(int n, const Issue& issue,
                                       const Mul& mul) {
  if (n > 0) issue(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();
#pragma unroll 1
  for (int j = 0; j < n; ++j) {
    // past the last barrier every thread is done with buffer (j + 1) & 1
    if (j + 1 < n) issue(j + 1, (j + 1) & 1);
    cp_async_commit();
    mul(j, j & 1);
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
  }
}

// One chunk of a K-major A operand: 64 rows of 64 bf16 (8 pieces of 16
// bytes each) into `dst`; this thread's pieces are q = tid % 8 of rows tid / 8
// + 16i. Row r is `rows_src` row `s0 + r` (its rows `ld` values apart, from
// its column `col`), zero where that row is outside [lo, hi).
__device__ __forceinline__ void load_a(uint32_t dst, const bf16* src,
                                       int64_t seq, int64_t ld, int64_t s0,
                                       int lo, int hi, int col) {
  const int q = threadIdx.x % 8, r0 = threadIdx.x / 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 16 * i;
    const int64_t s = s0 + r;
    const bool ok = s >= lo && s < hi;
    cp_async16_zfill(dst + sw128_piece(r, q),
                     ok ? src + (seq + s) * ld + col + q * 8 : src, ok);
  }
}

// One chunk of a B operand of 64 rows (a K-major B: its N rows; an MN-major
// one: its K rows) of kN values, in blocks of 64 values kBlock bytes apart:
// row r is `src` row r (rows `ld` values apart).
template <int kN>
__device__ __forceinline__ void load_b(uint32_t dst, const bf16* src,
                                       int64_t ld) {
  const int q = threadIdx.x % 8, r0 = threadIdx.x / 8;
#pragma unroll
  for (int i = 0; i < 4 * kN / 64; ++i) {
    const int r = r0 + 16 * (i % 4), h = i / 4;
    cp_async16(dst + h * kBlock + sw128_piece(r, q),
               src + static_cast<int64_t>(r) * ld + h * 64 + q * 8);
  }
}

// ---- pad: the weights into padded layouts ------------------------------------

// One block a padded row: rows [0, K*Cp) of w_in_p, then rows [0, Cp) of
// w_rs_p.
__global__ void __launch_bounds__(kElemThreads)
wn_bwd_any_pad_kernel(const bf16* __restrict__ w_in,
                      const bf16* __restrict__ w_rs, bf16* __restrict__ w_in_p,
                      bf16* __restrict__ w_rs_p, int C, int K, int last) {
  const int cp = pad64(C);
  const int n_rs = last ? C : 2 * C, n_rsp = last ? cp : 2 * cp;
  const bf16 zero = __float2bfloat16(0.f);
  const int row = blockIdx.x;
  if (row < K * cp) {
    const int tap = row / cp, ci = row % cp;
    const bf16* src = w_in + static_cast<int64_t>(tap * C + ci) * 2 * C;
    bf16* dst = w_in_p + static_cast<int64_t>(row) * 2 * cp;
    for (int col = threadIdx.x; col < 2 * cp; col += kElemThreads) {
      const int h = col / cp, co = col % cp;
      dst[col] = ci < C && co < C ? src[h * C + co] : zero;
    }
  } else {
    const int c = row - K * cp;
    const bf16* src = w_rs + static_cast<int64_t>(c) * n_rs;
    bf16* dst = w_rs_p + static_cast<int64_t>(c) * n_rsp;
    for (int col = threadIdx.x; col < n_rsp; col += kElemThreads) {
      const int h = col / cp, co = col % cp;
      dst[col] = c < C && co < C ? src[h * C + co] : zero;
    }
  }
}

// ---- prep: x and drs rounded into padded layouts, drs's column sums ------------

// One block per (tile of kTile time rows, batch row). Pairs of channels
// (C even keeps a pair's 8 bytes aligned): x_p from x, all threads over
// the tile's flat (row, pair)s; g_p from drs, a thread a column pair summing
// its column down the tile's rows in order, the sums into the tile's row of
// part_rs.
__global__ void __launch_bounds__(kElemThreads)
wn_bwd_any_prep_kernel(const float* __restrict__ x,
                       const float* __restrict__ dx_next,
                       const float* __restrict__ dskip,
                       const int* __restrict__ valid_t, bf16* __restrict__ x_p,
                       bf16* __restrict__ g_p, float* __restrict__ part_rs,
                       int T, int C, int last) {
  const int cp = pad64(C), n_rsp = last ? cp : 2 * cp;
  const int tile = blockIdx.x, b = blockIdx.y;
  const int t0 = tile * kTile;
  const int rows = min(kTile, T - t0);
  const int64_t row0 = static_cast<int64_t>(b) * T + t0;
  const int valid = valid_t != nullptr ? valid_t[b] : T;

  const int pairs = cp / 2;
  for (int i = threadIdx.x; i < rows * pairs; i += kElemThreads) {
    const int r = i / pairs, c = 2 * (i % pairs);
    const int64_t row = row0 + r;
    float2 v = make_float2(0.f, 0.f);
    if (c < C) v = *reinterpret_cast<const float2*>(x + row * C + c);
    *reinterpret_cast<uint32_t*>(x_p + row * cp + c) = pack_bf16(v.x, v.y);
  }

  for (int p = threadIdx.x; p < n_rsp / 2; p += kElemThreads) {
    const int col = 2 * p, h = col / cp, co = col % cp;
    const bool residual = !last && h == 0;  // dx_next's columns
    const float* src = residual ? dx_next : dskip;
    float2 sum = make_float2(0.f, 0.f);
    for (int r = 0; r < rows; ++r) {
      const int64_t row = row0 + r;
      float2 v = make_float2(0.f, 0.f);
      if (co < C && src != nullptr && !(residual && t0 + r >= valid))
        v = *reinterpret_cast<const float2*>(src + row * C + co);
      sum.x += v.x;
      sum.y += v.y;
      *reinterpret_cast<uint32_t*>(g_p + row * n_rsp + col) =
          pack_bf16(v.x, v.y);
    }
    float* out = part_rs + (static_cast<int64_t>(b) * gridDim.x + tile) * n_rsp;
    out[col] = sum.x;
    out[col + 1] = sum.y;
  }
}

// ---- rows: the gate recompute, dacts, the gate's adjoint ------------------------

// One block per (tile of 64 time rows x pass of 64 channels, batch row):
// blockIdx.x = tile * passes + pass.
__global__ void __launch_bounds__(kThreads, 1)
wn_bwd_any_rows_kernel(const bf16* __restrict__ x_p,
                       const bf16* __restrict__ cond,
                       const bf16* __restrict__ w_in_p,
                       const float* __restrict__ b_in,
                       const bf16* __restrict__ w_rs_p,
                       const bf16* __restrict__ g_p, bf16* __restrict__ dcond,
                       bf16* __restrict__ acts_p, bf16* __restrict__ dg_p,
                       float* __restrict__ part_in, int T, int C, int K,
                       int dilation, int last) {
  extern __shared__ __align__(1024) uint4 smem_rows[];
  const uint32_t base = smem_u32(smem_rows);
  // [A0][A1] kBlock each, [B0][B1] 2 kBlock each, then the column sums
  // [4 warps][128]
  constexpr int kB = 2 * kBlock, kRed = kB + 4 * kBlock;
  float* red = reinterpret_cast<float*>(reinterpret_cast<char*>(smem_rows) +
                                        kRed);
  const int cp = pad64(C), n_rsp = last ? cp : 2 * cp;
  const int passes = cp / 64;
  const int tile = blockIdx.x / passes, cb = (blockIdx.x % passes) * 64;
  const int b = blockIdx.y;
  const int t0 = tile * kTile;
  const int64_t seq = static_cast<int64_t>(b) * T;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;

  // accumulator element 4j + 2h + e: row warp*16 + g + 8h, column 8j + 2tig
  // + e of the pass: channel cb + 8j + 2tig + e's tanh pre-activation
  // (acc_t), sigmoid pre-activation (acc_s) and dacts (acc_d)
  float acc_t[32], acc_s[32], acc_d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_t[i] = acc_s[i] = acc_d[i] = 0.f;

  // ---- gates = taps @ w_in_p[:, the pass's columns]: chunk j is tap j /
  // passes, channels 64 (j % passes) + [0, 64)
  chunks(
      K * passes,
      [&](int j, int buf) {
        const int tap = j / passes, c0 = (j % passes) * kKC;
        load_a(base + buf * kBlock, x_p, seq, cp,
               t0 + static_cast<int64_t>(tap - K / 2) * dilation, 0, T, c0);
        // two MN-major [64 K][64 N] blocks: tanh columns cb.., sigmoid
        // columns Cp + cb..
        const bf16* w = w_in_p + static_cast<int64_t>(tap * cp + c0) * 2 * cp + cb;
        const uint32_t dst = base + kB + buf * 2 * kBlock;
        load_b<64>(dst, w, 2 * cp);
        load_b<64>(dst + kBlock, w + cp, 2 * cp);
      },
      [&](int, int buf) {
        const uint32_t a = base + buf * kBlock;
        const uint32_t w = base + kB + buf * 2 * kBlock;
        fence_acc(acc_t);
        fence_acc(acc_s);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < kKC / 16; ++k) {
          const uint64_t da = kmajor_desc(a + k * 32);
          wgmma_m64<64, 0, 1>(acc_t, da, mnmajor_desc(w + k * 2048, kBlock));
          wgmma_m64<64, 0, 1>(acc_s, da,
                              mnmajor_desc(w + kBlock + k * 2048, kBlock));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(acc_t);
        fence_acc(acc_s);
      });

  // ---- dacts = bf16(drs) @ w_rs_p[the pass's rows]^T: rows past T zero
  chunks(
      n_rsp / kKC,
      [&](int j, int buf) {
        load_a(base + buf * kBlock, g_p, seq, n_rsp, t0, 0, T, j * kKC);
        // K-major: N row n is w_rs_p row cb + n, its K values 64j..
        load_b<64>(base + kB + buf * 2 * kBlock,
                   w_rs_p + static_cast<int64_t>(cb) * n_rsp + j * kKC,
                   n_rsp);
      },
      [&](int, int buf) {
        const uint32_t a = base + buf * kBlock;
        const uint32_t w = base + kB + buf * 2 * kBlock;
        fence_acc(acc_d);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < kKC / 16; ++k)
          wgmma_m64<64, 0, 0>(acc_d, kmajor_desc(a + k * 32),
                              kmajor_desc(w + k * 32));
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(acc_d);
      });

  // ---- the gate and its adjoint on the accumulators (f32); rows past T and
  // channels past C give zeros
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int ch = cb + 8 * j + 2 * tig;
    const bool ch_ok = ch < C;  // C even: ch + 1 < C too
    float2 bt = make_float2(0.f, 0.f), bs = bt;
    if (ch_ok) {
      bt = *reinterpret_cast<const float2*>(b_in + ch);
      bs = *reinterpret_cast<const float2*>(b_in + C + ch);
    }
    float sa0 = 0.f, sa1 = 0.f, sb0 = 0.f, sb1 = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + warp * 16 + g + 8 * h;
      if (t >= T) continue;
      const int64_t row = seq + t;
      float act[2] = {0.f, 0.f}, da[2] = {0.f, 0.f}, db[2] = {0.f, 0.f};
      if (ch_ok) {
        const bf16* cr = cond + row * 2 * C + ch;
        const float2 ct = unpack_bf16(*reinterpret_cast<const uint32_t*>(cr));
        const float2 cs =
            unpack_bf16(*reinterpret_cast<const uint32_t*>(cr + C));
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          const float gt = acc_t[i] + (e ? bt.y : bt.x) + (e ? ct.y : ct.x);
          const float gs = acc_s[i] + (e ? bs.y : bs.x) + (e ? cs.y : cs.x);
          const float tv = tanhf(gt);
          const float sv = 1.f / (1.f + expf(-gs));
          const float dv = acc_d[i];
          act[e] = tv * sv;
          da[e] = dv * sv * (1.f - tv * tv);
          db[e] = dv * tv * sv * (1.f - sv);
        }
        bf16* dc = dcond + row * 2 * C + ch;
        *reinterpret_cast<uint32_t*>(dc) = pack_bf16(da[0], da[1]);
        *reinterpret_cast<uint32_t*>(dc + C) = pack_bf16(db[0], db[1]);
      }
      sa0 += da[0]; sa1 += da[1]; sb0 += db[0]; sb1 += db[1];
      *reinterpret_cast<uint32_t*>(acts_p + row * cp + ch) =
          pack_bf16(act[0], act[1]);
      bf16* dg = dg_p + row * 2 * cp + ch;
      *reinterpret_cast<uint32_t*>(dg) = pack_bf16(da[0], da[1]);
      *reinterpret_cast<uint32_t*>(dg + cp) = pack_bf16(db[0], db[1]);
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
      float* rw = red + warp * 128 + 8 * j + 2 * tig;
      rw[0] = sa0;
      rw[1] = sa1;
      rw[64] = sb0;
      rw[65] = sb1;
    }
  }
  // the tile's dgates column sums over the 4 warps, in order
  __syncthreads();
  const int col = threadIdx.x;  // 128 columns: 64 tanh, then 64 sigmoid
  const float sum = ((red[col] + red[128 + col]) + red[256 + col]) +
                    red[384 + col];
  const int tiles = gridDim.x / passes;
  part_in[(static_cast<int64_t>(b) * tiles + tile) * 2 * cp +
          (col < 64 ? cb + col : cp + cb + col - 64)] = sum;
}

// ---- dx: the taps' adjoint ----------------------------------------------------------

// One block per (tile of 64 time rows x 64 output channels, batch row):
// blockIdx.x = tile * (Cp / 64) + channel block. K chunk j is tap j /
// (2Cp / 64), gate columns 64 (j % (2Cp / 64)) + [0, 64).
__global__ void __launch_bounds__(kThreads, 1)
wn_bwd_any_dx_kernel(const bf16* __restrict__ dg_p,
                     const bf16* __restrict__ w_in_p,
                     const float* __restrict__ dx_next,
                     const int* __restrict__ valid_t, float* __restrict__ dx,
                     int T, int C, int K, int dilation) {
  extern __shared__ __align__(1024) uint4 smem_dx[];
  const uint32_t base = smem_u32(smem_dx);
  constexpr int kB = 2 * kBlock;  // [A0][A1][B0][B1], kBlock each
  const int cp = pad64(C);
  const int blocks_n = cp / 64, per_tap = 2 * cp / kKC;
  const int tile = blockIdx.x / blocks_n, n0 = (blockIdx.x % blocks_n) * 64;
  const int b = blockIdx.y;
  const int t0 = tile * kTile;
  const int64_t seq = static_cast<int64_t>(b) * T;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  chunks(
      K * per_tap,
      [&](int j, int buf) {
        const int tap = j / per_tap, m0 = (j % per_tap) * kKC;
        // dx[t] takes dgates[t - (tap - K/2)*d]
        load_a(base + buf * kBlock, dg_p, seq, 2 * cp,
               t0 - static_cast<int64_t>(tap - K / 2) * dilation, 0, T, m0);
        // K-major: N row n is w_in_p row tap*Cp + n0 + n, its K values m0..
        load_b<64>(base + kB + buf * kBlock,
                   w_in_p + static_cast<int64_t>(tap * cp + n0) * 2 * cp + m0,
                   2 * cp);
      },
      [&](int, int buf) {
        const uint32_t a = base + buf * kBlock;
        const uint32_t w = base + kB + buf * kBlock;
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < kKC / 16; ++k)
          wgmma_m64<64, 0, 0>(acc, kmajor_desc(a + k * 32),
                              kmajor_desc(w + k * 32));
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(acc);
      });

  const int valid = valid_t != nullptr ? valid_t[b] : T;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = t0 + warp * 16 + g + 8 * h;
    if (t >= T) continue;
    const int64_t row = (seq + t) * C;
    const bool add = dx_next != nullptr && t < valid;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int ch = n0 + 8 * j + 2 * tig;
      if (ch >= C) continue;  // C even: ch + 1 < C too
      float2 v = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      if (add) {
        const float2 n = *reinterpret_cast<const float2*>(dx_next + row + ch);
        v = make_float2(n.x + v.x, n.y + v.y);
      }
      *reinterpret_cast<float2*>(dx + row + ch) = v;
    }
  }
}

// ---- weights: dw_in and dw_rs, f32 partials of row ranges --------------------------

// Output tiles of 64 rows x kWN columns: dw_in_p's (K*Cp / 64 x 2Cp / kWN),
// then dw_rs_p's (Cp / 64 x ceil(n_rsp / kWN)).
__host__ __device__ __forceinline__ int weight_tiles(int C, int K, int last) {
  const int cp = pad64(C), n_rsp = last ? cp : 2 * cp;
  return K * cp / 64 * (2 * cp / kWN) + cp / 64 * ((n_rsp + kWN - 1) / kWN);
}

// blockIdx.x: the output tile; blockIdx.y: the range s = b * n_splits_t +
// ts, rows [ts * split_rows, (ts + 1) * split_rows) of batch row b. Writes
// its f32 partial of the tile into slot s of ws, each slot dw_in_p [K*Cp,
// 2Cp] then dw_rs_p [Cp, n_rsp].
__global__ void __launch_bounds__(kThreads, 1)
wn_bwd_any_weights_kernel(const bf16* __restrict__ x_p,
                          const bf16* __restrict__ dg_p,
                          const bf16* __restrict__ acts_p,
                          const bf16* __restrict__ g_p, float* __restrict__ ws,
                          int T, int C, int K, int dilation, int last,
                          int n_splits_t, int split_rows) {
  extern __shared__ __align__(1024) uint4 smem_w[];
  const uint32_t base = smem_u32(smem_w);
  constexpr int kB = 2 * kBlock;  // [A0][A1] kBlock each, [B0][B1]
  constexpr int kBBytes = kWN / 64 * kBlock;
  const int cp = pad64(C), n_rsp = last ? cp : 2 * cp;
  const int split = blockIdx.y;
  const int b = split / n_splits_t;
  const int tb = (split % n_splits_t) * split_rows;
  const int te = min(T, tb + split_rows);
  const int64_t seq = static_cast<int64_t>(b) * T;
  const int64_t dw_in_size = static_cast<int64_t>(K) * cp * 2 * cp;
  float* wsp = ws + split * (dw_in_size + static_cast<int64_t>(cp) * n_rsp);

  // the tile: out[m][n] = sum over the range's rows t of A[t + shift][m]
  // B[t][n], m < 64, n < n_ext
  const int in_nt = 2 * cp / kWN, in_tiles = K * cp / 64 * in_nt;
  const int rs_nt = (n_rsp + kWN - 1) / kWN;
  const bf16 *a_src, *b_src;
  int lda, ldb, n_ext, ld_out;
  int64_t shift;
  float* out;
  if (static_cast<int>(blockIdx.x) < in_tiles) {
    // dw_in_p rows tap*Cp + ci0 + m, columns nt*kWN + n
    const int mt = blockIdx.x / in_nt, nt = blockIdx.x % in_nt;
    const int tap = mt * 64 / cp, ci0 = mt * 64 % cp;
    a_src = x_p + ci0;
    lda = cp;
    shift = static_cast<int64_t>(tap - K / 2) * dilation;
    b_src = dg_p + nt * kWN;
    ldb = 2 * cp;
    n_ext = kWN;
    ld_out = 2 * cp;
    out = wsp + static_cast<int64_t>(mt) * 64 * 2 * cp + nt * kWN;
  } else {
    // dw_rs_p rows mt*64 + m, columns nt*kWN + n
    const int tile = blockIdx.x - in_tiles;
    const int mt = tile / rs_nt, nt = tile % rs_nt;
    a_src = acts_p + mt * 64;
    lda = cp;
    shift = 0;
    b_src = g_p + nt * kWN;
    ldb = n_rsp;
    n_ext = min(kWN, n_rsp - nt * kWN);
    ld_out = n_rsp;
    out = wsp + dw_in_size + static_cast<int64_t>(mt) * 64 * n_rsp + nt * kWN;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  float acc[kWN / 2];
#pragma unroll
  for (int i = 0; i < kWN / 2; ++i) acc[i] = 0.f;
  chunks(
      te > tb ? (te - tb + kKC - 1) / kKC : 0,
      [&](int c, int buf) {
        const int q = threadIdx.x % 8, r0 = threadIdx.x / 8;
        const uint32_t a = base + buf * kBlock;
        const uint32_t w = base + kB + buf * kBBytes;
        // MN-major: K row kr is time row t = tb + 64c + kr, its 64 M values
        // (A, from row t + shift) and kWN N values (B)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kr = r0 + 16 * i;
          const int t = tb + c * kKC + kr;
          const int64_t s = t + shift;
          const bool ok = t < te && s >= 0 && s < T;
          cp_async16_zfill(a + sw128_piece(kr, q),
                           ok ? a_src + (seq + s) * lda + q * 8 : a_src, ok);
        }
#pragma unroll
        for (int i = 0; i < 4 * kWN / 64; ++i) {
          const int kr = r0 + 16 * (i % 4), h = i / 4;
          const int t = tb + c * kKC + kr;
          const int n = h * 64 + q * 8;
          const bool ok = t < te && n < n_ext;
          cp_async16_zfill(w + h * kBlock + sw128_piece(kr, q),
                           ok ? b_src + (seq + t) * ldb + n : b_src, ok);
        }
      },
      [&](int, int buf) {
        const uint32_t a = base + buf * kBlock;
        const uint32_t w = base + kB + buf * kBBytes;
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < kKC / 16; ++k)
          wgmma_m64<kWN, 1, 1>(acc, mnmajor_desc(a + k * 2048, kBlock),
                               mnmajor_desc(w + k * 2048, kBlock));
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(acc);
      });

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float* o = out + static_cast<int64_t>(warp * 16 + g + 8 * h) * ld_out;
#pragma unroll
    for (int j = 0; j < kWN / 8; ++j) {
      const int n = 8 * j + 2 * tig;
      if (n < n_ext)
        *reinterpret_cast<float2*>(o + n) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// ---- reduce: fixed-order sums, the padding dropped, casts -------------------------

// One thread per output element: dw_in [K*C, 2C], dw_rs [C, n_rs], db_in
// [2C], db_rs [n_rs], in that order. A weight sums its n_splits partials in
// order; a bias its n_tiles column sums in order.
__global__ void __launch_bounds__(kElemThreads)
wn_bwd_any_reduce_kernel(const float* __restrict__ ws, int n_splits,
                         const float* __restrict__ part_in,
                         const float* __restrict__ part_rs, int n_tiles,
                         bf16* __restrict__ dw_in, bf16* __restrict__ dw_rs,
                         float* __restrict__ db_in, float* __restrict__ db_rs,
                         int C, int K, int last) {
  const int cp = pad64(C);
  const int n_rs = last ? C : 2 * C, n_rsp = last ? cp : 2 * cp;
  const int64_t n_in = static_cast<int64_t>(K) * C * 2 * C;
  const int64_t n_w = n_in + static_cast<int64_t>(C) * n_rs;
  const int64_t dw_in_size = static_cast<int64_t>(K) * cp * 2 * cp;
  const int64_t stride = dw_in_size + static_cast<int64_t>(cp) * n_rsp;
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * kElemThreads + threadIdx.x;
  if (idx < n_w) {
    int64_t p;
    if (idx < n_in) {
      const int64_t row = idx / (2 * C);
      const int col = static_cast<int>(idx % (2 * C));
      const int64_t tap = row / C, ci = row % C;
      p = (tap * cp + ci) * 2 * cp + col / C * cp + col % C;
    } else {
      const int64_t c = (idx - n_in) / n_rs;
      const int col = static_cast<int>((idx - n_in) % n_rs);
      p = dw_in_size + c * n_rsp + col / C * cp + col % C;
    }
    float s = 0.f;
    for (int i = 0; i < n_splits; ++i) s += ws[i * stride + p];
    const bf16 v = __float2bfloat16(s);
    if (idx < n_in) dw_in[idx] = v;
    else dw_rs[idx - n_in] = v;
    return;
  }
  const int64_t col = idx - n_w;
  if (col >= 2 * C + n_rs) return;
  const bool in = col < 2 * C;
  const int c = static_cast<int>(in ? col : col - 2 * C);
  const float* part = in ? part_in : part_rs;
  const int ld = in ? 2 * cp : n_rsp;
  const int p = c / C * cp + c % C;
  float s = 0.f;
  for (int i = 0; i < n_tiles; ++i) s += part[static_cast<int64_t>(i) * ld + p];
  if (in) db_in[c] = s;
  else db_rs[c] = s;
}

// The kernel `which` (0 rows, 1 dx, 2 weights, 3 reduce, 4 prep, 5 pad) and
// its dynamic shared bytes.
const void* kernel_for(int which, int* smem_bytes) {
  *smem_bytes = 0;
  switch (which) {
    case 0:
      *smem_bytes = kRowsSmem;
      return reinterpret_cast<const void*>(wn_bwd_any_rows_kernel);
    case 1:
      *smem_bytes = kDxSmem;
      return reinterpret_cast<const void*>(wn_bwd_any_dx_kernel);
    case 2:
      *smem_bytes = kWeightsSmem;
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

std::atomic<uint32_t> g_opted_in[3];

}  // namespace

extern "C" {

// Output tiles of the weights kernel at (C, K, last): each a block for each
// of the n_splits_t ranges of each batch row.
int wn_layer_bwd_any_weight_tiles(int C, int K, int last) {
  if (C <= 0 || C % 2 != 0 || K <= 0 || K % 2 != 1) return -1;
  return weight_tiles(C, K, last);
}

// The bf16 backward of one whole layer at any even C and odd K, six
// launches on `stream` (pad, prep, rows, dx, weights, reduce), no
// synchronisation; returns the first launch error.
// Inputs: x [batch, T, C] f32; cond [batch, T, 2C], w_in [K*C, 2C], w_rs
// [C, n_rs] bf16 (n_rs = C when last, else 2C); b_in [2C] f32; dx_next,
// dskip [batch, T, C] f32 or null (zero); valid_t [batch] int32 or null.
// Outputs: dx f32 like x, dcond bf16 like cond, dw_in / dw_rs bf16 like the
// weights, db_in / db_rs f32. Scratch, from the caller (Cp = C rounded up
// to 64, n_rsp = Cp when last, else 2Cp; R = batch*T; tiles = batch *
// ceil(T / 64)): x_p, acts_p [R, Cp], g_p [R, n_rsp], dg_p [R, 2Cp],
// w_in_p [K*Cp, 2Cp], w_rs_p [Cp, n_rsp] bf16; part_in [tiles, 2Cp],
// part_rs [tiles, n_rsp] f32; ws [batch * n_splits_t, K*Cp*2Cp +
// Cp*n_rsp] f32. The weights kernel splits each batch row's T into
// n_splits_t ranges of split_rows rows (a multiple of 64). Pointers
// 16-byte aligned, contiguous.
cudaError_t wn_layer_backward_any_bf16(
    const float* x, const void* cond, const void* w_in, const float* b_in,
    const void* w_rs, const float* dx_next, const float* dskip,
    const int* valid_t, float* dx, void* dcond, void* dw_in, float* db_in,
    void* dw_rs, float* db_rs, void* x_p, void* g_p, void* w_in_p,
    void* w_rs_p, void* acts_p, void* dg_p, float* part_in, float* part_rs,
    float* ws, int batch, int T, int C, int K, int dilation, int last,
    int n_splits_t, int split_rows, cudaStream_t stream) {
  if (T <= 0 || batch <= 0 || batch > 65535 || C <= 0 || C % 2 != 0 ||
      K <= 0 || K % 2 != 1 || dilation < 0 || n_splits_t <= 0 ||
      split_rows <= 0 || split_rows % kKC != 0 ||
      static_cast<int64_t>(batch) * n_splits_t > 65535 ||
      static_cast<int64_t>(n_splits_t) * split_rows < T)
    return cudaErrorInvalidValue;
  const int cp = pad64(C);
  const int tiles_t = (T + kTile - 1) / kTile;
  const auto* wi = static_cast<const bf16*>(w_in);
  const auto* wr = static_cast<const bf16*>(w_rs);
  auto* xb = static_cast<bf16*>(x_p);
  auto* gb = static_cast<bf16*>(g_p);
  auto* wib = static_cast<bf16*>(w_in_p);
  auto* wrb = static_cast<bf16*>(w_rs_p);
  auto* ab = static_cast<bf16*>(acts_p);
  auto* dgb = static_cast<bf16*>(dg_p);

  wn_bwd_any_pad_kernel<<<K * cp + cp, kElemThreads, 0, stream>>>(
      wi, wr, wib, wrb, C, K, last);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wn_bwd_any_prep_kernel<<<dim3(tiles_t, batch), kElemThreads, 0, stream>>>(
      x, dx_next, dskip, valid_t, xb, gb, part_rs, T, C, last);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = opt_in_smem(wn_bwd_any_rows_kernel, kRowsSmem, &g_opted_in[0]);
  if (err != cudaSuccess) return err;
  wn_bwd_any_rows_kernel<<<dim3(tiles_t * (cp / 64), batch), kThreads,
                           kRowsSmem, stream>>>(
      xb, static_cast<const bf16*>(cond), wib, b_in, wrb, gb,
      static_cast<bf16*>(dcond), ab, dgb, part_in, T, C, K, dilation, last);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = opt_in_smem(wn_bwd_any_dx_kernel, kDxSmem, &g_opted_in[1]);
  if (err != cudaSuccess) return err;
  wn_bwd_any_dx_kernel<<<dim3(tiles_t * (cp / 64), batch), kThreads, kDxSmem,
                         stream>>>(dgb, wib, dx_next, valid_t, dx, T, C, K,
                                   dilation);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = opt_in_smem(wn_bwd_any_weights_kernel, kWeightsSmem, &g_opted_in[2]);
  if (err != cudaSuccess) return err;
  wn_bwd_any_weights_kernel<<<dim3(weight_tiles(C, K, last),
                                   batch * n_splits_t),
                              kThreads, kWeightsSmem, stream>>>(
      xb, dgb, ab, gb, ws, T, C, K, dilation, last, n_splits_t, split_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int n_rs = last ? C : 2 * C;
  const int64_t outputs = static_cast<int64_t>(K) * C * 2 * C +
                          static_cast<int64_t>(C) * n_rs + 2 * C + n_rs;
  wn_bwd_any_reduce_kernel<<<static_cast<unsigned>(
                                 (outputs + kElemThreads - 1) / kElemThreads),
                             kElemThreads, 0, stream>>>(
      ws, batch * n_splits_t, part_in, part_rs, batch * tiles_t,
      static_cast<bf16*>(dw_in), static_cast<bf16*>(dw_rs), db_in, db_rs, C,
      K, last);
  return cudaGetLastError();
}

// What the loaded build of kernel `which` (0 rows, 1 dx, 2 weights, 3
// reduce, 4 prep, 5 pad) uses, from the CUDA runtime: registers and local
// (spill) bytes per thread, static shared bytes, and the dynamic shared
// bytes its launcher passes.
cudaError_t wn_layer_bwd_any_kernel_info(int which, int* registers,
                                         int* local_bytes,
                                         int* static_smem_bytes,
                                         int* dynamic_smem_bytes) {
  const void* kernel = kernel_for(which, dynamic_smem_bytes);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  *registers = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *static_smem_bytes = static_cast<int>(attr.sharedSizeBytes);
  return cudaSuccess;
}

}  // extern "C"
