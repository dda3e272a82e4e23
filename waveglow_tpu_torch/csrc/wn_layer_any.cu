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
// C, K, the dilation d, B and T are runtime arguments. Global layouts: x,
// x', skip [B, T, C], cond [B, T, 2C], w_in [K*C, 2C], w_rs [C, 2C] (last
// layer [C, C]), all row-major. x, x', b_in, b_rs and the skip sum are f32.
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
// Design: right and simple, one block per (batch row, tile of 64 time rows),
// the channels in passes of 64. Nothing here is tuned; making it fast is
// later work.
//   * Gate: for each pass p of 64 gate channels, pre [64 rows, 64 tanh + 64
//     sigmoid columns] accumulates over the K*C deep product in K chunks
//     (tap, channel block). Each tap's rows are loaded on their own from
//     global memory (rows of the row's own sequence, zero outside [0, T)):
//     taps reach +-(K/2)*d rows, up to +-384 at K = 7 and d = 128, so no
//     halo window is staged. While one chunk is multiplied the next one
//     copies into the other of two shared buffers by cp.async, nothing
//     staged in registers: the weights as they are, the f32 taps
//     transposed in f32, and in bf16 into an f32 staging area that each
//     thread then rounds into the bf16 operand; one barrier a chunk. The
//     gate runs in f32 on the accumulators and writes the pass's acts into
//     shared memory.
//   * The acts of all C channels of the tile stay in shared memory; the
//     res/skip product reads them from there in passes of 64 output
//     channels (the residual's with the skip's of the same channels; the
//     last layer's 64 skip channels), K = C, then the epilogue adds b_rs,
//     the residual and the skip sum in f32, masks rows >= valid_t and writes
//     rows < T only.
//   * Any even C: a 64-channel block past C is zero-filled in shared memory
//     (taps, weight rows and columns, acts), so C = 48 or 200 is exact. An
//     f32 row of x is 4C bytes and a bf16 weight row's sigmoid half starts
//     2C bytes in, so C = 50 allows no 16-byte copy: the taps copy as
//     single floats (f32, transposed) or 8-byte pairs (bf16), and the
//     weights in 16-byte pieces where C allows (C % 4 == 0 in f32, C % 8 ==
//     0 in bf16), else in pairs (8 or 4 bytes), which C even keeps
//     aligned; a warp's copies are contiguous.
//   * wn_any_kernel_f32<last> (parity mode): true f32 FMAs on the CUDA
//     cores, 256 threads, a thread 4 rows x 4 channels of each half (32
//     accumulators), K chunks of 16 rows; the taps and the acts held
//     transposed ([channel][row]) so a thread's 4 rows are one 16-byte read.
//   * wn_any_kernel_bf16<last> (fast mode): one warpgroup (128 threads),
//     wgmma m64n64k16 with both operands in shared memory in the 128-byte
//     swizzle of sm90_wgmma.cuh (A: the taps or the acts, K-major; B: the
//     weights, MN-major), K chunks of 64; every chunk's wgmmas are waited
//     for before the next chunk's taps are rounded into the other buffer,
//     so no wgmma is in flight across the loop's back edge.
//
// Shared memory caps C (the acts of a 64-row tile at all C channels): the
// f32 kernel's at kMaxC = 704 (AnyF32::smem), the bf16 kernel's at 1,280
// (AnyBf16::smem); kernels/wn_layer.py's ANY_MAX_C names both, and the
// wrapper refuses a wider C.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

#include "f32_ring.cuh"
#include "sm90_wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;  // time rows of a block
constexpr int kPass = 64;  // channels of a gate or res/skip pass

struct AnyF32 {
  static constexpr int kThreads = 256;
  static constexpr int kKC = 16;                       // K rows of a chunk
  static constexpr int kLd = kTile + 4;                // floats a row of A / acts
  static constexpr int kAFloats = kKC * kLd;           // [16 k][68]
  static constexpr int kBFloats = kKC * 2 * kPass;     // [16 k][128]
  static constexpr int kMaxC = 704;
  static constexpr int smem(int cpad) {
    return (2 * kAFloats + 2 * kBFloats + cpad * kLd) * 4;
  }
};
static_assert(AnyF32::smem(AnyF32::kMaxC) <= 232448,
              "over the 227 KB a block may use");
static_assert(AnyF32::smem(AnyF32::kMaxC + kPass) > 232448,
              "kMaxC is the largest fit");

struct AnyBf16 {
  static constexpr int kThreads = 128;
  static constexpr int kKC = 64;               // K of a chunk
  static constexpr int kABytes = kTile * 128;  // [64 rows][64 K] K-major
  static constexpr int kNBlock = 64 * 128;     // [64 K][64 N] MN-major
  static constexpr int kBBytes = 2 * kNBlock;  // two N blocks
  static constexpr int kFBytes = kTile * kKC * 4;  // the f32 taps staged
  static constexpr int kMaxC = 1280;
  static constexpr int smem(int cpad) {
    return 2 * kABytes + 2 * kBBytes + kFBytes + cpad / kPass * kABytes;
  }
};
static_assert(AnyBf16::smem(AnyBf16::kMaxC) <= 232448,
              "over the 227 KB a block may use");
static_assert(AnyBf16::smem(AnyBf16::kMaxC + kPass) > 232448,
              "kMaxC is the largest fit");

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

// Byte offset of the pair (row, 2i) in a 128-byte-swizzled row of 64 bf16:
// a K-major A tile (row = M row, column = K) or a K row of an MN-major B
// block (row = K row, column = N).
__device__ __forceinline__ int sw_off(int row, int col) {
  return row * 128 + (((col / 8) ^ (row % 8)) * 16) + (col % 8) * 2;
}

// cp.async of kBytes (4, 8 or 16) from `src` when `valid`, else kBytes zero
// bytes (nothing is read).
template <int kBytes>
__device__ __forceinline__ void cp_async_zfill(uint32_t dst, const void* src,
                                               bool valid) {
  if constexpr (kBytes == 16) {
    cp_async16_zfill(dst, src, valid);
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(kBytes), "r"(valid ? kBytes : 0));
  }
}

// The K loop of one product: n chunks in two shared buffers. `issue(j,
// buf)` starts chunk j's cp.async copies into buffer `buf` (the bf16
// kernel's taps into an f32 staging area); `round(buf)` turns the thread's
// own copies of the staged taps into buffer `buf`'s bf16 A (nothing in
// f32); `mul(j, buf)` multiplies chunk j from buffer `buf` into the
// accumulators. Chunk j + 1 copies while chunk j is multiplied; one barrier
// a chunk, before which the thread's copies are done and (kFence) handed to
// the async proxy, where the bf16 kernel's wgmma reads them. Nothing is
// staged in registers. Returns after a barrier, with every chunk
// multiplied.
template <bool kFence, typename Issue, typename Round, typename Mul>
__device__ __forceinline__ void chunks(int n, const Issue& issue,
                                       const Round& round, const Mul& mul) {
  issue(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  round(0);
  if constexpr (kFence) fence_proxy_async();
  __syncthreads();
#pragma unroll 1
  for (int j = 0; j < n; ++j) {
    // past the last barrier every thread is done with buffer (j + 1) & 1
    // and with the staging area
    if (j + 1 < n) issue(j + 1, (j + 1) & 1);
    cp_async_commit();
    mul(j, j & 1);
    cp_async_wait<0>();
    if (j + 1 < n) round((j + 1) & 1);
    if constexpr (kFence) fence_proxy_async();
    __syncthreads();
  }
}

// cp.async the taps of a chunk: row r of the tile and channel c of the
// chunk's kCh (from c0) is x[t0 + r + shift][c0 + c] of the sequence, zero
// outside [0, T) and past channel C, landing at `dst(r, c)`. kW floats a
// copy (C even keeps two aligned). A thread copies one column piece of rows
// rf, rf + kStep, ... (see copy_weights).
template <int kW, int kThreads, int kCh, typename Dst>
__device__ __forceinline__ void copy_taps(const Dst& dst, const float* x,
                                          int64_t seq, int T, int C, int t0,
                                          int64_t shift, int c0) {
  constexpr int kPer = kCh / kW;            // copies a row
  constexpr int kStep = kThreads / kPer;    // rows between a thread's copies
  static_assert(kThreads % kPer == 0 && kTile % kStep == 0, "whole rounds");
  const int c = (threadIdx.x % kPer) * kW, rf = threadIdx.x / kPer;
  const bool col_ok = c0 + c < C;
  const int64_t s0 = t0 + rf + shift;
#pragma unroll 4
  for (int i = 0; i < kTile / kStep; ++i) {
    const int64_t s = s0 + i * kStep;
    const bool ok = col_ok && s >= 0 && s < T;
    cp_async_zfill<kW * 4>(dst(rf + i * kStep, c),
                           ok ? x + (seq + s) * C + c0 + c : x, ok);
  }
}

// cp.async a weight chunk of kRows K rows into a shared B buffer: K row k
// is row row0 + k of `w` (rows `ld` values apart), its half h the 64
// columns from column c_h of that row (c1 < 0: no second half), landing at
// `dst(h, k, n)` for column n of the half; zero past row C - k0 and past
// channel C - ch0. Pieces of kW values: 16 bytes where C allows, else two
// values. A thread copies one column piece of rows kf, kf + kStep, ...,
// its source one pointer stepping down the rows (a copy a row apart
// computes no address of its own, which kept ptxas from holding one for
// each of the 32 two-value copies of a bf16 chunk and spilling them).
template <int kW, int kThreads, int kRows, typename T, typename Dst>
__device__ __forceinline__ void copy_weights(const Dst& dst, const T* w,
                                             int64_t ld, int k0, int row0,
                                             int c0, int c1, int ch0, int C) {
  constexpr int kPer = 2 * kPass / kW;      // pieces a K row
  constexpr int kStep = kThreads / kPer;    // K rows between a thread's pieces
  static_assert(kThreads % kPer == 0 && kRows % kStep == 0, "whole rounds");
  const int piece = threadIdx.x % kPer, kf = threadIdx.x / kPer;
  const int h = piece / (kPer / 2), n = (piece % (kPer / 2)) * kW;
  const bool col_ok = ch0 + n < C && (h == 0 || c1 >= 0);
  const T* src = w + (row0 + kf) * ld + (h ? c1 : c0) + n;
  const int64_t step = kStep * ld;
#pragma unroll 4
  for (int i = 0; i < kRows / kStep; ++i) {
    const int k = kf + i * kStep;
    const bool ok = col_ok && k0 + k < C;
    cp_async_zfill<static_cast<int>(kW * sizeof(T))>(
        dst(h, k, n), ok ? src + i * step : w, ok);
  }
}

// ---- f32 (parity mode) ----------------------------------------------------------

template <bool kLast>
__global__ void __launch_bounds__(AnyF32::kThreads, 1)
wn_any_kernel_f32(const float* __restrict__ x, const float* __restrict__ cond,
                  const float* __restrict__ w_in,
                  const float* __restrict__ b_in,
                  const float* __restrict__ w_rs,
                  const float* __restrict__ b_rs,
                  const int* __restrict__ valid_t, float* __restrict__ x_out,
                  float* skip_out, int accumulate, int T, int C, int K,
                  int dilation) {
  using L = AnyF32;
  extern __shared__ __align__(16) float smem_f32[];
  float* const as = smem_f32;                      // [2][kKC][kLd]: A^T
  float* const bs = as + 2 * L::kAFloats;          // [2][kKC][128]
  float* const acts = bs + 2 * L::kBFloats;        // [Cpad][kLd]: acts^T
  const uint32_t as_u32 = smem_u32(as), bs_u32 = smem_u32(bs);
  const int b = blockIdx.y, t0 = blockIdx.x * kTile;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;  // rows 4tr, ch 4tc
  const int passes = (C + kPass - 1) / kPass;
  const int kchunks = (C + L::kKC - 1) / L::kKC;   // K chunks of C channels
  const int64_t seq = static_cast<int64_t>(b) * T;  // the sequence's first row
  const int n_rs = kLast ? C : 2 * C;
  const bool vec = C % 4 == 0;  // 16-byte weight pieces

  // a weight chunk into B buffer `buf`
  const auto weights = [&](int buf, const float* w, int64_t ld, int k0,
                           int row0, int c0, int c1, int ch0) {
    const uint32_t b0 = bs_u32 + buf * L::kBFloats * 4;
    const auto dst = [&](int h, int k, int n) {
      return b0 + (k * 2 * kPass + h * kPass + n) * 4;
    };
    if (vec)
      copy_weights<4, L::kThreads, L::kKC>(dst, w, ld, k0, row0, c0, c1,
                                            ch0, C);
    else
      copy_weights<2, L::kThreads, L::kKC>(dst, w, ld, k0, row0, c0, c1,
                                            ch0, C);
  };
  // 32 FMAs a K row: the thread's 4 rows (a: A^T from row 4 tr) x its 4
  // channels of each half (w: from column 4 tc)
  const auto fma_rows = [&](float (&acc_a)[4][4], float (&acc_b)[4][4],
                            const float* a, const float* w, bool paired) {
#pragma unroll
    for (int k = 0; k < L::kKC; ++k) {
      float av[4], wa[4], wb[4];
      load4(av, a + k * L::kLd);
      load4(wa, w + k * 2 * kPass);
      load4(wb, w + k * 2 * kPass + kPass);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc_a[i][j] = fmaf(av[i], wa[j], acc_a[i][j]);
          if (paired) acc_b[i][j] = fmaf(av[i], wb[j], acc_b[i][j]);
        }
    }
  };

  // ---- the gate, in passes of 64 channels -------------------------------------
#pragma unroll 1
  for (int p = 0; p < passes; ++p) {
    float acc_t[4][4] = {}, acc_s[4][4] = {};
    const int ch0 = p * kPass;
    const auto issue = [&](int j, int buf) {
      const int tap = j / kchunks, c0 = (j % kchunks) * L::kKC;
      const int64_t shift = static_cast<int64_t>(tap - K / 2) * dilation;
      weights(buf, w_in, 2 * C, c0, tap * C + c0, ch0, C + ch0, ch0);
      const uint32_t a0 = as_u32 + buf * L::kAFloats * 4;
      copy_taps<1, L::kThreads, L::kKC>(
          [&](int r, int c) { return a0 + (c * L::kLd + r) * 4; }, x, seq, T,
          C, t0, shift, c0);
    };
    chunks<false>(K * kchunks, issue, [](int) {}, [&](int, int buf) {
      fma_rows(acc_t, acc_s, as + buf * L::kAFloats + 4 * tr,
               bs + buf * L::kBFloats + 4 * tc, true);
    });
    // the gate in f32; acts^T of the pass's 64 channels (zero past C and
    // past T)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ch = ch0 + 4 * tc + j;
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + 4 * tr + i;
        v[i] = 0.f;
        if (t < T && ch < C) {
          const float* cr = cond + (seq + t) * 2 * C;
          const float gt = acc_t[i][j] + b_in[ch] + cr[ch];
          const float gs = acc_s[i][j] + b_in[C + ch] + cr[C + ch];
          v[i] = tanhf(gt) * sigmoidf(gs);
        }
      }
      store4(acts + ch * L::kLd + 4 * tr, v);
    }
  }
  // the acts are read by every thread past chunks()'s first barrier

  // ---- the res/skip product, in passes of 64 output channels -----------------
  const int vt = valid_t != nullptr ? valid_t[b] : T;
#pragma unroll 1
  for (int q = 0; q < passes; ++q) {
    float acc_a[4][4] = {}, acc_b[4][4] = {};  // residual | skip (last: skip)
    const int ch0 = q * kPass;
    chunks<false>(
        kchunks,
        [&](int j, int buf) {
          const int k0 = j * L::kKC;
          weights(buf, w_rs, n_rs, k0, k0, ch0, kLast ? -1 : C + ch0, ch0);
        },
        [](int) {},
        [&](int j, int buf) {
          fma_rows(acc_a, acc_b, acts + j * L::kKC * L::kLd + 4 * tr,
                   bs + buf * L::kBFloats + 4 * tc, !kLast);
        });
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + 4 * tr + i;
      if (t >= T) continue;
      const int64_t row = (seq + t) * C;
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        const int ch = ch0 + 4 * tc + j;
        if (ch >= C) continue;  // C even: ch + 1 < C too
        float2 xn = *reinterpret_cast<const float2*>(x + row + ch);
        float2 sk;
        if constexpr (kLast) {
          sk = make_float2(acc_a[i][j] + b_rs[ch],
                           acc_a[i][j + 1] + b_rs[ch + 1]);
        } else {
          xn.x += acc_a[i][j] + b_rs[ch];
          xn.y += acc_a[i][j + 1] + b_rs[ch + 1];
          sk = make_float2(acc_b[i][j] + b_rs[C + ch],
                           acc_b[i][j + 1] + b_rs[C + ch + 1]);
        }
        if (t >= vt) xn = make_float2(0.f, 0.f);
        if (accumulate) {
          const float2 old =
              *reinterpret_cast<const float2*>(skip_out + row + ch);
          sk.x = old.x + sk.x;
          sk.y = old.y + sk.y;
        }
        *reinterpret_cast<float2*>(x_out + row + ch) = xn;
        *reinterpret_cast<float2*>(skip_out + row + ch) = sk;
      }
    }
  }
}

// ---- bf16 (fast mode), wgmma ------------------------------------------------------

template <bool kLast>
__global__ void __launch_bounds__(AnyBf16::kThreads, 1)
wn_any_kernel_bf16(const float* __restrict__ x, const bf16* __restrict__ cond,
                   const bf16* __restrict__ w_in,
                   const float* __restrict__ b_in,
                   const bf16* __restrict__ w_rs,
                   const float* __restrict__ b_rs,
                   const int* __restrict__ valid_t, float* __restrict__ x_out,
                   float* skip_out, int accumulate, int T, int C, int K,
                   int dilation) {
  using L = AnyBf16;
  extern __shared__ __align__(1024) uint4 smem_any[];
  char* const sm = reinterpret_cast<char*>(smem_any);
  const uint32_t base = smem_u32(smem_any);
  // [A0][A1][B0][B1][F: f32 taps][acts: Cpad / 64 K-major blocks], all
  // 1024-aligned
  constexpr int kB = 2 * L::kABytes, kF = kB + 2 * L::kBBytes;
  constexpr int kActs = kF + L::kFBytes;
  const int b = blockIdx.y, t0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  const int passes = (C + kPass - 1) / kPass;  // also the K chunks of C
  const int64_t seq = static_cast<int64_t>(b) * T;
  const int n_rs = kLast ? C : 2 * C;
  const bool vec = C % 8 == 0;  // 16-byte weight pieces

  // a weight chunk into B buffer `buf`
  const auto weights = [&](int buf, const bf16* w, int64_t ld, int k0,
                           int row0, int c0, int c1, int ch0) {
    const uint32_t b0 = base + kB + buf * L::kBBytes;
    const auto dst = [&](int h, int k, int n) {
      return b0 + h * L::kNBlock + sw_off(k, n);
    };
    if (vec)
      copy_weights<8, L::kThreads, L::kKC>(dst, w, ld, k0, row0, c0, c1,
                                            ch0, C);
    else
      copy_weights<2, L::kThreads, L::kKC>(dst, w, ld, k0, row0, c0, c1,
                                            ch0, C);
  };

  // ---- the gate, in passes of 64 channels -------------------------------------
#pragma unroll 1
  for (int p = 0; p < passes; ++p) {
    float acc_t[32], acc_s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_t[i] = acc_s[i] = 0.f;
    const int ch0 = p * kPass;
    const auto issue = [&](int j, int buf) {
      const int tap = j / passes, c0 = (j % passes) * L::kKC;
      const int64_t shift = static_cast<int64_t>(tap - K / 2) * dilation;
      weights(buf, w_in, 2 * C, c0, tap * C + c0, ch0, C + ch0, ch0);
      copy_taps<2, L::kThreads, L::kKC>(
          [&](int r, int c) { return base + kF + (r * L::kKC + c) * 4; }, x,
          seq, T, C, t0, shift, c0);
    };
    // the thread's own staged taps (copy_taps' pieces) rounded into A
    const auto round_taps = [&](int buf) {
      constexpr int kPer = L::kKC / 2, kStep = L::kThreads / kPer;
      const int c = (threadIdx.x % kPer) * 2, rf = threadIdx.x / kPer;
      char* a = sm + buf * L::kABytes;
#pragma unroll 4
      for (int i = 0; i < kTile / kStep; ++i) {
        const int r = rf + i * kStep;
        const float2 v =
            *reinterpret_cast<const float2*>(sm + kF + (r * L::kKC + c) * 4);
        *reinterpret_cast<uint32_t*>(a + sw_off(r, c)) = pack_bf16(v.x, v.y);
      }
    };
    chunks<true>(K * passes, issue, round_taps, [&](int, int buf) {
      const uint32_t a = base + buf * L::kABytes;
      const uint32_t w = base + kB + buf * L::kBBytes;
      fence_acc(acc_t);
      fence_acc(acc_s);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < L::kKC / 16; ++k) {
        const uint64_t da = kmajor_desc(a + k * 32);
        wgmma_m64<64, 0, 1>(acc_t, da,
                            mnmajor_desc(w + k * 2048, L::kNBlock));
        wgmma_m64<64, 0, 1>(
            acc_s, da, mnmajor_desc(w + L::kNBlock + k * 2048, L::kNBlock));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc_t);
      fence_acc(acc_s);
    });
    // the gate in f32 on the accumulators (thread: rows warp*16 + g + 8h,
    // columns 8j + 2tig + {0, 1}); the acts in bf16 into acts block p
    // (zero past C and past T)
    char* blk = sm + kActs + p * L::kABytes;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = warp * 16 + g + 8 * h;
      const int t = t0 + row;
      const bf16* cr = cond + (seq + (t < T ? t : 0)) * 2 * C;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = 8 * j + 2 * tig, ch = ch0 + n;
        float v0 = 0.f, v1 = 0.f;
        if (t < T && ch < C) {
          const float2 ct =
              unpack_bf16(*reinterpret_cast<const uint32_t*>(cr + ch));
          const float2 cs =
              unpack_bf16(*reinterpret_cast<const uint32_t*>(cr + C + ch));
          const float2 bt = *reinterpret_cast<const float2*>(b_in + ch);
          const float2 bsg = *reinterpret_cast<const float2*>(b_in + C + ch);
          v0 = tanhf(acc_t[4 * j + 2 * h] + bt.x + ct.x) *
               sigmoidf(acc_s[4 * j + 2 * h] + bsg.x + cs.x);
          v1 = tanhf(acc_t[4 * j + 2 * h + 1] + bt.y + ct.y) *
               sigmoidf(acc_s[4 * j + 2 * h + 1] + bsg.y + cs.y);
        }
        *reinterpret_cast<uint32_t*>(blk + sw_off(row, n)) = pack_bf16(v0, v1);
      }
    }
  }
  // the acts reach the async proxy and every thread past chunks()'s first
  // fence and barrier

  // ---- the res/skip product, in passes of 64 output channels -----------------
  const int vt = valid_t != nullptr ? valid_t[b] : T;
#pragma unroll 1
  for (int q = 0; q < passes; ++q) {
    float acc_a[32], acc_b[32];  // residual | skip (last: skip)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_a[i] = acc_b[i] = 0.f;
    const int ch0 = q * kPass;
    chunks<true>(
        passes,
        [&](int j, int buf) {
          const int k0 = j * L::kKC;
          weights(buf, w_rs, n_rs, k0, k0, ch0, kLast ? -1 : C + ch0, ch0);
        },
        [](int) {},
        [&](int j, int buf) {
          const uint32_t a = base + kActs + j * L::kABytes;
          const uint32_t w = base + kB + buf * L::kBBytes;
          fence_acc(acc_a);
          if constexpr (!kLast) fence_acc(acc_b);
          wgmma_fence();
#pragma unroll
          for (int k = 0; k < L::kKC / 16; ++k) {
            const uint64_t da = kmajor_desc(a + k * 32);
            wgmma_m64<64, 0, 1>(acc_a, da,
                                mnmajor_desc(w + k * 2048, L::kNBlock));
            if constexpr (!kLast)
              wgmma_m64<64, 0, 1>(
                  acc_b, da,
                  mnmajor_desc(w + L::kNBlock + k * 2048, L::kNBlock));
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_acc(acc_a);
          if constexpr (!kLast) fence_acc(acc_b);
        });
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + warp * 16 + g + 8 * h;
      if (t >= T) continue;
      const int64_t row = (seq + t) * C;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int ch = ch0 + 8 * j + 2 * tig;
        if (ch >= C) continue;  // C even: ch + 1 < C too
        const float a0 = acc_a[4 * j + 2 * h], a1 = acc_a[4 * j + 2 * h + 1];
        float2 xn = *reinterpret_cast<const float2*>(x + row + ch);
        float2 sk;
        if constexpr (kLast) {
          sk = make_float2(a0 + b_rs[ch], a1 + b_rs[ch + 1]);
        } else {
          xn.x += a0 + b_rs[ch];
          xn.y += a1 + b_rs[ch + 1];
          sk = make_float2(acc_b[4 * j + 2 * h] + b_rs[C + ch],
                           acc_b[4 * j + 2 * h + 1] + b_rs[C + ch + 1]);
        }
        if (t >= vt) xn = make_float2(0.f, 0.f);
        if (accumulate) {
          const float2 old =
              *reinterpret_cast<const float2*>(skip_out + row + ch);
          sk.x = old.x + sk.x;
          sk.y = old.y + sk.y;
        }
        *reinterpret_cast<float2*>(x_out + row + ch) = xn;
        *reinterpret_cast<float2*>(skip_out + row + ch) = sk;
      }
    }
  }
}

// The (bf16, last) instance's function pointer, threads, the dynamic
// shared bytes at width C, and the most any width needs (the opt-in).
struct Instance {
  const void* fn;
  int threads, smem, max_smem;
};

Instance instance(int bf16_mode, int last, int C) {
  const int cpad = (C + kPass - 1) / kPass * kPass;
  if (bf16_mode)
    return {last ? reinterpret_cast<const void*>(wn_any_kernel_bf16<true>)
                 : reinterpret_cast<const void*>(wn_any_kernel_bf16<false>),
            AnyBf16::kThreads, AnyBf16::smem(cpad),
            AnyBf16::smem(AnyBf16::kMaxC)};
  return {last ? reinterpret_cast<const void*>(wn_any_kernel_f32<true>)
               : reinterpret_cast<const void*>(wn_any_kernel_f32<false>),
          AnyF32::kThreads, AnyF32::smem(cpad), AnyF32::smem(AnyF32::kMaxC)};
}

std::atomic<uint32_t> g_opted_in[4];

}  // namespace

extern "C" {

// The widest C each mode's kernel takes (its shared memory's cap).
int wn_layer_any_max_channels(int bf16_mode) {
  return bf16_mode ? AnyBf16::kMaxC : AnyF32::kMaxC;
}

// Shapes: x, x_out, skip_out [batch, T, C] f32; cond [batch, T, 2C]; w_in
// [K*C, 2C]; b_in [2C] f32; w_rs [C, 2C] or [C, C] (last); b_rs likewise
// f32; valid_t [batch] int32 or null. cond/w_in/w_rs are bf16 when bf16_mode
// != 0, else f32. C even, at most wn_layer_any_max_channels(bf16_mode); K odd;
// dilation >= 0. accumulate != 0 adds into skip_out (in place). All
// pointers 8-byte aligned and contiguous. Launches one kernel on `stream`,
// does not synchronise; returns the launch error.
cudaError_t wn_layer_any_forward(const float* x, const void* cond,
                                 const void* w_in, const float* b_in,
                                 const void* w_rs, const float* b_rs,
                                 const int* valid_t, float* x_out,
                                 float* skip_out, int accumulate, int batch,
                                 int T, int C, int K, int dilation,
                                 int bf16_mode, int last,
                                 cudaStream_t stream) {
  if (T <= 0 || batch <= 0 || batch > 65535 || C <= 0 || C % 2 != 0 ||
      C > wn_layer_any_max_channels(bf16_mode) || K <= 0 || K % 2 != 1 ||
      dilation < 0)
    return cudaErrorInvalidValue;
  const Instance k = instance(bf16_mode, last, C);
  // one opt-in per (mode, last) instance and device, to the widest C's bytes
  cudaError_t err =
      opt_in_smem(k.fn, k.max_smem, &g_opted_in[2 * (bf16_mode != 0) + (last != 0)]);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kTile - 1) / kTile, batch);
  if (bf16_mode) {
    const auto* c = static_cast<const bf16*>(cond);
    const auto* wi = static_cast<const bf16*>(w_in);
    const auto* wr = static_cast<const bf16*>(w_rs);
    if (last)
      wn_any_kernel_bf16<true><<<grid, k.threads, k.smem, stream>>>(
          x, c, wi, b_in, wr, b_rs, valid_t, x_out, skip_out, accumulate, T,
          C, K, dilation);
    else
      wn_any_kernel_bf16<false><<<grid, k.threads, k.smem, stream>>>(
          x, c, wi, b_in, wr, b_rs, valid_t, x_out, skip_out, accumulate, T,
          C, K, dilation);
  } else {
    const auto* c = static_cast<const float*>(cond);
    const auto* wi = static_cast<const float*>(w_in);
    const auto* wr = static_cast<const float*>(w_rs);
    if (last)
      wn_any_kernel_f32<true><<<grid, k.threads, k.smem, stream>>>(
          x, c, wi, b_in, wr, b_rs, valid_t, x_out, skip_out, accumulate, T,
          C, K, dilation);
    else
      wn_any_kernel_f32<false><<<grid, k.threads, k.smem, stream>>>(
          x, c, wi, b_in, wr, b_rs, valid_t, x_out, skip_out, accumulate, T,
          C, K, dilation);
  }
  return cudaGetLastError();
}

// What the loaded build of the (bf16, last) kernel uses, read from the CUDA
// runtime: registers per thread, local (spill) bytes per thread, static
// shared bytes, and the dynamic shared bytes its launcher passes at width C.
cudaError_t wn_layer_any_kernel_info(int C, int bf16_mode, int last,
                                     int* registers, int* local_bytes,
                                     int* static_smem_bytes,
                                     int* dynamic_smem_bytes) {
  if (C <= 0 || C % 2 != 0 || C > wn_layer_any_max_channels(bf16_mode))
    return cudaErrorInvalidValue;
  const Instance k = instance(bf16_mode, last, C);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, k.fn);
  if (err != cudaSuccess) return err;
  *registers = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *static_smem_bytes = static_cast<int>(attr.sharedSizeBytes);
  *dynamic_smem_bytes = k.smem;
  return cudaSuccess;
}

}  // extern "C"
