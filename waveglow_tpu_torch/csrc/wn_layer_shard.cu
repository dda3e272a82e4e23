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
// over the full C = 256 input channels of x. The partial is the rank's
// share of the res/skip sum, without b_rs and without the residual: the
// caller sums the ranks' partials in a fixed order, then adds b_rs, the
// residual, the valid_t row mask and the skip sum once
// (models/wn.py::wn_forward_tp).
//
// Layouts, row-major: x [B, T, C] f32; cond_s [B, T, 2C'] (tanh columns of
// this rank's channels, then its sigmoid columns); w_in_s [3, C, 2C']; b_in_s
// [2C'] f32; w_rs_s [C', 2C] ([C', C] for the last layer); partial [B, T, 2C]
// ([B, T, C]) f32. cond_s, w_in_s and w_rs_s are f32 (parity mode) or bf16
// (fast mode). In fast mode the taps of x and the acts are rounded to bf16
// before they enter a product, as wn_layer_kernel_mma rounds them; every
// product of two bf16 values is exact in f32, so FFMAs over the converted
// operands give bf16 operands with f32 accumulation. f32 mode is true FFMA,
// no TF32.
//
// What bounds it on an H100 SXM: a non-last layer at B=1, T=26,432 groups
// and C' = 128 does 2*T*(3*C*2C' + C'*2C) = 13.9 GFLOP, 0.21 ms at the 67
// TFLOP/s f32 rate (operation-bound); in bf16 its bytes (x in, cond_s in,
// the partial out) are T*(4C + 2*2C' + 4*2C) = 95 MB, 0.028 ms at 3.35 TB/s
// (byte-bound, the FFMAs on converted bf16 then take the f32 rate's time).
//
// Design (simple first; making it fast is later work): one block of 256
// threads per (batch row, tile of 32 time rows). For each tap the tile's 32
// tap rows of x (zero outside [0, T)) are staged in shared memory; each
// thread holds 2 tanh and the same 2 sigmoid channels of this rank for
// 32 / (256 / (C'/2)) rows, reads its weights through the L1 cache and runs
// the gate on its accumulators. The acts go to shared memory (over the tap
// rows); for the second product each thread holds 4 adjacent output
// columns for 16 (or 8) rows. No atomics and no split K: every output is
// summed in one fixed order, so two launches give the same bits.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kC = 256;                  // input channels (the model's width)
constexpr int kThreads = 256;
constexpr int kRows = 32;                // time rows a block
constexpr int kStride = kC + 4;          // padded shared row: rows 2 apart
                                         // fall 8 banks apart

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <bool kBf16>
__device__ __forceinline__ float operand(float v) {
  if constexpr (kBf16) return __bfloat162float(__float2bfloat16(v));
  return v;
}

// Four adjacent weights as floats (16-byte f32 or 8-byte bf16 load).
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

template <int kCP, bool kBf16, bool kLast>
__global__ void __launch_bounds__(kThreads)
wn_shard_kernel(const float* __restrict__ x,
                const typename std::conditional<kBf16, bf16, float>::type* __restrict__ cond,
                const typename std::conditional<kBf16, bf16, float>::type* __restrict__ w_in,
                const float* __restrict__ b_in,
                const typename std::conditional<kBf16, bf16, float>::type* __restrict__ w_rs,
                float* __restrict__ out, int T, int dilation) {
  constexpr int kIn = 2 * kCP;             // gate columns of this rank
  constexpr int kN = kLast ? kC : 2 * kC;  // partial columns
  constexpr int kPairs = kCP / 2;          // channel pairs: 64, 32, 16
  constexpr int kRG1 = kThreads / kPairs;  // row groups of the gate product
  constexpr int kR1 = kRows / kRG1;        // rows a thread: 8, 4, 2
  constexpr int kCG2 = kN / 4;             // float4 columns of the partial
  constexpr int kRG2 = kThreads / kCG2;
  constexpr int kR2 = kRows / kRG2;        // rows a thread: 16 or 8
  static_assert(kThreads % kPairs == 0 && kRows % kRG1 == 0, "gate grid");
  static_assert(kThreads % kCG2 == 0 && kRows % kRG2 == 0, "partial grid");
  static_assert(kCP + 4 <= kStride, "acts fit in a tap row");

  // tap rows of x during the first product, then the acts [kRows][kCP]
  __shared__ __align__(16) float tile[kRows][kStride];

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int pair = tid % kPairs;
  const int r1 = (tid / kPairs) * kR1;
  const int c0 = 2 * pair;                 // this thread's channels c0, c0+1
  const float* xb = x + static_cast<int64_t>(b) * T * kC;

  float acc[kR1][4];                       // tanh c0, c0+1; sigmoid c0, c0+1
#pragma unroll
  for (int r = 0; r < kR1; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;

  for (int tap = 0; tap < 3; ++tap) {
    const int off = (tap - 1) * dilation;
    __syncthreads();                       // the previous tap's reads are done
    for (int i = tid; i < kRows * (kC / 4); i += kThreads) {
      const int r = i / (kC / 4);
      const int q = i % (kC / 4);
      const int t = t0 + r + off;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t >= 0 && t < T)
        v = __ldg(reinterpret_cast<const float4*>(xb + static_cast<int64_t>(t) * kC) + q);
      v.x = operand<kBf16>(v.x);
      v.y = operand<kBf16>(v.y);
      v.z = operand<kBf16>(v.z);
      v.w = operand<kBf16>(v.w);
      *reinterpret_cast<float4*>(&tile[r][q * 4]) = v;
    }
    __syncthreads();
    const auto* w = w_in + static_cast<int64_t>(tap) * kC * kIn;
#pragma unroll 4
    for (int k = 0; k < kC; ++k) {
      const auto* wk = w + k * kIn;
      const float wt0 = to_f32(wk[c0]), wt1 = to_f32(wk[c0 + 1]);
      const float ws0 = to_f32(wk[kCP + c0]), ws1 = to_f32(wk[kCP + c0 + 1]);
#pragma unroll
      for (int r = 0; r < kR1; ++r) {
        const float xv = tile[r1 + r][k];
        acc[r][0] = fmaf(xv, wt0, acc[r][0]);
        acc[r][1] = fmaf(xv, wt1, acc[r][1]);
        acc[r][2] = fmaf(xv, ws0, acc[r][2]);
        acc[r][3] = fmaf(xv, ws1, acc[r][3]);
      }
    }
  }

  // the gate, in f32, on the accumulators
  float act[kR1][2];
  const float bt0 = b_in[c0], bt1 = b_in[c0 + 1];
  const float bs0 = b_in[kCP + c0], bs1 = b_in[kCP + c0 + 1];
#pragma unroll
  for (int r = 0; r < kR1; ++r) {
    const int t = t0 + r1 + r;
    float ct0 = 0.f, ct1 = 0.f, cs0 = 0.f, cs1 = 0.f;
    if (t < T) {
      const auto* crow = cond + (static_cast<int64_t>(b) * T + t) * kIn;
      ct0 = to_f32(crow[c0]);
      ct1 = to_f32(crow[c0 + 1]);
      cs0 = to_f32(crow[kCP + c0]);
      cs1 = to_f32(crow[kCP + c0 + 1]);
    }
    const float g_t0 = acc[r][0] + bt0 + ct0, g_t1 = acc[r][1] + bt1 + ct1;
    const float g_s0 = acc[r][2] + bs0 + cs0, g_s1 = acc[r][3] + bs1 + cs1;
    act[r][0] = operand<kBf16>(tanhf(g_t0) * (1.f / (1.f + expf(-g_s0))));
    act[r][1] = operand<kBf16>(tanhf(g_t1) * (1.f / (1.f + expf(-g_s1))));
  }
  __syncthreads();                         // every tap row read: reuse tile
#pragma unroll
  for (int r = 0; r < kR1; ++r) {
    tile[r1 + r][c0] = act[r][0];
    tile[r1 + r][c0 + 1] = act[r][1];
  }
  __syncthreads();

  // the partial res/skip product: 4 adjacent columns, kR2 rows a thread
  const int cg = tid % kCG2;
  const int r2 = (tid / kCG2) * kR2;
  float acc2[kR2][4];
#pragma unroll
  for (int r = 0; r < kR2; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc2[r][j] = 0.f;
#pragma unroll 2
  for (int k = 0; k < kCP; ++k) {
    const float4 w4 = load4(w_rs + static_cast<int64_t>(k) * kN + cg * 4);
#pragma unroll
    for (int r = 0; r < kR2; ++r) {
      const float a = tile[r2 + r][k];
      acc2[r][0] = fmaf(a, w4.x, acc2[r][0]);
      acc2[r][1] = fmaf(a, w4.y, acc2[r][1]);
      acc2[r][2] = fmaf(a, w4.z, acc2[r][2]);
      acc2[r][3] = fmaf(a, w4.w, acc2[r][3]);
    }
  }
#pragma unroll
  for (int r = 0; r < kR2; ++r) {
    const int t = t0 + r2 + r;
    if (t < T) {
      float4* dst = reinterpret_cast<float4*>(
          out + (static_cast<int64_t>(b) * T + t) * kN) + cg;
      *dst = make_float4(acc2[r][0], acc2[r][1], acc2[r][2], acc2[r][3]);
    }
  }
}

template <int kCP, bool kBf16, bool kLast>
cudaError_t launch(const float* x, const void* cond, const void* w_in,
                   const float* b_in, const void* w_rs, float* out, int batch,
                   int T, int dilation, cudaStream_t stream) {
  using Op = typename std::conditional<kBf16, bf16, float>::type;
  dim3 grid((T + kRows - 1) / kRows, batch);
  wn_shard_kernel<kCP, kBf16, kLast><<<grid, kThreads, 0, stream>>>(
      x, static_cast<const Op*>(cond), static_cast<const Op*>(w_in), b_in,
      static_cast<const Op*>(w_rs), out, T, dilation);
  return cudaGetLastError();
}

template <int kCP>
const void* kernel_for_width(int bf16_mode, int last) {
  if (bf16_mode)
    return last ? reinterpret_cast<const void*>(wn_shard_kernel<kCP, true, true>)
                : reinterpret_cast<const void*>(wn_shard_kernel<kCP, true, false>);
  return last ? reinterpret_cast<const void*>(wn_shard_kernel<kCP, false, true>)
              : reinterpret_cast<const void*>(wn_shard_kernel<kCP, false, false>);
}

const void* kernel_for(int cp, int bf16_mode, int last) {
  switch (cp) {
    case 128: return kernel_for_width<128>(bf16_mode, last);
    case 64: return kernel_for_width<64>(bf16_mode, last);
    case 32: return kernel_for_width<32>(bf16_mode, last);
    default: return nullptr;
  }
}

template <int kCP>
cudaError_t launch_width(const float* x, const void* cond, const void* w_in,
                         const float* b_in, const void* w_rs, float* out,
                         int batch, int T, int dilation, int bf16_mode,
                         int last, cudaStream_t stream) {
#define WN_SHARD_LAUNCH(BF, LAST) \
  return launch<kCP, BF, LAST>(x, cond, w_in, b_in, w_rs, out, batch, T, \
                               dilation, stream)
  if (bf16_mode) {
    if (last) WN_SHARD_LAUNCH(true, true);
    WN_SHARD_LAUNCH(true, false);
  }
  if (last) WN_SHARD_LAUNCH(false, true);
  WN_SHARD_LAUNCH(false, false);
#undef WN_SHARD_LAUNCH
}

}  // namespace

extern "C" {

// Shapes: x [batch, T, 256] f32; cond [batch, T, 2*cp]; w_in [3, 256, 2*cp];
// b_in [2*cp] f32; w_rs [cp, 512] or [cp, 256] (last != 0); out [batch, T,
// 512] or [batch, T, 256] f32. cond/w_in/w_rs are bf16 when bf16 != 0, else
// f32. cp must be 128, 64 or 32. All pointers 16-byte aligned and
// contiguous. Launches on `stream`, does not synchronise; returns the
// launch error.
cudaError_t wn_layer_shard_forward(const float* x, const void* cond,
                                   const void* w_in, const float* b_in,
                                   const void* w_rs, float* out, int batch,
                                   int T, int cp, int dilation, int bf16,
                                   int last, cudaStream_t stream) {
  if (T <= 0 || batch <= 0 || batch > 65535 ||
      static_cast<int64_t>(batch) * T > INT32_MAX)
    return cudaErrorInvalidValue;
  switch (cp) {
    case 128: return launch_width<128>(x, cond, w_in, b_in, w_rs, out, batch,
                                       T, dilation, bf16, last, stream);
    case 64: return launch_width<64>(x, cond, w_in, b_in, w_rs, out, batch, T,
                                     dilation, bf16, last, stream);
    case 32: return launch_width<32>(x, cond, w_in, b_in, w_rs, out, batch, T,
                                     dilation, bf16, last, stream);
    default: return cudaErrorInvalidValue;
  }
}

// What the loaded build of the (cp, bf16, last) kernel uses, read from the
// CUDA runtime: registers per thread, local (spill) bytes per thread, static
// shared bytes, and the dynamic shared bytes its launcher passes (none).
cudaError_t wn_layer_shard_kernel_info(int cp, int bf16, int last,
                                       int* registers, int* local_bytes,
                                       int* static_smem_bytes,
                                       int* dynamic_smem_bytes) {
  const void* kernel = kernel_for(cp, bf16, last);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  *registers = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *static_smem_bytes = static_cast<int>(attr.sharedSizeBytes);
  *dynamic_smem_bytes = 0;
  return cudaSuccess;
}

}  // extern "C"
