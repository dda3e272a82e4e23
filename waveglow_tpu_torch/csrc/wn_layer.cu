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
// Built for the model's width only, C = 256 channels.
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
// Design (simple first; made fast in a later change): one block of 256
// threads per (batch row, tile of 32 time rows). Each warp owns 4 rows; lane
// l owns the 8 channels {4l..4l+3} and {128+4l..128+4l+3} of BOTH gate
// halves, so the gate is computed in registers. The 3C-deep conv product
// streams K in chunks of 16 through shared memory (tap rows outside [0, T)
// read as zero); acts are staged in shared memory and feed the res/skip
// product; the epilogue adds the residual, masks rows >= valid_t and
// accumulates the skip. Both modes run f32 FMAs on the CUDA cores (no TF32,
// so parity mode stays exact f32); bf16 operands are widened when staged.
// No tensor cores, TMA or pipelining yet.
//
// Measured on an NVIDIA H100 80GB HBM3 (700 W) by chip_smoke.py, at the
// shape above (d=1): f32 1.00 ms against the 0.41 ms bound (41%), with both
// TF32 switches off; bf16 0.97 ms against the 0.041 ms bound (4%), held by
// the same CUDA-core FMAs. ptxas: 116 (f32) / 113 (bf16) registers, no
// spills, no static shared memory; 67,584 bytes (kSmemBytes) of dynamic
// shared memory per block. wn_layer_kernel_info reports what the loaded
// build uses.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kC = 256;                                      // channels
constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;
constexpr int kTileRows = (kThreads / 32) * kRowsPerThread;  // 32
constexpr int kChunk = 16;                                   // K per stage
constexpr int kPerLane = 8;      // channels per gate half a lane owns
constexpr int kHalf = kC / 2;    // offset of a lane's second block of 4
// taps chunk [kTileRows][kChunk], weight chunk [kChunk][2C], acts
// [kTileRows][C], all f32
constexpr int kSmemBytes =
    sizeof(float) * (kTileRows * kChunk + kChunk * 2 * kC + kTileRows * kC);

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 4 contiguous floats from a 16-byte-aligned address.
__device__ __forceinline__ void load4(float* dst, const float* src) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}

__device__ __forceinline__ void store4(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = make_float4(src[0], src[1], src[2], src[3]);
}

// A lane's 8 channels {c, .., c+3} and {c+kHalf, .., c+kHalf+3} of a row.
__device__ __forceinline__ void load8(float* dst, const float* row, int c) {
  load4(dst, row + c);
  load4(dst + 4, row + c + kHalf);
}

__device__ __forceinline__ void store8(float* row, int c, const float* src) {
  store4(row + c, src);
  store4(row + c + kHalf, src + 4);
}

// The same 8 channels of a float or bf16 global row, widened to f32.
template <typename T>
__device__ __forceinline__ void load8_global(float* dst, const T* row, int c) {
  if constexpr (sizeof(T) == 4) {
    load8(dst, reinterpret_cast<const float*>(row), c);
  } else {
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      dst[h] = __bfloat162float(row[c + h]);
      dst[4 + h] = __bfloat162float(row[c + kHalf + h]);
    }
  }
}

// Copy rows [k0, k0 + kChunk) of a [K, N] weight (float or bf16) into
// shared memory as f32 [kChunk][N].
template <typename T>
__device__ __forceinline__ void stage_weights(float* dst, const T* w, int k0,
                                              int n) {
  const int total = kChunk * n;
  const T* src = w + static_cast<int64_t>(k0) * n;
  if constexpr (sizeof(T) == 4) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < total / 4; i += kThreads) d4[i] = s4[i];
  } else {
    // 8 bf16 (16 bytes) per load
    const uint4* s8 = reinterpret_cast<const uint4*>(src);
    for (int i = threadIdx.x; i < total / 8; i += kThreads) {
      uint4 raw = s8[i];
      const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&raw);
      float4* d4 = reinterpret_cast<float4*>(dst + i * 8);
      d4[0] = make_float4(__bfloat162float(b[0]), __bfloat162float(b[1]),
                          __bfloat162float(b[2]), __bfloat162float(b[3]));
      d4[1] = make_float4(__bfloat162float(b[4]), __bfloat162float(b[5]),
                          __bfloat162float(b[6]), __bfloat162float(b[7]));
    }
  }
}

// W is the operand type (float or bf16) of cond, w_in and w_rs; kBf16 rounds
// the taps and acts to bf16; kLast selects the [C, C] res/skip of the last
// layer.
template <typename W, bool kBf16, bool kLast>
__global__ void __launch_bounds__(kThreads)
wn_layer_kernel(const float* __restrict__ x, const W* __restrict__ cond,
                const W* __restrict__ w_in, const float* __restrict__ b_in,
                const W* __restrict__ w_rs, const float* __restrict__ b_rs,
                const int* __restrict__ valid_t, float* __restrict__ x_out,
                float* skip_out, int accumulate, int T, int dilation) {
  constexpr int C = kC;
  constexpr int N_IN = 2 * C;                 // gate pre-activations
  constexpr int N_RS = kLast ? C : 2 * C;     // res/skip outputs

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* a_tile = smem;                                  // [kTileRows][kChunk]
  float* w_tile = a_tile + kTileRows * kChunk;           // [kChunk][2C]
  float* acts = w_tile + kChunk * N_IN;                  // [kTileRows][C]

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTileRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * kRowsPerThread;                  // first local row
  const int cl = lane * 4;                               // lane's channels

  const float* xb = x + static_cast<int64_t>(b) * T * C;

  // ---- stage 1: pre[rows, 2C] = taps[rows, 3C] @ w_in[3C, 2C] ------------
  float acc_t[kRowsPerThread][kPerLane];  // tanh half
  float acc_s[kRowsPerThread][kPerLane];  // sigmoid half
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) acc_t[i][j] = acc_s[i][j] = 0.f;

  for (int k0 = 0; k0 < 3 * C; k0 += kChunk) {
    const int tap = k0 / C;
    const int ci0 = k0 % C;
    const int off = (tap - 1) * dilation;
    // taps chunk: kTileRows x kChunk floats, one float4 per thread (128 used)
    if (threadIdx.x < kTileRows * kChunk / 4) {
      const int r = threadIdx.x / (kChunk / 4);
      const int q = threadIdx.x % (kChunk / 4);
      const int t = t0 + r + off;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t >= 0 && t < T) {
        v = *reinterpret_cast<const float4*>(
            xb + static_cast<int64_t>(t) * C + ci0 + q * 4);
        if constexpr (kBf16) {
          v.x = round_bf16(v.x); v.y = round_bf16(v.y);
          v.z = round_bf16(v.z); v.w = round_bf16(v.w);
        }
      }
      *reinterpret_cast<float4*>(a_tile + r * kChunk + q * 4) = v;
    }
    stage_weights<W>(w_tile, w_in, k0, N_IN);
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 4) {
      float a[kRowsPerThread][4];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        load4(a[i], a_tile + (r0 + i) * kChunk + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* wrow = w_tile + (kk + u) * N_IN;
        float wt[kPerLane], ws[kPerLane];
        load8(wt, wrow, cl);
        load8(ws, wrow + C, cl);
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
          for (int j = 0; j < kPerLane; ++j) {
            acc_t[i][j] = fmaf(a[i][u], wt[j], acc_t[i][j]);
            acc_s[i][j] = fmaf(a[i][u], ws[j], acc_s[i][j]);
          }
      }
    }
    __syncthreads();
  }

  // ---- gate (f32), acts staged in shared memory --------------------------
  {
    float bt[kPerLane], bs[kPerLane];
    load8(bt, b_in, cl);
    load8(bs, b_in + C, cl);
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int t = t0 + r0 + i;
      float ct[kPerLane], cs[kPerLane];
      if (t < T) {
        const W* crow = cond + (static_cast<int64_t>(b) * T + t) * N_IN;
        load8_global<W>(ct, crow, cl);
        load8_global<W>(cs, crow + C, cl);
      } else {
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) ct[j] = cs[j] = 0.f;
      }
      float out[kPerLane];
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const float gt = acc_t[i][j] + bt[j] + ct[j];
        const float gs = acc_s[i][j] + bs[j] + cs[j];
        float v = tanhf(gt) * (1.f / (1.f + expf(-gs)));
        if constexpr (kBf16) v = round_bf16(v);
        out[j] = v;
      }
      store8(acts + (r0 + i) * C, cl, out);
    }
  }

  // ---- stage 2: rs[rows, N_RS] = acts[rows, C] @ w_rs[C, N_RS] -----------
  // acc_t is reused for the residual half (or the last layer's skip), acc_s
  // for the skip half.
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) acc_t[i][j] = acc_s[i][j] = 0.f;

  for (int k0 = 0; k0 < C; k0 += kChunk) {
    stage_weights<W>(w_tile, w_rs, k0, N_RS);
    __syncthreads();  // also orders the acts writes before the first reads
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 4) {
      float a[kRowsPerThread][4];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        load4(a[i], acts + (r0 + i) * C + k0 + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* wrow = w_tile + (kk + u) * N_RS;
        float wr[kPerLane];
        load8(wr, wrow, cl);
        if constexpr (kLast) {
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
            for (int j = 0; j < kPerLane; ++j)
              acc_t[i][j] = fmaf(a[i][u], wr[j], acc_t[i][j]);
        } else {
          float wk[kPerLane];
          load8(wk, wrow + C, cl);
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
            for (int j = 0; j < kPerLane; ++j) {
              acc_t[i][j] = fmaf(a[i][u], wr[j], acc_t[i][j]);
              acc_s[i][j] = fmaf(a[i][u], wk[j], acc_s[i][j]);
            }
        }
      }
    }
    __syncthreads();
  }

  // ---- epilogue: residual, valid_t mask, skip accumulation ---------------
  const int valid = valid_t != nullptr ? valid_t[b] : T;
  float br[kPerLane], bk[kPerLane];
  load8(br, b_rs, cl);
  if constexpr (!kLast) load8(bk, b_rs + C, cl);
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int t = t0 + r0 + i;
    if (t >= T) continue;
    const int64_t row = (static_cast<int64_t>(b) * T + t) * C;
    float xv[kPerLane], skip[kPerLane];
    load8(xv, x + row, cl);
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      if constexpr (kLast) {
        skip[j] = acc_t[i][j] + br[j];
      } else {
        xv[j] += acc_t[i][j] + br[j];
        skip[j] = acc_s[i][j] + bk[j];
      }
      if (t >= valid) xv[j] = 0.f;
    }
    store8(x_out + row, cl, xv);
    if (accumulate) {
      float prev[kPerLane];
      load8(prev, skip_out + row, cl);
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) skip[j] += prev[j];
    }
    store8(skip_out + row, cl, skip);
  }
}

template <typename W, bool kBf16, bool kLast>
cudaError_t launch(const float* x, const void* cond, const void* w_in,
                   const float* b_in, const void* w_rs, const float* b_rs,
                   const int* valid_t, float* x_out, float* skip_out,
                   int accumulate, int batch, int T, int dilation,
                   cudaStream_t stream) {
  auto kernel = wn_layer_kernel<W, kBf16, kLast>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  dim3 grid((T + kTileRows - 1) / kTileRows, batch);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      x, static_cast<const W*>(cond), static_cast<const W*>(w_in), b_in,
      static_cast<const W*>(w_rs), b_rs, valid_t, x_out, skip_out, accumulate,
      T, dilation);
  return cudaGetLastError();
}

// The kernel instantiation for (bf16, last), as a function pointer.
const void* kernel_for(int bf16, int last) {
  if (bf16) {
    return last ? reinterpret_cast<const void*>(
                      wn_layer_kernel<__nv_bfloat16, true, true>)
                : reinterpret_cast<const void*>(
                      wn_layer_kernel<__nv_bfloat16, true, false>);
  }
  return last ? reinterpret_cast<const void*>(wn_layer_kernel<float, false, true>)
              : reinterpret_cast<const void*>(wn_layer_kernel<float, false, false>);
}

}  // namespace

extern "C" {

// Shapes: x, x_out, skip_out [batch, T, C] f32; cond [batch, T, 2C]; w_in
// [3C, 2C]; b_in [2C] f32; w_rs [C, 2C] or [C, C] (last); b_rs likewise f32;
// valid_t [batch] int32 or null. cond/w_in/w_rs are bf16 when bf16 != 0,
// else f32. accumulate != 0 adds into skip_out (in place). C must be 256.
// All pointers 16-byte aligned and contiguous. Launches on `stream`, does
// not synchronise; returns the launch error.
cudaError_t wn_layer_forward(const float* x, const void* cond,
                             const void* w_in, const float* b_in,
                             const void* w_rs, const float* b_rs,
                             const int* valid_t, float* x_out,
                             float* skip_out, int accumulate, int batch,
                             int T, int C, int dilation, int bf16, int last,
                             cudaStream_t stream) {
  if (C != kC || T <= 0 || batch <= 0 || batch > 65535)
    return cudaErrorInvalidValue;
#define WN_LAUNCH(W, BF, LAST)                                                \
  return launch<W, BF, LAST>(x, cond, w_in, b_in, w_rs, b_rs, valid_t, x_out, \
                             skip_out, accumulate, batch, T, dilation, stream)
  if (bf16) {
    if (last) WN_LAUNCH(__nv_bfloat16, true, true);
    WN_LAUNCH(__nv_bfloat16, true, false);
  }
  if (last) WN_LAUNCH(float, false, true);
  WN_LAUNCH(float, false, false);
#undef WN_LAUNCH
}

// What the loaded build of the (bf16, last) kernel uses, read from the CUDA
// runtime: registers per thread, local (spill) bytes per thread, static
// shared bytes, and the dynamic shared bytes the launcher passes.
cudaError_t wn_layer_kernel_info(int bf16, int last, int* registers,
                                 int* local_bytes, int* static_smem_bytes,
                                 int* dynamic_smem_bytes) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel_for(bf16, last));
  if (err != cudaSuccess) return err;
  *registers = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *static_smem_bytes = static_cast<int>(attr.sharedSizeBytes);
  *dynamic_smem_bytes = kSmemBytes;
  return cudaSuccess;
}

}  // extern "C"
