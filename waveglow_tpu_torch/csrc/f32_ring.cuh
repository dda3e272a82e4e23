// What the two f32 FFMA kernels share: the forward's wn_layer_kernel_f32
// (wn_layer.cu) and the shard's wn_shard_kernel (wn_layer_shard.cu). Both
// run one wave of blocks over the flat B*T rows, stream K chunks of weight
// rows (with tap rows) through a cp.async ring, one barrier a chunk, and
// run the FMAs of a register tile of rows x (4 "a" + 4 "b") columns from
// the ring's slots. The cp.async helpers also serve the bf16 kernels of
// those two files.
//
// Each source is compiled on its own and includes this file once, so
// everything here lives in the anonymous namespace of that source.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

// ---- cp.async ----------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

// 16 bytes from `src` when `valid`, else 16 zero bytes (nothing is read).
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src,
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

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// ---- the f32 ring and register tile -------------------------------------------

// 4 contiguous floats from a 16-byte-aligned address.
__device__ __forceinline__ void load4(float* dst, const float* src) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}

__device__ __forceinline__ void store4(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = make_float4(src[0], src[1], src[2], src[3]);
}

// cp.async kRows rows of a weight (rows `ld` floats apart from `src`) to
// `dst` as rows of kN floats: columns [a, a + kHalf) of the source row, then
// (when kN = 2 kHalf) columns [b, b + kHalf); 16 bytes a copy.
template <int kRows, int kThreads, int kN, int kHalf>
__device__ __forceinline__ void copy_rows(uint32_t dst, const float* src,
                                          int ld, int a, int b) {
  constexpr int kPieces = kRows * kN / 4;
#pragma unroll
  for (int i = 0; i < (kPieces + kThreads - 1) / kThreads; ++i) {
    const int p = threadIdx.x + i * kThreads;
    if (kPieces % kThreads == 0 || p < kPieces) {
      const int r = p / (kN / 4), col = (p % (kN / 4)) * 4;
      const int from = col < kHalf ? a + col : b + col - kHalf;
      cp_async16(dst + p * 16, src + static_cast<int64_t>(r) * ld + from);
    }
  }
}

// The ring's first kAhead chunks: `load(c)` starts the copies of chunk c
// into its slot; one commit group a chunk (empty past the last one).
template <int kAhead, typename Load>
__device__ __forceinline__ void ring_prologue(int n_chunks, const Load& load) {
  for (int c = 0; c < kAhead; ++c) {
    if (c < n_chunks) load(c);
    cp_async_commit();
  }
}

// One step of a ring of kAhead + 1 slots, at chunk `chunk`: wait for this
// thread's copies of it and make them block-wide. Past the barrier every
// thread is done with chunk - 1, so its slot takes chunk + kAhead. One
// commit group a step (empty past the last chunk), so the wait count stays
// kAhead - 1.
template <int kAhead, typename Load>
__device__ __forceinline__ void ring_step(int chunk, int n_chunks,
                                          const Load& load) {
  cp_async_wait<kAhead - 1>();
  __syncthreads();
  if (chunk + kAhead < n_chunks) load(chunk + kAhead);
  cp_async_commit();
}

// k = kk..kk+3 of a register tile: acc_a[i][j] += a[row kRL*i][k] *
// w[k][j] and, when kPaired, acc_b[i][j] += a[row kRL*i][k] * w[k][kBOff +
// j]. `a` points at the thread's first row (rows kStride floats apart), `w`
// at its first column (rows kN floats apart). A weight value read from
// shared memory feeds kR rows of FMAs.
template <int kR, int kRL, int kStride, int kN, int kBOff, bool kPaired>
__device__ __forceinline__ void tile_fma4(float (&acc_a)[kR][4],
                                          float (&acc_b)[kR][4],
                                          const float* a, const float* w,
                                          int kk) {
  float av[kR][4];
#pragma unroll
  for (int i = 0; i < kR; ++i) load4(av[i], a + kRL * i * kStride + kk);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    float wa[4], wb[4];
    load4(wa, w + (kk + u) * kN);
    if constexpr (kPaired) load4(wb, w + (kk + u) * kN + kBOff);
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc_a[i][j] = fmaf(av[i][u], wa[j], acc_a[i][j]);
        if constexpr (kPaired)
          acc_b[i][j] = fmaf(av[i][u], wb[j], acc_b[i][j]);
      }
  }
}

// ---- launch ------------------------------------------------------------------

// The opt-in to more than 48 KB of dynamic shared memory, made once per
// kernel and device (bit `device` of `*done`), not on every launch.
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, int bytes, std::atomic<uint32_t>* done) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const uint32_t bit = 1u << (device & 31);
  if (done->load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done->fetch_or(bit, std::memory_order_release);
  return err;
}

// Blocks of `kernel` the current device holds at once, as SMs and blocks an
// SM (the occupancy API, after the shared-memory opt-in). The caller keeps
// one `cache` (sms * 256 + per_sm; 0 until read) and `opted_in` per kernel,
// so each is read once per device.
template <typename Kernel>
cudaError_t wave_slots(Kernel kernel, int threads, int smem_bytes,
                       std::atomic<int> (&cache)[32],
                       std::atomic<uint32_t>* opted_in, int* sms,
                       int* per_sm) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  int v = cache[device & 31].load(std::memory_order_acquire);
  if (v == 0) {
    err = opt_in_smem(kernel, smem_bytes, opted_in);
    if (err != cudaSuccess) return err;
    int n = 0, k = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&k, kernel, threads,
                                                        smem_bytes);
    if (err != cudaSuccess) return err;
    if (n < 1 || k < 1 || k > 255) return cudaErrorInvalidConfiguration;
    v = n * 256 + k;
    cache[device & 31].store(v, std::memory_order_release);
  }
  *sms = v / 256;
  *per_sm = v % 256;
  return cudaSuccess;
}

// Rows each block takes in one wave of `slots` blocks: an equal share of
// `rows`, rounded up to `quantum`, so no SM runs more than one short tile.
int one_wave_rows(int rows, int slots, int quantum) {
  const int share = (rows + slots - 1) / slots;
  return (share + quantum - 1) / quantum * quantum;
}

}  // namespace
