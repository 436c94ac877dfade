// Helpers shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu, flash_step.cu and flash_bwd_step.cu): element conversions,
// e^x for the bf16 kernels, bf16 packing, a warp's f32 product of two
// shared-memory tiles on the FMA units, 16-byte tile loads into shared
// memory, and the one-time dynamic shared-memory attribute. The bf16
// kernels run their products on wgmma over TMA-staged tiles (hopper.cuh)
// and take from here fast_exp, the packing of p, the stores and the
// attribute; the f32 kernels the tile loads and warp_fma.
//
// The f32 products use the fragment layout of mma.sync m16n8k16 (and of
// wgmma's accumulator per warp), so that both types share their index
// arithmetic: lane (g = lane / 4, c = lane % 4) holds
//   A (16 x 16, row major): rows g and g + 8, columns 2c, 2c + 1, 2c + 8,
//     2c + 9;
//   B (16 x 8, column major): rows 2c, 2c + 1, 2c + 8, 2c + 9 of column g;
//   C (16 x 8): rows g and g + 8, columns 2c and 2c + 1.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace gtt {

constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// e^x as one multiply and the SFU's 2^x (ex2.approx: ~2 ulps in f32, and
// 0 for x = -inf), for the bf16 kernels (B1, B2, B6, B7). The precise
// expf takes several more instructions per score, which the softmax of
// every key tile pays: in the chain of one block, that bounded B1 at long
// sequences. p is rounded to bf16 right after, and the tolerances against
// the plain twins' torch.exp hold unchanged (tests/test_torch_attention.py's
// TOL, chip_smoke.py's KERNEL_TOL, BWD_TOL and STEP_TOL).
__device__ __forceinline__ float fast_exp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// Two bf16 in one register, lo in the low half (the lower k or n index).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// acc[j] += A B on the FMA units in f32, for the warp's 16 rows of A and
// the NT 8-column slices of B, in the C fragment layout, summed over K in
// order. A(r, k) = a[r * kAR + k * kAK], B(k, n) = b[k * kBK + n * kBN] in
// shared memory; either operand may be bf16 (widened exactly) or f32.
template <int K, int NT, int kAR, int kAK, int kBK, int kBN, typename TA,
          typename TB>
__device__ __forceinline__ void warp_fma(float (*acc)[4], const TA* a,
                                         const TB* b) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int c2 = 2 * (lane % 4);
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float x0 = to_f32(a[g * kAR + k * kAK]);
    const float x1 = to_f32(a[(g + 8) * kAR + k * kAK]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float y0 = to_f32(b[k * kBK + (j * 8 + c2) * kBN]);
      const float y1 = to_f32(b[k * kBK + (j * 8 + c2 + 1) * kBN]);
      acc[j][0] = fmaf(x0, y0, acc[j][0]);
      acc[j][1] = fmaf(x0, y1, acc[j][1]);
      acc[j][2] = fmaf(x1, y0, acc[j][2]);
      acc[j][3] = fmaf(x1, y1, acc[j][3]);
    }
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Copies rows [row0, row0 + kRows) of a (t, D) slice with row stride
// `stride` into shared memory (row stride kLd), 16 bytes per thread and
// step, with kThreads threads. Rows at or past t are zero, so padded rows
// contribute 0 * 0 and never NaN. With `scale` the values are multiplied
// and rounded back to T.
template <typename T, int D, int kLd, int kRows, int kThreads, bool kScale>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long stride, int row0, int t,
                                          float scale) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < kRows * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < t) {
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * stride + c);
    }
    if constexpr (kScale) {
      T* e = reinterpret_cast<T*>(&val);
#pragma unroll
      for (int j = 0; j < kVec; ++j) e[j] = from_f32<T>(to_f32(e[j]) * scale);
    }
    *reinterpret_cast<uint4*>(dst + r * kLd + c) = val;
  }
}

// Above 48 KB, dynamic shared memory must be allowed per kernel and
// device. Each launcher calls this with its own `done` flags, so the
// attribute is set once per kernel instance and device, not on every
// launch: the small launches of the model are bound by the host.
template <typename Kernel>
cudaError_t allow_dynamic_smem(Kernel kernel, size_t bytes,
                               std::atomic<bool>* done) {
  int dev = 0;
  const cudaError_t got = cudaGetDevice(&dev);
  if (got != cudaSuccess) return got;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev].load(std::memory_order_acquire)) {
    const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (attr != cudaSuccess) return attr;
    done[dev].store(true, std::memory_order_release);
  }
  return cudaSuccess;
}

}  // namespace gtt
