// Helpers shared by the flash-attention kernels (flash_fwd.cu and
// flash_bwd.cu): element conversions, bf16 packing, the m16n8k16 mma.sync
// product, 16-byte tile loads into shared memory, and the one-time
// dynamic shared-memory attribute.
//
// Fragment layout of mma.sync m16n8k16 (bf16 in, f32 accumulate), which
// the f32 FMA paths copy so that both types share their index arithmetic:
// lane (g = lane / 4, c = lane % 4) holds
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

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 in one register, lo in the low half (the lower k or n index).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d[0..3] += A (16x16, row) * B (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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
