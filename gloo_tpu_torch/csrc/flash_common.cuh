// Helpers shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu,
// flash_step.cu and flash_bwd_step.cu): element conversions of bf16, f16 and
// f32, e^x for the 16-bit kernels, the packing of two 16-bit values into one
// register and an f32 pair's hi/lo split, a warp's f32 product of two
// shared-memory tiles on the FMA units, 16-byte tile loads into shared memory,
// q * scale in place in a staged tile, the grid's row axis past 65535, and the
// one-time dynamic shared-memory attribute. The 16-bit kernels (bf16 and f16,
// one template each) run their products on wgmma over TMA-staged tiles
// (hopper.cuh) and take from here fast_exp, the packing of p, the stores and
// the attribute; the f32 kernels the tile loads and warp_fma.
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
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace gtt {

constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// e^x as one multiply and the SFU's 2^x (ex2.approx: ~2 ulps in f32, and
// 0 for x = -inf), for the 16-bit kernels (B1, B2, B6, B7). The precise
// expf takes several more instructions per score, which the softmax of
// every key tile pays: in the chain of one block, that bounded B1 at long
// sequences. p is rounded to bf16 or f16 right after, and the tolerances
// against the plain twins' torch.exp hold unchanged (tests/
// test_torch_attention.py's TOL, chip_smoke.py's KERNEL_TOL, BWD_TOL and
// STEP_TOL).
__device__ __forceinline__ float fast_exp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// Two T (bf16 or f16) in one register, lo in the low half (the lower k or
// n index); and back.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t bits);
template <>
__device__ __forceinline__ float2 unpack2<__nv_bfloat16>(uint32_t bits) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&bits));
}
template <>
__device__ __forceinline__ float2 unpack2<__half>(uint32_t bits) {
  return __half22float2(*reinterpret_cast<__half2*>(&bits));
}

// f32 a and b as T hi halves (*hi, packed) and the T rounding of what
// they leave (*lo): hi + lo carries ~16 bits of each (bf16), or ~22 (f16)
// where the remainder is a normal f16, down to f16's 2^-24 below that.
template <typename T>
__device__ __forceinline__ void split2(float a, float b, uint32_t* hi,
                                       uint32_t* lo) {
  *hi = pack2<T>(a, b);
  const float2 h = unpack2<T>(*hi);
  *lo = pack2<T>(a - h.x, b - h.y);
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
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// Every element of a staged 16-bit tile of `bytes` bytes times `scale`,
// rounded back to T in place, by kCount threads (the consumers).
template <typename T, int kCount>
__device__ __forceinline__ void scale_in_place(uint8_t* tile, int bytes,
                                               float scale) {
  for (int i = threadIdx.x; i < bytes / 16; i += kCount) {
    uint4* const at = reinterpret_cast<uint4*>(tile) + i;
    uint4 val = *at;
    T* e = reinterpret_cast<T*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = from_f32<T>(to_f32(e[j]) * scale);
    *at = val;
  }
}

// The grid's y axis holds at most 65535 blocks: a launch over `rows` rows
// (b * h, query-head rows) puts them on y and z, (x, min(rows, 65535),
// ceil(rows / 65535)). Up to 65535 rows that is (x, rows, 1), the launch
// as it was; a block whose row (grid_row) is past the end returns first.
constexpr int kMaxGridY = 65535;
inline dim3 rows_grid(int x, long long rows) {
  return dim3(x, static_cast<unsigned>(rows < kMaxGridY ? rows : kMaxGridY),
              static_cast<unsigned>((rows + kMaxGridY - 1) / kMaxGridY));
}
__device__ __forceinline__ int grid_row() {
  return static_cast<int>(blockIdx.z) * kMaxGridY +
         static_cast<int>(blockIdx.y);
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
