// Hopper's asynchronous machinery, shared by the kernels that stage tiles
// with TMA and multiply them with wgmma (overlap.cu's B5a/B5b,
// flash_fwd.cu's B1, flash_bwd.cu's B2, flash_step.cu's B6,
// flash_bwd_step.cu's B7): shared-memory addresses,
// mbarriers, TMA tensor loads, stores and reduce-adds, bulk copies and
// bulk-group waits, proxy fences, named barriers, wgmma descriptors of
// 128-byte-swizzled tiles, the m64n64k16 bf16 and f16 products (A from
// shared memory, K-major or MN-major, or from registers) and their
// accumulator layout, and on the host the tensor-map encoder
// (cuTensorMapEncodeTiled, looked up through the CUDA runtime: nothing new
// to link). Element types on the host side are dtype codes: 0 bf16, 1 f32,
// 2 f16 (ring.SUM_DTYPES' codes).
//
// Every tile is 64 lines of 128 bytes, 128-byte swizzled (TMA's
// CU_TENSOR_MAP_SWIZZLE_128B, wgmma's layout type 1) and 1024-byte
// aligned. A K-major operand's lines are its rows (A) or columns (B), each
// 64 16-bit values of depth: k-step kk of 16 starts 32 kk bytes into the
// line. An MN-major operand's lines are depths, each 64 rows (A) or
// columns (B): k-step kk starts 16 kk lines (2048 kk bytes) in.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only; no libcuda)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

#include "ring_common.cuh"  // kSpinCycles

namespace gtt {

// ---- shared memory, mbarriers, TMA ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// One arrival of the calling thread.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Every thread waits for the phase of parity `parity` to complete; traps
// after ~2 s like the flag spins.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  const long long start = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > kSpinCycles) __trap();
  }
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_addr(dst)),
      "l"(map), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_addr(dst)),
      "l"(map), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes),
      "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];" ::"l"(map),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// The box of `map` at {c0, c1, c2} += the f32 tile at `src` (the map's
// layout, 128-byte swizzled), in this thread's open bulk group; elements
// outside the tensor are left alone. Adds from different blocks to one
// element land in no fixed order, as atomics do.
__device__ __forceinline__ void tma_reduce_add_3d(const CUtensorMap* map,
                                                  const void* src, int c0,
                                                  int c1, int c2) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.tile.bulk_group"
      " [%0, {%2, %3, %4}], [%1];" ::"l"(map),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// The bulk stores so far have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// The bulk stores so far are complete in global memory.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Orders this thread's async-proxy (TMA) accesses of global memory with
// its generic ones: after a TMA store before the release flag, after an
// acquire before a TMA load.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

// Makes this thread's generic writes to shared memory visible to the
// async proxy (wgmma's and TMA's reads of it).
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Named barrier `id` among kCount threads (a multiple of 32): the
// consumer warpgroups of a block sync without the producer warp.
template <int kCount>
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(kCount) : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];" ::"l"(map) : "memory");
}

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  const uint32_t a = smem_addr(raw);
  return raw + ((1024 - (a & 1023)) & 1023);
}

// ---- wgmma ----

// A wgmma descriptor of a 128-byte-swizzled tile at shared address `addr`:
// 8-row groups 1024 bytes apart (SBO; LBO is the same, and unused by these
// 64-wide tiles).
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma.
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The two wgmma forms (A from shared memory, or from registers), spelled
// once for both operand types (TY: bf16 or f16).
#define GTT_WGMMA_ACC                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),        \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),    \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),    \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),    \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),    \
      "+f"(d[31])
#define GTT_WGMMA_REGS                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31}"
#define GTT_WGMMA_SS(TY)                                                \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"            \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY  \
               " " GTT_WGMMA_REGS ", %32, %33, p, 1, 1, %36, %35;\n}\n" \
               : GTT_WGMMA_ACC                                          \
               : "l"(da), "l"(db), "r"(1), "n"(kTransB), "n"(kTransA))
#define GTT_WGMMA_RS(TY)                                                   \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"               \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY     \
               " " GTT_WGMMA_REGS                                          \
               ", {%32, %33, %34, %35}, %36, p, 1, 1, %37;\n}\n"          \
               : GTT_WGMMA_ACC                                             \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),      \
                 "n"(kTransB), "r"(1))

// d += A (64 x 16) B (16 x 64), T (bf16 or f16) in, f32 accumulate, both
// from shared memory; B K-major (kTransB 0) or MN-major (1), A K-major
// (kTransA 0) or MN-major (1).
template <int kTransB, int kTransA = 0, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_bf16(float* d, uint64_t da,
                                           uint64_t db) {
  static_assert(std::is_same<T, __nv_bfloat16>::value ||
                std::is_same<T, __half>::value);
  if constexpr (std::is_same<T, __half>::value) {
    GTT_WGMMA_SS("f16");
  } else {
    GTT_WGMMA_SS("bf16");
  }
}

// d += A (64 x 16, from registers) B (16 x 64), T in, f32 accumulate;
// B K-major (kTransB 0) or MN-major (1). Thread (warp w, lane l) holds A's
// rows 16 w + l / 4 (+ 8) and columns 2 (l % 4) (+ 8), +1, as mma.sync's
// m16n8k16 A fragment: a[0] row +0 cols +0, a[1] row +8 cols +0, a[2] row
// +0 cols +8, a[3] row +8 cols +8, each two T (the lower column in the
// low half). That is the accumulator layout of two adjacent 8-column
// slices (acc_row, acc_col), so a product's result feeds the next one
// without leaving registers.
template <int kTransB, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_bf16_rs(float* d, const uint32_t* a,
                                              uint64_t db) {
  static_assert(std::is_same<T, __nv_bfloat16>::value ||
                std::is_same<T, __half>::value);
  if constexpr (std::is_same<T, __half>::value) {
    GTT_WGMMA_RS("f16");
  } else {
    GTT_WGMMA_RS("bf16");
  }
}

#undef GTT_WGMMA_SS
#undef GTT_WGMMA_RS
#undef GTT_WGMMA_REGS
#undef GTT_WGMMA_ACC

// Keeps the compiler from reusing A-fragment registers that an RS-form
// wgmma still reads: place it after the wgmma_wait that retires it.
template <int kN>
__device__ __forceinline__ void fence_regs(uint32_t* a) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// Orders the warpgroup's register and shared-memory accesses so far before
// the wgmma that follows (needed before the first one, and whenever its
// accumulator or A registers were written in between).
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Waits until at most kPending wgmma groups of the warpgroup are in
// flight.
template <int kPending>
__device__ __forceinline__ void wgmma_wait(float* d) {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending)
               : "memory");
  fence_acc(d);
}

// The accumulator layout of wgmma m64n64 (and of the f32 path): thread
// (warp w, lane l) holds rows 16 w + l / 4 + 8 i and columns
// 8 j + 2 (l % 4) + e at d[4 j + 2 i + e].
__device__ __forceinline__ int acc_row(int i) {
  return threadIdx.x / 32 * 16 + threadIdx.x % 32 / 4 + 8 * i;
}
__device__ __forceinline__ int acc_col(int j) {
  return 8 * j + 2 * (threadIdx.x % 4);
}

// ---- host side ----

using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, from the driver through the runtime (nothing to
// link).
inline cudaError_t encoder(EncodeFn* fn) {
  static std::atomic<EncodeFn> cached{nullptr};
  EncodeFn f = cached.load();
  if (f == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &sym, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &sym, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess) return err;
    if (q != cudaDriverEntryPointSuccess || sym == nullptr) {
      return cudaErrorNotSupported;
    }
    f = reinterpret_cast<EncodeFn>(sym);
    cached.store(f);
  }
  *fn = f;
  return cudaSuccess;
}

// Bytes of an element of dtype code `dtype` (0 bf16, 1 f32, 2 f16).
inline int dtype_bytes(int dtype) { return dtype == 1 ? 4 : 2; }

// A tiled map of `rank` dims (innermost first; strides in bytes of dims
// 1 ..), 128-byte swizzle, zeros outside the tensor; dtype 0 bf16, 1 f32,
// 2 f16.
inline cudaError_t encode(CUtensorMap* map, int dtype, int rank,
                          const void* base, const cuuint64_t* dims,
                          const cuuint64_t* strides, const cuuint32_t* box) {
  EncodeFn fn = nullptr;
  const cudaError_t err = encoder(&fn);
  if (err != cudaSuccess) return err;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUresult res = fn(
      map,
      dtype == 1   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
      : dtype == 2 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                   : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      static_cast<cuuint32_t>(rank), const_cast<void*>(base), dims, strides,
      box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A {d, t, heads, b} map of one 16-bit (b, heads, t, d) operand (dtype 0
// bf16, 2 f16) with d contiguous and (b, heads, t) strides in elements:
// box 64 x 64 (one swizzled slab of 64 rows).
inline cudaError_t encode_heads(CUtensorMap* map, int dtype, const void* base,
                                int d, int t, int heads, int b, long long st,
                                long long sh, long long sb) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 64, 1, 1};
  return encode(map, dtype, 4, base, dims, strides, box);
}

// A {d, t, rows} map of a (rows, t, d) operand (dtype 0 bf16, 1 f32, 2
// f16) with d contiguous and row and t strides in elements; box {box_d,
// 64, 1} (64 or, for f32, 32 columns: one 128-byte line).
inline cudaError_t encode_rows(CUtensorMap* map, int dtype, const void* base,
                               int d, int t, int rows, long long st,
                               long long sr, int box_d) {
  const int elt = dtype_bytes(dtype);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(st) * elt,
                                 static_cast<cuuint64_t>(sr) * elt};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_d), 64, 1};
  return encode(map, dtype, 3, base, dims, strides, box);
}

// The card's opt-in shared memory per block, 0 on an error.
inline int smem_limit() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess) {
    return 0;
  }
  return bytes;
}

}  // namespace gtt
