// Helpers shared by the kernels that walk a ring of ranks on one card
// (ring.cu, ring_variants.cu, overlap.cu, alltoall.cu): the flag protocol
// between blocks, the element-wise add of the ring's reduce steps and the
// fold of a member-order sum.
//
// Flags are counters in device memory that only grow and are zeroed per
// call. A sender's threads store into the peer's buffer, then
// __syncthreads(), then one thread fences and publishes with a release
// (red.release.gpu / st.release.gpu; overlap.cu's hand-offs). A
// receiver's thread 0 spins on an acquire load, then __syncthreads().
// Every spin is bounded: after ~2 s of clock64() the block traps, so a
// protocol fault surfaces as a CUDA error, not a hung card.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstring>

namespace gtt {

// The most ranks a peer table holds.
constexpr int kMaxRanks = 32;
// ~2 s at the H100's clocks (1.98 GHz boost; longer when it runs slower).
constexpr long long kSpinCycles = 4000000000LL;

// Flags of one (rank, slice): counters that only grow, zeroed per call.
// The members barrier takes the first; overlap.cu's ring hand-offs the
// rest.
constexpr int kBarrier = 0;  // + 1 from each other member
constexpr int kFull = 1;     // [2]: + 1 each time the left fills slot k
constexpr int kAck = 3;      // [2]: + 1 each time the right empties slot k
constexpr int kGather = 5;   // [n - 1]: 1 when allgather step s landed

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void add_release(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// Thread 0 waits until *flag >= target, then the block goes on together.
__device__ inline void wait_flag(const int* flag, int target) {
  if (threadIdx.x == 0) {
    const long long start = clock64();
    while (ld_acquire(flag) < target) {
      if (clock64() - start > kSpinCycles) __trap();
    }
  }
  __syncthreads();
}

// The entry barrier among the n members of a ring (ring.cu's B3, B4a and
// B4b, ring_variants.cu's B9, B10 and B11, alltoall.cu's B8),
// one flag per (rank, slice): thread 0 adds one to the flag `peer(k)` of
// each other member, k = 1 .. n - 1, and the block waits until its own
// reaches n - 1. The block has stored nothing before it, so nothing needs
// to be published with the adds.
template <typename Peer>
__device__ inline void members_barrier(int* fl_me, int n, Peer peer) {
  if (threadIdx.x == 0) {
    for (int k = 1; k < n; ++k) add_release(peer(k), 1);
  }
  wait_flag(fl_me, n - 1);
}

// One add per element in the element type, as PyTorch adds on the CPU:
// floats in f32 (f64 for double) rounded once to the element type, no
// contraction; integers wrap.
__device__ __forceinline__ float add1(float a, float b) {
  return __fadd_rn(a, b);
}

__device__ __forceinline__ __nv_bfloat16 add1(__nv_bfloat16 a,
                                              __nv_bfloat16 b) {
  return __float2bfloat16_rn(
      __fadd_rn(__bfloat162float(a), __bfloat162float(b)));
}

__device__ __forceinline__ __half add1(__half a, __half b) {
  return __float2half_rn(__fadd_rn(__half2float(a), __half2float(b)));
}

__device__ __forceinline__ double add1(double a, double b) {
  return __dadd_rn(a, b);
}

__device__ __forceinline__ int add1(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) +
                          static_cast<unsigned>(b));
}

__device__ __forceinline__ long long add1(long long a, long long b) {
  return static_cast<long long>(static_cast<unsigned long long>(a) +
                                static_cast<unsigned long long>(b));
}

// The sub-word and unsigned integers add in their own width: the sum is
// cut back to the type's bits (two's complement), as PyTorch's int8, uint8
// and int16 adds wrap, and as the reference's uint16 and uint32 sums do.
__device__ __forceinline__ signed char add1(signed char a, signed char b) {
  return static_cast<signed char>(static_cast<unsigned char>(
      static_cast<unsigned char>(a) + static_cast<unsigned char>(b)));
}

__device__ __forceinline__ unsigned char add1(unsigned char a,
                                              unsigned char b) {
  return static_cast<unsigned char>(a + b);
}

__device__ __forceinline__ short add1(short a, short b) {
  return static_cast<short>(static_cast<unsigned short>(
      static_cast<unsigned short>(a) + static_cast<unsigned short>(b)));
}

__device__ __forceinline__ unsigned short add1(unsigned short a,
                                               unsigned short b) {
  return static_cast<unsigned short>(a + b);
}

__device__ __forceinline__ unsigned add1(unsigned a, unsigned b) {
  return a + b;
}

// The element types of the sum kernels (ring.cu's B3 and B4a,
// ring_variants.cu's B9 and B11) by dtype code, ring.SUM_DTYPES, each with
// its single-element unit (the element's bits); their 16-byte unit is a
// uint4.
#define GTT_SUM_TYPES(X)              \
  X(0, __nv_bfloat16, unsigned short) \
  X(1, float, float)                  \
  X(2, __half, unsigned short)        \
  X(3, double, double)                \
  X(4, int, int)                      \
  X(5, long long, long long)          \
  X(6, signed char, signed char)      \
  X(7, unsigned char, unsigned char)  \
  X(8, short, short)                  \
  X(9, unsigned short, unsigned short) \
  X(10, unsigned, unsigned)
constexpr int kSumTypes = 11;

// Element-wise a + b over the lanes of one unit (a 16-byte vector, or the
// bits of one element): the unit is unpacked into its lanes of T (16 int8,
// 8 int16 or bf16, ...), each lane added in T.
template <typename T, typename U>
__device__ __forceinline__ U add_units(U a, U b) {
  constexpr int kLanes = sizeof(U) / sizeof(T);
  T la[kLanes], lb[kLanes];
  memcpy(la, &a, sizeof(U));
  memcpy(lb, &b, sizeof(U));
#pragma unroll
  for (int k = 0; k < kLanes; ++k) la[k] = add1(la[k], lb[k]);
  memcpy(&a, la, sizeof(U));
  return a;
}

// The fold of a member-order sum (ring.cu's B3 and B4a, ring_variants.cu's
// B11): acc[i] = in_{n-1}[i] + ( ... + (in_1[i] + in_0[i])) over the n
// members of a walk, for each of this thread's kUnroll units i that
// live(i) admits; unit i of the k-th member of the walk lies at
// member(k) + at(i). The loads of kGroup members x kUnroll units are
// issued before any of them is added. Inputs are read through the
// non-coherent path (__ldg): nothing may write them during the launch.
template <typename T, int kUnroll, int kGroup, typename U, typename Member,
          typename At, typename Live>
__device__ __forceinline__ void fold_members(U (&acc)[kUnroll], int n,
                                             Member member, At at,
                                             Live live) {
  for (int k0 = 0; k0 < n; k0 += kGroup) {
    U v[kGroup][kUnroll];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      if (k0 + g < n) {
        const U* const src = member(k0 + g);
#pragma unroll
        for (int i = 0; i < kUnroll; ++i) {
          if (live(i)) v[g][i] = __ldg(src + at(i));
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) {
        if (k0 + g < n && live(i)) {
          acc[i] = k0 + g == 0 ? v[g][i] : add_units<T>(v[g][i], acc[i]);
        }
      }
    }
  }
}

__device__ __forceinline__ int wrap(int i, int n) { return ((i % n) + n) % n; }

}  // namespace gtt
