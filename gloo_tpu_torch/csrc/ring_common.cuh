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
//
// The scope is a template parameter of the flag helpers: Scope::kGpu (the
// default, .gpu) for the ranks of a world on one card, Scope::kSys (.sys)
// for flags that other processes read and write through peer-mapped
// memory (ring.cu's cross-process instances, peer.cu's probe). Those
// flags are not zeroed per call: each call adds n - 1 to every flag of a
// member, and the caller passes the count before the call (`base`), so a
// peer's add can never land before the owner resets it.
//
// No rank ceiling: a launch's per-rank tables live in device memory, not
// in its parameters. Rank r's buffers are base + r x stride on one card
// (PerRank), or entry r of a device array of peer-mapped pointers across
// processes (tpu/peer.py fills it where it maps the peers); the ring
// tables are one int32 tensor per (mesh, axes) that ops/ring.py's
// ring_table builds once (Rings), so a launch copies no table. The host
// entries check the same tables, as host arrays, before any launch. What
// bounds a world on one card is the cooperative launch's residency (every
// block of every rank resident at once), which each wrapper checks. The
// counts that grow with n fit at any n the card can hold (at most 132 SMs
// x 32 blocks = 4224 ranks): a members barrier's flag reaches base + n - 1,
// a chain's arrival count n slices, and B5's flag stride kGather + n - 1
// ints per tile; ops/ring.py's WIDENED sums of n uint16 (uint32) values fit
// int32 (int64) up to n = 32768 (2^32).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace gtt {

// ~2 s at the H100's clocks (1.98 GHz boost; longer when it runs slower).
constexpr long long kSpinCycles = 4000000000LL;

// Flags of one (rank, slice): counters that only grow, zeroed per call.
// The members barrier takes the first; overlap.cu's ring hand-offs the
// rest.
constexpr int kBarrier = 0;  // + 1 from each other member
constexpr int kFull = 1;     // [2]: + 1 each time the left fills slot k
constexpr int kAck = 3;      // [2]: + 1 each time the right empties slot k
constexpr int kGather = 5;   // [n - 1]: 1 when allgather step s landed
// The cross-process instances of ring.cu: per (rank, slice) the members
// barrier's flag (kBarrier), then the exit barrier's.
constexpr int kPeerExit = 1;
constexpr int kPeerFlags = 2;

// The memory scope of a flag: the card (.gpu), or the system (.sys) for
// flags in peer-mapped memory that other processes use.
enum class Scope { kGpu, kSys };

template <Scope S = Scope::kGpu>
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  if constexpr (S == Scope::kGpu) {
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
                 : "=r"(v) : "l"(p) : "memory");
  } else {
    asm volatile("ld.acquire.sys.global.b32 %0, [%1];"
                 : "=r"(v) : "l"(p) : "memory");
  }
  return v;
}

template <Scope S = Scope::kGpu>
__device__ __forceinline__ void add_release(int* p, int v) {
  if constexpr (S == Scope::kGpu) {
    asm volatile("red.release.gpu.global.add.s32 [%0], %1;"
                 :: "l"(p), "r"(v) : "memory");
  } else {
    asm volatile("red.release.sys.global.add.s32 [%0], %1;"
                 :: "l"(p), "r"(v) : "memory");
  }
}

template <Scope S = Scope::kGpu>
__device__ __forceinline__ void store_release(int* p, int v) {
  if constexpr (S == Scope::kGpu) {
    asm volatile("st.release.gpu.global.b32 [%0], %1;"
                 :: "l"(p), "r"(v) : "memory");
  } else {
    asm volatile("st.release.sys.global.b32 [%0], %1;"
                 :: "l"(p), "r"(v) : "memory");
  }
}

// Thread 0 waits until *flag >= target, then the block goes on together.
template <Scope S = Scope::kGpu>
__device__ inline void wait_flag(const int* flag, int target) {
  if (threadIdx.x == 0) {
    const long long start = clock64();
    while (ld_acquire<S>(flag) < target) {
      if (clock64() - start > kSpinCycles) __trap();
    }
  }
  __syncthreads();
}

// Thread 0's adds of a barrier: one to the flag flag_of(m) of every
// member m of the ring row `row` (n flat ranks) but `self`, in any order.
// The row's entries are loaded kBatch at a time, all before the batch's
// adds (whose release asm would otherwise hold each next load back): a
// few round trips to the device table, not one per member.
template <Scope S, typename FlagOf>
__device__ __forceinline__ void add_to_others(const int* row, int n,
                                              int self, FlagOf flag_of) {
  constexpr int kBatch = 8;
  for (int k0 = 0; k0 < n; k0 += kBatch) {
    int m[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) m[i] = k0 + i < n ? row[k0 + i] : self;
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (m[i] != self) add_release<S>(flag_of(m[i]), 1);
    }
  }
}

// The entry barrier among the n members of a ring (ring.cu's B3, B4a and
// B4b, ring_variants.cu's B9, B10 and B11, alltoall.cu's B8, permute.cu's
// transport), one flag per (rank, slice): thread 0 adds one to the flag
// flag_of(m) of each other member m of the block's ring row `row` (flat
// rank `self` is its own), and the block waits until its own flag reaches
// base + n - 1 (base: its count before this call; 0 where the flags are
// zeroed per call). The block has stored nothing before it; at system
// scope a fence first orders the earlier kernels' writes of this process
// (its input) before the adds, for peers that read it.
template <Scope S = Scope::kGpu, typename FlagOf>
__device__ inline void members_barrier(int* fl_me, const int* row, int n,
                                       int self, FlagOf flag_of,
                                       int base = 0) {
  if (threadIdx.x == 0) {
    if constexpr (S == Scope::kSys) __threadfence_system();
    add_to_others<S>(row, n, self, flag_of);
  }
  wait_flag<S>(fl_me, base + n - 1);
}

// The exit barrier among the n members of a ring, for ranks in other
// processes: once every thread of the block has made its last load of a
// member's input and its last store into a member's output, thread 0
// fences, adds one to the exit flag flag_of(m) of each other member m of
// the ring row, and the block waits until its own reaches base + n - 1. A
// block that returns then leaves no peer reading its rank's input or
// writing its rank's output for this slice.
template <Scope S, typename FlagOf>
__device__ inline void exit_barrier(int* fl_me, const int* row, int n,
                                    int self, FlagOf flag_of, int base) {
  __syncthreads();
  if (threadIdx.x == 0) {
    if constexpr (S == Scope::kSys) {
      __threadfence_system();
    } else {
      __threadfence();
    }
    add_to_others<S>(row, n, self, flag_of);
  }
  wait_flag<S>(fl_me, base + n - 1);
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

// Every rank's buffer of one kind. On one card rank r's lies at base +
// r x stride bytes (the layout of one world tensor); across processes at
// table[r], a device array of pointers by flat rank (peer-mapped, or this
// process's own for its local ranks). at<S>(r) picks the form by the
// instance's scope at compile time (no branch and no unused fields in the
// loops); at(x) is the strided form, for buffers laid out by block row x
// in both instances.
template <typename T>
struct PerRank {
  T* base;
  long long stride;
  T* const* table;
  template <Scope S = Scope::kGpu>
  __device__ __forceinline__ T* at(int r) const {
    if constexpr (S == Scope::kGpu) {
      return (T*)((const char*)base + static_cast<long long>(r) * stride);
    } else {
      return table[r];
    }
  }
};

// One card: rank r's buffer at base + r x stride bytes.
template <typename T>
inline PerRank<T> strided(T* base, long long stride) {
  return {base, stride, nullptr};
}

// Across processes: rank r's buffer at table[r] (a device array).
template <typename T>
inline PerRank<T> tabled(T* const* table) {
  return {nullptr, 0, table};
}

// A launch's ring tables in device memory: one int32 array (ops/ring.py's
// ring_table), built once per (mesh, axes) and laid out as
//   my[ranks] right[ranks] left[ranks] local[local_ranks] members[ranks n]:
// each flat rank's ring index, right and left neighbours, the flat ranks
// this process plays (block x plays local[x]; every rank on one card), and
// row r of members rank r's ring in ring order.
struct Rings {
  const int* my;
  const int* right;
  const int* left;
  const int* local;
  const int* members;
  // Row r of members: ring index -> flat rank.
  __device__ __forceinline__ const int* ring(int r, int n) const {
    return members + static_cast<long long>(r) * n;
  }
};

inline Rings rings_at(const int* table, int ranks, int local_ranks) {
  return {table, table + ranks, table + 2 * ranks, table + 3 * ranks,
          table + 3 * ranks + local_ranks};
}

// Host checks of a launch's rank tables, the host arrays of the device
// table the launch reads. my: every flat rank's ring index (below n);
// members: ranks x n flat ranks, row r the ring of rank r in ring order
// with r itself at entry my[r] and nowhere else, checked for the flat
// ranks in local (local_ranks of them; nullptr: every rank); table: the
// device copy, 4-byte aligned. False where a table breaks that.
inline bool check_rings(const int* my, const int* members, const int* local,
                        int local_ranks, int ranks, int n,
                        const void* table) {
  if (table == nullptr || reinterpret_cast<uintptr_t>(table) % 4) {
    return false;
  }
  for (int r = 0; r < ranks; ++r) {
    if (my[r] < 0 || my[r] >= n) return false;
  }
  for (int x = 0; x < local_ranks; ++x) {
    const int r = local == nullptr ? x : local[x];
    if (r < 0 || r >= ranks) return false;
    for (int k = 0; k < n; ++k) {
      const long long m = members[static_cast<long long>(r) * n + k];
      if (m < 0 || m >= ranks || (k == my[r]) != (m == r)) return false;
    }
  }
  return true;
}

// Host check of a table of `ranks` device pointers: none null, each a
// multiple of `align` bytes.
template <typename T>
inline bool check_pointers(T* const* table, int ranks, int align = 1) {
  for (int r = 0; r < ranks; ++r) {
    if (table[r] == nullptr ||
        reinterpret_cast<uintptr_t>(table[r]) % align) {
      return false;
    }
  }
  return true;
}

// The cooperative launch's limit on the current device once the kernels'
// occupancy queries have given err and the least blocks per SM, per_sm:
// per_sm x SMs in *blocks (0 on an error). Returns a cudaError_t.
inline int cooperative_blocks(cudaError_t err, int per_sm, int* blocks) {
  int device = 0, sms = 0, coop = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  }
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  *blocks = err == cudaSuccess ? per_sm * sms : 0;
  return static_cast<int>(err);
}

}  // namespace gtt
