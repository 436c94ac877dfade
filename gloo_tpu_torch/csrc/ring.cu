// Ring allreduce, reduce-scatter and allgather for Hopper (sm_90a), with a
// plain C interface.
//
// Replaces three Pallas TPU kernels of gloo_tpu/ops/pallas_ring.py:
//   B3  _ring_allreduce_kernel       (ring_allreduce)       gtt_ring_allreduce
//   B4a _ring_reduce_scatter_kernel  (ring_reduce_scatter)  gtt_ring_reduce_scatter
//   B4b _ring_allgather_kernel       (ring_allgather)       gtt_ring_allgather
//
// The ranks are a world on one card: rank r's input, output and flags are
// its own buffers in device memory, and its part of the collective runs as
// its own thread blocks. The kernel sees them only through a table of
// per-rank pointers and the members table, so a launch over more than one
// card needs a table built from peer-mapped memory (and more: see the end
// of this note).
//
// B3 and B4a: one pass in member order. The TPU kernels are shaped for a
// torus of chips, where a chip reaches only its neighbours: they copy the
// input into VMEM, then at each of n - 1 steps DMA a chunk into the right
// neighbour's comm slot, wait for the left one's and add. On Hopper every
// rank's input already lies in device memory that every SM reads, and the
// cards of a host are joined all to all through NVSwitch, not in a ring. So
// the rank that finishes chunk c reads chunk c of every member of its ring
// itself, adds them up and writes the result: each input byte is read once
// and each output byte written once, with one barrier in place of the
// ring's 2 (n - 1) + 1 hand-offs, and no comm slot and no working copy.
//
// The sums stay the ring's. The ring fixes the order in which chunk c is
// added up, and one rank walks the members in that same order. With ring
// indices mod n and in_k the input of the member with ring index k:
//   B3 (chunk c starts raw on c and is finished on c - 1):
//     sum_c = in_{c-1}[c] + (in_{c-2}[c] + ( ... + (in_{c+1}[c] + in_c[c])))
//     and every member's output chunk c is sum_c;
//   B4a (start shift 1: chunk c starts on c + 1 and is finished on c):
//     sum_c = in_c[c] + (in_{c-1}[c] + ( ... + (in_{c+2}[c] + in_{c+1}[c])))
//     and rank c's output is sum_c.
// In both, the rank with ring index `my` walks members my + 1, my + 2, ...,
// my + n = my, its own input last, and finishes chunk my + 1 (B3) or my
// (B4a). Each + is add1 of ring_common.cuh, one add in the element type
// (bf16 and f16 in f32 rounded back after every add, f32 and f64 IEEE
// without contraction, the integers wrapping in their own width), as the
// TPU kernel's o_ref + comm_ref and the plain twins in
// gloo_tpu_torch/ops/ring.py do.
// IEEE addition is commutative, so only the nesting matters: results are
// bitwise the twins', and B3's outputs bitwise equal on every rank.
//
// B4b: one pass that pushes. The TPU kernel forwards chunk (my - s) to the
// right neighbour at each of n - 1 steps, so every chunk is read back from
// device memory n - 1 times and every step waits on the one before. Here
// the rank that owns a chunk reads it once and stores it at offset
// my * chunk into the output of every member of its ring, itself
// included: B3's store loop without the fold. Each input byte is read once
// and each output byte written once (S + P S for S bytes per rank, the
// bound's count), behind the same one members barrier as B3 and B4a, with
// no step flags, no read-back of another block's stores and no neighbour
// tables. The pull form (each rank reads every member's chunk) would read
// each input n times. The result is the TPU kernel's bit for bit: every
// byte lands where the ring's forwarding puts it.
//
// Work division: grid (P, S). Block (r, j) plays rank r on slice j of its
// chunk; each slice has its own barrier flag, so no block waits for another
// block of its own rank. In B3 and B4a each
// thread folds kUnroll units per pass and starts the loads of kGroup
// members (kGroup x kUnroll 16-byte loads) before it adds any of them
// (fold_members of ring_common.cuh, which B11 shares): at
// n >= 4, 32 KB in flight per block and four blocks per SM (kUnroll 4
// takes 116 registers and leaves room for two). Blocks spin on flags that
// other blocks set, so all must be resident at once: the launch is
// cooperative (cudaLaunchCooperativeKernel refuses a grid that cannot be),
// the wrapper takes S from the occupancy that gtt_ring_max_blocks reports,
// and every spin is bounded (~2 s of clock64(), then __trap), so a protocol
// fault surfaces as a CUDA error, not a hung card. The flag helpers are in
// ring_common.cuh.
//
// What bounds them on an H100: bytes, and B3 and B4a now move exactly the
// bound's count. B3 reads n chunks of every rank's input and writes n
// copies of every finished chunk: 2 P S at 3.35 TB/s for S bytes per rank
// (0.0166 ms at the DDP gradient shape, P = 4, 6.95 MB per rank); B4a
// reads P S and writes S (P S + S). There is no arithmetic to speak of
// (n - 1 adds per element). B4b reads S P and writes P S n bytes for a
// world of P ranks in rings of n (0.0104 ms at the DDP shape, P = n = 4,
// 1.74 MB per rank). All three read the inputs through the non-coherent
// path (ld.global.nc): nothing writes them during the launch, and each
// output unit is written by exactly one block.
//
// On one card the entry barrier is not needed for the result: stream order
// completes every rank's input before the launch. Across cards (ROADMAP
// A.7) a peer's input is complete only once that peer has entered, and the
// launch must add: loads (B3, B4a) and stores (B3, B4b) through
// peer-mapped pointers, flags at system scope (.sys in place of .gpu), one
// cooperative launch per card, and an exit barrier among the members
// before a rank may reuse its input (a peer may still be reading it) or
// read B3's or B4b's output (peers write into it).
//
// Types: B3 and B4a take bf16, f16, f32, f64, int8, uint8, int16, int32 and
// int64; a 16-byte unit is unpacked into its lanes and each lane added in
// its own type. B4b only moves bytes, so it takes any type: its instances
// are by unit width (16, 8, 4, 2 or 1 bytes), not by element type.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstring>

#include "ring_common.cuh"

namespace {

using namespace gtt;

constexpr int kThreads = 256;
// B3 and B4a: units each thread folds per pass, and members whose loads
// start together.
constexpr int kUnroll = 2;
constexpr int kGroup = 4;
// B4b: units each thread loads before it stores any.
constexpr int kGatherUnroll = 4;

enum Mode { kAllreduce = 0, kReduceScatter = 1, kAllgather = 2 };

struct Params {
  // The peer table: rank r's buffers. in: n chunks (B3, B4a) or one (B4b);
  // out: n chunks (B3, B4b) or one (B4a); flags: slices x flag_stride ints.
  const void* in[kMaxRanks];
  void* out[kMaxRanks];
  int* flags[kMaxRanks];
  int my[kMaxRanks];
  unsigned char members[kMaxRanks][kMaxRanks];  // ring index -> flat rank
  int n;
  int flag_stride;
  long long chunk;  // units (16-byte vectors or single elements) per chunk
};

// B3 and B4a: block (r, j) sums slice j of the chunk rank r finishes over
// the members of r's ring, in the ring's order, and stores it into rank r's
// output (B4a) or into that chunk of every member's output (B3).
template <typename T, typename U, int kMode>
__device__ __forceinline__ void member_sum(const Params& p) {
  const int r = blockIdx.x;
  const int n = p.n, my = p.my[r];
  const unsigned char* const ring = p.members[r];
  const long long chunk = p.chunk;
  const long long lo = chunk * blockIdx.y / gridDim.y;
  const long long hi = chunk * (blockIdx.y + 1) / gridDim.y;
  const long long off =
      (kMode == kAllreduce ? wrap(my + 1, n) : my) * chunk;
  const long long flag = blockIdx.y * p.flag_stride + kBarrier;

  members_barrier(p.flags[r] + flag, n, [&](int k) {
    return p.flags[ring[wrap(my + k, n)]] + flag;
  });

  for (long long base = lo + threadIdx.x; base < hi;
       base += kThreads * kUnroll) {
    U acc[kUnroll];
    fold_members<T, kUnroll, kGroup>(
        acc, n,
        [&](int k) {
          return static_cast<const U*>(p.in[ring[wrap(my + 1 + k, n)]]) +
                 off + base;
        },
        [](int i) { return i * kThreads; },
        [&](int i) { return base + i * kThreads < hi; });
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const long long u = base + i * kThreads;
      if (u >= hi) continue;
      if (kMode == kReduceScatter) {
        static_cast<U*>(p.out[r])[u] = acc[i];
      } else {
        for (int k = 0; k < n; ++k) {
          static_cast<U*>(p.out[ring[k]])[off + u] = acc[i];
        }
      }
    }
  }
}

// B4b: block (r, j) reads slice j of rank r's chunk once and stores it at
// offset my * chunk into the output of every member of r's ring.
template <typename U>
__device__ __forceinline__ void member_gather(const Params& p) {
  const int r = blockIdx.x;
  const int n = p.n, my = p.my[r];
  const unsigned char* const ring = p.members[r];
  const long long chunk = p.chunk;
  const long long lo = chunk * blockIdx.y / gridDim.y;
  const long long hi = chunk * (blockIdx.y + 1) / gridDim.y;
  const long long off = my * chunk;
  const long long flag = blockIdx.y * p.flag_stride + kBarrier;

  members_barrier(p.flags[r] + flag, n, [&](int k) {
    return p.flags[ring[wrap(my + k, n)]] + flag;
  });

  const U* const in = static_cast<const U*>(p.in[r]);
  for (long long base = lo + threadIdx.x; base < hi;
       base += kThreads * kGatherUnroll) {
    U v[kGatherUnroll];
#pragma unroll
    for (int i = 0; i < kGatherUnroll; ++i) {
      if (base + i * kThreads < hi) v[i] = __ldg(in + base + i * kThreads);
    }
    for (int k = 0; k < n; ++k) {
      U* const out = static_cast<U*>(p.out[ring[k]]) + off + base;
#pragma unroll
      for (int i = 0; i < kGatherUnroll; ++i) {
        if (base + i * kThreads < hi) out[i * kThreads] = v[i];
      }
    }
  }
}

// T: element type; U: the unit of access (uint4, or the element's bits).
// The allgather only copies units, and its instances take T = U. The peer
// table stays in parameter space (__grid_constant__: indexing it takes no
// copy into local memory).
template <typename T, typename U, int kMode>
__global__ void __launch_bounds__(kThreads)
ring_kernel(const __grid_constant__ Params p) {
  if constexpr (kMode == kAllgather) {
    member_gather<U>(p);
  } else {
    member_sum<T, U, kMode>(p);
  }
}

// B4b's units by width in bytes.
#define GTT_COPY_UNITS(X) \
  X(16, uint4)            \
  X(8, uint2)             \
  X(4, unsigned)          \
  X(2, unsigned short)    \
  X(1, unsigned char)

// The kernel of one mode: for B3 and B4a by dtype code and vec, for B4b
// by unit width (`dtype` then holds the unit's bytes, `vec` is unused).
template <int kMode>
void* kernel_for(int dtype, int vec) {
  if constexpr (kMode == kAllgather) {
#define GTT_COPY_CASE(BYTES, U) \
    if (dtype == BYTES) return (void*)ring_kernel<U, U, kMode>;
    GTT_COPY_UNITS(GTT_COPY_CASE)
#undef GTT_COPY_CASE
  } else {
#define GTT_SUM_CASE(CODE, T, SCALAR)                                  \
    if (dtype == CODE) {                                               \
      return vec ? (void*)ring_kernel<T, uint4, kMode>                 \
                 : (void*)ring_kernel<T, SCALAR, kMode>;               \
    }
    GTT_SUM_TYPES(GTT_SUM_CASE)
#undef GTT_SUM_CASE
  }
  return nullptr;
}

// Checks the sizes and fills the per-rank part of the peer table: rank r's
// buffers are base + r * stride (bytes), the layout of one world tensor.
bool fill(Params& p, const void* in, long long in_stride, void* out,
          long long out_stride, int* flags, int flag_stride, const int* my,
          int ranks, int n, int slices, long long chunk) {
  if (ranks < 2 || ranks > kMaxRanks || n < 2 || n > ranks || slices < 1 ||
      slices > 65535 || chunk < 1 || flag_stride < 1) {
    return false;
  }
  memset(&p, 0, sizeof(p));
  for (int r = 0; r < ranks; ++r) {
    if (my[r] < 0 || my[r] >= n) return false;
    p.in[r] = static_cast<const char*>(in) + r * in_stride;
    p.out[r] = static_cast<char*>(out) + r * out_stride;
    p.flags[r] = flags + static_cast<long long>(r) * slices * flag_stride;
    p.my[r] = my[r];
  }
  p.n = n;
  p.flag_stride = flag_stride;
  p.chunk = chunk;
  return true;
}

int launch(void* fn, const Params& p, int ranks, int slices, void* stream) {
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {const_cast<Params*>(&p)};
  cudaError_t err = cudaLaunchCooperativeKernel(
      fn, dim3(ranks, slices), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream));
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

// members is ranks x n flat ranks, row r the ring of rank r in ring order;
// rank r must be entry my[r] of its own row.
int run(int mode, const void* in, long long in_stride, void* out,
        long long out_stride, int* flags, int flag_stride, const int* my,
        const int* members, int ranks, int n, int slices, long long chunk,
        int dtype, int vec, void* stream) {
  Params p;
  if (!fill(p, in, in_stride, out, out_stride, flags, flag_stride, my,
            ranks, n, slices, chunk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int r = 0; r < ranks; ++r) {
    for (int k = 0; k < n; ++k) {
      const int m = members[r * n + k];
      if (m < 0 || m >= ranks || (k == my[r]) != (m == r)) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      p.members[r][k] = static_cast<unsigned char>(m);
    }
  }
  void* fn = mode == kAllreduce       ? kernel_for<kAllreduce>(dtype, vec)
             : mode == kReduceScatter ? kernel_for<kReduceScatter>(dtype, vec)
                                      : kernel_for<kAllgather>(dtype, vec);
  return launch(fn, p, ranks, slices, stream);
}

cudaError_t min_blocks(const void* fn, int* blocks) {
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fn, kThreads, 0);
  if (err == cudaSuccess && per_sm < *blocks) *blocks = per_sm;
  return err;
}

}  // namespace

extern "C" {

// Ints of flags each (rank, slice) needs for a ring of n: the members
// barrier's one (ring_common.cuh's kBarrier), whatever n.
int gtt_ring_flag_stride(int) { return kBarrier + 1; }

// The most blocks of any ring kernel that can be resident at once on the
// current device (the cooperative launch's limit), in *blocks.
int gtt_ring_max_blocks(int* blocks) {
  int per_sm = 1 << 30;
  cudaError_t err = cudaSuccess;
  for (int code = 0; code < kSumTypes; ++code) {
    for (int vec = 0; vec < 2; ++vec) {
      if (err == cudaSuccess) {
        err = min_blocks(kernel_for<kAllreduce>(code, vec), &per_sm);
      }
      if (err == cudaSuccess) {
        err = min_blocks(kernel_for<kReduceScatter>(code, vec), &per_sm);
      }
    }
  }
  for (int bytes = 1; bytes <= 16; bytes *= 2) {
    if (err == cudaSuccess) {
      err = min_blocks(kernel_for<kAllgather>(bytes, 0), &per_sm);
    }
  }
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

// Each returns a cudaError_t; 0 is success. dtype (B3, B4a): 0 = bf16,
// 1 = f32, 2 = f16, 3 = f64, 4 = int32, 5 = int64, 6 = int8, 7 = uint8,
// 8 = int16, 9 = uint16, 10 = uint32. vec: units are 16-byte vectors
// (every chunk a whole number of them, every buffer 16-byte aligned), else
// single elements. B4b takes unit_bytes (16, 8, 4, 2 or 1, dividing the
// chunk and every buffer's start) in their place. chunk counts units.
// Strides are in bytes. flags: ranks x slices x flag_stride zeroed ints.
// my: each rank's ring index; members: ranks x n flat ranks, row r the
// ring of rank r in ring order. All tables are host arrays.

int gtt_ring_allreduce(const void* x, void* out, long long rank_stride,
                       int* flags, int flag_stride, const int* my,
                       const int* members, int ranks, int n, int slices,
                       long long chunk, int dtype, int vec, void* stream) {
  return run(kAllreduce, x, rank_stride, out, rank_stride, flags,
             flag_stride, my, members, ranks, n, slices, chunk, dtype, vec,
             stream);
}

int gtt_ring_reduce_scatter(const void* x, long long in_stride, void* out,
                            long long out_stride, int* flags,
                            int flag_stride, const int* my,
                            const int* members, int ranks, int n,
                            int slices, long long chunk, int dtype, int vec,
                            void* stream) {
  return run(kReduceScatter, x, in_stride, out, out_stride, flags,
             flag_stride, my, members, ranks, n, slices, chunk, dtype, vec,
             stream);
}

int gtt_ring_allgather(const void* x, long long in_stride, void* out,
                       long long out_stride, int* flags, int flag_stride,
                       const int* my, const int* members, int ranks, int n,
                       int slices, long long chunk, int unit_bytes,
                       void* stream) {
  return run(kAllgather, x, in_stride, out, out_stride, flags, flag_stride,
             my, members, ranks, n, slices, chunk, unit_bytes, 0, stream);
}

const char* gtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
