// All-to-all along one ring of ranks for Hopper (sm_90a), with a plain C
// interface.
//
// Replaces gloo_tpu/ops/pallas_ring.py::_alltoall_kernel (B8), the Pallas
// TPU kernel behind pallas_alltoall, and the copies that spmd.alltoall
// made around it: block k of rank r's output is block my[r] (r's ring
// index) of its ring member k, where a block may be a strided slab of each
// rank's local value. Any element type: the kernel copies bytes.
//
// The ranks are a world on one card, as in ring.cu: rank r's input, output
// and flags are its own buffers, reached through a table of per-rank
// pointers, and its part of the exchange runs as its own thread blocks. A
// (rank, ring index) -> flat rank table names each rank's peers.
//
// Blocks as strided slabs (lax.all_to_all's split and concat axes). Write
// a rank's contiguous local value as (A, n c, B) around the split axis and
// its result as (A', n c', B') around the concat axis. Block k is then, in
// the same row-major order on both sides,
//   - on the input, A rows of in_run = c B elements, in_pitch = n c B
//     apart, from offset k c B;
//   - on the output, A' rows of out_run = c' B' elements, out_pitch apart,
//     from offset k c' B'.
// The kernel copies runs of g = gcd(in_run, out_run) bytes, each contiguous
// on both sides, in units of the widest access (16, 8, 4, 2 or 1 bytes)
// that divides g, both pitches and every rank's buffers, and computes the
// two offsets once per run: run j of a block starts at row j / (in_run / g)
// and column j % (in_run / g) runs of the input row, likewise on the
// output. The leading-axis case (split = concat = 0: MoE, the process
// group) is A = A' = 1, one run per block.
//
// One pass, pulled: block (r, s) plays rank r on slice s of its block
// positions; for each position it loads the unit from every member's
// input (block my[r], through the non-coherent path: nothing writes an
// input during the launch), kGroup members x kUnroll units issued before
// any store, then stores each into block k of r's own output. No rank
// stores into a peer's buffer, so there are no receive flags and no
// collisions to order; the one members barrier (ring_common.cuh) is what a
// launch over several cards needs before it reads a peer's input (on one
// card the launch's start already orders it). Over several cards each
// rank's input must be peer-mapped, and a members barrier at exit must
// come before a rank reuses its input (ROADMAP A.7).
//
// What bounds it on an H100: bytes. Each rank's input is read once and its
// output written once: 2 x the world's bytes (8 MiB at a Ulysses exchange
// of the long-context path, ~2.5 us at 3.35 TB/s; a world of 4 MiB stays
// in the 50 MB L2 between back-to-back calls, so it may run under that).
//
// Work division: grid (P, S), cooperative (the barrier spins on flags that
// other blocks set, so all must be resident; S comes from the occupancy
// that gtt_alltoall_max_blocks reports, and the spin is bounded, ~2 s, then
// __trap). `group` threads share one run: kThreads where a run holds at
// least kThreads units, and the slices then cut the block's units; else a
// power of two no larger than a run's units, each group takes whole runs,
// and the slices cut the runs.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "ring_common.cuh"

namespace {

using namespace gtt;

constexpr int kThreads = 256;
// Units each thread moves per member and pass, and members whose loads
// start together.
constexpr int kUnroll = 2;
constexpr int kGroup = 4;
// Flags of one (rank, slice), zeroed per call: + 1 from each member on
// entry.
constexpr int kFlagStride = 1;

struct Params {
  const void* in[kMaxRanks];
  void* out[kMaxRanks];
  int* flags[kMaxRanks];
  int my[kMaxRanks];
  unsigned char members[kMaxRanks][kMaxRanks];  // ring index -> flat rank
  int n;
  int group;           // threads per run
  long long runs;      // runs per block
  long long run;       // units per run
  long long in_runs;   // runs per input row of a block
  long long out_runs;  // runs per output row of a block
  long long in_pitch;  // units between input rows
  long long out_pitch;
  long long in_block;  // units between blocks along an input row
  long long out_block;
};

// Units [w0, w1) of one run, step `step` apart from this thread's first:
// the run starts at unit `src` of block my of every member's input and at
// unit `dst` of block 0 of rank r's output.
template <typename U>
__device__ __forceinline__ void copy_run(const Params& p, int r,
                                         long long src, long long dst,
                                         long long w0, long long w1,
                                         int step) {
  const int n = p.n;
  U* const out = static_cast<U*>(p.out[r]) + dst;
  for (long long w = w0; w < w1; w += static_cast<long long>(step) * kUnroll) {
    for (int k0 = 0; k0 < n; k0 += kGroup) {
      U v[kGroup][kUnroll];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        if (k0 + g < n) {
          const U* const in =
              static_cast<const U*>(p.in[p.members[r][k0 + g]]) + src;
#pragma unroll
          for (int i = 0; i < kUnroll; ++i) {
            if (w + i * step < w1) v[g][i] = __ldg(in + w + i * step);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        if (k0 + g < n) {
          U* const o = out + (k0 + g) * p.out_block;
#pragma unroll
          for (int i = 0; i < kUnroll; ++i) {
            if (w + i * step < w1) o[w + i * step] = v[g][i];
          }
        }
      }
    }
  }
}

// The unit offsets of run j: (input, block my; output, block 0).
__device__ __forceinline__ void run_offsets(const Params& p, int my,
                                            long long j, long long* src,
                                            long long* dst) {
  *src = j / p.in_runs * p.in_pitch + my * p.in_block +
         j % p.in_runs * p.run;
  *dst = j / p.out_runs * p.out_pitch + j % p.out_runs * p.run;
}

// U: the unit of access (16, 8, 4, 2 or 1 bytes). The peer table stays in
// parameter space (__grid_constant__: indexing it takes no local copy).
template <typename U>
__global__ void __launch_bounds__(kThreads)
alltoall_kernel(const __grid_constant__ Params p) {
  const int r = blockIdx.x;
  const int n = p.n, my = p.my[r];
  const unsigned char* const ring = p.members[r];

  members_barrier(p.flags[r] + blockIdx.y, n, [&](int k) {
    return p.flags[ring[wrap(my + k, n)]] + blockIdx.y;
  });

  long long src, dst;
  if (p.group == kThreads) {
    // Long runs: this slice's units [lo, hi) of the block, run by run.
    const long long total = p.runs * p.run;
    const long long lo = total * blockIdx.y / gridDim.y;
    const long long hi = total * (blockIdx.y + 1) / gridDim.y;
    for (long long j = lo / p.run; j * p.run < hi; ++j) {
      run_offsets(p, my, j, &src, &dst);
      const long long base = j * p.run;
      copy_run<U>(p, r, src, dst,
                  (lo > base ? lo - base : 0) + threadIdx.x,
                  hi - base < p.run ? hi - base : p.run, kThreads);
    }
  } else {
    // Short runs: this slice's runs [lo, hi), one per group of threads.
    const long long lo = p.runs * blockIdx.y / gridDim.y;
    const long long hi = p.runs * (blockIdx.y + 1) / gridDim.y;
    const int groups = kThreads / p.group;
    for (long long j = lo + threadIdx.x / p.group; j < hi; j += groups) {
      run_offsets(p, my, j, &src, &dst);
      copy_run<U>(p, r, src, dst, threadIdx.x % p.group, p.run, p.group);
    }
  }
}

template <typename U>
void* kernel_for() {
  return reinterpret_cast<void*>(alltoall_kernel<U>);
}

void* kernel_of(int unit) {
  switch (unit) {
    case 16: return kernel_for<uint4>();
    case 8: return kernel_for<uint2>();
    case 4: return kernel_for<unsigned int>();
    case 2: return kernel_for<unsigned short>();
    case 1: return kernel_for<unsigned char>();
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// Ints of flags each (rank, slice) needs.
int gtt_alltoall_flag_stride() { return kFlagStride; }

// The most all-to-all blocks that can be resident at once on the current
// device (the cooperative launch's limit), in *blocks.
int gtt_alltoall_max_blocks(int* blocks) {
  int per_sm = 1 << 30;
  cudaError_t err = cudaSuccess;
  const int units[] = {16, 8, 4, 2, 1};
  for (int unit : units) {
    int got = 0;
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &got, kernel_of(unit), kThreads, 0);
    }
    if (err == cudaSuccess && got < per_sm) per_sm = got;
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

// Returns a cudaError_t; 0 is success. Rank r's input is x + r * in_stride
// and its output out + r * out_stride (bytes); flags: ranks x slices x
// flag_stride zeroed ints. my: each rank's ring index; members: ranks x n
// flat ranks, row r the ring of rank r in ring order. A block is
// block_bytes: rows of in_run bytes in_pitch apart on the input (block k
// at k in_run along a row), rows of out_run bytes out_pitch apart on the
// output (block k at k out_run). run: the bytes copied as one contiguous
// piece on both sides, dividing in_run and out_run; unit: bytes per access
// (16, 8, 4, 2 or 1), dividing run, both pitches and every buffer's
// alignment; group: threads per run, kThreads (256) or a power of two no
// larger than run / unit.
int gtt_alltoall(const void* x, long long in_stride, void* out,
                 long long out_stride, int* flags, int flag_stride,
                 const int* my, const int* members, int ranks, int n,
                 int slices, long long block_bytes, long long in_run,
                 long long in_pitch, long long out_run, long long out_pitch,
                 long long run, int unit, int group, void* stream) {
  void* fn = kernel_of(unit);
  const auto divides = [](long long d, long long v) {
    return d > 0 && v % d == 0;
  };
  const long long run_units = run > 0 ? run / unit : 0;
  if (fn == nullptr || ranks < 2 || ranks > kMaxRanks || n < 2 ||
      n > ranks || slices < 1 || slices > 65535 || block_bytes < 1 ||
      !divides(run, in_run) || !divides(run, out_run) ||
      !divides(in_run, block_bytes) || !divides(out_run, block_bytes) ||
      !divides(unit, run) || in_pitch % unit || out_pitch % unit ||
      in_stride % unit || out_stride % unit ||
      reinterpret_cast<uintptr_t>(x) % unit ||
      reinterpret_cast<uintptr_t>(out) % unit ||
      in_pitch < n * in_run || out_pitch < n * out_run || group < 1 ||
      group > kThreads || (group & (group - 1)) ||
      (group < kThreads && group > run_units) ||
      flag_stride != kFlagStride) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  memset(&p, 0, sizeof(p));
  for (int r = 0; r < ranks; ++r) {
    if (my[r] < 0 || my[r] >= n) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    for (int k = 0; k < n; ++k) {
      const int m = members[r * n + k];
      if (m < 0 || m >= ranks) return static_cast<int>(cudaErrorInvalidValue);
      p.members[r][k] = static_cast<unsigned char>(m);
    }
    p.in[r] = static_cast<const char*>(x) + r * in_stride;
    p.out[r] = static_cast<char*>(out) + r * out_stride;
    p.flags[r] = flags + static_cast<long long>(r) * slices * flag_stride;
    p.my[r] = my[r];
  }
  p.n = n;
  p.group = group;
  p.runs = block_bytes / run;
  p.run = run_units;
  p.in_runs = in_run / run;
  p.out_runs = out_run / run;
  p.in_pitch = in_pitch / unit;
  p.out_pitch = out_pitch / unit;
  p.in_block = in_run / unit;
  p.out_block = out_run / unit;
  void* args[] = {&p};
  cudaError_t err = cudaLaunchCooperativeKernel(
      fn, dim3(ranks, slices), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream));
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

const char* gtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
