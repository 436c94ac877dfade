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
// and flags are its own buffers, at base + r x stride, and its part of
// the exchange runs as its own thread blocks. A (rank, ring index) -> flat
// rank table in device memory names each rank's peers (ring_common.cuh's
// Rings; no rank ceiling).
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
// card the launch's start already orders it).
//
// Across processes (alltoall_peer_kernel, entry gtt_alltoall_peer) each
// rank's input lives in its process's peer workspace (peer.cu), mapped
// into every other process by CUDA IPC; its output is its process's own
// memory, since only the rank itself stores into it. Each process makes
// one cooperative launch of grid (local ranks, slices). The barriers are
// at system scope on one entry and one exit flag per rank, counters that
// only grow: each block adds one to the flag of every other member of
// its ring, and the wrapper passes the count before the call. The entry
// barrier makes every member's input complete before any load; the exit
// barrier keeps every rank from returning, and its process from writing
// its next input, while a peer can still read it.
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
// Across processes, each rank's entry and exit flag (kPeerFlags ints).
constexpr int kPeerEntry = kBarrier;

struct Params {
  // Rank r's input and flags; block row x's output (x = r on one card,
  // local rank x across processes).
  PerRank<const void> in;
  PerRank<void> out;
  PerRank<int> flags;
  Rings rings;  // in device memory
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
// unit `dst` of block 0 of the output of the rank whose ring row is
// `ring` (block row blockIdx.x's).
template <typename U, Scope S>
__device__ __forceinline__ void copy_run(const Params& p, const int* ring,
                                         long long src, long long dst,
                                         long long w0, long long w1,
                                         int step) {
  const int n = p.n;
  U* const out = static_cast<U*>(p.out.at(blockIdx.x)) + dst;
  for (long long w = w0; w < w1; w += static_cast<long long>(step) * kUnroll) {
    for (int k0 = 0; k0 < n; k0 += kGroup) {
      U v[kGroup][kUnroll];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        if (k0 + g < n) {
          const U* const in =
              static_cast<const U*>(p.in.at<S>(ring[k0 + g])) + src;
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

// Block (x, s) plays rank r on slice s. One card (S = Scope::kGpu): r = x,
// one zeroed flag per (rank, slice). Across processes (S = Scope::kSys):
// r is the process's local rank x, and each rank has one entry and one
// exit flag (kPeerEntry, kPeerExit) that every block of every other
// member adds one to, so a call adds (n - 1) slices to each; `before` is
// their count before the call, and each barrier waits for before +
// (n - 1) slices.
template <typename U, Scope S>
__device__ __forceinline__ void alltoall_body(const Params& p, int r,
                                              int before) {
  const int n = p.n, my = p.rings.my[r];
  const int* const ring = p.rings.ring(r, n);
  const int flag = S == Scope::kGpu ? blockIdx.y : kPeerEntry;
  const int bar_base =
      S == Scope::kGpu ? 0 : before + (n - 1) * (gridDim.y - 1);

  members_barrier<S>(p.flags.at<S>(r) + flag, ring, n, r, [&](int m) {
    return p.flags.at<S>(m) + flag;
  }, bar_base);

  long long src, dst;
  if (p.group == kThreads) {
    // Long runs: this slice's units [lo, hi) of the block, run by run.
    const long long total = p.runs * p.run;
    const long long lo = total * blockIdx.y / gridDim.y;
    const long long hi = total * (blockIdx.y + 1) / gridDim.y;
    for (long long j = lo / p.run; j * p.run < hi; ++j) {
      run_offsets(p, my, j, &src, &dst);
      const long long base = j * p.run;
      copy_run<U, S>(p, ring, src, dst,
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
      copy_run<U, S>(p, ring, src, dst, threadIdx.x % p.group, p.run, p.group);
    }
  }
  if constexpr (S == Scope::kSys) {
    // No member may return, and reuse its input, while a peer can still
    // read it.
    exit_barrier<S>(p.flags.at<S>(r) + kPeerExit, ring, n, r, [&](int m) {
      return p.flags.at<S>(m) + kPeerExit;
    }, bar_base);
  }
}

// U: the unit of access (16, 8, 4, 2 or 1 bytes).
template <typename U>
__global__ void __launch_bounds__(kThreads)
alltoall_kernel(const __grid_constant__ Params p) {
  alltoall_body<U, Scope::kGpu>(p, blockIdx.x, 0);
}

// The cross-process instance: Params over device tables of every
// member's peer-mapped input and flags (and this process's outputs; block
// x plays flat rank rings.local[x]), and the flags' count before the call.
struct PeerParams {
  Params p;
  int before;
};

template <typename U>
__global__ void __launch_bounds__(kThreads)
alltoall_peer_kernel(const __grid_constant__ PeerParams q) {
  alltoall_body<U, Scope::kSys>(q.p, q.p.rings.local[blockIdx.x],
                                q.before);
}

template <typename U, bool kPeer>
void* kernel_for() {
  if constexpr (kPeer) {
    return reinterpret_cast<void*>(alltoall_peer_kernel<U>);
  } else {
    return reinterpret_cast<void*>(alltoall_kernel<U>);
  }
}

template <bool kPeer = false>
void* kernel_of(int unit) {
  switch (unit) {
    case 16: return kernel_for<uint4, kPeer>();
    case 8: return kernel_for<uint2, kPeer>();
    case 4: return kernel_for<unsigned int, kPeer>();
    case 2: return kernel_for<unsigned short, kPeer>();
    case 1: return kernel_for<unsigned char, kPeer>();
    default: return nullptr;
  }
}

template <bool kPeer>
int max_blocks(int* blocks) {
  int per_sm = 1 << 30;
  cudaError_t err = cudaSuccess;
  const int units[] = {16, 8, 4, 2, 1};
  for (int unit : units) {
    int got = 0;
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &got, kernel_of<kPeer>(unit), kThreads, 0);
    }
    if (err == cudaSuccess && got < per_sm) per_sm = got;
  }
  return cooperative_blocks(err, per_sm, blocks);
}

// The sizes every launch must meet, and the run geometry of Params.
bool fill_geometry(Params& p, int unit, int n, int slices,
                   long long block_bytes, long long in_run,
                   long long in_pitch, long long out_run,
                   long long out_pitch, long long run, int group) {
  const auto divides = [](long long d, long long v) {
    return d > 0 && v % d == 0;
  };
  const long long run_units = run > 0 ? run / unit : 0;
  if (n < 2 || slices < 1 || slices > 65535 ||
      block_bytes < 1 || !divides(run, in_run) || !divides(run, out_run) ||
      !divides(in_run, block_bytes) || !divides(out_run, block_bytes) ||
      !divides(unit, run) || in_pitch % unit || out_pitch % unit ||
      in_pitch < n * in_run || out_pitch < n * out_run || group < 1 ||
      group > kThreads || (group & (group - 1)) ||
      (group < kThreads && group > run_units)) {
    return false;
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
  return true;
}

}  // namespace

extern "C" {

// Ints of flags each (rank, slice) needs.
int gtt_alltoall_flag_stride() { return kFlagStride; }

// The most all-to-all blocks that can be resident at once on the current
// device (the cooperative launch's limit), in *blocks.
int gtt_alltoall_max_blocks(int* blocks) { return max_blocks<false>(blocks); }

// The same for the cross-process instances.
int gtt_alltoall_peer_max_blocks(int* blocks) {
  return max_blocks<true>(blocks);
}

// Returns a cudaError_t; 0 is success. Rank r's input is x + r * in_stride
// and its output out + r * out_stride (bytes); flags: ranks x slices x
// flag_stride zeroed ints. my: each rank's ring index; members: ranks x n
// flat ranks, row r the ring of rank r in ring order (host arrays, checked
// before the launch); table: the same tables in device memory
// (ring_common.cuh's Rings), which the kernel reads. A block is
// block_bytes: rows of in_run bytes in_pitch apart on the input (block k
// at k in_run along a row), rows of out_run bytes out_pitch apart on the
// output (block k at k out_run). run: the bytes copied as one contiguous
// piece on both sides, dividing in_run and out_run; unit: bytes per access
// (16, 8, 4, 2 or 1), dividing run, both pitches and every buffer's
// alignment; group: threads per run, kThreads (256) or a power of two no
// larger than run / unit.
int gtt_alltoall(const void* x, long long in_stride, void* out,
                 long long out_stride, int* flags, int flag_stride,
                 const int* my, const int* members, const int* table,
                 int ranks, int n, int slices, long long block_bytes,
                 long long in_run, long long in_pitch, long long out_run,
                 long long out_pitch, long long run, int unit, int group,
                 void* stream) {
  void* fn = kernel_of(unit);
  Params p;
  memset(&p, 0, sizeof(p));
  if (fn == nullptr || ranks < 2 || n > ranks ||
      !fill_geometry(p, unit, n, slices, block_bytes, in_run, in_pitch,
                     out_run, out_pitch, run, group) ||
      in_stride % unit || out_stride % unit ||
      reinterpret_cast<uintptr_t>(x) % unit ||
      reinterpret_cast<uintptr_t>(out) % unit ||
      flag_stride != kFlagStride ||
      !check_rings(my, members, nullptr, ranks, ranks, n, table)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.in = strided(x, in_stride);
  p.out = strided(out, out_stride);
  p.flags = strided(flags, static_cast<long long>(slices) * flag_stride *
                               static_cast<long long>(sizeof(int)));
  p.rings = rings_at(table, ranks, ranks);
  void* args[] = {&p};
  cudaError_t err = cudaLaunchCooperativeKernel(
      fn, dim3(ranks, slices), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream));
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

// The cross-process instance: one cooperative launch of grid (local_ranks,
// slices) per process. in and flags: `ranks` host arrays of device
// pointers by flat rank (each member's input, peer-mapped or this
// process's own, and its kPeerFlags flag ints), d_in and d_flags the same
// arrays in device memory (tpu/peer.py's PeerWorkspace.device_table); out:
// this process's outputs, local rank x's at out + x * out_stride; local:
// the flat ranks this process plays; my, members and table as
// gtt_alltoall's (members' rows read for the local ranks; table's local
// part is this process's); the block geometry as gtt_alltoall's. before: the
// flags' count before this call (each call adds (n - 1) slices to each);
// every process of the ring makes the same calls in the same order with
// the same slices.
int gtt_alltoall_peer(const void* const* in, void* out, long long out_stride,
                      int* const* flags, const void* const* d_in,
                      int* const* d_flags, const int* local, int local_ranks,
                      const int* my, const int* members, const int* table,
                      int ranks, int n, int slices, long long block_bytes,
                      long long in_run, long long in_pitch, long long out_run,
                      long long out_pitch, long long run, int unit,
                      int group, int before, void* stream) {
  void* fn = kernel_of<true>(unit);
  PeerParams q;
  memset(&q, 0, sizeof(q));
  Params& p = q.p;
  if (fn == nullptr || ranks < 2 || n > ranks || local_ranks < 1 ||
      local_ranks > ranks || before < 0 || d_in == nullptr ||
      d_flags == nullptr ||
      !fill_geometry(p, unit, n, slices, block_bytes, in_run, in_pitch,
                     out_run, out_pitch, run, group) ||
      out_stride % unit || reinterpret_cast<uintptr_t>(out) % unit ||
      !check_rings(my, members, local, local_ranks, ranks, n, table) ||
      !check_pointers(in, ranks, unit) || !check_pointers(flags, ranks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.in = tabled(d_in);
  p.out = strided(out, out_stride);
  p.flags = tabled(d_flags);
  p.rings = rings_at(table, ranks, local_ranks);
  q.before = before;
  void* args[] = {&q};
  cudaError_t err = cudaLaunchCooperativeKernel(
      fn, dim3(local_ranks, slices), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream));
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

const char* gtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
