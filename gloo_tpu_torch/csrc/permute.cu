// The point-to-point transport of spmd across processes for Hopper
// (sm_90a), with a plain C interface: one pull over the peer workspace.
//
// Replaces no Pallas kernel. In the reference, ppermute, shift, broadcast
// and scatter are XLA collectives (lax.ppermute, and lax.psum of a value
// masked to the root: gloo_tpu/tpu/spmd.py:89-131), which span hosts once
// jax.distributed has joined them. Here a process mesh (tpu/multihost.py)
// has no such collective: NCCL refuses two ranks of one group on one card,
// so the transport rides the same peer-mapped workspace as the ring
// kernels' cross-process instances (peer.cu, tpu/peer.py), and every
// process makes one cooperative launch of this kernel.
//
// What it does: every rank's value lies in its row of the workspace's
// "in" region (tpu/peer.py), where every member of its ring can read it.
// Block (x, j) plays the process's local rank local[x] = r on slice j of
// its output (the tables in device memory: no rank ceiling): after an
// entry barrier among the members of r's ring (no peer's value is
// complete before its owner has entered), it copies
// `count` units from flat rank src[r]'s row, starting `offset[r]` units
// in, into r's output, or writes zeros where no pair names r as a
// destination (src[r] = -1). An exit barrier among the same members then
// lets each source reuse its row. ppermute and shift name one source per
// destination at offset 0; broadcast names the root for every member;
// scatter the root at offset (ring index) x count.
//
// Flags: each rank has one entry and one exit flag at system scope (.sys)
// in the workspace's "perm_flags" region, counters that only grow: every
// block of every other member adds one to each, so a call adds (n - 1) x
// slices, and the wrapper passes their count before the call (`before`).
// Nothing zeroes them, since a peer's add may land before the owner's
// zeroing (ring_common.cuh). Every rank of the ring takes part, with a
// source or without, so the counts stay the same in every process. The
// source rows are read through the non-coherent path (__ldg): no process
// writes its row during the launch. Each spin is bounded (~2 s, then
// __trap), so a protocol fault surfaces as a CUDA error.
//
// On one card the processes' contexts time-slice, so each barrier waits
// until the card has run every member's blocks; across cards the loads
// would ride NVLink. What bounds it: bytes, each output byte read once
// from its source and written once (2 x the bytes the ranks receive).

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "ring_common.cuh"

namespace {

using namespace gtt;

constexpr int kThreads = 256;
// Units each thread loads before it stores any.
constexpr int kUnroll = 4;

struct Params {
  // Every flat rank's row of "in" and its two flag ints (device tables);
  // local rank x's output; pairs (in device memory): local rank x's source
  // (flat rank or -1) at pairs[x] and its offset into the source's row, in
  // units, at pairs[local ranks + x].
  PerRank<const void> in;
  PerRank<int> flags;
  PerRank<void> out;
  const long long* pairs;
  Rings rings;  // in device memory; block x plays rings.local[x]
  int n;
  int local_ranks;
  int before;
  long long count;  // units per output
};

// U: the unit of access (16, 8, 4, 2 or 1 bytes).
template <typename U>
__global__ void __launch_bounds__(kThreads)
permute_peer_kernel(const __grid_constant__ Params p) {
  const int r = p.rings.local[blockIdx.x];
  const int n = p.n;
  const int* const ring = p.rings.ring(r, n);
  const int src = static_cast<int>(p.pairs[blockIdx.x]);
  const long long offset = p.pairs[p.local_ranks + blockIdx.x];
  const int base = p.before + (n - 1) * (static_cast<int>(gridDim.y) - 1);
  const auto flags = [&](int m) { return p.flags.at<Scope::kSys>(m); };
  members_barrier<Scope::kSys>(flags(r) + kBarrier, ring, n, r, [&](int m) {
    return flags(m) + kBarrier;
  }, base);

  const long long lo = p.count * blockIdx.y / gridDim.y;
  const long long hi = p.count * (blockIdx.y + 1) / gridDim.y;
  U* const out = static_cast<U*>(p.out.at(blockIdx.x));
  if (src < 0) {
    U zero;
    memset(&zero, 0, sizeof(zero));
    for (long long u = lo + threadIdx.x; u < hi; u += kThreads) {
      out[u] = zero;
    }
  } else {
    const U* const in =
        static_cast<const U*>(p.in.at<Scope::kSys>(src)) + offset;
    for (long long u0 = lo + threadIdx.x; u0 < hi;
         u0 += kThreads * kUnroll) {
      U v[kUnroll];
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) {
        if (u0 + i * kThreads < hi) v[i] = __ldg(in + u0 + i * kThreads);
      }
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) {
        if (u0 + i * kThreads < hi) out[u0 + i * kThreads] = v[i];
      }
    }
  }
  // No source reuses its row while a member can still read it.
  exit_barrier<Scope::kSys>(flags(r) + kPeerExit, ring, n, r, [&](int m) {
    return flags(m) + kPeerExit;
  }, base);
}

void* kernel_of(int unit) {
  switch (unit) {
    case 16: return reinterpret_cast<void*>(permute_peer_kernel<uint4>);
    case 8: return reinterpret_cast<void*>(permute_peer_kernel<uint2>);
    case 4: return reinterpret_cast<void*>(permute_peer_kernel<unsigned>);
    case 2:
      return reinterpret_cast<void*>(permute_peer_kernel<unsigned short>);
    case 1:
      return reinterpret_cast<void*>(permute_peer_kernel<unsigned char>);
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// The most blocks of the transport that can be resident at once on the
// current device (the cooperative launch's limit), in *blocks.
int gtt_permute_peer_max_blocks(int* blocks) {
  int per_sm = 1 << 30;
  cudaError_t err = cudaSuccess;
  for (int unit = 1; unit <= 16; unit *= 2) {
    int got = 0;
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &got, kernel_of(unit), kThreads, 0);
    }
    if (err == cudaSuccess && got < per_sm) per_sm = got;
  }
  return cooperative_blocks(err, per_sm, blocks);
}

// Returns a cudaError_t; 0 is success. One cooperative launch of grid
// (local_ranks, slices) per process. in and flags: `ranks` host arrays of
// device pointers by flat rank (each rank's row of "in", peer-mapped or
// this process's own, and its kPeerFlags flag ints), d_in and d_flags the
// same arrays in device memory (tpu/peer.py's PeerWorkspace.device_table);
// out: this process's outputs, local rank x's at out + x * out_stride
// bytes; local: the flat ranks this process plays; my: each rank's ring
// index; members: ranks x n flat ranks, row r the ring of rank r in ring
// order (read for the local ranks); table: the ring tables in device
// memory (ring_common.cuh's Rings, with this process's local ranks); src
// and offset: host arrays per local rank, the flat rank of its ring it
// pulls from (-1: zeros) and the offset into that rank's row, in units,
// and pairs their device copy (local_ranks sources, then as many offsets,
// as int64);
// count: units per output; unit: bytes per access (16, 8, 4, 2 or 1),
// dividing every row's and output's address. before: the flags' count
// before this call (each call adds (n - 1) x slices to each); every
// process of the ring makes the same calls in the same order with the
// same slices.
int gtt_permute_peer(const void* const* in, void* out, long long out_stride,
                     int* const* flags, const void* const* d_in,
                     int* const* d_flags, const int* local, int local_ranks,
                     const int* my, const int* members, const int* table,
                     int ranks, int n, const int* src,
                     const long long* offset, const long long* pairs,
                     int slices, long long count, int unit, int before,
                     void* stream) {
  void* fn = kernel_of(unit);
  if (fn == nullptr || ranks < 2 || n < 2 || n > ranks || local_ranks < 1 ||
      local_ranks > ranks || slices < 1 || slices > 65535 || count < 1 ||
      before < 0 || out_stride % unit ||
      reinterpret_cast<uintptr_t>(out) % unit || d_in == nullptr ||
      d_flags == nullptr || pairs == nullptr ||
      reinterpret_cast<uintptr_t>(pairs) % 8 ||
      !check_rings(my, members, local, local_ranks, ranks, n, table) ||
      !check_pointers(in, ranks, unit) || !check_pointers(flags, ranks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int x = 0; x < local_ranks; ++x) {
    const int r = local[x];
    // A source is a member of the destination's ring.
    bool member = src[x] == -1;
    for (int k = 0; k < n; ++k) {
      member = member || members[static_cast<long long>(r) * n + k] == src[x];
    }
    if (!member || offset[x] < 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  Params p;
  memset(&p, 0, sizeof(p));
  p.in = tabled(d_in);
  p.flags = tabled(d_flags);
  p.out = strided(out, out_stride);
  p.pairs = pairs;
  p.rings = rings_at(table, ranks, local_ranks);
  p.local_ranks = local_ranks;
  p.n = n;
  p.before = before;
  p.count = count;
  void* args[] = {&p};
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
