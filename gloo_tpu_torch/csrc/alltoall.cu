// All-to-all along one ring of ranks for Hopper (sm_90a), with a plain C
// interface.
//
// Replaces gloo_tpu/ops/pallas_ring.py::_alltoall_kernel (B8), the Pallas
// TPU kernel behind pallas_alltoall: every rank's buffer is n blocks of
// chunk bytes, and block j of rank r's output is block (ring index of r)
// of its ring member j. Any element type: the kernel copies bytes.
//
// The ranks are a world on one card, as in ring.cu: rank r's input, output
// and flags are its own buffers, reached through a table of per-rank
// pointers, and its part of the exchange runs as its own thread blocks. A
// (rank, ring index) -> flat rank table names each rank's peers, so a launch
// over more than one card needs only a table built from peer-mapped memory,
// flags at system scope and one cooperative launch per card.
//
// The TPU kernel's schedule, kept step for step (pallas_ring.py:1127-1161):
//   - the own block copied into place;
//   - an entry barrier with every peer: each rank adds one to the barrier
//     flag of its n - 1 peers and waits until its own reaches n - 1, so no
//     rank writes into a peer that has not entered the kernel;
//   - at step s = 1 .. n - 1, block (my + s) copied into slot my of peer
//     (my + s): each rank receives exactly one block per step, from
//     (my - s), so the copies of one step never collide;
//   - each rank then adds one to the receive flag of each peer it wrote and
//     waits until n - 1 blocks have landed in its own output (the TPU
//     kernel's per-step DMA semaphores).
// On one card the barrier and the receive flags are not needed for the
// result (the launch ends only when every block has), but the launch over
// several cards needs both; they are kept, and timed with the kernel.
//
// What bounds it on an H100: bytes. Each rank's input is read once and its
// output written once: 2 x the world's bytes (8 MiB at the Ulysses path's
// q, k, v or out, ~2.5 us at 3.35 TB/s). The design makes exactly that one
// pass, with 16-byte loads and stores where the blocks and buffers allow
// (8, 4, 2 or 1 bytes otherwise), over (rank, slice) blocks that each own
// a slice of every block; peer stores go through L2 (st.global.cg).
//
// Work division: grid (P, S). Block (r, j) plays rank r on slice j of each
// of its n blocks; each slice has its own flags, so no block waits for
// another block of its own rank. Blocks spin on flags other blocks set, so
// all must be resident: the launch is cooperative, S comes from the
// occupancy that gtt_alltoall_max_blocks reports, and every spin is
// bounded (~2 s, then __trap) by the helpers of ring_common.cuh.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "ring_common.cuh"

namespace {

using namespace gtt;

constexpr int kThreads = 256;

// Flags of one (rank, slice), zeroed per call.
constexpr int kEnter = 0;  // + 1 from each peer on entry
constexpr int kRecv = 1;   // + 1 from each peer once its block landed
constexpr int kFlagStride = 2;

struct Params {
  const void* in[kMaxRanks];
  void* out[kMaxRanks];
  int* flags[kMaxRanks];
  int my[kMaxRanks];
  unsigned char members[kMaxRanks][kMaxRanks];  // ring index -> flat rank
  int n;
  long long chunk;  // units per block
};

// Thread 0 adds one to flag `which` of slice blockIdx.y of the n - 1 peers
// of rank r, after the block's stores so far.
__device__ inline void signal_peers(const Params& p, int r, int which) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    for (int s = 1; s < p.n; ++s) {
      const int peer = p.members[r][wrap(p.my[r] + s, p.n)];
      add_release(p.flags[peer] + blockIdx.y * kFlagStride + which, 1);
    }
  }
}

// U: the unit of access (16, 8, 4, 2 or 1 bytes).
template <typename U>
__global__ void __launch_bounds__(kThreads) alltoall_kernel(const Params p) {
  const int r = blockIdx.x;
  const int n = p.n, my = p.my[r];
  const long long chunk = p.chunk;
  const long long lo = chunk * blockIdx.y / gridDim.y;
  const long long hi = chunk * (blockIdx.y + 1) / gridDim.y;
  const long long t0 = lo + threadIdx.x;
  const U* const in = static_cast<const U*>(p.in[r]);
  int* const fl_me = p.flags[r] + blockIdx.y * kFlagStride;

  U* const own = static_cast<U*>(p.out[r]) + my * chunk;
  for (long long u = t0; u < hi; u += kThreads) own[u] = in[my * chunk + u];

  signal_peers(p, r, kEnter);
  wait_flag(fl_me + kEnter, n - 1);

  for (int s = 1; s < n; ++s) {
    const int dst = wrap(my + s, n);
    U* const peer = static_cast<U*>(p.out[p.members[r][dst]]) + my * chunk;
    const U* const src = in + dst * chunk;
    for (long long u = t0; u < hi; u += kThreads) __stcg(peer + u, src[u]);
  }

  signal_peers(p, r, kRecv);
  wait_flag(fl_me + kRecv, n - 1);
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
// flat ranks, row r the ring of rank r in ring order. chunk_bytes: one
// block; unit: bytes per access (16, 8, 4, 2 or 1), dividing chunk_bytes
// and every buffer's alignment.
int gtt_alltoall(const void* x, long long in_stride, void* out,
                 long long out_stride, int* flags, int flag_stride,
                 const int* my, const int* members, int ranks, int n,
                 int slices, long long chunk_bytes, int unit, void* stream) {
  void* fn = kernel_of(unit);
  if (fn == nullptr || ranks < 2 || ranks > kMaxRanks || n < 2 ||
      n > ranks || slices < 1 || slices > 65535 || chunk_bytes < 1 ||
      chunk_bytes % unit != 0 || flag_stride != kFlagStride) {
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
  p.chunk = chunk_bytes / unit;
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
