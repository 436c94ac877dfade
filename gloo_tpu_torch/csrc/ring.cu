// Ring allreduce, reduce-scatter and allgather for Hopper (sm_90a), with a
// plain C interface.
//
// Replaces three Pallas TPU kernels of gloo_tpu/ops/pallas_ring.py:
//   B3  _ring_allreduce_kernel       (ring_allreduce)       gtt_ring_allreduce
//   B4a _ring_reduce_scatter_kernel  (ring_reduce_scatter)  gtt_ring_reduce_scatter
//   B4b _ring_allgather_kernel       (ring_allgather)       gtt_ring_allgather
//
// The ranks are a world on one card: rank r's input, output, two comm
// slots and flags are its own buffers in device memory, and its part of
// the ring runs as its own thread blocks. The kernel sees them only
// through a table of per-rank pointers and the ring tables (ring index,
// right and left flat rank of every rank), so a launch over more than one
// card needs only a table built from peer-mapped memory, flags at system
// scope (.sys in place of .gpu below) and one cooperative launch per card.
//
// What the TPU kernels do, and this one does the same, step for step:
//   - an entry barrier with both neighbours;
//   - reduce-scatter, n - 1 steps: push chunk (my - shift - s) mod n into
//     the right neighbour's comm slot s mod 2, wait for the own slot to
//     fill, add it into chunk (my - shift - s - 1) mod n (own + received,
//     one add per step in the input type), ack the left neighbour. A slot
//     is reused (s >= 2) only after the right neighbour's ack; the acks are
//     drained at the end, which also shows that the right neighbour has
//     finished its reduce-scatter before anyone writes into its output;
//   - allgather, n - 1 steps: forward chunk (first - s) mod n verbatim into
//     the right neighbour's output at the same offset, one flag per step
//     (a shared flag would let a neighbour a step ahead release the wait
//     before the matching chunk landed).
// B3 runs both phases (shift 0, first = my + 1); B4a the first with start
// shift 1 so that chunk r ends on rank r; B4b the second (first = my) on an
// output laid out by rank. Since the allgather forwards finished chunks
// verbatim, every rank of a B3 ring ends bitwise equal.
//
// Work division: grid (P, S). Block (r, j) plays rank r on slice j of every
// chunk; each slice is an independent ring with its own flags, so no block
// waits for another block of its own rank. Every block spins on flags that
// other blocks set, so all must be resident at once: the launch is
// cooperative (cudaLaunchCooperativeKernel refuses a grid that cannot be),
// and the wrapper takes S from the occupancy that gtt_ring_max_blocks
// reports. Every spin is bounded: after ~2 s of clock64() the block traps,
// so a protocol fault surfaces as a CUDA error, not a hung card.
//
// Memory order (the flag helpers are in ring_common.cuh, shared with
// overlap.cu): a sender's threads store into the peer's buffer, then
// __syncthreads(), then one thread fences and publishes with a release
// (red.release.gpu / st.release.gpu). A receiver's thread 0 spins on an
// acquire load, then __syncthreads(). Data another block wrote (comm slots,
// and in the allgather the chunks a neighbour wrote into this rank's
// output) is read with ld.global.cg: an SM's L1 is not coherent with
// stores from other SMs, and B3 reads comm slot 0 at step 0 and again at
// step 2.
//
// What bounds it on an H100: bytes. Each rank's input must be read once
// and its output written once (B3 at the DDP gradient shape, P = 4 and
// 6.95 MB per rank: 2 P S = 55.6 MB at 3.35 TB/s = 0.0166 ms); there is no
// arithmetic to speak of (P - 1 adds per element). The design makes one
// pass of loads and stores per ring step with 16-byte accesses where the
// chunk allows them; each reduce-scatter step also carries the chunk
// through a comm slot (one store and one load more than the bound counts),
// and every step costs a flag round trip between blocks.
//
// Numerics: one add per step in the input type (add1 in ring_common.cuh:
// bf16 and f16 in f32 rounded once, f32 and f64 IEEE without contraction,
// int32 and int64 wrapping), as the TPU kernel's o_ref + comm_ref and the
// plain twin in gloo_tpu_torch/ops/ring.py do, so kernel and twin agree
// bitwise. B3 and B4a take bf16, f16, f32, f64, int32 and int64. B4b only
// moves bytes, so it takes any type: its instances are by unit width (16,
// 8, 4, 2 or 1 bytes), not by element type.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstring>

#include "ring_common.cuh"

namespace {

using namespace gtt;

constexpr int kThreads = 256;

enum Mode { kAllreduce = 0, kReduceScatter = 1, kAllgather = 2 };

struct Params {
  // The peer table: rank r's buffers. in: n chunks (B3, B4a) or one (B4b);
  // out: n chunks (B3, B4b) or one (B4a); work: B4a's working copy;
  // comm: two slots of one chunk; flags: slices x flag_stride ints.
  const void* in[kMaxRanks];
  void* out[kMaxRanks];
  void* work[kMaxRanks];
  void* comm[kMaxRanks];
  int* flags[kMaxRanks];
  int my[kMaxRanks];
  int right[kMaxRanks];
  int left[kMaxRanks];
  int n;
  int flag_stride;
  long long chunk;  // units (16-byte vectors or single elements) per chunk
};

// T: element type; U: the unit of access (uint4, or the element's bits).
// The allgather only copies units, and its instances take T = U.
template <typename T, typename U, int kMode>
__global__ void __launch_bounds__(kThreads)
ring_kernel(const Params p) {
  const int r = blockIdx.x;
  const int n = p.n, my = p.my[r], right = p.right[r], left = p.left[r];
  const long long chunk = p.chunk;
  const long long lo = chunk * blockIdx.y / gridDim.y;
  const long long hi = chunk * (blockIdx.y + 1) / gridDim.y;
  const long long t0 = lo + threadIdx.x;
  int* const fl_me = p.flags[r] + blockIdx.y * p.flag_stride;
  int* const fl_right = p.flags[right] + blockIdx.y * p.flag_stride;
  int* const fl_left = p.flags[left] + blockIdx.y * p.flag_stride;
  const U* const in = static_cast<const U*>(p.in[r]);
  U* const out = static_cast<U*>(p.out[r]);
  // The buffer the reduce-scatter accumulates in.
  U* const acc = static_cast<U*>(kMode == kReduceScatter ? p.work[r]
                                                         : p.out[r]);

  // Own input into place: every chunk (B3, B4a), or chunk `my` (B4b).
  if (kMode == kAllgather) {
    for (long long u = t0; u < hi; u += kThreads) {
      out[my * chunk + u] = in[u];
    }
  } else {
    for (int c = 0; c < n; ++c) {
      for (long long u = t0; u < hi; u += kThreads) {
        acc[c * chunk + u] = in[c * chunk + u];
      }
    }
  }

  ring_barrier(fl_me, fl_left, fl_right);

  if constexpr (kMode != kAllgather) {
    const int shift = kMode == kReduceScatter ? 1 : 0;
    U* const slots = static_cast<U*>(p.comm[r]);
    U* const peer_slots = static_cast<U*>(p.comm[right]);
    for (int s = 0; s < n - 1; ++s) {
      const int slot = s & 1;
      // Slot reuse: the right neighbour has emptied it s / 2 times.
      if (s >= 2) wait_flag(fl_me + kAck + slot, s / 2);
      const U* src = acc + wrap(my - shift - s, n) * chunk;
      U* dst = peer_slots + slot * chunk;
      for (long long u = t0; u < hi; u += kThreads) {
        __stcg(dst + u, __ldcg(src + u));
      }
      signal_add(fl_right + kFull + slot, 1);
      wait_flag(fl_me + kFull + slot, s / 2 + 1);
      U* mine = acc + wrap(my - shift - s - 1, n) * chunk;
      const U* got = slots + slot * chunk;
      for (long long u = t0; u < hi; u += kThreads) {
        __stcg(mine + u, add_units<T>(__ldcg(mine + u), __ldcg(got + u)));
      }
      signal_add(fl_left + kAck + slot, 1);
    }
    // Drain the acks of the last two steps.
    if (n >= 3) wait_flag(fl_me + kAck + ((n - 3) & 1), (n - 3) / 2 + 1);
    wait_flag(fl_me + kAck + ((n - 2) & 1), (n - 2) / 2 + 1);
  }

  if (kMode == kReduceScatter) {
    for (long long u = t0; u < hi; u += kThreads) {
      out[u] = __ldcg(acc + my * chunk + u);
    }
    return;
  }

  // Allgather: rank r holds the finished chunk `first` and forwards.
  const int first = kMode == kAllreduce ? my + 1 : my;
  U* const peer_out = static_cast<U*>(p.out[right]);
  for (int s = 0; s < n - 1; ++s) {
    const long long off = wrap(first - s, n) * chunk;
    for (long long u = t0; u < hi; u += kThreads) {
      __stcg(peer_out + off + u, __ldcg(out + off + u));
    }
    signal_set(fl_right + kGather + s, 1);
    wait_flag(fl_me + kGather + s, 1);
  }
}

// The element types of B3 and B4a by dtype code, each with its 16-byte
// vector unit and its single-element unit (the element's bits).
#define GTT_SUM_TYPES(X)           \
  X(0, __nv_bfloat16, unsigned short) \
  X(1, float, float)               \
  X(2, __half, unsigned short)     \
  X(3, double, double)             \
  X(4, int, int)                   \
  X(5, long long, long long)

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

template <int kMode>
cudaError_t launch_mode(const Params& p, int dtype, int vec, dim3 grid,
                        cudaStream_t stream) {
  void* fn = kernel_for<kMode>(dtype, vec);
  if (fn == nullptr) return cudaErrorInvalidValue;
  void* args[] = {const_cast<Params*>(&p)};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      fn, grid, dim3(kThreads), args, 0, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Fills the peer table from per-rank strides (bytes) off base pointers:
// rank r's buffer is base + r * stride, the layout of one world tensor.
int run(int mode, const void* in, long long in_stride, void* out,
        long long out_stride, void* work, long long work_stride, void* comm,
        long long comm_stride, int* flags, int flag_stride, const int* my,
        const int* right, const int* left, int ranks, int n, int slices,
        long long chunk, int dtype, int vec, void* stream) {
  if (ranks < 2 || ranks > kMaxRanks || n < 2 || n > ranks || slices < 1 ||
      chunk < 1 || flag_stride < kGather + n - 1 || slices > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  memset(&p, 0, sizeof(p));
  for (int r = 0; r < ranks; ++r) {
    if (my[r] < 0 || my[r] >= n || right[r] < 0 || right[r] >= ranks ||
        left[r] < 0 || left[r] >= ranks) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    p.in[r] = static_cast<const char*>(in) + r * in_stride;
    p.out[r] = static_cast<char*>(out) + r * out_stride;
    p.work[r] = work ? static_cast<char*>(work) + r * work_stride : nullptr;
    p.comm[r] = comm ? static_cast<char*>(comm) + r * comm_stride : nullptr;
    p.flags[r] = flags + static_cast<long long>(r) * slices * flag_stride;
    p.my[r] = my[r];
    p.right[r] = right[r];
    p.left[r] = left[r];
  }
  p.n = n;
  p.flag_stride = flag_stride;
  p.chunk = chunk;
  const dim3 grid(ranks, slices);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (mode == kAllreduce) err = launch_mode<kAllreduce>(p, dtype, vec, grid, s);
  if (mode == kReduceScatter) {
    err = launch_mode<kReduceScatter>(p, dtype, vec, grid, s);
  }
  if (mode == kAllgather) err = launch_mode<kAllgather>(p, dtype, vec, grid, s);
  return static_cast<int>(err);
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

// Ints of flags each (rank, slice) needs for a ring of n.
int gtt_ring_flag_stride(int n) { return kGather + (n > 1 ? n - 1 : 1); }

// The most blocks of any ring kernel that can be resident at once on the
// current device (the cooperative launch's limit), in *blocks.
int gtt_ring_max_blocks(int* blocks) {
  int per_sm = 1 << 30;
  cudaError_t err = cudaSuccess;
  for (int code = 0; code < 6; ++code) {
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
// 1 = f32, 2 = f16, 3 = f64, 4 = int32, 5 = int64. vec: units are 16-byte
// vectors (every chunk a whole number of them, every buffer 16-byte
// aligned), else single elements. B4b takes unit_bytes (16, 8, 4, 2 or 1,
// dividing the chunk and every buffer's start) in their place. chunk
// counts units. Strides are in bytes. my/right/left: host arrays of
// `ranks` ints.

int gtt_ring_allreduce(const void* x, void* out, long long rank_stride,
                       void* comm, long long comm_stride, int* flags,
                       int flag_stride, const int* my, const int* right,
                       const int* left, int ranks, int n, int slices,
                       long long chunk, int dtype, int vec, void* stream) {
  return run(kAllreduce, x, rank_stride, out, rank_stride, nullptr, 0, comm,
             comm_stride, flags, flag_stride, my, right, left, ranks, n,
             slices, chunk, dtype, vec, stream);
}

int gtt_ring_reduce_scatter(const void* x, long long in_stride, void* out,
                            long long out_stride, void* work, void* comm,
                            long long comm_stride, int* flags,
                            int flag_stride, const int* my, const int* right,
                            const int* left, int ranks, int n, int slices,
                            long long chunk, int dtype, int vec,
                            void* stream) {
  return run(kReduceScatter, x, in_stride, out, out_stride, work, in_stride,
             comm, comm_stride, flags, flag_stride, my, right, left, ranks,
             n, slices, chunk, dtype, vec, stream);
}

int gtt_ring_allgather(const void* x, long long in_stride, void* out,
                       long long out_stride, int* flags, int flag_stride,
                       const int* my, const int* right, const int* left,
                       int ranks, int n, int slices, long long chunk,
                       int unit_bytes, void* stream) {
  return run(kAllgather, x, in_stride, out, out_stride, nullptr, 0, nullptr,
             0, flags, flag_stride, my, right, left, ranks, n, slices, chunk,
             unit_bytes, 0, stream);
}

const char* gtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
