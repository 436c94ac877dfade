// The ring allreduce variants for Hopper (sm_90a), with a plain C
// interface.
//
// Replaces three Pallas TPU kernels of gloo_tpu/ops/pallas_ring.py:
//   B9  _ring_allreduce_hbm_kernel    (ring_allreduce_hbm)
//       gtt_ring_allreduce_hbm
//   B10 _ring_allreduce_q8_kernel     (ring_allreduce_q8)
//       gtt_ring_allreduce_q8
//   B11 _ring_allreduce_bidir_kernel  (ring_allreduce_bidir)
//       gtt_ring_allreduce_bidir
//
// The model is ring.cu's (B3): the ranks are a world on one card, each
// rank's buffers its own, seen through a table of per-rank pointers and
// the ring tables, so a launch over cards needs only a table of
// peer-mapped pointers and flags at system scope. Grid (P, S): block
// (r, j) plays rank r on slice j of every chunk, each slice an
// independent ring with its own flags; B11's grid is (P, 2, S), one set
// of blocks per direction. Every block spins on flags other blocks set,
// so the launch is cooperative and the wrapper takes S from the occupancy
// that gtt_ring_variants_max_blocks reports. Every spin is bounded
// (ring_common.cuh: ~2 s, then __trap). Data another block wrote is read
// with ld.global.cg or cp.async.cg (L2), never through L1.
//
// B9, HBM streaming. On the TPU the ring buffers stay in HBM and the
// received chunk streams through VMEM in tiles, the next tile's DMA in
// flight while the current one is added. On Hopper every buffer is in HBM
// already; what carries over is the stream: each reduce-scatter step
// pulls the received chunk and the own chunk it adds into through shared
// memory in tiles of kTileUnits 16-byte units per operand, with cp.async
// into two buffers, tile t + 1's loads issued before tile t's add and
// store (pallas_ring.py:319-369). The outgoing chunk's stores into the
// right neighbour's slot are issued before the wait for the incoming one
// and drain while it lasts. The tile is chosen for the SM (32 KB of
// shared memory per block), not by the TPU's 256-row rule; tiling changes
// no value, since the add is elementwise. Chunk order and add order are
// B3's, so B9's output is bitwise B3's.
//
// B10, int8 wire. f32 only. Each reduce-scatter hop sends its outgoing
// chunk as int8 codes plus one f32 scale for the whole chunk
// (pallas_ring.py:515-519): scale = max|chunk| * f32(1 / 127), which is
// what XLA makes of the reference's max / 127, and q = clip(rint(x /
// max(scale, 1e-30)), +-127), a true division (rint: half to even). The
// scale is over the whole chunk while a block holds one slice of it, so
// every block reduces its slice's max|x|, folds it into its rank's cell
// for that step (atomicMax on the float's bits as an int, which orders
// like the float for x >= 0) and adds one to the cell's arrival count
// (release); thread 0 waits until every slice block of its rank has
// arrived (acquire) and reads the cell. That works because the launch is
// cooperative: every block is resident. The receiver accumulates
// acc = fma(q, scale, acc), one rounding, as the JAX reference computes
// it. The sender stores codes and scale straight into the right
// neighbour's wire slot (the TPU kernel's staging slots 2/3 exist only
// because a remote DMA needs a source buffer). Allgather: the owner of
// chunk my + 1 quantizes it once and adopts q0 * scale0 itself; the codes
// and scale then travel verbatim through per-step slots that are never
// reused (pallas_ring.py:584-595), and every rank decodes q * scale, so
// every rank ends bitwise equal.
//
// B11, bidirectional. Columns [0, cols/2) run B3's schedule to the right;
// columns [cols/2, cols) run the mirrored schedule to the left: its
// reduce-scatter sends chunk my + s and receives my + s + 1, its
// allgather forwards chunk my - 1 + s (pallas_ring.py:725-731, 791-793).
// That is B3 on the reversed ring (ring index -my, neighbours swapped)
// with chunk c' standing for chunk -c'. Each direction has its own comm
// slots and flags. A half-chunk is strided: chunk_rows rows of cols/2
// elements at a row pitch of cols, indexed by (row, unit in the row). On
// one card the two directions are two sets of blocks, so both directions'
// stores are in flight at once; the TPU's 2x link claim waits for the
// multi-card launch.
//
// With n = 2 the left and right neighbour are one rank; the flags stay
// per (rank, direction, slice) and per slot, so the two roles never share
// a counter.
//
// What bounds them on an H100: bytes. Each rank's input read once and its
// output written once, 2 P S at 3.35 TB/s (S bytes per rank); there is no
// arithmetic to speak of. The designs move more than that (the input copy,
// a comm-slot trip per reduce-scatter step, B10's two passes over each
// outgoing chunk) and pay a flag round trip per step, and B10 a rank-wide
// max per step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

#include "ring_common.cuh"

namespace {

using namespace gtt;

constexpr int kThreads = 256;
// B9's stream tile: 16-byte units per thread and operand, and per tile.
constexpr int kTilePerThread = 2;
constexpr int kTileUnits = kThreads * kTilePerThread;

enum Variant { kHbm = 0, kQ8 = 1, kBidir = 2 };

struct Params {
  // The peer table: rank r's buffers. in/out: n chunks; comm: B9 two
  // slots of one chunk, B10 the int8 wire (two reduce-scatter slots, then
  // n - 1 allgather slots, each one chunk of codes), B11 two directions of
  // two slots of one half-chunk; scales: B10's (n + 1) slots x S floats;
  // flags: B9/B10 S, B11 2 S sets of flag_stride ints; cells: B10's n
  // maxima then n arrival counts.
  const void* in[kMaxRanks];
  void* out[kMaxRanks];
  void* comm[kMaxRanks];
  float* scales[kMaxRanks];
  int* flags[kMaxRanks];
  int* cells[kMaxRanks];
  int my[kMaxRanks];
  int right[kMaxRanks];
  int left[kMaxRanks];
  int n;
  int flag_stride;
  long long chunk;       // B9/B10: 16-byte units per chunk
  long long chunk_rows;  // B11: rows per chunk
  long long half_units;  // B11: 16-byte units per row of one half
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(kPending) : "memory");
}

// The slice [lo, hi) of this block (16-byte units of a chunk of `chunk`).
__device__ __forceinline__ void slice_of(long long chunk, long long* lo,
                                         long long* hi) {
  const long long slice = blockIdx.y, slices = gridDim.y;
  *lo = chunk * slice / slices;
  *hi = chunk * (slice + 1) / slices;
}

// ---- B9 ----

// acc[u] = acc[u] + got[u] over this block's units [lo, hi), both operands
// streamed through shared memory in tiles, tile t + 1's cp.async loads
// issued before tile t's add and store. Each thread reads back only the
// shared units it loaded itself, so cp.async.wait_group is the only
// synchronisation a tile needs.
template <typename T>
__device__ void stream_add(uint4* acc, const uint4* got, long long lo,
                           long long hi,
                           uint4 (&tiles)[2][2][kTileUnits]) {
  const long long n_tiles = (hi - lo + kTileUnits - 1) / kTileUnits;
  auto load = [&](long long t, int buf) {
#pragma unroll
    for (int k = 0; k < kTilePerThread; ++k) {
      const int i = k * kThreads + threadIdx.x;
      const long long u = lo + t * kTileUnits + i;
      if (u < hi) {
        cp_async16(&tiles[buf][0][i], acc + u);
        cp_async16(&tiles[buf][1][i], got + u);
      }
    }
    cp_async_commit();
  };
  if (n_tiles > 0) load(0, 0);
  for (long long t = 0; t < n_tiles; ++t) {
    const int cur = static_cast<int>(t & 1);
    if (t + 1 < n_tiles) {
      load(t + 1, cur ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
#pragma unroll
    for (int k = 0; k < kTilePerThread; ++k) {
      const int i = k * kThreads + threadIdx.x;
      const long long u = lo + t * kTileUnits + i;
      if (u < hi) {
        __stcg(acc + u, add_units<T>(tiles[cur][0][i], tiles[cur][1][i]));
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) hbm_kernel(const Params p) {
  __shared__ uint4 tiles[2][2][kTileUnits];  // [buffer][acc, received]
  const int r = blockIdx.x;
  const int n = p.n, my = p.my[r], right = p.right[r], left = p.left[r];
  const long long chunk = p.chunk;
  long long lo, hi;
  slice_of(chunk, &lo, &hi);
  const long long t0 = lo + threadIdx.x;
  int* const fl_me = p.flags[r] + blockIdx.y * p.flag_stride;
  int* const fl_right = p.flags[right] + blockIdx.y * p.flag_stride;
  int* const fl_left = p.flags[left] + blockIdx.y * p.flag_stride;
  const uint4* const in = static_cast<const uint4*>(p.in[r]);
  uint4* const out = static_cast<uint4*>(p.out[r]);

  for (int c = 0; c < n; ++c) {
    for (long long u = t0; u < hi; u += kThreads) {
      out[c * chunk + u] = in[c * chunk + u];
    }
  }
  ring_barrier(fl_me, fl_left, fl_right);

  uint4* const slots = static_cast<uint4*>(p.comm[r]);
  uint4* const peer_slots = static_cast<uint4*>(p.comm[right]);
  for (int s = 0; s < n - 1; ++s) {
    const int slot = s & 1;
    if (s >= 2) wait_flag(fl_me + kAck + slot, s / 2);
    const uint4* src = out + wrap(my - s, n) * chunk;
    uint4* dst = peer_slots + slot * chunk;
    for (long long u = t0; u < hi; u += kThreads) {
      __stcg(dst + u, __ldcg(src + u));
    }
    signal_add(fl_right + kFull + slot, 1);
    wait_flag(fl_me + kFull + slot, s / 2 + 1);
    stream_add<T>(out + wrap(my - s - 1, n) * chunk, slots + slot * chunk,
                  lo, hi, tiles);
    signal_add(fl_left + kAck + slot, 1);
  }
  if (n >= 3) wait_flag(fl_me + kAck + ((n - 3) & 1), (n - 3) / 2 + 1);
  wait_flag(fl_me + kAck + ((n - 2) & 1), (n - 2) / 2 + 1);

  uint4* const peer_out = static_cast<uint4*>(p.out[right]);
  for (int s = 0; s < n - 1; ++s) {
    const long long off = wrap(my + 1 - s, n) * chunk;
    for (long long u = t0; u < hi; u += kThreads) {
      __stcg(peer_out + off + u, __ldcg(out + off + u));
    }
    signal_set(fl_right + kGather + s, 1);
    wait_flag(fl_me + kGather + s, 1);
  }
}

// ---- B10 ----

// max|x| over the whole chunk `src` of this block's rank: this block's
// slice [lo, hi) folded into *cell, then a wait for every slice block of
// the rank (*count reaching `slices`). Returns the rank-wide max to every
// thread.
__device__ float chunk_absmax(const uint4* src, long long lo, long long hi,
                              int* cell, int* count, int slices) {
  __shared__ float warp_max[kThreads / 32];
  __shared__ float result;
  float m = 0.0f;
  for (long long u = lo + threadIdx.x; u < hi; u += kThreads) {
    const uint4 v = __ldcg(src + u);
    m = fmaxf(m, fmaxf(fmaxf(fabsf(__uint_as_float(v.x)),
                             fabsf(__uint_as_float(v.y))),
                       fmaxf(fabsf(__uint_as_float(v.z)),
                             fabsf(__uint_as_float(v.w)))));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
    atomicMax(cell, __float_as_int(m));
    add_release(count, 1);
    const long long start = clock64();
    while (ld_acquire(count) < slices) {
      if (clock64() - start > kSpinCycles) __trap();
    }
    result = __int_as_float(ld_acquire(cell));
  }
  __syncthreads();
  return result;
}

// Four f32 lanes to four int8 codes, lane k in byte k.
__device__ __forceinline__ unsigned quantize4(uint4 v, float safe) {
  const unsigned bits[4] = {v.x, v.y, v.z, v.w};
  unsigned packed = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float q = rintf(__fdiv_rn(__uint_as_float(bits[k]), safe));
    q = fminf(fmaxf(q, -127.0f), 127.0f);
    packed |= (static_cast<unsigned>(static_cast<int>(q)) & 0xffu) << (8 * k);
  }
  return packed;
}

__device__ __forceinline__ float code(unsigned packed, int k) {
  return static_cast<float>(static_cast<signed char>(packed >> (8 * k)));
}

__device__ __forceinline__ uint4 decode4(unsigned packed, float scale) {
  return make_uint4(__float_as_uint(__fmul_rn(code(packed, 0), scale)),
                    __float_as_uint(__fmul_rn(code(packed, 1), scale)),
                    __float_as_uint(__fmul_rn(code(packed, 2), scale)),
                    __float_as_uint(__fmul_rn(code(packed, 3), scale)));
}

// acc + q * scale per lane, rounded once (fma).
__device__ __forceinline__ uint4 accumulate4(uint4 acc, unsigned packed,
                                             float scale) {
  return make_uint4(
      __float_as_uint(__fmaf_rn(code(packed, 0), scale,
                                __uint_as_float(acc.x))),
      __float_as_uint(__fmaf_rn(code(packed, 1), scale,
                                __uint_as_float(acc.y))),
      __float_as_uint(__fmaf_rn(code(packed, 2), scale,
                                __uint_as_float(acc.z))),
      __float_as_uint(__fmaf_rn(code(packed, 3), scale,
                                __uint_as_float(acc.w))));
}

// max|chunk| / 127 as the JAX reference computes it: XLA turns the
// division by the constant into a product with f32(1 / 127), rounded once.
__device__ __forceinline__ float scale_of(float absmax) {
  return __fmul_rn(absmax, 0x1.020408p-7f);
}

__global__ void __launch_bounds__(kThreads) q8_kernel(const Params p) {
  const int r = blockIdx.x, j = blockIdx.y, slices = gridDim.y;
  const int n = p.n, my = p.my[r], right = p.right[r], left = p.left[r];
  const long long chunk = p.chunk;
  long long lo, hi;
  slice_of(chunk, &lo, &hi);
  const long long t0 = lo + threadIdx.x;
  int* const fl_me = p.flags[r] + j * p.flag_stride;
  int* const fl_right = p.flags[right] + j * p.flag_stride;
  int* const fl_left = p.flags[left] + j * p.flag_stride;
  int* const cells = p.cells[r];
  const uint4* const in = static_cast<const uint4*>(p.in[r]);
  uint4* const out = static_cast<uint4*>(p.out[r]);
  // Wire slots: 0/1 reduce-scatter, 2 + s allgather step s.
  const unsigned* const wire = static_cast<const unsigned*>(p.comm[r]);
  unsigned* const peer_wire = static_cast<unsigned*>(p.comm[right]);
  const float* const scales = p.scales[r];
  float* const peer_scales = p.scales[right];

  for (int c = 0; c < n; ++c) {
    for (long long u = t0; u < hi; u += kThreads) {
      out[c * chunk + u] = in[c * chunk + u];
    }
  }
  ring_barrier(fl_me, fl_left, fl_right);

  for (int s = 0; s < n - 1; ++s) {
    const int slot = s & 1;
    if (s >= 2) wait_flag(fl_me + kAck + slot, s / 2);
    const uint4* src = out + wrap(my - s, n) * chunk;
    const float scale = scale_of(
        chunk_absmax(src, lo, hi, cells + s, cells + n + s, slices));
    const float safe = fmaxf(scale, 1e-30f);
    unsigned* dst = peer_wire + slot * chunk;
    for (long long u = t0; u < hi; u += kThreads) {
      __stcg(dst + u, quantize4(__ldcg(src + u), safe));
    }
    if (threadIdx.x == 0) __stcg(peer_scales + slot * slices + j, scale);
    signal_add(fl_right + kFull + slot, 1);
    wait_flag(fl_me + kFull + slot, s / 2 + 1);
    uint4* mine = out + wrap(my - s - 1, n) * chunk;
    const unsigned* got = wire + slot * chunk;
    const float got_scale = __ldcg(scales + slot * slices + j);
    for (long long u = t0; u < hi; u += kThreads) {
      __stcg(mine + u, accumulate4(__ldcg(mine + u), __ldcg(got + u),
                                   got_scale));
    }
    signal_add(fl_left + kAck + slot, 1);
  }
  if (n >= 3) wait_flag(fl_me + kAck + ((n - 3) & 1), (n - 3) / 2 + 1);
  wait_flag(fl_me + kAck + ((n - 2) & 1), (n - 2) / 2 + 1);

  // Allgather: quantize the owned chunk once, adopt its decoded values,
  // send the codes; then decode and forward what arrives.
  uint4* own = out + wrap(my + 1, n) * chunk;
  const float scale0 = scale_of(
      chunk_absmax(own, lo, hi, cells + n - 1, cells + 2 * n - 1, slices));
  const float safe0 = fmaxf(scale0, 1e-30f);
  for (long long u = t0; u < hi; u += kThreads) {
    const unsigned q = quantize4(__ldcg(own + u), safe0);
    __stcg(peer_wire + 2 * chunk + u, q);
    __stcg(own + u, decode4(q, scale0));
  }
  if (threadIdx.x == 0) __stcg(peer_scales + 2 * slices + j, scale0);
  signal_set(fl_right + kGather, 1);
  for (int s = 0; s < n - 1; ++s) {
    wait_flag(fl_me + kGather + s, 1);
    const bool forward = s < n - 2;
    const unsigned* got = wire + (2 + s) * chunk;
    const float got_scale = __ldcg(scales + (2 + s) * slices + j);
    uint4* dec = out + wrap(my - s, n) * chunk;
    unsigned* fwd = peer_wire + (3 + s) * chunk;
    for (long long u = t0; u < hi; u += kThreads) {
      const unsigned q = __ldcg(got + u);
      __stcg(dec + u, decode4(q, got_scale));
      if (forward) __stcg(fwd + u, q);
    }
    if (forward) {
      if (threadIdx.x == 0) {
        __stcg(peer_scales + (3 + s) * slices + j, got_scale);
      }
      signal_set(fl_right + kGather + s + 1, 1);
    }
  }
}

// ---- B11 ----

template <typename T>
__global__ void __launch_bounds__(kThreads) bidir_kernel(const Params p) {
  const int r = blockIdx.x, d = blockIdx.y;
  const int j = blockIdx.z, slices = gridDim.z;
  const int n = p.n;
  // Direction 1 is B3 on the reversed ring: ring index -my, sending to
  // the left, chunk c' standing for chunk -c'.
  const int my = d ? wrap(-p.my[r], n) : p.my[r];
  const int to = d ? p.left[r] : p.right[r];
  const int from = d ? p.right[r] : p.left[r];
  const long long hu = p.half_units, rows = p.chunk_rows;
  const long long half = rows * hu;
  const long long lo = half * j / slices, hi = half * (j + 1) / slices;
  const long long t0 = lo + threadIdx.x;
  const int set = d * slices + j;
  int* const fl_me = p.flags[r] + set * p.flag_stride;
  int* const fl_to = p.flags[to] + set * p.flag_stride;
  int* const fl_from = p.flags[from] + set * p.flag_stride;
  const uint4* const in = static_cast<const uint4*>(p.in[r]);
  uint4* const out = static_cast<uint4*>(p.out[r]);
  // Chunk c' of this direction starts at `base(c')` units; unit u of its
  // half lies at (row, unit in the row) = (u / hu, u % hu) from there.
  auto base = [&](int c) { return wrap(d ? -c : c, n) * rows * 2 * hu; };
  // Runs body(u, offset of unit u in a chunk) over this thread's units u =
  // t0, t0 + kThreads, ... < hi, stepping (row, unit) without a divide.
  const long long step_rows = kThreads / hu, step_units = kThreads % hu;
  auto walk = [&](auto&& body) {
    long long row = t0 / hu, cu = t0 % hu;
    for (long long u = t0; u < hi; u += kThreads) {
      body(u, row * 2 * hu + d * hu + cu);
      row += step_rows;
      cu += step_units;
      if (cu >= hu) {
        cu -= hu;
        ++row;
      }
    }
  };

  for (int c = 0; c < n; ++c) {
    const long long b = base(c);
    walk([&](long long, long long off) { out[b + off] = in[b + off]; });
  }
  ring_barrier(fl_me, fl_from, fl_to);

  uint4* const slots = static_cast<uint4*>(p.comm[r]) + d * 2 * half;
  uint4* const peer_slots = static_cast<uint4*>(p.comm[to]) + d * 2 * half;
  for (int s = 0; s < n - 1; ++s) {
    const int slot = s & 1;
    if (s >= 2) wait_flag(fl_me + kAck + slot, s / 2);
    uint4* dst = peer_slots + slot * half;
    const uint4* src = out + base(my - s);
    walk([&](long long u, long long off) {
      __stcg(dst + u, __ldcg(src + off));
    });
    signal_add(fl_to + kFull + slot, 1);
    wait_flag(fl_me + kFull + slot, s / 2 + 1);
    const uint4* got = slots + slot * half;
    uint4* mine = out + base(my - s - 1);
    walk([&](long long u, long long off) {
      __stcg(mine + off, add_units<T>(__ldcg(mine + off), __ldcg(got + u)));
    });
    signal_add(fl_from + kAck + slot, 1);
  }
  if (n >= 3) wait_flag(fl_me + kAck + ((n - 3) & 1), (n - 3) / 2 + 1);
  wait_flag(fl_me + kAck + ((n - 2) & 1), (n - 2) / 2 + 1);

  uint4* const peer_out = static_cast<uint4*>(p.out[to]);
  for (int s = 0; s < n - 1; ++s) {
    const long long b = base(my + 1 - s);
    walk([&](long long, long long off) {
      __stcg(peer_out + b + off, __ldcg(out + b + off));
    });
    signal_set(fl_to + kGather + s, 1);
    wait_flag(fl_me + kGather + s, 1);
  }
}

void* kernel_for(int variant, int dtype) {
  if (variant == kHbm && dtype == 0) return (void*)hbm_kernel<__nv_bfloat16>;
  if (variant == kHbm && dtype == 1) return (void*)hbm_kernel<float>;
  if (variant == kQ8 && dtype == 1) return (void*)q8_kernel;
  if (variant == kBidir && dtype == 0) {
    return (void*)bidir_kernel<__nv_bfloat16>;
  }
  if (variant == kBidir && dtype == 1) return (void*)bidir_kernel<float>;
  return nullptr;
}

// Fills the peer table from per-rank strides (bytes) off base pointers and
// launches. sets: flag sets per rank (S, or 2 S for B11).
int run(int variant, const void* in, void* out, long long rank_stride,
        void* comm, long long comm_stride, float* scales,
        long long scales_stride, int* flags, int flag_stride, const int* my,
        const int* right, const int* left, int ranks, int n, int slices,
        long long chunk, long long chunk_rows, long long half_units,
        int dtype, void* stream) {
  const int sets = variant == kBidir ? 2 * slices : slices;
  void* fn = kernel_for(variant, dtype);
  if (fn == nullptr || ranks < 2 || ranks > kMaxRanks || n < 2 || n > ranks ||
      slices < 1 || slices > 65535 || flag_stride < kGather + n - 1 ||
      (variant != kBidir && chunk < 1) ||
      (variant == kBidir && (chunk_rows < 1 || half_units < 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  memset(&p, 0, sizeof(p));
  // B10's cells follow every rank's flag sets.
  int* const cells = flags + static_cast<long long>(ranks) * sets * flag_stride;
  for (int r = 0; r < ranks; ++r) {
    if (my[r] < 0 || my[r] >= n || right[r] < 0 || right[r] >= ranks ||
        left[r] < 0 || left[r] >= ranks) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    p.in[r] = static_cast<const char*>(in) + r * rank_stride;
    p.out[r] = static_cast<char*>(out) + r * rank_stride;
    p.comm[r] = static_cast<char*>(comm) + r * comm_stride;
    p.scales[r] = scales ? reinterpret_cast<float*>(
                               reinterpret_cast<char*>(scales) +
                               r * scales_stride)
                         : nullptr;
    p.flags[r] = flags + static_cast<long long>(r) * sets * flag_stride;
    p.cells[r] = cells + 2 * n * r;
    p.my[r] = my[r];
    p.right[r] = right[r];
    p.left[r] = left[r];
  }
  p.n = n;
  p.flag_stride = flag_stride;
  p.chunk = chunk;
  p.chunk_rows = chunk_rows;
  p.half_units = half_units;
  const dim3 grid = variant == kBidir ? dim3(ranks, 2, slices)
                                      : dim3(ranks, slices);
  void* args[] = {&p};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      fn, grid, dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

extern "C" {

// Ints of flags each (rank, slice), or (rank, direction, slice) for B11,
// needs for a ring of n.
int gtt_ring_variants_flag_stride(int n) {
  return kGather + (n > 1 ? n - 1 : 1);
}

// The most blocks of any of the three kernels that can be resident at
// once on the current device (the cooperative launch's limit), in
// *blocks.
int gtt_ring_variants_max_blocks(int* blocks) {
  int per_sm = 1 << 30;
  cudaError_t err = cudaSuccess;
  for (int variant = 0; variant < 3; ++variant) {
    for (int dtype = 0; dtype < 2; ++dtype) {
      const void* fn = kernel_for(variant, dtype);
      if (fn == nullptr || err != cudaSuccess) continue;
      int n = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, kThreads,
                                                          0);
      if (err == cudaSuccess && n < per_sm) per_sm = n;
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

// Each returns a cudaError_t; 0 is success. x and out: P ranks of n
// chunks at rank_stride bytes, every buffer 16-byte aligned. dtype: 0 =
// bf16, 1 = f32. my/right/left: host arrays of `ranks` ints. flags:
// zeroed, P x S x flag_stride ints (B11: P x 2 x S x flag_stride), and
// for B10 then 2 n P more.

// B9: chunk = 16-byte units per chunk; comm: P x 2 chunks.
int gtt_ring_allreduce_hbm(const void* x, void* out, long long rank_stride,
                           void* comm, long long comm_stride, int* flags,
                           int flag_stride, const int* my, const int* right,
                           const int* left, int ranks, int n, int slices,
                           long long chunk, int dtype, void* stream) {
  return run(kHbm, x, out, rank_stride, comm, comm_stride, nullptr, 0, flags,
             flag_stride, my, right, left, ranks, n, slices, chunk, 0, 0,
             dtype, stream);
}

// B10 (f32): chunk = 16-byte units (4 floats) per chunk; wire: P x (n + 1)
// chunks of int8 codes (chunk * 4 bytes each); scales: P x (n + 1) x S
// floats.
int gtt_ring_allreduce_q8(const void* x, void* out, long long rank_stride,
                          void* wire, long long wire_stride, float* scales,
                          long long scales_stride, int* flags,
                          int flag_stride, const int* my, const int* right,
                          const int* left, int ranks, int n, int slices,
                          long long chunk, void* stream) {
  return run(kQ8, x, out, rank_stride, wire, wire_stride, scales,
             scales_stride, flags, flag_stride, my, right, left, ranks, n,
             slices, chunk, 0, 0, 1, stream);
}

// B11: chunk_rows rows per chunk, half_units 16-byte units per row of one
// column half (a row is 2 half_units); comm: P x 2 directions x 2 slots of
// chunk_rows x half_units units.
int gtt_ring_allreduce_bidir(const void* x, void* out, long long rank_stride,
                             void* comm, long long comm_stride, int* flags,
                             int flag_stride, const int* my,
                             const int* right, const int* left, int ranks,
                             int n, int slices, long long chunk_rows,
                             long long half_units, int dtype, void* stream) {
  return run(kBidir, x, out, rank_stride, comm, comm_stride, nullptr, 0,
             flags, flag_stride, my, right, left, ranks, n, slices, 0,
             chunk_rows, half_units, dtype, stream);
}

const char* gtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
