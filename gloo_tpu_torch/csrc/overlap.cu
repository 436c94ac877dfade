// Collective matmuls for Hopper (sm_90a), with a plain C interface.
//
// Replaces two Pallas TPU kernels of gloo_tpu/ops/overlap.py:
//   B5a _matmul_rs_kernel  (matmul_reduce_scatter)  gtt_matmul_rs
//   B5b _ag_matmul_kernel  (allgather_matmul)       gtt_ag_matmul
//
// As in ring.cu, the ranks are a world on one card: rank r's operands,
// outputs, comm slots and flags are its own buffers in device memory, its
// part of the ring runs as its own thread blocks, and a "send to the right
// neighbour" is a store into that rank's buffer.
//
// B5a, rows [my m/n, (my + 1) m/n) of sum_d X_d @ W_d, step for step as the
// TPU kernel: rank `my` sends partial(my - 1) to its right neighbour (write
// 0); at step s = 0 .. n - 2 it computes partial(my - 2 - s) (before it
// waits: the overlap the TPU kernel is for), takes the left neighbour's
// running sum (its write s) from its comm slot s mod 2, and stores tot =
// comm + partial into the right neighbour's slot (s + 1) mod 2 (write
// s + 1), or as the output at s = n - 2. partial(b) = X[b chunk] @ W
// accumulated in f32 and rounded to the element type; the add is one f32
// add rounded once, as the TPU kernel's comm[slot] + p. The add is the
// epilogue: the slot is read straight into the accumulator layout and tot
// stored straight into the neighbour's slot, with no staging buffer and no
// copy or add pass. A slot word carries its data beside the tag of the
// write that stored it (8 bytes, seen whole or not at all), so the taker
// polls the words themselves and the writer needs no fence or flag; a slot
// is written again only after the right neighbour's ack (a release/acquire
// counter, ring_common.cuh) of its previous contents, asked for before the
// step's product, off the hand-off's path; the last acks are drained.
//
// B5b, gather_rows(X) @ W and the gathered X: at step t = 0 .. n - 1 rank
// `my` computes y[my - t] = chunk(my - t) @ W, chunk my its own x and every
// other the one its left neighbour forwarded into its gx at step t - 1; at
// t < n - 1 it forwards the chunk into the right neighbour's gx (and at
// t = 0 into its own). y is rounded to the element type; gx is an exact
// copy. B5b forwards what it staged: each x slab that TMA brought into
// shared memory for the product is TMA-stored from there into the right
// neighbour's gx, so each x byte is read once per hop. Once the last slab's
// stores are complete (cp.async.bulk.wait_group 0, then fence.proxy.async
// into the generic proxy) the chunk's flag is released, before the last
// slab's product; a reader fences (fence.proxy.async.global) after its
// acquire, before its TMA loads.
//
// Work division: one block of one warpgroup per (rank, 64 x 64 output
// tile): grid (ranks, slices), block (r, j) walks tiles j, j + slices, ...
// (row tile major), each through the whole ring; slices = tiles where they
// can all be resident (64 blocks at the fused MLP's shape), fewer where
// not. Every block spins on what other blocks store, so all must be
// resident at once: the launch is cooperative, the wrapper takes the grid
// from gtt_overlap_max_blocks (an occupancy query with the kernels' real
// dynamic shared memory), and a grid that cannot be resident is refused.
// B5a's slots and acks are per (rank, tile); B5b's flags per (rank, row
// tile): the block of column tile 0 forwards the row tile's x, and every
// column tile of the right neighbour waits only for that flag.
//
// The product: operands are staged in shared memory by TMA
// (cp.async.bulk.tensor, completing on an mbarrier) in 128-byte "slabs" of
// depth (16-bit 64, f32 32) with the 128-byte swizzle, in a ring of `ring`
// slab buffers kept up to `ring` slabs ahead of the product, across the
// chunks of the walk (B5a's x chunks are all local; B5b's next chunk is
// loaded once its flag is seen). bf16 and f16 run wgmma m64n64k16 with f32
// accumulators in registers, a slab's 4 k-steps one group, retired one
// slab behind; W is read as it lies, row-major (MN-major B) or transposed
// (K-major B: B5b's VJP hands B5a w^T without a copy). f32 keeps full-f32
// FMA (no TF32) on the same staged slabs, in wgmma's accumulator layout.
// W's 64-column tile stays in shared memory for the whole walk (loaded
// once per block and column tile) where its depth is at most 8 slabs
// (16-bit k <= 512, f32 k <= 256); deeper W streams through the ring beside
// x. Rows and depth past the operands' ends come in as zeros (TMA's
// out-of-bounds fill) and are never stored.
//
// The TMA, mbarrier and wgmma helpers and the tensor-map encoder live in
// hopper.cuh, shared with flash_fwd.cu's B1.
//
// The wrapper (ops/overlap.py) hands TMA only what it can describe: rows
// of x, gx and W 16-byte aligned. Other strides (16-bit k or cols not a
// multiple of 8, f32 not a multiple of 4) are zero-padded in the wrapper.
//
// What bounds it on an H100: at the fused MLP's shape (4 ranks, 256 rows
// per rank, d_model 256, 256 columns per rank, bf16) the bytes would take
// 1.6 us (B5b reads x and W, 1 MB, and writes y and gx, 4.2 MB, at 3.35
// TB/s; its 0.54 GFLOP take 0.5 us at 989 TFLOP/s) and 0.9 us (B5a reads
// 2.6 MB and writes 0.5 MB). Neither is near that: both are bound by the
// ring's chain of n - 1 hand-offs between blocks on different SMs, each a
// store on one SM seen by a poll on another (microseconds each), behind a
// tile's product; chip_smoke.py times the kernels over rings of 2 and 8 to
// split the time into ring steps and the rest. The design keeps each
// hand-off to one tile's epilogue (B5a) or one tile's loads and stores
// (B5b), and spreads the products over 64 blocks.

#include <cuda.h>  // CUtensorMap and its enums (types only; no libcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <cstring>
#include <type_traits>

#include "flash_common.cuh"
#include "hopper.cuh"
#include "ring_common.cuh"

namespace {

using namespace gtt;

constexpr int kThreads = 128;  // one warpgroup
constexpr int kTileM = 64;     // wgmma's M
constexpr int kTileN = 64;     // wgmma's N: one W column tile
constexpr int kSlabBytes = 128;  // depth bytes per row of a slab
constexpr int kBufBytes = kTileM * kSlabBytes;  // an x or W slab, 8 KB
constexpr int kMaxRing = 16;

struct Params {
  // x: B5a (ranks, n, rows, k), B5b (ranks, 1, rows, k); gx: B5b
  // (ranks, n, rows, k); w: MN-major {cols, k, w ranks} or K-major
  // {k, cols, w ranks}. All with the 128-byte swizzle.
  CUtensorMap x;
  CUtensorMap gx;
  CUtensorMap w;
  // The peer table: out B5a (rows, cols), B5b y (n rows, cols); comm B5a
  // 2 slots of tiles x kTileWords 8-byte words, zeroed; flags tiles x
  // flag_stride ints, zeroed.
  void* out[kMaxRanks];
  void* comm[kMaxRanks];
  int* flags[kMaxRanks];
  int my[kMaxRanks];
  int right[kMaxRanks];
  int left[kMaxRanks];
  int n;
  int tiles;
  int col_tiles;
  int flag_stride;
  int rows;  // rows of one chunk
  int cols;
  int slabs;
  int ring;
  int w_resident;
  int w_shared;
};

// The bits of one element, for stores through L2.
template <typename T>
using Bits = std::conditional_t<sizeof(T) == 2, unsigned short, T>;

template <typename T>
__device__ __forceinline__ void store_cg(T* p, T v) {
  using B = Bits<T>;
  B b;
  memcpy(&b, &v, sizeof(T));
  __stcg(reinterpret_cast<B*>(p), b);
}

// ---- flags (ring_common.cuh's counters) ----

__device__ __forceinline__ int ld_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Thread 0 waits until *a >= ta and, where b is given, *b >= tb: both
// polled by relaxed loads in flight together, then one acquire fence; the
// block goes on together. Bounded like ring_common.cuh's wait_flag.
__device__ __forceinline__ void wait_flags(const int* a, int ta,
                                           const int* b, int tb) {
  if (threadIdx.x == 0) {
    const long long start = clock64();
    while (true) {
      const int va = ld_relaxed(a);
      const int vb = b ? ld_relaxed(b) : tb;
      if (va >= ta && vb >= tb) break;
      if (clock64() - start > kSpinCycles) __trap();
    }
    asm volatile("fence.acq_rel.gpu;" ::: "memory");
  }
  __syncthreads();
}

// The block's stores so far become visible (the barrier, then the
// release of thread 0's add), then one is added to *a and, where given,
// to *b.
__device__ __forceinline__ void publish(int* a, int* b) {
  __syncthreads();
  if (threadIdx.x == 0) {
    add_release(a, 1);
    if (b) add_release(b, 1);
  }
}

// ---- the product of one slab ----

// Byte offset of byte `b` of line `line` in a 128-byte-swizzled tile.
__device__ __forceinline__ int swz(int line, int b) {
  return line * 128 + ((((b >> 4) ^ line) & 7) << 4) + (b & 15);
}

// d += a (64 rows x one slab of depth) @ w (that depth x 64 columns).
// bf16 and f16: issues the slab's 4 wgmma k-steps as one group and returns
// with them in flight (wgmma_wait retires them); f32: FMA, done on return.
template <typename T, bool kKMajor>
__device__ __forceinline__ void slab_product(float* d, const uint8_t* a,
                                             const uint8_t* w) {
  if constexpr (sizeof(T) == 2) {
    const uint32_t sa = smem_addr(a), sw = smem_addr(w);
    __syncwarp();  // wgmma is issued by the converged warpgroup
    fence_acc(d);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // 16 of the slab's 64 depths: 32 bytes along a K-major line, 16
      // lines (2048 bytes) of an MN-major tile.
      wgmma_bf16<kKMajor ? 0 : 1, 0, T>(
          d, desc(sa + kk * 32), desc(sw + (kKMajor ? kk * 32 : kk * 2048)));
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  } else {
    static_assert(!kKMajor, "f32 takes W row-major only");
    // W's slab: two 32-column halves of 32 lines (depths) each.
    const int r0 = acc_row(0), r1 = acc_row(1);
#pragma unroll 4
    for (int kk = 0; kk < 32; ++kk) {
      const float a0 = *reinterpret_cast<const float*>(a + swz(r0, kk * 4));
      const float a1 = *reinterpret_cast<const float*>(a + swz(r1, kk * 4));
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = acc_col(j);
        const float2 b = *reinterpret_cast<const float2*>(
            w + (col / 32) * 4096 + swz(kk, (col % 32) * 4));
        d[4 * j + 0] = __fmaf_rn(a0, b.x, d[4 * j + 0]);
        d[4 * j + 1] = __fmaf_rn(a0, b.y, d[4 * j + 1]);
        d[4 * j + 2] = __fmaf_rn(a1, b.x, d[4 * j + 2]);
        d[4 * j + 3] = __fmaf_rn(a1, b.y, d[4 * j + 3]);
      }
    }
  }
}

// ---- one block's staging: the slab ring and the resident W ----

template <typename T, bool kRS, bool kKMajor>
struct Block {
  static constexpr int kE = kSlabBytes / sizeof(T);  // depths per slab
  const Params& p;
  const int r, n, my;
  uint8_t* w_sm;   // W: `slabs` resident slabs, or `ring` streamed ones
  uint8_t* a_sm;   // the x ring
  uint64_t* full;  // [ring]: slab g landed (phase g / ring)
  uint64_t* w_bar;
  // The ring, as every thread consumes it: the next buffer and the
  // parity of its current phase.
  int cbuf = 0;
  uint32_t cphase = 0;
  // Thread 0's loads: the next buffer, step and slab of the tile, slabs
  // issued in the tile, slabs loadable in the tile, slabs in flight.
  int ibuf = 0, it = 0, is = 0, issued = 0, ready = 0, pending = 0;
  int w_loads = 0, w_col = -1;
  bool w_pending = false, stores_pending = false;
  int row0 = 0, col0 = 0;

  __device__ Block(const Params& params, uint8_t* smem)
      : p(params), r(blockIdx.x), n(params.n), my(params.my[blockIdx.x]) {
    w_sm = smem;
    a_sm = smem + (p.w_resident ? p.slabs : p.ring) * kBufBytes;
    full = reinterpret_cast<uint64_t*>(a_sm + p.ring * kBufBytes);
    w_bar = full + p.ring;
    if (threadIdx.x == 0) {
      for (int i = 0; i <= p.ring; ++i) mbar_init(full + i, 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      prefetch_map(&p.x);
      if (!kRS) prefetch_map(&p.gx);
      prefetch_map(&p.w);
    }
    __syncthreads();
  }

  // The chunk of step t: B5a partial(my - 1 - t), B5b y[my - t].
  __device__ int chunk(int t) const {
    return kRS ? wrap(my - 1 - t, n) : wrap(my - t, n);
  }

  // Thread 0: W's slab s of the current column tile into dst.
  __device__ void load_w(uint8_t* dst, int s, uint64_t* bar) const {
    const int wr = p.w_shared ? 0 : r;
    if constexpr (kKMajor) {
      tma_load_3d(dst, &p.w, bar, s * kE, col0, wr);
    } else {
#pragma unroll
      for (int h = 0; h < kTileN / kE; ++h) {
        tma_load_3d(dst + h * (kBufBytes * kE / kTileN), &p.w, bar,
                    col0 + h * kE, s * kE, wr);
      }
    }
  }

  // Thread 0: loads slabs until `ring` are in flight or the next one is
  // not loadable yet.
  __device__ void pump() {
    if (threadIdx.x != 0) return;
    if (issued < ready && pending < p.ring && stores_pending) {
      bulk_wait_read();  // the ring buffer to refill may still be stored
      stores_pending = false;
    }
    while (issued < ready && pending < p.ring) {
      uint64_t* bar = full + ibuf;
      mbar_expect(bar, p.w_resident ? kBufBytes : 2 * kBufBytes);
      uint8_t* dst = a_sm + ibuf * kBufBytes;
      if (kRS) {
        tma_load_4d(dst, &p.x, bar, is * kE, row0, chunk(it), r);
      } else if (it == 0) {
        tma_load_4d(dst, &p.x, bar, is * kE, row0, 0, r);
      } else {
        tma_load_4d(dst, &p.gx, bar, is * kE, row0, chunk(it), r);
      }
      if (!p.w_resident) load_w(w_sm + ibuf * kBufBytes, is, bar);
      if (++ibuf == p.ring) ibuf = 0;
      if (++is == p.slabs) {
        is = 0;
        ++it;
      }
      ++issued;
      ++pending;
    }
  }

  // Starts tile `tile` with its first `steps` steps loadable; loads its W
  // column tile unless it is resident already.
  __device__ void begin_tile(int tile, int steps) {
    row0 = tile / p.col_tiles * kTileM;
    col0 = tile % p.col_tiles * kTileN;
    it = is = issued = 0;
    ready = steps * p.slabs;
    if (p.w_resident && w_col != col0) {
      if (threadIdx.x == 0) {
        mbar_expect(w_bar, p.slabs * kBufBytes);
        for (int s = 0; s < p.slabs; ++s) {
          load_w(w_sm + s * kBufBytes, s, w_bar);
        }
      }
      w_col = col0;
      w_pending = true;
    }
    pump();
  }

  // One more step is loadable (B5b, once its chunk's flag is seen).
  __device__ void add_step() {
    ready += p.slabs;
    pump();
  }

  // acc = the next step's x tile @ W tile, consuming its slabs; thread 0
  // calls fwd(slab, s) as each x slab lands.
  template <typename Fwd>
  __device__ void product(float* acc, Fwd&& fwd) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    if (w_pending) {
      mbar_wait(w_bar, w_loads & 1);
      ++w_loads;
      w_pending = false;
    }
    for (int s = 0; s < p.slabs; ++s) {
      mbar_wait(full + cbuf, cphase);
      uint8_t* a = a_sm + cbuf * kBufBytes;
      if (threadIdx.x == 0) fwd(a, s);
      slab_product<T, kKMajor>(
          acc, a, w_sm + (p.w_resident ? s : cbuf) * kBufBytes);
      if (++cbuf == p.ring) {
        cbuf = 0;
        cphase ^= 1;
      }
      if constexpr (sizeof(T) == 2) {
        // The previous slab's wgmma group is done: its buffer is free
        // while this slab's group runs.
        if (s > 0) {
          wgmma_wait<1>(acc);
          release();
        }
      } else {
        release();
      }
    }
    if constexpr (sizeof(T) == 2) {
      wgmma_wait<0>(acc);
      release();
    }
  }

  // The oldest buffer in use is free once every thread is done with it;
  // refill the ring.
  __device__ void release() {
    __syncthreads();
    --pending;
    pump();
  }
};

// Two neighbouring elements (an even column and the next) through L2, as
// one 4-byte (bf16, f16) or 8-byte (f32) store.
template <typename T>
__device__ __forceinline__ void store_pair(T* p, float a, float b) {
  __stcg(reinterpret_cast<unsigned*>(p), pack2<T>(a, b));
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  __stcg(reinterpret_cast<float2*>(p), make_float2(a, b));
}

// dst's part of the tile = acc rounded to T, dst a (rows, cols) block.
// Each pair is one store where cols is even (every pair then starts
// 2-element aligned).
template <typename T>
__device__ __forceinline__ void store_tile(T* dst, int row0, int col0,
                                           int rows, int cols,
                                           const float* acc) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + acc_row(i);
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + acc_col(j), e = 4 * j + 2 * i;
      if (col >= cols) continue;
      T* const q = dst + static_cast<long long>(row) * cols + col;
      if ((cols & 1) == 0) {
        store_pair(q, acc[e], acc[e + 1]);
      } else {
        store_cg(q, from_f32<T>(acc[e]));
        if (col + 1 < cols) store_cg(q + 1, from_f32<T>(acc[e + 1]));
      }
    }
  }
}

// ---- B5a's comm slots: data and its write number in one 8-byte word ----
//
// A word holds 4 bytes of data in its low half (a bf16 or f16 accumulator
// pair, or one f32 accumulator) and, in its high half, the tag of the write
// that stored it (the write's number + 1; a slot starts zeroed). An aligned
// 8-byte store is seen whole or not at all, so a reader that sees the tag sees
// the data: the write needs no fence and no flag of its own. A slot holds a
// tile's words in the accumulator layout itself: thread t of the writer stores
// what thread t of the reader adds, as 16-byte pieces that lie side by side
// across the warp (kWords / 2 pieces per thread, 128 threads apart).
// Accumulators past the operands' ends hold zeros and go through the slot like
// the rest; only the output is masked.

template <typename T>
constexpr int kWords = sizeof(T) == 2 ? 16 : 32;  // words per thread

// Words of one tile in a slot.
template <typename T>
constexpr int kTileWords = kWords<T> * kThreads;

template <typename T>
__device__ __forceinline__ uint64_t word(const float* acc, int k,
                                         uint32_t tag) {
  uint32_t data;
  if constexpr (sizeof(T) == 2) {
    data = pack2<T>(acc[2 * k], acc[2 * k + 1]);
  } else {
    data = __float_as_uint(acc[k]);
  }
  return static_cast<uint64_t>(tag) << 32 | data;
}

// Stores acc, rounded to T, into the tile's words at dst with tag `tag`.
template <typename T>
__device__ __forceinline__ void put_tile(uint64_t* dst, const float* acc,
                                         uint32_t tag) {
#pragma unroll
  for (int k = 0; k < kWords<T>; k += 2) {
    uint64_t* const q = dst + (k / 2 * kThreads + threadIdx.x) * 2;
    asm volatile("st.volatile.global.v2.u64 [%0], {%1, %2};" ::"l"(q),
                 "l"(word<T>(acc, k, tag)), "l"(word<T>(acc, k + 1, tag))
                 : "memory");
  }
}

// Waits until every one of the thread's words of the tile at src carries
// `tag` (all of them polled by loads in flight together; bounded like the
// flag spins), then acc = slot + round(acc) in T, one add per element
// (add1).
template <typename T>
__device__ __forceinline__ void take_tile(float* acc, const uint64_t* src,
                                          uint32_t tag) {
  uint64_t v[kWords<T>];
  const long long start = clock64();
  while (true) {
    bool ready = true;
#pragma unroll
    for (int k = 0; k < kWords<T>; k += 2) {
      const uint64_t* const q = src + (k / 2 * kThreads + threadIdx.x) * 2;
      asm volatile("ld.volatile.global.v2.u64 {%0, %1}, [%2];"
                   : "=l"(v[k]), "=l"(v[k + 1])
                   : "l"(q)
                   : "memory");
    }
#pragma unroll
    for (int k = 0; k < kWords<T>; ++k) {
      ready = ready && static_cast<uint32_t>(v[k] >> 32) == tag;
    }
    if (ready) break;
    if (clock64() - start > kSpinCycles) __trap();
  }
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    T got;
    if constexpr (sizeof(T) == 2) {
      const uint16_t half = static_cast<uint16_t>(v[e / 2] >> (16 * (e & 1)));
      memcpy(&got, &half, sizeof(got));
    } else {
      got = __uint_as_float(static_cast<uint32_t>(v[e]));
    }
    acc[e] = to_f32(add1(got, from_f32<T>(acc[e])));
  }
}

// B5a.
template <typename T, bool kKMajor>
__global__ void __launch_bounds__(kThreads)
    matmul_rs_kernel(const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  Block<T, true, kKMajor> b(p, aligned_smem(smem_raw));
  const int r = blockIdx.x, n = p.n, right = p.right[r], left = p.left[r];
  const int rows = p.rows, cols = p.cols;
  const long long slot = static_cast<long long>(p.tiles) * kTileWords<T>;
  T* const out = static_cast<T*>(p.out[r]);
  const uint64_t* const comm = static_cast<const uint64_t*>(p.comm[r]);
  uint64_t* const peer = static_cast<uint64_t*>(p.comm[right]);
  auto none = [](uint8_t*, int) {};
  float acc[32];
  for (int tile = blockIdx.y; tile < p.tiles; tile += gridDim.y) {
    const long long fo = static_cast<long long>(tile) * p.flag_stride;
    int* const fl_me = p.flags[r] + fo;
    int* const fl_right = p.flags[right] + fo;
    int* const fl_left = p.flags[left] + fo;
    const long long to = static_cast<long long>(tile) * kTileWords<T>;
    b.begin_tile(tile, n);
    // partial(my - 1), rounded, into the right neighbour's slot 0:
    // write 0.
    b.product(acc, none);
    put_tile<T>(peer + to, acc, 1);
    for (int s = 0; s < n - 1; ++s) {
      const int j = s + 1;  // this step's write to the right neighbour
      const bool last = s == n - 2;
      // The right neighbour's slot j mod 2 is written again only after it
      // read write j - 2 there: known long before the write, so asked
      // here, off the hand-off's path.
      if (!last && j >= 2) {
        wait_flags(fl_me + kAck + (j & 1), j / 2, nullptr, 0);
      }
      b.product(acc, none);  // partial(my - 2 - s), before the wait
      // The left neighbour's write s, in slot s mod 2.
      take_tile<T>(acc, comm + (s & 1) * slot + to, s + 1);
      // The ack's release orders the slot's reads, not this step's write,
      // which follows it and needs no fence.
      publish(fl_left + kAck + (s & 1), nullptr);
      if (last) {
        store_tile(out, b.row0, b.col0, rows, cols, acc);
      } else {
        put_tile<T>(peer + (j & 1) * slot + to, acc, j + 1);
      }
    }
    // Drain the acks of the last two writes.
    wait_flags(fl_me + kAck + ((n - 2) & 1), (n - 2) / 2 + 1,
               n >= 3 ? fl_me + kAck + ((n - 3) & 1) : nullptr,
               (n - 3) / 2 + 1);
  }
}

// B5b.
template <typename T, bool kKMajor>
__global__ void __launch_bounds__(kThreads)
    ag_matmul_kernel(const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  using B = Block<T, false, kKMajor>;
  B b(p, aligned_smem(smem_raw));
  const int r = blockIdx.x, n = p.n, my = b.my, right = p.right[r];
  const int rows = p.rows, cols = p.cols;
  T* const y = static_cast<T*>(p.out[r]);
  float acc[32];
  for (int tile = blockIdx.y; tile < p.tiles; tile += gridDim.y) {
    const int rt = tile / p.col_tiles;
    const bool forwards = tile % p.col_tiles == 0;
    const long long fo = static_cast<long long>(rt) * p.col_tiles *
                         p.flag_stride;
    int* const fl_me = p.flags[r] + fo;
    int* const fl_right = p.flags[right] + fo;
    b.begin_tile(tile, 1);
    for (int t = 0; t < n; ++t) {
      if (t > 0) {
        // Chunk my - t landed in gx (the left neighbour's step t - 1).
        wait_flags(fl_me + kGather + t - 1, 1, nullptr, 0);
        if (threadIdx.x == 0) fence_proxy_async();
        b.add_step();
      }
      const int c = wrap(my - t, n);
      const bool send = forwards && t < n - 1;
      b.product(acc, [&](uint8_t* slab, int s) {
        if (!send) return;
        tma_store_4d(&p.gx, slab, s * B::kE, b.row0, c, right);
        if (t == 0) tma_store_4d(&p.gx, slab, s * B::kE, b.row0, my, r);
        bulk_commit();
        b.stores_pending = true;
        if (s == p.slabs - 1) {
          // The chunk is released once its stores are complete, before
          // the last slab's product. Only thread 0's TMA stores are
          // published: no block barrier.
          bulk_wait();
          fence_proxy_async();
          b.stores_pending = false;
          store_release(fl_right + kGather + t, 1);
        }
      });
      store_tile(y + static_cast<long long>(c) * rows * cols, b.row0,
                 b.col0, rows, cols, acc);
    }
  }
}

// ---- host side ----

// Each kernel instance is allowed the card's whole opt-in shared memory
// once per device; the launch then asks for what its plan needs.
template <typename T, bool kRS, bool kKMajor>
void* kernel_fn(cudaError_t* err) {
  static std::atomic<bool> done[kMaxDevices];
  void* fn = kRS ? reinterpret_cast<void*>(matmul_rs_kernel<T, kKMajor>)
                 : reinterpret_cast<void*>(ag_matmul_kernel<T, kKMajor>);
  *err = allow_dynamic_smem(fn, smem_limit(), done);
  return fn;
}

template <typename T, bool kKMajor>
cudaError_t launch(bool rs, const Params& p, dim3 grid, int smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  void* fn = rs ? kernel_fn<T, true, kKMajor>(&err)
                : kernel_fn<T, false, kKMajor>(&err);
  if (err != cudaSuccess) return err;
  void* args[] = {const_cast<Params*>(&p)};
  err = cudaLaunchCooperativeKernel(fn, grid, dim3(kThreads), args, smem,
                                    stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Shared memory of a plan: the W slabs, the x ring, its barriers and the
// 1024-byte alignment of the swizzled tiles.
int smem_bytes(int slabs, int ring, int w_resident) {
  return ((w_resident ? slabs : ring) + ring) * kBufBytes +
         8 * (ring + 1) + 1024;
}

// x (ranks, chunks, rows, k) rows x_ld apart, gx (ranks, n, rows, k),
// w: rank stride (bytes; 0 = shared), element strides w_sk, w_sn.
int run(bool rs, const void* x, long long x_ld, const void* w,
        long long w_stride, long long w_sk, long long w_sn, void* out,
        void* gx, void* comm, int* flags, int flag_stride, const int* my,
        const int* right, const int* left, int ranks, int n, int slices,
        int rows, int k, int cols, int slabs, int ring, int w_resident,
        int smem, int dtype, void* stream) {
  const int elt = dtype == 0 || dtype == 2 ? 2 : dtype == 1 ? 4 : 0;
  const int depth = elt ? kSlabBytes / elt : 1;
  const bool k_major = w_sn != 1 && w_sk == 1;
  const long long tiles = static_cast<long long>((rows + kTileM - 1) /
                                                 kTileM) *
                          ((cols + kTileN - 1) / kTileN);
  const auto aligned = [](const void* a) {
    return (reinterpret_cast<uintptr_t>(a) & 15) == 0;
  };
  if (elt == 0 || ranks < 2 || ranks > kMaxRanks || n < 2 || n > ranks ||
      rows < 1 || k < 1 || cols < 1 || x_ld < k || (x_ld * elt) % 16 ||
      slabs != (k + depth - 1) / depth || ring < 1 || ring > kMaxRing ||
      slices < 1 || slices > tiles || slices > 65535 ||
      flag_stride < kGather + n - 1 || smem < smem_bytes(slabs, ring,
                                                         w_resident) ||
      (w_sn != 1 && !k_major) || (k_major && elt != 2) ||
      ((k_major ? w_sn : w_sk) * elt) % 16 || w_stride % 16 ||
      !aligned(x) || !aligned(w) ||
      (!rs && (gx == nullptr || !aligned(gx))) || (rs && comm == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  memset(&p, 0, sizeof(p));
  const cuuint64_t e = static_cast<cuuint64_t>(elt);
  const cuuint64_t line = static_cast<cuuint64_t>(x_ld) * e;
  const int chunks = rs ? n : 1;
  const cuuint32_t xbox[4] = {static_cast<cuuint32_t>(depth), kTileM, 1, 1};
  {
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(k),
                                static_cast<cuuint64_t>(rows),
                                static_cast<cuuint64_t>(chunks),
                                static_cast<cuuint64_t>(ranks)};
    const cuuint64_t strides[3] = {line, line * rows, line * rows * chunks};
    const cudaError_t err = encode(&p.x, dtype, 4, x, dims, strides, xbox);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (!rs) {
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(k),
                                static_cast<cuuint64_t>(rows),
                                static_cast<cuuint64_t>(n),
                                static_cast<cuuint64_t>(ranks)};
    const cuuint64_t strides[3] = {line, line * rows, line * rows * n};
    const cudaError_t err = encode(&p.gx, dtype, 4, gx, dims, strides, xbox);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  {
    const cuuint64_t lead =
        static_cast<cuuint64_t>(k_major ? w_sn : w_sk) * e;
    const cuuint64_t outer = static_cast<cuuint64_t>(k_major ? cols : k);
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(k_major ? k : cols),
                                outer,
                                static_cast<cuuint64_t>(w_stride ? ranks : 1)};
    const cuuint64_t strides[2] = {
        lead, w_stride ? static_cast<cuuint64_t>(w_stride) : lead * outer};
    const cuuint32_t box[3] = {static_cast<cuuint32_t>(depth),
                               static_cast<cuuint32_t>(k_major ? kTileN
                                                               : depth),
                               1};
    const cudaError_t err = encode(&p.w, dtype, 3, w, dims, strides, box);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  for (int i = 0; i < ranks; ++i) {
    if (my[i] < 0 || my[i] >= n || right[i] < 0 || right[i] >= ranks ||
        left[i] < 0 || left[i] >= ranks) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const long long out_rows = rs ? rows : static_cast<long long>(n) * rows;
    p.out[i] = static_cast<char*>(out) + i * out_rows * cols * elt;
    const long long words = tiles * kThreads * (elt == 2 ? 16 : 32);
    p.comm[i] = comm ? static_cast<char*>(comm) + i * 2 * words * 8
                     : nullptr;
    p.flags[i] = flags + i * tiles * flag_stride;
    p.my[i] = my[i];
    p.right[i] = right[i];
    p.left[i] = left[i];
  }
  p.n = n;
  p.tiles = static_cast<int>(tiles);
  p.col_tiles = (cols + kTileN - 1) / kTileN;
  p.flag_stride = flag_stride;
  p.rows = rows;
  p.cols = cols;
  p.slabs = slabs;
  p.ring = ring;
  p.w_resident = w_resident;
  p.w_shared = w_stride == 0;
  const dim3 grid(ranks, slices);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return static_cast<int>(launch<float, false>(rs, p, grid, smem, s));
  }
  if (dtype == 2) {
    return static_cast<int>(
        k_major ? launch<__half, true>(rs, p, grid, smem, s)
                : launch<__half, false>(rs, p, grid, smem, s));
  }
  return static_cast<int>(
      k_major ? launch<__nv_bfloat16, true>(rs, p, grid, smem, s)
              : launch<__nv_bfloat16, false>(rs, p, grid, smem, s));
}

template <typename T, bool kRS, bool kKMajor>
cudaError_t min_blocks(int smem, int* blocks) {
  cudaError_t err = cudaSuccess;
  void* fn = kernel_fn<T, kRS, kKMajor>(&err);
  int per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                        smem);
  }
  if (err == cudaSuccess && per_sm < *blocks) *blocks = per_sm;
  return err;
}

}  // namespace

extern "C" {

// Ints of flags each (rank, tile) needs for a ring of n.
int gtt_overlap_flag_stride(int n) { return kGather + (n > 1 ? n - 1 : 1); }

// The most blocks of either kernel, in any type and W layout, that can
// be resident at once on the current device with `smem` bytes of dynamic
// shared memory each (the cooperative launch's limit), in *blocks.
int gtt_overlap_max_blocks(int smem, int* blocks) {
  using bf16 = __nv_bfloat16;
  int per_sm = 1 << 30;
  cudaError_t err = min_blocks<bf16, true, false>(smem, &per_sm);
  if (err == cudaSuccess) err = min_blocks<bf16, true, true>(smem, &per_sm);
  if (err == cudaSuccess) err = min_blocks<bf16, false, false>(smem, &per_sm);
  if (err == cudaSuccess) err = min_blocks<bf16, false, true>(smem, &per_sm);
  if (err == cudaSuccess) err = min_blocks<__half, true, false>(smem, &per_sm);
  if (err == cudaSuccess) err = min_blocks<__half, true, true>(smem, &per_sm);
  if (err == cudaSuccess) {
    err = min_blocks<__half, false, false>(smem, &per_sm);
  }
  if (err == cudaSuccess) err = min_blocks<__half, false, true>(smem, &per_sm);
  if (err == cudaSuccess) err = min_blocks<float, true, false>(smem, &per_sm);
  if (err == cudaSuccess) err = min_blocks<float, false, false>(smem, &per_sm);
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

// Each returns a cudaError_t; 0 is success. dtype: 0 = bf16, 1 = f32, 2 =
// f16.
// x rows are x_ld elements apart; w_stride is w's rank stride in bytes (0:
// one w shared by every rank), w_sk and w_sn its element strides (one of
// them 1); rows is the rows of one chunk; slabs = ceil(k / (128 bytes of
// depth)), ring the slab buffers, w_resident whether W's column tile stays
// in shared memory, smem the bytes of dynamic shared memory per block
// (at least what the plan needs; LaunchPlan.smem in ops/overlap.py).
// my/right/left: host arrays of `ranks` ints. flags: (ranks, tiles,
// flag_stride) zeroed ints.

// B5a: x (n rows, k) per rank -> out (rows, cols) per rank; comm holds 2
// zeroed slots per rank of tiles x 128 x 16 (bf16, f16) or x 32 (f32)
// 8-byte words.
int gtt_matmul_rs(const void* x, long long x_ld, const void* w,
                  long long w_stride, long long w_sk, long long w_sn,
                  void* out, void* comm, int* flags, int flag_stride,
                  const int* my, const int* right, const int* left, int ranks,
                  int n, int slices, int rows, int k, int cols, int slabs,
                  int ring, int w_resident, int smem, int dtype,
                  void* stream) {
  return run(true, x, x_ld, w, w_stride, w_sk, w_sn, out, nullptr, comm,
             flags, flag_stride, my, right, left, ranks, n, slices, rows, k,
             cols, slabs, ring, w_resident, smem, dtype, stream);
}

// B5b: x (rows, k) per rank -> y (n rows, cols) and gx (n rows, k; rows
// x_ld apart) per rank.
int gtt_ag_matmul(const void* x, long long x_ld, const void* w,
                  long long w_stride, long long w_sk, long long w_sn, void* y,
                  void* gx, int* flags, int flag_stride, const int* my,
                  const int* right, const int* left, int ranks, int n,
                  int slices, int rows, int k, int cols, int slabs, int ring,
                  int w_resident, int smem, int dtype, void* stream) {
  return run(false, x, x_ld, w, w_stride, w_sk, w_sn, y, gx, nullptr, flags,
             flag_stride, my, right, left, ranks, n, slices, rows, k, cols,
             slabs, ring, w_resident, smem, dtype, stream);
}

const char* gtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
