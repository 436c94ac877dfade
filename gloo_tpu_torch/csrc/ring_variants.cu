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
// The model is ring.cu's: the ranks are a world on one card, each rank's
// buffers its own, seen as base + r x stride and through the ring tables
// in device memory (ring_common.cuh's PerRank and Rings; no rank
// ceiling). Every block spins on
// flags other blocks set, so the launches are cooperative and the wrapper
// takes the slice count S from the occupancy that
// gtt_ring_variants_max_blocks reports for each kernel. Every spin, the
// mbarrier waits included, is bounded (~2 s, then __trap).
//
// B9 and B11: one pass in member order, as ring.cu's B3. The TPU kernels
// are shaped for a torus of chips, where a chip reaches only its
// neighbours: a copy of the input, then n - 1 steps that DMA a chunk into
// the neighbour's comm slot and add, then n - 1 allgather steps. On Hopper
// every rank's input already lies in device memory that every SM reads,
// and the cards of a host are joined all to all through NVSwitch, not in
// a ring. So the block that finishes a chunk reads it from every member of
// its ring, in the order in which the ring would have added it up, and
// stores the sum into that chunk of every member's output: each input
// unit is read once and each output unit written once, behind one members
// barrier, with no comm slot, no working copy and no per-step hand-off.
// With ring indices mod n and in_k the input of the member with ring
// index k, each + one add1 of ring_common.cuh in the element type, at
// every type of GTT_SUM_TYPES (bf16 and f16 in f32 rounded back after
// every add, f32 and f64 IEEE without contraction, integers wrapping in
// their own width):
//   B3's order, chunk c (starts raw on c, finished on c - 1):
//     in_{c-1}[c] + (in_{c-2}[c] + ( ... + (in_{c+1}[c] + in_c[c])));
//   the mirrored ring's order, chunk c (starts on c, goes to c - 1, then
//   c - 2, and is finished on c + 1; pallas_ring.py:725-731):
//     in_{c+1}[c] + (in_{c+2}[c] + ( ... + (in_{c-1}[c] + in_c[c]))).
// The rank with ring index my walks members my + 1, my + 2, ..., my + n
// for chunk my + 1 in B3's order, and my - 1, my - 2, ..., my - n for
// chunk my - 1 in the mirrored order: its own input last in both.
//
// B9, HBM streaming: B3's function (its output is bitwise B3's), and what
// makes it itself is the stream. The TPU kernel streams each received
// chunk through VMEM in tiles, the next tile's DMA in flight while the
// current one is added (pallas_ring.py:253-258, 319-369). Here the card's
// own copy engine streams: grid (P, S), block (r, j) owns a run of whole
// tiles of chunk my + 1 (the last tile of a chunk may be short). One
// producer thread in a warp of its own issues, tile by tile and member by
// member in B3's order, a TMA bulk copy (cp.async.bulk) of that member's
// tile into the next of K shared-memory stages, completing on the stage's
// full mbarrier; it refills a stage only once its empty mbarrier shows
// that every consumer warp has read it. Load i = tile * n + member goes to
// stage i mod K in phase i / K. The 256 consumer threads each own fixed
// 16-byte units of the tile, fold the members into registers in issue
// order, then write the sum into one of two output buffers in shared
// memory; after fence.proxy.async and a barrier of the consumers, one
// thread issues n bulk stores of the buffer, one into each member's
// output, as one bulk group. A buffer is written again only after
// cp.async.bulk.wait_group.read 1 shows that its stores of two tiles ago
// have read it, so tile t's stores drain while tile t + 1 loads. Bytes in
// flight live in shared memory, not in registers. Tiles (kPer units per
// consumer thread: 8, 16 or 32 KB) and stages are the wrapper's choice.
//
// B11, bidirectional: grid (P, 2, S). Block (r, d, j) owns slice j of
// column half d of one chunk: d = 0 chunk my + 1 in B3's order, d = 1
// chunk my - 1 in the mirrored order. The TPU's two directions on the
// wire survive as the two add orders; on NVSwitch there is no direction,
// and across cards each rank pulls from every member. A half-chunk is
// strided: chunk_rows rows of half_units 16-byte units at a row pitch of
// 2 half_units, walked by (row, unit in the row) without a divide. Each
// thread starts the loads of kGroup members x kUnroll units before it
// adds any (ring.cu's scheme); inputs are read with __ldg (nothing writes
// them during the launch) and outputs stored plainly (only this block
// writes its units). With n = 2 the two orders coincide.
//
// B10, int8 wire, f32 only: one pass per chunk chain, in member order.
// Each reduce-scatter hop of the TPU kernel sends its outgoing chunk as
// int8 codes plus one f32 scale for the whole chunk
// (pallas_ring.py:515-519): scale = max|chunk| * f32(1 / 127), which is
// what XLA makes of the reference's max / 127, and q = clip(rint(x /
// max(scale, 1e-30)), +-127), a true division (rint: half to even); the
// receiver accumulates fma(q, scale, acc), one rounding; the owner of the
// finished chunk quantizes it once more, and every rank decodes those
// codes, q * scale. Chunk c's value depends on the partial sums alone, not
// on where they live. With x_k the input of the member with ring index k:
//   p_0 = x_c[c]; s_k = max|p_k| * f32(1 / 127);
//   p_{k+1} = fma(q(p_k, s_k), s_k, x_{c+k+1}[c]), k = 0 .. n - 2;
//   out[c] = q(p_{n-1}, s_{n-1}) * s_{n-1} on every member.
// Block (r, j) owns slice j of chunk my of the chain it starts (its own
// input first), so the S blocks of each rank walk one chain and all n
// chains of a ring run at once. Each thread owns fixed 16-byte units of
// the slice and folds each member's units into its partial, computing the
// max of the new partial in the same pass. The max over the whole chunk
// is one cross-block reduction per hop among the chain's blocks: each
// folds its slice's max into the chain's cell for the hop (atomicMax on
// the float's bits as an int, which orders like the float for x >= 0) and
// adds one to the hop's arrival count (release); thread 0 waits until
// every slice block of the chain has arrived (acquire) and reads the
// cell. That works because the launch is cooperative: every block is
// resident. The next member's loads are in flight across that wait. The
// decoded chunk is stored into chunk c of every member's output. A max is
// exact in any order, so the slicing changes no bit: the result is the
// twin's, which walks the ring. Two forms: the register form keeps each
// thread's partial in registers (at most kQ8Units units a thread, so each
// input unit is read once and each output unit written once); past what
// the resident grid holds that way, the out-of-register form keeps p_k in
// the chain owner's own output chunk between hops, read and written by
// the thread that owns the unit (the same bits, 2 - 1 / (2 n) times the
// bytes). No input copy, no wire, no per-step neighbour flags: one
// members barrier on entry, as B3, and the n cells per chain.
//
// What bounds them on an H100: bytes. Each rank's input read once and its
// output written once, 2 P S at 3.35 TB/s (S bytes per rank); there is no
// arithmetic to speak of. B9, B11 and B10's register form move exactly
// that; B10 adds n cross-block reductions per chain.
//
// Across processes (the cross-process instances, entry
// gtt_ring_variants_peer) each rank's input and output live in its
// process's peer workspace (peer.cu, tpu/peer.py), mapped into every other
// process by CUDA IPC: Params holds a peer-mapped pointer for every
// member's input, output and flags, and this process's own for its local
// ranks. Each process makes one cooperative launch of its local ranks'
// blocks (grid (local ranks, S), B11 (local ranks, 2, S)); block x plays
// flat rank local[x]. A peer's input is complete only once that peer has
// entered, so the entry barrier now orders the loads; an exit barrier
// follows the last load and store, since peers read a rank's input and
// every kernel stores finished chunks into every member's output. Each
// rank has one entry and one exit flag at system scope (.sys) that every
// block of every other member adds one to, counters that only grow: the
// wrapper passes their count before the call (`before`), a call adds
// (n - 1) x the blocks per rank, and nothing zeroes them (a peer's add
// could land before an owner's zeroing). B9's producer issues its bulk
// loads from the peer-mapped inputs after a proxy fence
// (fence.proxy.async.global: the acquire of the entry flags is a generic
// access, the bulk copies are the async proxy's), and its stores into the
// members' outputs are complete (cp.async.bulk.wait_group 0, then the
// proxy fence) before it enters the exit barrier. B10's chain cells stay
// this process's own: a chain's blocks all play the rank that starts it,
// so its maxima and arrival counts are touched by no peer and are zeroed
// in stream order before the launch; the out-of-register form's partial
// stays in the owner's own output chunk, which no peer writes before the
// chain's final store. On one card under time-slicing a spin waits until
// the card switches to a peer's context; across cards the loads and
// stores would ride NVLink, where B10's int8 hand-off (the blocks that
// read member c + k - 1 handing q_{k-1} and s_{k-1} to those that read
// member c + k, in place of f32 partials, with the same bits) is what
// pays; it is not built (ROADMAP A.7). The one-card instances are the
// same templates at Scope::kGpu with before 0 and no exit barrier.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "ring_common.cuh"

namespace {

using namespace gtt;

constexpr int kThreads = 256;
// B9: the consumer threads and one producer warp.
constexpr int kHbmThreads = kThreads + 32;
// B11: units each thread folds per pass, and members whose loads start
// together (ring.cu's B3).
constexpr int kUnroll = 2;
constexpr int kGroup = 4;

// B10 has two kernels: kQ8 holds the chain's partial in registers, kQ8Mem
// in memory.
enum Variant { kHbm = 0, kQ8 = 1, kBidir = 2, kQ8Mem = 3 };

struct Params {
  // Rank r's buffers. in/out: n chunks; flags: S sets (B11 2 S) of
  // flag_stride ints, each set's first the members barrier. cells (B10):
  // block row x's n maxima then n arrival counts of its rank's chain (x =
  // r on one card, local rank x across processes).
  PerRank<const void> in;
  PerRank<void> out;
  PerRank<int> flags;
  PerRank<int> cells;
  Rings rings;  // in device memory
  int n;
  int flag_stride;
  int stages;            // B9: shared-memory stages of one tile each
  long long chunk;       // B9/B10: 16-byte units per chunk
  long long chunk_rows;  // B11: rows per chunk
  long long half_units;  // B11: 16-byte units per row of one half
};

// The members barrier on entry of block rank r, whose ring row is `ring`.
// One card (S = Scope::kGpu): flag set `set` of rank r, zeroed per call.
// Across processes (Scope::kSys): rank r's entry flag, which every block of
// every other member adds one to, so the wait is for before + (n - 1) x
// the blocks per rank (gridDim.y x gridDim.z).
template <Scope S>
__device__ __forceinline__ void enter(const Params& p, int r,
                                      const int* ring, int set, int before) {
  const int n = p.n;
  const long long flag =
      S == Scope::kGpu
          ? static_cast<long long>(set) * p.flag_stride + kBarrier
          : kBarrier;
  const int base =
      S == Scope::kGpu
          ? 0
          : before + (n - 1) * (static_cast<int>(gridDim.y * gridDim.z) - 1);
  members_barrier<S>(p.flags.at<S>(r) + flag, ring, n, r, [&](int m) {
    return p.flags.at<S>(m) + flag;
  }, base);
}

// Across processes, the exit barrier of block rank r (its exit flag,
// counted as the entry flag): no member returns, and reuses its input or
// reads its output, while a peer can still read the one or write the
// other. Nothing on one card.
template <Scope S>
__device__ __forceinline__ void leave(const Params& p, int r,
                                      const int* ring, int before) {
  if constexpr (S == Scope::kSys) {
    const int n = p.n;
    exit_barrier<S>(p.flags.at<S>(r) + kPeerExit, ring, n, r, [&](int m) {
      return p.flags.at<S>(m) + kPeerExit;
    }, before + (n - 1) * (static_cast<int>(gridDim.y * gridDim.z) - 1));
  }
}

// ---- B9: shared memory, mbarriers, bulk copies ----

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)), "r"(bytes) : "memory");
}

// Waits for the phase of parity `parity` to complete; traps after ~2 s
// like the flag spins.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  const long long start = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - start > kSpinCycles) __trap();
  }
}

// `bytes` from global memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes),
      "r"(smem_addr(bar)) : "memory");
}

// `bytes` from shared memory into global memory, in this thread's open
// bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst), "r"(smem_addr(src)), "r"(bytes) : "memory");
}

// The barrier of B9's consumer warps (named barrier 1; the producer warp
// keeps out of it).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kThreads) : "memory");
}

// ---- B9 ----

// T: element type; kPer: 16-byte units of a tile per consumer thread.
// Dynamic shared memory: p.stages tiles, two output tiles, then the
// stages' full and empty mbarriers. Block (x, j) plays rank r with its
// flags' count `before` the call (see enter).
template <typename T, int kPer, Scope S>
__device__ __forceinline__ void hbm_body(const Params& p, int r,
                                         int before) {
  constexpr int kTileUnits = kThreads * kPer;
  extern __shared__ __align__(128) unsigned char smem[];
  const int stages = p.stages;
  uint4* const stage = reinterpret_cast<uint4*>(smem);
  uint4* const outbuf = stage + stages * kTileUnits;
  uint64_t* const full = reinterpret_cast<uint64_t*>(outbuf + 2 * kTileUnits);
  uint64_t* const empty = full + stages;

  const int n = p.n, my = p.rings.my[r];
  const int* const ring = p.rings.ring(r, n);
  const long long chunk = p.chunk;
  const long long tiles = (chunk + kTileUnits - 1) / kTileUnits;
  const long long t_lo = tiles * blockIdx.y / gridDim.y;
  const long long t_hi = tiles * (blockIdx.y + 1) / gridDim.y;
  const long long off = wrap(my + 1, n) * chunk;  // chunk my + 1

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // Ends in __syncthreads: the mbarriers are set.
  enter<S>(p, r, ring, blockIdx.y, before);

  if (threadIdx.x >= kThreads) {
    if (threadIdx.x == kThreads) {
      // The producer: load i = (tile, member) into stage i mod K, phase
      // i / K, once the stage's previous phase has been read. Across
      // processes the peers' inputs were released to the generic proxy.
      if constexpr (S == Scope::kSys) {
        asm volatile("fence.proxy.async.global;" ::: "memory");
      }
      int s = 0;
      uint32_t phase = 0;
      bool refill = false;
      for (long long t = t_lo; t < t_hi; ++t) {
        const long long u0 = t * kTileUnits;
        const uint32_t bytes = static_cast<uint32_t>(
            (chunk - u0 < kTileUnits ? chunk - u0 : kTileUnits) * 16);
        for (int m = 0; m < n; ++m) {
          if (refill) mbar_wait(empty + s, phase ^ 1);
          mbar_expect(full + s, bytes);
          bulk_load(stage + s * kTileUnits,
                    static_cast<const uint4*>(
                        p.in.at<S>(ring[wrap(my + 1 + m, n)])) + off + u0,
                    bytes, full + s);
          if (++s == stages) {
            s = 0;
            phase ^= 1;
            refill = true;
          }
        }
      }
    }
    // One card: the producer warp is done. Across processes it meets the
    // exit barrier with the consumers.
    if constexpr (S == Scope::kGpu) return;
  } else {
    // The consumers: thread x owns units x, x + 256, ... of every tile.
    int s = 0;
    uint32_t phase = 0;
    for (long long t = t_lo; t < t_hi; ++t) {
      const long long u0 = t * kTileUnits;
      const int len = static_cast<int>(
          chunk - u0 < kTileUnits ? chunk - u0 : kTileUnits);
      uint4 acc[kPer];
      for (int m = 0; m < n; ++m) {
        mbar_wait(full + s, phase);
        const uint4* const src = stage + s * kTileUnits;
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          const int e = k * kThreads + threadIdx.x;
          if (e < len) {
            acc[k] = m == 0 ? src[e] : add_units<T>(src[e], acc[k]);
          }
        }
        __syncwarp();
        if ((threadIdx.x & 31) == 0) mbar_arrive(empty + s);
        if (++s == stages) {
          s = 0;
          phase ^= 1;
        }
      }
      // The output buffer of two tiles ago is free once its stores have
      // read it.
      uint4* const buf = outbuf + ((t - t_lo) & 1) * kTileUnits;
      if (threadIdx.x == 0) {
        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      }
      consumers_sync();
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int e = k * kThreads + threadIdx.x;
        if (e < len) buf[e] = acc[k];
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      consumers_sync();
      if (threadIdx.x == 0) {
        for (int k = 0; k < n; ++k) {
          bulk_store(static_cast<uint4*>(p.out.at<S>(ring[k])) + off + u0,
                     buf, static_cast<uint32_t>(len) * 16);
        }
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      }
    }
    if (threadIdx.x == 0) {
      asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
      if constexpr (S == Scope::kSys) {
        asm volatile("fence.proxy.async.global;" ::: "memory");
      }
    }
  }
  leave<S>(p, r, ring, before);
}

template <typename T, int kPer>
__global__ void __launch_bounds__(kHbmThreads)
hbm_kernel(const __grid_constant__ Params p) {
  hbm_body<T, kPer, Scope::kGpu>(p, blockIdx.x, 0);
}

// ---- B10 ----

// The slice [lo, hi) of this block (16-byte units of a chunk of `chunk`).
__device__ __forceinline__ void slice_of(long long chunk, long long* lo,
                                         long long* hi) {
  const long long slice = blockIdx.y, slices = gridDim.y;
  *lo = chunk * slice / slices;
  *hi = chunk * (slice + 1) / slices;
}

// Units of its slice that each thread of the register form holds: the
// chain's partial stays in registers from its first member to the last.
constexpr int kQ8Units = 8;
// Units a thread of the out-of-register form loads per pass.
constexpr int kQ8Unroll = 4;

// max |x| over the four lanes of a unit.
__device__ __forceinline__ float absmax4(uint4 v) {
  return fmaxf(
      fmaxf(fabsf(__uint_as_float(v.x)), fabsf(__uint_as_float(v.y))),
      fmaxf(fabsf(__uint_as_float(v.z)), fabsf(__uint_as_float(v.w))));
}

// The max over the whole chunk at one hop of this block's chain, in two
// halves, so that the next member's loads go out between them.
// chain_arrive folds the block's max `m` into the hop's cell (atomicMax on
// the float's bits) and adds one to the hop's arrival count (release):
// thread 0 does so before any load of the next hop is in flight, so the
// release waits for none of them. chain_wait waits until every slice
// block of the chain has arrived (acquire) and returns the chunk's max to
// every thread.
__device__ void chain_arrive(float m, int* cell, int* count) {
  __shared__ float warp_max[kThreads / 32];
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
  }
}

__device__ float chain_wait(const int* cell, const int* count, int slices) {
  __shared__ float result;
  if (threadIdx.x == 0) {
    const long long start = clock64();
    while (ld_acquire(count) < slices) {
      if (clock64() - start > kSpinCycles) __trap();
    }
    result = __int_as_float(ld_acquire(cell));
  }
  __syncthreads();
  return result;
}

// Four f32 lanes to four int8 codes, lane k in byte k. A zero lane's code
// is 0 without the division: a zero dividend sends the IEEE division to
// its slow path, and gradient buffers hold many zeros.
__device__ __forceinline__ unsigned quantize4(uint4 v, float safe) {
  const unsigned bits[4] = {v.x, v.y, v.z, v.w};
  unsigned packed = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float x = __uint_as_float(bits[k]);
    float q = x == 0.f ? 0.f : rintf(__fdiv_rn(x == 0.f ? 1.f : x, safe));
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

// kRegs: the register form (every thread's units of its slice, at most
// kQ8Units, held in registers across the chain); else the partial is kept
// in this rank's own output chunk between hops, read and written by the
// thread that owns the unit, kQ8Unroll units a pass with every load of
// the pass issued before its first store.
template <bool kRegs, Scope S>
__device__ __forceinline__ void q8_body(const Params& p, int r, int before) {
  const int slices = gridDim.y;
  const int n = p.n, my = p.rings.my[r];
  const int* const ring = p.rings.ring(r, n);
  // The chain of chunk my: members my, my + 1, ..., my + n - 1.
  const long long off = my * p.chunk;
  long long lo, hi;
  slice_of(p.chunk, &lo, &hi);
  const long long t0 = lo + threadIdx.x;
  int* const cells = p.cells.at(blockIdx.x);  // n maxima, n arrival counts
  const auto member = [&](int k) {
    return static_cast<const uint4*>(p.in.at<S>(ring[wrap(my + k, n)])) +
           off;
  };
  const auto arrive = [&](float m, int hop) {
    chain_arrive(m, cells + hop, cells + n + hop);
  };
  const auto scale_at = [&](int hop) {
    return scale_of(chain_wait(cells + hop, cells + n + hop, slices));
  };
  const auto store_all = [&](long long u, uint4 y) {
    for (int k = 0; k < n; ++k) {
      static_cast<uint4*>(p.out.at<S>(ring[k]))[off + u] = y;
    }
  };
  enter<S>(p, r, ring, blockIdx.y, before);

  float m = 0.f;
  if constexpr (kRegs) {
    uint4 part[kQ8Units];
#pragma unroll
    for (int i = 0; i < kQ8Units; ++i) {
      const long long u = t0 + i * kThreads;
      if (u < hi) {
        part[i] = __ldg(member(0) + u);
        m = fmaxf(m, absmax4(part[i]));
      }
    }
    arrive(m, 0);
    for (int k = 1; k < n; ++k) {
      // Member k's units are in flight while the chain agrees on the max.
      uint4 next[kQ8Units];
      const uint4* const src = member(k);
#pragma unroll
      for (int i = 0; i < kQ8Units; ++i) {
        const long long u = t0 + i * kThreads;
        if (u < hi) next[i] = __ldg(src + u);
      }
      const float scale = scale_at(k - 1);
      const float safe = fmaxf(scale, 1e-30f);
      m = 0.f;
#pragma unroll
      for (int i = 0; i < kQ8Units; ++i) {
        if (t0 + i * kThreads < hi) {
          part[i] = accumulate4(next[i], quantize4(part[i], safe), scale);
          m = fmaxf(m, absmax4(part[i]));
        }
      }
      arrive(m, k);
    }
    const float scale = scale_at(n - 1);
    const float safe = fmaxf(scale, 1e-30f);
#pragma unroll
    for (int i = 0; i < kQ8Units; ++i) {
      const long long u = t0 + i * kThreads;
      if (u < hi) store_all(u, decode4(quantize4(part[i], safe), scale));
    }
  } else {
    uint4* const stash = static_cast<uint4*>(p.out.at<S>(r)) + off;
    for (long long u = t0; u < hi; u += kThreads) {
      m = fmaxf(m, absmax4(__ldg(member(0) + u)));
    }
    arrive(m, 0);
    for (int k = 1; k < n; ++k) {
      const float scale = scale_at(k - 1);
      const float safe = fmaxf(scale, 1e-30f);
      const uint4* const prev = k == 1 ? member(0) : stash;
      const uint4* const src = member(k);
      m = 0.f;
      for (long long base = t0; base < hi; base += kThreads * kQ8Unroll) {
        uint4 a[kQ8Unroll], b[kQ8Unroll];
#pragma unroll
        for (int i = 0; i < kQ8Unroll; ++i) {
          const long long u = base + i * kThreads;
          if (u < hi) {
            a[i] = prev[u];
            b[i] = __ldg(src + u);
          }
        }
#pragma unroll
        for (int i = 0; i < kQ8Unroll; ++i) {
          const long long u = base + i * kThreads;
          if (u < hi) {
            const uint4 part = accumulate4(b[i], quantize4(a[i], safe), scale);
            stash[u] = part;
            m = fmaxf(m, absmax4(part));
          }
        }
      }
      arrive(m, k);
    }
    const float scale = scale_at(n - 1);
    const float safe = fmaxf(scale, 1e-30f);
    for (long long base = t0; base < hi; base += kThreads * kQ8Unroll) {
      uint4 a[kQ8Unroll];
#pragma unroll
      for (int i = 0; i < kQ8Unroll; ++i) {
        const long long u = base + i * kThreads;
        if (u < hi) a[i] = stash[u];
      }
#pragma unroll
      for (int i = 0; i < kQ8Unroll; ++i) {
        const long long u = base + i * kThreads;
        if (u < hi) store_all(u, decode4(quantize4(a[i], safe), scale));
      }
    }
  }
  leave<S>(p, r, ring, before);
}

template <bool kRegs>
__global__ void __launch_bounds__(kThreads)
q8_kernel(const __grid_constant__ Params p) {
  q8_body<kRegs, Scope::kGpu>(p, blockIdx.x, 0);
}

// ---- B11 ----

template <typename T, Scope S>
__device__ __forceinline__ void bidir_body(const Params& p, int r,
                                           int before) {
  const int d = blockIdx.y;
  const int n = p.n, my = p.rings.my[r];
  const int* const ring = p.rings.ring(r, n);
  // d = 0: chunk my + 1, members my + 1, ..., my + n (B3's order);
  // d = 1: chunk my - 1, members my - 1, ..., my - n (the mirrored ring's).
  const int dir = d ? -1 : 1;
  const long long hu = p.half_units, pitch = 2 * hu;
  const long long half = p.chunk_rows * hu;
  const long long lo = half * blockIdx.z / gridDim.z;
  const long long hi = half * (blockIdx.z + 1) / gridDim.z;
  // Unit u of the half lies at (row, unit in the row) = (u / hu, u % hu)
  // from the half's first unit.
  const long long first = wrap(my + dir, n) * p.chunk_rows * pitch + d * hu;

  enter<S>(p, r, ring, d * gridDim.z + blockIdx.z, before);

  // This thread's next unit as (row, unit in the row), stepped by kThreads
  // units without a divide.
  const long long t0 = lo + threadIdx.x;
  long long row = t0 / hu, cu = t0 % hu;
  const long long step_rows = kThreads / hu, step_units = kThreads % hu;
  for (long long base = t0; base < hi; base += kThreads * kUnroll) {
    long long at[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      at[i] = first + row * pitch + cu;
      row += step_rows;
      cu += step_units;
      if (cu >= hu) {
        cu -= hu;
        ++row;
      }
    }
    uint4 acc[kUnroll];
    fold_members<T, kUnroll, kGroup>(
        acc, n,
        [&](int k) {
          return static_cast<const uint4*>(
              p.in.at<S>(ring[wrap(my + dir * (1 + k), n)]));
        },
        [&](int i) { return at[i]; },
        [&](int i) { return base + i * kThreads < hi; });
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      if (base + i * kThreads >= hi) continue;
      for (int k = 0; k < n; ++k) {
        static_cast<uint4*>(p.out.at<S>(ring[k]))[at[i]] = acc[i];
      }
    }
  }
  leave<S>(p, r, ring, before);
}

// Three blocks per SM (at most 80 registers), as with the rank tables in
// the parameters (unbounded: 88-90 registers, two; see ring.cu's
// ring_kernel).
template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
bidir_kernel(const __grid_constant__ Params p) {
  bidir_body<T, Scope::kGpu>(p, blockIdx.x, 0);
}

// The cross-process instances: Params over device tables of every
// member's peer-mapped buffers (block x plays flat rank rings.local[x]),
// and the flags' count before the call.
struct PeerParams {
  Params p;
  int before;
};

template <typename T, int kPer>
__global__ void __launch_bounds__(kHbmThreads)
hbm_peer_kernel(const __grid_constant__ PeerParams q) {
  hbm_body<T, kPer, Scope::kSys>(q.p, q.p.rings.local[blockIdx.x], q.before);
}

template <bool kRegs>
__global__ void __launch_bounds__(kThreads)
q8_peer_kernel(const __grid_constant__ PeerParams q) {
  q8_body<kRegs, Scope::kSys>(q.p, q.p.rings.local[blockIdx.x], q.before);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bidir_peer_kernel(const __grid_constant__ PeerParams q) {
  bidir_body<T, Scope::kSys>(q.p, q.p.rings.local[blockIdx.x], q.before);
}

// The instances: B9 by dtype and tile (8, 16 or 32 KB) and B11 by dtype,
// at every code of GTT_SUM_TYPES (ring.SUM_DTYPES); B10 f32 (code 1) in
// its two forms; each on one card or, kPeer, across processes.
template <typename T, int kPer, bool kPeer>
void* hbm_instance() {
  if constexpr (kPeer) {
    return (void*)hbm_peer_kernel<T, kPer>;
  } else {
    return (void*)hbm_kernel<T, kPer>;
  }
}

template <typename T, bool kPeer>
void* hbm_for(int tile_bytes) {
  if (tile_bytes == kThreads * 2 * 16) return hbm_instance<T, 2, kPeer>();
  if (tile_bytes == kThreads * 4 * 16) return hbm_instance<T, 4, kPeer>();
  if (tile_bytes == kThreads * 8 * 16) return hbm_instance<T, 8, kPeer>();
  return nullptr;
}

template <typename T, bool kPeer>
void* bidir_for() {
  if constexpr (kPeer) {
    return (void*)bidir_peer_kernel<T>;
  } else {
    return (void*)bidir_kernel<T>;
  }
}

template <bool kPeer = false>
void* kernel_for(int variant, int dtype, int tile_bytes) {
  if (variant == kQ8 || variant == kQ8Mem) {
    if (dtype != 1) return nullptr;
    if constexpr (kPeer) {
      return variant == kQ8 ? (void*)q8_peer_kernel<true>
                            : (void*)q8_peer_kernel<false>;
    } else {
      return variant == kQ8 ? (void*)q8_kernel<true>
                            : (void*)q8_kernel<false>;
    }
  }
#define GTT_VARIANT_CASE(CODE, T, SCALAR)                         \
  if (dtype == CODE) {                                            \
    return variant == kHbm     ? hbm_for<T, kPeer>(tile_bytes)    \
           : variant == kBidir ? bidir_for<T, kPeer>()            \
                               : nullptr;                         \
  }
  GTT_SUM_TYPES(GTT_VARIANT_CASE)
#undef GTT_VARIANT_CASE
  return nullptr;
}

// B9's dynamic shared memory: the stages, two output tiles, the mbarriers.
int hbm_smem(int tile_bytes, int stages) {
  return (stages + 2) * tile_bytes + 2 * stages * 8;
}

// Threads and dynamic shared memory of a launch; lets the kernel take
// more than 48 KB of it.
cudaError_t shape_of(int variant, void* fn, int tile_bytes, int stages,
                     int* threads, int* smem) {
  *threads = variant == kHbm ? kHbmThreads : kThreads;
  *smem = variant == kHbm ? hbm_smem(tile_bytes, stages) : 0;
  if (*smem == 0) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              *smem);
}

// Checks the sizes and the ring tables (host arrays my and members, their
// device copy `table`) and fills the per-rank buffers: rank r's input and
// output are base + r * rank_stride (bytes), its flags `sets` sets of
// flag_stride ints.
bool fill(Params& p, const void* in, void* out, long long rank_stride,
          int* flags, int flag_stride, int sets, const int* my,
          const int* members, const int* table, int ranks, int n,
          int slices) {
  if (ranks < 2 || n < 2 || n > ranks || slices < 1 || slices > 65535 ||
      flag_stride < 1 ||
      !check_rings(my, members, nullptr, ranks, ranks, n, table)) {
    return false;
  }
  memset(&p, 0, sizeof(p));
  p.in = strided(in, rank_stride);
  p.out = strided(out, rank_stride);
  p.flags = strided(flags, static_cast<long long>(sets) * flag_stride *
                               static_cast<long long>(sizeof(int)));
  p.rings = rings_at(table, ranks, ranks);
  p.n = n;
  p.flag_stride = flag_stride;
  return true;
}

template <typename P>
int launch(int variant, void* fn, const P& p, int stages, dim3 grid,
           int tile_bytes, void* stream) {
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int threads = 0, smem = 0;
  cudaError_t err = shape_of(variant, fn, tile_bytes, stages, &threads,
                             &smem);
  void* args[] = {const_cast<P*>(&p)};
  if (err == cudaSuccess) {
    err = cudaLaunchCooperativeKernel(fn, grid, dim3(threads), args, smem,
                                      static_cast<cudaStream_t>(stream));
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

template <bool kPeer>
int max_blocks(int variant, int tile_bytes, int stages, int* blocks) {
  int per_sm = 1 << 30;
  cudaError_t err = cudaSuccess;
  bool any = false;
  for (int dtype = 0; dtype < kSumTypes && err == cudaSuccess; ++dtype) {
    void* fn = kernel_for<kPeer>(variant, dtype, tile_bytes);
    if (fn == nullptr) continue;
    any = true;
    int threads = 0, smem = 0, n = 0;
    err = shape_of(variant, fn, tile_bytes, stages, &threads, &smem);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, threads,
                                                          smem);
    }
    if (err == cudaSuccess && n < per_sm) per_sm = n;
  }
  if (!any || (variant == kHbm && stages < 1)) err = cudaErrorInvalidValue;
  return cooperative_blocks(err, per_sm, blocks);
}

}  // namespace

extern "C" {

// Ints of flags each (rank, slice), or (rank, half, slice) for B11, takes:
// the members barrier's one, padded to 32 bytes so that the spins of
// neighbouring slices do not share an L2 sector.
int gtt_ring_variants_flag_stride(int) { return 8; }

// The most blocks of one variant's kernels (every dtype it has; for B9
// those of tile_bytes with `stages` stages) that can be resident at once
// on the current device (the cooperative launch's limit), in *blocks.
int gtt_ring_variants_max_blocks(int variant, int tile_bytes, int stages,
                                 int* blocks) {
  return max_blocks<false>(variant, tile_bytes, stages, blocks);
}

// The same for the cross-process instances.
int gtt_ring_variants_peer_max_blocks(int variant, int tile_bytes,
                                      int stages, int* blocks) {
  return max_blocks<true>(variant, tile_bytes, stages, blocks);
}

// Each returns a cudaError_t; 0 is success. x and out: P ranks of n
// chunks at rank_stride bytes, every buffer 16-byte aligned. dtype: a code
// of GTT_SUM_TYPES (B10: 1, f32 only). flags: zeroed, P x S x flag_stride
// ints (B11: P x 2 x S x flag_stride), and for B10 then 2 n P more. my:
// each rank's ring index; members: ranks x n flat ranks, row r the ring of
// rank r in ring order: host arrays, checked before the launch. table: the
// same tables in device memory (ring_common.cuh's Rings), which the kernel
// reads. Any number of ranks whose blocks the card holds at once.

// B9: chunk = 16-byte units per chunk; tile_bytes 8192, 16384 or 32768;
// stages >= 1 (the launch takes (stages + 2) tiles of shared memory).
int gtt_ring_allreduce_hbm(const void* x, void* out, long long rank_stride,
                           int* flags, int flag_stride, const int* my,
                           const int* members, const int* table, int ranks,
                           int n, int slices, long long chunk,
                           int tile_bytes, int stages, int dtype,
                           void* stream) {
  Params p;
  if (!fill(p, x, out, rank_stride, flags, flag_stride, slices, my, members,
            table, ranks, n, slices) ||
      chunk < 1 || stages < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.chunk = chunk;
  p.stages = stages;
  return launch(kHbm, kernel_for(kHbm, dtype, tile_bytes), p, stages,
                dim3(ranks, slices), tile_bytes, stream);
}

// B10 (f32): chunk = 16-byte units (4 floats) per chunk. in_registers: 1
// for the register form (a slice of at most kThreads x kQ8Units units: S
// >= chunk / (kThreads kQ8Units)), 0 for the out-of-register form.
int gtt_ring_allreduce_q8(const void* x, void* out, long long rank_stride,
                          int* flags, int flag_stride, const int* my,
                          const int* members, const int* table, int ranks,
                          int n, int slices, long long chunk,
                          int in_registers, void* stream) {
  Params p;
  if (!fill(p, x, out, rank_stride, flags, flag_stride, slices, my, members,
            table, ranks, n, slices) ||
      chunk < 1 ||
      (in_registers &&
       (chunk + slices - 1) / slices > kThreads * kQ8Units)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // The cells follow every rank's flag sets.
  int* const cells =
      flags + static_cast<long long>(ranks) * slices * flag_stride;
  p.cells = strided(cells, 2LL * n * static_cast<long long>(sizeof(int)));
  p.chunk = chunk;
  const int variant = in_registers ? kQ8 : kQ8Mem;
  return launch(variant, kernel_for(variant, 1, 0), p, 0,
                dim3(ranks, slices), 0, stream);
}

// B11: chunk_rows rows per chunk, half_units 16-byte units per row of one
// column half (a row is 2 half_units).
int gtt_ring_allreduce_bidir(const void* x, void* out, long long rank_stride,
                             int* flags, int flag_stride, const int* my,
                             const int* members, const int* table, int ranks,
                             int n, int slices, long long chunk_rows,
                             long long half_units, int dtype, void* stream) {
  Params p;
  if (!fill(p, x, out, rank_stride, flags, flag_stride, 2 * slices, my,
            members, table, ranks, n, slices) ||
      chunk_rows < 1 || half_units < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.chunk_rows = chunk_rows;
  p.half_units = half_units;
  return launch(kBidir, kernel_for(kBidir, dtype, 0), p, 0,
                dim3(ranks, 2, slices), 0, stream);
}

// The cross-process instances, one cooperative launch per process of grid
// (local_ranks, slices), B11 (local_ranks, 2, slices). variant: 0 B9, 1
// B10 (register form), 2 B11, 3 B10 (out-of-register form). in, out and
// flags: `ranks` host arrays of device pointers by flat rank (each
// member's input and output of n chunks, 16-byte aligned, and its
// kPeerFlags flag ints, peer-mapped or this process's own), and d_in,
// d_out, d_flags the same arrays in device memory (tpu/peer.py's
// PeerWorkspace.device_table); cells (B10): 2 n zeroed ints per local
// rank, this process's own; local: the flat ranks this process plays; my,
// members and table as gtt_ring_allreduce_hbm's (members' rows read for
// the local ranks; table's local part is this process's). chunk (B9,
// B10), chunk_rows and half_units (B11), tile_bytes and stages (B9) and
// dtype as the one-card entries take them. before: every flag's count
// before this call (each call adds (n - 1) x the blocks per rank to each);
// every process of the ring makes the same calls in the same order with
// the same slices.
int gtt_ring_variants_peer(int variant, const void* const* in,
                           void* const* out, int* const* flags,
                           const void* const* d_in, void* const* d_out,
                           int* const* d_flags, int* cells,
                           const int* local, int local_ranks, const int* my,
                           const int* members, const int* table, int ranks,
                           int n, int slices, long long chunk,
                           long long chunk_rows, long long half_units,
                           int tile_bytes, int stages, int dtype, int before,
                           void* stream) {
  const bool q8 = variant == kQ8 || variant == kQ8Mem;
  if (ranks < 2 || n < 2 || n > ranks || d_in == nullptr ||
      d_out == nullptr || d_flags == nullptr ||
      local_ranks < 1 || local_ranks > ranks || slices < 1 ||
      slices > 65535 || before < 0 || (q8 && cells == nullptr) ||
      (variant == kHbm && stages < 1) ||
      (variant == kBidir ? chunk_rows < 1 || half_units < 1 : chunk < 1) ||
      (variant == kQ8 &&
       (chunk + slices - 1) / slices > kThreads * kQ8Units)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!check_rings(my, members, local, local_ranks, ranks, n, table) ||
      !check_pointers(in, ranks, 16) || !check_pointers(out, ranks, 16) ||
      !check_pointers(flags, ranks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PeerParams q;
  memset(&q, 0, sizeof(q));
  Params& p = q.p;
  p.in = tabled(d_in);
  p.out = tabled(d_out);
  p.flags = tabled(d_flags);
  if (q8) {
    p.cells = strided(cells, 2LL * n * static_cast<long long>(sizeof(int)));
  }
  p.rings = rings_at(table, ranks, local_ranks);
  p.n = n;
  p.flag_stride = kPeerFlags;
  p.stages = stages;
  p.chunk = chunk;
  p.chunk_rows = chunk_rows;
  p.half_units = half_units;
  q.before = before;
  const dim3 grid = variant == kBidir ? dim3(local_ranks, 2, slices)
                                      : dim3(local_ranks, slices);
  return launch(variant, kernel_for<true>(variant, q8 ? 1 : dtype,
                                          tile_bytes),
                q, stages, grid, tile_bytes, stream);
}

const char* gtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
