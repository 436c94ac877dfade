// Flash-attention backward for Hopper (sm_90a), with a plain C interface.
//
// Replaces gloo_tpu/ops/attention.py::_flash_bwd_fused_kernel, the Pallas
// TPU kernel behind flash_attention's custom VJP: dQ, dK and dV from q, k,
// v, the output's cotangent dO, the forward's out and logsumexp rows (lse),
// recomputing every softmax tile from lse rather than reading a (t, t)
// matrix.
//
// What bounds it on an H100: at the flagship training shape (b*h = 32,
// t = 128, d = 64, causal, bf16) q, k, v, dO, dQ, dK and dV are 3.67 MB and
// lse and delta 32 KB, 1.1 us at 3.35 TB/s; the five products over the
// 8256 (q, k) pairs per head that the mask keeps are 169 MFLOP, 0.17 us at
// 989 TFLOP/s. Bytes bound it there, and the launches lie above both. At
// long sequences (the Ulysses path's b*h = 8, t = 4096, d = 64, causal:
// 43 GFLOP against 25 MB) the tensor cores do (~0.043 ms).
//
// Three launches per backward, all named flash_bwd_*:
//   1. flash_bwd_prep_kernel: delta = rowsum(dO * out) in f32 and the lse
//      rows, side by side per 64-row query tile (rows past t get lse =
//      +inf, so their p is exp(-inf) = 0 with no mask), and dq_acc = 0;
//   2. the main kernel (below);
//   3. flash_bwd_dq_kernel: dq = dq_acc * (1 / sqrt(d)) in the input type.
//
// bf16 and f16 (the model's types; one template, T),
// flash_bwd_wgmma_kernel: one block per (flat kv head, 64-key tile),
// longest blocks first under the causal mask (grid x runs over heads, y
// over key tiles), of one consumer warpgroup (128 threads) and one
// producer warp. The producer's lane 0 loads k and v once
// by TMA (128-byte-swizzled 64 x 64 slabs, hopper.cuh), where they stay,
// then streams the q and dO tiles of every query tile that sees this key
// tile, with their lse and delta rows (one 512-byte bulk copy), through
// kStages<D> stages on full/empty mbarriers; query tiles wholly above the
// causal diagonal are never loaded. The block walks the query heads of its
// GQA group and their query tiles; per tile the consumers
//   - scale q in shared memory (q * scale rounded to T, then
//     fence.proxy.async so that wgmma reads the scaled values);
//   - S^T = k (q * scale)^T and dP^T = v dO^T on SS wgmma (k, v as A and
//     q, dO as B, all K-major), f32 accumulators with rows = keys;
//   - p^T = exp(s^T - lse) (the SFU's 2^x, fast_exp) masked only on tiles
//     that cross the diagonal or the ragged end, ds^T = p^T (dp^T - delta),
//     both packed to T as the A fragments of two 8-column slices
//     (the accumulator layout: B1's PV trick);
//   - dV += p^T dO and dK += ds^T (q * scale) on RS wgmma (A from
//     registers, dO and q MN-major from the stage): no round trip of p^T or
//     ds^T through shared memory for these two;
//   - ds^T (T) to shared memory once, and dQ = dS k on SS wgmma with
//     ds^T read transposed (MN-major A) and k MN-major, one 64-column half
//     of d at a time (a d = 128 tile of dQ would not fit in registers beside
//     dK and dV);
//   - each half's f32 dQ staged in shared memory (128-byte swizzled) and
//     added into the f32 dq_acc by TMA reduce-adds of 32 x 64 boxes
//     (cp.reduce.async.bulk.tensor): one per box and tile, in place of two
//     f32 atomicAdds per element and key tile.
// The accumulators of dK and dV run over every query head of the group in
// f32 ("dK/dV group-summed in f32 before the single downcast") and are
// stored once. Reduce-adds from the blocks of one query row land in no
// fixed order, so dQ agrees with the plain version within a tolerance and
// not bit for bit; dK and dV are deterministic.
//
// d = 256 (136-248 zero-padded to it): dK and dV over the whole width
// would take 256 registers a thread for their accumulators alone (d = 128
// already takes 244 in all). So a block owns one 128-column half of the
// outputs: grid x runs over (kv head, half), each block recomputes S^T
// and dP^T over the full d (k and v resident, q and dO streamed, 4 slabs
// each) and accumulates dK, dV and dQ for its half only, in the d = 128
// instance's registers. Seven products per tile where one block would do
// five; one stage of q/dO (170 KB of shared memory).
//
// f32 (off the model's path) keeps the FMA design, flash_bwd_f32_kernel:
// one block of kWarps warps per (16 kWarps-key tile, flat kv head, column
// part); warp w owns keys 16w .. 16w + 15 and forms s^T, p^T, dp^T, ds^T in
// registers, writes p^T and ds^T to shared memory for dV, dK and dQ, and
// adds dQ into dq_acc with atomicAdd. 4 warps and the whole width up to
// d = 128; at d = 256, 2 warps (32 keys) and two 128-column halves, so
// that k, v, q and dO fit in shared memory (213 KB) and dK, dV in
// registers.
//
// Rows (b * h) past the grid's 65535 go on grid z where they lie on y
// (rows_grid in flash_common.cuh); the main kernel has them on x.
//
// Numerics follow the TPU kernel step by step: q * scale rounded to the
// input type (the wrapper passes scale already rounded to that type), s
// and dp accumulated in f32, p = exp(s - lse) in f32, p rounded to dO's
// type for dV, ds = p (dp - delta) in f32 and rounded to the input type
// for dK and dQ. dK contracts ds with the scaled q and so carries the
// rounded scale; dQ contracts ds with the unscaled k and takes the
// unrounded f32 1/sqrt(d) at the end (dq_scale): at d = 128 the two differ
// by ~0.1 % in bf16. Rows past t in a ragged last tile are zero in q, dO,
// k and v (TMA fills them), keys past t get p = 0, and queries past t
// exp(-inf) = 0, so padded rows and keys add nothing anywhere.

#include "flash_common.cuh"
#include "hopper.cuh"

#include <atomic>
#include <cmath>
#include <cstring>

namespace {

using namespace gtt;

constexpr int kBlockQ = 64;  // query rows per tile
constexpr int kBlockK = 64;  // keys per block
constexpr int kThreads = 128;  // 16-bit: the consumer warpgroup
constexpr int kTmaThreads = kThreads + 32;  // 16-bit: + the producer warp
constexpr int kSlab = 64 * 128;  // one swizzled slab: 64 lines x 128 bytes
// Per 64-row query tile: its lse rows, then its delta rows (f32).
constexpr int kRowsPerTile = 2 * kBlockQ;
constexpr int kPrepThreads = 256;  // 4 per row of a query tile
// f32: query columns of s^T and dp^T a warp holds in registers at once;
// the 64-column tile goes in two halves so that d = 128 fits beside the dK
// and dV accumulators.
constexpr int kChunk = 32;

// Output columns a block owns: the whole d up to 128; a half at d = 256.
template <int D>
constexpr int kCols = D > 128 ? 128 : D;

// ---- launch 1: delta, the lse rows and dq_acc = 0 ----

struct PrepParams {
  const void* dout;
  const void* out;
  const float* lse;  // (b*h, t) contiguous
  float* rows;       // (b*h, n_q, kRowsPerTile)
  float* dq_acc;     // (b*h, t, d) contiguous
  int bh;            // b * h
  int h, t, d, n_q;
  long long o_sb, o_sh, o_st;  // dO, in elements; d is contiguous
  long long y_sb, y_sh, y_st;  // out
};

// Block (query tile, flat head); 4 threads per row, each summing every
// fourth 16-byte vector of dO * out.
template <typename T>
__global__ void __launch_bounds__(kPrepThreads)
    flash_bwd_prep_kernel(const PrepParams p) {
  constexpr int kVec = 16 / sizeof(T);
  if (grid_row() >= p.bh) return;
  const int qi = blockIdx.x;
  const long long head = grid_row();
  const int b = static_cast<int>(head / p.h);
  const int hq = static_cast<int>(head % p.h);
  const int r = threadIdx.x / 4;
  const int row = qi * kBlockQ + r;
  float sum = 0.f;
  if (row < p.t) {
    const T* dg = static_cast<const T*>(p.dout) + b * p.o_sb + hq * p.o_sh +
                  row * p.o_st;
    const T* yg = static_cast<const T*>(p.out) + b * p.y_sb + hq * p.y_sh +
                  row * p.y_st;
    for (int c = threadIdx.x % 4 * kVec; c < p.d; c += 4 * kVec) {
      const uint4 a = *reinterpret_cast<const uint4*>(dg + c);
      const uint4 y = *reinterpret_cast<const uint4*>(yg + c);
      const T* ea = reinterpret_cast<const T*>(&a);
      const T* ey = reinterpret_cast<const T*>(&y);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        sum = __fadd_rn(sum, __fmul_rn(to_f32(ea[j]), to_f32(ey[j])));
      }
    }
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  if (threadIdx.x % 4 == 0) {
    float* tile = p.rows + (head * p.n_q + qi) * kRowsPerTile;
    tile[r] = row < p.t ? p.lse[head * p.t + row] : INFINITY;
    tile[kBlockQ + r] = sum;
  }
  const int rows = min(kBlockQ, p.t - qi * kBlockQ);
  float4* const zero = reinterpret_cast<float4*>(
      p.dq_acc + (head * p.t + qi * kBlockQ) * p.d);
  for (int i = threadIdx.x; i < rows * p.d / 4; i += kPrepThreads) {
    zero[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// ---- launch 2, bf16 and f16: wgmma on TMA-staged tiles ----

// Stages of the q/dO ring by head_dim: both query tiles of a block at the
// flagship's t = 128 in flight before the first product; one at d = 256,
// where a stage is 65 KB.
template <int D>
constexpr int kStages = D > 128 ? 1 : 2;
// Blocks per SM the registers are held to: two at d = 64 (dK, dV, S^T,
// dP^T and a dQ half, ~200 registers); one at d = 128 and 256, where dK
// and dV alone take 128.
template <int D>
constexpr int kMinBlocks = D == 64 ? 2 : 1;
template <int D>
constexpr int kTile = D / 64 * kSlab;  // bytes of a 64-row 16-bit tile
// One stage: the q tile, the dO tile, and their lse and delta rows (512
// bytes, padded to keep the next tile 1024-byte aligned).
template <int D>
constexpr int kStageBytes = 2 * kTile<D> + 1024;
// Shared memory of a 16-bit launch: k, v, the stages, ds^T (64 x 64), the
// dQ staging (64 x kCols f32 as kCols / 32 boxes of 32 columns), the
// mbarriers and the swizzle's 1024-byte alignment (d = 64: 76,840 bytes,
// d = 128: 142,376, d = 256: 174,104).
template <int D>
constexpr int kSmem = 2 * kTile<D> + kStages<D> * kStageBytes<D> + kSlab +
                      kCols<D> / 32 * kSlab + 8 * (1 + 2 * kStages<D>) +
                      1024;

struct TmaParams {
  // q, dO (b, h, t, d) and k, v (b, h_kv, t, d) as {d, t, heads, b} maps,
  // box {64, 64, 1, 1}; dq_acc (b*h, t, d) f32 as {d, t, b*h}, box
  // {32, 64, 1}; all 128-byte swizzled.
  CUtensorMap q;
  CUtensorMap k;
  CUtensorMap v;
  CUtensorMap dout;
  CUtensorMap dq;
  const float* rows;  // (b*h, n_q, kRowsPerTile): lse, delta
  void* dk;           // (b*h_kv, t, d) contiguous, T
  void* dv;
  int h, h_kv, group, t, n_q;
  int causal;
  float scale;  // 1 / sqrt(d), already rounded to T
};

__device__ __forceinline__ void consumers_sync() { named_sync<kThreads>(1); }

// Byte offset of (row, 16-byte chunk) in a 128-byte-swizzled tile of
// 128-byte rows.
__device__ __forceinline__ int swizzled(int row, int chunk) {
  return row * 128 + ((chunk ^ (row % 8)) << 4);
}

template <int D, typename T>
__global__ void __launch_bounds__(kTmaThreads, kMinBlocks<D>)
    flash_bwd_wgmma_kernel(const __grid_constant__ TmaParams p) {
  constexpr int kSlabs = D / 64;         // slabs per q, k, v, dO tile
  constexpr int kOut = kCols<D> / 64;    // slabs of the block's columns
  constexpr int kHalves = D / kCols<D>;  // blocks per (kv head, key tile)
  constexpr int kT = kTile<D>;
  constexpr int kSt = kStages<D>;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* const ks = aligned_smem(smem_raw);
  uint8_t* const vs = ks + kT;
  uint8_t* const stages = vs + kT;  // q, dO, rows of stage s
  uint8_t* const dst_s = stages + kSt * kStageBytes<D>;  // ds^T, T
  uint8_t* const dq_s = dst_s + kSlab;                   // dQ, f32
  uint64_t* const kv_full =
      reinterpret_cast<uint64_t*>(dq_s + kCols<D> / 32 * kSlab);
  uint64_t* const full = kv_full + 1;
  uint64_t* const empty = full + kSt;

  const int bk = blockIdx.x / kHalves;  // flat kv head b * h_kv + hk
  const int c0 = blockIdx.x % kHalves * kOut;  // the block's first slab
  const int kb = blockIdx.y;
  const int k0 = kb * kBlockK;
  const int b = bk / p.h_kv;
  const int hk = bk % p.h_kv;
  // Causal: query tiles wholly above this key tile's diagonal are skipped
  // (kBlockQ == kBlockK).
  const int qi_first = p.causal ? kb : 0;
  const int per_head = p.n_q - qi_first;
  const int tiles = p.group * per_head;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kSt; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kThreads) {
    // The producer warp: its lane 0 issues every load.
    if (threadIdx.x == kThreads) {
      prefetch_map(&p.q);
      prefetch_map(&p.k);
      prefetch_map(&p.v);
      prefetch_map(&p.dout);
      mbar_expect(kv_full, 2 * kT);
#pragma unroll
      for (int c = 0; c < kSlabs; ++c) {
        tma_load_4d(ks + c * kSlab, &p.k, kv_full, c * 64, k0, hk, b);
        tma_load_4d(vs + c * kSlab, &p.v, kv_full, c * 64, k0, hk, b);
      }
      for (int it = 0; it < tiles; ++it) {
        const int s = it % kSt;
        const int hq = hk * p.group + it / per_head;
        const int q0 = (qi_first + it % per_head) * kBlockQ;
        uint8_t* const st = stages + s * kStageBytes<D>;
        if (it >= kSt) mbar_wait(empty + s, (it / kSt - 1) & 1);
        mbar_expect(full + s, 2 * kT + kRowsPerTile * 4);
#pragma unroll
        for (int c = 0; c < kSlabs; ++c) {
          tma_load_4d(st + c * kSlab, &p.q, full + s, c * 64, q0, hq, b);
          tma_load_4d(st + kT + c * kSlab, &p.dout, full + s, c * 64, q0, hq,
                      b);
        }
        bulk_load(st + 2 * kT,
                  p.rows + (static_cast<long long>(b * p.h + hq) * p.n_q +
                            q0 / kBlockQ) * kRowsPerTile,
                  kRowsPerTile * 4, full + s);
      }
    }
    return;
  }

  const int lane = threadIdx.x % 32;
  const int c2 = 2 * (lane % 4);
  const int r0 = acc_row(0);  // this thread's tile rows: r0 and r0 + 8
  const uint32_t k_addr = smem_addr(ks);
  const uint32_t v_addr = smem_addr(vs);
  const uint32_t ds_addr = smem_addr(dst_s);

  float dk[kOut][32];
  float dv[kOut][32];
#pragma unroll
  for (int c = 0; c < kOut; ++c) {
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[c][i] = dv[c][i] = 0.f;
  }

  mbar_wait(kv_full, 0);
  for (int it = 0; it < tiles; ++it) {
    const int s = it % kSt;
    const int hq = hk * p.group + it / per_head;
    const int qi = qi_first + it % per_head;
    const int q0 = qi * kBlockQ;
    uint8_t* const qs = stages + s * kStageBytes<D>;
    const float* const rows = reinterpret_cast<const float*>(qs + 2 * kT);
    const uint32_t q_addr = smem_addr(qs);
    const uint32_t o_addr = q_addr + kT;

    // q * scale rounded to T, in place; then visible to wgmma's reads.
    mbar_wait(full + s, (it / kSt) & 1);
    scale_in_place<T, kThreads>(qs, kT, p.scale);
    fence_proxy_async_shared();
    consumers_sync();

    // S^T = k (q * scale)^T and dP^T = v dO^T in f32 over the whole d:
    // rows are keys, columns queries of the tile.
    float sc[32];
    float dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    fence_acc(sc);
    fence_acc(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = kk / 4 * kSlab + kk % 4 * 32;
      wgmma_bf16<0, 0, T>(sc, desc(k_addr + off), desc(q_addr + off));
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = kk / 4 * kSlab + kk % 4 * 32;
      wgmma_bf16<0, 0, T>(dp, desc(v_addr + off), desc(o_addr + off));
    }
    wgmma_commit();
    wgmma_wait<0>(sc);
    fence_acc(dp);

    // p^T = exp(s^T - lse), ds^T = p^T (dp^T - delta). Only tiles that
    // cross the diagonal or the ragged end of the keys pay the mask.
    const bool masked = (p.causal && qi == kb) || k0 + kBlockK > p.t;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j * 8 + c2 + e;
        const float lse = rows[col];
        const float delta = rows[kBlockQ + col];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int x = 4 * j + 2 * i + e;
          const int key = k0 + r0 + 8 * i;
          float pe = fast_exp(sc[x] - lse);
          if (masked && (key >= p.t || (p.causal && key > q0 + col))) {
            pe = 0.f;
          }
          sc[x] = pe;
          dp[x] = pe * (dp[x] - delta);
        }
      }
    }
    // p^T and ds^T in T as the A fragments of the four 16-query steps.
    uint32_t pa[4][4];
    uint32_t da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        pa[kk][f] = pack2<T>(sc[8 * kk + 2 * f], sc[8 * kk + 2 * f + 1]);
        da[kk][f] = pack2<T>(dp[8 * kk + 2 * f], dp[8 * kk + 2 * f + 1]);
      }
    }

    // dV += p^T dO and dK += ds^T (q * scale) over the block's columns, dO
    // and q MN-major.
#pragma unroll
    for (int c = 0; c < kOut; ++c) {
      fence_acc(dv[c]);
      fence_acc(dk[c]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int c = 0; c < kOut; ++c) {
        wgmma_bf16_rs<1, T>(dv[c], pa[kk],
                            desc(o_addr + (c0 + c) * kSlab + kk * 2048));
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int c = 0; c < kOut; ++c) {
        wgmma_bf16_rs<1, T>(dk[c], da[kk],
                            desc(q_addr + (c0 + c) * kSlab + kk * 2048));
      }
    }
    wgmma_commit();

    // Meanwhile ds^T to shared memory: rows of 64 queries, swizzled, the
    // A fragments' pairs as they lie (fragment f of step kk holds row
    // r0 + 8 (f % 2), columns 16 kk + 8 (f / 2) + c2, + 1). The previous
    // tile's dQ products, which read it, are complete.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int row = r0 + 8 * (f % 2);
        *reinterpret_cast<uint32_t*>(dst_s + swizzled(row, 2 * kk + f / 2) +
                                     2 * c2) = da[kk][f];
      }
    }
    wgmma_wait<0>(dv[0]);
#pragma unroll
    for (int c = 0; c < kOut; ++c) {
      fence_acc(dv[c]);
      fence_acc(dk[c]);
    }
    fence_regs<16>(&pa[0][0]);
    fence_regs<16>(&da[0][0]);
    mbar_arrive(empty + s);  // this thread is done with stage s
    fence_proxy_async_shared();
    // The previous tile's reduce-adds have read the dQ staging.
    if (threadIdx.x == 0) bulk_wait_read();
    consumers_sync();

    // dQ = dS k over the block's columns, one 64-column slab at a time:
    // A = ds^T read transposed, B = k MN-major. Staged in f32 as
    // 32-column boxes.
#pragma unroll
    for (int c = 0; c < kOut; ++c) {
      float dq[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) dq[i] = 0.f;
      fence_acc(dq);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_bf16<1, 1, T>(dq, desc(ds_addr + kk * 2048),
                            desc(k_addr + (c0 + c) * kSlab + kk * 2048));
      }
      wgmma_commit();
      wgmma_wait<0>(dq);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint8_t* const box = dq_s + (2 * c + j / 4) * kSlab;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          // Column 8 j + c2 of the slab: chunk 2 (j % 4) + c2 / 4 of its
          // box's 128-byte row, at byte (c2 % 4) * 4 of that chunk.
          const int row = r0 + 8 * i;
          *reinterpret_cast<float2*>(
              box + swizzled(row, 2 * (j % 4) + c2 / 4) + c2 % 4 * 4) =
              make_float2(dq[4 * j + 2 * i], dq[4 * j + 2 * i + 1]);
        }
      }
    }
    fence_proxy_async_shared();
    consumers_sync();
    if (threadIdx.x == 0) {
      const int head = b * p.h + hq;
#pragma unroll
      for (int x = 0; x < kCols<D> / 32; ++x) {
        tma_reduce_add_3d(&p.dq, dq_s + x * kSlab, c0 * 64 + x * 32, q0,
                          head);
      }
      bulk_commit();
    }
  }
  if (threadIdx.x == 0) bulk_wait();  // the last reduce-adds have landed

  T* const dkg = static_cast<T*>(p.dk) + static_cast<long long>(bk) * p.t * D;
  T* const dvg = static_cast<T*>(p.dv) + static_cast<long long>(bk) * p.t * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + r0 + 8 * i;
    if (key >= p.t) continue;
#pragma unroll
    for (int c = 0; c < kOut; ++c) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const long long off =
            static_cast<long long>(key) * D + (c0 + c) * 64 + j * 8 + c2;
        store2(dkg + off, dk[c][4 * j + 2 * i], dk[c][4 * j + 2 * i + 1]);
        store2(dvg + off, dv[c][4 * j + 2 * i], dv[c][4 * j + 2 * i + 1]);
      }
    }
  }
}

// ---- launch 2, f32: the FMA design ----

// Warps of an f32 block, and so its keys (16 per warp): 4 up to d = 128,
// 2 at d = 256.
template <int D>
constexpr int kF32Warps = D > 128 ? 2 : 4;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* rows;  // (b*h, n_q, kRowsPerTile): lse, delta
  float* dq_acc;      // (b*h, t, d) contiguous f32, zero on entry
  float* dk;          // (b*h_kv, t, d) contiguous
  float* dv;
  int rows_kv;  // b * h_kv
  int h, h_kv, group, t, n_q;
  int causal;
  float scale;  // 1 / sqrt(d)
  long long q_sb, q_sh, q_st;  // strides in elements; d is contiguous
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long o_sb, o_sh, o_st;  // dO
};

template <int D>
__global__ void __launch_bounds__(32 * kF32Warps<D>)
    flash_bwd_f32_kernel(const Params p) {
  using T = float;
  constexpr int kWarps = kF32Warps<D>;
  constexpr int kNThreads = 32 * kWarps;
  constexpr int kKeys = 16 * kWarps;  // keys per block
  constexpr int kHalves = D / kCols<D>;
  constexpr int kLd = D + 4;        // k, v, q, dO rows
  constexpr int kLdS = kBlockQ + 4;  // p^T, ds^T: [key][query]
  constexpr int kDT = kCols<D> / 8;  // 8-column slices of dK, dV
  constexpr int kCT = kChunk / 8;

  const int bk = grid_row();  // flat kv head b * h_kv + hk
  if (bk >= p.rows_kv) return;

  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + kKeys * kLd;
  T* qs = vs + kKeys * kLd;  // q * scale
  T* os = qs + kBlockQ * kLd;  // dO
  T* pts = os + kBlockQ * kLd;
  T* dsts = pts + kKeys * kLdS;
  float* lse_s = reinterpret_cast<float*>(dsts + kKeys * kLdS);
  float* delta_s = lse_s + kBlockQ;

  const int k0 = blockIdx.x / kHalves * kKeys;
  const int col0 = blockIdx.x % kHalves * kCols<D>;  // the block's columns
  const int b = bk / p.h_kv;
  const int hk = bk % p.h_kv;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int c2 = 2 * (lane % 4);
  const int kr = warp * 16 + g;  // this lane's key rows: kr and kr + 8

  load_tile<T, D, kLd, kKeys, kNThreads, false>(
      ks, p.k + b * p.k_sb + hk * p.k_sh, p.k_st, k0, p.t, 1.f);
  load_tile<T, D, kLd, kKeys, kNThreads, false>(
      vs, p.v + b * p.v_sb + hk * p.v_sh, p.v_st, k0, p.t, 1.f);

  float dk[kDT][4];
  float dv[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  }

  // Causal: query tiles wholly above this key tile's diagonal are skipped.
  const int qi_first = p.causal ? k0 / kBlockQ : 0;
  for (int hq = hk * p.group; hq < (hk + 1) * p.group; ++hq) {
    const long long head = static_cast<long long>(b) * p.h + hq;
    const T* qg = p.q + b * p.q_sb + hq * p.q_sh;
    const T* og = p.dout + b * p.o_sb + hq * p.o_sh;
    float* dqg = p.dq_acc + head * p.t * D;

    for (int qi = qi_first; qi < p.n_q; ++qi) {
      const int q0 = qi * kBlockQ;
      __syncthreads();  // every warp is done with the previous query tile
      load_tile<T, D, kLd, kBlockQ, kNThreads, true>(qs, qg, p.q_st, q0, p.t,
                                                     p.scale);
      load_tile<T, D, kLd, kBlockQ, kNThreads, false>(os, og, p.o_st, q0,
                                                      p.t, 1.f);
      const float* tile = p.rows + (head * p.n_q + qi) * kRowsPerTile;
      for (int i = threadIdx.x; i < kBlockQ; i += kNThreads) {
        lse_s[i] = tile[i];
        delta_s[i] = tile[kBlockQ + i];
      }
      __syncthreads();

      // Only tiles that cross the diagonal or a ragged end pay the mask.
      const bool masked = (p.causal && k0 + kKeys - 1 > q0) ||
                          k0 + kKeys > p.t || q0 + kBlockQ > p.t;
#pragma unroll
      for (int n0 = 0; n0 < kBlockQ; n0 += kChunk) {
        float s[kCT][4];
        float dp[kCT][4];
#pragma unroll
        for (int j = 0; j < kCT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
        }
        warp_fma<D, kCT, kLd, 1, 1, kLd>(s, ks + warp * 16 * kLd,
                                         qs + n0 * kLd);
        warp_fma<D, kCT, kLd, 1, 1, kLd>(dp, vs + warp * 16 * kLd,
                                         os + n0 * kLd);
#pragma unroll
        for (int j = 0; j < kCT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = n0 + j * 8 + c2 + (e & 1);  // query in the tile
            const int key = k0 + kr + (e >= 2 ? 8 : 0);
            const int query = q0 + col;
            float pe = expf(s[j][e] - lse_s[col]);
            if (masked &&
                (key >= p.t || query >= p.t || (p.causal && key > query))) {
              pe = 0.f;
            }
            s[j][e] = pe;
            dp[j][e] = pe * (dp[j][e] - delta_s[col]);
          }
          const int col = n0 + j * 8 + c2;
          store2(pts + kr * kLdS + col, s[j][0], s[j][1]);
          store2(pts + (kr + 8) * kLdS + col, s[j][2], s[j][3]);
          store2(dsts + kr * kLdS + col, dp[j][0], dp[j][1]);
          store2(dsts + (kr + 8) * kLdS + col, dp[j][2], dp[j][3]);
        }
      }
      __syncwarp();  // the warp's own p^T and ds^T rows are written

      // dV += p^T dO and dK += ds^T (q * scale) over the tile's queries,
      // in the block's columns.
      warp_fma<kBlockQ, kDT, kLdS, 1, kLd, 1>(
          dv, pts + warp * 16 * kLdS, os + col0);
      warp_fma<kBlockQ, kDT, kLdS, 1, kLd, 1>(
          dk, dsts + warp * 16 * kLdS, qs + col0);
      __syncthreads();  // every warp's ds^T rows are written

      // dQ rows q0 + 16 w + (g, g + 8) += ds k over the block's keys, for
      // each 16-row group w of the tile a warp takes, 32 of the block's
      // columns at a time.
      for (int w = warp; w < kBlockQ / 16; w += kWarps) {
#pragma unroll
        for (int c0 = col0; c0 < col0 + kCols<D>; c0 += 32) {
          float dq[4][4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
          }
          warp_fma<kKeys, 4, 1, kLdS, kLd, 1>(dq, dsts + w * 16, ks + c0);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int row = q0 + w * 16 + g + 8 * i;
            if (row >= p.t) continue;
            float* dst = dqg + static_cast<long long>(row) * D + c0 + c2;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              atomicAdd(dst + j * 8, dq[j][2 * i]);
              atomicAdd(dst + j * 8 + 1, dq[j][2 * i + 1]);
            }
          }
        }
      }
    }
  }

  T* dkg = p.dk + static_cast<long long>(bk) * p.t * D;
  T* dvg = p.dv + static_cast<long long>(bk) * p.t * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + kr + 8 * i;
    if (key >= p.t) continue;
#pragma unroll
    for (int j = 0; j < kDT; ++j) {
      const long long off =
          static_cast<long long>(key) * D + col0 + j * 8 + c2;
      store2(dkg + off, dk[j][2 * i], dk[j][2 * i + 1]);
      store2(dvg + off, dv[j][2 * i], dv[j][2 * i + 1]);
    }
  }
}

// dq = dq_acc * scale in the input type, two elements per thread and step.
template <typename T>
__global__ void flash_bwd_dq_kernel(const float* acc, T* dq,
                                    long long pairs, float scale) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < pairs; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const float2 x = reinterpret_cast<const float2*>(acc)[i];
    store2(dq + 2 * i, x.x * scale, x.y * scale);
  }
}

template <typename T>
cudaError_t launch_dq(const float* acc, void* dq, long long elems,
                      float scale, cudaStream_t stream) {
  const long long pairs = elems / 2;
  const int blocks = static_cast<int>(
      pairs / 256 + 1 < 4096 ? pairs / 256 + 1 : 4096);
  flash_bwd_dq_kernel<T><<<blocks, 256, 0, stream>>>(
      acc, static_cast<T*>(dq), pairs, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  constexpr int kKeys = 16 * kF32Warps<D>;
  constexpr int kLd = D + 4;
  constexpr int kLdS = kBlockQ + 4;
  constexpr size_t kSmem = 2 * (kKeys + kBlockQ) * kLd * sizeof(float) +
                           2 * kKeys * kLdS * sizeof(float) +
                           2 * kBlockQ * sizeof(float);
  static std::atomic<bool> smem_set[kMaxDevices];
  const cudaError_t err =
      allow_dynamic_smem(flash_bwd_f32_kernel<D>, kSmem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid =
      rows_grid((p.t + kKeys - 1) / kKeys * (D / kCols<D>), p.rows_kv);
  flash_bwd_f32_kernel<D><<<grid, 32 * kF32Warps<D>, kSmem, stream>>>(p);
  return cudaGetLastError();
}

// st: the (b, heads, t) strides of q, k, v and dO in turn.
template <int D, typename T>
cudaError_t launch_tma(TmaParams& p, int dtype, const void* q, const void* k,
                       const void* v, const void* dout, float* dq_acc, int b,
                       const long long* st, cudaStream_t stream) {
  cudaError_t err =
      encode_heads(&p.q, dtype, q, D, p.t, p.h, b, st[2], st[1], st[0]);
  if (err == cudaSuccess) {
    err = encode_heads(&p.k, dtype, k, D, p.t, p.h_kv, b, st[5], st[4],
                       st[3]);
  }
  if (err == cudaSuccess) {
    err = encode_heads(&p.v, dtype, v, D, p.t, p.h_kv, b, st[8], st[7],
                       st[6]);
  }
  if (err == cudaSuccess) {
    err = encode_heads(&p.dout, dtype, dout, D, p.t, p.h, b, st[11], st[10],
                       st[9]);
  }
  if (err == cudaSuccess) {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                                static_cast<cuuint64_t>(p.t),
                                static_cast<cuuint64_t>(b) * p.h};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 4,
                                   static_cast<cuuint64_t>(p.t) * D * 4};
    const cuuint32_t box[3] = {32, kBlockQ, 1};
    err = encode(&p.dq, 1, 3, dq_acc, dims, strides, box);
  }
  if (err != cudaSuccess) return err;
  static std::atomic<bool> smem_set[kMaxDevices];
  err = allow_dynamic_smem(flash_bwd_wgmma_kernel<D, T>, kSmem<D>, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * p.h_kv * (D / kCols<D>), (p.t + kBlockK - 1) / kBlockK);
  flash_bwd_wgmma_kernel<D, T><<<grid, kTmaThreads, kSmem<D>, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tma_d(TmaParams& p, int dtype, int d, const void* q,
                         const void* k, const void* v, const void* dout,
                         float* dq_acc, int b, const long long* st,
                         cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch_tma<64, T>(p, dtype, q, k, v, dout, dq_acc, b, st,
                               stream);
    case 128:
      return launch_tma<128, T>(p, dtype, q, k, v, dout, dq_acc, b, st,
                                stream);
    default:
      return launch_tma<256, T>(p, dtype, q, k, v, dout, dq_acc, b, st,
                                stream);
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t; 0 is success. dtype: 0 = bf16, 1 = f32, 2 = f16;
// d: 64, 128 or 256. scale is 1/sqrt(d) rounded to the input type (for
// q * scale), dq_scale the same in f32 (for dQ). Strides in elements, d
// contiguous, in the order q, k, v, dO, out, each (b, heads, t); every
// operand 16-byte aligned with strides that are multiples of 16 bytes
// (TMA, and the f32 kernel's row loads). rows (b*h, ceil(t / 64), 128) f32
// and dq_acc (b*h, t, d) f32 are work buffers, written here before they
// are read; dq, dk and dv are written whole. Three launches on `stream`.
// Any b * h below 2^31: past 65535 the grids spread them over y and z.
int gtt_flash_bwd(const void* q, const void* k, const void* v,
                  const void* dout, const void* out, const void* lse,
                  void* rows, void* dq_acc, void* dq, void* dk, void* dv,
                  int dtype, int b, int h, int h_kv, int t, int d, int causal,
                  float scale, float dq_scale, long long q_sb, long long q_sh,
                  long long q_st, long long k_sb, long long k_sh,
                  long long k_st, long long v_sb, long long v_sh,
                  long long v_st, long long o_sb, long long o_sh,
                  long long o_st, long long y_sb, long long y_sh,
                  long long y_st, void* stream) {
  const long long st[15] = {q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh,
                            v_st, o_sb, o_sh, o_st, y_sb, y_sh, y_st};
  const int vec = dtype == 1 ? 4 : 8;
  const auto aligned = [](const void* a) {
    return (reinterpret_cast<uintptr_t>(a) & 15) == 0;
  };
  bool ok = dtype >= 0 && dtype <= 2 && (d == 64 || d == 128 || d == 256) &&
            b >= 1 && h >= 1 && h_kv >= 1 && h % h_kv == 0 &&
            t >= 1 && static_cast<long long>(b) * h < (1LL << 31) &&
            aligned(q) && aligned(k) && aligned(v) && aligned(dout) &&
            aligned(out);
  for (long long x : st) ok = ok && x > 0 && x % vec == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_q = (t + kBlockQ - 1) / kBlockQ;

  PrepParams pp{dout, out, static_cast<const float*>(lse),
                static_cast<float*>(rows), static_cast<float*>(dq_acc),
                b * h, h, t, d, n_q, o_sb, o_sh, o_st, y_sb, y_sh, y_st};
  const dim3 prep_grid = rows_grid(n_q, static_cast<long long>(b) * h);
  if (dtype == 0) {
    flash_bwd_prep_kernel<__nv_bfloat16>
        <<<prep_grid, kPrepThreads, 0, s>>>(pp);
  } else if (dtype == 2) {
    flash_bwd_prep_kernel<__half><<<prep_grid, kPrepThreads, 0, s>>>(pp);
  } else {
    flash_bwd_prep_kernel<float><<<prep_grid, kPrepThreads, 0, s>>>(pp);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  float* acc = static_cast<float*>(dq_acc);
  if (dtype != 1) {
    TmaParams p;
    memset(&p, 0, sizeof(p));
    p.rows = static_cast<const float*>(rows);
    p.dk = dk;
    p.dv = dv;
    p.h = h;
    p.h_kv = h_kv;
    p.group = h / h_kv;
    p.t = t;
    p.n_q = n_q;
    p.causal = causal;
    p.scale = scale;
    err = dtype == 0 ? launch_tma_d<__nv_bfloat16>(p, dtype, d, q, k, v, dout,
                                                   acc, b, st, s)
                     : launch_tma_d<__half>(p, dtype, d, q, k, v, dout, acc,
                                            b, st, s);
  } else {
    Params p{static_cast<const float*>(q), static_cast<const float*>(k),
             static_cast<const float*>(v), static_cast<const float*>(dout),
             static_cast<const float*>(rows), acc,
             static_cast<float*>(dk), static_cast<float*>(dv), b * h_kv, h,
             h_kv, h / h_kv, t, n_q, causal, scale, q_sb, q_sh, q_st, k_sb,
             k_sh, k_st, v_sb, v_sh, v_st, o_sb, o_sh, o_st};
    err = d == 64    ? launch_f32<64>(p, s)
          : d == 128 ? launch_f32<128>(p, s)
                     : launch_f32<256>(p, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long elems = static_cast<long long>(b) * h * t * d;
  err = dtype == 0   ? launch_dq<__nv_bfloat16>(acc, dq, elems, dq_scale, s)
        : dtype == 2 ? launch_dq<__half>(acc, dq, elems, dq_scale, s)
                     : launch_dq<float>(acc, dq, elems, dq_scale, s);
  return static_cast<int>(err);
}

const char* gtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
