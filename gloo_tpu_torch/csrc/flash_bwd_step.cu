// The backward of one ring-attention step for Hopper (sm_90a), with a plain
// C interface: one fused launch per ring step.
//
// Replaces two Pallas TPU kernels of gloo_tpu/ops/attention.py behind
// flash_attention_bwd_step:
//   B7a _flash_bwd_dq_step_kernel   the dQ piece of one key/value block at a
//       global position;
//   B7b _flash_bwd_dkv_step_kernel  dK and dV of that block against the
//       local queries, per query head.
// Both recompute every softmax tile from the completed forward's
// logsumexp rows (lse) and delta = rowsum(dO * O), so each block's pieces
// are correct on their own and the ring backward
// (gloo_tpu_torch/parallel/sp.py) only sums them. The TPU runs them as two
// kernels that each read q, k, v, dO, lse and delta and recompute s and dp;
// here one block computes every product of a (key tile, query tile) pair
// once and feeds all three gradients from it.
//
// What bounds it on an H100: at the long-context path's shape (32 rows,
// t_q = t_kv = 1024, d = 64, bf16, causal; 16.8 M visible (q, k) pairs per
// step on average) the fused work is S, dP, dV, dK and dQ: six bf16
// wgmma passes per pair with the path's bf16-valued cotangent (dV takes
// two: p unrounded, below), eight with an f32 one (13 and 17 us at 989
// TFLOP/s), against ~64 MiB of bytes in the accumulating form (q, k, v,
// dO, the lse/delta rows, and dQ, dK, dV read and written as f32 carriers;
// ~20 us at 3.35 TB/s). Bytes bound it there; in the fresh form (no
// carriers read) the tensor cores do.
//
// Launches (all in this file):
//   1. bwd_step_prep_kernel, once per backward (the lse, delta and dO of a
//      ring backward are the same at every step): lse and delta side by
//      side per 64-row query tile (rows past t_q get lse = +inf, so their
//      p = exp(-inf) = 0 with no mask), and an f32 dO split into
//      dO_hi = T(dO) and dO_lo = T(dO - dO_hi), T the type of q;
//   2. bwd_step_wgmma_kernel<D, kLo, T>, once per ring step (below);
//   3. bwd_step_dq_kernel, once per backward in the accumulating form:
//      dq = dq_acc * (1 / sqrt(d)) in the input type.
//
// bwd_step_wgmma_kernel (bf16 or f16 q, k, v; one template, T): B2's design
// (flash_bwd.cu) at global offsets. One block per (output row, 64-key tile),
// longest blocks first under the causal mask (grid x runs over rows, y over
// key tiles), of one consumer warpgroup (128 threads) and one producer warp.
// The producer's lane 0 loads k and v once by TMA, where they stay, then
// streams the q and dO tiles of every query tile that sees this key tile, with
// their lse and delta rows, through kStages stages on full/empty mbarriers.
// Query tiles wholly above the global diagonal are never loaded: the TPU
// kernels' `active` test, from each row's own q_off and k_off, so one launch
// serves every rank of a world. A block walks `hpb` query heads: the kv_group
// heads of its kv head in the accumulating form (dK and dV accumulate over the
// group in f32 registers: no separate group-sum pass), one query head in the
// fresh form (per-query-head dK and dV, row i reading kv row i / kv_group, as
// the JAX kernels write them).
// Per tile the consumers
//   - scale q in shared memory (q * scale rounded to T, then
//     fence.proxy.async so that wgmma reads the scaled values);
//   - S^T = k (q * scale)^T and dP^T = v dO^T on SS wgmma, once each;
//   - p^T = exp(s^T - lse) (fast_exp), masked only on tiles that cross the
//     global diagonal or the ragged end of the keys, ds^T = p^T (dp^T -
//     delta), packed as RS A fragments (B1's PV trick);
//   - dV += p^T dO and dK += ds^T (q * scale) on RS wgmma;
//   - ds^T (T) to shared memory, and dQ = ds k on SS wgmma per 64-column
//     slab of d, staged in f32 and added into the f32 dQ buffer by TMA
//     reduce-adds (cp.reduce.async.bulk.tensor), as B2 does.
// At d = 256 (136-248 zero-padded to it) a block owns one 128-column half
// of dQ, dK and dV, as B2's d = 256 instance does (grid x runs over
// (output row, half)); S^T and dP^T are recomputed over the whole d by
// each half. One stage of q/dO (dO_lo): 170 KB (202 KB) of shared memory.
//
// The f32 products without rounding them away. The ring backward's cotangent
// is f32 in the TPU kernels, so dP = dO V^T and dV += p^T dO are f32 products
// and p is never rounded. Each f32 operand x runs as x_hi = bf16(x) and x_lo =
// bf16(x - x_hi), and each f32 product as the bf16 passes hi*hi + hi*lo +
// lo*hi into one f32 accumulator: ~16 bits of each operand kept, far closer to
// f32 than TF32's 10. f16 q, k and v split the same way in f16 (split2 in
// flash_common.cuh): ~22 bits where the remainder is a normal f16; below 2^-14
// of its own scale the remainder turns subnormal and hi + lo keeps f16's
// absolute 2^-24, which the ring path's cotangents (|dO| ~ 1, and p in [0, 1])
// stay well above. dP^T = v dO^T is v dO_hi + v dO_lo (v is bf16); dV += p^T
// dO is p_hi dO_hi + p_lo dO_hi + p_hi dO_lo, p_hi and p_lo from registers.
// The model's cotangent is bf16-valued (sp_step's loss is sum(sin(out)), whose
// cotangent reaches the ring backward as cos(out) in bf16): the caller passes
// it as bf16, kLo is false and the dO_lo passes drop out at compile time. The
// products are then exact (a bf16 x bf16 product fits in f32), and equal the
// JAX kernels' f32 products of the same values up to summation order.
//
// Outputs. The fresh form writes dK and dV (f32) and adds dQ * dq_scale
// into a zeroed f32 buffer. The accumulating form adds unscaled dQ into
// the caller's f32 buffer (launch 3 scales it once at the end) and adds dK
// and dV into the caller's f32 carriers: each block owns its tile, so it
// reads, adds and stores with no atomics, deterministically. Reduce-adds
// from the blocks of one query row land in no fixed order, so dQ agrees
// with the plain version within a tolerance and not bit for bit.
//
// f32 q, k, v (off the model's path) keep the FMA design: dq_step_kernel,
// one block per (query row, 16 kWarps-row query tile) walking the key
// tiles, and dkv_step_kernel, one block per (output row, 16 kWarps-key
// tile, column part) walking the query tiles of its hpb heads; two
// launches per step. kWarps is 4 up to d = 128; at d = 256 it is 2 and
// dkv_step_kernel owns one 128-column half, so that the tiles fit in
// shared memory and dK, dV in registers.
//
// d past 256 (any multiple of 8; the wrapper zero-pads the rest), in every
// type: one launch per step of bwd_step_wide_kernel, flash_wide.cuh's
// backward at the rows' global offsets, one block per (output row, 64-key
// tile, column part) walking its hpb query heads; dQ goes into the f32
// buffer by atomicAdd (times dq_scale in the fresh form), and dK and dV are
// written, or added to the carriers. bf16 and f16 read dO as dO_hi (+
// dO_lo) and the packed rows of launch 1; f32 reads the f32 dO, lse and
// delta as they are.
//
// Rows past the grid's 65535 go on grid z where they lie on y (rows_grid
// in flash_common.cuh); the fused kernel has them on x.
//
// Numerics follow the TPU kernels: q * scale rounded to the input type
// (the wrapper passes scale already rounded), s and dp in f32,
// p = exp(s - lse) with no guard (lse is finite for every row), masked
// entries and rows or keys past the ragged ends forced to p = 0, ds
// rounded to the input type for dQ += ds K and dK += ds^T (q * scale), dQ
// times the unrounded f32 1/sqrt(d).

#include "flash_common.cuh"
#include "flash_wide.cuh"
#include "hopper.cuh"

#include <atomic>
#include <cmath>
#include <cstring>

namespace {

using namespace gtt;

constexpr int kBlockQ = 64;  // query rows per tile
constexpr int kBlockK = 64;  // keys per tile
constexpr int kThreads = 128;  // 16-bit: the consumer warpgroup
constexpr int kTmaThreads = kThreads + 32;  // 16-bit: + the producer warp
constexpr int kSlab = 64 * 128;  // one swizzled slab: 64 lines x 128 bytes
// Per 64-row query tile: its lse rows, then its delta rows (f32).
constexpr int kRowsPerTile = 2 * kBlockQ;
constexpr int kPrepThreads = 256;
// f32: query columns of s^T and dp^T a dkv warp holds in registers at once.
constexpr int kChunk = 32;

// Output columns a block owns: the whole d up to 128; a half at d = 256.
template <int D>
constexpr int kCols = D > 128 ? 128 : D;

// Whether row `row`'s query tile qi sees key tile k0 under the causal mask
// at the row's global offsets: the TPU kernels' `active` test. The first
// query tile that does, for the block's key tile (later ones all do).
__device__ __forceinline__ int first_tile(const int* q_off, const int* k_off,
                                          int row, int k0, int n_q,
                                          int causal) {
  if (!causal) return 0;
  const int gap = k_off[row] + k0 - q_off[row] - (kBlockQ - 1);
  return gap <= 0 ? 0 : min(n_q, (gap + kBlockQ - 1) / kBlockQ);
}

// ---- launch 1: the lse and delta rows, dO split ----

struct PrepParams {
  const float* lse;    // (bh, t_q) contiguous
  const float* delta;  // (bh, t_q) contiguous
  float* rows;         // (bh, n_q, kRowsPerTile)
  const float* dout;   // (bh, t_q, d) f32 with d contiguous, or null
  void* hi;            // (bh, t_q, d) contiguous T, when dout is given
  void* lo;
  long long o_sr, o_st;
  int bh, tq, d, n_q;
};

// Block (query tile, row).
template <typename T>
__global__ void __launch_bounds__(kPrepThreads)
    bwd_step_prep_kernel(const PrepParams p) {
  if (grid_row() >= p.bh) return;
  const int qi = blockIdx.x;
  const long long row = grid_row();
  const int q0 = qi * kBlockQ;
  if (threadIdx.x < kBlockQ) {
    const int r = q0 + threadIdx.x;
    float* const tile = p.rows + (row * p.n_q + qi) * kRowsPerTile;
    tile[threadIdx.x] = r < p.tq ? p.lse[row * p.tq + r] : INFINITY;
    tile[kBlockQ + threadIdx.x] = r < p.tq ? p.delta[row * p.tq + r] : 0.f;
  }
  if (p.dout == nullptr) return;
  const int rows = min(kBlockQ, p.tq - q0);
  const float* const src = p.dout + row * p.o_sr + q0 * p.o_st;
  const long long dst = (row * p.tq + q0) * p.d;
  for (int i = threadIdx.x; i < rows * p.d / 2; i += kPrepThreads) {
    const int r = 2 * i / p.d;
    const int c = 2 * i % p.d;
    const float2 x = *reinterpret_cast<const float2*>(src + r * p.o_st + c);
    uint32_t hi, lo;
    split2<T>(x.x, x.y, &hi, &lo);
    *reinterpret_cast<uint32_t*>(static_cast<T*>(p.hi) + dst + 2 * i) = hi;
    *reinterpret_cast<uint32_t*>(static_cast<T*>(p.lo) + dst + 2 * i) = lo;
  }
}

// ---- launch 2, bf16 and f16: wgmma on TMA-staged tiles ----

// Stages of the q/dO ring: two query tiles in flight; one at d = 256.
template <int D>
constexpr int kStages = D > 128 ? 1 : 2;
// Blocks per SM the registers are held to: two at d = 64, one at d = 128
// and 256 (dK and dV alone take 128 registers there).
template <int D>
constexpr int kMinBlocks = D == 64 ? 2 : 1;
template <int D>
constexpr int kTile = D / 64 * kSlab;  // bytes of a 64-row 16-bit tile
// One stage: the q tile, the dO tile (and dO_lo's), and their lse and
// delta rows (512 bytes, padded to keep the next tile 1024-byte aligned).
template <int D, bool kLo>
constexpr int kStageBytes = (kLo ? 3 : 2) * kTile<D> + 1024;
// Shared memory of a launch: k, v, the stages, ds^T (64 x 64), the dQ
// staging (64 x kCols f32 as kCols / 32 boxes of 32 columns), the
// mbarriers and the swizzle's 1024-byte alignment.
template <int D, bool kLo>
constexpr int kSmem = 2 * kTile<D> + kStages<D> * kStageBytes<D, kLo> +
                      kSlab + kCols<D> / 32 * kSlab +
                      8 * (1 + 2 * kStages<D>) + 1024;

struct TmaParams {
  // q, dO_hi, dO_lo (bh, t_q, d) and k, v (bh / group, t_kv, d) as
  // {d, t, rows} maps, box {64, 64, 1}; dq (bh, t_q, d) f32 as
  // {d, t_q, bh}, box {32, 64, 1}; all 128-byte swizzled.
  CUtensorMap q;
  CUtensorMap k;
  CUtensorMap v;
  CUtensorMap dout;
  CUtensorMap dout_lo;
  CUtensorMap dq;
  const float* rows;  // (bh, n_q, kRowsPerTile): lse, delta
  const int* q_off;   // (bh,)
  const int* k_off;
  float* dk;  // (bh / hpb, t_kv, d) contiguous f32
  float* dv;
  int hpb, group, tq, tkv, n_q;
  int causal, accumulate;
  float scale;   // 1 / sqrt(d), rounded to T
  float dq_mul;  // what dQ is multiplied by before it is added: 1 or dq_scale
};

__device__ __forceinline__ void consumers_sync() { named_sync<kThreads>(1); }

// Byte offset of (row, 16-byte chunk) in a 128-byte-swizzled tile of
// 128-byte rows.
__device__ __forceinline__ int swizzled(int row, int chunk) {
  return row * 128 + ((chunk ^ (row % 8)) << 4);
}

// The block's dK or dV columns [col0, col0 + 64 kOut) (f32 accumulators)
// into its output rows of D columns: stored, or added to what the carrier
// holds.
template <int D, int kOut>
__device__ __forceinline__ void store_tile(float* out, const float (*acc)[32],
                                           int k0, int tkv, bool add,
                                           int col0) {
  const int c2 = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + acc_row(i);
    if (key >= tkv) continue;
#pragma unroll
    for (int c = 0; c < kOut; ++c) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float2* const at = reinterpret_cast<float2*>(
            out + static_cast<long long>(key) * D + col0 + c * 64 + j * 8 +
            c2);
        float2 x =
            make_float2(acc[c][4 * j + 2 * i], acc[c][4 * j + 2 * i + 1]);
        if (add) {
          const float2 o = *at;
          x = make_float2(o.x + x.x, o.y + x.y);
        }
        *at = x;
      }
    }
  }
}

template <int D, bool kLo, typename T>
__global__ void __launch_bounds__(kTmaThreads, kMinBlocks<D>)
    bwd_step_wgmma_kernel(const __grid_constant__ TmaParams p) {
  constexpr int kSlabs = D / 64;         // slabs per q, k, v, dO tile
  constexpr int kOut = kCols<D> / 64;    // slabs of the block's columns
  constexpr int kHalves = D / kCols<D>;  // blocks per (row, key tile)
  constexpr int kT = kTile<D>;
  constexpr int kSt = kStages<D>;
  constexpr int kOps = kLo ? 3 : 2;  // tiles per stage: q, dO (, dO_lo)
  constexpr int kSB = kStageBytes<D, kLo>;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* const ks = aligned_smem(smem_raw);
  uint8_t* const vs = ks + kT;
  uint8_t* const stages = vs + kT;  // q, dO (, dO_lo), rows of stage s
  uint8_t* const dst_s = stages + kSt * kSB;  // ds^T, T
  uint8_t* const dq_s = dst_s + kSlab;        // dQ, f32
  uint64_t* const kv_full =
      reinterpret_cast<uint64_t*>(dq_s + kCols<D> / 32 * kSlab);
  uint64_t* const full = kv_full + 1;
  uint64_t* const empty = full + kSt;

  const int r = blockIdx.x / kHalves;  // output row: query heads r hpb + j
  const int c0 = blockIdx.x % kHalves * kOut;  // the block's first slab
  const int kb = blockIdx.y;
  const int k0 = kb * kBlockK;
  const int kv_row = r * p.hpb / p.group;
  int tiles = 0;
  for (int j = 0; j < p.hpb; ++j) {
    tiles += p.n_q - first_tile(p.q_off, p.k_off, r * p.hpb + j, k0, p.n_q,
                                p.causal);
  }
  float* const dkg = p.dk + static_cast<long long>(r) * p.tkv * D;
  float* const dvg = p.dv + static_cast<long long>(r) * p.tkv * D;

  if (tiles == 0) {
    // A key tile that no local query sees: nothing to add; the fresh form
    // writes its zeros.
    if (!p.accumulate && threadIdx.x < kThreads) {
      float zero[kOut][32] = {};
      store_tile<D, kOut>(dkg, zero, k0, p.tkv, false, c0 * 64);
      store_tile<D, kOut>(dvg, zero, k0, p.tkv, false, c0 * 64);
    }
    return;
  }

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
      if constexpr (kLo) prefetch_map(&p.dout_lo);
      mbar_expect(kv_full, 2 * kT);
#pragma unroll
      for (int c = 0; c < kSlabs; ++c) {
        tma_load_3d(ks + c * kSlab, &p.k, kv_full, c * 64, k0, kv_row);
        tma_load_3d(vs + c * kSlab, &p.v, kv_full, c * 64, k0, kv_row);
      }
      int it = 0;
      for (int j = 0; j < p.hpb; ++j) {
        const int row = r * p.hpb + j;
        for (int qi = first_tile(p.q_off, p.k_off, row, k0, p.n_q, p.causal);
             qi < p.n_q; ++qi, ++it) {
          const int s = it % kSt;
          const int q0 = qi * kBlockQ;
          uint8_t* const st = stages + s * kSB;
          if (it >= kSt) mbar_wait(empty + s, (it / kSt - 1) & 1);
          mbar_expect(full + s, kOps * kT + kRowsPerTile * 4);
#pragma unroll
          for (int c = 0; c < kSlabs; ++c) {
            tma_load_3d(st + c * kSlab, &p.q, full + s, c * 64, q0, row);
            tma_load_3d(st + kT + c * kSlab, &p.dout, full + s, c * 64, q0,
                        row);
            if constexpr (kLo) {
              tma_load_3d(st + 2 * kT + c * kSlab, &p.dout_lo, full + s,
                          c * 64, q0, row);
            }
          }
          bulk_load(st + kOps * kT,
                    p.rows + (static_cast<long long>(row) * p.n_q + qi) *
                                 kRowsPerTile,
                    kRowsPerTile * 4, full + s);
        }
      }
    }
    return;
  }

  const int lane = threadIdx.x % 32;
  const int c2 = 2 * (lane % 4);
  const int r0 = acc_row(0);  // this thread's tile rows (keys): r0, r0 + 8
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
  int it = 0;
  for (int j = 0; j < p.hpb; ++j) {
    const int row = r * p.hpb + j;
    const int qo = p.q_off[row];
    const int ko = p.k_off[row];
    for (int qi = first_tile(p.q_off, p.k_off, row, k0, p.n_q, p.causal);
         qi < p.n_q; ++qi, ++it) {
      const int s = it % kSt;
      const int q0 = qi * kBlockQ;
      uint8_t* const qs = stages + s * kSB;
      const float* const rows =
          reinterpret_cast<const float*>(qs + kOps * kT);
      const uint32_t q_addr = smem_addr(qs);
      const uint32_t o_addr = q_addr + kT;
      const uint32_t lo_addr = o_addr + kT;  // dO_lo, with kLo

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
        if constexpr (kLo) {
          wgmma_bf16<0, 0, T>(dp, desc(v_addr + off), desc(lo_addr + off));
        }
      }
      wgmma_commit();
      wgmma_wait<0>(sc);
      fence_acc(dp);

      // p^T = exp(s^T - lse), ds^T = p^T (dp^T - delta). Only tiles that
      // cross the global diagonal or the ragged end of the keys pay the
      // mask; queries past t_q have lse = +inf.
      const bool masked = (p.causal && ko + k0 + kBlockK - 1 > qo + q0) ||
                          k0 + kBlockK > p.tkv;
#pragma unroll
      for (int x8 = 0; x8 < 8; ++x8) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = x8 * 8 + c2 + e;
          const float lse = rows[col];
          const float delta = rows[kBlockQ + col];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int x = 4 * x8 + 2 * i + e;
            const int key = k0 + r0 + 8 * i;
            float pe = fast_exp(sc[x] - lse);
            if (masked &&
                (key >= p.tkv || (p.causal && ko + key > qo + q0 + col))) {
              pe = 0.f;
            }
            sc[x] = pe;
            dp[x] = pe * (dp[x] - delta);
          }
        }
      }
      // p^T as T hi and lo halves and ds^T in T, as the A fragments of the
      // four 16-query steps.
      uint32_t ph[4][4];
      uint32_t pl[4][4];
      uint32_t da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          split2<T>(sc[8 * kk + 2 * f], sc[8 * kk + 2 * f + 1], &ph[kk][f],
                    &pl[kk][f]);
          da[kk][f] = pack2<T>(dp[8 * kk + 2 * f], dp[8 * kk + 2 * f + 1]);
        }
      }

      // dV += p^T dO as p_hi dO_hi + p_lo dO_hi (+ p_hi dO_lo), and
      // dK += ds^T (q * scale), over the block's columns; dO and q
      // MN-major.
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
          const uint32_t off = (c0 + c) * kSlab + kk * 2048;
          wgmma_bf16_rs<1, T>(dv[c], ph[kk], desc(o_addr + off));
          wgmma_bf16_rs<1, T>(dv[c], pl[kk], desc(o_addr + off));
          if constexpr (kLo) {
            wgmma_bf16_rs<1, T>(dv[c], ph[kk], desc(lo_addr + off));
          }
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
          const int line = r0 + 8 * (f % 2);
          *reinterpret_cast<uint32_t*>(
              dst_s + swizzled(line, 2 * kk + f / 2) + 2 * c2) = da[kk][f];
        }
      }
      wgmma_wait<0>(dv[0]);
#pragma unroll
      for (int c = 0; c < kOut; ++c) {
        fence_acc(dv[c]);
        fence_acc(dk[c]);
      }
      fence_regs<16>(&ph[0][0]);
      fence_regs<16>(&pl[0][0]);
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
        for (int x8 = 0; x8 < 8; ++x8) {
          uint8_t* const box = dq_s + (2 * c + x8 / 4) * kSlab;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            // Column 8 x8 + c2 of the slab: chunk 2 (x8 % 4) + c2 / 4 of
            // its box's 128-byte row, at byte (c2 % 4) * 4 of that chunk.
            const int line = r0 + 8 * i;
            *reinterpret_cast<float2*>(
                box + swizzled(line, 2 * (x8 % 4) + c2 / 4) + c2 % 4 * 4) =
                make_float2(dq[4 * x8 + 2 * i] * p.dq_mul,
                            dq[4 * x8 + 2 * i + 1] * p.dq_mul);
          }
        }
      }
      fence_proxy_async_shared();
      consumers_sync();
      if (threadIdx.x == 0) {
#pragma unroll
        for (int x = 0; x < kCols<D> / 32; ++x) {
          tma_reduce_add_3d(&p.dq, dq_s + x * kSlab, c0 * 64 + x * 32, q0,
                            row);
        }
        bulk_commit();
      }
    }
  }
  if (threadIdx.x == 0) bulk_wait();  // the last reduce-adds have landed

  store_tile<D, kOut>(dkg, dk, k0, p.tkv, p.accumulate, c0 * 64);
  store_tile<D, kOut>(dvg, dv, k0, p.tkv, p.accumulate, c0 * 64);
}

// ---- launch 2, f32: the FMA design ----

// Warps of an f32 block, and so its query rows (dq_step_kernel) or keys
// (dkv_step_kernel), 16 per warp: 4 up to d = 128, 2 at d = 256.
template <int D>
constexpr int kF32Warps = D > 128 ? 2 : 4;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;   // (bh, t_q, d) f32
  const float* lse;    // (bh, t_q) contiguous
  const float* delta;  // (bh, t_q) contiguous
  const int* q_off;    // (bh,)
  const int* k_off;    // (bh,)
  float* dq;           // (bh, t_q, d) contiguous
  float* dk;           // (bh / hpb, t_kv, d) contiguous
  float* dv;
  int bh;  // query-head rows
  int hpb, group, tq, tkv;
  int causal, accumulate;
  float scale;     // 1 / sqrt(d)
  float dq_scale;  // 1 / sqrt(d) in f32
  long long q_sr, q_st;  // strides in elements; d is contiguous
  long long k_sr, k_st;
  long long v_sr, v_st;
  long long o_sr, o_st;
};

// Whether (key, query) at tile-local positions is masked: past a ragged
// end, or (causal) the key's global position past the query's.
__device__ __forceinline__ bool masked_pair(const Params& p, int key,
                                            int query, int ko, int qo) {
  return key >= p.tkv || query >= p.tq ||
         (p.causal && ko + key > qo + query);
}

// Loads lse and delta of the tile's kRows rows (0 past t_q).
template <int kRows, int kCount>
__device__ __forceinline__ void load_rows(const Params& p, int row, int q0,
                                          float* lse_s, float* delta_s) {
  for (int i = threadIdx.x; i < kRows; i += kCount) {
    const int r = q0 + i;
    const long long at = static_cast<long long>(row) * p.tq + r;
    lse_s[i] = r < p.tq ? p.lse[at] : 0.f;
    delta_s[i] = r < p.tq ? p.delta[at] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(32 * kF32Warps<D>)
    dq_step_kernel(const Params p) {
  using T = float;
  constexpr int kNThreads = 32 * kF32Warps<D>;
  constexpr int kRowsQ = 16 * kF32Warps<D>;  // query rows per block
  constexpr int kLd = D + 4;             // q, k, v, dO rows
  constexpr int kLdS = kBlockK + 4;      // ds rows [query][key]
  constexpr int kNT = kBlockK / 8;
  constexpr int kDT = D / 8;

  const int row = grid_row();
  if (row >= p.bh) return;

  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);  // q * scale
  T* ks = qs + kRowsQ * kLd;
  T* vs = ks + kBlockK * kLd;
  T* dss = vs + kBlockK * kLd;
  float* dos = dss + kRowsQ * kLdS;
  float* lse_s = dos + kRowsQ * kLd;
  float* delta_s = lse_s + kRowsQ;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRowsQ;
  const int qo = p.q_off[row];
  const int ko = p.k_off[row];
  const T* kg = p.k + (row / p.group) * p.k_sr;
  const T* vg = p.v + (row / p.group) * p.v_sr;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int c2 = 2 * (lane % 4);
  const int r0 = warp * 16 + g;  // this lane's tile rows: r0 and r0 + 8

  const int n_kv = (p.tkv + kBlockK - 1) / kBlockK;
  int kv_end = n_kv;
  if (p.causal) {
    const int reach = qo + q0 + kRowsQ - 1 - ko;
    kv_end = reach < 0 ? 0 : min(n_kv, reach / kBlockK + 1);
  }

  float dq[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j) {
    dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
  }

  if (kv_end > 0) {
    load_tile<T, D, kLd, kRowsQ, kNThreads, true>(
        qs, p.q + row * p.q_sr, p.q_st, q0, p.tq, p.scale);
    load_tile<float, D, kLd, kRowsQ, kNThreads, false>(
        dos, p.dout + row * p.o_sr, p.o_st, q0, p.tq, 1.f);
    load_rows<kRowsQ, kNThreads>(p, row, q0, lse_s, delta_s);
  }

  for (int kb = 0; kb < kv_end; ++kb) {
    const int k0 = kb * kBlockK;
    __syncthreads();  // every warp is done with the previous k/v tile
    load_tile<T, D, kLd, kBlockK, kNThreads, false>(ks, kg, p.k_st, k0,
                                                    p.tkv, 1.f);
    load_tile<T, D, kLd, kBlockK, kNThreads, false>(vs, vg, p.v_st, k0,
                                                    p.tkv, 1.f);
    __syncthreads();

    float s[kNT][4];
    float dp[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
    // s = (q * scale) k^T; dp = dO v^T in f32.
    warp_fma<D, kNT, kLd, 1, 1, kLd>(s, qs + warp * 16 * kLd, ks);
    warp_fma<D, kNT, kLd, 1, 1, kLd>(dp, dos + warp * 16 * kLd, vs);

    const bool masked = (p.causal && ko + k0 + kBlockK - 1 > qo + q0) ||
                        k0 + kBlockK > p.tkv || q0 + kRowsQ > p.tq;
    T* dsw = dss + warp * 16 * kLdS;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + (e >= 2 ? 8 : 0);
        float pe = expf(s[j][e] - lse_s[r]);
        if (masked && masked_pair(p, k0 + j * 8 + c2 + (e & 1), q0 + r, ko,
                                  qo)) {
          pe = 0.f;
        }
        ds[e] = pe * (dp[j][e] - delta_s[r]);
      }
      store2(dsw + g * kLdS + j * 8 + c2, ds[0], ds[1]);
      store2(dsw + (g + 8) * kLdS + j * 8 + c2, ds[2], ds[3]);
    }
    __syncwarp();  // the warp's ds rows are written
    // dq += ds k.
    warp_fma<kBlockK, kDT, kLdS, 1, kLd, 1>(dq, dsw, ks);
  }

  // Fresh: dq = acc * dq_scale. Accumulating: the caller's unscaled f32
  // dQ += acc (this block owns its rows).
  float* dqg = p.dq + static_cast<long long>(row) * p.tq * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + r0 + 8 * i;
    if (r >= p.tq) continue;
#pragma unroll
    for (int j = 0; j < kDT; ++j) {
      float* const at = dqg + static_cast<long long>(r) * D + j * 8 + c2;
      if (p.accumulate) {
        store2(at, at[0] + dq[j][2 * i], at[1] + dq[j][2 * i + 1]);
      } else {
        store2(at, dq[j][2 * i] * p.dq_scale, dq[j][2 * i + 1] * p.dq_scale);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(32 * kF32Warps<D>)
    dkv_step_kernel(const Params p) {
  using T = float;
  constexpr int kWarps = kF32Warps<D>;
  constexpr int kNThreads = 32 * kWarps;
  constexpr int kKeys = 16 * kWarps;  // keys per block
  constexpr int kHalves = D / kCols<D>;
  constexpr int kLd = D + 4;         // k, v, q, dO rows
  constexpr int kLdP = kBlockQ + 4;  // p^T and ds^T [key][query]
  constexpr int kDT = kCols<D> / 8;  // 8-column slices of dK, dV
  constexpr int kCT = kChunk / 8;

  const int r = grid_row();  // output row: query heads r * hpb + j
  if (r >= p.bh / p.hpb) return;

  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + kKeys * kLd;
  T* qs = vs + kKeys * kLd;  // q * scale
  T* dsts = qs + kBlockQ * kLd;
  float* dos = dsts + kKeys * kLdP;
  float* pts = dos + kBlockQ * kLd;
  float* lse_s = pts + kKeys * kLdP;
  float* delta_s = lse_s + kBlockQ;

  const int k0 = blockIdx.x / kHalves * kKeys;
  const int col0 = blockIdx.x % kHalves * kCols<D>;  // the block's columns
  const int kv_row = r * p.hpb / p.group;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int c2 = 2 * (lane % 4);
  const int kr = warp * 16 + g;  // this lane's key rows: kr and kr + 8

  load_tile<T, D, kLd, kKeys, kNThreads, false>(
      ks, p.k + kv_row * p.k_sr, p.k_st, k0, p.tkv, 1.f);
  load_tile<T, D, kLd, kKeys, kNThreads, false>(
      vs, p.v + kv_row * p.v_sr, p.v_st, k0, p.tkv, 1.f);

  float dk[kDT][4];
  float dv[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  }

  const int n_q = (p.tq + kBlockQ - 1) / kBlockQ;
  float* ptw = pts + warp * 16 * kLdP;
  T* dstw = dsts + warp * 16 * kLdP;
  for (int h = 0; h < p.hpb; ++h) {
    const int row = r * p.hpb + h;
    const int qo = p.q_off[row];
    const int ko = p.k_off[row];
    const T* qg = p.q + row * p.q_sr;
    const float* og = p.dout + row * p.o_sr;
    for (int qi = first_tile(p.q_off, p.k_off, row, k0, n_q, p.causal);
         qi < n_q; ++qi) {
      const int q0 = qi * kBlockQ;
      __syncthreads();  // every warp is done with the previous query tile
      load_tile<T, D, kLd, kBlockQ, kNThreads, true>(qs, qg, p.q_st, q0,
                                                     p.tq, p.scale);
      load_tile<float, D, kLd, kBlockQ, kNThreads, false>(dos, og, p.o_st,
                                                          q0, p.tq, 1.f);
      load_rows<kBlockQ, kNThreads>(p, row, q0, lse_s, delta_s);
      __syncthreads();

      const bool masked = (p.causal && ko + k0 + kKeys - 1 > qo + q0) ||
                          k0 + kKeys > p.tkv || q0 + kBlockQ > p.tq;
#pragma unroll
      for (int n0 = 0; n0 < kBlockQ; n0 += kChunk) {
        float s[kCT][4];
        float dp[kCT][4];
#pragma unroll
        for (int j = 0; j < kCT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
        }
        // s^T = k (q * scale)^T; dp^T = v dO^T in f32.
        warp_fma<D, kCT, kLd, 1, 1, kLd>(s, ks + warp * 16 * kLd,
                                         qs + n0 * kLd);
        warp_fma<D, kCT, kLd, 1, 1, kLd>(dp, vs + warp * 16 * kLd,
                                         dos + n0 * kLd);
#pragma unroll
        for (int j = 0; j < kCT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = n0 + j * 8 + c2 + (e & 1);  // query in the tile
            float pe = expf(s[j][e] - lse_s[col]);
            if (masked && masked_pair(p, k0 + kr + (e >= 2 ? 8 : 0),
                                      q0 + col, ko, qo)) {
              pe = 0.f;
            }
            s[j][e] = pe;
            dp[j][e] = pe * (dp[j][e] - delta_s[col]);
          }
          const int col = n0 + j * 8 + c2;
          store2(ptw + g * kLdP + col, s[j][0], s[j][1]);
          store2(ptw + (g + 8) * kLdP + col, s[j][2], s[j][3]);
          store2(dstw + g * kLdP + col, dp[j][0], dp[j][1]);
          store2(dstw + (g + 8) * kLdP + col, dp[j][2], dp[j][3]);
        }
      }
      __syncwarp();  // the warp's own p^T and ds^T rows are written

      // dV += p^T dO; dK += ds^T (q * scale), in the block's columns.
      warp_fma<kBlockQ, kDT, kLdP, 1, kLd, 1>(dv, ptw, dos + col0);
      warp_fma<kBlockQ, kDT, kLdP, 1, kLd, 1>(dk, dstw, qs + col0);
    }
  }

  const long long base = static_cast<long long>(r) * p.tkv * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + kr + 8 * i;
    if (key >= p.tkv) continue;
#pragma unroll
    for (int j = 0; j < kDT; ++j) {
      const long long off = base + static_cast<long long>(key) * D + col0 +
                            j * 8 + c2;
      if (p.accumulate) {
        store2(p.dk + off, p.dk[off] + dk[j][2 * i],
               p.dk[off + 1] + dk[j][2 * i + 1]);
        store2(p.dv + off, p.dv[off] + dv[j][2 * i],
               p.dv[off + 1] + dv[j][2 * i + 1]);
      } else {
        store2(p.dk + off, dk[j][2 * i], dk[j][2 * i + 1]);
        store2(p.dv + off, dv[j][2 * i], dv[j][2 * i + 1]);
      }
    }
  }
}

// ---- launch 2, d past 256: flash_wide.cuh's backward ----

template <typename T>
__global__ void __launch_bounds__(wide::kThreads, 1)
    bwd_step_wide_kernel(const wide::BwdParams p) {
  wide::bwd<T, float>(p);
}

template <typename T>
cudaError_t launch_wide(const wide::BwdParams& p, cudaStream_t stream) {
  static std::atomic<bool> smem_set[kMaxDevices];
  return wide::launch_bwd(bwd_step_wide_kernel<T>, p, stream, smem_set);
}

// ---- launch 3: dq = dq_acc * scale in the input type ----

template <typename T>
__global__ void bwd_step_dq_kernel(const float* acc, T* dq, long long pairs,
                                   float scale) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < pairs; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const float2 x = reinterpret_cast<const float2*>(acc)[i];
    store2(dq + 2 * i, x.x * scale, x.y * scale);
  }
}

// ---- launchers ----

template <int D>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  constexpr int kRows = 16 * kF32Warps<D>;  // query rows or keys per block
  constexpr int kLd = D + 4;
  // d = 256: 204 KB and 213 KB.
  constexpr size_t kDqSmem =
      ((kRows + 2 * kBlockK) * kLd + kRows * (kBlockK + 4) + kRows * kLd +
       2 * kRows) * sizeof(float);
  constexpr size_t kDkvSmem =
      ((2 * kRows + kBlockQ) * kLd + 2 * kRows * (kBlockQ + 4) +
       kBlockQ * kLd + 2 * kBlockQ) * sizeof(float);
  static std::atomic<bool> dq_set[kMaxDevices];
  static std::atomic<bool> dkv_set[kMaxDevices];
  cudaError_t err = allow_dynamic_smem(dq_step_kernel<D>, kDqSmem, dq_set);
  if (err != cudaSuccess) return err;
  err = allow_dynamic_smem(dkv_step_kernel<D>, kDkvSmem, dkv_set);
  if (err != cudaSuccess) return err;
  constexpr int kThreadsF = 32 * kF32Warps<D>;
  dq_step_kernel<D><<<rows_grid((p.tq + kRows - 1) / kRows, p.bh),
                      kThreadsF, kDqSmem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv_step_kernel<D><<<rows_grid((p.tkv + kRows - 1) / kRows *
                                     (D / kCols<D>),
                                 p.bh / p.hpb),
                       kThreadsF, kDkvSmem, stream>>>(p);
  return cudaGetLastError();
}

template <int D, bool kLo, typename T>
cudaError_t launch_tma(TmaParams& p, int dtype, const void* q, const void* k,
                       const void* v, const void* dout, const void* dout_lo,
                       float* dq, int rows_out, const long long* st,
                       cudaStream_t stream) {
  const int bh = rows_out * p.hpb;
  const int bh_kv = bh / p.group;
  cudaError_t err =
      encode_rows(&p.q, dtype, q, D, p.tq, bh, st[1], st[0], 64);
  if (err == cudaSuccess) {
    err = encode_rows(&p.k, dtype, k, D, p.tkv, bh_kv, st[3], st[2], 64);
  }
  if (err == cudaSuccess) {
    err = encode_rows(&p.v, dtype, v, D, p.tkv, bh_kv, st[5], st[4], 64);
  }
  if (err == cudaSuccess) {
    err = encode_rows(&p.dout, dtype, dout, D, p.tq, bh, D,
                      static_cast<long long>(p.tq) * D, 64);
  }
  if (err == cudaSuccess && kLo) {
    err = encode_rows(&p.dout_lo, dtype, dout_lo, D, p.tq, bh, D,
                      static_cast<long long>(p.tq) * D, 64);
  }
  if (err == cudaSuccess) {
    err = encode_rows(&p.dq, 1, dq, D, p.tq, bh, D,
                      static_cast<long long>(p.tq) * D, 32);
  }
  if (err != cudaSuccess) return err;
  static std::atomic<bool> smem_set[kMaxDevices];
  err = allow_dynamic_smem(bwd_step_wgmma_kernel<D, kLo, T>, kSmem<D, kLo>,
                           smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(rows_out * (D / kCols<D>), (p.tkv + kBlockK - 1) / kBlockK);
  bwd_step_wgmma_kernel<D, kLo, T>
      <<<grid, kTmaThreads, kSmem<D, kLo>, stream>>>(p);
  return cudaGetLastError();
}

// The instance of head_dim D and type T: kLo where dO_lo is given.
template <int D, typename T>
cudaError_t launch_wgmma(TmaParams& p, int dtype, const void* q,
                         const void* k, const void* v, const void* dout,
                         const void* dout_lo, float* dq, int rows_out,
                         const long long* st, cudaStream_t stream) {
  return dout_lo == nullptr
             ? launch_tma<D, false, T>(p, dtype, q, k, v, dout, dout_lo, dq,
                                       rows_out, st, stream)
             : launch_tma<D, true, T>(p, dtype, q, k, v, dout, dout_lo, dq,
                                      rows_out, st, stream);
}

template <typename T>
cudaError_t launch_wgmma_d(TmaParams& p, int dtype, int d, const void* q,
                           const void* k, const void* v, const void* dout,
                           const void* dout_lo, float* dq, int rows_out,
                           const long long* st, cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch_wgmma<64, T>(p, dtype, q, k, v, dout, dout_lo, dq,
                                 rows_out, st, stream);
    case 128:
      return launch_wgmma<128, T>(p, dtype, q, k, v, dout, dout_lo, dq,
                                  rows_out, st, stream);
    default:
      return launch_wgmma<256, T>(p, dtype, q, k, v, dout, dout_lo, dq,
                                  rows_out, st, stream);
  }
}

}  // namespace

extern "C" {

// Each returns a cudaError_t; 0 is success. Strides in elements, d
// contiguous. dtype: 0 = bf16, 1 = f32, 2 = f16. Any bh below 2^31: past
// 65535 rows the grids spread them over y and z.

// Launch 1: rows (bh, ceil(t_q / 64), 128) f32 from lse and delta (bh, t_q)
// f32; with dout (bh, t_q, d) f32 (16-byte aligned rows), also do_hi and
// do_lo (bh, t_q, d) in dtype (0 or 2) contiguous. d even.
int gtt_flash_bwd_step_prep(const void* lse, const void* delta, void* rows,
                            const void* dout, void* do_hi, void* do_lo,
                            int bh, int tq, int d, int dtype, long long o_sr,
                            long long o_st, void* stream) {
  if (bh < 1 || tq < 1 || d < 2 || d % 2 || (dtype != 0 && dtype != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_q = (tq + kBlockQ - 1) / kBlockQ;
  const PrepParams p{static_cast<const float*>(lse),
                     static_cast<const float*>(delta),
                     static_cast<float*>(rows),
                     static_cast<const float*>(dout),
                     do_hi,
                     do_lo,
                     o_sr,
                     o_st,
                     bh,
                     tq,
                     d,
                     n_q};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    bwd_step_prep_kernel<__nv_bfloat16>
        <<<rows_grid(n_q, bh), kPrepThreads, 0, s>>>(p);
  } else {
    bwd_step_prep_kernel<__half><<<rows_grid(n_q, bh), kPrepThreads, 0, s>>>(
        p);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch 2, one ring step. dtype (of q, k, v): 0 = bf16, 1 = f32, 2 = f16;
// d: 64, 128, 256, or a multiple of 8 above 256 (the wide kernel). A
// block serves hpb query heads (1, or group: then its output row is their
// kv head). 16-bit: dout is dO_hi and dout_lo dO_lo or
// null, both (bh, t_q, d) in q's type contiguous; rows from launch 1; lse
// and delta unused. f32: dout (bh, t_q, d) f32 at o_sr / o_st; lse and
// delta (bh, t_q) f32; rows and dout_lo unused. dq (bh, t_q, d) f32
// contiguous: fresh (accumulate 0) it gets dQ * dq_scale (16-bit: added
// into zeros), else unscaled dQ is added to it. dk, dv (bh / hpb, t_kv, d)
// f32 contiguous: written, or added to. q_off, k_off (bh,) int32: each
// row's global offsets. Every operand 16-byte aligned with strides that
// are multiples of 16 bytes.
int gtt_flash_bwd_step(const void* q, const void* k, const void* v,
                       const void* dout, const void* dout_lo,
                       const void* rows, const void* lse, const void* delta,
                       const void* q_off, const void* k_off, void* dq,
                       void* dk, void* dv, int dtype, int bh, int hpb,
                       int group, int tq, int tkv, int d, int causal,
                       int accumulate, float scale, float dq_scale,
                       long long q_sr, long long q_st, long long k_sr,
                       long long k_st, long long v_sr, long long v_st,
                       long long o_sr, long long o_st, void* stream) {
  if (bh < 1 || group < 1 || bh % group != 0 || (hpb != 1 && hpb != group) ||
      tq < 1 || tkv < 1 ||
      (d != 64 && d != 128 && d != 256 && !wide::takes(d)) || dtype < 0 ||
      dtype > 2 || bh / hpb >= (1 << 30) || tkv > 65535 * kBlockK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows_out = bh / hpb;
  cudaError_t err;
  if (wide::takes(d)) {
    wide::BwdParams p{};
    p.q = q;
    p.k = k;
    p.v = v;
    p.dout = dout;
    p.dout_lo = dtype == 1 ? nullptr : dout_lo;
    p.rows = dtype == 1 ? nullptr : static_cast<const float*>(rows);
    p.lse = static_cast<const float*>(lse);
    p.delta = static_cast<const float*>(delta);
    p.q_off = static_cast<const int*>(q_off);
    p.k_off = static_cast<const int*>(k_off);
    p.dq = static_cast<float*>(dq);
    p.dk = dk;
    p.dv = dv;
    p.out_rows = rows_out;
    p.hpb = hpb;
    p.h = bh;
    p.h_kv = bh / group;
    p.group = group;
    p.tq = tq;
    p.tkv = tkv;
    p.d = d;
    p.n_q = (tq + kBlockQ - 1) / kBlockQ;
    p.causal = causal;
    p.accumulate = accumulate;
    p.scale = scale;
    p.dq_mul = accumulate ? 1.f : dq_scale;
    p.q_sh = q_sr;
    p.q_st = q_st;
    p.k_sh = k_sr;
    p.k_st = k_st;
    p.v_sh = v_sr;
    p.v_st = v_st;
    p.o_sh = o_sr;
    p.o_st = o_st;
    err = dtype == 0   ? launch_wide<__nv_bfloat16>(p, s)
          : dtype == 2 ? launch_wide<__half>(p, s)
                       : launch_wide<float>(p, s);
  } else if (dtype != 1) {
    TmaParams p;
    memset(&p, 0, sizeof(p));
    p.rows = static_cast<const float*>(rows);
    p.q_off = static_cast<const int*>(q_off);
    p.k_off = static_cast<const int*>(k_off);
    p.dk = static_cast<float*>(dk);
    p.dv = static_cast<float*>(dv);
    p.hpb = hpb;
    p.group = group;
    p.tq = tq;
    p.tkv = tkv;
    p.n_q = (tq + kBlockQ - 1) / kBlockQ;
    p.causal = causal;
    p.accumulate = accumulate;
    p.scale = scale;
    p.dq_mul = accumulate ? 1.f : dq_scale;
    const long long st[6] = {q_sr, q_st, k_sr, k_st, v_sr, v_st};
    float* acc = static_cast<float*>(dq);
    err = dtype == 0
              ? launch_wgmma_d<__nv_bfloat16>(p, dtype, d, q, k, v, dout,
                                              dout_lo, acc, rows_out, st, s)
              : launch_wgmma_d<__half>(p, dtype, d, q, k, v, dout, dout_lo,
                                       acc, rows_out, st, s);
  } else {
    Params p{};
    p.q = static_cast<const float*>(q);
    p.k = static_cast<const float*>(k);
    p.v = static_cast<const float*>(v);
    p.dout = static_cast<const float*>(dout);
    p.lse = static_cast<const float*>(lse);
    p.delta = static_cast<const float*>(delta);
    p.q_off = static_cast<const int*>(q_off);
    p.k_off = static_cast<const int*>(k_off);
    p.dq = static_cast<float*>(dq);
    p.dk = static_cast<float*>(dk);
    p.dv = static_cast<float*>(dv);
    p.bh = bh;
    p.hpb = hpb;
    p.group = group;
    p.tq = tq;
    p.tkv = tkv;
    p.causal = causal;
    p.accumulate = accumulate;
    p.scale = scale;
    p.dq_scale = dq_scale;
    p.q_sr = q_sr;
    p.q_st = q_st;
    p.k_sr = k_sr;
    p.k_st = k_st;
    p.v_sr = v_sr;
    p.v_st = v_st;
    p.o_sr = o_sr;
    p.o_st = o_st;
    err = d == 64    ? launch_f32<64>(p, s)
          : d == 128 ? launch_f32<128>(p, s)
                     : launch_f32<256>(p, s);
  }
  return static_cast<int>(err);
}

// Launch 3: dq (elems, in the input type: 0 = bf16, 1 = f32, 2 = f16) =
// acc * scale; elems even.
int gtt_flash_bwd_step_dq(const void* acc, void* dq, int dtype, float scale,
                          long long elems, void* stream) {
  if (elems < 2 || elems % 2 || dtype < 0 || dtype > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long pairs = elems / 2;
  const int blocks = static_cast<int>(
      pairs / 256 + 1 < 4096 ? pairs / 256 + 1 : 4096);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(acc);
  if (dtype == 0) {
    bwd_step_dq_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(
        a, static_cast<__nv_bfloat16*>(dq), pairs, scale);
  } else if (dtype == 2) {
    bwd_step_dq_kernel<__half><<<blocks, 256, 0, s>>>(
        a, static_cast<__half*>(dq), pairs, scale);
  } else {
    bwd_step_dq_kernel<float><<<blocks, 256, 0, s>>>(
        a, static_cast<float*>(dq), pairs, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* gtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
