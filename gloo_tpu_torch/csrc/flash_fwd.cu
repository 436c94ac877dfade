// Flash-attention forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces gloo_tpu/ops/attention.py::_flash_kernel, the Pallas TPU kernel
// behind flash_attention: attention over (b, h, t, d) without the (t, t)
// score matrix, online softmax with f32 state, and the logsumexp rows.
//
// What bounds it on an H100: at the flagship forward's shape (b*h = 32,
// t = 128, d = 64, causal, bf16) q, k, v and out are 2.1 MB and the two
// products over the (q, k) pairs the mask keeps are 68 MFLOP, so the bytes
// bound it (~0.63 us at 3.35 TB/s against ~0.07 us of tensor-core time),
// and above both lies the launch itself; at long sequences (the Ulysses
// path's b*h = 8, t = 4096, d = 64, causal: 17 GFLOP against 17 MB) the
// tensor cores do (~0.017 ms). The design keeps every load in flight ahead
// of the products and runs the products on wgmma:
//
// bf16 and f16 (the model's types; one template, T): one block per (flat query
// head, 64-row query tile), highest query tiles first (under the causal mask
// they are the longest), of one consumer warpgroup (128 threads, 16 query rows
// per warp) and one producer warp. The producer's lane 0 issues TMA loads of
// 128-byte-swizzled 64 x 64 slabs (hopper.cuh): the q tile once, then the k
// and v tiles of 64 keys into a ring of kStages<D> stages, each with a full
// mbarrier for k, one for v and an empty one the consumers arrive on; a stage
// is refilled only once its empty barrier shows the consumers are done with
// it. At the flagship's t = 128 every load of a block is in flight before the
// first product. The consumers scale q once in shared memory (q * scale
// rounded to T, then fence.proxy.async and a named barrier so that wgmma reads
// the scaled values), then per key tile:
//   - s = q k^T: wgmma m64n64k16 with both operands in shared memory, k
//     K-major (d / 16 k-steps, a slab per 64 of d), f32 accumulators;
//   - the mask, only on tiles that cross the diagonal or the ragged end
//     (TMA fills rows past t with zeros; they still need -inf), and the
//     online softmax in the accumulator layout (a row's 64 scores lie in
//     the 4 lanes of a quad: two xor shuffles finish its max and sum);
//   - o += p v: wgmma with A = p from registers (the accumulator of two
//     8-key slices is the A fragment of one 16-key step) and B = v
//     MN-major from shared memory, one n64 product per 64 columns of d.
// Key tiles above the causal diagonal are never loaded. k and v are read
// through the kv head hq / group (GQA): never replicated. At d = 256 (the
// largest instance; 136-248 are zero-padded to it) a tile is 4 slabs of 32
// KB and o takes 128 of a consumer's registers, beside 32 for s: one pass
// over the columns still fits (PERF.md has ptxas's count), one block per
// SM at 161 KB of shared memory.
//
// Rows (b * h) past the grid's 65535 go on grid z (rows_grid in
// flash_common.cuh): a launch of at most 65535 rows is the launch it was.
//
// f32 (off the model's path) keeps the FMA design: one block of 4 warps
// per (flat query head, 64-row query tile), 16-byte loads of the tiles
// into padded shared memory, the products on the FMA units in the
// m16n8 accumulator layout of mma.sync (flash_common.cuh).
//
// d past 256 (any multiple of 8; the wrapper zero-pads the rest), in every
// type: flash_fwd_wide_kernel, flash_wide.cuh's forward with its column
// parts on the grid beside the query tiles.
//
// Numerics follow the TPU kernel step by step: q * scale rounded to the
// input type before QK^T (the wrapper passes scale already rounded to that
// type), scores accumulated in f32 over key tiles of 64 (BLOCK_K, so the
// running maxima, and p's rounding with them, are the plain twin's and
// JAX's), masked scores -inf with the m_safe / corr guards, p rounded to
// v's type before PV, out = acc / max(l, 1e-30) in the input type, lse =
// m + log(max(l, 1e-30)) in f32. The 16-bit kernel takes e^x from the
// SFU's 2^x (fast_exp), the f32 kernel from expf.

#include "flash_common.cuh"
#include "flash_wide.cuh"
#include "hopper.cuh"

#include <atomic>
#include <cmath>
#include <cstring>

namespace {

using namespace gtt;

constexpr int kBlockQ = 64;  // query rows per block
constexpr int kBlockK = 64;  // keys per kv tile
constexpr int kThreads = 128;  // f32: 4 warps; 16-bit: the consumers
constexpr int kTmaThreads = kThreads + 32;  // 16-bit: + the producer warp
constexpr int kSlab = 64 * 128;    // one swizzled slab: 64 lines x 128 bytes
constexpr int kPLd = kBlockK + 4;  // row stride of the f32 path's p tile

// ---- bf16 and f16: wgmma on TMA-staged tiles ----

// k/v stages of the ring by head_dim: every load of a block at the
// flagship's t = 128 (two key tiles) in flight before the first product.
// Three at d = 64 (58 KB, three blocks per SM), two at d = 128 (83 KB, two
// per SM; three, at 116 KB, would leave one block per SM) and at d = 256
// (161 KB, one per SM).
template <int D>
constexpr int kStages = D == 64 ? 3 : 2;

// Shared memory of a 16-bit launch: the q tile and kStages<D> k and v tiles,
// their mbarriers and the swizzle's 1024-byte alignment.
template <int D>
constexpr int kTmaSmem =
    D / 64 * kSlab * (1 + 2 * kStages<D>) + 8 * (1 + 3 * kStages<D>) + 1024;

struct TmaParams {
  // q (b, h, t, d), k and v (b, h_kv, t, d) as {d, t, heads, b} maps, box
  // {64, 64, 1, 1}, 128-byte swizzle.
  CUtensorMap q;
  CUtensorMap k;
  CUtensorMap v;
  void* out;   // (b, h, t, d) contiguous, T
  float* lse;  // (b, h, t) contiguous
  int rows;    // b * h
  int h, group, t;
  int causal;
  float scale;  // 1 / sqrt(d), already rounded to T
};

__device__ __forceinline__ void consumers_sync() { named_sync<kThreads>(1); }

template <int D, typename T>
__global__ void __launch_bounds__(kTmaThreads)
    flash_fwd_wgmma_kernel(const __grid_constant__ TmaParams p) {
  constexpr int kSlabs = D / 64;         // slabs per tile
  constexpr int kTile = kSlabs * kSlab;  // bytes of a q, k or v tile
  constexpr int kSt = kStages<D>;

  const int head = grid_row();  // flat query head b * h + hq
  if (head >= p.rows) return;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* const qs = aligned_smem(smem_raw);
  uint8_t* const ks = qs + kTile;
  uint8_t* const vs = ks + kSt * kTile;
  uint64_t* const q_full = reinterpret_cast<uint64_t*>(vs + kSt * kTile);
  uint64_t* const k_full = q_full + 1;
  uint64_t* const v_full = k_full + kSt;
  uint64_t* const empty = v_full + kSt;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;
  const int b = head / p.h;
  const int hq = head % p.h;
  const int hk = hq / p.group;
  const int n_kv = (p.t + kBlockK - 1) / kBlockK;
  // Causal: kv tiles entirely above the diagonal are never loaded.
  const int kv_end =
      p.causal ? min(n_kv, (q0 + kBlockQ - 1) / kBlockK + 1) : n_kv;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kSt; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
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
      mbar_expect(q_full, kTile);
#pragma unroll
      for (int c = 0; c < kSlabs; ++c) {
        tma_load_4d(qs + c * kSlab, &p.q, q_full, c * 64, q0, hq, b);
      }
      for (int kb = 0; kb < kv_end; ++kb) {
        const int s = kb % kSt;
        if (kb >= kSt) mbar_wait(empty + s, (kb / kSt - 1) & 1);
        mbar_expect(k_full + s, kTile);
#pragma unroll
        for (int c = 0; c < kSlabs; ++c) {
          tma_load_4d(ks + s * kTile + c * kSlab, &p.k, k_full + s, c * 64,
                      kb * kBlockK, hk, b);
        }
        mbar_expect(v_full + s, kTile);
#pragma unroll
        for (int c = 0; c < kSlabs; ++c) {
          tma_load_4d(vs + s * kTile + c * kSlab, &p.v, v_full + s, c * 64,
                      kb * kBlockK, hk, b);
        }
      }
    }
    return;
  }

  const int lane = threadIdx.x % 32;
  const int c2 = 2 * (lane % 4);
  const int r0 = acc_row(0);  // this thread's tile rows: r0 and r0 + 8

  // q * scale rounded to T, in place; then visible to wgmma's reads.
  mbar_wait(q_full, 0);
  scale_in_place<T, kThreads>(qs, kTile, p.scale);
  fence_proxy_async_shared();
  consumers_sync();

  const uint32_t q_addr = smem_addr(qs);
  float o[kSlabs][32];
#pragma unroll
  for (int c = 0; c < kSlabs; ++c) {
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  }
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  for (int kb = 0; kb < kv_end; ++kb) {
    const int s = kb % kSt;
    const uint32_t parity = (kb / kSt) & 1;
    const int k0 = kb * kBlockK;
    const uint32_t k_addr = smem_addr(ks + s * kTile);
    const uint32_t v_addr = smem_addr(vs + s * kTile);

    // s = (q * scale) k^T in f32.
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    mbar_wait(k_full + s, parity);
    fence_acc(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = kk / 4 * kSlab + kk % 4 * 32;
      wgmma_bf16<0, 0, T>(sc, desc(q_addr + off), desc(k_addr + off));
    }
    wgmma_commit();
    wgmma_wait<0>(sc);

    // Only tiles that cross the diagonal or the ragged end pay the mask.
    const bool crosses_diag = p.causal && k0 + kBlockK - 1 > q0;
    if (crosses_diag || k0 + kBlockK > p.t) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = q0 + r0 + (e >= 2 ? 8 : 0);
          const int col = k0 + j * 8 + c2 + (e & 1);
          if (col >= p.t || (p.causal && col > row)) sc[4 * j + e] = -INFINITY;
        }
      }
    }

    // Online softmax; a row's 64 scores are spread over the 4 lanes of a
    // quad, so row max and row sum finish with two xor shuffles.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      const float corr = isfinite(m[i]) ? fast_exp(m[i] - m_safe) : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) {
          sc[4 * j + e] = fast_exp(sc[4 * j + e] - m_safe);
          sum += sc[4 * j + e];
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kSlabs; ++c) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[c][4 * j + 2 * i] *= corr;
          o[c][4 * j + 2 * i + 1] *= corr;
        }
      }
    }

    // p in T as the A fragments of the four 16-key steps.
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        pa[kk][f] = pack2<T>(sc[8 * kk + 2 * f], sc[8 * kk + 2 * f + 1]);
      }
    }

    // o += p v.
    mbar_wait(v_full + s, parity);
#pragma unroll
    for (int c = 0; c < kSlabs; ++c) fence_acc(o[c]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int c = 0; c < kSlabs; ++c) {
        wgmma_bf16_rs<1, T>(o[c], pa[kk],
                            desc(v_addr + c * kSlab + kk * 2048));
      }
    }
    wgmma_commit();
    wgmma_wait<0>(o[0]);
#pragma unroll
    for (int c = 1; c < kSlabs; ++c) fence_acc(o[c]);
    mbar_arrive(empty + s);  // this thread is done with stage s
  }

  T* og = static_cast<T*>(p.out) + static_cast<long long>(head) * p.t * D;
  float* lg = p.lse + static_cast<long long>(head) * p.t;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + 8 * i;
    if (row >= p.t) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kSlabs; ++c) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        store2(og + static_cast<long long>(row) * D + c * 64 + j * 8 + c2,
               o[c][4 * j + 2 * i] / den, o[c][4 * j + 2 * i + 1] / den);
      }
    }
    if (c2 == 0) lg[row] = m[i] + logf(den);
  }
}

// ---- f32: the FMA design ----

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* out;   // (b, h, t, d) contiguous
  float* lse;   // (b, h, t) contiguous
  int rows;     // b * h
  int h, group, t;
  int causal;
  float scale;  // 1 / sqrt(d)
  long long q_sb, q_sh, q_st;  // strides in elements; d is contiguous
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32_kernel(const Params p) {
  constexpr int kLd = D + 4;  // 16 bytes of row padding
  constexpr int kNT = kBlockK / 8;  // 8-key slices of a score tile
  constexpr int kDT = D / 8;        // 8-column slices of the output

  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + kBlockQ * kLd;
  float* vs = ks + kBlockK * kLd;
  float* ps = vs + kBlockK * kLd;

  const int head = grid_row();
  if (head >= p.rows) return;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;
  const int b = head / p.h;
  const int hq = head % p.h;
  const int hk = hq / p.group;
  const float* qg = p.q + b * p.q_sb + hq * p.q_sh;
  const float* kg = p.k + b * p.k_sb + hk * p.k_sh;
  const float* vg = p.v + b * p.v_sb + hk * p.v_sh;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int c2 = 2 * (lane % 4);
  const int r0 = warp * 16 + g;

  load_tile<float, D, kLd, kBlockQ, kThreads, true>(qs, qg, p.q_st, q0, p.t,
                                                    p.scale);
  __syncthreads();

  float o[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  const int n_kv = (p.t + kBlockK - 1) / kBlockK;
  const int kv_end =
      p.causal ? min(n_kv, (q0 + kBlockQ - 1) / kBlockK + 1) : n_kv;

  for (int kb = 0; kb < kv_end; ++kb) {
    const int k0 = kb * kBlockK;
    __syncthreads();  // every warp is done with the previous k/v tile
    load_tile<float, D, kLd, kBlockK, kThreads, false>(ks, kg, p.k_st, k0,
                                                       p.t, 1.f);
    load_tile<float, D, kLd, kBlockK, kThreads, false>(vs, vg, p.v_st, k0,
                                                       p.t, 1.f);
    __syncthreads();

    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qa = qs[r0 * kLd + d];
      const float qb = qs[(r0 + 8) * kLd + d];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const float ka = ks[(j * 8 + c2) * kLd + d];
        const float kb2 = ks[(j * 8 + c2 + 1) * kLd + d];
        s[j][0] = fmaf(qa, ka, s[j][0]);
        s[j][1] = fmaf(qa, kb2, s[j][1]);
        s[j][2] = fmaf(qb, ka, s[j][2]);
        s[j][3] = fmaf(qb, kb2, s[j][3]);
      }
    }

    const bool crosses_diag = p.causal && k0 + kBlockK - 1 > q0;
    if (crosses_diag || k0 + kBlockK > p.t) {
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = q0 + r0 + (e >= 2 ? 8 : 0);
          const int col = k0 + j * 8 + c2 + (e & 1);
          if (col >= p.t || (p.causal && col > row)) s[j][e] = -INFINITY;
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      const float corr = isfinite(m[i]) ? expf(m[i] - m_safe) : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) {
          s[j][e] = expf(s[j][e] - m_safe);
          sum += s[j][e];
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kDT; ++j) {
        o[j][2 * i] *= corr;
        o[j][2 * i + 1] *= corr;
      }
    }

    // o += p v: the warp's 16 rows of p go through its own slice of shared
    // memory, since each lane holds only part of a row.
    float* pw = ps + warp * 16 * kPLd;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      pw[g * kPLd + j * 8 + c2] = s[j][0];
      pw[g * kPLd + j * 8 + c2 + 1] = s[j][1];
      pw[(g + 8) * kPLd + j * 8 + c2] = s[j][2];
      pw[(g + 8) * kPLd + j * 8 + c2 + 1] = s[j][3];
    }
    __syncwarp();
#pragma unroll 4
    for (int key = 0; key < kBlockK; ++key) {
      const float pa = pw[g * kPLd + key];
      const float pb = pw[(g + 8) * kPLd + key];
#pragma unroll
      for (int j = 0; j < kDT; ++j) {
        const float va = vs[key * kLd + j * 8 + c2];
        const float vb = vs[key * kLd + j * 8 + c2 + 1];
        o[j][0] = fmaf(pa, va, o[j][0]);
        o[j][1] = fmaf(pa, vb, o[j][1]);
        o[j][2] = fmaf(pb, va, o[j][2]);
        o[j][3] = fmaf(pb, vb, o[j][3]);
      }
    }
    __syncwarp();  // the next tile rewrites pw
  }

  float* og = p.out + static_cast<long long>(head) * p.t * D;
  float* lg = p.lse + static_cast<long long>(head) * p.t;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + 8 * i;
    if (row >= p.t) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kDT; ++j) {
      store2(og + static_cast<long long>(row) * D + j * 8 + c2,
             o[j][2 * i] / den, o[j][2 * i + 1] / den);
    }
    if (c2 == 0) lg[row] = m[i] + logf(den);
  }
}

// ---- d past 256: flash_wide.cuh's forward ----

template <typename T>
__global__ void __launch_bounds__(wide::kThreads)
    flash_fwd_wide_kernel(const wide::FwdParams p) {
  wide::fwd<T>(p);
}

template <typename T>
cudaError_t launch_wide(const wide::FwdParams& p, cudaStream_t stream) {
  static std::atomic<bool> smem_set[kMaxDevices];
  return wide::launch_fwd(flash_fwd_wide_kernel<T>, p, stream, smem_set);
}

// ---- launches ----

template <int D>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  // d = 256: 212 KB, one block per SM.
  constexpr size_t kSmem = (kBlockQ + 2 * kBlockK) * (D + 4) * sizeof(float) +
                           kBlockQ * kPLd * sizeof(float);
  static std::atomic<bool> smem_set[kMaxDevices];
  const cudaError_t attr =
      allow_dynamic_smem(flash_fwd_f32_kernel<D>, kSmem, smem_set);
  if (attr != cudaSuccess) return attr;
  const dim3 grid = rows_grid((p.t + kBlockQ - 1) / kBlockQ, p.rows);
  flash_fwd_f32_kernel<D><<<grid, kThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

// st: the (b, heads, t) strides of q, k and v in turn.
template <int D, typename T>
cudaError_t launch_tma(TmaParams& p, int dtype, const void* q, const void* k,
                       const void* v, int b, int h_kv, const long long* st,
                       cudaStream_t stream) {
  cudaError_t err =
      encode_heads(&p.q, dtype, q, D, p.t, p.h, b, st[2], st[1], st[0]);
  if (err == cudaSuccess) {
    err = encode_heads(&p.k, dtype, k, D, p.t, h_kv, b, st[5], st[4], st[3]);
  }
  if (err == cudaSuccess) {
    err = encode_heads(&p.v, dtype, v, D, p.t, h_kv, b, st[8], st[7], st[6]);
  }
  if (err != cudaSuccess) return err;
  static std::atomic<bool> smem_set[kMaxDevices];
  err = allow_dynamic_smem(flash_fwd_wgmma_kernel<D, T>, kTmaSmem<D>,
                           smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid = rows_grid((p.t + kBlockQ - 1) / kBlockQ, p.rows);
  flash_fwd_wgmma_kernel<D, T>
      <<<grid, kTmaThreads, kTmaSmem<D>, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tma_d(TmaParams& p, int dtype, int d, const void* q,
                         const void* k, const void* v, int b, int h_kv,
                         const long long* st, cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch_tma<64, T>(p, dtype, q, k, v, b, h_kv, st, stream);
    case 128:
      return launch_tma<128, T>(p, dtype, q, k, v, b, h_kv, st, stream);
    default:
      return launch_tma<256, T>(p, dtype, q, k, v, b, h_kv, st, stream);
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t; 0 is success. dtype: 0 = bf16, 1 = f32, 2 = f16;
// d: 64, 128, 256, or a multiple of 8 above 256 (the wide kernel). Strides
// in elements, d contiguous; bf16 and f16 (and every type past 256) take
// 16-byte aligned q, k, v and strides that are multiples of 16 bytes (TMA,
// the wide kernel's 16-byte loads). Any b * h below 2^31: past 65535 the
// grid spreads them over y and z.
int gtt_flash_fwd(const void* q, const void* k, const void* v, void* out,
                  void* lse, int dtype, int b, int h, int h_kv, int t, int d,
                  int causal, float scale, long long q_sb,
                  long long q_sh, long long q_st, long long k_sb,
                  long long k_sh, long long k_st, long long v_sb,
                  long long v_sh, long long v_st, void* stream) {
  if (b < 1 || h < 1 || h_kv < 1 || h % h_kv != 0 || t < 1 ||
      static_cast<long long>(b) * h >= (1LL << 31) ||
      (d != 64 && d != 128 && d != 256 && !wide::takes(d)) || dtype < 0 ||
      dtype > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto aligned = [](const void* a) {
    return (reinterpret_cast<uintptr_t>(a) & 15) == 0;
  };
  const long long st[] = {q_sb, q_sh, q_st, k_sb, k_sh,
                          k_st, v_sb, v_sh, v_st};
  if (wide::takes(d)) {
    const int vec = dtype == 1 ? 4 : 8;
    bool ok = aligned(q) && aligned(k) && aligned(v);
    for (long long x : st) ok = ok && x > 0 && x % vec == 0;
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    wide::FwdParams p{};
    p.q = q;
    p.k = k;
    p.v = v;
    p.out = out;
    p.lse = static_cast<float*>(lse);
    p.rows = b * h;
    p.h = h;
    p.group = h / h_kv;
    p.tq = p.tkv = t;
    p.d = d;
    p.causal = causal;
    p.scale = scale;
    p.q_sb = q_sb;
    p.q_sh = q_sh;
    p.q_st = q_st;
    p.k_sb = k_sb;
    p.k_sh = k_sh;
    p.k_st = k_st;
    p.v_sb = v_sb;
    p.v_sh = v_sh;
    p.v_st = v_st;
    return static_cast<int>(dtype == 0   ? launch_wide<__nv_bfloat16>(p, s)
                            : dtype == 2 ? launch_wide<__half>(p, s)
                                         : launch_wide<float>(p, s));
  }
  if (dtype == 1) {
    Params p{static_cast<const float*>(q), static_cast<const float*>(k),
             static_cast<const float*>(v), static_cast<float*>(out),
             static_cast<float*>(lse), b * h, h, h / h_kv, t, causal, scale,
             q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st};
    return static_cast<int>(d == 64    ? launch_f32<64>(p, s)
                            : d == 128 ? launch_f32<128>(p, s)
                                       : launch_f32<256>(p, s));
  }
  bool ok = aligned(q) && aligned(k) && aligned(v);
  for (long long x : st) ok = ok && x > 0 && x % 8 == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  TmaParams p;
  memset(&p, 0, sizeof(p));
  p.out = out;
  p.lse = static_cast<float*>(lse);
  p.rows = b * h;
  p.h = h;
  p.group = h / h_kv;
  p.t = t;
  p.causal = causal;
  p.scale = scale;
  return static_cast<int>(
      dtype == 0
          ? launch_tma_d<__nv_bfloat16>(p, dtype, d, q, k, v, b, h_kv, st, s)
          : launch_tma_d<__half>(p, dtype, d, q, k, v, b, h_kv, st, s));
}

const char* gtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
