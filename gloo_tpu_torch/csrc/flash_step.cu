// One ring-attention step of flash attention for Hopper (sm_90a), with a
// plain C interface.
//
// Replaces gloo_tpu/ops/attention.py::_flash_step_kernel (B6), the Pallas
// TPU kernel behind flash_attention_step: fold one (t_kv, d) key/value
// block into carried online-softmax state (acc, m, l), f32, for queries
// and keys placed in the global sequence by per-row offsets. Ring
// attention (gloo_tpu_torch/parallel/sp.py) calls it once per ring step,
// each time with the block that has just arrived.
//
// The state is updated in place. The TPU kernel returns new arrays, and
// the port's flash_attention_step keeps that contract by copying the state
// first; the ring forward hands over its own buffers
// (flash_attention_step_into), so a query tile that sees no key of the
// block costs nothing: its block exits before any load or store, and its
// state stays as it was (the TPU kernel's online step would leave it bit
// for bit as it was too).
//
// What bounds it on an H100: bytes. At the long-context path's shape (32
// query-head rows over a world of 4 ranks, t_q = t_kv = 1024, d = 64,
// bf16, causal) a launch over the rows that see a key reads their q (4
// MiB at the first ring step), k and v (8 MiB) and their state (8.25 MiB)
// and writes the state: 28.5 MiB at the first step, 17.8 MiB on average
// over the ring's 4 steps (the causal ring hides 6 of its 16 rank-blocks),
// ~5.6 us at 3.35 TB/s, against ~4.3 us of bf16 products at 989 TFLOP/s.
// The design keeps every load in flight ahead of the products and runs
// the products on wgmma, with the state read once straight into the
// accumulator registers and written once.
//
// bf16 and f16 (the model's types; one template, T): B1's design
// (flash_fwd.cu) at per-row offsets.
// One block per (query-head row, 64-row query tile), highest query tiles
// first (under the causal mask they are the longest), of one consumer
// warpgroup (128 threads, 16 query rows per warp) and one producer warp.
// The producer's lane 0 issues TMA loads of 128-byte-swizzled 64 x 64
// slabs (hopper.cuh): the q tile once, then the k and v tiles of 64 keys
// into a ring of kStages<D> stages, each with a full mbarrier for k, one
// for v and an empty one the consumers arrive on. Meanwhile the consumers
// load the carried acc, m and l of their rows into the wgmma accumulator
// layout, scale q once in shared memory (q * scale rounded to T, then
// fence.proxy.async and a named barrier), then per key tile:
//   - s = q k^T: wgmma m64n64k16 with both operands in shared memory;
//   - the mask, only on tiles that cross the global diagonal or the
//     ragged end, and the online softmax in the accumulator layout, e^x
//     as fast_exp;
//   - o += p v: wgmma with p from registers and v MN-major.
// Key tiles above the global diagonal are never loaded. The maps run over
// (rows, t, d), and row i reads kv row i / group (GQA): never replicated.
// d = 256 (136-248 zero-padded to it): B1's d = 256 instance, one pass
// over the columns (161 KB of shared memory, one block per SM).
//
// Rows past the grid's 65535 go on grid z (rows_grid in
// flash_common.cuh): a launch of at most 65535 rows is the launch it was.
//
// f32 (off the model's path) keeps the FMA design: one block of 4 warps
// per (query-head row, 64-row query tile), 16-byte loads of the tiles
// into padded shared memory, the products on the FMA units in the m16n8
// accumulator layout of mma.sync (flash_common.cuh), which is wgmma's per
// warp: both kernels share the state's loads and stores.
//
// Numerics follow the TPU kernel step by step: q * scale rounded to the
// input type before QK^T (the wrapper passes scale already rounded), f32
// scores over 64-key tiles, -inf where the global key position passes the
// query's, the m_safe / corr guards of _online_step, p rounded to v's type
// before PV, f32 state. The 16-bit kernel takes e^x from the SFU's 2^x
// (fast_exp), the f32 kernel from expf.

#include "flash_common.cuh"
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

// k/v stages of the ring by head_dim, as B1's: three at d = 64 (58 KB),
// two at d = 128 (83 KB) and d = 256 (161 KB).
template <int D>
constexpr int kStages = D == 64 ? 3 : 2;

// Shared memory of a 16-bit launch: the q tile and kStages<D> k and v tiles,
// their mbarriers and the swizzle's 1024-byte alignment.
template <int D>
constexpr int kTmaSmem =
    D / 64 * kSlab * (1 + 2 * kStages<D>) + 8 * (1 + 3 * kStages<D>) + 1024;

// The carried state and the per-row offsets: what both kernels share.
struct State {
  float* acc;  // (bh, t_q, acc_ld) contiguous: columns [0, acc_ld) of D
  float* m;    // (bh, t_q) contiguous
  float* l;
  const int* q_off;  // (bh,) global position of each row's first query
  const int* k_off;  // (bh,) global position of each row's first key
  int bh;
  int group, tq, tkv;
  int acc_ld;  // the caller's head_dim: columns past it are the padding's
  int causal;
  float scale;  // 1 / sqrt(d), already rounded to the input type
};

// The key tiles [0, kv_end) that query tile q0 of `row` visits: under the
// causal mask, those whose first global position is at most that of the
// tile's last query before t_q. 0: the tile sees no key.
__device__ __forceinline__ int kv_end_of(const State& s, int row, int q0) {
  const int n_kv = (s.tkv + kBlockK - 1) / kBlockK;
  if (!s.causal) return n_kv;
  const int reach =
      s.q_off[row] + min(q0 + kBlockQ, s.tq) - 1 - s.k_off[row];
  return reach < 0 ? 0 : min(n_kv, reach / kBlockK + 1);
}

// This thread's two rows of the carried state (rows q0 + r0 and q0 + r0 +
// 8 of the row whose state starts at `base`), in the accumulator layout:
// o[jj][2 i + e] holds column 8 jj + c2 + e of row q0 + r0 + 8 i. Rows past
// t_q and the padding's columns start at 0 (and m at -inf) and are never
// stored.
template <int D>
__device__ __forceinline__ void load_state(const State& s, long long base,
                                           int q0, int r0, int c2,
                                           float (*o)[4], float* m,
                                           float* l) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + r0 + 8 * i;
    const bool in = r < s.tq;
    m[i] = in ? s.m[base + r] : -INFINITY;
    l[i] = in ? s.l[base + r] : 0.f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + c2;
      float2 a = make_float2(0.f, 0.f);
      if (in && col < s.acc_ld) {
        a = *reinterpret_cast<const float2*>(s.acc + (base + r) * s.acc_ld +
                                             col);
      }
      o[j][2 * i] = a.x;
      o[j][2 * i + 1] = a.y;
    }
  }
}

template <int D>
__device__ __forceinline__ void store_state(const State& s, long long base,
                                            int q0, int r0, int c2,
                                            float (*o)[4], const float* m,
                                            const float* l) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + r0 + 8 * i;
    if (r >= s.tq) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + c2;
      if (col < s.acc_ld) {
        store2(s.acc + (base + r) * s.acc_ld + col, o[j][2 * i],
               o[j][2 * i + 1]);
      }
    }
    if (c2 == 0) {
      s.m[base + r] = m[i];
      s.l[base + r] = l[i];
    }
  }
}

// ---- bf16 and f16: wgmma on TMA-staged tiles ----

struct TmaParams {
  // q (bh, t_q, d), k and v (bh / group, t_kv, d) as {d, t, rows} maps,
  // box {64, 64, 1}, 128-byte swizzle.
  CUtensorMap q;
  CUtensorMap k;
  CUtensorMap v;
  State s;
};

__device__ __forceinline__ void consumers_sync() { named_sync<kThreads>(1); }

template <int D, typename T>
__global__ void __launch_bounds__(kTmaThreads)
    flash_step_wgmma_kernel(const __grid_constant__ TmaParams p) {
  constexpr int kSlabs = D / 64;         // slabs per tile
  constexpr int kTile = kSlabs * kSlab;  // bytes of a q, k or v tile
  constexpr int kSt = kStages<D>;

  const State& st = p.s;
  const int row = grid_row();  // query-head row
  if (row >= st.bh) return;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;
  const int kv_end = kv_end_of(st, row, q0);
  if (kv_end == 0) return;  // nothing visible: the state stays as it is

  extern __shared__ uint8_t smem_raw[];
  uint8_t* const qs = aligned_smem(smem_raw);
  uint8_t* const ks = qs + kTile;
  uint8_t* const vs = ks + kSt * kTile;
  uint64_t* const q_full = reinterpret_cast<uint64_t*>(vs + kSt * kTile);
  uint64_t* const k_full = q_full + 1;
  uint64_t* const v_full = k_full + kSt;
  uint64_t* const empty = v_full + kSt;

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
      const int kv_row = row / st.group;
      prefetch_map(&p.q);
      prefetch_map(&p.k);
      prefetch_map(&p.v);
      mbar_expect(q_full, kTile);
#pragma unroll
      for (int c = 0; c < kSlabs; ++c) {
        tma_load_3d(qs + c * kSlab, &p.q, q_full, c * 64, q0, row);
      }
      for (int kb = 0; kb < kv_end; ++kb) {
        const int s = kb % kSt;
        if (kb >= kSt) mbar_wait(empty + s, (kb / kSt - 1) & 1);
        mbar_expect(k_full + s, kTile);
#pragma unroll
        for (int c = 0; c < kSlabs; ++c) {
          tma_load_3d(ks + s * kTile + c * kSlab, &p.k, k_full + s, c * 64,
                      kb * kBlockK, kv_row);
        }
        mbar_expect(v_full + s, kTile);
#pragma unroll
        for (int c = 0; c < kSlabs; ++c) {
          tma_load_3d(vs + s * kTile + c * kSlab, &p.v, v_full + s, c * 64,
                      kb * kBlockK, kv_row);
        }
      }
    }
    return;
  }

  const int c2 = 2 * (threadIdx.x % 4);
  const int r0 = acc_row(0);  // this thread's tile rows: r0 and r0 + 8
  const int qo = st.q_off[row];
  const int ko = st.k_off[row];
  const long long base = static_cast<long long>(row) * st.tq;

  // The carried state, while the q tile is in flight.
  float o[kSlabs][32];
  float m[2], l[2];
  load_state<D>(st, base, q0, r0, c2,
                reinterpret_cast<float(*)[4]>(&o[0][0]), m, l);

  // q * scale rounded to T, in place; then visible to wgmma's reads.
  mbar_wait(q_full, 0);
  scale_in_place<T, kThreads>(qs, kTile, st.scale);
  fence_proxy_async_shared();
  consumers_sync();

  const uint32_t q_addr = smem_addr(qs);
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

    // Only tiles that cross the global diagonal or the ragged end pay the
    // mask.
    const bool crosses_diag = st.causal && ko + k0 + kBlockK - 1 > qo + q0;
    if (crosses_diag || k0 + kBlockK > st.tkv) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = q0 + r0 + (e >= 2 ? 8 : 0);
          const int col = k0 + j * 8 + c2 + (e & 1);
          if (col >= st.tkv || (st.causal && ko + col > qo + r)) {
            sc[4 * j + e] = -INFINITY;
          }
        }
      }
    }

    // Online softmax (_online_step); a row's 64 scores are spread over the
    // 4 lanes of a quad, so row max and row sum finish with two shuffles.
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

  store_state<D>(st, base, q0, r0, c2,
                 reinterpret_cast<float(*)[4]>(&o[0][0]), m, l);
}

// ---- f32: the FMA design ----

struct Params {
  const float* q;
  const float* k;
  const float* v;
  State s;
  long long q_sr, q_st;  // strides in elements; d is contiguous
  long long k_sr, k_st;
  long long v_sr, v_st;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_step_f32_kernel(const Params p) {
  constexpr int kLd = D + 4;        // 16 bytes of row padding
  constexpr int kNT = kBlockK / 8;  // 8-key slices of a score tile
  constexpr int kDT = D / 8;        // 8-column slices of the state

  const State& st = p.s;
  const int row = grid_row();
  if (row >= st.bh) return;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;
  const int kv_end = kv_end_of(st, row, q0);
  if (kv_end == 0) return;  // nothing visible: the state stays as it is

  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + kBlockQ * kLd;
  float* vs = ks + kBlockK * kLd;
  float* ps = vs + kBlockK * kLd;

  const int qo = st.q_off[row];
  const int ko = st.k_off[row];
  const float* qg = p.q + row * p.q_sr;
  const float* kg = p.k + (row / st.group) * p.k_sr;
  const float* vg = p.v + (row / st.group) * p.v_sr;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int c2 = 2 * (lane % 4);
  const int r0 = warp * 16 + g;  // this lane's tile rows: r0 and r0 + 8
  const long long base = static_cast<long long>(row) * st.tq;

  float o[kDT][4];
  float m[2], l[2];
  load_state<D>(st, base, q0, r0, c2, o, m, l);

  load_tile<float, D, kLd, kBlockQ, kThreads, true>(qs, qg, p.q_st, q0,
                                                    st.tq, st.scale);
  __syncthreads();

  for (int kb = 0; kb < kv_end; ++kb) {
    const int k0 = kb * kBlockK;
    __syncthreads();  // every warp is done with the previous k/v tile
    load_tile<float, D, kLd, kBlockK, kThreads, false>(ks, kg, p.k_st, k0,
                                                       st.tkv, 1.f);
    load_tile<float, D, kLd, kBlockK, kThreads, false>(vs, vg, p.v_st, k0,
                                                       st.tkv, 1.f);
    __syncthreads();

    // s = (q * scale) k^T in f32.
    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    warp_fma<D, kNT, kLd, 1, 1, kLd>(s, qs + warp * 16 * kLd, ks);

    const bool crosses_diag = st.causal && ko + k0 + kBlockK - 1 > qo + q0;
    if (crosses_diag || k0 + kBlockK > st.tkv) {
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = q0 + r0 + (e >= 2 ? 8 : 0);
          const int col = k0 + j * 8 + c2 + (e & 1);
          if (col >= st.tkv || (st.causal && ko + col > qo + r)) {
            s[j][e] = -INFINITY;
          }
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
      store2(pw + g * kPLd + j * 8 + c2, s[j][0], s[j][1]);
      store2(pw + (g + 8) * kPLd + j * 8 + c2, s[j][2], s[j][3]);
    }
    __syncwarp();
    warp_fma<kBlockK, kDT, kPLd, 1, kLd, 1>(o, pw, vs);
    __syncwarp();  // the next tile rewrites pw
  }

  store_state<D>(st, base, q0, r0, c2, o, m, l);
}

// ---- launches ----

template <int D>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  // d = 256: 212 KB, one block per SM.
  constexpr size_t kSmem = (kBlockQ + 2 * kBlockK) * (D + 4) * sizeof(float) +
                           kBlockQ * kPLd * sizeof(float);
  static std::atomic<bool> smem_set[kMaxDevices];
  const cudaError_t attr =
      allow_dynamic_smem(flash_step_f32_kernel<D>, kSmem, smem_set);
  if (attr != cudaSuccess) return attr;
  const dim3 grid = rows_grid((p.s.tq + kBlockQ - 1) / kBlockQ, p.s.bh);
  flash_step_f32_kernel<D><<<grid, kThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

// st: the (row, t) strides of q, k and v in turn.
template <int D, typename T>
cudaError_t launch_tma(TmaParams& p, int dtype, const void* q, const void* k,
                       const void* v, const long long* st,
                       cudaStream_t stream) {
  const int bh = p.s.bh;
  cudaError_t err =
      encode_rows(&p.q, dtype, q, D, p.s.tq, bh, st[1], st[0], 64);
  if (err == cudaSuccess) {
    err = encode_rows(&p.k, dtype, k, D, p.s.tkv, bh / p.s.group, st[3],
                      st[2], 64);
  }
  if (err == cudaSuccess) {
    err = encode_rows(&p.v, dtype, v, D, p.s.tkv, bh / p.s.group, st[5],
                      st[4], 64);
  }
  if (err != cudaSuccess) return err;
  static std::atomic<bool> smem_set[kMaxDevices];
  err = allow_dynamic_smem(flash_step_wgmma_kernel<D, T>, kTmaSmem<D>,
                           smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid = rows_grid((p.s.tq + kBlockQ - 1) / kBlockQ, bh);
  flash_step_wgmma_kernel<D, T>
      <<<grid, kTmaThreads, kTmaSmem<D>, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tma_d(TmaParams& p, int dtype, int d, const void* q,
                         const void* k, const void* v, const long long* st,
                         cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch_tma<64, T>(p, dtype, q, k, v, st, stream);
    case 128:
      return launch_tma<128, T>(p, dtype, q, k, v, st, stream);
    default:
      return launch_tma<256, T>(p, dtype, q, k, v, st, stream);
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t; 0 is success. Folds k, v into the state in
// place. dtype: 0 = bf16, 1 = f32, 2 = f16; d (the kernel's head_dim): 64,
// 128 or 256. q (bh, t_q, d), k and v (bh / group, t_kv, d) at row and t
// strides in elements, d contiguous, 16-byte aligned with strides that are
// multiples of 16 bytes. acc (bh, t_q, acc_ld) f32 contiguous, acc_ld <= d
// and a multiple of 2 (columns past it are the zero padding of q, k and
// v); m, l (bh, t_q) f32 contiguous. q_off, k_off (bh,) int32. Any bh: past
// 65535 rows the grid spreads them over y and z.
int gtt_flash_step(const void* q, const void* k, const void* v, void* acc,
                   void* m, void* l, const void* q_off, const void* k_off,
                   int dtype, int bh, int group, int tq, int tkv, int d,
                   int acc_ld, int causal, float scale, long long q_sr,
                   long long q_st, long long k_sr, long long k_st,
                   long long v_sr, long long v_st, void* stream) {
  if (bh < 1 || group < 1 || bh % group != 0 || tq < 1 || tkv < 1 ||
      (d != 64 && d != 128 && d != 256) || acc_ld < 2 || acc_ld > d ||
      acc_ld % 2 || dtype < 0 || dtype > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const State s{static_cast<float*>(acc),
                static_cast<float*>(m),
                static_cast<float*>(l),
                static_cast<const int*>(q_off),
                static_cast<const int*>(k_off),
                bh,
                group,
                tq,
                tkv,
                acc_ld,
                causal,
                scale};
  cudaStream_t stm = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype != 1) {
    TmaParams p;
    memset(&p, 0, sizeof(p));
    p.s = s;
    const long long st[6] = {q_sr, q_st, k_sr, k_st, v_sr, v_st};
    err = dtype == 0
              ? launch_tma_d<__nv_bfloat16>(p, dtype, d, q, k, v, st, stm)
              : launch_tma_d<__half>(p, dtype, d, q, k, v, st, stm);
  } else {
    const Params p{static_cast<const float*>(q),
                   static_cast<const float*>(k),
                   static_cast<const float*>(v),
                   s,
                   q_sr,
                   q_st,
                   k_sr,
                   k_st,
                   v_sr,
                   v_st};
    err = d == 64    ? launch_f32<64>(p, stm)
          : d == 128 ? launch_f32<128>(p, stm)
                     : launch_f32<256>(p, stm);
  }
  return static_cast<int>(err);
}

const char* gtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
