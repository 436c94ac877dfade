// The backward of one ring-attention step for Hopper (sm_90a), with a plain
// C interface: two kernels, two entry points.
//
// Replaces two Pallas TPU kernels of gloo_tpu/ops/attention.py behind
// flash_attention_bwd_step:
//   B7a _flash_bwd_dq_step_kernel   gtt_flash_bwd_dq_step
//       the dQ piece of one key/value block at a global position;
//   B7b _flash_bwd_dkv_step_kernel  gtt_flash_bwd_dkv_step
//       dK and dV of that block against the local queries, per query head.
// Both recompute every softmax tile from the completed forward's
// logsumexp rows (lse) and delta = rowsum(dO * O), so each block's pieces
// are correct on their own and the ring backward
// (gloo_tpu_torch/parallel/sp.py) only sums them.
//
// The cotangent dO is f32 (the ring backward's g.astype(f32)). As in the
// TPU kernels, dp = dO V^T and dV += p^T dO are then f32 products and p is
// never rounded; only ds is rounded to the input type, for dQ += ds K and
// dK += ds^T (q * scale). This version runs the two f32 products on the FMA
// units (not TF32, not bf16) and the two input-type products on mma.sync
// (bf16) or the FMA units (f32).
//
// What bounds them on an H100: operations. At the long-context path's
// shape (32 query-head rows, t_q = t_kv = 1024, d = 64, bf16 q/k/v) a step
// whose block is wholly visible to 3 of 4 ranks has 25.2 M (q, k) pairs;
// the f32 products alone are 128 flop per pair each (3.2 GFLOP per
// kernel, ~48 us at 67 TFLOP/s without the tensor cores), far above the
// ~28 MiB of bytes (~9 us). The design keeps every accumulator (dQ in B7a,
// dK and dV in B7b) in registers for the whole block, reads each operand
// tile once per block from device memory (16-byte loads into shared
// memory), never writes s, p, dp or ds to device memory, and skips the
// tiles that the TPU kernels' `active` tests skip (wholly above the global
// diagonal: their p is 0). wgmma, TMA, TF32 and one fused launch over
// shared tiles are left for a later version.
//
// Work division, 4 warps per block:
//   B7a: one block per (query-head row, 64-row query tile); warp w owns
//     query rows 16w .. 16w + 15 and walks the 64-key tiles, so dQ needs no
//     atomics. It writes dQ once, as acc * dq_scale in f32 (the TPU
//     kernel's last grid step: the unrounded f32 1/sqrt(d)).
//   B7b: one block per (query-head row, 64-key tile); warp w owns keys
//     16w .. 16w + 15 and walks the 64-row query tiles, 32 queries of s^T
//     and dp^T at a time; p^T (f32) and ds^T (input type) go through the
//     warp's rows of shared memory into dV and dK. It writes dK and dV in
//     f32 per query head (the caller folds GQA groups).
// Row i reads kv row i / group. Each row carries its own q_offset and
// k_offset, so one launch serves every rank of a world.
//
// Numerics follow the TPU kernels: q * scale rounded to the input type
// (the wrapper passes scale already rounded), s and dp in f32,
// p = exp(s - lse) with no guard (lse is finite for every row), masked
// entries and rows or keys past the ragged ends forced to p = 0.

#include "flash_common.cuh"

#include <atomic>
#include <cmath>
#include <type_traits>

namespace {

using namespace gtt;

constexpr int kBlockQ = 64;  // query rows per tile
constexpr int kBlockK = 64;  // keys per tile
constexpr int kThreads = 128;
// Query columns of s^T and dp^T a B7b warp holds in registers at once.
constexpr int kChunk = 32;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* dout;   // (bh, t_q, d) f32
  const float* lse;    // (bh, t_q) contiguous
  const float* delta;  // (bh, t_q) contiguous
  const int* q_off;    // (bh,)
  const int* k_off;    // (bh,)
  float* dq;           // B7a: (bh, t_q, d) contiguous
  float* dk;           // B7b: (bh, t_kv, d) contiguous
  float* dv;
  int group, tq, tkv;
  int causal;
  float scale;     // 1 / sqrt(d), rounded to the input type
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

// Loads lse and delta of the tile's rows (0 past t_q).
__device__ __forceinline__ void load_rows(const Params& p, int row, int q0,
                                          float* lse_s, float* delta_s) {
  if (threadIdx.x < kBlockQ) {
    const int r = q0 + threadIdx.x;
    const long long at = static_cast<long long>(row) * p.tq + r;
    lse_s[threadIdx.x] = r < p.tq ? p.lse[at] : 0.f;
    delta_s[threadIdx.x] = r < p.tq ? p.delta[at] : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) dq_step_kernel(const Params p) {
  constexpr int kLd = D + 16 / sizeof(T);         // q, k, v rows
  constexpr int kLdF = D + 4;                     // f32 dO rows
  constexpr int kLdS = kBlockK + 16 / sizeof(T);  // ds rows [query][key]
  constexpr int kNT = kBlockK / 8;
  constexpr int kDT = D / 8;

  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);  // q * scale
  T* ks = qs + kBlockQ * kLd;
  T* vs = ks + kBlockK * kLd;
  T* dss = vs + kBlockK * kLd;
  float* dos = reinterpret_cast<float*>(dss + kBlockQ * kLdS);
  float* lse_s = dos + kBlockQ * kLdF;
  float* delta_s = lse_s + kBlockQ;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;
  const int row = blockIdx.y;
  const int qo = p.q_off[row];
  const int ko = p.k_off[row];
  const T* kg = static_cast<const T*>(p.k) + (row / p.group) * p.k_sr;
  const T* vg = static_cast<const T*>(p.v) + (row / p.group) * p.v_sr;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int c2 = 2 * (lane % 4);
  const int r0 = warp * 16 + g;  // this lane's tile rows: r0 and r0 + 8

  const int n_kv = (p.tkv + kBlockK - 1) / kBlockK;
  int kv_end = n_kv;
  if (p.causal) {
    const int reach = qo + q0 + kBlockQ - 1 - ko;
    kv_end = reach < 0 ? 0 : min(n_kv, reach / kBlockK + 1);
  }

  float dq[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  if (kv_end > 0) {
    load_tile<T, D, kLd, kBlockQ, kThreads, true>(
        qs, static_cast<const T*>(p.q) + row * p.q_sr, p.q_st, q0, p.tq,
        p.scale);
    load_tile<float, D, kLdF, kBlockQ, kThreads, false>(
        dos, p.dout + row * p.o_sr, p.o_st, q0, p.tq, 1.f);
    load_rows(p, row, q0, lse_s, delta_s);
  }

  for (int kb = 0; kb < kv_end; ++kb) {
    const int k0 = kb * kBlockK;
    __syncthreads();  // every warp is done with the previous k/v tile
    load_tile<T, D, kLd, kBlockK, kThreads, false>(ks, kg, p.k_st, k0, p.tkv,
                                                   1.f);
    load_tile<T, D, kLd, kBlockK, kThreads, false>(vs, vg, p.v_st, k0, p.tkv,
                                                   1.f);
    __syncthreads();

    float s[kNT][4];
    float dp[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
    // s = (q * scale) k^T; dp = dO v^T in f32.
    warp_product<T, D, kNT, kLd, 1, 1, kLd>(s, qs + warp * 16 * kLd, ks);
    warp_fma<D, kNT, kLdF, 1, 1, kLd>(dp, dos + warp * 16 * kLdF, vs);

    const bool masked = (p.causal && ko + k0 + kBlockK - 1 > qo + q0) ||
                        k0 + kBlockK > p.tkv || q0 + kBlockQ > p.tq;
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
    // dq += ds (in the input type) k.
    warp_product<T, kBlockK, kDT, kLdS, 1, kLd, 1>(dq, dsw, ks);
  }

  float* dqg = p.dq + static_cast<long long>(row) * p.tq * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + r0 + 8 * i;
    if (r >= p.tq) continue;
#pragma unroll
    for (int j = 0; j < kDT; ++j) {
      store2(dqg + static_cast<long long>(r) * D + j * 8 + c2,
             dq[j][2 * i] * p.dq_scale, dq[j][2 * i + 1] * p.dq_scale);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) dkv_step_kernel(const Params p) {
  constexpr int kLd = D + 16 / sizeof(T);         // k, v, q rows
  constexpr int kLdF = D + 4;                     // f32 dO rows
  constexpr int kLdP = kBlockQ + 4;               // f32 p^T [key][query]
  constexpr int kLdS = kBlockQ + 16 / sizeof(T);  // ds^T [key][query]
  constexpr int kDT = D / 8;
  constexpr int kCT = kChunk / 8;

  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + kBlockK * kLd;
  T* qs = vs + kBlockK * kLd;  // q * scale
  T* dsts = qs + kBlockQ * kLd;
  float* dos = reinterpret_cast<float*>(dsts + kBlockK * kLdS);
  float* pts = dos + kBlockQ * kLdF;
  float* lse_s = pts + kBlockK * kLdP;
  float* delta_s = lse_s + kBlockQ;

  const int k0 = blockIdx.x * kBlockK;
  const int row = blockIdx.y;
  const int qo = p.q_off[row];
  const int ko = p.k_off[row];
  const T* qg = static_cast<const T*>(p.q) + row * p.q_sr;
  const float* og = p.dout + row * p.o_sr;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int c2 = 2 * (lane % 4);
  const int kr = warp * 16 + g;  // this lane's key rows: kr and kr + 8

  load_tile<T, D, kLd, kBlockK, kThreads, false>(
      ks, static_cast<const T*>(p.k) + (row / p.group) * p.k_sr, p.k_st, k0,
      p.tkv, 1.f);
  load_tile<T, D, kLd, kBlockK, kThreads, false>(
      vs, static_cast<const T*>(p.v) + (row / p.group) * p.v_sr, p.v_st, k0,
      p.tkv, 1.f);

  float dk[kDT][4];
  float dv[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  }

  const int n_q = (p.tq + kBlockQ - 1) / kBlockQ;
  // Causal: query tiles whose last global position lies before the key
  // tile's first are skipped.
  int qi_first = 0;
  if (p.causal) {
    const int gap = ko + k0 - qo - (kBlockQ - 1);
    qi_first = gap <= 0 ? 0 : (gap + kBlockQ - 1) / kBlockQ;
  }
  float* ptw = pts + warp * 16 * kLdP;
  T* dstw = dsts + warp * 16 * kLdS;
  for (int qi = qi_first; qi < n_q; ++qi) {
    const int q0 = qi * kBlockQ;
    __syncthreads();  // every warp is done with the previous query tile
    load_tile<T, D, kLd, kBlockQ, kThreads, true>(qs, qg, p.q_st, q0, p.tq,
                                                  p.scale);
    load_tile<float, D, kLdF, kBlockQ, kThreads, false>(dos, og, p.o_st, q0,
                                                        p.tq, 1.f);
    load_rows(p, row, q0, lse_s, delta_s);
    __syncthreads();

    const bool masked = (p.causal && ko + k0 + kBlockK - 1 > qo + q0) ||
                        k0 + kBlockK > p.tkv || q0 + kBlockQ > p.tq;
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
      warp_product<T, D, kCT, kLd, 1, 1, kLd>(s, ks + warp * 16 * kLd,
                                              qs + n0 * kLd);
      warp_fma<D, kCT, kLd, 1, 1, kLdF>(dp, vs + warp * 16 * kLd,
                                        dos + n0 * kLdF);
#pragma unroll
      for (int j = 0; j < kCT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n0 + j * 8 + c2 + (e & 1);  // query in the tile
          float pe = expf(s[j][e] - lse_s[col]);
          if (masked && masked_pair(p, k0 + kr + (e >= 2 ? 8 : 0), q0 + col,
                                    ko, qo)) {
            pe = 0.f;
          }
          s[j][e] = pe;
          dp[j][e] = pe * (dp[j][e] - delta_s[col]);
        }
        const int col = n0 + j * 8 + c2;
        store2(ptw + g * kLdP + col, s[j][0], s[j][1]);
        store2(ptw + (g + 8) * kLdP + col, s[j][2], s[j][3]);
        store2(dstw + g * kLdS + col, dp[j][0], dp[j][1]);
        store2(dstw + (g + 8) * kLdS + col, dp[j][2], dp[j][3]);
      }
    }
    __syncwarp();  // the warp's own p^T and ds^T rows are written

    // dV += p^T dO (f32, p unrounded); dK += ds^T (q * scale).
    warp_fma<kBlockQ, kDT, kLdP, 1, kLdF, 1>(dv, ptw, dos);
    warp_product<T, kBlockQ, kDT, kLdS, 1, kLd, 1>(dk, dstw, qs);
  }

  const long long base = static_cast<long long>(row) * p.tkv * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + kr + 8 * i;
    if (key >= p.tkv) continue;
#pragma unroll
    for (int j = 0; j < kDT; ++j) {
      const long long off = base + static_cast<long long>(key) * D + j * 8 +
                            c2;
      store2(p.dk + off, dk[j][2 * i], dk[j][2 * i + 1]);
      store2(p.dv + off, dv[j][2 * i], dv[j][2 * i + 1]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_dq(const Params& p, int bh, cudaStream_t stream) {
  constexpr int kLd = D + 16 / sizeof(T);
  constexpr size_t kSmem =
      (kBlockQ + 2 * kBlockK) * kLd * sizeof(T) +
      kBlockQ * (kBlockK + 16 / sizeof(T)) * sizeof(T) +
      (kBlockQ * (D + 4) + 2 * kBlockQ) * sizeof(float);
  static std::atomic<bool> smem_set[kMaxDevices];
  const cudaError_t attr =
      allow_dynamic_smem(dq_step_kernel<T, D>, kSmem, smem_set);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.tq + kBlockQ - 1) / kBlockQ, bh);
  dq_step_kernel<T, D><<<grid, kThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Params& p, int bh, cudaStream_t stream) {
  constexpr int kLd = D + 16 / sizeof(T);
  constexpr size_t kSmem =
      (2 * kBlockK + kBlockQ) * kLd * sizeof(T) +
      kBlockK * (kBlockQ + 16 / sizeof(T)) * sizeof(T) +
      (kBlockQ * (D + 4) + kBlockK * (kBlockQ + 4) + 2 * kBlockQ) *
          sizeof(float);
  static std::atomic<bool> smem_set[kMaxDevices];
  const cudaError_t attr =
      allow_dynamic_smem(dkv_step_kernel<T, D>, kSmem, smem_set);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.tkv + kBlockK - 1) / kBlockK, bh);
  dkv_step_kernel<T, D><<<grid, kThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <bool kDq>
int run(const Params& p, int dtype, int bh, int d, void* stream) {
  if (bh < 1 || bh > 65535 || p.group < 1 || bh % p.group != 0 || p.tq < 1 ||
      p.tkv < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && d == 64) {
    err = kDq ? launch_dq<bf16, 64>(p, bh, s) : launch_dkv<bf16, 64>(p, bh, s);
  }
  if (dtype == 0 && d == 128) {
    err = kDq ? launch_dq<bf16, 128>(p, bh, s)
              : launch_dkv<bf16, 128>(p, bh, s);
  }
  if (dtype == 1 && d == 64) {
    err = kDq ? launch_dq<float, 64>(p, bh, s)
              : launch_dkv<float, 64>(p, bh, s);
  }
  if (dtype == 1 && d == 128) {
    err = kDq ? launch_dq<float, 128>(p, bh, s)
              : launch_dkv<float, 128>(p, bh, s);
  }
  return static_cast<int>(err);
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   const void* q_off, const void* k_off, int group, int tq,
                   int tkv, int causal, float scale, long long q_sr,
                   long long q_st, long long k_sr, long long k_st,
                   long long v_sr, long long v_st, long long o_sr,
                   long long o_st) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = static_cast<const float*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.q_off = static_cast<const int*>(q_off);
  p.k_off = static_cast<const int*>(k_off);
  p.group = group;
  p.tq = tq;
  p.tkv = tkv;
  p.causal = causal;
  p.scale = scale;
  p.q_sr = q_sr;
  p.q_st = q_st;
  p.k_sr = k_sr;
  p.k_st = k_st;
  p.v_sr = v_sr;
  p.v_st = v_st;
  p.o_sr = o_sr;
  p.o_st = o_st;
  return p;
}

}  // namespace

extern "C" {

// Each returns a cudaError_t; 0 is success. dtype (of q, k, v): 0 = bf16,
// 1 = f32; dO, lse, delta and the outputs are f32. Strides in elements.
int gtt_flash_bwd_dq_step(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, const void* q_off,
                          const void* k_off, void* dq, int dtype, int bh,
                          int group, int tq, int tkv, int d, int causal,
                          float scale, float dq_scale, long long q_sr,
                          long long q_st, long long k_sr, long long k_st,
                          long long v_sr, long long v_st, long long o_sr,
                          long long o_st, void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, q_off, k_off, group, tq,
                         tkv, causal, scale, q_sr, q_st, k_sr, k_st, v_sr,
                         v_st, o_sr, o_st);
  p.dq = static_cast<float*>(dq);
  p.dq_scale = dq_scale;
  return run<true>(p, dtype, bh, d, stream);
}

int gtt_flash_bwd_dkv_step(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, const void* q_off,
                           const void* k_off, void* dk, void* dv, int dtype,
                           int bh, int group, int tq, int tkv, int d,
                           int causal, float scale, long long q_sr,
                           long long q_st, long long k_sr, long long k_st,
                           long long v_sr, long long v_st, long long o_sr,
                           long long o_st, void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, q_off, k_off, group, tq,
                         tkv, causal, scale, q_sr, q_st, k_sr, k_st, v_sr,
                         v_st, o_sr, o_st);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  return run<false>(p, dtype, bh, d, stream);
}

const char* gtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
