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
// What bounds it on an H100: bytes. At the long-context path's shape (32
// query-head rows over a world of 4 ranks, t_q = t_kv = 1024, d = 64,
// bf16) one launch reads q (4 MiB), k and v (8 MiB), the state (8.25 MiB)
// and writes the state (8.25 MiB): 28.5 MiB, ~9 us at 3.35 TB/s, against
// at most ~6.4 GFLOP of bf16 products per causal step (< 6.5 us at 989
// TFLOP/s). The f32 state in and out is more than half of the bytes. The
// design keeps that state in registers for the whole block: it is read
// once and written once per launch, and every k and v element is read
// once per query tile (16-byte loads into shared memory); scores never
// leave registers; key tiles wholly above the global diagonal are
// skipped (their scores are all -inf, so they would leave the state bit
// for bit as it was). Products run on the tensor cores through mma.sync
// (bf16) or on the FMA units (f32); wgmma, TMA and the next tile's loads
// in flight are left for a later version.
//
// Work division: one block of 4 warps per (query-head row, 64-row query
// tile), each warp 16 query rows, as flash_fwd.cu; a loop over 64-key
// tiles inside the block replaces the TPU grid's sequential kv axis. Row
// i reads kv row i / group (GQA). Each row carries its own q_offset and
// k_offset, so one launch serves every rank of a world whose rows are
// flattened (rank, batch, head).
//
// Numerics follow the TPU kernel step by step: q * scale rounded to the
// input type before QK^T (the wrapper passes scale already rounded), f32
// scores, -inf where the global key position passes the query's, the
// m_safe / corr guards of _online_step, p rounded to v's type before PV,
// f32 state.

#include "flash_common.cuh"

#include <atomic>
#include <cmath>
#include <type_traits>

namespace {

using namespace gtt;

constexpr int kBlockQ = 64;  // query rows per block
constexpr int kBlockK = 64;  // keys per kv tile
constexpr int kWarps = kBlockQ / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kPLd = kBlockK + 4;  // row stride of the f32 path's p tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* acc_in;  // (bh, t_q, d) contiguous
  const float* m_in;    // (bh, t_q) contiguous
  const float* l_in;
  float* acc_out;
  float* m_out;
  float* l_out;
  const int* q_off;  // (bh,) global position of each row's first query
  const int* k_off;  // (bh,) global position of each row's first key
  int group, tq, tkv;
  int causal;
  float scale;  // 1 / sqrt(d), already rounded to the input type
  long long q_sr, q_st;  // strides in elements; d is contiguous
  long long k_sr, k_st;
  long long v_sr, v_st;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_step_kernel(const Params p) {
  constexpr bool kBf16 = std::is_same_v<T, __nv_bfloat16>;
  constexpr int kLd = D + 16 / sizeof(T);  // 16 bytes of row padding
  constexpr int kNT = kBlockK / 8;         // 8-key slices of a score tile
  constexpr int kDT = D / 8;               // 8-column slices of the state

  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + kBlockQ * kLd;
  T* vs = ks + kBlockK * kLd;
  float* ps = reinterpret_cast<float*>(vs + kBlockK * kLd);  // f32 path

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;
  const int row = blockIdx.y;
  const int qo = p.q_off[row];
  const int ko = p.k_off[row];
  const T* qg = static_cast<const T*>(p.q) + row * p.q_sr;
  const T* kg = static_cast<const T*>(p.k) + (row / p.group) * p.k_sr;
  const T* vg = static_cast<const T*>(p.v) + (row / p.group) * p.v_sr;
  const long long state = static_cast<long long>(row) * p.tq;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int c2 = 2 * (lane % 4);
  const int r0 = warp * 16 + g;  // this lane's tile rows: r0 and r0 + 8

  // The carried state of this lane's two rows; rows past t_q start empty
  // and are never stored.
  float o[kDT][4];
  float m[2], l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + r0 + 8 * i;
    const bool in = r < p.tq;
    m[i] = in ? p.m_in[state + r] : -INFINITY;
    l[i] = in ? p.l_in[state + r] : 0.f;
#pragma unroll
    for (int j = 0; j < kDT; ++j) {
      float2 a = make_float2(0.f, 0.f);
      if (in) {
        a = *reinterpret_cast<const float2*>(p.acc_in + (state + r) * D +
                                             j * 8 + c2);
      }
      o[j][2 * i] = a.x;
      o[j][2 * i + 1] = a.y;
    }
  }

  const int n_kv = (p.tkv + kBlockK - 1) / kBlockK;
  // Causal: key tiles whose first global position lies past the tile's
  // last query are never visited.
  int kv_end = n_kv;
  if (p.causal) {
    const int reach = qo + q0 + kBlockQ - 1 - ko;
    kv_end = reach < 0 ? 0 : min(n_kv, reach / kBlockK + 1);
  }

  if (kv_end > 0) {
    load_tile<T, D, kLd, kBlockQ, kThreads, true>(qs, qg, p.q_st, q0, p.tq,
                                                  p.scale);
  }
  __syncthreads();

  for (int kb = 0; kb < kv_end; ++kb) {
    const int k0 = kb * kBlockK;
    __syncthreads();  // every warp is done with the previous k/v tile
    load_tile<T, D, kLd, kBlockK, kThreads, false>(ks, kg, p.k_st, k0, p.tkv,
                                                   1.f);
    load_tile<T, D, kLd, kBlockK, kThreads, false>(vs, vg, p.v_st, k0, p.tkv,
                                                   1.f);
    __syncthreads();

    // s = (q * scale) k^T in f32.
    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    warp_product<T, D, kNT, kLd, 1, 1, kLd>(s, qs + warp * 16 * kLd, ks);

    // Only tiles that cross the global diagonal or the ragged end pay the
    // mask.
    const bool crosses_diag = p.causal && ko + k0 + kBlockK - 1 > qo + q0;
    if (crosses_diag || k0 + kBlockK > p.tkv) {
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = q0 + r0 + (e >= 2 ? 8 : 0);
          const int col = k0 + j * 8 + c2 + (e & 1);
          if (col >= p.tkv || (p.causal && ko + col > qo + r)) {
            s[j][e] = -INFINITY;
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

    // o += p v, with p in v's type.
    if constexpr (kBf16) {
      // Two adjacent 8-key slices of the accumulator are the A fragment of
      // one 16-key step, so p never leaves registers.
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        const uint32_t a[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int j = 0; j < kDT; ++j) {
          const T* bp = vs + (kk * 16 + c2) * kLd + j * 8 + g;
          mma_bf16(o[j], a, pack_bf16(bp[0], bp[kLd]),
                   pack_bf16(bp[8 * kLd], bp[9 * kLd]));
        }
      }
    } else {
      // f32: the warp's 16 rows of p go through its own slice of shared
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
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + r0 + 8 * i;
    if (r >= p.tq) continue;
#pragma unroll
    for (int j = 0; j < kDT; ++j) {
      store2(p.acc_out + (state + r) * D + j * 8 + c2, o[j][2 * i],
             o[j][2 * i + 1]);
    }
    if (c2 == 0) {
      p.m_out[state + r] = m[i];
      p.l_out[state + r] = l[i];
    }
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, int bh, cudaStream_t stream) {
  constexpr int kLd = D + 16 / sizeof(T);
  constexpr size_t kSmem =
      (kBlockQ + 2 * kBlockK) * kLd * sizeof(T) +
      (std::is_same_v<T, float> ? kBlockQ * kPLd * sizeof(float) : 0);
  static std::atomic<bool> smem_set[kMaxDevices];
  const cudaError_t attr =
      allow_dynamic_smem(flash_step_kernel<T, D>, kSmem, smem_set);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.tq + kBlockQ - 1) / kBlockQ, bh);
  flash_step_kernel<T, D><<<grid, kThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t; 0 is success. dtype: 0 = bf16, 1 = f32. The
// state in and out may not overlap.
int gtt_flash_step(const void* q, const void* k, const void* v,
                   const void* acc_in, const void* m_in, const void* l_in,
                   void* acc_out, void* m_out, void* l_out, const void* q_off,
                   const void* k_off, int dtype, int bh, int group, int tq,
                   int tkv, int d, int causal, float scale, long long q_sr,
                   long long q_st, long long k_sr, long long k_st,
                   long long v_sr, long long v_st, void* stream) {
  if (bh < 1 || bh > 65535 || group < 1 || bh % group != 0 || tq < 1 ||
      tkv < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{q,
           k,
           v,
           static_cast<const float*>(acc_in),
           static_cast<const float*>(m_in),
           static_cast<const float*>(l_in),
           static_cast<float*>(acc_out),
           static_cast<float*>(m_out),
           static_cast<float*>(l_out),
           static_cast<const int*>(q_off),
           static_cast<const int*>(k_off),
           group,
           tq,
           tkv,
           causal,
           scale,
           q_sr,
           q_st,
           k_sr,
           k_st,
           v_sr,
           v_st};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && d == 64) err = launch<__nv_bfloat16, 64>(p, bh, s);
  if (dtype == 0 && d == 128) err = launch<__nv_bfloat16, 128>(p, bh, s);
  if (dtype == 1 && d == 64) err = launch<float, 64>(p, bh, s);
  if (dtype == 1 && d == 128) err = launch<float, 128>(p, bh, s);
  return static_cast<int>(err);
}

const char* gtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
