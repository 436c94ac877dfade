// Flash-attention backward for Hopper (sm_90a), with a plain C interface.
//
// Replaces gloo_tpu/ops/attention.py::_flash_bwd_fused_kernel, the Pallas
// TPU kernel behind flash_attention's custom VJP: dQ, dK and dV from q, k,
// v, the output's cotangent dO, the forward's logsumexp rows (lse) and
// delta = rowsum(dO * O), recomputing every softmax tile from lse rather
// than reading a (t, t) matrix.
//
// What bounds it on an H100: at the flagship training shape (b*h = 32,
// t = 128, d = 64, causal, bf16) q, k, v, dO, dQ, dK and dV are 3.67 MB and
// lse and delta 32 KB, 1.1 us at 3.35 TB/s; the five products over the
// 8256 (q, k) pairs per head that the mask keeps are 169 MFLOP, 0.17 us at
// 989 TFLOP/s. Bytes bound it, and the two launches lie above both. The
// design therefore reads each k and v tile from device memory once per
// block and keeps it in shared memory while the block walks every query
// tile that sees it, never writes s, p, dp or ds to device memory, and
// skips query tiles wholly above the causal diagonal. Products run on the
// tensor cores through mma.sync (bf16) or on the FMA units (f32); wgmma,
// TMA and pipelined loads are left for a shape where products bound it.
//
// Work division: one block of 4 warps per (batch, kv head, 64-key tile);
// 64 blocks at the training shape, where one program per flat query head
// walking every tile pair in order (the TPU grid) would give 32. The block
// loops over the query heads of its GQA group and over their 64-row query
// tiles, starting at the first tile that reaches the diagonal. For each
// query tile warp w owns keys 16w .. 16w + 15 and computes, in registers,
//   s^T = k (q * scale)^T, p^T = exp(s^T - lse), dp^T = v dO^T,
//   ds^T = p^T (dp^T - delta),
// writes p^T and ds^T (rounded to the input type) to shared memory and
// accumulates dV += p^T dO and dK += ds^T (q * scale) in f32 registers.
// The accumulators run over every query head of the group, which is the
// TPU contract "dK/dV group-summed in f32 before the single downcast"
// without a per-query-head buffer or a second pass. Then warp w takes
// query rows 16w .. 16w + 15 of the tile and adds dQ += ds k into an f32
// (b*h, t, d) buffer with atomicAdd: the key tiles of one query row live
// in different blocks. A second kernel scales that buffer and casts it to
// the input type, as the TPU kernel does in its last grid step. The atomics
// make dQ's f32 summation order change from run to run, so dQ agrees with
// the plain version within a tolerance and not bit for bit; dK and dV are
// deterministic.
//
// Numerics follow the TPU kernel step by step: q * scale rounded to the
// input type (the wrapper passes scale already rounded to that type), s
// and dp accumulated in f32, p = exp(s - lse) in f32, p rounded to dO's
// type for dV, ds = p (dp - delta) in f32 and rounded to the input type
// for dK and dQ. dK contracts ds with the scaled q and so carries the
// rounded scale; dQ contracts ds with the unscaled k and takes the
// unrounded f32 1/sqrt(d) at the end (dq_scale): at d = 128 the two differ
// by ~0.1 % in bf16. Rows past t in a ragged last tile are zero in q, dO,
// k and v, and their p is forced to 0 (lse is undefined there, and
// exp(0 - lse) is not 0), so padded rows and keys add nothing anywhere.

#include "flash_common.cuh"

#include <atomic>
#include <cmath>
#include <type_traits>

namespace {

using namespace gtt;

constexpr int kBlockQ = 64;  // query rows per tile
constexpr int kBlockK = 64;  // keys per block
constexpr int kWarps = kBlockK / 16;
constexpr int kThreads = kWarps * 32;
// Query columns of s^T and dp^T a warp holds in registers at once; the
// 64-column tile goes in two halves so that d = 128 fits beside the dK and
// dV accumulators.
constexpr int kChunk = 32;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (b*h, t) contiguous
  const float* delta;  // (b*h, t) contiguous
  float* dq_acc;       // (b*h, t, d) contiguous f32, zero on entry
  void* dk;            // (b*h_kv, t, d) contiguous, input type
  void* dv;
  int h, h_kv, group, t;
  int causal;
  float scale;  // 1 / sqrt(d), already rounded to the input type
  long long q_sb, q_sh, q_st;  // strides in elements; d is contiguous
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long o_sb, o_sh, o_st;  // dO
};

// Two bf16 of a row (kStride == 1) or of a column (their row stride) as
// one mma operand register, the lower index in the low half.
template <int kStride>
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  if constexpr (kStride == 1) {
    return ld_u32(p);
  } else {
    return pack_bf16(p[0], p[kStride]);
  }
}

// acc[j] += A B for the warp's 16 rows of A and the NT 8-column slices of
// B, in the C fragment layout (flash_common.cuh), summed over K. Both
// operands lie in shared memory with compile-time strides:
// A(r, k) = a[r * kAR + k * kAK], B(k, n) = b[k * kBK + n * kBN]. bf16 runs
// on mma.sync, f32 on the FMA units.
template <typename T, int K, int NT, int kAR, int kAK, int kBK, int kBN>
__device__ __forceinline__ void warp_product(float (*acc)[4], const T* a,
                                             const T* b) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int c2 = 2 * (lane % 4);
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
#pragma unroll
    for (int kk = 0; kk < K; kk += 16) {
      const T* ap = a + g * kAR + (kk + c2) * kAK;
      const uint32_t af[4] = {
          ld_pair<kAK>(ap), ld_pair<kAK>(ap + 8 * kAR),
          ld_pair<kAK>(ap + 8 * kAK), ld_pair<kAK>(ap + 8 * kAR + 8 * kAK)};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const T* bp = b + (kk + c2) * kBK + (j * 8 + g) * kBN;
        mma_bf16(acc[j], af, ld_pair<kBK>(bp), ld_pair<kBK>(bp + 8 * kBK));
      }
    }
  } else {
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float x0 = a[g * kAR + k * kAK];
      const float x1 = a[(g + 8) * kAR + k * kAK];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float y0 = b[k * kBK + (j * 8 + c2) * kBN];
        const float y1 = b[k * kBK + (j * 8 + c2 + 1) * kBN];
        acc[j][0] = fmaf(x0, y0, acc[j][0]);
        acc[j][1] = fmaf(x0, y1, acc[j][1]);
        acc[j][2] = fmaf(x1, y0, acc[j][2]);
        acc[j][3] = fmaf(x1, y1, acc[j][3]);
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_kernel(const Params p) {
  constexpr int kLd = D + 16 / sizeof(T);        // k, v, q, dO rows
  constexpr int kLdS = kBlockQ + 16 / sizeof(T);  // p^T, ds^T: [key][query]
  constexpr int kDT = D / 8;
  constexpr int kCT = kChunk / 8;

  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + kBlockK * kLd;
  T* qs = vs + kBlockK * kLd;  // q * scale
  T* os = qs + kBlockQ * kLd;  // dO
  T* pts = os + kBlockQ * kLd;
  T* dsts = pts + kBlockK * kLdS;
  float* lse_s = reinterpret_cast<float*>(dsts + kBlockK * kLdS);
  float* delta_s = lse_s + kBlockQ;

  const int k0 = blockIdx.x * kBlockK;
  const int bk = blockIdx.y;  // flat kv head b * h_kv + hk
  const int b = bk / p.h_kv;
  const int hk = bk % p.h_kv;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int c2 = 2 * (lane % 4);
  const int kr = warp * 16 + g;  // this lane's key rows: kr and kr + 8

  load_tile<T, D, kLd, kBlockK, kThreads, false>(
      ks, static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh, p.k_st, k0,
      p.t, 1.f);
  load_tile<T, D, kLd, kBlockK, kThreads, false>(
      vs, static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh, p.v_st, k0,
      p.t, 1.f);

  float dk[kDT][4];
  float dv[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  }

  const int n_q = (p.t + kBlockQ - 1) / kBlockQ;
  // Causal: query tiles wholly above this key tile's diagonal are skipped.
  const int qi_first = p.causal ? k0 / kBlockQ : 0;
  for (int hq = hk * p.group; hq < (hk + 1) * p.group; ++hq) {
    const long long head = static_cast<long long>(b) * p.h + hq;
    const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + hq * p.q_sh;
    const T* og = static_cast<const T*>(p.dout) + b * p.o_sb + hq * p.o_sh;
    const float* lg = p.lse + head * p.t;
    const float* dg = p.delta + head * p.t;
    float* dqg = p.dq_acc + head * p.t * D;

    for (int qi = qi_first; qi < n_q; ++qi) {
      const int q0 = qi * kBlockQ;
      __syncthreads();  // every warp is done with the previous query tile
      load_tile<T, D, kLd, kBlockQ, kThreads, true>(qs, qg, p.q_st, q0, p.t,
                                                    p.scale);
      load_tile<T, D, kLd, kBlockQ, kThreads, false>(os, og, p.o_st, q0, p.t,
                                                     1.f);
      if (threadIdx.x < kBlockQ) {
        const int row = q0 + threadIdx.x;
        lse_s[threadIdx.x] = row < p.t ? lg[row] : 0.f;
        delta_s[threadIdx.x] = row < p.t ? dg[row] : 0.f;
      }
      __syncthreads();

      // Only tiles that cross the diagonal or a ragged end pay the mask.
      const bool masked = (p.causal && k0 + kBlockK - 1 > q0) ||
                          k0 + kBlockK > p.t || q0 + kBlockQ > p.t;
#pragma unroll
      for (int n0 = 0; n0 < kBlockQ; n0 += kChunk) {
        float s[kCT][4];
        float dp[kCT][4];
#pragma unroll
        for (int j = 0; j < kCT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
        }
        warp_product<T, D, kCT, kLd, 1, 1, kLd>(s, ks + warp * 16 * kLd,
                                                qs + n0 * kLd);
        warp_product<T, D, kCT, kLd, 1, 1, kLd>(dp, vs + warp * 16 * kLd,
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

      // dV += p^T dO and dK += ds^T (q * scale) over the tile's queries.
      warp_product<T, kBlockQ, kDT, kLdS, 1, kLd, 1>(
          dv, pts + warp * 16 * kLdS, os);
      warp_product<T, kBlockQ, kDT, kLdS, 1, kLd, 1>(
          dk, dsts + warp * 16 * kLdS, qs);
      __syncthreads();  // every warp's ds^T rows are written

      // dQ rows q0 + 16 warp + (g, g + 8) += ds k over the block's keys,
      // 32 columns at a time.
#pragma unroll
      for (int c0 = 0; c0 < D; c0 += 32) {
        float dq[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
        }
        warp_product<T, kBlockK, 4, 1, kLdS, kLd, 1>(dq, dsts + warp * 16,
                                                     ks + c0);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = q0 + warp * 16 + g + 8 * i;
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

  T* dkg = static_cast<T*>(p.dk) + static_cast<long long>(bk) * p.t * D;
  T* dvg = static_cast<T*>(p.dv) + static_cast<long long>(bk) * p.t * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + kr + 8 * i;
    if (key >= p.t) continue;
#pragma unroll
    for (int j = 0; j < kDT; ++j) {
      const long long off = static_cast<long long>(key) * D + j * 8 + c2;
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

template <typename T, int D>
cudaError_t launch(const Params& p, int b, void* dq, float dq_scale,
                   cudaStream_t stream) {
  constexpr int kLd = D + 16 / sizeof(T);
  constexpr int kLdS = kBlockQ + 16 / sizeof(T);
  constexpr size_t kSmem = 2 * (kBlockK + kBlockQ) * kLd * sizeof(T) +
                           2 * kBlockK * kLdS * sizeof(T) +
                           2 * kBlockQ * sizeof(float);
  static std::atomic<bool> smem_set[kMaxDevices];
  cudaError_t err =
      allow_dynamic_smem(flash_bwd_kernel<T, D>, kSmem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.t + kBlockK - 1) / kBlockK, b * p.h_kv);
  flash_bwd_kernel<T, D><<<grid, kThreads, kSmem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long pairs = static_cast<long long>(b) * p.h * p.t * D / 2;
  const int blocks = static_cast<int>(
      pairs / 256 + 1 < 4096 ? pairs / 256 + 1 : 4096);
  flash_bwd_dq_kernel<T><<<blocks, 256, 0, stream>>>(
      p.dq_acc, static_cast<T*>(dq), pairs, dq_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t; 0 is success. dtype: 0 = bf16, 1 = f32. scale is
// 1/sqrt(d) rounded to the input type (for q * scale), dq_scale the same in
// f32 (for dQ). dq_acc must be zero; dq, dk and dv are written whole.
int gtt_flash_bwd(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dq_acc, void* dq, void* dk, void* dv, int dtype,
                  int b, int h, int h_kv, int t, int d, int causal,
                  float scale, float dq_scale, long long q_sb, long long q_sh,
                  long long q_st, long long k_sb, long long k_sh,
                  long long k_st, long long v_sb, long long v_sh,
                  long long v_st, long long o_sb, long long o_sh,
                  long long o_st, void* stream) {
  if (b < 1 || h < 1 || h_kv < 1 || h % h_kv != 0 || t < 1 ||
      static_cast<long long>(b) * h > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq_acc = static_cast<float*>(dq_acc);
  p.dk = dk;
  p.dv = dv;
  p.h = h;
  p.h_kv = h_kv;
  p.group = h / h_kv;
  p.t = t;
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
  p.o_sb = o_sb;
  p.o_sh = o_sh;
  p.o_st = o_st;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  if (dtype == 0 && d == 64) err = launch<bf16, 64>(p, b, dq, dq_scale, s);
  if (dtype == 0 && d == 128) err = launch<bf16, 128>(p, b, dq, dq_scale, s);
  if (dtype == 1 && d == 64) err = launch<float, 64>(p, b, dq, dq_scale, s);
  if (dtype == 1 && d == 128) err = launch<float, 128>(p, b, dq, dq_scale, s);
  return static_cast<int>(err);
}

const char* gtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
