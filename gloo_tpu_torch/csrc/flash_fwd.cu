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
// and above both lies the launch itself. The design therefore reads every q, k and v element once
// from device memory per query tile (16-byte loads into shared memory),
// keeps the (64 x 64) score tile and the softmax state in registers, never
// writes scores back, and skips kv tiles above the causal diagonal, so a
// causal forward reads half the keys. Matrix products run on the tensor
// cores through mma.sync (bf16) or on the FMA units (f32); wgmma and TMA
// are left for when a larger shape makes the products the bound.
//
// Work division: one block of 4 warps per (flat query head, 64-row query
// tile); each warp owns 16 query rows. A loop over 64-key tiles inside the
// block replaces the TPU grid's sequential ("arbitrary") kv axis. Score and
// output tiles live in registers in the m16n8 accumulator layout of
// mma.sync: lane (g = lane / 4, c = lane % 4) holds rows g and g + 8 and
// columns 2c, 2c + 1 of every 8-column slice.
//
// Numerics follow the TPU kernel step by step: q * scale rounded to the
// input type before QK^T (the wrapper passes scale already rounded to that
// type), scores accumulated in f32, masked scores -inf with the m_safe /
// corr guards, p rounded to v's type before PV, out = acc / max(l, 1e-30)
// in the input type, lse = m + log(max(l, 1e-30)) in f32. GQA: query head
// hq reads kv head hq / group; k and v are never replicated.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kBlockQ = 64;  // query rows per block
constexpr int kBlockK = 64;  // keys per kv tile
constexpr int kWarps = kBlockQ / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kPLd = kBlockK + 4;  // row stride of the f32 path's p tile
constexpr int kMaxDevices = 64;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;    // (b, h, t, d) contiguous, input type
  float* lse;   // (b, h, t) contiguous
  int h, group, t;
  int causal;
  float scale;  // 1 / sqrt(d), already rounded to the input type
  long long q_sb, q_sh, q_st;  // strides in elements; d is contiguous
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 in one register, lo in the low half (the lower k or n index).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d[0..3] += A (16x16, row) * B (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Copies rows [row0, row0 + kRows) of a (t, D) slice with row stride
// `stride` into shared memory (row stride kLd), 16 bytes per thread and
// step. Rows at or past t are zero, so padded keys contribute 0 * 0 and
// never NaN. With `scale` the values are multiplied and rounded back to T.
template <typename T, int D, int kLd, int kRows, bool kScale>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long stride, int row0, int t,
                                          float scale) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < kRows * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < t) {
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * stride + c);
    }
    if constexpr (kScale) {
      T* e = reinterpret_cast<T*>(&val);
#pragma unroll
      for (int j = 0; j < kVec; ++j) e[j] = from_f32<T>(to_f32(e[j]) * scale);
    }
    *reinterpret_cast<uint4*>(dst + r * kLd + c) = val;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const Params p) {
  constexpr bool kBf16 = std::is_same_v<T, __nv_bfloat16>;
  constexpr int kLd = D + 16 / sizeof(T);  // 16 bytes of row padding
  constexpr int kNT = kBlockK / 8;         // 8-key slices of a score tile
  constexpr int kDT = D / 8;               // 8-column slices of the output

  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + kBlockQ * kLd;
  T* vs = ks + kBlockK * kLd;
  float* ps = reinterpret_cast<float*>(vs + kBlockK * kLd);  // f32 path

  // Highest query tiles first: under the causal mask they are the longest.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;
  const int head = blockIdx.y;  // flat query head b * h + hq
  const int b = head / p.h;
  const int hq = head % p.h;
  const int hk = hq / p.group;
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + hq * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int c2 = 2 * (lane % 4);
  const int r0 = warp * 16 + g;  // this lane's tile rows: r0 and r0 + 8

  load_tile<T, D, kLd, kBlockQ, true>(qs, qg, p.q_st, q0, p.t, p.scale);
  __syncthreads();

  // bf16: the warp's 16 query rows as mma A fragments, for the whole loop.
  uint32_t qf[kBf16 ? D / 16 : 1][4];
  if constexpr (kBf16) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const T* a = qs + r0 * kLd + kk * 16 + c2;
      qf[kk][0] = ld_u32(a);
      qf[kk][1] = ld_u32(a + 8 * kLd);
      qf[kk][2] = ld_u32(a + 8);
      qf[kk][3] = ld_u32(a + 8 * kLd + 8);
    }
  }

  float o[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  const int n_kv = (p.t + kBlockK - 1) / kBlockK;
  // Causal: kv tiles entirely above the diagonal are never visited.
  const int kv_end =
      p.causal ? min(n_kv, (q0 + kBlockQ - 1) / kBlockK + 1) : n_kv;

  for (int kb = 0; kb < kv_end; ++kb) {
    const int k0 = kb * kBlockK;
    __syncthreads();  // every warp is done with the previous k/v tile
    load_tile<T, D, kLd, kBlockK, false>(ks, kg, p.k_st, k0, p.t, 1.f);
    load_tile<T, D, kLd, kBlockK, false>(vs, vg, p.v_st, k0, p.t, 1.f);
    __syncthreads();

    // s = (q * scale) k^T in f32.
    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    if constexpr (kBf16) {
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const T* bp = ks + (j * 8 + g) * kLd + kk * 16 + c2;
          mma_bf16(s[j], qf[kk], ld_u32(bp), ld_u32(bp + 8));
        }
      }
    } else {
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float qa = to_f32(qs[r0 * kLd + d]);
        const float qb = to_f32(qs[(r0 + 8) * kLd + d]);
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const float ka = to_f32(ks[(j * 8 + c2) * kLd + d]);
          const float kb2 = to_f32(ks[(j * 8 + c2 + 1) * kLd + d]);
          s[j][0] = fmaf(qa, ka, s[j][0]);
          s[j][1] = fmaf(qa, kb2, s[j][1]);
          s[j][2] = fmaf(qb, ka, s[j][2]);
          s[j][3] = fmaf(qb, kb2, s[j][3]);
        }
      }
    }

    // Only tiles that cross the diagonal or the ragged end pay the mask.
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

    // Online softmax; a row's 64 scores are spread over the 4 lanes of a
    // quad, so row max and row sum finish with two xor shuffles.
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
      // The accumulator layout of two adjacent 8-key slices is the A
      // fragment layout of one 16-key step, so p never leaves registers.
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
          const float va = to_f32(vs[key * kLd + j * 8 + c2]);
          const float vb = to_f32(vs[key * kLd + j * 8 + c2 + 1]);
          o[j][0] = fmaf(pa, va, o[j][0]);
          o[j][1] = fmaf(pa, vb, o[j][1]);
          o[j][2] = fmaf(pb, va, o[j][2]);
          o[j][3] = fmaf(pb, vb, o[j][3]);
        }
      }
      __syncwarp();  // the next tile rewrites pw
    }
  }

  T* og = static_cast<T*>(p.out) + static_cast<long long>(head) * p.t * D;
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

template <typename T, int D>
cudaError_t launch(const Params& p, int bh, cudaStream_t stream) {
  constexpr int kLd = D + 16 / sizeof(T);
  constexpr size_t kSmem =
      (kBlockQ + 2 * kBlockK) * kLd * sizeof(T) +
      (std::is_same_v<T, float> ? kBlockQ * kPLd * sizeof(float) : 0);
  // Above 48 KB, dynamic shared memory must be allowed per kernel and
  // device. It is allowed once per (T, D) and device, not on every launch:
  // the forward is bound by the host's launches.
  static std::atomic<bool> smem_set[kMaxDevices];
  int dev = 0;
  const cudaError_t got = cudaGetDevice(&dev);
  if (got != cudaSuccess) return got;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!smem_set[dev].load(std::memory_order_acquire)) {
    const cudaError_t attr = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmem));
    if (attr != cudaSuccess) return attr;
    smem_set[dev].store(true, std::memory_order_release);
  }
  const dim3 grid((p.t + kBlockQ - 1) / kBlockQ, bh);
  flash_fwd_kernel<T, D><<<grid, kThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t; 0 is success. dtype: 0 = bf16, 1 = f32.
int gtt_flash_fwd(const void* q, const void* k, const void* v, void* out,
                  void* lse, int dtype, int b, int h, int h_kv, int t, int d,
                  int causal, float scale, long long q_sb, long long q_sh,
                  long long q_st, long long k_sb, long long k_sh,
                  long long k_st, long long v_sb, long long v_sh,
                  long long v_st, void* stream) {
  if (b < 1 || h < 1 || h_kv < 1 || h % h_kv != 0 || t < 1 ||
      static_cast<long long>(b) * h > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{q,    k,    v,    out,  static_cast<float*>(lse),
           h,    h / h_kv,   t,    causal, scale,
           q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = b * h;
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
