// The flash kernels at a head_dim past the instances' 256: B1 (flash_fwd.cu),
// B2 (flash_bwd.cu), B6 (flash_step.cu) and the fused B7a + B7b
// (flash_bwd_step.cu) at any d that is a multiple of 8 above 256 (the
// wrapper zero-pads any other d up to one). Each source wraps these bodies
// in a __global__ of its own name and launches it where d is past 256; the
// instances at 64, 128 and 256 are untouched.
//
// What bounds them on an H100: the FMA units. The products run in f32 on
// the FMA units (67 TFLOP/s), not on wgmma, for bf16, f16 and f32 alike,
// and each block recomputes the scores over the whole d (below), so at
// d = 512 the forward does 5 / 2 and the backward 11 / 5 of the products
// the algorithm needs. A simple design that is right at every d; a Hopper
// redesign (wgmma over TMA-staged tiles, as the instances) is later work.
//
// Why column parts. At d = 512 a 64-row f32 accumulator of the output
// alone is 128 KB, past a thread's registers and most of a block's shared
// memory. So a block owns kPart (128) output columns, a part: the forward's
// o, the backward's dK, dV and dQ. The scores s = q k^T (and the
// backward's dp = dO v^T) contract over all of d, so each part recomputes
// them, staging d through shared memory kChunk (64) columns at a time; the
// part's own columns of v (forward), q, dO and k (backward) are staged
// once per tile. Identical arithmetic in identical order gives every part
// of a row the same scores, running maxima and sums, bit for bit.
//
// The forward (wide::fwd): one block of 4 warps per (flat query head, 64-row
// query tile, part), warp w owning query rows 16 w .. 16 w + 15 in the
// m16n8 accumulator layout of flash_common.cuh. Per visible 64-key tile:
// s over the d chunks, the mask, the online softmax (expf, the m_safe /
// corr guards), p rounded to the input type through shared memory, and
// o += p v over the part's columns. B1 puts the parts on the grid and writes
// out (and lse, from part 0). B6 updates the carried f32 state (acc, m, l)
// in place, so a part may not write m or l while another part of the row
// still has to read them: one B6 block walks every part of its query tile
// in turn, reading (m, l) once at the start and writing them once at the
// end. A query tile that sees no key of the block exits before any load or
// store, as the instances' blocks do.
//
// The backward (wide::bwd): one block of 4 warps per (output row, 64-key
// tile, part), warp w owning keys 16 w .. 16 w + 15. The output row is a kv
// head (B2, and B7's accumulating form: the block walks the query heads of
// its GQA group) or a query head (B7's fresh form). Per visible query tile:
// s^T and dp^T over the d chunks, p^T = exp(s^T - lse) masked to 0,
// ds^T = p^T (dp^T - delta), both to shared memory (p rounded to dO's type
// for B2, unrounded for B7; ds rounded to the input type), then dV += p^T dO
// and dK += ds^T (q * scale) in registers over the part's columns, and
// dQ += ds k for the part's columns added into the f32 dQ buffer with
// atomicAdd (times dq_mul). delta and lse come packed per query tile (the
// prep launches' rows, lse +inf past t_q) or as (rows, t_q) arrays (B7 in
// f32). dO is one operand in the input type, or dO_hi + dO_lo (B7's split
// f32 cotangent, summed in f32 as it is staged).
//
// Numerics follow the instances and the TPU kernels: q * scale rounded to
// the input type, s and dp summed in f32, p rounded to v's (forward) or dO's
// (B2) type before its product, ds rounded to the input type, the f32 state
// and accumulators; dQ's scale is applied by the caller's finish launch or
// through dq_mul. dQ's atomics land in no fixed order, so dQ agrees with the
// plain version within a tolerance and not bit for bit.

#pragma once

#include "flash_common.cuh"

#include <atomic>
#include <cmath>

namespace gtt {
namespace wide {

constexpr int kRows = 64;         // query rows or keys of a tile
constexpr int kThreads = 128;     // 4 warps of 16 rows
constexpr int kChunk = 64;        // columns of d staged at once for s, dp
constexpr int kPart = 128;        // output columns a block owns
constexpr int kLdC = kChunk + 4;  // row stride of a staged chunk (f32)
constexpr int kLdP = kPart + 4;   // row stride of a staged part (f32)
constexpr int kRowsPerTile = 2 * kRows;  // packed rows: lse, then delta

// How stage() turns a loaded value into the staged f32.
enum StageMode { kAsIs = 0, kScaled = 1, kHiLo = 2 };

// Rows [row0, row0 + kRows) and columns [c0, c0 + kW) of a (t, d) matrix of
// T (row stride `stride`, d contiguous) into f32 shared memory of row stride
// kLd, 16 bytes per thread and load. Rows at or past t and columns at or
// past c0 + width are 0. kScaled rounds x * scale to T (q * scale);
// kHiLo adds the same element of `lo` (dO_hi + dO_lo in f32).
template <typename T, int kW, int kLd, int kMode>
__device__ __forceinline__ void stage(float* dst, const T* src,
                                      const T* lo, long long stride,
                                      int row0, int t, int c0, int width,
                                      float scale) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = kW / kVec;
  for (int i = threadIdx.x; i < kRows * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    float x[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) x[j] = 0.f;
    if (row0 + r < t && c < width) {
      const long long at = static_cast<long long>(row0 + r) * stride + c0 + c;
      const uint4 val = *reinterpret_cast<const uint4*>(src + at);
      const T* e = reinterpret_cast<const T*>(&val);
#pragma unroll
      for (int j = 0; j < kVec; ++j) x[j] = to_f32(e[j]);
      if constexpr (kMode == kScaled) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          x[j] = to_f32(from_f32<T>(x[j] * scale));
        }
      }
      if constexpr (kMode == kHiLo) {
        const uint4 lv = *reinterpret_cast<const uint4*>(lo + at);
        const T* el = reinterpret_cast<const T*>(&lv);
#pragma unroll
        for (int j = 0; j < kVec; ++j) x[j] += to_f32(el[j]);
      }
    }
    float* const out = dst + r * kLd + c;
#pragma unroll
    for (int j = 0; j < kVec; j += 4) {
      *reinterpret_cast<float4*>(out + j) =
          make_float4(x[j], x[j + 1], x[j + 2], x[j + 3]);
    }
  }
}

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// Global offsets of query-head row `row`'s first query or key (0 without a
// table).
__device__ __forceinline__ int offset_of(const int* table, long long row) {
  return table == nullptr ? 0 : table[row];
}

// ---- the forward: B1 and B6 ----

struct FwdParams {
  const void* q;  // (b, h, t_q, d): T
  const void* k;  // (b, h_kv, t_kv, d)
  const void* v;
  void* out;    // B1: (rows, t_q, d) contiguous T; B6: null
  float* lse;   // B1: (rows, t_q) contiguous
  float* acc;   // B6: (rows, t_q, acc_ld) contiguous f32; B1: null
  float* m;     // B6: (rows, t_q)
  float* l;
  const int* q_off;  // B6: (rows,) global offsets; B1: null
  const int* k_off;
  int rows;  // b * h (B6: b = 1, h = rows)
  int h, group, tq, tkv, d, acc_ld, causal;
  float scale;  // 1 / sqrt(true d), rounded to T
  long long q_sb, q_sh, q_st;  // strides in elements
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
};

// q and k chunks, v's part, p (f32).
constexpr size_t kFwdSmem =
    (3 * kRows * kLdC + kRows * kLdP) * sizeof(float);

template <typename T>
__device__ __forceinline__ void fwd(const FwdParams& p) {
  constexpr int kNT = kRows / 8;   // 8-key slices of a score tile
  constexpr int kDT = kPart / 8;   // 8-column slices of a part
  const int head = grid_row();
  if (head >= p.rows) return;
  const bool carry = p.acc != nullptr;
  const int n_parts = (p.d + kPart - 1) / kPart;
  const int on_grid = carry ? 1 : n_parts;  // parts per query tile on x
  const int q0 = (gridDim.x / on_grid - 1 - blockIdx.x / on_grid) * kRows;
  const int qo = offset_of(p.q_off, head);
  const int ko = offset_of(p.k_off, head);
  const int n_kv = (p.tkv + kRows - 1) / kRows;
  int kv_end = n_kv;
  if (p.causal) {
    const int reach = qo + min(q0 + kRows, p.tq) - 1 - ko;
    kv_end = reach < 0 ? 0 : min(n_kv, reach / kRows + 1);
  }
  if (kv_end == 0) return;  // nothing visible: the state stays as it is

  extern __shared__ __align__(16) unsigned char smem[];
  float* const qc = reinterpret_cast<float*>(smem);
  float* const kc = qc + kRows * kLdC;
  float* const ps = kc + kRows * kLdC;
  float* const vp = ps + kRows * kLdC;

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
  const long long base = static_cast<long long>(head) * p.tq;

  float m0[2], l0[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + r0 + 8 * i;
    const bool in = carry && r < p.tq;
    m0[i] = in ? p.m[base + r] : -INFINITY;
    l0[i] = in ? p.l[base + r] : 0.f;
  }
  const int first = carry ? 0 : blockIdx.x % on_grid;
  const int last = carry ? n_parts : first + 1;
  float m[2], l[2];
  for (int part = first; part < last; ++part) {
    const int c_lo = part * kPart;
    const int width = min(kPart, p.d - c_lo);
    float o[kDT][4];
#pragma unroll
    for (int j = 0; j < kDT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = q0 + r0 + (e >= 2 ? 8 : 0);
        const int col = c_lo + j * 8 + c2 + (e & 1);
        o[j][e] = carry && r < p.tq && col < p.acc_ld
                      ? p.acc[(base + r) * p.acc_ld + col]
                      : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[i] = m0[i];
      l[i] = l0[i];
    }

    for (int kb = 0; kb < kv_end; ++kb) {
      const int k0 = kb * kRows;
      // s = (q * scale) k^T in f32, over d in chunks.
      float s[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      for (int c0 = 0; c0 < p.d; c0 += kChunk) {
        const int cw = min(kChunk, p.d - c0);
        __syncthreads();  // every warp is done with the previous chunk
        stage<T, kChunk, kLdC, kScaled>(qc, qg, nullptr, p.q_st, q0, p.tq,
                                        c0, cw, p.scale);
        stage<T, kChunk, kLdC, kAsIs>(kc, kg, nullptr, p.k_st, k0, p.tkv,
                                      c0, cw, 1.f);
        __syncthreads();
        warp_fma<kChunk, kNT, kLdC, 1, 1, kLdC>(s, qc + warp * 16 * kLdC,
                                                 kc);
      }

      const bool crosses = p.causal && ko + k0 + kRows - 1 > qo + q0;
      if (crosses || k0 + kRows > p.tkv) {
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

      // p in v's type through the warp's own rows of shared memory (each
      // lane holds only part of a row), and the part's columns of v.
      float* const pw = ps + warp * 16 * kLdC;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        pw[g * kLdC + j * 8 + c2] = round_to<T>(s[j][0]);
        pw[g * kLdC + j * 8 + c2 + 1] = round_to<T>(s[j][1]);
        pw[(g + 8) * kLdC + j * 8 + c2] = round_to<T>(s[j][2]);
        pw[(g + 8) * kLdC + j * 8 + c2 + 1] = round_to<T>(s[j][3]);
      }
      stage<T, kPart, kLdP, kAsIs>(vp, vg, nullptr, p.v_st, k0, p.tkv,
                                   c_lo, width, 1.f);
      __syncthreads();
      // o += p v.
      warp_fma<kRows, kDT, kLdC, 1, kLdP, 1>(o, pw, vp);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = q0 + r0 + 8 * i;
      if (r >= p.tq) continue;
      const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < kDT; ++j) {
        if (j * 8 >= width) continue;
        const int col = c_lo + j * 8 + c2;
        if (carry) {
          float* const at = p.acc + (base + r) * p.acc_ld + col;
          if (col < p.acc_ld) at[0] = o[j][2 * i];
          if (col + 1 < p.acc_ld) at[1] = o[j][2 * i + 1];
        } else {
          store2(static_cast<T*>(p.out) + (base + r) * p.d + col,
                 o[j][2 * i] / den, o[j][2 * i + 1] / den);
        }
      }
      if (!carry && part == 0 && c2 == 0) p.lse[base + r] = m[i] + logf(den);
    }
    __syncthreads();  // the next part restages every buffer
  }
  if (carry) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = q0 + r0 + 8 * i;
      if (r < p.tq && c2 == 0) {
        p.m[base + r] = m[i];
        p.l[base + r] = l[i];
      }
    }
  }
}

// One launch of a forward kernel: B1's parts on grid x beside the query
// tiles, B6's walked inside each block.
template <typename Kernel>
cudaError_t launch_fwd(Kernel kernel, const FwdParams& p, cudaStream_t s,
                       std::atomic<bool>* smem_set) {
  const cudaError_t attr = allow_dynamic_smem(kernel, kFwdSmem, smem_set);
  if (attr != cudaSuccess) return attr;
  const int parts = p.acc != nullptr ? 1 : (p.d + kPart - 1) / kPart;
  const dim3 grid = rows_grid((p.tq + kRows - 1) / kRows * parts, p.rows);
  kernel<<<grid, kThreads, kFwdSmem, s>>>(p);
  return cudaGetLastError();
}

// ---- the backward: B2 and the fused B7 ----

struct BwdParams {
  const void* q;        // (b, h, t_q, d): T
  const void* k;        // (b, h_kv, t_kv, d)
  const void* v;
  const void* dout;     // (b, h, t_q, d) at the o_* strides: T
  const void* dout_lo;  // dO_lo beside dO_hi (same strides), or null
  const float* rows;    // (b * h, n_q, kRowsPerTile): lse, delta; or null
  const float* lse;     // (b * h, t_q) when rows is null
  const float* delta;
  const int* q_off;  // (b * h,) global offsets, or null
  const int* k_off;
  float* dq;  // (b * h, t_q, d) f32: += dQ * dq_mul (atomics)
  void* dk;   // (out_rows, t_kv, d) contiguous: OutT
  void* dv;
  int out_rows;  // blocks' rows: kv heads or query heads
  int hpb;       // query heads per output row, its query rows hpb r + j
  int h, h_kv, group, tq, tkv, d, n_q;
  int causal, accumulate, round_p;
  float scale;   // 1 / sqrt(true d), rounded to T
  float dq_mul;  // what dQ is multiplied by before it is added
  long long q_sb, q_sh, q_st;  // strides in elements
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long o_sb, o_sh, o_st;
};

// The d chunks of k, v, q, dO (reused for the part's q and dO), k's part,
// p^T and ds^T, lse and delta.
constexpr size_t kBwdSmem =
    (4 * kRows * kLdC + kRows * kLdP + 2 * kRows * kLdC + 2 * kRows) *
    sizeof(float);
static_assert(4 * kLdC >= 2 * kLdP, "q's and dO's parts fit the chunks");

template <typename T, typename OutT>
__device__ __forceinline__ void bwd(const BwdParams& p) {
  constexpr int kNT = kRows / 8;  // 8-query slices of s^T and dp^T
  constexpr int kDT = kPart / 8;  // 8-column slices of a part
  const int r = grid_row();
  if (r >= p.out_rows) return;
  const int n_parts = (p.d + kPart - 1) / kPart;
  const int part = blockIdx.x % n_parts;
  const int k0 = blockIdx.x / n_parts * kRows;
  const int c_lo = part * kPart;
  const int width = min(kPart, p.d - c_lo);

  extern __shared__ __align__(16) unsigned char smem[];
  float* const kc = reinterpret_cast<float*>(smem);
  float* const vc = kc + kRows * kLdC;
  float* const qc = vc + kRows * kLdC;
  float* const oc = qc + kRows * kLdC;
  float* const qp = kc;  // the part's q * scale, once s^T and dp^T are done
  float* const op = kc + kRows * kLdP;  // the part's dO
  float* const kp = oc + kRows * kLdC;
  float* const pts = kp + kRows * kLdP;  // p^T [key][query]
  float* const dsts = pts + kRows * kLdC;  // ds^T
  float* const lse_s = dsts + kRows * kLdC;
  float* const delta_s = lse_s + kRows;

  const int kvh = r * p.hpb / p.group;  // flat kv head
  const long long kvb = kvh / p.h_kv;
  const long long hk = kvh % p.h_kv;
  const T* kg = static_cast<const T*>(p.k) + kvb * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + kvb * p.v_sb + hk * p.v_sh;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int c2 = 2 * (lane % 4);
  const int kr = warp * 16 + g;  // this lane's key rows: kr and kr + 8

  stage<T, kPart, kLdP, kAsIs>(kp, kg, nullptr, p.k_st, k0, p.tkv, c_lo,
                               width, 1.f);
  float dk[kDT][4];
  float dv[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  }

  for (int jh = 0; jh < p.hpb; ++jh) {
    const long long qh = static_cast<long long>(r) * p.hpb + jh;
    const long long b = qh / p.h;
    const long long hq = qh % p.h;
    const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + hq * p.q_sh;
    const long long o_at = b * p.o_sb + hq * p.o_sh;
    const T* og = static_cast<const T*>(p.dout) + o_at;
    const T* olo = p.dout_lo == nullptr
                       ? nullptr
                       : static_cast<const T*>(p.dout_lo) + o_at;
    const int qo = offset_of(p.q_off, qh);
    const int ko = offset_of(p.k_off, qh);
    int qi = 0;
    if (p.causal) {  // query tiles wholly above the diagonal are skipped
      const int gap = ko + k0 - qo - (kRows - 1);
      qi = gap <= 0 ? 0 : min(p.n_q, (gap + kRows - 1) / kRows);
    }
    for (; qi < p.n_q; ++qi) {
      const int q0 = qi * kRows;
      // s^T = k (q * scale)^T and dp^T = v dO^T in f32, over d in chunks.
      float s[kNT][4];
      float dp[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      }
      for (int c0 = 0; c0 < p.d; c0 += kChunk) {
        const int cw = min(kChunk, p.d - c0);
        __syncthreads();  // every warp is done with the previous stage
        stage<T, kChunk, kLdC, kAsIs>(kc, kg, nullptr, p.k_st, k0, p.tkv, c0,
                                      cw, 1.f);
        stage<T, kChunk, kLdC, kAsIs>(vc, vg, nullptr, p.v_st, k0, p.tkv, c0,
                                      cw, 1.f);
        stage<T, kChunk, kLdC, kScaled>(qc, qg, nullptr, p.q_st, q0, p.tq,
                                        c0, cw, p.scale);
        if (olo == nullptr) {
          stage<T, kChunk, kLdC, kAsIs>(oc, og, nullptr, p.o_st, q0, p.tq,
                                        c0, cw, 1.f);
        } else {
          stage<T, kChunk, kLdC, kHiLo>(oc, og, olo, p.o_st, q0, p.tq, c0,
                                        cw, 1.f);
        }
        if (c0 == 0) {
          for (int i = threadIdx.x; i < kRows; i += kThreads) {
            const int row = q0 + i;
            if (p.rows != nullptr) {
              const float* tile =
                  p.rows + (qh * p.n_q + qi) * kRowsPerTile;
              lse_s[i] = tile[i];
              delta_s[i] = tile[kRows + i];
            } else {
              lse_s[i] = row < p.tq ? p.lse[qh * p.tq + row] : INFINITY;
              delta_s[i] = row < p.tq ? p.delta[qh * p.tq + row] : 0.f;
            }
          }
        }
        __syncthreads();
        warp_fma<kChunk, kNT, kLdC, 1, 1, kLdC>(s, kc + warp * 16 * kLdC,
                                                 qc);
        warp_fma<kChunk, kNT, kLdC, 1, 1, kLdC>(dp, vc + warp * 16 * kLdC,
                                                 oc);
      }

      const bool masked = (p.causal && ko + k0 + kRows - 1 > qo + q0) ||
                          k0 + kRows > p.tkv || q0 + kRows > p.tq;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + c2 + (e & 1);  // query in the tile
          const int key = k0 + kr + (e >= 2 ? 8 : 0);
          const int query = q0 + col;
          float pe = expf(s[j][e] - lse_s[col]);
          if (masked && (key >= p.tkv || query >= p.tq ||
                         (p.causal && ko + key > qo + query))) {
            pe = 0.f;
          }
          const float ds = pe * (dp[j][e] - delta_s[col]);
          const int at = (kr + (e >= 2 ? 8 : 0)) * kLdC + col;
          pts[at] = p.round_p ? round_to<T>(pe) : pe;
          dsts[at] = round_to<T>(ds);
        }
      }
      __syncthreads();  // p^T and ds^T whole; the chunks are free
      stage<T, kPart, kLdP, kScaled>(qp, qg, nullptr, p.q_st, q0, p.tq, c_lo,
                                     width, p.scale);
      if (olo == nullptr) {
        stage<T, kPart, kLdP, kAsIs>(op, og, nullptr, p.o_st, q0, p.tq, c_lo,
                                     width, 1.f);
      } else {
        stage<T, kPart, kLdP, kHiLo>(op, og, olo, p.o_st, q0, p.tq, c_lo,
                                     width, 1.f);
      }
      __syncthreads();

      // dV += p^T dO and dK += ds^T (q * scale) over the tile's queries.
      warp_fma<kRows, kDT, kLdC, 1, kLdP, 1>(dv, pts + warp * 16 * kLdC, op);
      warp_fma<kRows, kDT, kLdC, 1, kLdP, 1>(dk, dsts + warp * 16 * kLdC,
                                             qp);
      // dQ rows q0 + 16 w + (g, g + 8) += ds k over the block's keys.
      float dqa[kDT][4];
#pragma unroll
      for (int j = 0; j < kDT; ++j) {
        dqa[j][0] = dqa[j][1] = dqa[j][2] = dqa[j][3] = 0.f;
      }
      warp_fma<kRows, kDT, 1, kLdC, kLdP, 1>(dqa, dsts + warp * 16, kp);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = q0 + warp * 16 + g + 8 * i;
        if (row >= p.tq) continue;
        float* const dst = p.dq + (qh * p.tq + row) * p.d + c_lo + c2;
#pragma unroll
        for (int j = 0; j < kDT; ++j) {
          if (j * 8 >= width) continue;
          atomicAdd(dst + j * 8, dqa[j][2 * i] * p.dq_mul);
          atomicAdd(dst + j * 8 + 1, dqa[j][2 * i + 1] * p.dq_mul);
        }
      }
    }
  }

  OutT* const dkg = static_cast<OutT*>(p.dk);
  OutT* const dvg = static_cast<OutT*>(p.dv);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + kr + 8 * i;
    if (key >= p.tkv) continue;
#pragma unroll
    for (int j = 0; j < kDT; ++j) {
      if (j * 8 >= width) continue;
      const long long off = (static_cast<long long>(r) * p.tkv + key) * p.d +
                            c_lo + j * 8 + c2;
      float a0 = dk[j][2 * i], a1 = dk[j][2 * i + 1];
      float b0 = dv[j][2 * i], b1 = dv[j][2 * i + 1];
      if (p.accumulate) {  // f32 carriers: this block owns its tile
        a0 += to_f32(dkg[off]);
        a1 += to_f32(dkg[off + 1]);
        b0 += to_f32(dvg[off]);
        b1 += to_f32(dvg[off + 1]);
      }
      store2(dkg + off, a0, a1);
      store2(dvg + off, b0, b1);
    }
  }
}

// One launch of a backward kernel: grid x runs over (64-key tile, part),
// the output rows over y and z.
template <typename Kernel>
cudaError_t launch_bwd(Kernel kernel, const BwdParams& p, cudaStream_t s,
                       std::atomic<bool>* smem_set) {
  const cudaError_t attr = allow_dynamic_smem(kernel, kBwdSmem, smem_set);
  if (attr != cudaSuccess) return attr;
  const long long x = static_cast<long long>((p.tkv + kRows - 1) / kRows) *
                      ((p.d + kPart - 1) / kPart);
  if (x >= (1LL << 31)) return cudaErrorInvalidValue;
  const dim3 grid = rows_grid(static_cast<int>(x), p.out_rows);
  kernel<<<grid, kThreads, kBwdSmem, s>>>(p);
  return cudaGetLastError();
}

// Whether d takes the wide kernels: past the instances' 256, a multiple
// of 8 (16-byte rows in every type).
inline bool takes(int d) { return d > 256 && d % 8 == 0; }

}  // namespace wide
}  // namespace gtt
