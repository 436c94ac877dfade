// Collective matmuls for Hopper (sm_90a), with a plain C interface.
//
// Replaces two Pallas TPU kernels of gloo_tpu/ops/overlap.py:
//   B5a _matmul_rs_kernel  (matmul_reduce_scatter)  gtt_matmul_rs
//   B5b _ag_matmul_kernel  (allgather_matmul)       gtt_ag_matmul
//
// As in ring.cu, the ranks are a world on one card: rank r's operands,
// outputs, comm slots and flags are its own buffers in device memory, its
// part of the ring runs as its own thread blocks, and the kernel sees them
// through a table of per-rank pointers and the ring tables (ring index,
// right and left flat rank of every rank). A "send to the right neighbour"
// is a store into that rank's buffer, published with a flag
// (ring_common.cuh).
//
// B5a, rows [my m/n, (my + 1) m/n) of sum_d X_d @ W_d, step for step as the
// TPU kernel: rank `my` stages partial(my - 1); at step s = 0 .. n - 2 it
// pushes its staged running sum into the right neighbour's comm slot
// s mod 2, computes partial(my - 2 - s) (before it waits: the overlap the
// TPU kernel is for), waits for the left neighbour's running sum in its
// own slot, adds tot = comm + partial and stages tot for the next step, or
// writes it as the output at s = n - 2; then it acks the slot to the left.
// A slot is reused (s >= 2) only after the right neighbour's ack; the last
// acks are drained. partial(b) = X[b chunk : (b + 1) chunk] @ W accumulated
// in f32 and rounded to the element type before the add, and the add is
// one f32 add rounded once, as the TPU kernel's comm[slot] + p.
//
// B5b, gather_rows(X) @ W and the gathered X: rank `my` copies its own x
// into gx[my]; at step s it forwards chunk my - s into the right
// neighbour's gx at the same offset (one flag per step) and computes
// y[my - s] = chunk @ W; after the walk it computes the last chunk,
// my - (n - 1). y is rounded to the element type per chunk; gx is an exact
// copy.
//
// Work division: grid (P, S). Block (r, j) plays rank r on the row strips
// t = j, j + S, ... of every chunk (strips of 16 rows); each slice is an
// independent ring with its own flags, and a strip belongs to the same
// slice on every rank, so a block waits only on the matching block of its
// left neighbour. Every block spins on flags other blocks set, so all must
// be resident at once: the launch is cooperative and the wrapper takes S
// from the occupancy that gtt_overlap_max_blocks reports for these very
// kernels (their shared memory and registers included); a grid that cannot
// be resident is refused and the wrapper raises.
//
// The products are computed here, in the block: a strip of 16 rows times
// 128 columns per pass, each of the 4 warps one 16 x 32 tile, the depth
// staged through shared memory 256 bytes of a row at a time (bf16 128, f32
// 64). Both operands are staged as they lie, W row-major, in 16-byte units
// where strides and alignment allow (element by element otherwise), all of
// a pass's loads issued before its first store; the mma fragments pack W's
// depth pairs from shared memory. bf16 runs mma.sync m16n8k16 with f32
// accumulation; f32 runs FMA in the same fragment layout (no TF32). Rows,
// columns and depth past the operands' ends are zero-filled and never
// stored, so chunks of 8 rows, a depth of 16 and any column count are
// taken.
//
// What bounds it on an H100: at the fused MLP's shape (4 ranks, 256 rows
// per rank, d_model 256, 256 columns per rank, bf16) bytes: B5b reads x and
// W (1 MB) and writes y and gx (4.2 MB), 1.6 us at 3.35 TB/s, against 0.54
// GFLOP (0.5 us at 989 TFLOP/s); B5a reads 2.6 MB and writes 0.5 MB, 0.9
// us. Both are latency-bound: a block's products and ring steps run in
// sequence (n - 1 flag round trips, each step's product behind the left
// neighbour's), one block per strip and rank (64 blocks at that shape on
// 132 SMs), every pass a load-barrier-compute-barrier round with no
// cp.async/TMA double buffering and no wgmma, and W re-read from L2 for
// every strip.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "flash_common.cuh"
#include "ring_common.cuh"

namespace {

using namespace gtt;

constexpr int kThreads = 128;    // 4 warps
constexpr int kStripRows = 16;   // one mma row tile
constexpr int kPassCols = 128;   // 4 warps x 32 columns
// Depth staged in shared memory per pass: 256 bytes of a row (bf16 128,
// f32 64), so that a pass keeps many loads in flight before its barrier.
template <typename T>
constexpr int kDepth = 256 / sizeof(T);
// Shared row strides (elements) of the staged x strip (kStripRows x depth)
// and w tile (depth x kPassCols): rows stay 16-byte aligned, and the
// padding spreads a fragment's loads over the banks.
template <typename T>
constexpr int kLdA = kDepth<T> + 8;
constexpr int kLdB = kPassCols + 8;

struct Params {
  // The peer table: rank r's buffers. x: B5a (n rows, k), B5b (rows, k),
  // contiguous; w: (k, cols) at element strides w_sk, w_sn; out: B5a
  // (rows, cols), B5b y (n rows, cols); gx: B5b (n rows, k); stage, comm:
  // B5a 2 x (rows, cols) each; flags: slices x flag_stride ints.
  const void* x[kMaxRanks];
  const void* w[kMaxRanks];
  void* out[kMaxRanks];
  void* gx[kMaxRanks];
  void* stage[kMaxRanks];
  void* comm[kMaxRanks];
  int* flags[kMaxRanks];
  int my[kMaxRanks];
  int right[kMaxRanks];
  int left[kMaxRanks];
  int n;
  int flag_stride;
  int rows;  // rows of one chunk
  int k;
  int cols;
  long long w_sk;
  long long w_sn;
};

// The bits of one element, for cache-global loads and stores.
template <typename T>
struct Bits;
template <>
struct Bits<float> {
  using type = float;
};
template <>
struct Bits<__nv_bfloat16> {
  using type = unsigned short;
};

// An element another block may have written during this launch: read
// through L2 (an SM's L1 is not coherent with stores from other SMs).
template <typename T>
__device__ __forceinline__ T load_cg(const T* p) {
  using B = typename Bits<T>::type;
  const B b = __ldcg(reinterpret_cast<const B*>(p));
  T v;
  memcpy(&v, &b, sizeof(T));
  return v;
}

template <typename T>
__device__ __forceinline__ void store_cg(T* p, T v) {
  using B = typename Bits<T>::type;
  B b;
  memcpy(&b, &v, sizeof(T));
  __stcg(reinterpret_cast<B*>(p), b);
}

__device__ __forceinline__ bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) &
          15) == 0;
}

// dst[0, count) = src[0, count), through L2 both ways: 16-byte units where
// both ends are aligned, then the tail element by element.
template <typename T>
__device__ void copy_range(T* dst, const T* src, long long count) {
  long long done = 0;
  if (aligned16(dst, src)) {
    constexpr int kVec = 16 / sizeof(T);
    const long long units = count / kVec;
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (long long u = threadIdx.x; u < units; u += kThreads) {
      __stcg(d + u, __ldcg(s + u));
    }
    done = units * kVec;
  }
  for (long long i = done + threadIdx.x; i < count; i += kThreads) {
    store_cg(dst + i, load_cg(src + i));
  }
}

// dst[i] = got[i] + dst[i] over [0, count): one add per element (add1).
// got is another block's comm slot; dst this block's own staging.
template <typename T>
__device__ void add_range(T* dst, const T* got, long long count) {
  long long done = 0;
  if (aligned16(dst, got)) {
    constexpr int kVec = 16 / sizeof(T);
    const long long units = count / kVec;
    const uint4* g = reinterpret_cast<const uint4*>(got);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (long long u = threadIdx.x; u < units; u += kThreads) {
      d[u] = add_units<T>(__ldcg(g + u), d[u]);
    }
    done = units * kVec;
  }
  for (long long i = done + threadIdx.x; i < count; i += kThreads) {
    dst[i] = add1(load_cg(got + i), dst[i]);
  }
}

// dst[0:valid, 0:cols] = a[0:valid, 0:k] @ w, accumulated in f32 and
// rounded to T. a: contiguous rows of k (read through L2); w: element
// (kk, c) at w[kk * sk + c * sn]; dst: contiguous rows of cols. Both
// operands are staged in shared memory as they lie (w row-major), in
// 16-byte units where the strides and the start allow it, element by
// element otherwise; the mma fragments of w pack their pairs from there.
template <typename T>
__device__ void strip_product(const T* a, int valid, const T* w, long long sk,
                              long long sn, int k, int cols, T* dst, T* as,
                              T* bs) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int depth = kDepth<T>, lda = kLdA<T>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const T zero = from_f32<T>(0.f);
  const uint4 zeros = make_uint4(0u, 0u, 0u, 0u);
  const bool vec_a = k % kVec == 0 && aligned16(a, a);
  const bool vec_w = sn == 1 && sk % kVec == 0 && cols % kVec == 0 &&
                     aligned16(w, w);
  for (int n0 = 0; n0 < cols; n0 += kPassCols) {
    float acc[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    }
    for (int k0 = 0; k0 < k; k0 += depth) {
      __syncthreads();  // the previous pass is done with as and bs
      // All of a pass's loads are issued before the first store to shared
      // memory, so that they are in flight together.
      if (vec_a) {
        constexpr int kPerRow = depth / kVec;
        constexpr int kLoads = kStripRows * kPerRow / kThreads;
        uint4 v[kLoads];
#pragma unroll
        for (int j = 0; j < kLoads; ++j) {
          const int i = threadIdx.x + j * kThreads;
          const int row = i / kPerRow, kk = i % kPerRow * kVec;
          v[j] = row < valid && k0 + kk < k
                     ? __ldcg(reinterpret_cast<const uint4*>(
                           a + static_cast<long long>(row) * k + k0 + kk))
                     : zeros;
        }
#pragma unroll
        for (int j = 0; j < kLoads; ++j) {
          const int i = threadIdx.x + j * kThreads;
          *reinterpret_cast<uint4*>(as + i / kPerRow * lda +
                                    i % kPerRow * kVec) = v[j];
        }
      } else {
        for (int i = threadIdx.x; i < kStripRows * depth; i += kThreads) {
          const int row = i / depth, kk = i % depth;
          as[row * lda + kk] =
              row < valid && k0 + kk < k
                  ? load_cg(a + static_cast<long long>(row) * k + k0 + kk)
                  : zero;
        }
      }
      if (vec_w) {
        constexpr int kPerRow = kPassCols / kVec;
        constexpr int kLoads = depth * kPerRow / kThreads;
        uint4 v[kLoads];
#pragma unroll
        for (int j = 0; j < kLoads; ++j) {
          const int i = threadIdx.x + j * kThreads;
          const int kk = i / kPerRow, col = i % kPerRow * kVec;
          v[j] = n0 + col < cols && k0 + kk < k
                     ? *reinterpret_cast<const uint4*>(w + (k0 + kk) * sk +
                                                       n0 + col)
                     : zeros;
        }
#pragma unroll
        for (int j = 0; j < kLoads; ++j) {
          const int i = threadIdx.x + j * kThreads;
          *reinterpret_cast<uint4*>(bs + i / kPerRow * kLdB +
                                    i % kPerRow * kVec) = v[j];
        }
      } else {
        for (int i = threadIdx.x; i < depth * kPassCols; i += kThreads) {
          const int kk = i / kPassCols, col = i % kPassCols;
          bs[kk * kLdB + col] =
              n0 + col < cols && k0 + kk < k
                  ? w[(k0 + kk) * sk + static_cast<long long>(n0 + col) * sn]
                  : zero;
        }
      }
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < depth; ks += 16) {
        if constexpr (sizeof(T) == 2) {
          const uint32_t af[4] = {ld_u32(as + g * lda + ks + 2 * c),
                                  ld_u32(as + (g + 8) * lda + ks + 2 * c),
                                  ld_u32(as + g * lda + ks + 2 * c + 8),
                                  ld_u32(as + (g + 8) * lda + ks + 2 * c + 8)};
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            // Column warp * 32 + nt * 8 + g, depth pairs (2c, 2c + 1) and
            // (2c + 8, 2c + 9), the lower depth in the low half.
            const T* b = bs + (ks + 2 * c) * kLdB + warp * 32 + nt * 8 + g;
            mma_bf16(acc[nt], af, pack_bf16(b[0], b[kLdB]),
                     pack_bf16(b[8 * kLdB], b[9 * kLdB]));
          }
        } else {
#pragma unroll 4
          for (int kk = ks; kk < ks + 16; ++kk) {
            const float a0 = to_f32(as[g * lda + kk]);
            const float a1 = to_f32(as[(g + 8) * lda + kk]);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              const T* b = bs + kk * kLdB + warp * 32 + nt * 8 + 2 * c;
              const float b0 = to_f32(b[0]), b1 = to_f32(b[1]);
              acc[nt][0] = __fmaf_rn(a0, b0, acc[nt][0]);
              acc[nt][1] = __fmaf_rn(a0, b1, acc[nt][1]);
              acc[nt][2] = __fmaf_rn(a1, b0, acc[nt][2]);
              acc[nt][3] = __fmaf_rn(a1, b1, acc[nt][3]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + warp * 32 + nt * 8 + 2 * c;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = g + 8 * h;
        if (row >= valid) continue;
        T* o = dst + static_cast<long long>(row) * cols + col;
        if (col < cols) o[0] = from_f32<T>(acc[nt][2 * h]);
        if (col + 1 < cols) o[1] = from_f32<T>(acc[nt][2 * h + 1]);
      }
    }
  }
}

// B5a.
template <typename T>
__global__ void __launch_bounds__(kThreads) matmul_rs_kernel(const Params p) {
  __shared__ __align__(16) T as[kStripRows * kLdA<T>];
  __shared__ __align__(16) T bs[kDepth<T> * kLdB];
  const int r = blockIdx.x;
  const int n = p.n, my = p.my[r], right = p.right[r], left = p.left[r];
  const int rows = p.rows, k = p.k, cols = p.cols;
  const long long chunk = static_cast<long long>(rows) * cols;
  const int strips = (rows + kStripRows - 1) / kStripRows;
  int* const fl_me = p.flags[r] + blockIdx.y * p.flag_stride;
  int* const fl_right = p.flags[right] + blockIdx.y * p.flag_stride;
  int* const fl_left = p.flags[left] + blockIdx.y * p.flag_stride;
  const T* const x = static_cast<const T*>(p.x[r]);
  const T* const w = static_cast<const T*>(p.w[r]);
  T* const out = static_cast<T*>(p.out[r]);
  T* const stage = static_cast<T*>(p.stage[r]);
  const T* const comm = static_cast<const T*>(p.comm[r]);
  T* const peer_comm = static_cast<T*>(p.comm[right]);

  // This block's strips of partial(b) into dst (a (rows, cols) chunk).
  auto partial = [&](int b, T* dst) {
    for (int t = blockIdx.y; t < strips; t += gridDim.y) {
      const int row0 = t * kStripRows;
      strip_product(x + (static_cast<long long>(b) * rows + row0) * k,
                    min(kStripRows, rows - row0), w, p.w_sk, p.w_sn, k, cols,
                    dst + static_cast<long long>(row0) * cols, as, bs);
    }
  };

  partial(wrap(my - 1, n), stage);
  ring_barrier(fl_me, fl_left, fl_right);

  for (int s = 0; s < n - 1; ++s) {
    const int slot = s & 1;
    // Slot reuse: the right neighbour has emptied it s / 2 times.
    if (s >= 2) wait_flag(fl_me + kAck + slot, s / 2);
    for (int t = blockIdx.y; t < strips; t += gridDim.y) {
      const long long off = static_cast<long long>(t) * kStripRows * cols;
      copy_range(peer_comm + slot * chunk + off, stage + slot * chunk + off,
                 min(kStripRows, rows - t * kStripRows) *
                     static_cast<long long>(cols));
    }
    signal_add(fl_right + kFull + slot, 1);
    // The overlap: this block's partial for the block whose running sum is
    // on its way from the left neighbour.
    T* const dst = s == n - 2 ? out : stage + ((s + 1) & 1) * chunk;
    partial(wrap(my - 2 - s, n), dst);
    wait_flag(fl_me + kFull + slot, s / 2 + 1);
    for (int t = blockIdx.y; t < strips; t += gridDim.y) {
      const long long off = static_cast<long long>(t) * kStripRows * cols;
      add_range(dst + off, comm + slot * chunk + off,
                min(kStripRows, rows - t * kStripRows) *
                    static_cast<long long>(cols));
    }
    signal_add(fl_left + kAck + slot, 1);
  }
  // Drain the acks of the last two steps.
  if (n >= 3) wait_flag(fl_me + kAck + ((n - 3) & 1), (n - 3) / 2 + 1);
  wait_flag(fl_me + kAck + ((n - 2) & 1), (n - 2) / 2 + 1);
}

// B5b.
template <typename T>
__global__ void __launch_bounds__(kThreads) ag_matmul_kernel(const Params p) {
  __shared__ __align__(16) T as[kStripRows * kLdA<T>];
  __shared__ __align__(16) T bs[kDepth<T> * kLdB];
  const int r = blockIdx.x;
  const int n = p.n, my = p.my[r], right = p.right[r], left = p.left[r];
  const int rows = p.rows, k = p.k, cols = p.cols;
  const long long xchunk = static_cast<long long>(rows) * k;
  const int strips = (rows + kStripRows - 1) / kStripRows;
  int* const fl_me = p.flags[r] + blockIdx.y * p.flag_stride;
  int* const fl_right = p.flags[right] + blockIdx.y * p.flag_stride;
  int* const fl_left = p.flags[left] + blockIdx.y * p.flag_stride;
  const T* const x = static_cast<const T*>(p.x[r]);
  const T* const w = static_cast<const T*>(p.w[r]);
  T* const y = static_cast<T*>(p.out[r]);
  T* const gx = static_cast<T*>(p.gx[r]);
  T* const peer_gx = static_cast<T*>(p.gx[right]);

  // This block's strips of y[c] = src @ W, src the (rows, k) chunk c.
  auto dot_chunk = [&](int c, const T* src) {
    for (int t = blockIdx.y; t < strips; t += gridDim.y) {
      const int row0 = t * kStripRows;
      strip_product(src + static_cast<long long>(row0) * k,
                    min(kStripRows, rows - row0), w, p.w_sk, p.w_sn, k, cols,
                    y + (static_cast<long long>(c) * rows + row0) * cols, as,
                    bs);
    }
  };
  // This block's strips of chunk c of `src` into `dst` at the same offset.
  auto copy_chunk = [&](T* dst, const T* src) {
    for (int t = blockIdx.y; t < strips; t += gridDim.y) {
      const long long off = static_cast<long long>(t) * kStripRows * k;
      copy_range(dst + off, src + off,
                 min(kStripRows, rows - t * kStripRows) *
                     static_cast<long long>(k));
    }
  };

  copy_chunk(gx + my * xchunk, x);
  ring_barrier(fl_me, fl_left, fl_right);

  for (int s = 0; s < n - 1; ++s) {
    // Chunk my - s is here (own at s = 0, received at step s - 1): forward
    // it, then its product overlaps the left neighbour's forward.
    const int c = wrap(my - s, n);
    const T* const src = s == 0 ? x : gx + c * xchunk;
    copy_chunk(peer_gx + c * xchunk, src);
    signal_set(fl_right + kGather + s, 1);
    dot_chunk(c, src);
    wait_flag(fl_me + kGather + s, 1);
  }
  // The last chunk received was never forwarded; compute its product.
  const int last = wrap(my - (n - 1), n);
  dot_chunk(last, gx + last * xchunk);
}

template <typename T>
cudaError_t launch(bool rs, const Params& p, dim3 grid, cudaStream_t stream) {
  void* fn = rs ? reinterpret_cast<void*>(matmul_rs_kernel<T>)
                : reinterpret_cast<void*>(ag_matmul_kernel<T>);
  void* args[] = {const_cast<Params*>(&p)};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      fn, grid, dim3(kThreads), args, 0, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Fills the peer table from per-rank strides (bytes) off base pointers:
// rank r's buffer is base + r * stride, the layout of one world tensor
// (stride 0: one buffer shared by every rank).
int run(bool rs, const void* x, long long x_stride, const void* w,
        long long w_stride, long long w_sk, long long w_sn, void* out,
        long long out_stride, void* gx, long long gx_stride, void* stage,
        void* comm, long long slot_stride, int* flags, int flag_stride,
        const int* my, const int* right, const int* left, int ranks, int n,
        int slices, int rows, int k, int cols, int dtype, void* stream) {
  if (ranks < 2 || ranks > kMaxRanks || n < 2 || n > ranks || slices < 1 ||
      slices > 65535 || rows < 1 || k < 1 || cols < 1 ||
      flag_stride < kGather + n - 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  memset(&p, 0, sizeof(p));
  for (int i = 0; i < ranks; ++i) {
    if (my[i] < 0 || my[i] >= n || right[i] < 0 || right[i] >= ranks ||
        left[i] < 0 || left[i] >= ranks) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    p.x[i] = static_cast<const char*>(x) + i * x_stride;
    p.w[i] = static_cast<const char*>(w) + i * w_stride;
    p.out[i] = static_cast<char*>(out) + i * out_stride;
    p.gx[i] = gx ? static_cast<char*>(gx) + i * gx_stride : nullptr;
    p.stage[i] = stage ? static_cast<char*>(stage) + i * slot_stride : nullptr;
    p.comm[i] = comm ? static_cast<char*>(comm) + i * slot_stride : nullptr;
    p.flags[i] = flags + static_cast<long long>(i) * slices * flag_stride;
    p.my[i] = my[i];
    p.right[i] = right[i];
    p.left[i] = left[i];
  }
  p.n = n;
  p.flag_stride = flag_stride;
  p.rows = rows;
  p.k = k;
  p.cols = cols;
  p.w_sk = w_sk;
  p.w_sn = w_sn;
  const dim3 grid(ranks, slices);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch<__nv_bfloat16>(rs, p, grid, s));
  if (dtype == 1) return static_cast<int>(launch<float>(rs, p, grid, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename Kernel>
cudaError_t min_blocks(Kernel kernel, int* blocks) {
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kThreads, 0);
  if (err == cudaSuccess && per_sm < *blocks) *blocks = per_sm;
  return err;
}

}  // namespace

extern "C" {

// Ints of flags each (rank, slice) needs for a ring of n.
int gtt_overlap_flag_stride(int n) { return kGather + (n > 1 ? n - 1 : 1); }

// Rows of one strip: a chunk's strips are spread over the slices.
int gtt_overlap_strip_rows() { return kStripRows; }

// The most blocks of either kernel, in either type, that can be resident
// at once on the current device (the cooperative launch's limit), in
// *blocks. The query sees each kernel's own shared memory and registers.
int gtt_overlap_max_blocks(int* blocks) {
  int per_sm = 1 << 30;
  cudaError_t err = min_blocks(matmul_rs_kernel<__nv_bfloat16>, &per_sm);
  if (err == cudaSuccess) err = min_blocks(matmul_rs_kernel<float>, &per_sm);
  if (err == cudaSuccess) {
    err = min_blocks(ag_matmul_kernel<__nv_bfloat16>, &per_sm);
  }
  if (err == cudaSuccess) err = min_blocks(ag_matmul_kernel<float>, &per_sm);
  int device = 0, sms = 0, coop = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  }
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  *blocks = err == cudaSuccess ? per_sm * sms : 0;
  return static_cast<int>(err);
}

// Each returns a cudaError_t; 0 is success. dtype: 0 = bf16, 1 = f32.
// Strides between ranks are in bytes, w_sk and w_sn in elements; rows is
// the rows of one chunk. my/right/left: host arrays of `ranks` ints.

// B5a: x (n rows, k) per rank -> out (rows, cols) per rank; stage and comm
// hold 2 (rows, cols) slots per rank, slot_stride bytes apart by rank.
int gtt_matmul_rs(const void* x, long long x_stride, const void* w,
                  long long w_stride, long long w_sk, long long w_sn,
                  void* out, long long out_stride, void* stage, void* comm,
                  long long slot_stride, int* flags, int flag_stride,
                  const int* my, const int* right, const int* left, int ranks,
                  int n, int slices, int rows, int k, int cols, int dtype,
                  void* stream) {
  if (stage == nullptr || comm == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return run(true, x, x_stride, w, w_stride, w_sk, w_sn, out, out_stride,
             nullptr, 0, stage, comm, slot_stride, flags, flag_stride, my,
             right, left, ranks, n, slices, rows, k, cols, dtype, stream);
}

// B5b: x (rows, k) per rank -> y (n rows, cols) and gx (n rows, k) per rank.
int gtt_ag_matmul(const void* x, long long x_stride, const void* w,
                  long long w_stride, long long w_sk, long long w_sn, void* y,
                  long long y_stride, void* gx, long long gx_stride,
                  int* flags, int flag_stride, const int* my,
                  const int* right, const int* left, int ranks, int n,
                  int slices, int rows, int k, int cols, int dtype,
                  void* stream) {
  if (gx == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return run(false, x, x_stride, w, w_stride, w_sk, w_sn, y, y_stride, gx,
             gx_stride, nullptr, nullptr, 0, flags, flag_stride, my, right,
             left, ranks, n, slices, rows, k, cols, dtype, stream);
}

const char* gtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
