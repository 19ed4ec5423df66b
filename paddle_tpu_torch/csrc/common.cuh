// Shared helpers for the paddle_tpu_torch CUDA kernels.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace ptt {

constexpr float kNegInf = -1e30f;  // the reference kernels' finite "-inf"

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ float warp_sum(float v, int width = 32) {
  for (int o = width / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v, int width = 32) {
  for (int o = width / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One page of the paged-attention online softmax, shared by the decode
// kernel (paged_attention.cu) and the ragged kernel
// (ragged_paged_attention.cu) so that a ragged slot with one query token
// gives the decode kernel's bits exactly, as the reference's two
// interpret kernels do (paged_attention.py `_decode_kernel` and
// `_ragged_kernel` both update their running softmax once per page).
//
// Block-cooperative; every thread of the block calls it. The block's
// n_rows query rows sit pre-scaled in f32 in q_s [n_rows][d]. The page
// holds `valid` tokens: token t's k row at kb + t * tok_stride, its v row
// at vb + t * tok_stride (d values each). Row r sees the first
// row_keys(r) tokens of the page (a causal prefix); the others weigh
// exactly 0. Per page:
//   1. logits: one warp per token; lanes split d (lane + 32 i) and sum
//      with one fmaf chain each, then one xor-shuffle tree per row;
//   2. one warp per row: the page max, m_new = max(m, page max),
//      p = exp(x - m_new), the page sum by lanes then a shuffle tree,
//      alpha = exp(m - m_new), l = fmaf(alpha, l, sum);
//   3. thread-owned outputs e = tid + i * kThreads (row e / d, feature
//      e % d): sum = fmaf chain over the page's tokens of p * v, then
//      acc = fmaf(alpha, acc, sum).
// Which thread owns an output does not change its arithmetic, so two
// kernels that map rows to blocks differently still agree bit for bit.
// s_s: [n_rows][ss] scratch (ss >= valid); m_s, l_s, a_s: [n_rows].
// d <= 256 (kMaxDLane lanes' worth) and n_rows * d <= kAcc * kThreads.
// A positive kUnrollQK / kUnrollPV unrolls the token loop of step 1 / 3 by
// that factor (more loads in flight); 0 leaves it to the compiler. Unrolling
// keeps every sum's order, so it never changes a bit: the decode kernel,
// whose few rows leave each thread one long chain of dependent loads,
// unrolls; the ragged kernel, with many accumulators per thread, does not.
constexpr int kPageMaxDLane = 8;

template <int kThreads, int kAcc, int kUnrollQK, int kUnrollPV, typename T,
          typename RowKeys>
__device__ __forceinline__ void online_softmax_page(
    const float* q_s, int n_rows, int d, const T* __restrict__ kb,
    const T* __restrict__ vb, size_t tok_stride, int valid, RowKeys row_keys,
    float* s_s, int ss, float* m_s, float* l_s, float* a_s, float (&acc)[kAcc]) {
  constexpr int kWarps = kThreads / 32;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  auto logits = [&](int t) {
    const T* kr = kb + t * tok_stride;
    float kv[kPageMaxDLane];
#pragma unroll
    for (int i = 0; i < kPageMaxDLane; ++i) {
      const int j = lane + 32 * i;
      kv[i] = (j < d) ? to_f32(kr[j]) : 0.f;
    }
    for (int r = 0; r < n_rows; ++r) {
      const float* qr = q_s + r * d;
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kPageMaxDLane; ++i) {
        const int j = lane + 32 * i;
        if (j < d) part = fmaf(qr[j], kv[i], part);
      }
      part = warp_sum(part);
      if (lane == 0) s_s[r * ss + t] = t < row_keys(r) ? part : kNegInf;
    }
  };
  if constexpr (kUnrollQK > 0) {
#pragma unroll(kUnrollQK > 0 ? kUnrollQK : 1)
    for (int t = warp; t < valid; t += kWarps) logits(t);
  } else {
    for (int t = warp; t < valid; t += kWarps) logits(t);
  }
  __syncthreads();

  for (int r = warp; r < n_rows; r += kWarps) {
    float* sr = s_s + r * ss;
    float mx = kNegInf;
    for (int t = lane; t < valid; t += 32) mx = fmaxf(mx, sr[t]);
    mx = warp_max(mx);
    const float m_prev = m_s[r];
    const float m_new = fmaxf(m_prev, mx);
    float sum = 0.f;
    for (int t = lane; t < valid; t += 32) {
      const float x = sr[t];
      const float e = x > kNegInf ? expf(x - m_new) : 0.f;
      sr[t] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const float alpha = expf(m_prev - m_new);
      l_s[r] = fmaf(alpha, l_s[r], sum);
      m_s[r] = m_new;
      a_s[r] = alpha;
    }
  }
  __syncthreads();

  const int rd = n_rows * d;
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int e = tid + i * kThreads;
    if (e < rd) {
      const int r = e / d, j = e % d;
      const float* wr = s_s + r * ss;
      const T* vj = vb + j;
      float sum = 0.f;
      if constexpr (kUnrollPV > 0) {
#pragma unroll(kUnrollPV > 0 ? kUnrollPV : 1)
        for (int t = 0; t < valid; ++t) sum = fmaf(wr[t], to_f32(vj[t * tok_stride]), sum);
      } else {
        for (int t = 0; t < valid; ++t) sum = fmaf(wr[t], to_f32(vj[t * tok_stride]), sum);
      }
      acc[i] = fmaf(a_s[r], acc[i], sum);
    }
  }
  __syncthreads();  // s_s and a_s are rewritten by the next page
}

// ---------------------------------------------------------------- GEMV slab
// The weight-streaming GEMV of the int8 matmul's decode path
// (quantized_matmul.cu `qmm_gemv_kernel`), shared with the decode
// megakernel (decode_megakernel.cu) so that an int8 projection inside the
// megakernel sums in the same order, and gives the same bits, as the
// standalone kernel on the same x.
//
// One block of kSlabThreads threads owns a slab of kSlabCols output
// columns and walks all of k. kColThreads threads cover the slab's width
// with one 16-byte weight load each (int8: 2 threads x 16 columns, so a k
// row of the slab is one 32-byte sector read whole; bf16: 4 x 8; f32:
// 8 x 4); the block takes kSlabThreads / kColThreads k rows per pass,
// kSlabUnroll passes of loads in flight per thread. Every thread keeps f32
// sums for its columns and all M rows (one fmaf chain per (row, column) in
// k order). The k partial sums are reduced by xor shuffles across the
// lanes that share a column, then across warps in shared memory, in warp
// order; `emit(i, col, sum)` receives each finished f32 sum. Rows at or
// past mrows are computed as zeros and never emitted; loads past k or n
// read zeros, so ragged edges need no padded copy.
constexpr int kSlabThreads = 256;
constexpr int kSlabCols = 32;
constexpr int kSlabUnroll = 4;

template <typename WT>
struct SlabW;
template <>
struct SlabW<int8_t> {
  static constexpr int kCols = 16;
  union Pack {
    int4 v;
    int8_t e[16];
  };
  static __device__ __forceinline__ float at(const Pack& p, int j) {
    return static_cast<float>(p.e[j]);
  }
};
template <>
struct SlabW<__nv_bfloat16> {
  static constexpr int kCols = 8;
  union Pack {
    int4 v;
    unsigned short e[8];  // raw bf16 bits
  };
  static __device__ __forceinline__ float at(const Pack& p, int j) {
    return __uint_as_float(static_cast<unsigned>(p.e[j]) << 16);  // exact
  }
};
template <>
struct SlabW<float> {
  static constexpr int kCols = 4;
  union Pack {
    int4 v;
    float e[4];
  };
  static __device__ __forceinline__ float at(const Pack& p, int j) { return p.e[j]; }
};

// 16 bytes of row `row` of a [k, n] weight from column `col`; columns past
// n read zeros. vec: rows start 16-byte aligned (n * sizeof(WT) % 16 == 0
// and an aligned base).
template <typename WT>
__device__ __forceinline__ typename SlabW<WT>::Pack load_w(const WT* w, int row, int col,
                                                           int n, bool vec) {
  using Pack = typename SlabW<WT>::Pack;
  constexpr int kCols = SlabW<WT>::kCols;
  Pack p;
  const WT* src = w + (size_t)row * n + col;
  if (vec && col + kCols <= n) {
    p.v = __ldg(reinterpret_cast<const int4*>(src));
  } else {
    using E = typename std::remove_reference<decltype(p.e[0])>::type;
    const E* se = reinterpret_cast<const E*>(src);
#pragma unroll
    for (int j = 0; j < kCols; ++j) p.e[j] = (col + j < n) ? se[j] : E(0);
  }
  return p;
}

template <typename WT>
__host__ __device__ inline bool slab_vec_ok(const void* w, int n) {
  return ((size_t)n * sizeof(WT)) % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
}

// Block-cooperative: every thread of a kSlabThreads block calls it.
// x_at(i, r): x[i, r] as f32 for i < mrows. red: kSlabThreads / 32 * M *
// kSlabCols floats of shared memory. Ends with a block barrier, so a block
// can run slab after slab.
template <typename WT, int M, typename XAt, typename Emit>
__device__ __forceinline__ void gemv_slab(XAt x_at, const WT* __restrict__ w, int mrows, int k,
                                          int n, int slab, bool vec, float* red, Emit emit) {
  using SW = SlabW<WT>;
  constexpr int kCols = SW::kCols;
  constexpr int kColThreads = kSlabCols / kCols;
  constexpr int kKRows = kSlabThreads / kColThreads;
  const int tid = threadIdx.x;
  const int ct = tid % kColThreads;
  const int kr = tid / kColThreads;
  const int col0 = slab * kSlabCols + ct * kCols;

  float acc[M][kCols];
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  auto fma_row = [&](const typename SW::Pack& p, int row) {
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const float xv = (i < mrows) ? x_at(i, row) : 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(xv, SW::at(p, j), acc[i][j]);
    }
  };

  int row = kr;
  for (; row + (kSlabUnroll - 1) * kKRows < k; row += kSlabUnroll * kKRows) {
    typename SW::Pack p[kSlabUnroll];
#pragma unroll
    for (int u = 0; u < kSlabUnroll; ++u) p[u] = load_w<WT>(w, row + u * kKRows, col0, n, vec);
#pragma unroll
    for (int u = 0; u < kSlabUnroll; ++u) fma_row(p[u], row + u * kKRows);
  }
  for (; row < k; row += kKRows) fma_row(load_w<WT>(w, row, col0, n, vec), row);

  // lanes with the same column group share a slab: sum them across the warp
  const int lane = tid % 32, warp = tid / 32;
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      float v = acc[i][j];
      for (int o = kColThreads; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      acc[i][j] = v;
    }
  if (lane < kColThreads) {
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        red[(warp * M + i) * kSlabCols + lane * kCols + j] = acc[i][j];
  }
  __syncthreads();
  for (int e = tid; e < M * kSlabCols; e += kSlabThreads) {
    const int i = e / kSlabCols, c = e % kSlabCols;
    const int col = slab * kSlabCols + c;
    if (i < mrows && col < n) {
      float s = 0.f;
#pragma unroll
      for (int wv = 0; wv < kSlabThreads / 32; ++wv) s += red[(wv * M + i) * kSlabCols + c];
      emit(i, col, s);
    }
  }
  __syncthreads();  // red is rewritten by the next slab
}

// Dynamic shared memory above 48 KB needs an explicit opt-in per kernel.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace ptt
