// Shared helpers for the paddle_tpu_torch CUDA kernels.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// Dynamic shared memory above 48 KB needs an explicit opt-in per kernel.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace ptt
