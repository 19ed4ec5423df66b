// Paged-attention decode: one query token per slot attends the slot's KV
// pages through its page table, with an online softmax in f32.
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py `_decode_kernel`
// (called from `paged_attention`). On the TPU the page axis is the
// innermost, sequential grid dimension and the softmax state rides in VMEM
// scratch from one grid step to the next; here that axis is a loop inside
// one block.
//
// What bounds it on the H100: the KV bytes of the live positions (2 bytes
// x 2 tensors x d per position and kv head in bf16) over 3.35 TB/s. The
// arithmetic is ~1 flop per byte: memory, and at decode batch sizes the
// latency of the page walk, set the time.
//
// Design: one block per (slot, kv head). The block reads its own row of
// the page table (ids clamped to [0, n_pages) as the reference does) and
// walks its pages up to seq_len; positions at or past seq_len are never
// loaded. Each page is one call of `ptt::online_softmax_page`
// (common.cuh), the per-page step the ragged kernel shares: each warp
// takes whole tokens, holds the token's k row in registers (lanes split d)
// and dots it with the `rep` pre-scaled query heads of the group, staged
// once in shared memory (GQA: the k/v row is read once for all rep
// heads); one warp per head updates (m, l) and turns the page's logits
// into weights; every thread owns (head, feature) outputs and accumulates
// weights x v in f32 registers, rescaled by alpha. An inactive slot or a
// slot of length 0
// walks no page and writes zeros (l clamped to 1e-30, as in the
// reference). d is any multiple of 16 up to 256; rep * d <= 2048.
#include "common.cuh"

namespace {

using ptt::from_f32;
using ptt::kNegInf;
using ptt::to_f32;

constexpr int kThreads = 128;
constexpr int kMaxAcc = 16;     // accumulators per thread: rep * d <= 2048

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp, const int* __restrict__ table,
                       const int* __restrict__ lens, const int* __restrict__ active,
                       T* __restrict__ out, int h, int h_kv, int d, int p,
                       int n_pages, int max_pages, float scale) {
  extern __shared__ float smem[];
  const int rep = h / h_kv;
  float* q_s = smem;               // [rep][d], pre-scaled
  float* s_s = q_s + rep * d;      // [rep][p] logits, then weights
  float* m_s = s_s + rep * p;      // [rep] running max
  float* l_s = m_s + rep;          // [rep] running sum
  float* a_s = l_s + rep;          // [rep] this page's rescale factor

  const int b = blockIdx.x / h_kv, g = blockIdx.x % h_kv;
  const int tid = threadIdx.x;
  const int rd = rep * d;
  const size_t qoff = ((size_t)b * h + (size_t)g * rep) * d;  // rep heads, contiguous

  int L = lens[b];
  if (active != nullptr && active[b] == 0) L = 0;
  L = max(0, min(L, max_pages * p));

  for (int e = tid; e < rd; e += kThreads) q_s[e] = to_f32(q[qoff + e]) * scale;
  for (int r = tid; r < rep; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) acc[i] = 0.f;
  __syncthreads();

  const size_t tok_stride = (size_t)h_kv * d;
  const int n_pg = (L + p - 1) / p;
  for (int pi = 0; pi < n_pg; ++pi) {
    const int page = min(max(table[(size_t)b * max_pages + pi], 0), n_pages - 1);
    const int valid = min(p, L - pi * p);
    const size_t base = (size_t)page * p * tok_stride + (size_t)g * d;
    // every token of a live page is visible to every head of the group;
    // token loops unrolled 2 (q.k) and 16 (p.v) deep: with few heads per
    // group each thread has one long chain of v loads, and rolled it
    // stalls on each (measured slower on the H100)
    ptt::online_softmax_page<kThreads, kMaxAcc, 2, 16>(
        q_s, rep, d, kp + base, vp + base, tok_stride, valid,
        [](int) { return 1 << 30; }, s_s, p, m_s, l_s, a_s, acc);
  }

#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) {
    const int e = tid + i * kThreads;
    if (e < rd) {
      const int r = e / d;
      out[qoff + e] = from_f32<T>(acc[i] / fmaxf(l_s[r], 1e-30f));
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* kp, const void* vp, const int* table,
                   const int* lens, const int* active, void* out, int b, int h,
                   int h_kv, int d, int p, int n_pages, int max_pages, float scale,
                   cudaStream_t s) {
  const int rep = h / h_kv;
  const size_t smem = sizeof(float) * ((size_t)rep * d + (size_t)rep * p + 3 * rep);
  cudaError_t err = ptt::allow_smem(paged_attention_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  paged_attention_kernel<T><<<b * h_kv, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
      table, lens, active, static_cast<T*>(out), h, h_kv, d, p, n_pages, max_pages,
      scale);
  return cudaSuccess;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, pages and out share it).
// active may be null (every slot live).
extern "C" int ptt_paged_attention(const void* q, const void* k_pages,
                                   const void* v_pages, const void* table,
                                   const void* lens, const void* active, void* out,
                                   int b, int h, int h_kv, int d, int p, int n_pages,
                                   int max_pages, float scale, int dtype, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (h_kv <= 0 || h % h_kv != 0 || d % 16 != 0 || d > 32 * ptt::kPageMaxDLane ||
      (h / h_kv) * d > kMaxAcc * kThreads)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(table);
  const int* ln = static_cast<const int*>(lens);
  const int* ac = static_cast<const int*>(active);
  if (dtype == 1)
    err = launch<__nv_bfloat16>(q, k_pages, v_pages, tb, ln, ac, out, b, h, h_kv, d, p,
                                n_pages, max_pages, scale, s);
  else if (dtype == 0)
    err = launch<float>(q, k_pages, v_pages, tb, ln, ac, out, b, h, h_kv, d, p, n_pages,
                        max_pages, scale, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
