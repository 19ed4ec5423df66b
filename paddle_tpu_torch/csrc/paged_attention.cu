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
//
// Two builds, chosen by the wrapper (`paged_route`, by dtype, d and page
// size alone). "direct" (`paged_attention_kernel`) reads each page's K and
// V rows straight from device memory inside the per-page step, with
// nothing in flight past the page it is on: every page pays a dozen round
// trips to HBM in series (0.054 ms at the serving shape, 5 pages a block,
// on the H100). "staged" (`paged_staged_kernel`, every shape whose ring of
// two pages fits `paged_stage_plan`'s budget) keeps a ring of `stages`
// pages of the block's kv head in shared memory (`ptt::PageRing`,
// common.cuh), a whole page two TMA tensor copies issued `stages` pages
// ahead, and runs the same `ptt::online_softmax_page` on the staged rows
// (tok_stride = d) in its grouped form (kRowsCT > 0): the logits of a
// warp's (head, token) pairs with their loads in flight together and their
// xor trees sharing shuffles (`ptt::warp_sum_many`), P V on quads of
// outputs with one v load a token. Every sum keeps its operands and order,
// so the two builds, the ragged kernel's and the decode megakernel's
// attention phase give the same bits. What bounds the staged build is no
// longer the bytes in flight but the page step's latency chain: ~2,000-
// 2,500 cycles a page (logits, the softmax row update, P V, three block
// barriers) and ~2 us of start-up (0.017 ms at the serving shape).
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

// The staged build: the direct kernel's walk over a ring of pages staged
// in shared memory (layout: the ring, then q_s, s_s, m_s, l_s, a_s as
// above). kRowsCT (the group's heads, a compile-time bound) and kTokG
// (tokens a warp takes at once) set step 1's groups; kRowsCT = 0 keeps the
// per-token loop.
template <typename T, int kRowsCT, int kTokG>
__global__ void __launch_bounds__(kThreads)
paged_staged_kernel(const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap, int use_maps,
                    const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ table,
                    const int* __restrict__ lens, const int* __restrict__ active,
                    T* __restrict__ out, int h, int h_kv, int d, int p, int n_pages,
                    int max_pages, float scale, int stages) {
  extern __shared__ __align__(128) unsigned char staged_smem[];
  const int rep = h / h_kv;
  const int b = blockIdx.x / h_kv, g = blockIdx.x % h_kv;
  const int tid = threadIdx.x;
  const int rd = rep * d;
  const size_t qoff = ((size_t)b * h + (size_t)g * rep) * d;

  int L = lens[b];
  if (active != nullptr && active[b] == 0) L = 0;
  L = max(0, min(L, max_pages * p));

  // shared memory: the ring (from 128 bytes), its barriers, then q_s
  // [rep][d] pre-scaled, s_s [rep][p] logits then weights, m_s, l_s, a_s
  // [rep] (running max, running sum, this page's rescale factor) and the
  // walk's page ids
  unsigned char* base = staged_smem + ((128u - (ptt::smem_u32(staged_smem) & 127u)) & 127u);
  T* ring_rows = reinterpret_cast<T*>(base);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + (size_t)stages * 2 * p * d * sizeof(T));
  float* q_s = reinterpret_cast<float*>(bars + stages);
  float* s_s = q_s + rep * d;
  float* m_s = s_s + rep * p;
  float* l_s = m_s + rep;
  float* a_s = l_s + rep;
  int* pid_s = reinterpret_cast<int*>(a_s + rep);
  const ptt::PageRing<T> ring{ring_rows, bars, kp + (size_t)g * d, vp + (size_t)g * d,
                              use_maps ? &kmap : nullptr, use_maps ? &vmap : nullptr,
                              pid_s, (size_t)h_kv * d, stages, p, d, n_pages, L, g * d};

  // the walk's page ids, read once (an issue then waits on no device load)
  const int n_pg = ring.pages();
  for (int i = tid; i < n_pg; i += kThreads)
    pid_s[i] = min(max(table[(size_t)b * max_pages + i], 0), n_pages - 1);
  ring.init();
  __syncthreads();
  for (int pi = 0; pi < min(stages, n_pg); ++pi) ring.issue(pi);

  for (int e = tid; e < rd; e += kThreads) q_s[e] = to_f32(q[qoff + e]) * scale;
  for (int r = tid; r < rep; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int pi = 0; pi < n_pg; ++pi) {
    ring.wait(pi);
    ptt::online_softmax_page<kThreads, kMaxAcc, 2, 16, kRowsCT, kTokG>(
        q_s, rep, d, ring.k(pi), ring.v(pi), (size_t)d, ring.valid(pi),
        [](int) { return 1 << 30; }, s_s, p, m_s, l_s, a_s, acc);
    // the routine ended on a block barrier: the stage is free
    if (pi + stages < n_pg) ring.issue(pi + stages);
  }

  if constexpr (kRowsCT > 0) {
    // the routine's quads: acc[4 i + c] is output 4 (u % (d / 4)) + c of
    // row u / (d / 4), u = tid + i * kThreads
    const int dq = d >> 2;
#pragma unroll
    for (int i = 0; i < kMaxAcc / 4; ++i) {
      const int u = tid + i * kThreads;
      if (u < rep * dq) {
        const int r = u / dq, f = 4 * (u - r * dq);
        const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          out[qoff + (size_t)r * d + f + c] = from_f32<T>(acc[4 * i + c] / l);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kMaxAcc; ++i) {
      const int e = tid + i * kThreads;
      if (e < rd) {
        const int r = e / d;
        out[qoff + e] = from_f32<T>(acc[i] / fmaxf(l_s[r], 1e-30f));
      }
    }
  }
}

template <typename T, int kRowsCT, int kTokG>
cudaError_t launch_staged(const void* q, const void* kp, const void* vp, const int* table,
                          const int* lens, const int* active, void* out, int b, int h,
                          int h_kv, int d, int p, int n_pages, int max_pages, float scale,
                          int stages, int device, cudaStream_t s) {
  const int rep = h / h_kv;
  // + 128: the ring's start is rounded up to 128 bytes
  const size_t smem = 128 + ptt::PageRing<T>::bytes(stages, p, d) +
                      sizeof(float) * ((size_t)rep * d + (size_t)rep * p + 3 * rep) +
                      sizeof(int) * (size_t)max_pages;
  CUtensorMap kmap{}, vmap{};
  const bool maps = ptt::PageRing<T>::maps_fit(p, d);
  if (maps && !(ptt::pool_map<T>(&kmap, kp, n_pages, p, h_kv, d) &&
                ptt::pool_map<T>(&vmap, vp, n_pages, p, h_kv, d)))
    return cudaErrorInvalidValue;
  auto kernel = paged_staged_kernel<T, kRowsCT, kTokG>;
  static ptt::SmemOptIn opt_in;
  cudaError_t err = opt_in.allow(kernel, smem, device);
  if (err != cudaSuccess) return err;
  kernel<<<b * h_kv, kThreads, smem, s>>>(
      kmap, vmap, maps ? 1 : 0, static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), table, lens, active, static_cast<T*>(out), h, h_kv, d, p,
      n_pages, max_pages, scale, stages);
  return cudaSuccess;
}

// step 1's groups by the group's head count: 1 head, 16 tokens a warp; up
// to 4 heads, 4 tokens; up to 8 heads, 4 tokens; more, the per-token loop
template <typename T>
cudaError_t staged(const void* q, const void* kp, const void* vp, const int* table,
                   const int* lens, const int* active, void* out, int b, int h, int h_kv,
                   int d, int p, int n_pages, int max_pages, float scale, int stages,
                   int device, cudaStream_t s) {
  const int rep = h / h_kv;
  if (rep == 1)
    return launch_staged<T, 1, 16>(q, kp, vp, table, lens, active, out, b, h, h_kv, d, p,
                                  n_pages, max_pages, scale, stages, device, s);
  if (rep <= 4)
    return launch_staged<T, 4, 4>(q, kp, vp, table, lens, active, out, b, h, h_kv, d, p,
                                  n_pages, max_pages, scale, stages, device, s);
  if (rep <= 8)
    return launch_staged<T, 8, 4>(q, kp, vp, table, lens, active, out, b, h, h_kv, d, p,
                                  n_pages, max_pages, scale, stages, device, s);
  return launch_staged<T, 0, 1>(q, kp, vp, table, lens, active, out, b, h, h_kv, d, p,
                                n_pages, max_pages, scale, stages, device, s);
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
// active may be null (every slot live). stages: 0 takes the direct build,
// 2..ptt::kRingMaxStages the staged build with a ring of that many pages
// (the pools then start on 16 bytes).
extern "C" int ptt_paged_attention(const void* q, const void* k_pages,
                                   const void* v_pages, const void* table,
                                   const void* lens, const void* active, void* out,
                                   int b, int h, int h_kv, int d, int p, int n_pages,
                                   int max_pages, float scale, int dtype, int stages,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (h_kv <= 0 || h % h_kv != 0 || d % 16 != 0 || d > 32 * ptt::kPageMaxDLane ||
      (h / h_kv) * d > kMaxAcc * kThreads ||
      (stages != 0 && (stages < 2 || stages > ptt::kRingMaxStages)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(table);
  const int* ln = static_cast<const int*>(lens);
  const int* ac = static_cast<const int*>(active);
  if (dtype == 1 && stages)
    err = staged<__nv_bfloat16>(q, k_pages, v_pages, tb, ln, ac, out, b, h, h_kv, d, p,
                                n_pages, max_pages, scale, stages, device, s);
  else if (dtype == 0 && stages)
    err = staged<float>(q, k_pages, v_pages, tb, ln, ac, out, b, h, h_kv, d, p, n_pages,
                        max_pages, scale, stages, device, s);
  else if (dtype == 1)
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
