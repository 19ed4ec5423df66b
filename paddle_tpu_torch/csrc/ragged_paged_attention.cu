// Ragged paged attention: slot b carries tq query tokens at global positions
// q_starts[b] + [0, tq) and attends its own KV pages causally, up to
// ctx_lens[b], with an online softmax in f32. Chunked prefill of slots that
// sit at different offsets runs as one launch.
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py `_ragged_kernel` (called
// from `ragged_paged_attention`). On the TPU the page axis is a sequential
// grid dimension carrying (m, l, acc) in VMEM, and every page of the table is
// DMA'd whether or not it is visible; here the page walk is a loop inside one
// block and stops at the block's causal horizon.
//
// What bounds it on the H100: at the serving path's shape (8 slots, 128-token
// chunks, 32 heads of d = 128, contexts up to 768) the bytes are q, o and the
// live K/V, about 65 MB, over 3.35 TB/s: ~0.02 ms. The flops (4 d per visible
// (row, key) pair, ~5 GFLOP) over 989 TFLOP/s take ~0.005 ms, so bytes bound
// it. This first kernel does its arithmetic on CUDA cores in f32 and is
// limited by shared-memory traffic, far above that bound; wgmma tiles are a
// later PR's work.
//
// Design: one block per (slot, kv head, tile of 64 query rows of that head's
// group). A group's rows are the rep query heads of the kv head at every
// chunk offset, ordered (offset, head), so a tile covers a contiguous range
// of offsets and its horizon is min(ctx_len, q_start + last offset + 1): keys
// past it are never loaded. Keys are staged 64 at a time in shared memory (k
// and v in f32, rows padded to d + 1 floats against bank conflicts; GQA: one
// staged k/v row serves all rep heads). Each of 256 threads owns a 4 x 4
// tile of the 64 x 64 logits, then 4 rows x d/16 features of the output;
// one warp per row updates (m, l). Masked logits contribute exactly zero, so
// a row with no visible key (an inactive slot, ctx_len 0) emits zeros (l
// clamped to 1e-30, as in the reference). Table ids are clamped to
// [0, n_pages). d is any multiple of 16 up to 256.
#include "common.cuh"

namespace {

using ptt::from_f32;
using ptt::kNegInf;
using ptt::to_f32;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;      // query rows per block
constexpr int kKeys = 64;      // keys staged per chunk
constexpr int kMaxDpt = 16;    // d / 16 output features per thread: d <= 256

template <typename T>
__global__ void __launch_bounds__(kThreads)
ragged_kernel(const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
              const int* __restrict__ table, const int* __restrict__ ctx_lens,
              const int* __restrict__ q_starts, const int* __restrict__ active,
              T* __restrict__ out, int tq, int h, int h_kv, int d, int p, int n_pages,
              int max_pages, int n_tiles, float scale) {
  extern __shared__ float smem[];
  const int ds = d + 1;                      // padded row stride
  float* q_s = smem;                         // [kRows][ds], pre-scaled
  float* k_s = q_s + kRows * ds;             // [kKeys][ds]
  float* v_s = k_s + kKeys * ds;             // [kKeys][ds]
  float* s_s = v_s + kKeys * ds;             // [kRows][kKeys + 1]
  float* m_s = s_s + kRows * (kKeys + 1);    // [kRows] running max
  float* l_s = m_s + kRows;                  // [kRows] running sum
  float* a_s = l_s + kRows;                  // [kRows] this chunk's rescale

  const int rep = h / h_kv;
  const int tile = blockIdx.x % n_tiles;
  const int g = (blockIdx.x / n_tiles) % h_kv;
  const int b = blockIdx.x / (n_tiles * h_kv);
  const int r0 = tile * kRows;
  const int n_rows = min(kRows, rep * tq - r0);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int lane = tid % 32, warp = tid / 32;
  const int dpt = d / 16;

  const int q_start = q_starts[b];
  int ctx = ctx_lens[b];
  if (active != nullptr && active[b] == 0) ctx = 0;
  ctx = min(ctx, max_pages * p);
  const int n_keys = max(0, min(ctx, q_start + (r0 + n_rows - 1) / rep + 1));

  for (int e = tid; e < kRows * d; e += kThreads) {
    const int rr = e / d, f = e % d;
    float x = 0.f;
    if (rr < n_rows) {
      const int r = r0 + rr;
      x = to_f32(q[(((size_t)b * tq + r / rep) * h + g * rep + r % rep) * d + f]) * scale;
    }
    q_s[rr * ds + f] = x;
  }
  for (int r = tid; r < kRows; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) qpos[i] = q_start + (r0 + ty + 16 * i) / rep;
  float acc[4][kMaxDpt];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kMaxDpt; ++j) acc[i][j] = 0.f;
  __syncthreads();

  const size_t tok_stride = (size_t)h_kv * d;
  for (int c0 = 0; c0 < n_keys; c0 += kKeys) {
    const int nk = min(kKeys, n_keys - c0);
    // stage keys c0 .. c0 + nk (each through its own page-table entry)
    for (int e = tid; e < kKeys * d; e += kThreads) {
      const int kk = e / d, f = e % d;
      float kx = 0.f, vx = 0.f;
      if (kk < nk) {
        const int c = c0 + kk;
        const int page = min(max(table[(size_t)b * max_pages + c / p], 0), n_pages - 1);
        const size_t off = ((size_t)page * p + c % p) * tok_stride + (size_t)g * d + f;
        kx = to_f32(kp[off]);
        vx = to_f32(vp[off]);
      }
      k_s[kk * ds + f] = kx;
      v_s[kk * ds + f] = vx;
    }
    __syncthreads();

    // logits: rows ty + 16 i, keys tx + 16 j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int f = 0; f < d; ++f) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty + 16 * i) * ds + f];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx + 16 * j) * ds + f];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = tx + 16 * j;
        // c < n_keys <= ctx_len already holds; the causal test is per row
        const bool ok = kk < nk && c0 + kk <= qpos[i];
        s_s[(ty + 16 * i) * (kKeys + 1) + kk] = ok ? sc[i][j] : kNegInf;
      }
    __syncthreads();

    // online softmax: one warp per row; masked logits weigh exactly 0
    for (int r = warp; r < kRows; r += kWarps) {
      float* sr = s_s + r * (kKeys + 1);
      float mx = kNegInf;
      for (int kk = lane; kk < kKeys; kk += 32) mx = fmaxf(mx, sr[kk]);
      mx = ptt::warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int kk = lane; kk < kKeys; kk += 32) {
        const float x = sr[kk];
        const float e = x > kNegInf ? expf(x - m_new) : 0.f;
        sr[kk] = e;
        sum += e;
      }
      sum = ptt::warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc = alpha * acc + P @ V over this chunk's keys
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kMaxDpt; ++j) acc[i][j] *= alpha;
    }
    for (int kk = 0; kk < nk; ++kk) {
      float pw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pw[i] = s_s[(ty + 16 * i) * (kKeys + 1) + kk];
      const float* vr = v_s + kk * ds + tx;
#pragma unroll
      for (int j = 0; j < kMaxDpt; ++j) {
        if (j < dpt) {
          const float vx = vr[16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pw[i], vx, acc[i][j]);
        }
      }
    }
    __syncthreads();  // k_s, v_s, s_s and a_s are rewritten by the next chunk
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rr = ty + 16 * i;
    if (rr < n_rows) {
      const int r = r0 + rr;
      const float l = fmaxf(l_s[rr], 1e-30f);
      T* o = out + (((size_t)b * tq + r / rep) * h + g * rep + r % rep) * d + tx;
#pragma unroll
      for (int j = 0; j < kMaxDpt; ++j)
        if (j < dpt) o[16 * j] = from_f32<T>(acc[i][j] / l);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* kp, const void* vp, const int* table,
                   const int* ctx, const int* starts, const int* active, void* out, int b,
                   int tq, int h, int h_kv, int d, int p, int n_pages, int max_pages,
                   float scale, cudaStream_t s) {
  const int rep = h / h_kv;
  const int n_tiles = (rep * tq + kRows - 1) / kRows;
  const size_t smem = sizeof(float) * ((size_t)(kRows + 2 * kKeys) * (d + 1) +
                                       (size_t)kRows * (kKeys + 1) + 3 * kRows);
  cudaError_t err = ptt::allow_smem(ragged_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  ragged_kernel<T><<<b * h_kv * n_tiles, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), table,
      ctx, starts, active, static_cast<T*>(out), tq, h, h_kv, d, p, n_pages, max_pages,
      n_tiles, scale);
  return cudaSuccess;
}

}  // namespace

// q and out: [b, tq, h, d]; pages [n_pages, p, h_kv, d]; table [b, max_pages];
// ctx_lens, q_starts and active [b] int32 (active may be null: every slot
// live). dtype: 0 = float32, 1 = bfloat16 (q, pages and out share it).
extern "C" int ptt_ragged_paged_attention(const void* q, const void* k_pages,
                                          const void* v_pages, const void* table,
                                          const void* ctx_lens, const void* q_starts,
                                          const void* active, void* out, int b, int tq,
                                          int h, int h_kv, int d, int p, int n_pages,
                                          int max_pages, float scale, int dtype, int device,
                                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (h_kv <= 0 || h % h_kv != 0 || d % 16 != 0 || d <= 0 || d > 16 * kMaxDpt || tq <= 0 ||
      p <= 0 || n_pages <= 0 || max_pages <= 0)
    return (int)cudaErrorInvalidValue;
  if (b == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(table);
  const int* cl = static_cast<const int*>(ctx_lens);
  const int* st = static_cast<const int*>(q_starts);
  const int* ac = static_cast<const int*>(active);
  if (dtype == 1)
    err = launch<__nv_bfloat16>(q, k_pages, v_pages, tb, cl, st, ac, out, b, tq, h, h_kv, d,
                                p, n_pages, max_pages, scale, s);
  else if (dtype == 0)
    err = launch<float>(q, k_pages, v_pages, tb, cl, st, ac, out, b, tq, h, h_kv, d, p,
                        n_pages, max_pages, scale, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
