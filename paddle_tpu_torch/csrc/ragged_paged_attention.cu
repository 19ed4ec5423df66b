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
// it. This kernel does its arithmetic on CUDA cores in f32 and is limited by
// shuffles and shared-memory traffic, far above that bound; wgmma tiles are
// a later PR's work.
//
// Design: one block per (slot, kv head, tile of 32 query rows of that head's
// group). A group's rows are the rep query heads of the kv head at every
// chunk offset, ordered (offset, head), so a tile covers a contiguous range
// of offsets and its horizon is min(ctx_len, q_start + last offset + 1): keys
// past it are never loaded. The block walks the slot's pages up to that
// horizon and updates its running softmax once per page through
// `ptt::online_softmax_page` (common.cuh), the same routine the decode kernel
// (paged_attention.cu) calls, as the reference's `_ragged_kernel` and
// `_decode_kernel` both update per page. Row r sees the keys of a page up to
// its own position; the others weigh exactly 0, so a row with no visible key
// (an inactive slot, ctx_len 0) emits zeros (l clamped to 1e-30, as in the
// reference). With tq = 1 and q_start = ctx_len - 1 every row sees every key
// below ctx_len, the rows are the rep heads of one offset, and the
// arithmetic is the decode kernel's, bit for bit. Table ids are clamped to
// [0, n_pages). d is any multiple of 16 up to 256.
#include "common.cuh"

namespace {

using ptt::from_f32;
using ptt::kNegInf;
using ptt::to_f32;

constexpr int kThreads = 256;
constexpr int kRows = 32;                          // query rows per block
constexpr int kAcc = kRows * 256 / kThreads;       // outputs per thread: d <= 256

template <typename T>
__global__ void __launch_bounds__(kThreads)
ragged_kernel(const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
              const int* __restrict__ table, const int* __restrict__ ctx_lens,
              const int* __restrict__ q_starts, const int* __restrict__ active,
              T* __restrict__ out, int tq, int h, int h_kv, int d, int p, int n_pages,
              int max_pages, int n_tiles, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;                 // [kRows][d], pre-scaled
  float* s_s = q_s + kRows * d;      // [kRows][p] logits, then weights
  float* m_s = s_s + kRows * p;      // [kRows] running max
  float* l_s = m_s + kRows;          // [kRows] running sum
  float* a_s = l_s + kRows;          // [kRows] this page's rescale factor

  const int rep = h / h_kv;
  const int tile = blockIdx.x % n_tiles;
  const int g = (blockIdx.x / n_tiles) % h_kv;
  const int b = blockIdx.x / (n_tiles * h_kv);
  const int r0 = tile * kRows;
  const int n_rows = min(kRows, rep * tq - r0);
  const int tid = threadIdx.x;

  const int q_start = q_starts[b];
  int ctx = ctx_lens[b];
  if (active != nullptr && active[b] == 0) ctx = 0;
  ctx = min(ctx, max_pages * p);
  const int n_keys = max(0, min(ctx, q_start + (r0 + n_rows - 1) / rep + 1));

  // row rr of the tile is query offset (r0 + rr) / rep, head g * rep + (r0 + rr) % rep
  for (int e = tid; e < n_rows * d; e += kThreads) {
    const int rr = e / d, f = e % d, r = r0 + rr;
    q_s[e] = to_f32(q[(((size_t)b * tq + r / rep) * h + g * rep + r % rep) * d + f]) * scale;
  }
  for (int r = tid; r < n_rows; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  __syncthreads();

  const size_t tok_stride = (size_t)h_kv * d;
  const int n_pg = (n_keys + p - 1) / p;
  for (int pi = 0; pi < n_pg; ++pi) {
    const int page = min(max(table[(size_t)b * max_pages + pi], 0), n_pages - 1);
    const int valid = min(p, n_keys - pi * p);
    const size_t base = (size_t)page * p * tok_stride + (size_t)g * d;
    const int first = q_start - pi * p + 1;   // keys of this page row 0's offset sees
    // token loops left to the compiler: with 16 outputs per thread,
    // unrolling p.v 8 or 16 deep measured slower on the H100
    ptt::online_softmax_page<kThreads, kAcc, 0, 0>(
        q_s, n_rows, d, kp + base, vp + base, tok_stride, valid,
        [=](int rr) { return first + (r0 + rr) / rep; }, s_s, p, m_s, l_s, a_s, acc);
  }

#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int e = tid + i * kThreads;
    if (e < n_rows * d) {
      const int rr = e / d, f = e % d, r = r0 + rr;
      out[(((size_t)b * tq + r / rep) * h + g * rep + r % rep) * d + f] =
          from_f32<T>(acc[i] / fmaxf(l_s[rr], 1e-30f));
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
  const size_t smem = sizeof(float) * ((size_t)kRows * d + (size_t)kRows * p + 3 * kRows);
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
  if (h_kv <= 0 || h % h_kv != 0 || d % 16 != 0 || d <= 0 ||
      d > 32 * ptt::kPageMaxDLane || tq <= 0 || p <= 0 || n_pages <= 0 || max_pages <= 0)
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
