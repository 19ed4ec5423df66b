// Ragged paged attention on the tensor cores: the bf16 chunked-prefill build
// of `ragged_paged_attention` (tq > 1, d 64 or 128, page size a multiple of
// 16 up to 128). Slot b carries tq query tokens at global positions
// q_starts[b] + [0, tq) and attends its own KV pages causally, up to
// ctx_lens[b], with an online softmax in f32.
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py `_ragged_kernel` (called
// from `ragged_paged_attention`) on the continuous-batching engine's prefill
// (8 slots x 128-token chunks at LLaMA-7B: 32 heads, d 128, page 64). The
// per-page build (ragged_paged_attention.cu) stays for tq = 1, the verify
// entry and f32: those are held bit for bit to the decode kernel, which an
// mma's sum order cannot match.
//
// What bounds it on the H100: the bytes (q, o and the live K/V, ~65 MB at
// the serving shape, ~0.02 ms at 3.35 TB/s); the ~5 GFLOP of products take
// ~0.005 ms at the bf16 tensor-core peak. The per-page build does every
// product in f32 on the CUDA cores with a shuffle tree per (row, key) and
// reads each page's V once per owned row through L1/L2 (2.1 ms).
//
// Design: one CTA of 4 warps per (slot, kv head, tile of 64 rows of the
// group's (offset, head) rows, ordered as the per-page build's). The Q tile
// goes to swizzled shared memory by cp.async, read as mma A fragments
// (unscaled bf16; the scale is applied to the f32 scores). The
// CTA walks the slot's pages up to the tile's causal horizon; each page's K
// and V ([p, d] of one kv head, rows h_kv d apart in the pool) are copied
// by cp.async into swizzled shared memory, double-buffered, so page i + 1
// is in flight while page i computes. Warp w owns rows 16 w..16 w + 15: in
// chunks of KC keys it computes S = Q K^T (mma.sync m16n8k16, f32
// accumulators), masks keys past each row's horizon only in a chunk that
// crosses one, updates the running max and sum in registers (quad
// shuffles), rescales O and adds P V with P packed to bf16 straight from
// the score registers, as three terms (P = hi + mid + lo, each bf16, the
// rest below 2^-27 P): a single bf16 P moves the f32 output by ~2^-9 of
// itself, enough to flip the rounding of a bf16 output in [2, 4) (one ulp,
// 0.0156), where the three terms keep it at the f32 sums' error; V, Q and
// K are bf16 already, so every product is exact. The two extra P V steps
// cost little: the kernel is bound by bytes. A warp stops at its own
// rows' horizon. Rows with no
// visible key (inactive slots, ctx 0) give exact zeros (l clamped to
// 1e-30); padded rows past a chunk's end see keys up to ctx and stay
// finite. K/V rows past the page's live tokens are zero-filled, never read
// from the pool. The output goes through shared memory to 16-byte stores.
//
// Why mma.sync and not wgmma: a warp's 16 rows own their softmax state in
// the mma's C layout, and P reaches the P V product from registers with no
// shared-memory round trip; at this shape the kernel is bound by bytes and
// latency, not by the tensor-core rate wgmma would add. cp.async and not
// TMA: a page's K rows sit h_kv d apart in the pool and the page id comes
// from the table; a 128-thread cp.async loop handles both with no tensor
// map per pool.
//
// ptxas (sm_90a, CUDA 12.8; chip_smoke's build phase): d 64 / KC 16 95
// registers, no spill; d 64 / KC 64 128, 16 B spilled; d 128 / KC 16 164, no
// spill; d 128 / KC 64 (the serving shape's build) 168, 56 B spilled. HMMA
// instructions in cuobjdump's SASS: 32 / 128 / 64 / 256.
#include "common.cuh"
#include "mma.cuh"

namespace {

using ptt::kNegInf;
using namespace ptt::mma;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kRows = 64;  // query rows per CTA, 16 per warp

template <int D>
constexpr size_t smem_bytes(int p) {
  return (size_t)kRows * D * 2 + 4 * (size_t)p * D * 2;  // Q, 2 stages of K and V
}

template <int D, int KC>
__global__ void __launch_bounds__(kThreads)
ragged_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kp,
                 const bf16* __restrict__ vp, const int* __restrict__ table,
                 const int* __restrict__ ctx_lens, const int* __restrict__ q_starts,
                 const int* __restrict__ active, bf16* __restrict__ out, int tq, int h,
                 int h_kv, int p, int n_pages, int max_pages, int n_tiles, float scale_log2) {
  constexpr int kCh = D / 8;  // 16-byte chunks per row
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t q_s = smem_addr(smem);
  const uint32_t kv_s = q_s + kRows * D * 2;
  const uint32_t page_bytes = (uint32_t)p * D * 2;

  const int rep = h / h_kv;
  const int tile = blockIdx.x % n_tiles;
  const int g = (blockIdx.x / n_tiles) % h_kv;
  const int b = blockIdx.x / (n_tiles * h_kv);
  const int r0 = tile * kRows;
  const int n_rows = min(kRows, rep * tq - r0);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  const int q_start = q_starts[b];
  int ctx = ctx_lens[b];
  if (active != nullptr && active[b] == 0) ctx = 0;
  ctx = min(ctx, max_pages * p);
  const int n_keys = max(0, min(ctx, q_start + (r0 + n_rows - 1) / rep + 1));
  const int n_pg = (n_keys + p - 1) / p;

  // row rr of the tile is query offset (r0 + rr) / rep, head g * rep + (r0 + rr) % rep
  for (int e = tid; e < kRows * kCh; e += kThreads) {
    const int rr = e / kCh, c = e % kCh, r = r0 + rr;
    const bool in = rr < n_rows;
    const bf16* src = in ? q + (((size_t)b * tq + r / rep) * h + g * rep + r % rep) * D + c * 8 : q;
    cp_async16(q_s + swz<D>(rr, c), src, in);
  }
  const size_t tok_stride = (size_t)h_kv * D;
  auto load_page = [&](int pi, int stage) {
    const int page = min(max(table[(size_t)b * max_pages + pi], 0), n_pages - 1);
    const int valid = min(p, n_keys - pi * p);
    const size_t base = (size_t)page * p * tok_stride + (size_t)g * D;
    const uint32_t ks = kv_s + stage * 2 * page_bytes, vs = ks + page_bytes;
    for (int e = tid; e < p * kCh; e += kThreads) {
      const int t = e / kCh, c = e % kCh;
      const bool in = t < valid;
      const size_t off = in ? base + t * tok_stride + c * 8 : base;
      cp_async16(ks + swz<D>(t, c), kp + off, in);
      cp_async16(vs + swz<D>(t, c), vp + off, in);
    }
  };
  if (n_pg > 0) load_page(0, 0);
  cp_async_commit();  // Q and page 0

  // this thread's two rows (g, g + 8 of the warp's 16) and their horizons;
  // rows past n_rows see the tile's keys (never written)
  const int gq = lane / 4, t4 = lane % 4;
  int lim[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rr = warp * 16 + gq + 8 * i;
    lim[i] = rr < n_rows ? min(ctx, q_start + (r0 + rr) / rep + 1) : n_keys;
  }
  const int lim_lo = min(lim[0], lim[1]);
  int warp_hi = max(lim[0], lim[1]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) warp_hi = max(warp_hi, __shfl_xor_sync(0xffffffffu, warp_hi, o));

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int pi = 0; pi < n_pg; ++pi) {
    if (pi + 1 < n_pg) load_page(pi + 1, (pi + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const uint32_t ks = kv_s + (pi & 1) * 2 * page_bytes, vs = ks + page_bytes;
    for (int c0 = 0; c0 < p; c0 += KC) {
      const int key0 = pi * p + c0;
      if (key0 >= warp_hi) break;  // every row of the warp is past its horizon
      float s[KC / 8][4];
#pragma unroll
      for (int j = 0; j < KC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t qa[4];
        load_a<D>(qa, q_s, warp * 16, kk, lane);
#pragma unroll
        for (int nn = 0; nn < KC / 16; ++nn) {
          uint32_t bb[4];
          load_bt<D>(bb, ks, c0 + nn * 16, kk, lane);
          mma_bf16(s[2 * nn], qa, bb[0], bb[1]);
          mma_bf16(s[2 * nn + 1], qa, bb[2], bb[3]);
        }
      }
      // scores in the log2 domain; keys at or past a row's horizon masked
      const bool crosses = key0 + KC > lim_lo;
#pragma unroll
      for (int j = 0; j < KC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = key0 + j * 8 + 2 * t4 + (e & 1);
          const float x = s[j][e] * scale_log2;
          s[j][e] = (crosses && col >= lim[e >> 1]) ? kNegInf : x;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < KC / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx);
        const float alpha = exp2f(m[i] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < KC / 8; ++j)
#pragma unroll
          for (int e = 2 * i; e < 2 * i + 2; ++e) {
            const float x = s[j][e];
            const float pr = x > kNegInf ? exp2f(x - m_new) : 0.f;
            s[j][e] = pr;
            sum += pr;
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l[i] = fmaf(alpha, l[i], sum);
        m[i] = m_new;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          acc[n][2 * i] *= alpha;
          acc[n][2 * i + 1] *= alpha;
        }
      }
      // O += P V, P as three bf16 terms packed from the score registers
#pragma unroll
      for (int kc = 0; kc < KC / 16; ++kc) {
        float x[8] = {s[2 * kc][0],     s[2 * kc][1],     s[2 * kc][2],     s[2 * kc][3],
                      s[2 * kc + 1][0], s[2 * kc + 1][1], s[2 * kc + 1][2], s[2 * kc + 1][3]};
        uint32_t a[3][4];
#pragma unroll
        for (int part = 0; part < 3; ++part)
#pragma unroll
          for (int r = 0; r < 4; ++r) a[part][r] = split_bf16(x[2 * r], x[2 * r + 1]);
#pragma unroll
        for (int nd = 0; nd < D / 16; ++nd) {
          uint32_t bb[4];
          load_b<D>(bb, vs, c0 + kc * 16, nd, lane);
#pragma unroll
          for (int part = 0; part < 3; ++part) {
            mma_bf16(acc[2 * nd], a[part], bb[0], bb[1]);
            mma_bf16(acc[2 * nd + 1], a[part], bb[2], bb[3]);
          }
        }
      }
    }
    __syncthreads();  // this stage is rewritten by page pi + 2
  }
  cp_async_wait<0>();
  __syncthreads();

  // O / l through the (free) Q tile, then 16-byte stores of the live rows
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rr = warp * 16 + gq + 8 * i;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const uint32_t v = pack_bf16(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
      const uint32_t addr = q_s + swz<D>(rr, n) + 4 * t4;
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
    }
  }
  __syncthreads();
  for (int e = tid; e < n_rows * kCh; e += kThreads) {
    const int rr = e / kCh, c = e % kCh, r = r0 + rr;
    uint4 v;
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "r"(q_s + swz<D>(rr, c))
                 : "memory");
    *reinterpret_cast<uint4*>(out + (((size_t)b * tq + r / rep) * h + g * rep + r % rep) * D +
                              c * 8) = v;
  }
}

template <int D, int KC>
cudaError_t launch(const void* q, const void* kp, const void* vp, const int* table,
                   const int* ctx, const int* starts, const int* active, void* out, int b,
                   int tq, int h, int h_kv, int p, int n_pages, int max_pages, float scale,
                   cudaStream_t s) {
  const int rep = h / h_kv;
  const int n_tiles = (rep * tq + kRows - 1) / kRows;
  const size_t smem = smem_bytes<D>(p);
  cudaError_t err = ptt::allow_smem(ragged_tc_kernel<D, KC>, smem);
  if (err != cudaSuccess) return err;
  ragged_tc_kernel<D, KC><<<b * h_kv * n_tiles, kThreads, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kp), static_cast<const bf16*>(vp),
      table, ctx, starts, active, static_cast<bf16*>(out), tq, h, h_kv, p, n_pages, max_pages,
      n_tiles, scale * kLog2e);
  return cudaSuccess;
}

}  // namespace

// q and out: [b, tq, h, d] bf16; pages [n_pages, p, h_kv, d] bf16; table
// [b, max_pages]; ctx_lens, q_starts and active [b] int32 (active may be
// null: every slot live). d 64 or 128; p a multiple of 16 up to 128; q,
// the pools and out 16-byte aligned.
extern "C" int ptt_ragged_paged_attention_tc(const void* q, const void* k_pages,
                                             const void* v_pages, const void* table,
                                             const void* ctx_lens, const void* q_starts,
                                             const void* active, void* out, int b, int tq,
                                             int h, int h_kv, int d, int p, int n_pages,
                                             int max_pages, float scale, int device,
                                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (h_kv <= 0 || h % h_kv != 0 || (d != 64 && d != 128) || p % 16 != 0 || p <= 0 ||
      p > 128 || tq <= 0 || n_pages <= 0 || max_pages <= 0)
    return (int)cudaErrorInvalidValue;
  if (b == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(table);
  const int* cl = static_cast<const int*>(ctx_lens);
  const int* st = static_cast<const int*>(q_starts);
  const int* ac = static_cast<const int*>(active);
#define PTT_RAGGED_TC(D, KC)                                                                \
  launch<D, KC>(q, k_pages, v_pages, tb, cl, st, ac, out, b, tq, h, h_kv, p, n_pages,     \
                max_pages, scale, s)
  if (d == 128)
    err = p % 64 == 0 ? PTT_RAGGED_TC(128, 64) : PTT_RAGGED_TC(128, 16);
  else
    err = p % 64 == 0 ? PTT_RAGGED_TC(64, 64) : PTT_RAGGED_TC(64, 16);
#undef PTT_RAGGED_TC
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
