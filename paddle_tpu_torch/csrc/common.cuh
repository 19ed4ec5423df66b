// Shared helpers for the paddle_tpu_torch CUDA kernels.
#pragma once
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>
#include <vector>

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

// N independent warp sums at once (N a power of two up to 32), each by
// `warp_sum`'s own xor tree: at level o every sum adds the partial of lane
// i ^ o to lane i's, as `warp_sum` does, so every sum keeps its operands
// and its order and gives `warp_sum`'s bits. While a lane holds several
// sums it keeps half of them at each level and sends the other half, so
// the trees share shuffles: N sums take N - 1 + 5 - log2 N shuffles, not
// 5 N. On return lane i holds sum number i >> (5 - log2 N) in v[0].
template <int L, int N>
__device__ __forceinline__ void warp_sum_levels(float (&v)[N], int lane) {
  if constexpr (L < 5) {
    constexpr int o = 16 >> L;
    constexpr int n = (N >> L) > 1 ? (N >> L) : 1;
    if constexpr (n > 1) {
      const bool up = (lane & o) != 0;
#pragma unroll
      for (int k = 0; k < n / 2; ++k) {
        const float send = up ? v[k] : v[k + n / 2];
        const float keep = up ? v[k + n / 2] : v[k];
        v[k] = keep + __shfl_xor_sync(0xffffffffu, send, o);
      }
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
    }
    warp_sum_levels<L + 1, N>(v, lane);
  }
}

template <int N>
__device__ __forceinline__ float warp_sum_many(float (&v)[N], int lane) {
  static_assert(N >= 1 && N <= 32 && (N & (N - 1)) == 0, "N: a power of two up to 32");
  warp_sum_levels<0, N>(v, lane);
  return v[0];
}

__host__ __device__ constexpr int log2_exact(int n) {
  return n <= 1 ? 0 : 1 + log2_exact(n / 2);
}

// The attention-dropout keep bit of the reference's flash kernels
// (paddle_tpu/ops/pallas/flash_attention.py `_dropout_keep`): an
// xxhash-style avalanche of (seed, slice = batch * heads + head, global
// query row, global key column) in uint32 arithmetic, kept where the hash
// is at or above thresh = min(int(p * 2^32), 2^32 - 1). The forward and
// the backward kernels call it on the same tuple, so the mask is never
// stored, and it is the reference's mask bit for bit.
__device__ __forceinline__ bool dropout_keep(uint32_t seed, uint32_t slice, uint32_t row,
                                             uint32_t col, uint32_t thresh) {
  uint32_t h = seed * 2654435761u + slice * 0x9E3779B9u;
  h = h ^ (row * 0x85EBCA6Bu) ^ (col * 0xC2B2AE35u);
  h ^= h >> 15;
  h *= 0x2C1B3C6Du;
  h ^= h >> 12;
  h *= 0x297A2D39u;
  h ^= h >> 15;
  return h >= thresh;
}

// Dropout of one launch: on, the seed, the threshold and 1 / (1 - p)
// rounded to f32 (the reference's `jnp.float32(1.0 / (1.0 - p))`).
struct Dropout {
  int on;
  uint32_t seed, thresh;
  float inv_keep;
};

// An additive attention mask as the flash kernels read it: f32 element
// (batch, head, query row, key column) at p[b * sb + h * sh + row * sq +
// col * sk]. The strides are in elements; a broadcast dim has stride 0, so
// a [b, 1, 1, s] key-padding mask is read in place for every head and row.
struct AddMask {
  const float* p;
  long long sb, sh, sq, sk;
  __device__ __forceinline__ float at(int b, int h, int row, int col) const {
    return p[b * sb + h * sh + row * sq + col * sk];
  }
};

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
// Keys a row may not see change none of its bits: their logits are
// kNegInf, so the page max keeps m, their weights are exact zeros, and a
// zero term leaves the sums of steps 2 and 3 as they were (pool values are
// finite). A page the row sees none of is then an exact no-op: m_new = m,
// alpha = exp(0) = 1, l = fmaf(1, l, 0) and acc = fmaf(1, acc, 0). So a
// row walked past its own horizon (the ragged kernel's verify rows, whose
// tile walks to the last feed position) equals the decode step that stops
// at it.
// s_s: [n_rows][ss] scratch (ss >= valid); m_s, l_s, a_s: [n_rows].
// d <= 256 (kMaxDLane lanes' worth) and n_rows * d <= kAcc * kThreads.
// A positive kUnrollQK / kUnrollPV unrolls the token loop of step 1 / 3 by
// that factor (more loads in flight); 0 leaves it to the compiler. Unrolling
// keeps every sum's order, so it never changes a bit: the decode kernel,
// whose few rows leave each thread one long chain of dependent loads,
// unrolls; the ragged kernel, with many accumulators per thread, does not.
// A positive kRowsCT (a compile-time bound on n_rows) with kTokG tokens a
// warp at a time (kRowsCT * kTokG a power of two up to 32) runs step 1 on
// groups: the warp forms the kRowsCT * kTokG (row, token) partials, each
// by the same per-lane fmaf chain, and sums them with one
// `warp_sum_many`, whose trees are `warp_sum`'s: the same bits, with the
// shuffles shared and the trees of several rows and tokens in flight at
// once. Its loads are branch-free, so a group's are in flight together.
// Step 3 then runs on quads: unit u = tid + i * kThreads owns the four
// outputs 4 (u % (d / 4)) + c of row u / (d / 4) in acc[4 i + c] (the
// callers' epilogue follows this map) and reads their v elements with one
// load a token; every output keeps its fmaf chain. kRowsCT = 0 keeps the
// per-token loop and the map above, instruction for instruction (the
// decode megakernel's attention phase).
constexpr int kPageMaxDLane = 8;

// four consecutive elements as f32 with one load (8 bytes of bf16, 16 of
// f32; the address on that many bytes)
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(x.x << 16);  // bf16 to f32 is exact: the bits shifted up
  v[1] = __uint_as_float(x.x & 0xffff0000u);
  v[2] = __uint_as_float(x.y << 16);
  v[3] = __uint_as_float(x.y & 0xffff0000u);
}

template <int kThreads, int kAcc, int kUnrollQK, int kUnrollPV, int kRowsCT = 0,
          int kTokG = 1, typename T, typename RowKeys>
__device__ __forceinline__ void online_softmax_page(
    const float* q_s, int n_rows, int d, const T* __restrict__ kb,
    const T* __restrict__ vb, size_t tok_stride, int valid, RowKeys row_keys,
    float* s_s, int ss, float* m_s, float* l_s, float* a_s, float (&acc)[kAcc]) {
  constexpr int kWarps = kThreads / 32;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  constexpr int kSums = kRowsCT > 0 ? kRowsCT * kTokG : 1;
  constexpr int kShift = 5 - log2_exact(kSums);
  auto logit_groups = [&](int t0) {
    float part[kSums];
#pragma unroll
    for (int s = 0; s < kSums; ++s) part[s] = 0.f;
#pragma unroll
    for (int i = 0; i < kPageMaxDLane; ++i) {
      if (32 * i < d) {
        // branch-free, so the loads of a group are in flight together: a
        // lane past d reads column d - 1 and adds nothing, tokens past the
        // page's end read its last row and rows past n_rows the last row
        // (those sums are never stored)
        const int j = lane + 32 * i;
        const bool j_in = j < d;
        const int jc = j_in ? j : d - 1;
        float kv[kTokG];
#pragma unroll
        for (int g = 0; g < kTokG; ++g)
          kv[g] = to_f32(kb[(size_t)min(t0 + g, valid - 1) * tok_stride + jc]);
#pragma unroll
        for (int r = 0; r < kRowsCT; ++r) {
          const float qv = q_s[min(r, n_rows - 1) * d + jc];
#pragma unroll
          for (int g = 0; g < kTokG; ++g) {
            const float f = fmaf(qv, kv[g], part[r * kTokG + g]);
            part[r * kTokG + g] = j_in ? f : part[r * kTokG + g];
          }
        }
      }
    }
    const float sum = warp_sum_many<kSums>(part, lane);
    const int s = lane >> kShift, r = s / kTokG, t = t0 + s % kTokG;
    if ((lane & ((1 << kShift) - 1)) == 0 && r < n_rows && t < valid)
      s_s[r * ss + t] = t < row_keys(r) ? sum : kNegInf;
  };

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
  if constexpr (kRowsCT > 0) {
    const int n_groups = (valid + kTokG - 1) / kTokG;
#pragma unroll 1
    for (int c = warp; c < n_groups; c += kWarps) logit_groups(c * kTokG);
  } else if constexpr (kUnrollQK > 0) {
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
      float e;
      if constexpr (kRowsCT > 0) {
        const float ex = expf(x - m_new);   // computed either way: no branch
        e = x > kNegInf ? ex : 0.f;
      } else {
        e = x > kNegInf ? expf(x - m_new) : 0.f;
      }
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

  if constexpr (kRowsCT > 0) {
    // step 3 on quads: unit u = tid + i * kThreads owns outputs 4 f' .. 4 f'
    // + 3 of row u / (d / 4), f' = u % (d / 4), in acc[4 i .. 4 i + 3]
    // (the callers' epilogue follows this map), and reads their four v
    // elements with one load a token; each output keeps its own fmaf chain
    // over t in order
    constexpr int kUnits = kAcc / 4;
    static_assert(kAcc % 4 == 0, "kAcc: whole quads");
    const int dq = d >> 2, nq = n_rows * dq;
#pragma unroll
    for (int i = 0; i < kUnits; ++i) {
      const int u = tid + i * kThreads;
      if (u < nq) {
        const int r = u / dq, f = 4 * (u - r * dq);
        const float* wr = s_s + r * ss;
        const T* vq = vb + f;
        float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll(kUnrollPV > 0 ? kUnrollPV : 1)
        for (int t = 0; t < valid; ++t) {
          float v[4];
          load4(vq + t * tok_stride, v);
          const float w = wr[t];
#pragma unroll
          for (int c = 0; c < 4; ++c) sum[c] = fmaf(w, v[c], sum[c]);
        }
        const float alpha = a_s[r];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[4 * i + c] = fmaf(alpha, acc[4 * i + c], sum[c]);
      }
    }
    __syncthreads();  // s_s and a_s are rewritten by the next page
    return;
  }
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

// ---------------------------------------------------------------- staged pages
// A ring of `stages` KV pages of one kv head in shared memory, filled by the
// copy engine (TMA) several pages ahead of the page a block works on;
// shared by the decode kernel and the ragged kernel's per-page build. Stage
// s holds one page's K rows, then its V rows, each [p][d] with row stride d
// (so `online_softmax_page` reads them at tok_stride = d), and one
// mbarrier. Page pi goes to stage pi % stages and is the (pi / stages)-th
// fill of that stage: its barrier phase has parity (pi / stages) & 1.
//
// issue(pi): thread 0 arms the stage's barrier with the page's exact byte
// count, 2 * valid * d * sizeof(T). A full page (valid = p) of a ring built
// with tensor maps (`tma`: the pools as 2-D [n_pages * p, h_kv * d] maps,
// boxes of d x p) is two tensor copies issued by thread 0: K and V at
// column g * d, row page * p. A page the block walks only in part (the last
// one: positions at or past the keys' end are never loaded), or every page
// of a ring without maps, is one bulk copy (`cp.async.bulk`) per token row,
// d * sizeof(T) contiguous bytes at (page * p + t) * tok_stride of the
// block's head, the rows spread over the block's threads (a warp issues
// its lanes' bulk copies one after another). The page ids are the block's
// row of the page table clamped to [0, n_pages), read into shared memory
// before the walk, so an issue waits on no device load. wait(pi)
// (every thread) polls the barrier; a phase that never completes traps
// after ~2^26 polls rather than hanging the card. A stage is refilled only
// after the block barrier that ends the page's `online_softmax_page`, so no
// warp still reads it. The pools start on 16 bytes (the wrappers check),
// rows are d * sizeof(T) bytes (d a multiple of 16), and the ring starts on
// 128 bytes with stages a multiple of 128 bytes when it takes maps, as the
// copies require.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

constexpr int kRingMaxStages = 32;  // the deepest ring a C entry accepts

template <typename T>
struct PageRing {
  T* buf;             // [stages][2][p][d], on 128 bytes
  uint64_t* bar;      // [stages]
  const T* kp;        // the K pool at this block's kv head (+ g * d)
  const T* vp;        // the V pool likewise
  const CUtensorMap* kmap;  // the pools' maps (null: row copies only)
  const CUtensorMap* vmap;
  const int* table;   // the block's page ids, clamped (in shared memory)
  size_t tok_stride;  // elements between token rows in the pools (h_kv * d)
  int stages, p, d, n_pages, n_keys, col;  // col: g * d, the head's first column

  // shared memory of the ring: the stages' rows, then the barriers
  static __host__ __device__ size_t bytes(int stages, int p, int d) {
    return (size_t)stages * (2 * (size_t)p * d * sizeof(T) + sizeof(uint64_t));
  }
  // a ring of these pages can take tensor copies: a box row is at most
  // 256 tokens and a stage's K and V halves stay on 128 bytes
  static __host__ __device__ bool maps_fit(int p, int d) {
    return p <= 256 && ((size_t)p * d * sizeof(T)) % 128 == 0;
  }
  __device__ int pages() const { return (n_keys + p - 1) / p; }
  __device__ int valid(int pi) const { return min(p, n_keys - pi * p); }
  __device__ const T* k(int pi) const { return buf + (size_t)(pi % stages) * 2 * p * d; }
  __device__ const T* v(int pi) const { return k(pi) + (size_t)p * d; }

  // thread 0; the caller's block barrier follows before any issue or wait
  __device__ void init() const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < stages; ++s)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar + s)),
                     "r"(1u)
                     : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }

  // every thread of the block calls it
  __device__ void issue(int pi) const {
    const int s = pi % stages, n = valid(pi);
    const int page = table[pi];
    const uint32_t row = (uint32_t)(d * sizeof(T));
    const uint32_t b = smem_u32(bar + s);
    T* ks = buf + (size_t)s * 2 * p * d;
    T* vs = ks + (size_t)p * d;
    // the stage's last readers were generic loads: order them before the
    // copy engine's writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (threadIdx.x == 0)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
                   "r"(2u * (uint32_t)n * row)
                   : "memory");
    if (kmap != nullptr && n == p) {
      if (threadIdx.x == 0) {
        asm volatile(
            "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(ks)),
            "l"(reinterpret_cast<uint64_t>(kmap)), "r"(col), "r"(page * p), "r"(b)
            : "memory");
        asm volatile(
            "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(vs)),
            "l"(reinterpret_cast<uint64_t>(vmap)), "r"(col), "r"(page * p), "r"(b)
            : "memory");
      }
      return;
    }
    const size_t src = (size_t)page * p * tok_stride;
    for (int c = threadIdx.x; c < 2 * n; c += blockDim.x) {
      const int t = c >> 1;
      const size_t off = src + (size_t)t * tok_stride;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32((c & 1 ? vs : ks) + (size_t)t * d)),
          "l"(reinterpret_cast<uint64_t>((c & 1 ? vp : kp) + off)), "r"(row), "r"(b)
          : "memory");
    }
  }

  __device__ void wait(int pi) const {
    const uint32_t b = smem_u32(bar + pi % stages);
    const uint32_t parity = (uint32_t)(pi / stages) & 1u;
    uint32_t done = 0;
    for (uint32_t polls = 0; !done; ++polls) {
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(b), "r"(parity)
          : "memory");
      if (polls > (1u << 26)) __trap();
    }
  }
};

// libcuda's cuTensorMapEncodeTiled, looked up once by name at run time
// (the library is not linked against libcuda).
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(f);
  }
  return fn;
}

// A KV pool [n_pages, p, h_kv, d] as a 2-D map [n_pages * p rows, h_kv * d
// columns] with d x p boxes (one page of one kv head), no swizzle: a box
// lands in shared memory as [p][d] rows. False if the encode fails.
// The maps of the last kMapCache pools are kept (a pool is launched on once
// a layer and a step), so a launch usually encodes none.
constexpr size_t kMapCache = 256;

template <typename T>
inline bool pool_map(CUtensorMap* map, const void* pool, int n_pages, int p, int h_kv, int d) {
  struct Entry {
    const void* pool;
    int n_pages, p, h_kv, d;
    CUtensorMap map;
  };
  static std::mutex mu;
  static std::vector<Entry> cache;
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : cache)
    if (e.pool == pool && e.n_pages == n_pages && e.p == p && e.h_kv == h_kv && e.d == d) {
      *map = e.map;
      return true;
    }
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)h_kv * d, (cuuint64_t)n_pages * p};
  const cuuint64_t strides[1] = {(cuuint64_t)h_kv * d * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)d, (cuuint32_t)p};
  const cuuint32_t estr[2] = {1, 1};
  const CUtensorMapDataType dt = std::is_same<T, float>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (enc(map, dt, 2, const_cast<void*>(pool), dims, strides, box, estr,
          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  if (cache.size() >= kMapCache) cache.erase(cache.begin());
  cache.push_back(Entry{pool, n_pages, p, h_kv, d, *map});
  return true;
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

// The opt-in for one kernel, remembered per device: set again only when a
// launch needs more than the last one set there (a host call saved on
// every launch of a kernel launched many times a step).
struct SmemOptIn {
  static constexpr int kDevices = 64;
  int bytes[kDevices] = {};
  template <typename K>
  cudaError_t allow(K kernel, size_t need, int device) {
    if (need <= 48 * 1024) return cudaSuccess;
    if (device >= 0 && device < kDevices && bytes[device] >= (int)need) return cudaSuccess;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)need);
    if (err == cudaSuccess && device >= 0 && device < kDevices) bytes[device] = (int)need;
    return err;
  }
};

// Dynamic shared memory above 48 KB needs an explicit opt-in per kernel.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace ptt
