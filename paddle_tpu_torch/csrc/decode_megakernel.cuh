// Whole-step decode megakernel: the decoder layers of one LLaMA decode step
// (and, with the head, the final norm, the lm_head and the greedy argmax)
// in one persistent cooperative launch. The kernel body; its builds and C
// entry points are decode_megakernel.cu (seg "full") and
// decode_megakernel_tp.cu (the tensor-parallel segments).
//
// Replaces: paddle_tpu/ops/pallas/decode_megakernel.py `_mk_kernel` (seg
// "full", tq = 1 and the tq > 1 speculative verify of
// decode_megakernel.py:494-530, the greedy head and the head_k > 1 top-K
// fold of decode_megakernel.py:616-656, and the tensor-parallel segments
// qkv / tail / down of decode_megakernel.py:72-77, :312, :709-712), called
// from `decode_megakernel`. On the TPU
// one core walks a static schedule of weight tiles in order and keeps the
// activations in VMEM between tiles; here 132 SMs work at once, so the walk
// becomes phases of independent work units separated by grid-wide barriers,
// and the activations between phases live in small global scratch buffers
// (R x width, in L2).
//
// What bounds it on the H100: every weight of the step read once (7B:
// 13.2 GB in bf16, 6.6 GB in int8) plus the live KV rows, over 3.35 TB/s.
// A decode step at R <= 8 rows does 2 R flops per weight element, far below
// the tensor cores' ~295 flops per byte: it is a chain of GEMVs, and the
// only things that matter are streaming the bytes and not idling between
// phases. This first version aims at right and simple: CUDA-core f32 sums,
// no TMA, one barrier per phase.
//
// Design, per layer (R rows = the slot bucket, inactive slots inside it):
//  1. every block computes norm1 of all R rows of h into shared memory
//     itself (no barrier needed before it);
//  2. Q/K/V: work units are 32-column slabs of wq | wk | wv, each run by
//     `ptt::gemv_slab` (common.cuh), the int8 matmul kernel's GEMV, so an
//     int8 projection sums in that kernel's order; outputs go to a qkv
//     scratch in the compute dtype (the op chain's rounding point);
//  -- grid barrier --
//  3. attention (`attention_phase`, out of line so that its registers do
//     not add to the other phases'): units (slot, kv head). A slot owns tq
//     rows (tq > 1: the verify pass's feed rows, row t at position
//     lens + t). The unit ropes each row's k row at its position (torch's
//     bf16 order: each product rounded, then the sum) and writes the k and
//     v rows into the layer's pool in place at their flat rows (a row
//     outside `wmask`, or of an inactive slot, writes the scratch row
//     `oob`, as the engine's `_write_kv` does), then, row by row, ropes the
//     row's q heads and walks the slot's pages up to the row's own position
//     (the ragged causal mask) with
//     `ptt::online_softmax_page`, the paged-attention kernel's per-page step
//     with its unroll arguments (2, 16): on the same q and pool the output
//     equals that kernel's bit for bit (the routine's arithmetic does not
//     depend on the block size). Inactive slots skip the page reads and
//     emit zeros (l clamped to 1e-30). Row t of a verify pass is thus the
//     decode step at lens + t, page for page and bit for bit; looping the
//     rows keeps the scratch at one row's rep heads (any GQA group the
//     tq = 1 step takes) and the register sums at R <= 8 rows: the
//     wrapper splits a pass into launches of floor(8 / tq) whole slots;
//  -- grid barrier --
//  4. O: 32-column slabs of wo, the residual added in the epilogue
//     (h + o, each rounded to the compute dtype); a unit owns its columns;
//  -- grid barrier --
//  5. every block computes norm2 into shared memory; units are 32-column
//     slabs of the ffn width, each running the gate slab then the up slab
//     and fusing SwiGLU (silu in f32, rounded, times u) in the epilogue;
//  -- grid barrier --
//  6. down: 32-column slabs of wd, residual in the epilogue;
//  -- grid barrier (except after the last layer without a head) --
// With the head: the final norm, 32-column slabs of the lm_head (logits
// rounded to the compute dtype and written out), a running (max, argmax)
// per block over its slabs in ascending order (strictly greater wins), one
// barrier, then block 0 reduces the blocks' pairs: a larger value wins, an
// equal one goes to the smaller id. That is the first-max-wins rule of
// argmax over the whole row.
//
// The top-K fold (head_k = K > 1, the sampling path): no logits are written.
// Each block keeps, per row, a sorted list of its best K (value, id) pairs
// in shared memory, ordered by value descending then id ascending (the
// order of lax.top_k; a block's slabs are strided over the vocabulary, so
// the order key is the pair, never the arrival order). After each slab one
// warp per row ranks the slab's 32 candidates by shuffles and merges them
// into its list (`warp_merge`: every entry's output position is its index
// plus the number of entries of the other list ahead of it, found by a
// binary search; equal keys put the list first). Pad columns carry -inf
// and ids >= V, so they never pass a real column. The blocks then write
// their lists to a [grid, R, K] scratch and merge them pairwise in
// ceil(log2 grid) rounds, one grid barrier each; block 0 writes the final
// (topv, topi). Only selection happens, so the result equals a stable
// top-K of the cast logits bit for bit. The lists live in shared memory
// (24 R max(K, 32) bytes), not registers: the kernel is at 255 registers.
// The fold is an out-of-line function (`head_fold`): inlined, it changed
// the register allocation of the layer phases and slowed the R = 8 whole
// step (PERF.md).
//
// The tensor-parallel segments (kSeg, a template parameter: each segment is
// its own build, and the full build keeps its instructions) split a layer at
// the reference's exact-mode gather boundaries, so one shard runs its share
// and the engine gathers between launches: kSegQkv runs phases 1-3 on the
// shard's local heads and writes `attn` [R, nh d] (h is read only);
// kSegTail runs phases 4-5, O reading the gathered `attn` [R, nh d]
// against the replicated wo, and writes the local `act` [R, F]; kSegDown
// runs phase 6, down reading the gathered `act` [R, F] against the
// replicated wd, then the head over the shard's vocab slice (local ids).
// The arguments carry each segment's widths: nh and nh_kv are the shard's
// head counts for qkv and the full ones for tail (O reads every head), F
// is the local ffn width for tail and the full one for down (down reads
// the gathered row), so each phase reads its widths as the full build
// does, and the argument struct is the full build's. A segment runs one
// layer. A shard's column slices keep each
// column's place in its 32-wide slab when the local widths are multiples of
// 32 (7B at tp 2 and 4), so its outputs are the matching columns of the
// full launch's, bit for bit.
//
// Memory ordering: values one phase writes and another block reads after a
// barrier (h, qkv, attn, act, the partials) are read with ld.global.cg
// (L2, never a stale L1 line); pool rows are written and read back by the
// same block, ordered by __syncthreads. Weights are read-only for the
// launch. The grid is the SM count times the occupancy the runtime reports,
// so every block is resident; a refused cooperative launch is an error.
#pragma once
#include "common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

// Arguments of one launch. Must match _MkArgs in
// paddle_tpu_torch/ops/pallas/decode_megakernel.py field for field.
struct PttMkArgs {
  const long long* ptrs;  // pointer table [(L + 1) * kPtrs] int64
  void* h;                // [R, H]  in place
  void* qkv;              // [R, NQ + 2 NK] scratch
  void* attn;             // [R, NQ] scratch
  void* act;              // [R, F]  scratch
  const int* table;       // [R / tq, max_pages], per slot
  const int* lens;        // [R / tq] tokens cached before this step
  const int* active;      // [R / tq]
  const float* cos;       // [max_len, hd / 2]
  const float* sin;
  void* logits;           // [R, V] (head only)
  int* tok;               // [R]
  float* maxv;            // [R]
  float* part_v;          // [max_grid, R]
  int* part_i;
  float* topv;            // [R, head_k] (head_k > 1)
  int* topi;
  float* fold_v;          // [max_grid, R, head_k] per-block lists
  int* fold_i;
  const int* wmask;       // [R] pool-write gate of each row, or null (all)
  int layer0, n_layers, head_row;  // head_row < 0: no head
  int R, H, nh, nh_kv, hd, F, V;
  int p, n_pages, max_pages, oob, max_len, max_grid;
  int head_k;             // 1: greedy argmax; 2..128: the top-K fold
  int tq;                 // rows per slot: 1, or T of a verify pass
  float eps, scale;
};

namespace {

using ptt::from_f32;
using ptt::kNegInf;
using ptt::kSlabCols;
using ptt::to_f32;

constexpr int kThreads = ptt::kSlabThreads;  // 256
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 8;
constexpr int kAttnAcc = 8;  // rep * d <= kAttnAcc * kThreads = 2048
constexpr int kRed = kWarps * kMaxRows * kSlabCols;  // GEMV reduction floats
constexpr int kNormAux = kWarps * kMaxRows + kMaxRows;
constexpr int kAux = kNormAux + 2 * kMaxRows * kSlabCols + 2 * kMaxRows;

// one row of the pointer table per layer, then one for the head
enum : int {
  P_LN1, P_LN2, P_WQ, P_SQ, P_WK, P_SK, P_WV, P_SV, P_WO, P_SO,
  P_WG, P_SG, P_WU, P_SU, P_WD, P_SD, P_KP, P_VP, kPtrs
};
// the phases of a build (the reference's SEG_PHASES)
enum : int { kSegFull = 0, kSegQkv = 1, kSegTail = 2, kSegDown = 3 };
enum : int { P_NF = 0, P_WH = 1, P_SH = 2 };

template <typename T>
__device__ __forceinline__ T ld_cg(const T* p);
template <>
__device__ __forceinline__ float ld_cg<float>(const float* p) { return __ldcg(p); }
template <>
__device__ __forceinline__ int ld_cg<int>(const int* p) { return __ldcg(p); }
template <>
__device__ __forceinline__ __nv_bfloat16 ld_cg<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p)));
}

// a * b as one torch op in T: the f32 product rounded to T
template <typename T>
__device__ __forceinline__ float mul_t(float a, float b) {
  return to_f32(from_f32<T>(__fmul_rn(a, b)));
}

template <typename T>
__device__ __forceinline__ T emit_t(float s, const float* sc, int col) {
  return from_f32<T>(sc != nullptr ? s * sc[col] : s);  // int8: scale at emission
}

template <typename P>
__device__ __forceinline__ P ptr(const long long* row, int i) {
  return reinterpret_cast<P>(row[i]);
}

// RMSNorm of the R rows of h into xs, serving cast order: x * rsqrt(mean
// x^2 + eps) in f32, rounded to T, times the weight in T.
template <typename T>
__device__ void block_norm(const T* h, const T* w, T* xs, int R, int H, float eps, float* aux) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  float ss[kMaxRows];
#pragma unroll
  for (int i = 0; i < kMaxRows; ++i) ss[i] = 0.f;
  for (int c = tid; c < H; c += kThreads) {
#pragma unroll
    for (int i = 0; i < kMaxRows; ++i)
      if (i < R) {
        const float v = to_f32(ld_cg(h + (size_t)i * H + c));
        ss[i] = __fadd_rn(ss[i], __fmul_rn(v, v));
      }
  }
#pragma unroll
  for (int i = 0; i < kMaxRows; ++i) {
    const float v = ptt::warp_sum(ss[i]);
    if (lane == 0) aux[warp * kMaxRows + i] = v;
  }
  __syncthreads();
  float* inv = aux + kWarps * kMaxRows;
  if (tid < R) {
    float s = 0.f;
    for (int wv = 0; wv < kWarps; ++wv) s += aux[wv * kMaxRows + tid];
    inv[tid] = rsqrtf(s / (float)H + eps);
  }
  __syncthreads();
  for (int c = tid; c < H; c += kThreads) {
    const float wc = to_f32(w[c]);
#pragma unroll
    for (int i = 0; i < kMaxRows; ++i)
      if (i < R) {
        const float x = to_f32(ld_cg(h + (size_t)i * H + c));
        xs[(size_t)i * H + c] = from_f32<T>(mul_t<T>(mul_t<T>(x, inv[i]), wc));
      }
  }
  __syncthreads();
}

// the fold's order: (v1, i1) before (v2, i2)
__device__ __forceinline__ bool ahead(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

// entries of the sorted list (v, ix)[0, n) ahead of (x, xi); with kOrEq
// also those equal to it
template <bool kOrEq>
__device__ __forceinline__ int count_ahead(const float* v, const int* ix, int n, float x, int xi) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const bool before = kOrEq ? !ahead(x, xi, v[mid], ix[mid]) : ahead(v[mid], ix[mid], x, xi);
    if (before)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// One warp: the best K of the sorted lists A (na entries) and B (nb) into
// out (sorted). An entry's output position is its index plus the entries of
// the other list ahead of it, equal keys putting A first, so the positions
// are a permutation and the merge is stable.
__device__ void warp_merge(const float* av, const int* ai, int na, const float* bv, const int* bi,
                           int nb, float* ov, int* oi, int K) {
  const int lane = threadIdx.x % 32;
  for (int j = lane; j < na; j += 32) {
    const int pos = j + count_ahead<false>(bv, bi, nb, av[j], ai[j]);
    if (pos < K) {
      ov[pos] = av[j];
      oi[pos] = ai[j];
    }
  }
  for (int j = lane; j < nb; j += 32) {
    const int pos = j + count_ahead<true>(av, ai, na, bv[j], bi[j]);
    if (pos < K) {
      ov[pos] = bv[j];
      oi[pos] = bi[j];
    }
  }
  __syncwarp();
}

// bytes of the [R, H] rows (or the attention scratch) in shared memory
__host__ __device__ inline size_t xs_bytes(const PttMkArgs& a, size_t t_size) {
  const size_t rep = a.nh / a.nh_kv;
  const size_t attn = 4 * (rep * a.hd + rep * a.p + 3 * rep);
  size_t xs = (size_t)a.R * a.H * t_size;
  if (attn > xs) xs = attn;
  return (xs + 15) / 16 * 16;
}

// row stride of the fold's lists in shared memory
__host__ __device__ inline int fold_stride(const PttMkArgs& a) {
  return a.head_k > kSlabCols ? a.head_k : kSlabCols;
}

// The head's top-K fold (head_k > 1), after the final norm (xs holds the
// normed rows): the lm_head slabs into per-row sorted lists, then the
// blocks' lists merged pairwise across the grid; block 0 writes (topv,
// topi). Out of line, so its registers do not add to the layer phases'.
template <typename T, typename WT>
__device__ __noinline__ void head_fold(const PttMkArgs& a, const T* xs, const WT* wh,
                                       const float* shs, bool vh, float* red, float* stage) {
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int R = a.R, H = a.H;
  const float neg_inf = -__int_as_float(0x7f800000);
  const int n_slabs = (a.V + kSlabCols - 1) / kSlabCols;
  auto x_smem = [=](int i, int r) { return to_f32(xs[(size_t)i * H + r]); };
  // the top-K fold: per-row lists in shared memory after xs; lv/li the
  // block's list, ov/oi the merge output, bv/bi the incoming candidates
  const int K = a.head_k, KS = fold_stride(a);
  float* lv = reinterpret_cast<float*>(
      reinterpret_cast<char*>(const_cast<T*>(xs)) + xs_bytes(a, sizeof(T)));
  int* li = reinterpret_cast<int*>(lv + kMaxRows * KS);
  float* ov = reinterpret_cast<float*>(li + kMaxRows * KS);
  int* oi = reinterpret_cast<int*>(ov + kMaxRows * KS);
  float* bv = reinterpret_cast<float*>(oi + kMaxRows * KS);
  int* bi = reinterpret_cast<int*>(bv + kMaxRows * KS);
  float* rv = lv + warp * KS;  // this warp's row
  int* ri = li + warp * KS;
  float* rov = ov + warp * KS;
  int* roi = oi + warp * KS;
  float* rbv = bv + warp * KS;
  int* rbi = bi + warp * KS;
  for (int e = tid; e < kMaxRows * KS; e += kThreads) {
    lv[e] = neg_inf;  // sentinels: behind every column
    li[e] = 0x7fffffff;
  }
  __syncthreads();  // a block with no slab writes its sentinels below
  for (int u = blockIdx.x; u < n_slabs; u += gridDim.x) {
    for (int e = tid; e < kMaxRows * kSlabCols; e += kThreads) stage[e] = neg_inf;
    ptt::gemv_slab<WT, kMaxRows>(x_smem, wh, R, H, a.V, u, vh, red,
                                 [&](int i, int col, float s) {
                                   stage[i * kSlabCols + col % kSlabCols] =
                                       to_f32(emit_t<T>(s, shs, col));
                                 });
    if (warp < R) {  // one warp per row: rank the slab, merge it in
      const float v = stage[warp * kSlabCols + lane];
      const int c = u * kSlabCols + lane;  // pads: -inf, ids >= V
      int rank = 0;
      for (int o = 0; o < 32; ++o) {
        const float w_v = __shfl_sync(0xffffffffu, v, o);
        const int w_c = __shfl_sync(0xffffffffu, c, o);
        rank += ahead(w_v, w_c, v, c) ? 1 : 0;
      }
      rbv[rank] = v;
      rbi[rank] = c;
      __syncwarp();
      warp_merge(rv, ri, K, rbv, rbi, kSlabCols, rov, roi, K);
      for (int j = lane; j < K; j += 32) {
        rv[j] = rov[j];
        ri[j] = roi[j];
      }
      __syncwarp();
    }
    __syncthreads();
  }
  // the blocks' lists, merged pairwise across the grid
  const int G = gridDim.x, b = blockIdx.x;
  if (warp < R)
    for (int j = lane; j < K; j += 32) {
      a.fold_v[((size_t)b * R + warp) * K + j] = rv[j];
      a.fold_i[((size_t)b * R + warp) * K + j] = ri[j];
    }
  for (int stride = 1; stride < G; stride <<= 1) {
    grid.sync();
    if (b % (2 * stride) == 0 && b + stride < G && warp < R) {
      const size_t src = ((size_t)(b + stride) * R + warp) * K;
      for (int j = lane; j < K; j += 32) {
        rbv[j] = ld_cg(a.fold_v + src + j);
        rbi[j] = ld_cg(a.fold_i + src + j);
      }
      __syncwarp();
      warp_merge(rv, ri, K, rbv, rbi, K, rov, roi, K);
      const size_t dst = ((size_t)b * R + warp) * K;
      for (int j = lane; j < K; j += 32) {
        rv[j] = rov[j];
        ri[j] = roi[j];
        a.fold_v[dst + j] = rov[j];
        a.fold_i[dst + j] = roi[j];
      }
      __syncwarp();
    }
  }
  if (b == 0 && warp < R)
    for (int j = lane; j < K; j += 32) {
      a.topv[(size_t)warp * K + j] = rv[j];
      a.topi[(size_t)warp * K + j] = ri[j];
    }
}

// Phase 3 of a layer (see the header): rope, the pool write and paged
// attention per (slot, kv head); a slot owns tq consecutive rows (tq > 1:
// the verify pass's feed rows). Out of line, so its registers do not add to
// the layer phases' (inlined, it made the tq = 1 step slower: PERF.md).
template <typename T>
__device__ __noinline__ void attention_phase(const PttMkArgs& a, const long long* P, T* xs,
                                             const T* qkv, T* attn) {
  const int tid = threadIdx.x;
  const int R = a.R, hd = a.hd;
  const int NQ = a.nh * hd, NK = a.nh_kv * hd, QW = NQ + 2 * NK;
  const int rep = a.nh / a.nh_kv, d2 = hd / 2;
  float* q_s = reinterpret_cast<float*>(xs);  // [rep][hd], pre-scaled
  float* s_s = q_s + rep * hd;                // [rep][p]
  float* m_s = s_s + rep * a.p;
  float* l_s = m_s + rep;
  float* a_s = l_s + rep;
  T* kpool = ptr<T*>(P, P_KP);
  T* vpool = ptr<T*>(P, P_VP);
  const size_t tok_stride = (size_t)NK;
  const int tq = a.tq, n_slots = R / tq;
  for (int u = blockIdx.x; u < n_slots * a.nh_kv; u += gridDim.x) {
    const int s = u / a.nh_kv, g = u % a.nh_kv;
    const bool live = a.active[s] != 0;
    const int len = a.lens[s];
    // rotate the two halves of a head at position pos: x1 c - x2 s |
    // x2 c + x1 s, each product and each sum rounded to T (cos/sin
    // cast to T first)
    auto rope = [&](const T* x, int j, int pos) -> T {
      const int jj = j < d2 ? j : j - d2;
      const float c = to_f32(from_f32<T>(a.cos[(size_t)pos * d2 + jj]));
      const float sn = to_f32(from_f32<T>(a.sin[(size_t)pos * d2 + jj]));
      const float x1 = to_f32(ld_cg(x + jj)), x2 = to_f32(ld_cg(x + jj + d2));
      return j < d2 ? from_f32<T>(__fsub_rn(mul_t<T>(x1, c), mul_t<T>(x2, sn)))
                    : from_f32<T>(__fadd_rn(mul_t<T>(x2, c), mul_t<T>(x1, sn)));
    };
    // every row's k and v first, at its own position; a row outside
    // the write mask (or of an inactive slot) writes the scratch row
    for (int t = 0; t < tq; ++t) {
      const int r = s * tq + t;
      const int pos = min(max(len + t, 0), a.max_len - 1);
      const bool wr = live && (a.wmask == nullptr || a.wmask[r] != 0);
      const long long row =
          wr ? (long long)a.table[(size_t)s * a.max_pages + pos / a.p] * a.p + pos % a.p
             : (long long)a.oob;
      const T* krow = qkv + (size_t)r * QW + NQ + (size_t)g * hd;
      const T* vrow = krow + NK;
      for (int j = tid; j < hd; j += kThreads) {
        kpool[row * NK + (size_t)g * hd + j] = rope(krow, j, pos);
        vpool[row * NK + (size_t)g * hd + j] = ld_cg(vrow + j);
      }
    }
    __syncthreads();  // the new k/v rows, before any row attends
    // then each row attends up to its own position (the ragged causal
    // mask): the walk of a decode step at len + t, page for page
    for (int t = 0; t < tq; ++t) {
      const int r = s * tq + t;
      const int pos = min(max(len + t, 0), a.max_len - 1);
      const T* qrow = qkv + (size_t)r * QW + (size_t)g * rep * hd;
      for (int e = tid; e < rep * hd; e += kThreads)
        q_s[e] = to_f32(rope(qrow + (e / hd) * hd, e % hd, pos)) * a.scale;
      for (int i = tid; i < rep; i += kThreads) {
        m_s[i] = kNegInf;
        l_s[i] = 0.f;
      }
      float acc[kAttnAcc];
#pragma unroll
      for (int i = 0; i < kAttnAcc; ++i) acc[i] = 0.f;
      __syncthreads();  // q_s and the softmax state
      const int L = live ? max(0, min(len + t + 1, a.max_pages * a.p)) : 0;
      const int n_pg = (L + a.p - 1) / a.p;
      for (int pi = 0; pi < n_pg; ++pi) {
        const int page =
            min(max(a.table[(size_t)s * a.max_pages + pi], 0), a.n_pages - 1);
        const int valid = min(a.p, L - pi * a.p);
        const size_t base = (size_t)page * a.p * tok_stride + (size_t)g * hd;
        ptt::online_softmax_page<kThreads, kAttnAcc, 2, 16>(
            q_s, rep, hd, kpool + base, vpool + base, tok_stride, valid,
            [](int) { return 1 << 30; }, s_s, a.p, m_s, l_s, a_s, acc);
      }
      T* arow = attn + (size_t)r * NQ + (size_t)g * rep * hd;
#pragma unroll
      for (int i = 0; i < kAttnAcc; ++i) {
        const int e = tid + i * kThreads;
        if (e < rep * hd) arow[e] = from_f32<T>(acc[i] / fmaxf(l_s[e / hd], 1e-30f));
      }
      __syncthreads();  // the scratch is reused by the next row or unit
    }
  }
}

template <typename T, typename WT, int kSeg>
__global__ void __launch_bounds__(kThreads) decode_megakernel_kernel(const PttMkArgs a) {
  constexpr bool kQkv = kSeg == kSegFull || kSeg == kSegQkv;    // phases 1-3
  constexpr bool kTail = kSeg == kSegFull || kSeg == kSegTail;  // phases 4-5
  constexpr bool kDown = kSeg == kSegFull || kSeg == kSegDown;  // 6, the head
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  float* red = smem;                                 // [kRed]
  float* aux = red + kRed;                           // [kAux]
  T* xs = reinterpret_cast<T*>(aux + kAux);          // [R, H], or attention scratch
  float* stage = aux + kNormAux;                     // [kMaxRows][32] gate / logits
  float* best_v = stage + 2 * kMaxRows * kSlabCols;  // [kMaxRows]
  int* best_i = reinterpret_cast<int*>(best_v + kMaxRows);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int R = a.R, H = a.H, hd = a.hd, F = a.F;
  const int NQ = a.nh * hd, NK = a.nh_kv * hd, QW = NQ + 2 * NK;
  T* h = static_cast<T*>(a.h);
  T* qkv = static_cast<T*>(a.qkv);
  T* attn = static_cast<T*>(a.attn);
  T* act = static_cast<T*>(a.act);

  auto x_smem = [&](int i, int r) { return to_f32(xs[(size_t)i * H + r]); };
  auto residual = [&](const float* sc) {
    return [=](int i, int col, float s) {
      T* hp = h + (size_t)i * H + col;
      *hp = from_f32<T>(__fadd_rn(to_f32(ld_cg(hp)), to_f32(emit_t<T>(s, sc, col))));
    };
  };
  const int sq = (NQ + kSlabCols - 1) / kSlabCols, sk = (NK + kSlabCols - 1) / kSlabCols;
  const int sh = (H + kSlabCols - 1) / kSlabCols, sf = (F + kSlabCols - 1) / kSlabCols;

  for (int l = 0; l < a.n_layers; ++l) {
    const long long* P = a.ptrs + (size_t)(a.layer0 + l) * kPtrs;

    if constexpr (kQkv) {
      // 1-2. norm1, then Q/K/V slabs into the qkv scratch
      block_norm<T>(h, ptr<const T*>(P, P_LN1), xs, R, H, a.eps, aux);
      for (int u = blockIdx.x; u < sq + 2 * sk; u += gridDim.x) {
        int wi, n, off, slab;
        if (u < sq) {
          wi = P_WQ; n = NQ; off = 0; slab = u;
        } else if (u < sq + sk) {
          wi = P_WK; n = NK; off = NQ; slab = u - sq;
        } else {
          wi = P_WV; n = NK; off = NQ + NK; slab = u - sq - sk;
        }
        const WT* w = ptr<const WT*>(P, wi);
        const float* sc = ptr<const float*>(P, wi + 1);
        ptt::gemv_slab<WT, kMaxRows>(x_smem, w, R, H, n, slab, ptt::slab_vec_ok<WT>(w, n), red,
                                     [&](int i, int col, float s) {
                                       qkv[(size_t)i * QW + off + col] = emit_t<T>(s, sc, col);
                                     });
      }
      grid.sync();

      attention_phase<T>(a, P, xs, qkv, attn);
    }
    if constexpr (kSeg == kSegFull) grid.sync();

    if constexpr (kTail) {
      // 4. O, plus the residual
      {
        const WT* w = ptr<const WT*>(P, P_WO);
        const bool vec = ptt::slab_vec_ok<WT>(w, H);
        auto x_attn = [&](int i, int r) { return to_f32(ld_cg(attn + (size_t)i * NQ + r)); };
        for (int u = blockIdx.x; u < sh; u += gridDim.x)
          ptt::gemv_slab<WT, kMaxRows>(x_attn, w, R, NQ, H, u, vec, red,
                                       residual(ptr<const float*>(P, P_SO)));
      }
      grid.sync();

      // 5. norm2, then gate and up slabs of the same columns with SwiGLU
      block_norm<T>(h, ptr<const T*>(P, P_LN2), xs, R, H, a.eps, aux);
      {
        const WT* wg = ptr<const WT*>(P, P_WG);
        const WT* wu = ptr<const WT*>(P, P_WU);
        const float* sg = ptr<const float*>(P, P_SG);
        const float* su = ptr<const float*>(P, P_SU);
        const bool vg = ptt::slab_vec_ok<WT>(wg, F), vu = ptt::slab_vec_ok<WT>(wu, F);
        for (int u = blockIdx.x; u < sf; u += gridDim.x) {
          ptt::gemv_slab<WT, kMaxRows>(x_smem, wg, R, H, F, u, vg, red,
                                       [&](int i, int col, float s) {
                                         stage[i * kSlabCols + col % kSlabCols] =
                                             to_f32(emit_t<T>(s, sg, col));
                                       });
          ptt::gemv_slab<WT, kMaxRows>(
              x_smem, wu, R, H, F, u, vu, red, [&](int i, int col, float s) {
                const float g = stage[i * kSlabCols + col % kSlabCols];
                const float silu = to_f32(from_f32<T>(__fdiv_rn(g, __fadd_rn(1.f, expf(-g)))));
                act[(size_t)i * F + col] =
                    from_f32<T>(__fmul_rn(silu, to_f32(emit_t<T>(s, su, col))));
              });
        }
      }
    }
    if constexpr (kSeg == kSegFull) grid.sync();

    if constexpr (kDown) {
      // 6. down, plus the residual
      {
        const WT* w = ptr<const WT*>(P, P_WD);
        const bool vec = ptt::slab_vec_ok<WT>(w, H);
        auto x_act = [&](int i, int r) { return to_f32(ld_cg(act + (size_t)i * F + r)); };
        for (int u = blockIdx.x; u < sh; u += gridDim.x)
          ptt::gemv_slab<WT, kMaxRows>(x_act, w, R, F, H, u, vec, red,
                                       residual(ptr<const float*>(P, P_SD)));
      }
      if (l + 1 < a.n_layers || a.head_row >= 0) grid.sync();
    }
  }

  if constexpr (kDown) {
    if (a.head_row < 0) return;
    // final norm, lm_head slabs, greedy argmax
    const long long* P = a.ptrs + (size_t)a.head_row * kPtrs;
    block_norm<T>(h, ptr<const T*>(P, P_NF), xs, R, H, a.eps, aux);
    const WT* wh = ptr<const WT*>(P, P_WH);
    const float* shs = ptr<const float*>(P, P_SH);
    const bool vh = ptt::slab_vec_ok<WT>(wh, a.V);
    const float neg_inf = -__int_as_float(0x7f800000);
    const int n_slabs = (a.V + kSlabCols - 1) / kSlabCols;
    if (a.head_k > 1) {  // the top-K fold, out of line: its own registers
      head_fold<T, WT>(a, xs, wh, shs, vh, red, stage);
      return;
    }
    T* logits = static_cast<T*>(a.logits);
    if (tid < kMaxRows) {
      best_v[tid] = neg_inf;
      best_i[tid] = 0x7fffffff;
    }
    for (int u = blockIdx.x; u < n_slabs; u += gridDim.x) {
      for (int e = tid; e < kMaxRows * kSlabCols; e += kThreads) stage[e] = neg_inf;
      ptt::gemv_slab<WT, kMaxRows>(x_smem, wh, R, H, a.V, u, vh, red,
                                   [&](int i, int col, float s) {
                                     const T y = emit_t<T>(s, shs, col);
                                     logits[(size_t)i * a.V + col] = y;
                                     stage[i * kSlabCols + col % kSlabCols] = to_f32(y);
                                   });
      if (warp < R) {  // one warp per row: the slab's max, ties to the smaller id
        float v = stage[warp * kSlabCols + lane];
        int c = u * kSlabCols + lane;
        for (int o = 16; o > 0; o >>= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, v, o);
          const int oc = __shfl_xor_sync(0xffffffffu, c, o);
          if (ov > v || (ov == v && oc < c)) {
            v = ov;
            c = oc;
          }
        }
        if (lane == 0 && v > best_v[warp]) {  // slabs ascend: the first max stays
          best_v[warp] = v;
          best_i[warp] = c;
        }
      }
      __syncthreads();
    }
    __syncthreads();
    if (tid < R) {
      a.part_v[(size_t)blockIdx.x * R + tid] = best_v[tid];
      a.part_i[(size_t)blockIdx.x * R + tid] = best_i[tid];
    }
    grid.sync();
    if (blockIdx.x == 0 && tid < R) {
      float bv = neg_inf;
      int bi = 0x7fffffff;
      for (int b = 0; b < (int)gridDim.x; ++b) {
        const float v = ld_cg(a.part_v + (size_t)b * R + tid);
        const int c = ld_cg(a.part_i + (size_t)b * R + tid);
        if (v > bv || (v == bv && c < bi)) {
          bv = v;
          bi = c;
        }
      }
      a.tok[tid] = bi;
      a.maxv[tid] = bv;
    }
  }
}

size_t smem_bytes(const PttMkArgs& a, size_t t_size) {
  size_t fold = 0;  // six [kMaxRows, stride] lists of 4-byte words
  if (a.head_row >= 0 && a.head_k > 1) fold = (size_t)6 * kMaxRows * fold_stride(a) * 4;
  return (kRed + kAux) * sizeof(float) + xs_bytes(a, t_size) + fold;
}

template <typename T, typename WT, int kSeg>
cudaError_t launch(const PttMkArgs& a, int device, cudaStream_t s, int* grid_out) {
  auto kern = decode_megakernel_kernel<T, WT, kSeg>;
  const size_t smem = smem_bytes(a, sizeof(T));
  static size_t smem_allowed = 48 * 1024;  // per instantiation
  cudaError_t err;
  if (smem > smem_allowed) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_allowed = smem;
  }
  int per_sm = 0, n_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  int grid = per_sm * n_sm;
  if (grid > a.max_grid) grid = a.max_grid;
  if (grid <= 0) return cudaErrorCooperativeLaunchTooLarge;
  PttMkArgs args = a;
  void* kargs[] = {&args};
  err = cudaLaunchCooperativeKernel((void*)kern, dim3(grid),
                                    dim3(kThreads), kargs, smem, s);
  if (grid_out != nullptr) *grid_out = grid;
  return err;
}

// the arguments every build takes (the entry points add their own)
inline bool args_ok(const PttMkArgs& a) {
  return !(a.R < 1 || a.R > kMaxRows || a.tq < 1 || a.R % a.tq != 0 || a.nh_kv <= 0 ||
           a.nh % a.nh_kv != 0 || a.hd % 16 != 0 || a.hd > 32 * ptt::kPageMaxDLane ||
           (a.nh / a.nh_kv) * a.hd > kAttnAcc * kThreads || a.p <= 0 || a.max_len <= 0 ||
           a.n_layers < 0 || (a.head_row >= 0 && a.V <= 0) ||
           (a.head_row >= 0 && (a.head_k < 1 || a.head_k > 128 || a.head_k > a.V)) ||
           (a.head_k > 1 && (a.topv == nullptr || a.fold_v == nullptr)));
}

}  // namespace

