// Flash-attention backward on the tensor cores, bf16 [b, s, h, d], d 64 or
// 128: dQ, dK and dV of o = softmax(q k^T * scale + mask, masked at keys >=
// s_true and, when causal, above the diagonal) v, from q, k, v, dO, the
// forward's lse ([b, h, s] f32) and delta = rowsum(dO * o) ([b, h, s] f32,
// computed by the wrapper). The mask gets no gradient. f32 inputs take
// flash_attention_bwd.cu.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py `_fused_bwd_kernel`
// (called from `_flash_bwd` / `make_flash_attention`'s custom VJP) in its
// bf16 builds: causal or not, with or without an additive mask, with or
// without attention dropout. The reference walks K/V blocks outside and Q
// blocks inside and writes one dQ partial per (K block, Q block) visit for
// XLA to sum. On the H100 that buffer is [s / 64, b, s, h, d] f32 (2.15 GB
// at llama350m's b 32, s 1024, h 16, d 64) written and read back, so this
// build does not carry the grid over: two kernels, each writing its
// gradients once, with no partial buffer and no atomics (two launches with
// one seed give the same bits).
//
// What bounds it on the H100: the operations. Per visible (query, key) pair
// the five d-long products (S, dP, dV, dK, dQ) are 10 d flops; ~s / 3 flops
// per byte of q, k, v, o, dO and the gradients at s = 1024, above the card's
// ~295, so the bf16 tensor-core peak (989 TFLOP/s) is the bound. This build
// does 14 d flops per pair (the dQ kernel recomputes S and dP), on the
// tensor cores; the f32 build did 10 d on the CUDA cores.
//
// Design, both kernels: CTAs of 4 warps, 64-row tiles on both sides, warp w
// owning rows 16 w..16 w + 15 of the CTA's own tile; the tiles walked are
// streamed by cp.async into swizzled shared memory, double-buffered, and
// taken 32 rows at a time (two 16-deep mma steps); every product is
// mma.sync m16n8k16 with f32 accumulators in registers; P and dS are
// packed to bf16 from the score registers as the A operand of the next
// product.
//   dK/dV kernel, one CTA per (batch x head, 64-key tile): walks the query
//     tiles the key tile meets (from the diagonal on when causal without a
//     mask; all of them with a mask). Per 32 queries: S^T = K Q^T, P^T =
//     exp(S^T scale - lse), dP^T = V dO^T, dV += P_drop^T dO, dS^T = P^T
//     (dP_drop^T - delta) scale, dK += dS^T Q.
//   dQ kernel, one CTA per (batch x head, 64-query tile, heaviest first):
//     walks the key tiles the query tile meets (up to the diagonal when
//     causal without a mask, below s_true without a mask, all with one).
//     Per 32 keys: S, P, dP, dS as above, dQ += dS K.
// P = exp2(fma(S, scale log2 e, -lse log2 e) [+ mask log2 e]); a pair
// outside s_true / the causal triangle is 0 without a mask, and with one
// exp2((NEG_INF - lse) log2 e) inside the tensor (the reference's
// `_block_p`: 0, or 1 on a row the mask hides entirely, where lse is itself
// NEG_INF). Keep bits from `ptt::dropout_keep` on the global (row, col) and
// slice b * h + head, as the forward's: dV reads the dropped weights, dP is
// dropped the same way, dS takes the undropped P. The kDrop and kMask
// builds differ from the plain one only by the keep multiply and the mask
// add, and a mask launch walks every (key tile, query tile) cell: a zero
// mask adds +0 to the exponent and the extra cells add exact zeros, so a
// causal launch with a zero mask gives the causal launch's bits.
//
// Why mma.sync and not wgmma: each warp's 16 rows hold their scores in the
// mma's C layout, where the per-row lse, delta, masks and keep bits apply
// and from which P and dS feed the next product without shared memory;
// wgmma's 64-row accumulators and shared-memory descriptors are later work
// (this build is the simple correct tensor-core step).
//
// ptxas (sm_90a, CUDA 12.8; chip_smoke's build phase): the dQ kernel 163-168
// registers at d 64 and 227-250 at d 128, no spill; the dK/dV kernel 209-229
// at d 64, no spill, and 255 at d 128 with 88-200 B spilled (its two f32
// accumulator tiles alone take 128 registers). HMMA instructions in
// cuobjdump's SASS: dQ 96 / 192, dK/dV 128 / 256 (d 64 / 128).
#include "common.cuh"
#include "mma.cuh"

namespace {

using ptt::kNegInf;
using namespace ptt::mma;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kTile = 64;   // rows of a tile, both sides
constexpr int kChunk = 32;  // rows of the walked tile per step

template <int D>
constexpr size_t smem_bytes() {
  // two resident tiles, then two stages of two streamed tiles plus (dK/dV
  // kernel) 64 lse and 64 delta values
  return 2 * (size_t)kTile * D * 2 + 2 * (2 * (size_t)kTile * D * 2 + 2 * kTile * 4);
}

// Everything one (query row, key column) pair needs, shared by both kernels
// so that they compute P and dS alike; bh = b * h + head, bi and hh are the
// CTA's batch and head.
struct PairArgs {
  int S, s_true, causal, bh, bi, hh;
  float scale, scale_log2;
  ptt::Dropout drop;
  ptt::AddMask mask;
};

// P as dV reads it (dropped) and dS of one pair from its score s and dP
// value dp; nl2 = -lse log2 e of the row. `inside`: the caller knows the
// pair is visible (it only skips the tests). The mask and NEG_INF terms are
// scaled by __fmul_rn, never fused into the sum: on a hidden row
// (lse = NEG_INF) they cancel nl2 exactly, as the reference's f32 does.
template <bool kDrop, bool kMask>
__device__ __forceinline__ void pair_grad(const PairArgs& a, int row, int col, bool inside,
                                          float s, float dp, float nl2, float del, float& p_v,
                                          float& ds) {
  const bool ok = inside || (row < a.S && col < a.s_true && (!a.causal || col <= row));
  float p;
  if constexpr (kMask) {
    const bool in = inside || (row < a.S && col < a.S);
    p = ok ? exp2f(fmaf(s, a.scale_log2, nl2) +
                   __fmul_rn(a.mask.at(a.bi, a.hh, row, col), kLog2e))
           : (in ? exp2f(__fmul_rn(kNegInf, kLog2e) + nl2) : 0.f);
  } else {
    p = ok ? exp2f(fmaf(s, a.scale_log2, nl2)) : 0.f;
  }
  p_v = p;
  if constexpr (kDrop) {
    const bool keep = ptt::dropout_keep(a.drop.seed, a.bh, row, col, a.drop.thresh);
    p_v = keep ? p * a.drop.inv_keep : 0.f;
    dp = keep ? dp * a.drop.inv_keep : 0.f;
  }
  ds = p * (dp - del) * a.scale;
}

// Copy rows [row0, row0 + 64) of a [b, s, h, d] tensor's head into a
// swizzled tile (rows past S zero-filled).
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* __restrict__ src,
                                          size_t head_off, size_t row_stride, int row0, int S,
                                          int tid) {
  constexpr int kCh = D / 8;
  for (int e = tid; e < kTile * kCh; e += kThreads) {
    const int r = e / kCh, c = e % kCh, sr = row0 + r;
    const bool in = sr < S;
    cp_async16(dst + swz<D>(r, c), src + (in ? head_off + (size_t)sr * row_stride + c * 8 : 0),
               in);
  }
}

// acc rows (g, g + 8 of the warp's 16) -> bf16 pairs of a [b, s, h, d]
// tensor, rows past S dropped
template <int D>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, const float (&acc)[D / 8][4],
                                           size_t head_off, size_t row_stride, int row0, int S,
                                           int lane) {
  const int gq = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + gq + 8 * i;
    if (r >= S) continue;
    bf16* o = dst + head_off + (size_t)r * row_stride + 2 * t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(o + n * 8) = pack_bf16(acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

template <int D, bool kDrop, bool kMask>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dk, bf16* __restrict__ dv, int H, PairArgs args) {
  constexpr uint32_t kTileB = kTile * D * 2;
  constexpr uint32_t kStageB = 2 * kTileB + 2 * kTile * 4;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t k_s = smem_addr(smem), v_s = k_s + kTileB, st0 = v_s + kTileB;
  const float* stage_f = reinterpret_cast<const float*>(smem + 2 * kTileB);

  PairArgs a = args;
  a.bh = blockIdx.y;
  a.bi = a.bh / H;
  a.hh = a.bh % H;
  const int S = a.S;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gq = lane / 4, t4 = lane % 4;
  const int k_start = blockIdx.x * kTile;
  const size_t row_stride = (size_t)H * D;
  const size_t head_off = (size_t)a.bi * S * row_stride + (size_t)a.hh * D;
  const int nq = (S + kTile - 1) / kTile;
  const int qt0 = (!kMask && a.causal) ? k_start / kTile : 0;
  const int qt_end = (kMask || k_start < a.s_true) ? nq : qt0;

  auto load_q_tile = [&](int qt, int stage) {
    const uint32_t base = st0 + stage * kStageB;
    load_tile<D>(base, q, head_off, row_stride, qt * kTile, S, tid);
    load_tile<D>(base + kTileB, dout, head_off, row_stride, qt * kTile, S, tid);
    if (tid < 2 * kTile) {
      const int r = tid % kTile, sr = qt * kTile + r;
      const float* src = tid < kTile ? lse : delta;
      cp_async4(base + 2 * kTileB + tid * 4, src + (sr < S ? (size_t)a.bh * S + sr : 0), sr < S);
    }
  };
  load_tile<D>(k_s, k, head_off, row_stride, k_start, S, tid);
  load_tile<D>(v_s, v, head_off, row_stride, k_start, S, tid);
  if (qt0 < qt_end) load_q_tile(qt0, 0);
  cp_async_commit();

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  const int key_lo = k_start + warp * 16;  // the warp's keys: key_lo..key_lo + 15
  for (int qt = qt0; qt < qt_end; ++qt) {
    const int stage = (qt - qt0) & 1;
    if (qt + 1 < qt_end) load_q_tile(qt + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const uint32_t q_s = st0 + stage * kStageB, do_s = q_s + kTileB;
    const float* lse_s = stage_f + stage * (kStageB / 4) + 2 * kTile * D / 2;
    const float* del_s = lse_s + kTile;
#pragma unroll
    for (int qc = 0; qc < kTile / kChunk; ++qc) {
      const int row0 = qt * kTile + qc * kChunk;
      if (row0 >= S) break;
      // causal without a mask: every key of the warp above every row here
      if (!kMask && a.causal && key_lo > row0 + kChunk - 1) continue;
      float st[kChunk / 8][4], dpt[kChunk / 8][4];
#pragma unroll
      for (int j = 0; j < kChunk / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ka[4], va[4];
        load_a<D>(ka, k_s, warp * 16, kk, lane);
        load_a<D>(va, v_s, warp * 16, kk, lane);
#pragma unroll
        for (int nn = 0; nn < kChunk / 16; ++nn) {
          uint32_t bb[4];
          load_bt<D>(bb, q_s, qc * kChunk + nn * 16, kk, lane);
          mma_bf16(st[2 * nn], ka, bb[0], bb[1]);
          mma_bf16(st[2 * nn + 1], ka, bb[2], bb[3]);
          load_bt<D>(bb, do_s, qc * kChunk + nn * 16, kk, lane);
          mma_bf16(dpt[2 * nn], va, bb[0], bb[1]);
          mma_bf16(dpt[2 * nn + 1], va, bb[2], bb[3]);
        }
      }
      // inside: no pair of the warp's block is masked
      const bool inside = row0 + kChunk <= S && key_lo + 16 <= a.s_true &&
                          (!a.causal || key_lo + 15 <= row0);
#pragma unroll
      for (int j = 0; j < kChunk / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = key_lo + gq + 8 * (e >> 1);           // key
          const int ql = qc * kChunk + j * 8 + 2 * t4 + (e & 1);  // query in the tile
          float pv, ds;
          pair_grad<kDrop, kMask>(a, qt * kTile + ql, col, inside, st[j][e], dpt[j][e],
                                  -lse_s[ql] * kLog2e, del_s[ql], pv, ds);
          st[j][e] = pv;
          dpt[j][e] = ds;
        }
      // dV += P_drop^T dO, dK += dS^T Q over the chunk's queries
#pragma unroll
      for (int kc = 0; kc < kChunk / 16; ++kc) {
        const uint32_t pa[4] = {pack_bf16(st[2 * kc][0], st[2 * kc][1]),
                                pack_bf16(st[2 * kc][2], st[2 * kc][3]),
                                pack_bf16(st[2 * kc + 1][0], st[2 * kc + 1][1]),
                                pack_bf16(st[2 * kc + 1][2], st[2 * kc + 1][3])};
        const uint32_t sa[4] = {pack_bf16(dpt[2 * kc][0], dpt[2 * kc][1]),
                                pack_bf16(dpt[2 * kc][2], dpt[2 * kc][3]),
                                pack_bf16(dpt[2 * kc + 1][0], dpt[2 * kc + 1][1]),
                                pack_bf16(dpt[2 * kc + 1][2], dpt[2 * kc + 1][3])};
#pragma unroll
        for (int nd = 0; nd < D / 16; ++nd) {
          uint32_t bb[4];
          load_b<D>(bb, do_s, qc * kChunk + kc * 16, nd, lane);
          mma_bf16(dv_acc[2 * nd], pa, bb[0], bb[1]);
          mma_bf16(dv_acc[2 * nd + 1], pa, bb[2], bb[3]);
          load_b<D>(bb, q_s, qc * kChunk + kc * 16, nd, lane);
          mma_bf16(dk_acc[2 * nd], sa, bb[0], bb[1]);
          mma_bf16(dk_acc[2 * nd + 1], sa, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();  // this stage is rewritten by tile qt + 2
  }
  cp_async_wait<0>();
  store_rows<D>(dk, dk_acc, head_off, row_stride, key_lo, S, lane);
  store_rows<D>(dv, dv_acc, head_off, row_stride, key_lo, S, lane);
}

template <int D, bool kDrop, bool kMask>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, int H, PairArgs args) {
  constexpr uint32_t kTileB = kTile * D * 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t q_s = smem_addr(smem), do_s = q_s + kTileB, st0 = do_s + kTileB;

  PairArgs a = args;
  a.bh = blockIdx.y;
  a.bi = a.bh / H;
  a.hh = a.bh % H;
  const int S = a.S;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gq = lane / 4, t4 = lane % 4;
  const int nq = (S + kTile - 1) / kTile;
  const int qt = nq - 1 - (int)blockIdx.x;  // the causal walk's longest tiles first
  const int q_start = qt * kTile;
  const size_t row_stride = (size_t)H * D;
  const size_t head_off = (size_t)a.bi * S * row_stride + (size_t)a.hh * D;
  const int nk = nq;
  const int kt_end = kMask ? nk
                           : min(a.causal ? qt + 1 : nk, (a.s_true + kTile - 1) / kTile);

  load_tile<D>(q_s, q, head_off, row_stride, q_start, S, tid);
  load_tile<D>(do_s, dout, head_off, row_stride, q_start, S, tid);
  auto load_k_tile = [&](int kt, int stage) {
    const uint32_t base = st0 + stage * 2 * kTileB;
    load_tile<D>(base, k, head_off, row_stride, kt * kTile, S, tid);
    load_tile<D>(base + kTileB, v, head_off, row_stride, kt * kTile, S, tid);
  };
  if (kt_end > 0) load_k_tile(0, 0);
  cp_async_commit();

  const int row_lo = q_start + warp * 16;  // the warp's rows: row_lo..row_lo + 15
  float nl2[2], del[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row_lo + gq + 8 * i;
    nl2[i] = r < S ? -lse[(size_t)a.bh * S + r] * kLog2e : 0.f;
    del[i] = r < S ? delta[(size_t)a.bh * S + r] : 0.f;
  }
  float dq_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;

  for (int kt = 0; kt < kt_end; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < kt_end) load_k_tile(kt + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const uint32_t k_s = st0 + stage * 2 * kTileB, v_s = k_s + kTileB;
#pragma unroll
    for (int kc = 0; kc < kTile / kChunk; ++kc) {
      const int col0 = kt * kTile + kc * kChunk;
      if (col0 >= S) break;
      if (!kMask && (col0 >= a.s_true || (a.causal && col0 > row_lo + 15))) continue;
      float s[kChunk / 8][4], dp[kChunk / 8][4];
#pragma unroll
      for (int j = 0; j < kChunk / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t qa[4], oa[4];
        load_a<D>(qa, q_s, warp * 16, kk, lane);
        load_a<D>(oa, do_s, warp * 16, kk, lane);
#pragma unroll
        for (int nn = 0; nn < kChunk / 16; ++nn) {
          uint32_t bb[4];
          load_bt<D>(bb, k_s, kc * kChunk + nn * 16, kk, lane);
          mma_bf16(s[2 * nn], qa, bb[0], bb[1]);
          mma_bf16(s[2 * nn + 1], qa, bb[2], bb[3]);
          load_bt<D>(bb, v_s, kc * kChunk + nn * 16, kk, lane);
          mma_bf16(dp[2 * nn], oa, bb[0], bb[1]);
          mma_bf16(dp[2 * nn + 1], oa, bb[2], bb[3]);
        }
      }
      const bool inside = row_lo + 16 <= S && col0 + kChunk <= a.s_true &&
                          (!a.causal || col0 + kChunk - 1 <= row_lo);
#pragma unroll
      for (int j = 0; j < kChunk / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          float pv, ds;
          pair_grad<kDrop, kMask>(a, row_lo + gq + 8 * i, col0 + j * 8 + 2 * t4 + (e & 1),
                                  inside, s[j][e], dp[j][e], nl2[i], del[i], pv, ds);
          s[j][e] = ds;
        }
      // dQ += dS K over the chunk's keys
#pragma unroll
      for (int c = 0; c < kChunk / 16; ++c) {
        const uint32_t sa[4] = {pack_bf16(s[2 * c][0], s[2 * c][1]),
                                pack_bf16(s[2 * c][2], s[2 * c][3]),
                                pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]),
                                pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3])};
#pragma unroll
        for (int nd = 0; nd < D / 16; ++nd) {
          uint32_t bb[4];
          load_b<D>(bb, k_s, kc * kChunk + c * 16, nd, lane);
          mma_bf16(dq_acc[2 * nd], sa, bb[0], bb[1]);
          mma_bf16(dq_acc[2 * nd + 1], sa, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();  // this stage is rewritten by tile kt + 2
  }
  cp_async_wait<0>();
  store_rows<D>(dq, dq_acc, head_off, row_stride, row_lo, S, lane);
}

template <int D, bool kDrop, bool kMask>
cudaError_t launch_as(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dq, void* dk, void* dv,
                      int b, int h, const PairArgs& a, cudaStream_t st) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = ptt::allow_smem(bwd_dkdv_kernel<D, kDrop, kMask>, smem);
  if (err != cudaSuccess) return err;
  err = ptt::allow_smem(bwd_dq_kernel<D, kDrop, kMask>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + kTile - 1) / kTile, b * h);
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v), *ob = static_cast<const bf16*>(dout);
  bwd_dkdv_kernel<D, kDrop, kMask><<<grid, kThreads, smem, st>>>(
      qb, kb, vb, ob, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), h, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dq_kernel<D, kDrop, kMask><<<grid, kThreads, smem, st>>>(
      qb, kb, vb, ob, lse, delta, static_cast<bf16*>(dq), h, a);
  return cudaSuccess;
}

}  // namespace

// q, k, v, dout, dq, dk, dv: [b, s, h, d] bf16, 16-byte aligned; lse and
// delta: [b, h, s] f32. d must be 64 or 128. mask, causal and dropout
// (seed, thresh, inv_keep) as the forward's. Two launches on `stream`: the
// dK/dV kernel, then the dQ kernel.
extern "C" int ptt_flash_attention_bwd_tc(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, const void* delta,
                                          void* dq, void* dk, void* dv, const void* mask,
                                          long long msb, long long msh, long long msq,
                                          long long msk, int b, int s, int h, int d,
                                          int s_true, int causal, float scale, int dropout,
                                          unsigned seed, unsigned thresh, float inv_keep,
                                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b * h > 65535 || (d != 64 && d != 128)) return (int)cudaErrorInvalidValue;  // grid.y
  if (b == 0 || s == 0 || h == 0) return (int)cudaSuccess;
  PairArgs a{s, s_true, causal, 0, 0, 0, scale, scale * kLog2e,
             ptt::Dropout{dropout, seed, thresh, inv_keep},
             ptt::AddMask{static_cast<const float*>(mask), msb, msh, msq, msk}};
  // bh, bi and hh are set per CTA from blockIdx.y
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
#define PTT_BWD_TC(D, DROP, MASK) \
  launch_as<D, DROP, MASK>(q, k, v, dout, l, dl, dq, dk, dv, b, h, a, st)
  const bool drop = dropout != 0, masked = mask != nullptr;
  if (d == 128)
    err = masked ? (drop ? PTT_BWD_TC(128, true, true) : PTT_BWD_TC(128, false, true))
                 : (drop ? PTT_BWD_TC(128, true, false) : PTT_BWD_TC(128, false, false));
  else
    err = masked ? (drop ? PTT_BWD_TC(64, true, true) : PTT_BWD_TC(64, false, true))
                 : (drop ? PTT_BWD_TC(64, true, false) : PTT_BWD_TC(64, false, false));
#undef PTT_BWD_TC
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
