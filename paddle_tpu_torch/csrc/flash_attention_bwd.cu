// Flash-attention backward on [b, s, h, d], the f32 build (bf16 takes the
// tensor-core build, flash_attention_bwd_tc.cu): dQ, dK and dV of
// o = softmax(q k^T * scale + mask, masked at keys >= s_true and, when
// causal, above the diagonal) v, from q, k, v, dO, the forward's lse
// ([b, h, s] f32) and delta = rowsum(dO * o) ([b, h, s] f32, computed by
// the wrapper). The mask gets no gradient (the reference's is zero).
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py `_fused_bwd_kernel`
// (called from `_flash_bwd` / `make_flash_attention`'s custom VJP), causal
// or not, with or without an additive mask, with or without attention
// dropout. The reference's grid walks
// K/V blocks outside and Q blocks inside: dK and dV accumulate in VMEM over
// the inner Q axis, and every (K block, Q block) visit writes its dQ
// partial, which XLA sums afterwards. Nothing is added to dQ by two
// writers, so dQ is deterministic. This kernel keeps that design: one block
// per (batch x head, key tile) loops over the 64-row query tiles the key
// tile meets (all of them, or from the diagonal on when causal), keeps dK
// and dV in f32 registers, and writes its f32 dQ partial to its own slice
// of a [nk, b, s, h, d] buffer; the wrapper sums the nk slices. The key
// tile is 128 keys at d 64 and 64 at d 128 (`Tile<D>::kBK`; the wrapper's
// `bwd_key_tile` and the `n_part` argument say the same). Partials of
// query tiles the key tile does not meet (before the diagonal, or every
// tile when the key tile starts at or past s_true) are written as exact
// zeros, as the reference flushes its skipped cells; a non-causal key tile
// below s_true meets every query tile and flushes nothing. No atomics
// anywhere. It stays one kernel: split as the bf16 build is (a dK/dV
// kernel, then a dQ kernel), the CUDA cores would compute S and dP twice,
// 7 products a pair instead of 5, which costs more than the partials'
// traffic.
//
// Mask (the `kMask` instantiations): P is rebuilt as exp(S * scale - lse +
// mask[b, h, row, col]) (the f32 mask read through `ptt::AddMask`'s four
// strides; a key-padding mask, query stride 0, once per column for the
// whole block), and a masked-out pair inside the tensor as exp(NEG_INF -
// lse), the reference's `_block_p` (0 unless the row is hidden entirely,
// where lse is itself about NEG_INF). A launch with a mask meets every (key
// tile, query tile) cell, as the forward walks every key tile, so the
// gradients of a hidden row are the plain version's too. `S * scale - lse`
// is one explicit fused multiply-add with or without a mask, so a zero
// mask gives the maskless bits (the extra cells of a mask launch add exact
// zeros); the reference adds the mask before subtracting lse, which moves
// only the last bits of P. With kMask false nothing of the mask is
// compiled in, and causality is the `kCausal` flag (a runtime `causal`
// cost the causal launch 2%); a launch with a mask reads `causal` at run
// time.
//
// Dropout (the `kDrop` instantiations): each pair's keep bit is
// `ptt::dropout_keep` on its global (row, column), as the forward's. dV
// reads the dropped weights p_v = keep ? p / (1 - p_drop) : 0; dP is
// dropped the same way; dS = P (dP - delta) * scale takes the undropped P;
// delta = rowsum(dO o) over the dropped forward's o, as without dropout
// (the reference's `_fused_bwd_kernel`). With kDrop false nothing of the
// hash is compiled in.
//
// What bounds it on the H100 SXM (data-sheet rates): per visible (query,
// key) pair it does five d-long products (S again, dV, dP, dK, dQ: 10 d flops) in f32 FFMA on the
// CUDA cores (67 TFLOP/s; the tensor cores' f32 path is TF32, outside the
// parity gates), against 32 s d bytes of q, k, v, o, dO and the three
// gradients per (batch, head): at BERT-base's shape (b 32, s 512, h 12, d
// 64) 64.4 GFLOP take 0.962 ms and 403 MB 0.120 ms, so the FFMA rate bounds
// it; dropout adds ~16 integer operations per visible pair (the hash) on
// the same cores. The dQ partials add nk x 4 s d bytes written by the
// kernel and read by the wrapper's sum (201 MB each way at BERT's shape).
//
// Design: 256 threads, one block an SM (193 KB of shared memory at d 64,
// 225 KB at d 128; 219-255 registers a thread). K and V of the key tile
// stay in shared memory (16-byte chunks XOR-swizzled by key and rotated by
// one element, so that each FFMA of a dot-product step reads two registers
// of different banks); Q, dO, lse and delta of the query tiles stream
// through a 2-stage ring by `cp.async`, the next tile's copies started
// before this tile's products, with three barriers a query tile. Per query
// tile: S = Q K^T and dP = dO V^T in dot-product form along d (thread: 4
// rows x 8 or 4 keys; per 4 depth steps 4 loads of Q or dO shared by a
// quarter-warp and 8 or 4 of K or V), P and dS in the same registers,
// written as 16-byte rows of 4 keys (the mask's layout picked once a tile,
// not per pair); then dV += P_v^T dO and dK += dS^T Q (thread: 4 keys x 8
// features, per query row 6 16-byte loads for 64 FFMAs) and the dQ partial
// dS K (thread: 4 rows x 4 or 8 features; per 4 keys 4 dS loads and 4 or 8
// K loads), written to global memory 16 bytes at a time. Every product's
// loop runs two operand sets in turn, each loaded a step ahead of the
// FFMAs that read it.
//
// On "NVIDIA H100 80GB HBM3" at 700 W, BERT-base's f32 mask row (the
// wrapper's delta and partial sum included) takes ~2.04 ms, 47% of the f32
// bound (PERF.md section 6): the loops dispatch FFMA at 0.7-0.82 of the
// schedulers' rate (`tools/bwd_phases.py`), and the wrapper's delta and
// sum of 4 partials take ~0.15 ms.
#include "common.cuh"
#include "mma.cuh"

namespace {

using ptt::kNegInf;
using ptt::mma::cp_async16;
using ptt::mma::cp_async4;
using ptt::mma::cp_async_commit;
using ptt::mma::cp_async_wait;
using ptt::mma::smem_addr;

constexpr int kThreads = 256;
constexpr int kBQ = 64;  // query rows a tile

template <int D>
struct Tile {
  static constexpr int kBK = D == 64 ? 128 : 64;  // keys a block: one dQ partial each
  // S, P, dP, dS [kBQ][kBK]: 16 row groups x 16 key groups
  static constexpr int kSN = 16, kSM = kThreads / kSN;
  static constexpr int kSK = kBK / kSN;              // keys a thread: 8 or 4
  // dK, dV [kBK][D]: key groups x feature groups
  static constexpr int kGN = D == 64 ? 8 : 16, kGM = kThreads / kGN;
  static constexpr int kGF = D / kGN;                // features a thread: 8
  // the dQ partial [kBQ][D]: 16 row groups x 16 feature groups
  static constexpr int kQN = 16, kQM = kThreads / kQN;
  static constexpr int kQF = D / kQN;                // features a thread: 4 or 8
  static constexpr size_t kSmem =
      sizeof(float) * (2 * (size_t)kBK * D + 4 * (size_t)kBQ * D + 2 * (size_t)kBQ * kBK +
                       4 * (size_t)kBQ);
  static_assert(kSM * 4 == kBQ && kGM * 4 == kBK && kQM * 4 == kBQ, "one 4-row chunk a thread");
  static_assert(kSK % 4 == 0 && kGF % 4 == 0 && kQF % 4 == 0, "4-element chunks");
  static_assert(kSN % 8 == 0 && kGN % 8 == 0 && kQN % 8 == 0, "a quarter-warp shares a row");
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The 16-byte operands of one step of a product. The loops run two sets
// in turn, each loaded a step ahead of the FFMAs that read it (the loop
// body's first FFMAs would otherwise wait out the shared-memory latency at
// every iteration, and a set copied into the other costs a move a value).
template <int kA, int kB>
struct Frag {
  float4 a[kA], b[kB];
};

// K and V sit in shared memory with each 16-byte chunk rotated by one
// element, (e1, e2, e3, e0): the FFMAs of a dot-product step then read
// a.x with b.w, a.y with b.x, ..., registers of different banks (element e
// of a 4-register fragment sits in bank e; two same-bank sources cost the
// dispatch a cycle), in the same depth order.
__device__ __forceinline__ float4 rot(const float4& v) {
  return make_float4(v.y, v.z, v.w, v.x);
}

// acc[t][j] += dot(a[t], b[j]) over one 4-deep chunk, in depth order; b
// rotated
template <int kA, int kB>
__device__ __forceinline__ void dot4(float (&acc)[kA][kB], const Frag<kA, kB>& f) {
#pragma unroll
  for (int t = 0; t < kA; ++t)
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      acc[t][j] = fmaf(f.a[t].x, f.b[j].w, acc[t][j]);
      acc[t][j] = fmaf(f.a[t].y, f.b[j].x, acc[t][j]);
      acc[t][j] = fmaf(f.a[t].z, f.b[j].y, acc[t][j]);
      acc[t][j] = fmaf(f.a[t].w, f.b[j].z, acc[t][j]);
    }
}

// acc[t][4 fc + e] += a_t * b[fc].e: one rank-1 step of an outer product;
// with kRot, b's chunks are rotated (K's rows in the dQ product)
template <bool kRot = false, int kF>
__device__ __forceinline__ void outer(float (&acc)[4][kF], const float4& a, const float4* b) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float at = comp(a, t);
#pragma unroll
    for (int fc = 0; fc < kF / 4; ++fc) {
      const float4 bf = kRot ? make_float4(b[fc].w, b[fc].x, b[fc].y, b[fc].z) : b[fc];
      acc[t][4 * fc] = fmaf(at, bf.x, acc[t][4 * fc]);
      acc[t][4 * fc + 1] = fmaf(at, bf.y, acc[t][4 * fc + 1]);
      acc[t][4 * fc + 2] = fmaf(at, bf.z, acc[t][4 * fc + 2]);
      acc[t][4 * fc + 3] = fmaf(at, bf.w, acc[t][4 * fc + 3]);
    }
  }
}

// Rows [r0, r0 + kRows) of one head's [S, row_stride] slab into dst [kRows][D]
// by 16-byte cp.async copies; rows at or past S are zero-filled. kSwz puts
// chunk c of row r at chunk c ^ ((r >> 2) & 7).
template <int D, int kRows, bool kSwz>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int r0, int S,
                                          size_t row_stride, int tid) {
  constexpr int kC = D / 4;
  static_assert(kRows * kC % kThreads == 0, "whole copies per thread");
#pragma unroll
  for (int it = 0; it < kRows * kC / kThreads; ++it) {
    const int e = tid + it * kThreads, r = e / kC, c = e % kC, sr = r0 + r;
    const bool in = sr < S;
    const int pc = kSwz ? (c ^ ((r >> 2) & 7)) : c;
    cp_async16(smem_addr(dst + r * D + 4 * pc), src + (size_t)(in ? sr : 0) * row_stride + 4 * c,
               in);
  }
}

template <int D, bool kDrop, bool kMask, bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dq_part, float* __restrict__ dk, float* __restrict__ dv,
                 int B, int S, int H, int s_true, int causal, float scale, ptt::Dropout drop,
                 ptt::AddMask mask) {
  using TL = Tile<D>;
  constexpr int kBK = TL::kBK, kSN = TL::kSN, kSK = TL::kSK;
  constexpr int kGN = TL::kGN, kGF = TL::kGF, kQN = TL::kQN, kQF = TL::kQF;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                  // [kBK][D], chunks swizzled by key and rotated
  float* Vs = Ks + kBK * D;          // [kBK][D], chunks swizzled by key and rotated
  float* Qs = Vs + kBK * D;          // [2][kBQ][D]
  float* dOs = Qs + 2 * kBQ * D;     // [2][kBQ][D]
  float* Ps = dOs + 2 * kBQ * D;     // [kBQ][kBK]: P with dropout applied
  float* dSs = Ps + kBQ * kBK;       // [kBQ][kBK]
  float* Ls = dSs + kBQ * kBK;       // [2][kBQ]: lse
  float* Dl = Ls + 2 * kBQ;          // [2][kBQ]: delta

  const int tid = threadIdx.x;
  const int kt = blockIdx.x, bh = blockIdx.y, bi = bh / H, hh = bh % H;
  const int k_start = kt * kBK;
  const int nq = (S + kBQ - 1) / kBQ;
  const size_t row_stride = (size_t)H * D;
  const size_t head_off = (size_t)bi * S * row_stride + (size_t)hh * D;
  float* dqp = dq_part + (size_t)kt * B * S * row_stride + head_off;  // this key tile's slice
  const float* qh = q + head_off;
  const float* doh = dout + head_off;

  // S-tile thread: rows 4 sm + t, keys 4 (sn + 16 jc) + u
  const int sn = tid % kSN, sm = tid / kSN;
  auto skey = [&](int j) { return 4 * (sn + kSN * (j >> 2)) + (j & 3); };
  // dK / dV thread: keys 4 gm + t, features 4 (gn + kGN fc) + u
  const int gn = tid % kGN, gm = tid / kGN;
  // dQ thread: rows 4 qm + t, features 4 (qn + 16 fc) + u
  const int qn = tid % kQN, qm = tid / kQN;

  load_rows<D, kBK, true>(Ks, k + head_off, k_start, S, row_stride, tid);
  load_rows<D, kBK, true>(Vs, v + head_off, k_start, S, row_stride, tid);
  cp_async_commit();

  // causality: the kCausal flag without a mask, `causal` with one. Causal:
  // query tiles from the one holding row k_start; none when every key of
  // the tile is at or past s_true; with a mask every query tile
  const bool is_causal = kMask ? causal != 0 : kCausal;
  const int qt0 = kCausal && !kMask ? k_start / kBQ : 0;
  const bool meets = kMask || k_start < s_true;
  const int qt_end = meets ? nq : qt0;
  const int zero_rows = meets ? qt0 * kBQ : S;
  for (int e = tid; e < zero_rows * (D / 4); e += kThreads) {
    const int r = e / (D / 4), c = e % (D / 4);
    *reinterpret_cast<float4*>(dqp + (size_t)r * row_stride + 4 * c) =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // a key-padding mask: one value per column of the block
  const bool mask_by_key = kMask && mask.sq == 0;
  float mv[kSK];
#pragma unroll
  for (int j = 0; j < kSK; ++j) {
    const int col = k_start + skey(j);
    mv[j] = mask_by_key && col < S ? mask.at(bi, hh, 0, col) : 0.f;
  }

  auto load_stage = [&](int st, int qt) {
    const int q0 = qt * kBQ;
    load_rows<D, kBQ, false>(Qs + st * kBQ * D, qh, q0, S, row_stride, tid);
    load_rows<D, kBQ, false>(dOs + st * kBQ * D, doh, q0, S, row_stride, tid);
    if (tid < 2 * kBQ) {
      const int r = tid % kBQ, sr = q0 + r;
      const bool in = sr < S;
      const float* src = (tid < kBQ ? lse : delta) + (size_t)bh * S + (in ? sr : 0);
      cp_async4(smem_addr((tid < kBQ ? Ls : Dl) + st * kBQ + r), src, in);
    }
  };

  float dk_acc[4][kGF], dv_acc[4][kGF];
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int f = 0; f < kGF; ++f) dk_acc[t][f] = dv_acc[t][f] = 0.f;

  const int sswz = sn & 7;  // (skey(j) >> 2) & 7 for every j
  // acc[t][j] += A[4 sm + t] . B[skey(j)] over d (A: Q or dO rows, B: K or
  // V rows), in depth order, the next chunk's operands loaded a step ahead
  auto dot_tile = [&](float (&acc)[4][kSK], const float* A, const float* Bm) {
    auto load = [&](Frag<4, kSK>& f, int c) {
#pragma unroll
      for (int t = 0; t < 4; ++t) f.a[t] = ld4(A + (4 * sm + t) * D + 4 * c);
#pragma unroll
      for (int j = 0; j < kSK; ++j) f.b[j] = ld4(Bm + skey(j) * D + 4 * (c ^ sswz));
    };
    Frag<4, kSK> f0, f1;
    load(f0, 0);
#pragma unroll 1
    for (int c = 0; c < D / 4; c += 2) {
      load(f1, c + 1);
      dot4(acc, f0);
      load(f0, (c + 2) % (D / 4));  // the last step reloads chunk 0, unused
      dot4(acc, f1);
    }
  };
  if (qt0 < qt_end) load_stage(0, qt0);
  cp_async_commit();
  // rotate this thread's own K and V chunks (load_rows' map); the first
  // query tile's barrier publishes them
  cp_async_wait<1>();
#pragma unroll
  for (int it = 0; it < kBK * D / 4 / kThreads; ++it) {
    const int e = tid + it * kThreads, r = e / (D / 4), c = e % (D / 4);
    const int off = r * D + 4 * (c ^ ((r >> 2) & 7));
    float4* kc4 = reinterpret_cast<float4*>(Ks + off);
    float4* vc4 = reinterpret_cast<float4*>(Vs + off);
    *kc4 = rot(*kc4);
    *vc4 = rot(*vc4);
  }
  for (int qt = qt0; qt < qt_end; ++qt) {
    const int st = (qt - qt0) & 1, q_start = qt * kBQ;
    if (qt + 1 < qt_end) load_stage(st ^ 1, qt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // this tile's stage (and K, V) landed
    const float* Qt = Qs + st * kBQ * D;
    const float* dOt = dOs + st * kBQ * D;

    // S = Q K^T, then P = exp(S * scale - lse), zero where masked
    float sp[4][kSK];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int j = 0; j < kSK; ++j) sp[t][j] = 0.f;
    dot_tile(sp, Qt, Ks);
    // every pair passes the tests unless the tile holds padding rows, keys
    // at or past s_true, or the diagonal
    const bool tests = q_start + kBQ > S || k_start + kBK > s_true ||
                       (is_causal && k_start + kBK - 1 > q_start);
    uint32_t keep = 0;  // bit t * kSK + j: pair (t, j) kept (kDrop only)
    // P of every pair, mval(j, row, col) the mask's value there; the caller
    // picks the mask's layout once a tile, not per pair
    auto p_tile = [&](auto mval) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int row = q_start + 4 * sm + t;
        const float lr = Ls[st * kBQ + 4 * sm + t];
        float pv[kSK];
#pragma unroll
        for (int j = 0; j < kSK; ++j) {
          const int col = k_start + skey(j);
          const bool ok = !tests || (row < S && col < s_true && (!is_causal || col <= row));
          float p;
          if constexpr (kMask) {
            p = ok ? expf(fmaf(sp[t][j], scale, -lr) + mval(j, row, col))
                   : (row < S && col < S ? expf(kNegInf - lr) : 0.f);
          } else {
            p = ok ? expf(fmaf(sp[t][j], scale, -lr)) : 0.f;
          }
          sp[t][j] = p;
          pv[j] = p;
          if constexpr (kDrop) {
            const bool kp = ptt::dropout_keep(drop.seed, bh, row, col, drop.thresh);
            keep |= (uint32_t)kp << (t * kSK + j);
            pv[j] = kp ? p * drop.inv_keep : 0.f;
          }
        }
#pragma unroll
        for (int jc = 0; jc < kSK / 4; ++jc)
          *reinterpret_cast<float4*>(Ps + (4 * sm + t) * kBK + 4 * (sn + kSN * jc)) =
              make_float4(pv[4 * jc], pv[4 * jc + 1], pv[4 * jc + 2], pv[4 * jc + 3]);
      }
    };
    if (mask_by_key)
      p_tile([&](int j, int, int) { return mv[j]; });
    else
      p_tile([&](int, int row, int col) { return mask.at(bi, hh, row, col); });

    // dP = dO V^T on the same tiling, then dS = P (dP - delta) * scale
    float dp[4][kSK];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int j = 0; j < kSK; ++j) dp[t][j] = 0.f;
    dot_tile(dp, dOt, Vs);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float dl = Dl[st * kBQ + 4 * sm + t];
      float ds[kSK];
#pragma unroll
      for (int j = 0; j < kSK; ++j) {
        float dpv = dp[t][j];
        if constexpr (kDrop) dpv = ((keep >> (t * kSK + j)) & 1u) ? dpv * drop.inv_keep : 0.f;
        ds[j] = sp[t][j] * (dpv - dl) * scale;
      }
#pragma unroll
      for (int jc = 0; jc < kSK / 4; ++jc)
        *reinterpret_cast<float4*>(dSs + (4 * sm + t) * kBK + 4 * (sn + kSN * jc)) =
            make_float4(ds[4 * jc], ds[4 * jc + 1], ds[4 * jc + 2], ds[4 * jc + 3]);
    }
    __syncthreads();  // P and dS of every pair are in place

    // dV[key, f] += sum_q P_v[q, key] dO[q, f]; dK[key, f] += sum_q dS[q, key] Q[q, f]
    {
      // a: P_v and dS at (r, this thread's 4 keys); b: dO, then Q, at (r,
      // its features)
      auto load = [&](Frag<2, 2 * kGF / 4>& f, int r) {
        f.a[0] = ld4(Ps + r * kBK + 4 * gm);
        f.a[1] = ld4(dSs + r * kBK + 4 * gm);
#pragma unroll
        for (int fc = 0; fc < kGF / 4; ++fc) {
          f.b[fc] = ld4(dOt + r * D + 4 * (gn + kGN * fc));
          f.b[kGF / 4 + fc] = ld4(Qt + r * D + 4 * (gn + kGN * fc));
        }
      };
      auto step = [&](const Frag<2, 2 * kGF / 4>& f) {
        outer(dv_acc, f.a[0], f.b);
        outer(dk_acc, f.a[1], f.b + kGF / 4);
      };
      Frag<2, 2 * kGF / 4> f0, f1;
      load(f0, 0);
#pragma unroll 1
      for (int r = 0; r < kBQ; r += 2) {
        load(f1, r + 1);
        step(f0);
        load(f0, (r + 2) % kBQ);  // the last step reloads row 0, unused
        step(f1);
      }
    }

    // this key tile's dQ partial: dQ[q, f] = sum_key dS[q, key] K[key, f]
    float dq[4][kQF];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int f = 0; f < kQF; ++f) dq[t][f] = 0.f;
    {
      // a: dS at (this thread's 4 rows, keys 4 kc..4 kc + 3); b: K at (key
      // 4 kc + u, its features), u = 0..3
      auto load = [&](Frag<4, kQF>& f, int kc) {
#pragma unroll
        for (int t = 0; t < 4; ++t) f.a[t] = ld4(dSs + (4 * qm + t) * kBK + 4 * kc);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int fc = 0; fc < kQF / 4; ++fc)
            f.b[u * (kQF / 4) + fc] =
                ld4(Ks + (4 * kc + u) * D + 4 * ((qn + kQN * fc) ^ (kc & 7)));
      };
      // dq[t][f] += dS[t][4 kc + u] K[4 kc + u][f] for u = 0..3, in key order
      auto step = [&](const Frag<4, kQF>& f) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 col =
              make_float4(comp(f.a[0], u), comp(f.a[1], u), comp(f.a[2], u), comp(f.a[3], u));
          outer<true>(dq, col, f.b + u * (kQF / 4));
        }
      };
      Frag<4, kQF> f0, f1;
      load(f0, 0);
#pragma unroll 1
      for (int kc = 0; kc < kBK / 4; kc += 2) {
        load(f1, kc + 1);
        step(f0);
        load(f0, (kc + 2) % (kBK / 4));  // the last step reloads chunk 0, unused
        step(f1);
      }
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int row = q_start + 4 * qm + t;
      if (row >= S) continue;
      float* o = dqp + (size_t)row * row_stride;
#pragma unroll
      for (int fc = 0; fc < kQF / 4; ++fc)
        *reinterpret_cast<float4*>(o + 4 * (qn + kQN * fc)) =
            make_float4(dq[t][4 * fc], dq[t][4 * fc + 1], dq[t][4 * fc + 2], dq[t][4 * fc + 3]);
    }
    __syncthreads();  // every thread is done with P, dS and this stage
  }
  cp_async_wait<0>();

#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int key = k_start + 4 * gm + t;
    if (key >= S) continue;
    const size_t off = head_off + (size_t)key * row_stride;
#pragma unroll
    for (int fc = 0; fc < kGF / 4; ++fc) {
      const int f = 4 * (gn + kGN * fc);
      *reinterpret_cast<float4*>(dk + off + f) = make_float4(
          dk_acc[t][4 * fc], dk_acc[t][4 * fc + 1], dk_acc[t][4 * fc + 2], dk_acc[t][4 * fc + 3]);
      *reinterpret_cast<float4*>(dv + off + f) = make_float4(
          dv_acc[t][4 * fc], dv_acc[t][4 * fc + 1], dv_acc[t][4 * fc + 2], dv_acc[t][4 * fc + 3]);
    }
  }
}

template <int D, bool kDrop, bool kMask, bool kCausal>
cudaError_t launch_as(const float* q, const float* k, const float* v, const float* dout,
                      const float* lse, const float* delta, float* dq_part, float* dk, float* dv,
                      int b, int s, int h, int s_true, int causal, float scale,
                      ptt::Dropout drop, ptt::AddMask mask, cudaStream_t st) {
  constexpr size_t smem = Tile<D>::kSmem;
  cudaError_t err = ptt::allow_smem(flash_bwd_kernel<D, kDrop, kMask, kCausal>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((s + Tile<D>::kBK - 1) / Tile<D>::kBK, b * h);
  flash_bwd_kernel<D, kDrop, kMask, kCausal><<<grid, kThreads, smem, st>>>(
      q, k, v, dout, lse, delta, dq_part, dk, dv, b, s, h, s_true, causal, scale, drop, mask);
  return cudaSuccess;
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, const float* dout,
                   const float* lse, const float* delta, float* dq_part, int n_part, float* dk,
                   float* dv, int b, int s, int h, int s_true, int causal, float scale,
                   ptt::Dropout drop, ptt::AddMask mask, cudaStream_t st) {
  if (n_part != (s + Tile<D>::kBK - 1) / Tile<D>::kBK) return cudaErrorInvalidValue;
#define PTT_BWD(DROP, MASK, CAUSAL)                                                        \
  launch_as<D, DROP, MASK, CAUSAL>(q, k, v, dout, lse, delta, dq_part, dk, dv, b, s, h, \
                                   s_true, causal, scale, drop, mask, st)
  if (mask.p != nullptr)
    return drop.on ? PTT_BWD(true, true, false) : PTT_BWD(false, true, false);
  if (causal) return drop.on ? PTT_BWD(true, false, true) : PTT_BWD(false, false, true);
  return drop.on ? PTT_BWD(true, false, false) : PTT_BWD(false, false, false);
#undef PTT_BWD
}

}  // namespace

// q, k, v, dout, dk, dv: [b, s, h, d] f32 (dtype 0; bf16 goes to
// ptt_flash_attention_bwd_tc), q, k, v and dout starting on 16 bytes; lse
// and delta: [b, h, s] f32; dq_part: [n_part, b, s, h, d] f32, every
// element written, where n_part = ceil(s / key tile) (128 keys at d 64, 64
// at d 128; any other n_part is refused). d must be 64 or 128. mask, causal
// and dropout (seed, thresh, inv_keep) as the forward's.
extern "C" int ptt_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dq_part, int n_part, void* dk, void* dv,
                                       const void* mask, long long msb, long long msh,
                                       long long msq, long long msk, int b, int s, int h, int d,
                                       int s_true, int causal, float scale, int dtype,
                                       int dropout, unsigned seed, unsigned thresh,
                                       float inv_keep, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const ptt::Dropout drop{dropout, seed, thresh, inv_keep};
  const ptt::AddMask m{static_cast<const float*>(mask), msb, msh, msq, msk};
  if (b * h > 65535) return (int)cudaErrorInvalidValue;  // grid.y
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* df = static_cast<const float*>(dout);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  float* dqp = static_cast<float*>(dq_part);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  if (dtype == 0 && d == 128)
    err = launch<128>(qf, kf, vf, df, l, dl, dqp, n_part, dkf, dvf, b, s, h, s_true, causal,
                      scale, drop, m, st);
  else if (dtype == 0 && d == 64)
    err = launch<64>(qf, kf, vf, df, l, dl, dqp, n_part, dkf, dvf, b, s, h, s_true, causal,
                     scale, drop, m, st);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
