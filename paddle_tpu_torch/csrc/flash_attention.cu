// Flash-attention forward on [b, s, h, d], the f32 build: o = softmax(q k^T
// * scale + mask, masked past s_true and, when causal, above the diagonal)
// v, plus lse = logsumexp of each row.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py `_fwd_kernel` (called
// from `_flash_fwd` / `make_flash_attention`) in f32, causal or not, with or
// without an additive mask, with or without attention dropout; the bf16
// builds are flash_attention_tc.cu's (wgmma; TF32 tensor cores would break
// the f32 parity gates, so f32 stays on the CUDA cores in f32 FFMA). On the
// TPU the k-block axis is the innermost, sequential grid dimension and (m,
// l, acc) persist in VMEM scratch across it; here it is a loop inside one
// block.
//
// Mask (the `kMask` instantiations; the `.masked` entries): the f32
// element mask[b, h, row, col], read through four element strides
// (`ptt::AddMask`; a broadcast dim has stride 0), is added to the scaled
// logit before the s_true and causal tests, as the reference adds it
// before its `where`. A key-padding mask (query stride 0) is read once per
// key tile and column; any other layout once per (row, column). A launch
// with a mask walks every key tile (no causal or s_true skip): in f32,
// -1e30 + logit is -1e30, so a row the mask hides entirely weighs every key
// of the sequence alike, as in the plain version and the reference, and
// keys past the tensor's end weigh nothing. With kMask false nothing of the
// mask is compiled in; `causal` is a runtime argument. A zero mask adds
// exact zeros, and the extra tiles of a mask launch add exact zeros to l
// and to the outputs, so a causal launch with a zero mask gives the bits of
// the causal launch without one.
//
// Dropout (the `kDrop` instantiations; `.dropout` entry of
// `make_flash_attention`): after a tile's running max, l and alpha update,
// each weight p is kept as p / (1 - p_drop) (times the f32 reciprocal, as
// the reference) or zeroed, by `ptt::dropout_keep` on its global (row,
// column) and slice = batch * heads + head, before the P V product; l, and
// so lse, stays the sum of the weights before dropout. With kDrop false
// nothing of the hash is compiled in.
//
// What bounds it on the H100 SXM (data-sheet rates): the two products do 4
// d flops per visible (query, key) pair, in f32 FFMA on the CUDA cores (67
// TFLOP/s; the tensor
// cores' f32 path is TF32, outside the parity gates), against 16 s d bytes
// per (batch, head): at BERT-base's shape (b 32, s 512, h 12, d 64, every
// pair visible) 25.8 GFLOP take 0.385 ms and the 201 MB take 0.060 ms, so
// the FFMA rate bounds it, and an FFMA has to be dispatched in nearly every
// cycle of every scheduler. Dropout adds the hash, ~16 integer operations per
// visible pair, on the same cores.
//
// Design: one block of 128 threads per (batch x head, query tile): 128
// rows at d 64, 64 at d 128, two blocks an SM (100 / 112 KB of shared
// memory, 254-255 registers a thread). Q (scaled once in shared memory)
// stays for the block; K and V tiles of 64 keys stream through one buffer
// each by 16-byte `cp.async` copies, each started one phase ahead (K of the
// next tile during this tile's softmax and P V, V during this tile's Q
// K^T), with three barriers a tile. Thread (rg, cg) owns 8 rows, 8 or 4
// keys of the score tile and 8 output features (4-element chunks
// interleaved by the column-group count), so every shared-memory read is a
// 16-byte load: Q K^T runs in dot-product form along d (per 4 depth steps,
// 8 Q loads shared by the 8 lanes of a quarter-warp and 8 or 4 K loads for
// 256 or 128 FFMAs); P is written as 16-byte rows of 4 keys and P V reads
// P by rows and V by feature chunks (16 loads per 256 FFMAs). K's chunks
// are XOR-swizzled by key, so the 8 keys a quarter-warp reads fall in 8
// bank groups; at d 64 a warp's rows are 4 consecutive rows and Q and P
// rows carry a 16-byte pad, so those fall in 4. Q's chunks are stored
// rotated by one element so that each FFMA of Q K^T reads two registers of
// different banks. The cg lanes of a row group reduce the row max and sum
// with shuffles; (m, l) and the output accumulators stay in registers in
// f32 for the whole loop, and o and lse are written once.
//
// On "NVIDIA H100 80GB HBM3" at 700 W, BERT-base's f32 mask row takes
// ~0.69 ms (55% of the f32 bound; PERF.md section 6). The loops dispatch FFMA
// at ~0.7 of the schedulers' rate: the rest goes to the softmax, the
// shared loads' dispatch slots and the barriers.
#include "common.cuh"
#include "mma.cuh"

namespace {

using ptt::kNegInf;
using ptt::mma::cp_async16;
using ptt::mma::cp_async_commit;
using ptt::mma::cp_async_wait;
using ptt::mma::smem_addr;

constexpr int kThreads = 128;
constexpr int kBK = 64;  // keys a tile

template <int D>
struct Tile {
  static constexpr int kBQ = D == 64 ? 128 : 64;   // query rows a block
  static constexpr int kCG = D == 64 ? 8 : 16;     // column groups: lanes sharing a row group
  static constexpr int kRG = kThreads / kCG;       // row groups
  static constexpr int kTM = kBQ / kRG;            // rows a thread: 8
  static constexpr int kTN = kBK / kCG;            // keys a thread: 8 or 4
  static constexpr int kTF = D / kCG;              // output features a thread: 8
  // Row strides in floats. At d 64 a warp reads 4 consecutive Q and P rows
  // (rows rg + 16 i): a 16-byte pad puts them in 4 bank groups, one
  // wavefront a load. At d 128 (two blocks an SM leave no room for it) a
  // warp reads 2 rows 4 apart.
  static constexpr int kQD = D == 64 ? D + 4 : D;     // Q
  static constexpr int kPD = D == 64 ? kBK + 4 : kBK; // P
  static constexpr size_t kSmem =
      sizeof(float) * ((size_t)kBQ * kQD + 2 * (size_t)kBK * D + (size_t)kBQ * kPD);
  static_assert(kTM % 4 == 0 && kTN % 4 == 0 && kTF % 4 == 0, "4-element chunks");
  static_assert(kCG % 8 == 0 && 32 % kCG == 0, "a quarter-warp shares a row group");
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Rows [r0, r0 + kRows) of one head's [S, row_stride] slab into dst, rows
// kDst floats apart, by 16-byte cp.async copies; rows at or past S are
// zero-filled. kSwz puts chunk c of row r at chunk c ^ ((r >> 2) & 7).
template <int D, int kRows, bool kSwz, int kDst = D>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int r0, int S,
                                          size_t row_stride, int tid) {
  constexpr int kC = D / 4;
  static_assert(kRows * kC % kThreads == 0, "whole copies per thread");
#pragma unroll
  for (int it = 0; it < kRows * kC / kThreads; ++it) {
    const int e = tid + it * kThreads, r = e / kC, c = e % kC, sr = r0 + r;
    const bool in = sr < S;
    const int pc = kSwz ? (c ^ ((r >> 2) & 7)) : c;
    cp_async16(smem_addr(dst + r * kDst + 4 * pc),
               src + (size_t)(in ? sr : 0) * row_stride + 4 * c, in);
  }
}

template <int D, bool kDrop, bool kMask>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                 int S, int H, int s_true, int causal, float scale, ptt::Dropout drop,
                 ptt::AddMask mask) {
  using TL = Tile<D>;
  constexpr int kBQ = TL::kBQ, kCG = TL::kCG, kRG = TL::kRG;
  constexpr int kTM = TL::kTM, kTN = TL::kTN, kTF = TL::kTF, kQD = TL::kQD, kPD = TL::kPD;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;              // [kBQ][kQD], scaled, chunks rotated
  float* Ks = Qs + kBQ * kQD;    // [kBK][D], chunks swizzled by key
  float* Vs = Ks + kBK * D;      // [kBK][D]
  float* Ps = Vs + kBK * D;      // [kBQ][kPD]: this tile's weights

  const int tid = threadIdx.x, cg = tid % kCG, rg = tid / kCG;
  const int bh = blockIdx.y, bi = bh / H, hh = bh % H;
  const int q_start = blockIdx.x * kBQ;
  const size_t row_stride = (size_t)H * D;
  const size_t head_off = (size_t)bi * S * row_stride + (size_t)hh * D;
  const float* kh = k + head_off;
  const float* vh = v + head_off;
  // row i of this thread (local), key j of the tile, feature f
  auto row_of = [&](int i) {
    return D == 64 ? rg + kRG * i : 4 * (rg + kRG * (i >> 2)) + (i & 3);
  };
  auto key_of = [&](int j) { return 4 * (cg + kCG * (j >> 2)) + (j & 3); };
  auto feat_of = [&](int f) { return 4 * (cg + kCG * (f >> 2)) + (f & 3); };

  // key tiles below s_true, and when causal only up to the one holding
  // the tile's last row; with a mask every key tile
  const int last_row = min(q_start + kBQ - 1, S - 1);
  const int n_valid = (s_true + kBK - 1) / kBK;
  const int n_kt = kMask ? (S + kBK - 1) / kBK
                         : (causal ? min(last_row / kBK + 1, n_valid) : n_valid);

  load_rows<D, kBQ, false, kQD>(Qs, q + head_off, q_start, S, row_stride, tid);
  cp_async_commit();
  if (n_kt > 0) load_rows<D, kBK, true>(Ks, kh, 0, S, row_stride, tid);
  cp_async_commit();
  cp_async_wait<1>();
  // scale this thread's own Q copies and rotate each 16-byte chunk by one
  // element, (e1, e2, e3, e0): the FFMAs of a Q K^T step then read a.w with
  // b.x, a.x with b.y, ..., registers of different banks (element e of a
  // 4-register fragment sits in bank e; two same-bank sources cost the
  // dispatch a cycle), in the same depth order. The first tile's barrier
  // publishes them.
#pragma unroll
  for (int it = 0; it < kBQ * D / 4 / kThreads; ++it) {
    const int e = tid + it * kThreads;
    float4* p = reinterpret_cast<float4*>(Qs + (e / (D / 4)) * kQD) + e % (D / 4);
    const float4 x = *p;
    *p = make_float4(x.y * scale, x.z * scale, x.w * scale, x.x * scale);
  }

  float m[kTM], l[kTM], acc[kTM][kTF];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int f = 0; f < kTF; ++f) acc[i][f] = 0.f;
  }
  const bool mask_by_key = kMask && mask.sq == 0;  // one value per column
  const int swz = cg & 7;                          // (key_of(j) >> 2) & 7 for every j

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k_start = kt * kBK;
    cp_async_wait<0>();
    __syncthreads();  // K of this tile landed; every thread is done with P and V
    load_rows<D, kBK, false>(Vs, vh, k_start, S, row_stride, tid);
    cp_async_commit();

    float sc[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) sc[i][j] = 0.f;
#pragma unroll 2
    for (int c = 0; c < D / 4; ++c) {
      float4 a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = ld4(Qs + row_of(i) * kQD + 4 * c);
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = ld4(Ks + key_of(j) * D + 4 * (c ^ swz));
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          sc[i][j] = fmaf(a[i].w, b[j].x, sc[i][j]);
          sc[i][j] = fmaf(a[i].x, b[j].y, sc[i][j]);
          sc[i][j] = fmaf(a[i].y, b[j].z, sc[i][j]);
          sc[i][j] = fmaf(a[i].z, b[j].w, sc[i][j]);
        }
    }
    __syncthreads();  // every thread is done with K
    if (kt + 1 < n_kt) load_rows<D, kBK, true>(Ks, kh, k_start + kBK, S, row_stride, tid);
    cp_async_commit();

    // the logit is scaled (q was); add the mask, then the tests, only on
    // tiles where some pair fails them
    if constexpr (kMask) {
      if (mask_by_key) {
        float mv[kTN];
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          const int col = k_start + key_of(j);
          mv[j] = col < S ? mask.at(bi, hh, 0, col) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) sc[i][j] += mv[j];
      } else {
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          const int row = q_start + row_of(i);
#pragma unroll
          for (int j = 0; j < kTN; ++j) {
            const int col = k_start + key_of(j);
            if (row < S && col < S) sc[i][j] += mask.at(bi, hh, row, col);
          }
        }
      }
    }
    const bool tests = k_start + kBK > s_true || (causal && k_start + kBK - 1 > q_start);
    if (tests) {
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const int row = q_start + row_of(i);
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          const int col = k_start + key_of(j);
          const bool valid = col < s_true && (!causal || col <= row);
          // a key past the tensor's end weighs nothing even in a hidden row
          if (!valid) sc[i][j] = kMask && col >= S ? -INFINITY : kNegInf;
        }
      }
    }

#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int row = q_start + row_of(i);
      float mx = sc[i][0];
#pragma unroll
      for (int j = 1; j < kTN; ++j) mx = fmaxf(mx, sc[i][j]);
      mx = ptt::warp_max(mx, kCG);  // the kCG lanes of this row group
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const float pj = expf(sc[i][j] - m_new);
        sum += pj;  // l sums the weights before dropout
        float w = pj;
        if constexpr (kDrop) {
          const bool keep =
              ptt::dropout_keep(drop.seed, bh, row, k_start + key_of(j), drop.thresh);
          w = keep ? pj * drop.inv_keep : 0.f;
        }
        sc[i][j] = w;
      }
      sum = ptt::warp_sum(sum, kCG);
      const float alpha = expf(m[i] - m_new);
      l[i] = fmaf(alpha, l[i], sum);
      m[i] = m_new;
#pragma unroll
      for (int f = 0; f < kTF; ++f) acc[i][f] *= alpha;
#pragma unroll
      for (int jc = 0; jc < kTN / 4; ++jc)
        *reinterpret_cast<float4*>(Ps + row_of(i) * kPD + 4 * (cg + kCG * jc)) =
            make_float4(sc[i][4 * jc], sc[i][4 * jc + 1], sc[i][4 * jc + 2], sc[i][4 * jc + 3]);
    }
    cp_async_wait<1>();
    __syncthreads();  // V of this tile and every row's weights are in place

#pragma unroll 2
    for (int kc = 0; kc < kBK / 4; ++kc) {
      float4 p[kTM];
#pragma unroll
      for (int i = 0; i < kTM; ++i) p[i] = ld4(Ps + row_of(i) * kPD + 4 * kc);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vr = Vs + (4 * kc + u) * D;
        float4 vv[kTF / 4];
#pragma unroll
        for (int fc = 0; fc < kTF / 4; ++fc) vv[fc] = ld4(vr + feat_of(4 * fc));
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          const float pu = comp(p[i], u);
#pragma unroll
          for (int fc = 0; fc < kTF / 4; ++fc) {
            acc[i][4 * fc] = fmaf(pu, vv[fc].x, acc[i][4 * fc]);
            acc[i][4 * fc + 1] = fmaf(pu, vv[fc].y, acc[i][4 * fc + 1]);
            acc[i][4 * fc + 2] = fmaf(pu, vv[fc].z, acc[i][4 * fc + 2]);
            acc[i][4 * fc + 3] = fmaf(pu, vv[fc].w, acc[i][4 * fc + 3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = q_start + row_of(i);
    if (row >= S) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    float* orow = o + head_off + (size_t)row * row_stride;
#pragma unroll
    for (int fc = 0; fc < kTF / 4; ++fc)
      *reinterpret_cast<float4*>(orow + feat_of(4 * fc)) =
          make_float4(acc[i][4 * fc] / lc, acc[i][4 * fc + 1] / lc, acc[i][4 * fc + 2] / lc,
                      acc[i][4 * fc + 3] / lc);
    if (cg == 0) lse[(size_t)bh * S + row] = m[i] + logf(lc);
  }
}

template <int D, bool kDrop, bool kMask>
cudaError_t launch_as(const float* q, const float* k, const float* v, float* o, float* lse,
                      int b, int s, int h, int s_true, int causal, float scale,
                      ptt::Dropout drop, ptt::AddMask mask, cudaStream_t st) {
  constexpr size_t smem = Tile<D>::kSmem;
  cudaError_t err = ptt::allow_smem(flash_fwd_kernel<D, kDrop, kMask>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((s + Tile<D>::kBQ - 1) / Tile<D>::kBQ, b * h);
  flash_fwd_kernel<D, kDrop, kMask><<<grid, kThreads, smem, st>>>(
      q, k, v, o, lse, s, h, s_true, causal, scale, drop, mask);
  return cudaSuccess;
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* o, float* lse,
                   int b, int s, int h, int s_true, int causal, float scale,
                   ptt::Dropout drop, ptt::AddMask mask, cudaStream_t st) {
#define PTT_FWD(DROP, MASK) \
  launch_as<D, DROP, MASK>(q, k, v, o, lse, b, s, h, s_true, causal, scale, drop, mask, st)
  if (mask.p != nullptr) return drop.on ? PTT_FWD(true, true) : PTT_FWD(false, true);
  return drop.on ? PTT_FWD(true, false) : PTT_FWD(false, false);
#undef PTT_FWD
}

}  // namespace

// dtype: 0 = float32 (q, k, v and o share it; bf16 takes
// flash_attention_tc.cu); q, k and v start on 16 bytes; lse is f32 [b, h,
// s]. d must be 64 or 128. mask: null, or the f32 additive mask read at
// mask[bi * msb + hh * msh + row * msq + col * msk]. causal != 0 masks keys
// above the diagonal. dropout != 0 drops attention weights with the
// reference's hash of seed, kept where it is >= thresh, scaled by inv_keep.
extern "C" int ptt_flash_attention_fwd(const void* q, const void* k, const void* v,
                                       void* o, void* lse, const void* mask, long long msb,
                                       long long msh, long long msq, long long msk, int b,
                                       int s, int h, int d, int s_true, int causal,
                                       float scale, int dtype, int dropout, unsigned seed,
                                       unsigned thresh, float inv_keep, int device,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b * h > 65535) return (int)cudaErrorInvalidValue;  // grid.y
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  float* l = static_cast<float*>(lse);
  const ptt::Dropout drop{dropout, seed, thresh, inv_keep};
  const ptt::AddMask m{static_cast<const float*>(mask), msb, msh, msq, msk};
  if (dtype == 0 && d == 128)
    err = launch<128>(qf, kf, vf, of, l, b, s, h, s_true, causal, scale, drop, m, st);
  else if (dtype == 0 && d == 64)
    err = launch<64>(qf, kf, vf, of, l, b, s, h, s_true, causal, scale, drop, m, st);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
