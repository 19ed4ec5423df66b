// Flash-attention forward on [b, s, h, d]: o = softmax(q k^T * scale + mask,
// masked past s_true and, when causal, above the diagonal) v, plus lse =
// logsumexp of each row.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py `_fwd_kernel` (called
// from `_flash_fwd` / `make_flash_attention`) in f32, causal or not, with or
// without an additive mask, with or without attention dropout; the bf16
// builds are flash_attention_tc.cu's (wgmma; TF32 tensor cores would break
// the f32 parity gates, so f32 stays on the CUDA cores). On the TPU
// the k-block axis is the innermost, sequential grid dimension and (m, l,
// acc) persist in VMEM scratch across it; here it is a loop inside one
// block.
//
// Mask (the `kMask` instantiations; the `.masked` entries): the f32
// element mask[b, h, row, col], read through four element strides
// (`ptt::AddMask`; a broadcast dim has stride 0), is added to the scaled
// logit before the s_true and causal tests, as the reference adds it
// before its `where`. A launch with a mask walks every key tile (no causal
// or s_true skip): in f32, -1e30 + logit is -1e30, so a row the mask hides
// entirely weighs every key of the sequence alike, as in the plain version
// and the reference, and keys past the tensor's end weigh nothing. With
// kMask false nothing of the mask is compiled in; `causal` is a runtime
// argument (the non-causal launch drops the diagonal bound and the
// `col <= row` test).
//
// Dropout (the `kDrop` instantiations; `.dropout` entry of
// `make_flash_attention`): after a tile's running max, l and alpha update,
// each weight p is kept as p / (1 - p_drop) (times the f32 reciprocal, as
// the reference) or zeroed, by `ptt::dropout_keep` on its global (row,
// column) and slice = batch * heads + head, before the P V product; l, and
// so lse, stays the sum of the weights before dropout. With kDrop false
// the kernel is the one without dropout, instruction for instruction.
//
// What bounds it on the H100: causal attention does about 4 * d * s^2 / 2
// flops per (batch, head) and moves 4 * s * d * 2 bytes (bf16 q, k, v, o),
// so about s / 4 flops per byte against the card's ~295 (989 TFLOP/s bf16
// over 3.35 TB/s). At the serving path's prefill shape (s = 320) that is
// ~80 flops/byte: the function is bound by memory, and becomes bound by the
// tensor cores only from s of about 1200 up. Dropout adds the hash, ~16
// integer operations per visible (query, key) pair on the CUDA cores. This
// kernel computes on the CUDA cores in f32 and is far from both bounds.
//
// Design: one block of 128 threads per (batch x head, 64-row query tile).
// The block stages the query tile (pre-scaled, f32) in shared memory, then
// loops over 64-key tiles from 0 below s_true (and, when causal, up to
// the diagonal),
// staging k and v in shared memory. Each thread owns 4 query rows x 8 key
// columns of the score tile and 4 rows x d/8 features of the output, rows
// and columns interleaved so that shared-memory reads spread over banks.
// The 8 threads of a row group reduce the row max and sum with shuffles;
// (m, l) and the output accumulators stay in registers in f32 for the
// whole loop, and o (input dtype) and lse (f32) are written once.
#include "common.cuh"

namespace {

using ptt::from_f32;
using ptt::kNegInf;
using ptt::to_f32;

constexpr int kThreads = 128;
constexpr int kBQ = 64, kBK = 64;
constexpr int kRowsPerThread = 4;   // rows rg + 16 * i
constexpr int kColsPerThread = 8;   // key columns cg + 8 * j

template <int D>
constexpr size_t smem_floats() {
  return (size_t)kBQ * (D + 1) + (size_t)kBK * (D + 1) + (size_t)kBK * D +
         (size_t)kBQ * (kBK + 1);
}

template <typename T, int D, bool kDrop, bool kMask>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                 int S, int H, int s_true, int causal, float scale, ptt::Dropout drop,
                 ptt::AddMask mask) {
  constexpr int kOut = D / 8;  // output features per thread: cg + 8 * jd
  extern __shared__ float smem[];
  float* Qs = smem;                       // [kBQ][D + 1]
  float* Ks = Qs + kBQ * (D + 1);         // [kBK][D + 1]
  float* Vs = Ks + kBK * (D + 1);         // [kBK][D]
  float* Ps = Vs + kBK * D;               // [kBQ][kBK + 1]

  const int tid = threadIdx.x;
  const int rg = tid / 8, cg = tid % 8;   // 16 row groups x 8 column groups
  const int bh = blockIdx.y, bi = bh / H, hh = bh % H;
  const int q_start = blockIdx.x * kBQ;
  const size_t row_stride = (size_t)H * D;
  const size_t head_off = (size_t)bi * S * row_stride + (size_t)hh * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, j = e % D, sr = q_start + r;
    Qs[r * (D + 1) + j] =
        sr < S ? to_f32(q[head_off + (size_t)sr * row_stride + j]) * scale : 0.f;
  }

  float m[kRowsPerThread], l[kRowsPerThread], acc[kRowsPerThread][kOut];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jd = 0; jd < kOut; ++jd) acc[i][jd] = 0.f;
  }

  // key tiles below s_true, and when causal only up to the one holding
  // the tile's last row; with a mask every key tile
  const int last_row = min(q_start + kBQ - 1, S - 1);
  const int n_valid = (s_true + kBK - 1) / kBK;
  const int n_kt = kMask ? (S + kBK - 1) / kBK
                         : (causal ? min(last_row / kBK + 1, n_valid) : n_valid);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k_start = kt * kBK;
    __syncthreads();  // the previous tile's readers are done with Ks/Vs
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, j = e % D, sr = k_start + r;
      const bool in = sr < S;
      const size_t off = head_off + (size_t)sr * row_stride + j;
      Ks[r * (D + 1) + j] = in ? to_f32(k[off]) : 0.f;
      Vs[r * D + j] = in ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();

    float sc[kRowsPerThread][kColsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < D; ++dd) {
      float qv[kRowsPerThread], kv[kColsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) qv[i] = Qs[(rg + 16 * i) * (D + 1) + dd];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) kv[j] = Ks[(cg + 8 * j) * (D + 1) + dd];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int row = q_start + rg + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int col = k_start + cg + 8 * j;
        const bool valid = col < s_true && (!causal || col <= row);
        if constexpr (kMask) {
          // the logit is scaled (q was); add the mask, then the tests; a
          // key past the tensor's end weighs nothing even in a hidden row
          if (row < S && col < S) sc[i][j] += mask.at(bi, hh, row, col);
          if (!valid) sc[i][j] = col < S ? kNegInf : -INFINITY;
        } else {
          if (!valid) sc[i][j] = kNegInf;
        }
        mx = fmaxf(mx, sc[i][j]);
      }
      mx = ptt::warp_max(mx, 8);  // the 8 lanes of this row group
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const float pj = expf(sc[i][j] - m_new);
        float w = pj;
        if constexpr (kDrop) {
          const bool keep = ptt::dropout_keep(drop.seed, bh, row, k_start + cg + 8 * j,
                                              drop.thresh);
          w = keep ? pj * drop.inv_keep : 0.f;
        }
        Ps[(rg + 16 * i) * (kBK + 1) + cg + 8 * j] = w;
        sum += pj;  // l sums the weights before dropout
      }
      sum = ptt::warp_sum(sum, 8);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int jd = 0; jd < kOut; ++jd) acc[i][jd] *= alpha;
    }
    __syncwarp();  // a row's weights are written and read by one warp

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) pv[i] = Ps[(rg + 16 * i) * (kBK + 1) + kk];
#pragma unroll
      for (int jd = 0; jd < kOut; ++jd) {
        const float vv = Vs[kk * D + cg + 8 * jd];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) acc[i][jd] = fmaf(pv[i], vv, acc[i][jd]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = q_start + rg + 16 * i;
    if (row >= S) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    const size_t off = head_off + (size_t)row * row_stride;
#pragma unroll
    for (int jd = 0; jd < kOut; ++jd) o[off + cg + 8 * jd] = from_f32<T>(acc[i][jd] / lc);
    if (cg == 0) lse[(size_t)bh * S + row] = m[i] + logf(lc);
  }
}

template <typename T, int D, bool kDrop, bool kMask>
cudaError_t launch_as(const void* q, const void* k, const void* v, void* o, float* lse,
                      int b, int s, int h, int s_true, int causal, float scale,
                      ptt::Dropout drop, ptt::AddMask mask, cudaStream_t st) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  cudaError_t err = ptt::allow_smem(flash_fwd_kernel<T, D, kDrop, kMask>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((s + kBQ - 1) / kBQ, b * h);
  flash_fwd_kernel<T, D, kDrop, kMask><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, s, h, s_true, causal, scale, drop, mask);
  return cudaSuccess;
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   int b, int s, int h, int s_true, int causal, float scale,
                   ptt::Dropout drop, ptt::AddMask mask, cudaStream_t st) {
#define PTT_FWD(DROP, MASK)                                                          \
  launch_as<T, D, DROP, MASK>(q, k, v, o, lse, b, s, h, s_true, causal, scale, drop, \
                              mask, st)
  if (mask.p != nullptr) return drop.on ? PTT_FWD(true, true) : PTT_FWD(false, true);
  return drop.on ? PTT_FWD(true, false) : PTT_FWD(false, false);
#undef PTT_FWD
}

}  // namespace

// dtype: 0 = float32 (q, k, v and o share it; bf16 takes
// flash_attention_tc.cu); lse is f32 [b, h, s]. d must be 64 or 128. mask: null, or the f32 additive mask
// read at mask[bi * msb + hh * msh + row * msq + col * msk]. causal != 0
// masks keys above the diagonal. dropout != 0 drops attention weights
// with the reference's hash of seed, kept where it is >= thresh, scaled by
// inv_keep.
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
  float* l = static_cast<float*>(lse);
  const ptt::Dropout drop{dropout, seed, thresh, inv_keep};
  const ptt::AddMask m{static_cast<const float*>(mask), msb, msh, msq, msk};
  if (dtype == 0 && d == 128)
    err = launch<float, 128>(q, k, v, o, l, b, s, h, s_true, causal, scale, drop, m, st);
  else if (dtype == 0 && d == 64)
    err = launch<float, 64>(q, k, v, o, l, b, s, h, s_true, causal, scale, drop, m, st);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
