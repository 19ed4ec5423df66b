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
// per (batch x head, 64-key tile) loops over the 64-row query tiles the key
// tile meets (all of them, or from the diagonal on when causal), keeps dK
// and dV in f32 registers, and writes its f32 dQ partial to its own slice
// of a [nk, b, s, h, d] buffer; the wrapper sums the nk slices. Partials of
// query tiles the key tile does not meet (before the diagonal, or every
// tile when the key tile starts at or past s_true) are written as exact
// zeros, as the reference flushes its skipped cells; a non-causal key tile
// below s_true meets every query tile and flushes nothing. No atomics
// anywhere.
//
// Mask (the `kMask` instantiations): P is rebuilt as exp(S * scale - lse +
// mask[b, h, row, col]) (the f32 mask read through `ptt::AddMask`'s four
// strides), and a masked-out pair inside the tensor as exp(NEG_INF - lse),
// the reference's `_block_p` (0 unless the row is hidden entirely, where
// lse is itself about NEG_INF). A launch with a mask meets every (key tile,
// query tile) cell, as the forward walks every key tile, so the gradients
// of a hidden row are the plain version's too. `S * scale - lse` is one
// explicit fused multiply-add with or without a mask (nvcc contracted the
// maskless expression to it before), so a zero mask gives the maskless
// bits; the reference adds the mask before subtracting lse, which moves
// only the last bits of P. With kMask false nothing of the mask is
// compiled in, and causality is the `kCausal` flag, so the causal launch
// without a mask runs the instructions it ran before masks were ported (a
// runtime `causal` there cost it 2%); a launch with a mask reads `causal`
// at run time, to keep the instantiations at 24 a file.
//
// What bounds it on the H100: per visible (query, key) pair it does five
// d-long products (S again, dV, dP, dK, dQ: 10 d flops), about 5 d s^2 per
// (batch, head) when causal, against 16 s d bytes of bf16 q, k, v, o, dO and
// the three gradients: ~s / 3 flops per byte, ~330 at the training shapes'
// s = 1024, just above the card's ~295, so the tensor cores' peak (989
// TFLOP/s bf16) bounds it; dropout adds ~16 integer operations per visible
// pair (the hash) on the CUDA cores. This first kernel computes on the CUDA
// cores in f32, far from that bound; wgmma tiles are later work.
//
// Per query tile: stage Q and dO (f32, rows padded to d + 1 floats against
// bank conflicts) beside the block's K and V; each of 256 threads owns a
// 4 x 4 tile of the 64 x 64 scores (rows ty + 16 i, keys tx + 16 j):
// P = exp(S * scale - lse) masked, then dP = dO V^T and
// dS = P (dP - delta) * scale in the same registers; P and then dS pass
// through one shared tile for the three products that read them by column.
// Each thread owns 4 key rows x d/16 features of dK and dV and 4 query rows
// x d/16 features of the dQ partial. d 64 or 128; f32 in and out (on the
// tensor cores f32 would run as TF32, which the f32 training paths'
// tolerances do not allow; its bf16 instantiations went to the
// tensor-core build).
//
// Dropout (the `kDrop` instantiations): each thread hashes its 16 (query,
// key) pairs with `ptt::dropout_keep` on their global positions, as the
// forward did, and keeps the bits in a register mask. dV reads the dropped
// weights p_v = keep ? p / (1 - p_drop) : 0; dP is dropped the same way;
// dS = P (dP - delta) * scale takes the undropped P; delta = rowsum(dO o)
// over the dropped forward's o, as without dropout (the reference's
// `_fused_bwd_kernel`). With kDrop false the kernel is the one without
// dropout, instruction for instruction.
#include "common.cuh"

namespace {

using ptt::from_f32;
using ptt::kNegInf;
using ptt::to_f32;

constexpr int kThreads = 256;
constexpr int kBQ = 64, kBK = 64;

template <int D>
constexpr size_t smem_floats() {
  return 4 * (size_t)kBK * (D + 1) + (size_t)kBQ * (kBK + 1) + 2 * (size_t)kBQ;
}

template <typename T, int D, bool kDrop, bool kMask, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq_part,
                 T* __restrict__ dk, T* __restrict__ dv, int B, int S, int H, int s_true,
                 int causal, float scale, ptt::Dropout drop, ptt::AddMask mask) {
  constexpr int kF = D / 16;  // features per thread: tx + 16 * j
  constexpr int DP = D + 1;   // padded row stride
  extern __shared__ float smem[];
  float* Ks = smem;                     // [kBK][DP]
  float* Vs = Ks + kBK * DP;            // [kBK][DP]
  float* Qs = Vs + kBK * DP;            // [kBQ][DP]
  float* dOs = Qs + kBQ * DP;           // [kBQ][DP]
  float* Ps = dOs + kBQ * DP;           // [kBQ][kBK + 1]: P, then dS
  float* lse_s = Ps + kBQ * (kBK + 1);  // [kBQ]
  float* del_s = lse_s + kBQ;           // [kBQ]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int kt = blockIdx.x, bh = blockIdx.y, bi = bh / H, hh = bh % H;
  const int k_start = kt * kBK;
  const int nq = (S + kBQ - 1) / kBQ;
  const size_t row_stride = (size_t)H * D;
  const size_t head_off = (size_t)bi * S * row_stride + (size_t)hh * D;
  float* dqp = dq_part + (size_t)kt * B * S * row_stride;  // this key tile's slice

  for (int e = tid; e < kBK * D; e += kThreads) {
    const int r = e / D, j = e % D, sr = k_start + r;
    const bool in = sr < S;
    const size_t off = head_off + (size_t)sr * row_stride + j;
    Ks[r * DP + j] = in ? to_f32(k[off]) : 0.f;
    Vs[r * DP + j] = in ? to_f32(v[off]) : 0.f;
  }

  // causality: the kCausal flag without a mask, `causal` with one. Causal:
  // query tiles from the one holding row k_start; none when every key of
  // the tile is at or past s_true; with a mask every query tile
  const bool is_causal = kMask ? causal != 0 : kCausal;
  const int qt0 = kCausal && !kMask ? k_start / kBQ : 0;
  const bool meets = kMask || k_start < s_true;
  const int qt_end = meets ? nq : qt0;
  const int zero_rows = meets ? qt0 * kBQ : S;
  for (size_t e = tid; e < (size_t)zero_rows * D; e += kThreads) {
    const size_t r = e / D, j = e % D;
    dqp[head_off + r * row_stride + j] = 0.f;
  }

  float dk_acc[4][kF], dv_acc[4][kF];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kF; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int qt = qt0; qt < qt_end; ++qt) {
    const int q_start = qt * kBQ;
    __syncthreads();  // the previous tile's readers are done with Qs, dOs, Ps
    for (int e = tid; e < kBQ * D; e += kThreads) {
      const int r = e / D, j = e % D, sr = q_start + r;
      const bool in = sr < S;
      const size_t off = head_off + (size_t)sr * row_stride + j;
      Qs[r * DP + j] = in ? to_f32(q[off]) : 0.f;
      dOs[r * DP + j] = in ? to_f32(dout[off]) : 0.f;
    }
    for (int r = tid; r < kBQ; r += kThreads) {
      const int sr = q_start + r;
      lse_s[r] = sr < S ? lse[(size_t)bh * S + sr] : 0.f;
      del_s[r] = sr < S ? delta[(size_t)bh * S + sr] : 0.f;
    }
    __syncthreads();

    // P = exp(Q K^T * scale - lse), zero where masked
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) p[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < D; ++dd) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * DP + dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * DP + dd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) p[i][j] = fmaf(qv[i], kv[j], p[i][j]);
    }
    uint32_t keep = 0;  // bit 4 i + j: pair (i, j) kept (kDrop only)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q_start + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k_start + tx + 16 * j;
        const bool ok = row < S && col < s_true && (!is_causal || col <= row);
        if constexpr (kMask) {
          const bool in = row < S && col < S;
          const float l = lse_s[ty + 16 * i];
          p[i][j] = ok ? expf(fmaf(p[i][j], scale, -l) + mask.at(bi, hh, row, col))
                       : (in ? expf(kNegInf - l) : 0.f);
        } else {
          p[i][j] = ok ? expf(fmaf(p[i][j], scale, -lse_s[ty + 16 * i])) : 0.f;
        }
        float pv = p[i][j];
        if constexpr (kDrop) {
          const bool kp = ptt::dropout_keep(drop.seed, bh, row, col, drop.thresh);
          keep |= (uint32_t)kp << (4 * i + j);
          pv = kp ? pv * drop.inv_keep : 0.f;
        }
        Ps[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] = pv;
      }
    }
    __syncthreads();

    // dV[key, f] += sum_q P[q, key] dO[q, f]   (keys ty + 16 i)
#pragma unroll 4
    for (int qq = 0; qq < kBQ; ++qq) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[qq * (kBK + 1) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kF; ++j) {
        const float g = dOs[qq * DP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) dv_acc[i][j] = fmaf(pv[i], g, dv_acc[i][j]);
      }
    }

    // dP = dO V^T on the score tiling, then dS = P (dP - delta) * scale
    float dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dp[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < D; ++dd) {
      float gv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) gv[i] = dOs[(ty + 16 * i) * DP + dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) vv[j] = Vs[(tx + 16 * j) * DP + dd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
    }
    __syncthreads();  // every thread is done reading P for dV
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float dpv = dp[i][j];
        if constexpr (kDrop) dpv = ((keep >> (4 * i + j)) & 1u) ? dpv * drop.inv_keep : 0.f;
        Ps[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] =
            p[i][j] * (dpv - del_s[ty + 16 * i]) * scale;
      }
    __syncthreads();

    // dK[key, f] += sum_q dS[q, key] Q[q, f]   (keys ty + 16 i)
#pragma unroll 4
    for (int qq = 0; qq < kBQ; ++qq) {
      float sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = Ps[qq * (kBK + 1) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kF; ++j) {
        const float qf = Qs[qq * DP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) dk_acc[i][j] = fmaf(sv[i], qf, dk_acc[i][j]);
      }
    }

    // this key tile's dQ partial: dQ[q, f] = sum_key dS[q, key] K[key, f]
    float dq[4][kF];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kF; ++j) dq[i][j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = Ps[(ty + 16 * i) * (kBK + 1) + kk];
#pragma unroll
      for (int j = 0; j < kF; ++j) {
        const float kf = Ks[kk * DP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) dq[i][j] = fmaf(sv[i], kf, dq[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q_start + ty + 16 * i;
      if (row >= S) continue;
      float* o = dqp + head_off + (size_t)row * row_stride + tx;
#pragma unroll
      for (int j = 0; j < kF; ++j) o[16 * j] = dq[i][j];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k_start + ty + 16 * i;
    if (key >= S) continue;
    const size_t off = head_off + (size_t)key * row_stride + tx;
#pragma unroll
    for (int j = 0; j < kF; ++j) {
      dk[off + 16 * j] = from_f32<T>(dk_acc[i][j]);
      dv[off + 16 * j] = from_f32<T>(dv_acc[i][j]);
    }
  }
}

template <typename T, int D, bool kDrop, bool kMask, bool kCausal>
cudaError_t launch_as(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, float* dq_part, void* dk,
                      void* dv, int b, int s, int h, int s_true, int causal, float scale,
                      ptt::Dropout drop, ptt::AddMask mask, cudaStream_t st) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  cudaError_t err = ptt::allow_smem(flash_bwd_kernel<T, D, kDrop, kMask, kCausal>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((s + kBK - 1) / kBK, b * h);
  flash_bwd_kernel<T, D, kDrop, kMask, kCausal><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, dq_part, static_cast<T*>(dk),
      static_cast<T*>(dv), b, s, h, s_true, causal, scale, drop, mask);
  return cudaSuccess;
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, float* dq_part, void* dk, void* dv,
                   int b, int s, int h, int s_true, int causal, float scale,
                   ptt::Dropout drop, ptt::AddMask mask, cudaStream_t st) {
#define PTT_BWD(DROP, MASK, CAUSAL)                                                     \
  launch_as<T, D, DROP, MASK, CAUSAL>(q, k, v, dout, lse, delta, dq_part, dk, dv, b, s, h, \
                                      s_true, causal, scale, drop, mask, st)
  if (mask.p != nullptr)
    return drop.on ? PTT_BWD(true, true, false) : PTT_BWD(false, true, false);
  if (causal) return drop.on ? PTT_BWD(true, false, true) : PTT_BWD(false, false, true);
  return drop.on ? PTT_BWD(true, false, false) : PTT_BWD(false, false, false);
#undef PTT_BWD
}

}  // namespace

// q, k, v, dout, dk, dv: [b, s, h, d] f32 (dtype 0; bf16 goes to
// ptt_flash_attention_bwd_tc); lse and delta: [b, h, s] f32; dq_part: [ceil(s / 64), b, s,
// h, d] f32, every element written. d must be 64 or 128. mask, causal and
// dropout (seed, thresh, inv_keep) as the forward's.
extern "C" int ptt_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dq_part, void* dk, void* dv, const void* mask,
                                       long long msb, long long msh, long long msq,
                                       long long msk, int b, int s, int h, int d, int s_true,
                                       int causal, float scale, int dtype, int dropout,
                                       unsigned seed, unsigned thresh, float inv_keep,
                                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const ptt::Dropout drop{dropout, seed, thresh, inv_keep};
  const ptt::AddMask m{static_cast<const float*>(mask), msb, msh, msq, msk};
  if (b * h > 65535) return (int)cudaErrorInvalidValue;  // grid.y
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  float* dqp = static_cast<float*>(dq_part);
  if (dtype == 0 && d == 128)
    err = launch<float, 128>(q, k, v, dout, l, dl, dqp, dk, dv, b, s, h, s_true, causal, scale,
                             drop, m, st);
  else if (dtype == 0 && d == 64)
    err = launch<float, 64>(q, k, v, dout, l, dl, dqp, dk, dv, b, s, h, s_true, causal, scale,
                            drop, m, st);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
