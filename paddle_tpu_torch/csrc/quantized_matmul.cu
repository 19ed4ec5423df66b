// int8 weight-only matmul: out[m, n] = (sum_k x[m, k] * w[k, n]) * scale[n].
//
// Replaces: paddle_tpu/ops/pallas/quantized_matmul.py `_qmm_kernel`
// (called from `quantized_matmul`), the TPU kernel that streams int8
// weight tiles through VMEM with an f32 accumulator over k tiles and
// applies the per-channel scale once at emission.
//
// What bounds it on the H100: at decode m is the batch (1-4), so the
// product is a GEMV and the time is the int8 weight bytes over 3.35 TB/s
// (about 2 flops per weight byte, far below the ~295 the tensor cores
// need). At prefill (m = b * t_pad, hundreds to thousands of rows) it is
// a GEMM bounded by the tensor cores' bf16 rate.
//
// Design:
//  - GEMV path (m <= 8, and any m for f32 x, in chunks of 8 rows): each
//    block owns a slab of 32 output columns and walks all of k. Two
//    threads cover the slab's width with one 16-byte int8 load each, so
//    a k row of the slab is one 32-byte sector read whole; 128 such
//    thread pairs take 128 k rows at a time, four rows of loads in
//    flight per thread. Every thread keeps f32 sums for its 16 columns
//    and all m rows (x is tiny and read through L1). The k partial sums
//    are reduced by warp shuffles and once across warps in shared
//    memory; the scale multiplies once, when the output is written.
//  - Tiled path (bf16 x, m > 8): 64x64 output tiles, k in steps of 32,
//    four warps with WMMA 16x16x16 bf16 tensor-core products and f32
//    accumulators. int8 converts to bf16 exactly while the tile is
//    staged in shared memory; the scale is applied in the epilogue.
//  - Ragged edges (k = 11008 and n = 32000 are not multiples of 512):
//    loads past k or n read zeros and stores past m or n are skipped; no
//    padded copies are made.
#include "common.cuh"

#include <mma.h>

namespace {

using ptt::from_f32;
using ptt::to_f32;

constexpr int kGemvThreads = 256;
constexpr int kColsPerThread = 16;                       // one int4 of int8
constexpr int kColThreads = 2;                           // threads across n
constexpr int kGemvBN = kColsPerThread * kColThreads;    // 32 columns
constexpr int kKRows = kGemvThreads / kColThreads;       // 128 k rows / pass
constexpr int kUnroll = 4;

union Pack16 {
  int4 v;
  int8_t b[16];
};

__device__ __forceinline__ Pack16 load_w(const int8_t* w, int row, int col,
                                         int n, bool vec) {
  Pack16 p;
  const int8_t* src = w + (size_t)row * n + col;
  if (vec && col + 16 <= n) {
    p.v = __ldg(reinterpret_cast<const int4*>(src));
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) p.b[j] = (col + j < n) ? src[j] : int8_t(0);
  }
  return p;
}

template <typename T, int M>
__global__ void __launch_bounds__(kGemvThreads)
qmm_gemv_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ scales, T* __restrict__ out,
                int m, int k, int n, bool vec) {
  __shared__ float red[kGemvThreads / 32][M][kGemvBN];
  const int tid = threadIdx.x;
  const int ct = tid % kColThreads;
  const int kr = tid / kColThreads;
  const int col0 = blockIdx.x * kGemvBN + ct * kColsPerThread;
  const int row0 = blockIdx.y * M;
  const int mrows = min(M, m - row0);
  const T* xr = x + (size_t)row0 * k;

  float acc[M][kColsPerThread];
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[i][j] = 0.f;

  auto fma_row = [&](const Pack16& p, int row) {
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const float xv = (i < mrows) ? to_f32(xr[(size_t)i * k + row]) : 0.f;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j)
        acc[i][j] = fmaf(xv, static_cast<float>(p.b[j]), acc[i][j]);
    }
  };

  int row = kr;
  for (; row + (kUnroll - 1) * kKRows < k; row += kUnroll * kKRows) {
    Pack16 p[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) p[u] = load_w(w, row + u * kKRows, col0, n, vec);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) fma_row(p[u], row + u * kKRows);
  }
  for (; row < k; row += kKRows) fma_row(load_w(w, row, col0, n, vec), row);

  // lanes with the same column half share a slab: sum them across the warp
  const int lane = tid % 32, warp = tid / 32;
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      float v = acc[i][j];
      for (int o = kColThreads; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      acc[i][j] = v;
    }
  if (lane < kColThreads) {
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j)
        red[warp][i][lane * kColsPerThread + j] = acc[i][j];
  }
  __syncthreads();
  for (int e = tid; e < M * kGemvBN; e += kGemvThreads) {
    const int i = e / kGemvBN, c = e % kGemvBN;
    const int col = blockIdx.x * kGemvBN + c;
    if (i < mrows && col < n) {
      float s = 0.f;
#pragma unroll
      for (int wv = 0; wv < kGemvThreads / 32; ++wv) s += red[wv][i][c];
      out[(size_t)(row0 + i) * n + col] = from_f32<T>(s * scales[col]);
    }
  }
}

// ---------------------------------------------------------------- tiled
constexpr int kTBM = 64, kTBN = 64, kTBK = 32;
constexpr int kTiledThreads = 128;
constexpr int kAPad = 8, kBPad = 8, kCPad = 4;

__global__ void __launch_bounds__(kTiledThreads)
qmm_tiled_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                      const int8_t* __restrict__ w,
                      const float* __restrict__ scales,
                      __nv_bfloat16* __restrict__ out, int m, int k, int n,
                      bool xvec, bool wvec) {
  using namespace nvcuda;
  __shared__ __align__(32) __nv_bfloat16 As[kTBM][kTBK + kAPad];
  __shared__ __align__(32) __nv_bfloat16 Bs[kTBK][kTBN + kBPad];
  __shared__ __align__(32) float Cs[kTBM][kTBN + kCPad];

  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;  // 2x2 warps, 32x32 each
  const int m0 = blockIdx.y * kTBM, n0 = blockIdx.x * kTBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0.f);

  for (int k0 = 0; k0 < k; k0 += kTBK) {
    // x tile [64 x 32] bf16: 256 chunks of 8 values, two per thread
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int chunk = tid + u * kTiledThreads;
      const int r = chunk / (kTBK / 8), cc = (chunk % (kTBK / 8)) * 8;
      const int gr = m0 + r, gc = k0 + cc;
      __nv_bfloat16* dst = &As[r][cc];
      if (xvec && gr < m && gc + 8 <= k) {
        *reinterpret_cast<int4*>(dst) =
            *reinterpret_cast<const int4*>(x + (size_t)gr * k + gc);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          dst[j] = (gr < m && gc + j < k) ? x[(size_t)gr * k + gc + j]
                                          : __float2bfloat16(0.f);
      }
    }
    // w tile [32 x 64] int8 -> bf16 (exact): one 16-byte chunk per thread
    {
      const int r = tid / (kTBN / 16), cc = (tid % (kTBN / 16)) * 16;
      const int gr = k0 + r, gc = n0 + cc;
      Pack16 p;
      if (gr < k) {
        p = load_w(w, gr, gc, n, wvec);
      } else {
        p.v = make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int j = 0; j < 16; ++j)
        Bs[r][cc + j] = __float2bfloat16(static_cast<float>(p.b[j]));
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[wm * 32 + i * 16][kk], kTBK + kAPad);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Bs[kk][wn * 32 + j * 16], kTBN + kBPad);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(c[i][j], a[i], b[j], c[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wm * 32 + i * 16][wn * 32 + j * 16], c[i][j],
                              kTBN + kCPad, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < kTBM * kTBN; e += kTiledThreads) {
    const int r = e / kTBN, cc = e % kTBN;
    const int gr = m0 + r, gc = n0 + cc;
    if (gr < m && gc < n)
      out[(size_t)gr * n + gc] = __float2bfloat16(Cs[r][cc] * scales[gc]);
  }
}

template <typename T, int M>
void launch_gemv(const void* x, const int8_t* w, const float* scales, void* out,
                 int m, int k, int n, cudaStream_t s) {
  const bool vec = (n % 16 == 0) && (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  dim3 grid((n + kGemvBN - 1) / kGemvBN, (m + M - 1) / M);
  qmm_gemv_kernel<T, M><<<grid, kGemvThreads, 0, s>>>(
      static_cast<const T*>(x), w, scales, static_cast<T*>(out), m, k, n, vec);
}

template <typename T>
void launch_gemv_any(const void* x, const int8_t* w, const float* scales,
                     void* out, int m, int k, int n, cudaStream_t s) {
  if (m <= 1) launch_gemv<T, 1>(x, w, scales, out, m, k, n, s);
  else if (m <= 2) launch_gemv<T, 2>(x, w, scales, out, m, k, n, s);
  else if (m <= 4) launch_gemv<T, 4>(x, w, scales, out, m, k, n, s);
  else launch_gemv<T, 8>(x, w, scales, out, m, k, n, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and out share it).
extern "C" int ptt_quantized_matmul(const void* x, const void* w, const void* scales,
                                    void* out, int m, int k, int n, int dtype,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(scales);
  if (dtype == 1 && m > 8) {
    const bool xvec = (k % 8 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
    const bool wvec = (n % 16 == 0) && (reinterpret_cast<uintptr_t>(w) % 16 == 0);
    dim3 grid((n + kTBN - 1) / kTBN, (m + kTBM - 1) / kTBM);
    qmm_tiled_bf16_kernel<<<grid, kTiledThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), wq, sc,
        static_cast<__nv_bfloat16*>(out), m, k, n, xvec, wvec);
  } else if (dtype == 1) {
    launch_gemv_any<__nv_bfloat16>(x, wq, sc, out, m, k, n, s);
  } else if (dtype == 0) {
    launch_gemv_any<float>(x, wq, sc, out, m, k, n, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
