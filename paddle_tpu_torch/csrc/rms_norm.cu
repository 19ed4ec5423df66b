// RMSNorm forward in the training cast order: y = x * rsqrt(mean(x^2) + eps)
// * w, computed in f32 and rounded once to the output dtype (the weight
// multiplies in f32 before the cast).
//
// Replaces: paddle_tpu/ops/pallas/rms_norm.py `_rms_fwd_kernel` (called from
// `_rms_fwd` / `make_rms_norm`). On the TPU a grid step normalises a tile of
// 256 rows held in VMEM; here one warp owns one row.
//
// What bounds it on the H100: it reads x and w and writes y, doing ~4 flops
// per element: about 1 flop per byte against the card's ~295, so the bytes
// over 3.35 TB/s bound it.
//
// Design: a block of 128 threads normalises 4 rows, one warp per row. Each
// lane reads 8 consecutive values at a time (16 bytes in bf16, 32 in f32),
// lanes side by side, and sums their squares with fmaf; one xor-shuffle
// tree gives the row's sum. The second pass reads the row again (it is
// still in L1/L2: at most 32 KB) with w and writes y. No shared memory, no
// block barrier. bf16 or f32 x/y and w (w may differ from x), any row
// count, d a multiple of 8, 16-byte-aligned rows.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRowsPerBlock = kThreads / 32;

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 raw;
  __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h2[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
rms_fwd_kernel(const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ y, int n,
               int d, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= n) return;
  const T* xr = x + (size_t)row * d;
  T* yr = y + (size_t)row * d;

  float ss = 0.f;
  for (int c = lane * 8; c < d; c += 32 * 8) {
    float v[8];
    load8(xr + c, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) ss = fmaf(v[i], v[i], ss);
  }
  ss = ptt::warp_sum(ss);
  const float inv = rsqrtf(ss / (float)d + eps);

  for (int c = lane * 8; c < d; c += 32 * 8) {
    float v[8], wv[8], o[8];
    load8(xr + c, v);
    load8(w + c, wv);
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = v[i] * inv * wv[i];
    store8(yr + c, o);
  }
}

template <typename T, typename W>
cudaError_t launch(const void* x, const void* w, void* y, int n, int d, float eps,
                   cudaStream_t st) {
  const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  rms_fwd_kernel<T, W><<<blocks, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<T*>(y), n, d, eps);
  return cudaSuccess;
}

}  // namespace

// x and y: [n, d] of dtype x_dtype; w: [d] of dtype w_dtype (0 = float32,
// 1 = bfloat16). d must be a multiple of 8 and every pointer 16-byte aligned.
extern "C" int ptt_rms_norm_fwd(const void* x, const void* w, void* y, int n, int d,
                                float eps, int x_dtype, int w_dtype, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (d <= 0 || d % 8 != 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 1 && w_dtype == 1)
    err = launch<__nv_bfloat16, __nv_bfloat16>(x, w, y, n, d, eps, st);
  else if (x_dtype == 1 && w_dtype == 0)
    err = launch<__nv_bfloat16, float>(x, w, y, n, d, eps, st);
  else if (x_dtype == 0 && w_dtype == 0)
    err = launch<float, float>(x, w, y, n, d, eps, st);
  else if (x_dtype == 0 && w_dtype == 1)
    err = launch<float, __nv_bfloat16>(x, w, y, n, d, eps, st);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
