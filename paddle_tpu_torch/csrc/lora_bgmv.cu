// The batched LoRA delta of multi-adapter serving: for every row m of a
// product's input x [M, in] with adapter slot aid = aid[m / t] (t rows per
// request slot; aid 0 = no adapter),
//
//   xa[m, :] = scale[m / t] * sum_i x[m, i] * A[aid][i, :]          (shrink)
//   out[m, o] = aid > 0 ? y[m, o] + (T) sum_j xa[m, j] * B[aid][j, o]
//                       : y[m, o]                                    (expand)
//
// in f32, rounded once to y's type T before the add, as the reference's
// `y + delta.astype(y.dtype)` rounds (`paddle_tpu/inference/adapters.py`
// `lora_delta` / `lora_apply`). A row with aid 0 keeps y's bits exactly.
//
// Replaces: no pl.pallas_call. The reference computes the delta as two
// jnp.einsum calls on gathered factors. On the card the same einsums would
// go to cuBLAS batched GEMMs whose kernel (split-K included) is picked by
// the row count per request (1 in a decode step, T in a verify pass), so a
// row's delta could change its bits between the two, breaking the
// reference's promises that a mixed batch equals per-adapter dedicated
// engines and that speculative decode equals plain decode with adapters on;
// and they would gather a [rows, in, r] copy of every factor on every step.
// Here each row is summed in one fixed order that depends only on its own
// x row, its adapter and the factors: not on M, the row's position, or t.
//
// Design (simple and right first; speed is later work): the shrink runs
// one block of 256 threads per row. Thread k sums i = k, k + 256, ... in
// ascending order into r accumulators (A's row i is r contiguous floats, so
// a warp reads 32 consecutive rows), then each warp reduces every
// accumulator by a fixed xor-shuffle tree and thread j adds the 8 warps'
// partials in warp order. The expand runs one thread per (row, output
// column): one fmaf chain over j in ascending order, B's row j read
// coalesced across the columns. The factors are read in place from the
// pool's stacks (L2 serves the re-reads of one adapter's factors by its
// rows); a pool rank of at most kMaxRank.
//
// What bounds it on the H100: bytes. x, y and out once per row plus each
// distinct adapter's A and B once (f32); about 2 (in + out) r flops per row.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRank = 64;

template <int RB, typename T>
__global__ void __launch_bounds__(kThreads)
lora_shrink_kernel(const T* __restrict__ x, const float* __restrict__ a,
                   const int* __restrict__ aid, const float* __restrict__ scale,
                   float* __restrict__ xa, int t, int in, int r) {
  const int m = blockIdx.x;
  const int slot = aid[m / t];
  float* xr = xa + (size_t)m * r;
  if (slot <= 0) {
    for (int j = threadIdx.x; j < r; j += kThreads) xr[j] = 0.f;
    return;
  }
  const T* xm = x + (size_t)m * in;
  const float* am = a + (size_t)slot * in * r;
  float acc[RB];
#pragma unroll
  for (int j = 0; j < RB; ++j) acc[j] = 0.f;
  for (int i = threadIdx.x; i < in; i += kThreads) {
    const float xv = ptt::to_f32(xm[i]);
    const float* ar = am + (size_t)i * r;
#pragma unroll
    for (int j = 0; j < RB; ++j)
      if (j < r) acc[j] = fmaf(xv, ar[j], acc[j]);
  }
  __shared__ float part[kWarps][RB];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int j = 0; j < RB; ++j) {
    const float s = ptt::warp_sum(acc[j]);
    if (lane == 0) part[warp][j] = s;
  }
  __syncthreads();
  if (threadIdx.x < r) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += part[w][threadIdx.x];
    xr[threadIdx.x] = s * scale[m / t];
  }
}

// y == nullptr: out is the f32 delta itself (0 on aid-0 rows).
template <typename T>
__global__ void __launch_bounds__(kThreads)
lora_expand_kernel(const float* __restrict__ xa, const float* __restrict__ b,
                   const int* __restrict__ aid, const T* __restrict__ y,
                   void* __restrict__ out, int t, int r, int n) {
  const int m = blockIdx.y;
  const int o = blockIdx.x * kThreads + threadIdx.x;
  if (o >= n) return;
  const int slot = aid[m / t];
  const size_t at = (size_t)m * n + o;
  if (slot <= 0) {
    if (y != nullptr)
      static_cast<T*>(out)[at] = y[at];
    else
      static_cast<float*>(out)[at] = 0.f;
    return;
  }
  const float* xr = xa + (size_t)m * r;
  const float* bs = b + (size_t)slot * r * n + o;
  float d = 0.f;
  for (int j = 0; j < r; ++j) d = fmaf(xr[j], bs[(size_t)j * n], d);
  if (y == nullptr) {
    static_cast<float*>(out)[at] = d;
  } else {
    // y + (T) d, added in f32 and rounded once to T (torch's bf16 add)
    const float sum = ptt::to_f32(y[at]) + ptt::to_f32(ptt::from_f32<T>(d));
    static_cast<T*>(out)[at] = ptt::from_f32<T>(sum);
  }
}

template <typename T>
cudaError_t shrink(const void* x, const float* a, const int* aid, const float* scale,
                   float* xa, int m, int t, int in, int r, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  if (r <= 8)
    lora_shrink_kernel<8, T><<<m, kThreads, 0, st>>>(xp, a, aid, scale, xa, t, in, r);
  else if (r <= 16)
    lora_shrink_kernel<16, T><<<m, kThreads, 0, st>>>(xp, a, aid, scale, xa, t, in, r);
  else if (r <= 32)
    lora_shrink_kernel<32, T><<<m, kThreads, 0, st>>>(xp, a, aid, scale, xa, t, in, r);
  else
    lora_shrink_kernel<64, T><<<m, kThreads, 0, st>>>(xp, a, aid, scale, xa, t, in, r);
  return cudaSuccess;
}

}  // namespace

// x: [m, in] of dtype (0 = float32, 1 = bfloat16); a: [slots, in, r] f32;
// aid: [m / t] int32 adapter slots; scale: [m / t] f32; xa: [m, r] f32 out.
extern "C" int ptt_lora_shrink(const void* x, const void* a, const void* aid,
                               const void* scale, void* xa, int m, int t, int in, int r,
                               int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (m < 0 || t <= 0 || m % t != 0 || in <= 0 || r <= 0 || r > kMaxRank)
    return (int)cudaErrorInvalidValue;
  if (m == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ap = static_cast<const float*>(a);
  const int* ip = static_cast<const int*>(aid);
  const float* sp = static_cast<const float*>(scale);
  float* op = static_cast<float*>(xa);
  if (dtype == 0)
    err = shrink<float>(x, ap, ip, sp, op, m, t, in, r, st);
  else if (dtype == 1)
    err = shrink<__nv_bfloat16>(x, ap, ip, sp, op, m, t, in, r, st);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// xa: [m, r] f32; b: [slots, r, n] f32; aid: [m / t] int32; y: [m, n] of
// dtype, or null; out: [m, n] of dtype (y given) or f32 (the delta alone).
extern "C" int ptt_lora_expand(const void* xa, const void* b, const void* aid,
                               const void* y, void* out, int m, int t, int r, int n,
                               int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (m < 0 || t <= 0 || m % t != 0 || n <= 0 || r <= 0 || r > kMaxRank || m > 65535)
    return (int)cudaErrorInvalidValue;
  if (m == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kThreads - 1) / kThreads, m);
  const float* xp = static_cast<const float*>(xa);
  const float* bp = static_cast<const float*>(b);
  const int* ip = static_cast<const int*>(aid);
  if (dtype == 0)
    lora_expand_kernel<float><<<grid, kThreads, 0, st>>>(
        xp, bp, ip, static_cast<const float*>(y), out, t, r, n);
  else if (dtype == 1)
    lora_expand_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        xp, bp, ip, static_cast<const __nv_bfloat16*>(y), out, t, r, n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
