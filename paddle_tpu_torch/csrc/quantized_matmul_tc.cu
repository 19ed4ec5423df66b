// int8 weight-only matmul on Hopper's warpgroup tensor cores (wgmma), bf16
// x [m, k] and out [m, n]: out = (x @ w_int8) * scale, w int8 [k, n]
// row-major, one f32 scale per output column. The route "tc" of
// `quantized_matmul` (`qmm_route`): bf16 x with m > 8, n % 16 == 0 and
// k % 8 == 0 (the rows of both operands whole 16-byte pieces, as a TMA
// tensor map needs): prefill, the speculative verify pass and the fused
// blocks' prefill.
//
// Replaces: paddle_tpu/ops/pallas/quantized_matmul.py `_qmm_kernel`
// (called from `quantized_matmul`) at prefill widths. The TPU kernel takes
// int8 tiles of the weight into VMEM, widens them in-register to the
// compute type for the MXU (`dot_tile_f32`), keeps f32 partial sums over k
// tiles and multiplies the scale once at emission (`scale_emit`).
//
// What bounds it on the H100: at m ~1000 rows it does 2 m flops per weight
// byte read, far past the card's ~295 flops a byte, so the tensor cores'
// bf16 rate (989 TFLOP/s dense) bounds it, and the int8 weight must reach
// them as bf16: the widening runs on the CUDA cores, beside the products.
//
// Design: the product is taken transposed, out^T = W^T x^T, so that the
// weight is the wgmma A operand, which may come from registers: each
// warpgroup widens its own weight fragments in registers, and nothing
// widened goes back to shared memory. One CTA per 128 output columns
// (channels) x 128 rows of x (blockIdx.x the row tile, so the CTAs that run
// together share the weight's column tiles in L2): two consumer
// warpgroups, each owning 64 channels, and one producer warp.
//   - The producer's lane 0 streams, per k step of 64, the x tile (128
//     rows x 64 k, K-major: the wgmma B operand as TMA lands it) and the
//     weight tile (64 k rows x 128 int8 channels) into a ring of kStages
//     stages behind full / empty mbarriers, both in the 128-byte swizzle.
//     Rows past m, k and columns past n arrive as zeros.
//   - A warp's A fragment (16 channels x 16 k) comes from the int8 tile by
//     one `ldmatrix.trans` of 8 x 8 matrices of byte pairs: a pair is two
//     adjacent channels, so thread (g, t) receives k rows 2t, 2t + 1 of
//     channels 2g, 2g + 1, which are A rows g and g + 8 when the warp's
//     rows take its channels in the order 0, 2, ..., 14, 1, 3, ..., 15. The
//     swizzle puts the 8 k rows of a matrix in 8 bank groups. Each byte is
//     widened to bf16 exactly (|q| <= 127 fits bf16's 8-bit significand:
//     the byte-permute widening of `SlabW<int8_t>::unpack` to f32, then a
//     round-to-nearest pack that changes nothing).
//   - out^T += A B by wgmma m64n128k16 (A from registers, B = x from
//     shared memory, K-major), f32 accumulators in registers for the whole
//     k walk. A warpgroup waits for its products inside the k step that
//     issues them (ptxas serializes every wgmma whose group crosses a loop
//     edge or a branch; C7520 in the build log) and then releases the
//     stage; the warpgroups share no barrier, so one widens while the
//     other's products run.
//   - The epilogue multiplies each f32 sum by its channel's scale, rounds
//     to bf16 and stores channel pairs (4 bytes) of each row of out; rows
//     past m and channels past n are not written.
// Measured against a first design that widened the tile into a bf16 B
// operand in shared memory (both operands of wgmma from shared memory, a
// named barrier a k step): that one took 0.33 ms at 1280 x 4096 x 11008,
// bound by the shared-memory traffic of the widened tile (written once,
// read by both warpgroups) beside the copies; this one 0.23 ms.
// k runs in order inside the CTA and there is no split over k, so a row's
// bits depend on that row of x, on w and on the scales, never on m or on
// the row's neighbours (the tile shape is fixed).
//
// The tensor maps: the weight's is encoded once per (address, k, n) by
// ptt_quantized_matmul_map and kept by the caller; x's is encoded per
// launch through cudaGetDriverEntryPoint (no -lcuda).
#include <cuda.h>

#include "common.cuh"
#include "mma.cuh"
#include "quantized_matmul.cuh"
#include "wgmma.cuh"

namespace {

using ptt::mma::pack_bf16;
using ptt::mma::smem_addr;
using namespace ptt::wg;
using bf16 = __nv_bfloat16;
using ptt::qmm::kTcBK;
using ptt::qmm::kTcBM;
using ptt::qmm::kTcBN;

constexpr int kConsumerWarps = 8;                     // two warpgroups
constexpr int kThreads = 32 * kConsumerWarps + 32;    // + the producer warp
constexpr int kStages = 8;
constexpr uint32_t kXTile = kTcBM * kTcBK * 2;        // [128 rows][64 k] bf16, 16 KB
constexpr uint32_t kWTile = kTcBK * kTcBN;            // [64 k][128 channels] int8, 8 KB
constexpr uint32_t kOffX = 0;
constexpr uint32_t kOffW = kOffX + kStages * kXTile;
constexpr uint32_t kOffBar = kOffW + kStages * kWTile;
// + the barriers, + slack to align the base to 1024 bytes (the swizzle
// pattern's period; TMA and the descriptors assume it)
constexpr uint32_t kSmem = kOffBar + 8 * 2 * kStages + 1024;
static_assert(kTcBK == 64 && kTcBM == 128 && kTcBN == 128, "the layout below");
static_assert(kSmem <= 227 * 1024, "one CTA's shared memory");

// d += A B, m64n128k16: A [64 x 16] from registers (per warp the mma A
// fragment of its 16 rows), B [16 x 128] K-major from shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 4 int8 bytes (b0 b1 b2 b3) of an ldmatrix.trans register: k rows 2t and
// 2t + 1 (b0 b1, b2 b3) of channels 2g and 2g + 1. Widened exactly, as
// A's two bf16 pairs: lo = channel 2g (b0, b2), hi = channel 2g + 1 (b1, b3)
__device__ __forceinline__ void widen4(uint32_t v, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = v ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int b = 0; b < 4; ++b)
    f[b] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + b)), 8388736.f);
  lo = pack_bf16(f[0], f[2]);
  hi = pack_bf16(f[1], f[3]);
}

__global__ void __launch_bounds__(kThreads, 1)
qmm_tc_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
              const float* __restrict__ scales, bf16* __restrict__ out, int m, int k, int n) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t x_s = base + kOffX, w_s = base + kOffW;
  auto full = [&](int st) { return base + kOffBar + 8 * st; };
  auto empty = [&](int st) { return base + kOffBar + 8 * (kStages + st); };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.x * kTcBM, n0 = blockIdx.y * kTcBN;
  const int n_kt = (k + kTcBK - 1) / kTcBK;

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // ---- producer: lane 0 issues every copy
    if (lane == 0) {
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % kStages;
        if (kt >= kStages) mbar_wait(empty(st), ((kt / kStages) & 1) ^ 1);
        mbar_expect_tx(full(st), kXTile + kWTile);
        tma_load_2d(x_s + st * kXTile, &tm_x, kt * kTcBK, m0, full(st));
        tma_load_2d(w_s + st * kWTile, &tm_w, n0, kt * kTcBK, full(st));
      }
    }
    return;
  }

  // ---- consumers: warp wi of warpgroup wg owns channels n0 + 64 wg + 16
  // wi .. + 15: the 16-byte chunk ch of the weight tile's rows
  const int wg = warp / 4, wi = warp % 4, g = lane / 4, t = lane % 4;
  const int ch = 4 * wg + wi;
  float acc[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) acc[j] = 0.f;
  // this thread's row address of ldmatrix.x4: matrix j = lane / 8 (k rows
  // 0-7 and 8-15 of one k16 step, then of the next), its row lane % 8
  const int krow = 16 * (lane / 16) + 8 * ((lane / 8) & 1) + lane % 8;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % kStages;
    mbar_wait(full(st), (kt / kStages) & 1);
    const uint32_t wt = w_s + st * kWTile;
    uint32_t a[kTcBK / 16][4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int kr = 32 * half + krow;
      uint32_t r[4];
      asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                   : "r"(wt + kr * 128 + ((ch ^ (kr & 7)) << 4)));
      // r[0], r[1]: k16 step 2 half, rows 0-7 and 8-15; r[2], r[3]: the next step
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        widen4(r[2 * j], a[2 * half + j][0], a[2 * half + j][1]);
        widen4(r[2 * j + 1], a[2 * half + j][2], a[2 * half + j][3]);
      }
    }
    const uint32_t xb = x_s + st * kXTile;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk) wgmma_rs(acc, a[kk], desc_k(xb, kk));
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  }

  // epilogue: acc[4 c + e] is (A row 16 wi + g + 8 (e >> 1), x row 8 c + 2 t
  // + (e & 1)) of the warpgroup's 64 x 128 tile; A row g + 8 h of the warp
  // is channel 2 g + h, so a thread holds channels 2 g and 2 g + 1 of a row
  // (n % 16 == 0: a pair is in or out together)
  const int chn = n0 + 64 * wg + 16 * wi + 2 * g;
  if (chn >= n) return;
  const float s0 = scales[chn], s1 = scales[chn + 1];
#pragma unroll
  for (int c = 0; c < kTcBM / 8; ++c)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = m0 + 8 * c + 2 * t + e;
      if (row < m)
        *reinterpret_cast<uint32_t*>(out + (size_t)row * n + chn) =
            pack_bf16(acc[4 * c + e] * s0, acc[4 * c + 2 + e] * s1);
    }
}

// x [m, k] bf16 as a 2-D map with 64-column x 128-row boxes in the
// 128-byte swizzle, rows past m and columns past k zero-filled
bool x_map(CUtensorMap* map, const void* x, int m, int k) {
  ptt::EncodeTiledFn enc = ptt::encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)m};
  const cuuint64_t strides[1] = {(cuuint64_t)k * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kTcBK, (cuuint32_t)kTcBM};
  const cuuint32_t estr[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), dims, strides, box,
             estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// x [m, k] and out [m, n] bf16, w int8 [k, n], scales f32 [n]; x and w on
// 16 bytes, k % 8 == 0, n % 16 == 0; wmap: the weight's map for route 1
// (128 host bytes from ptt_quantized_matmul_map).
extern "C" int ptt_quantized_matmul_tc(const void* x, const void* w, const void* scales,
                                       void* out, int m, int k, int n, const void* wmap,
                                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (wmap == nullptr || k <= 0 || k % 8 != 0 || n % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      (n + kTcBN - 1) / kTcBN > 65535)
    return (int)cudaErrorInvalidValue;
  if (m == 0 || n == 0) return (int)cudaSuccess;
  CUtensorMap mx, mw;
  memcpy(&mw, wmap, sizeof(mw));
  if (!x_map(&mx, x, m, k)) return (int)cudaErrorInvalidValue;
  static ptt::SmemOptIn opt;
  err = opt.allow(qmm_tc_kernel, kSmem, device);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((m + kTcBM - 1) / kTcBM, (n + kTcBN - 1) / kTcBN);
  qmm_tc_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      mx, mw, static_cast<const float*>(scales), static_cast<bf16*>(out), m, k, n);
  return (int)cudaGetLastError();
}
