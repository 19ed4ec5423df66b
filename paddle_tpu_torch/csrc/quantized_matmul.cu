// int8 weight-only matmul: out[m, n] = (sum_k x[m, k] * w[k, n]) * scale[n].
//
// Replaces: paddle_tpu/ops/pallas/quantized_matmul.py `_qmm_kernel`
// (called from `quantized_matmul`), the TPU kernel that streams int8
// weight tiles through VMEM with an f32 accumulator over k tiles and
// applies the per-channel scale once at emission.
//
// What bounds it on the H100: at decode m is the batch (1-8), so the
// product is a GEMV and the time is the int8 weight bytes over 3.35 TB/s
// (about 2 flops per weight byte, far below the ~295 the tensor cores
// need). At prefill (m = b * t_pad, hundreds to thousands of rows) it is
// a GEMM bounded by the tensor cores' bf16 rate.
//
// Routes (`quantized_matmul.qmm_route`, by dtype and shape): "gemv" here
// (m <= 8, and any m for f32 x, in chunks of 8 rows), "tc" in
// quantized_matmul_tc.cu (bf16 x, m > 8, n % 16 == 0, k % 8 == 0), and
// "tiled" here (bf16 x, m > 8, the other shapes).
//  - GEMV: the routine `ptt::gemv_slab` (common.cuh), which the decode
//    megakernel runs too: 32 output columns a slab, 256 threads, each
//    keeping f32 chains over every 128th k row for its 16 columns and all
//    M rows, reduced by shuffles and across warps in warp order; the
//    scale multiplies once, when the output is written. Two builds with
//    the same sums, so the same bits:
//    * ring (the wrapper's `gemv_build` picks it for slabs of k >= 8192
//      rows, where its pipeline beats the direct build; it needs n % 16
//      == 0, the weight's rows whole 16-byte pieces): a persistent grid (SMs x blocks an SM), each block taking slabs b,
//      b + G, ... Every weight tile (kRingRows k rows x one slab) reaches
//      shared memory by a 2-D TMA tensor copy into a `ptt::SlabRing` of
//      kRingStages stages; the block's tile stream is a function of the
//      tile's index, and at tile t lane 0 of warp t % 8 issues tile t +
//      stages - 2, so a copy's issue stall lands on one warp in eight
//      (the megakernel's weight stream). x comes through L1.
//    * direct (the other shapes): one block a slab, rows read from device memory
//      by 16-byte loads where they are aligned, four rows in flight.
//  - Tiled (bf16 x, m > 8, shapes the tensor-core GEMM does not take):
//    64x64 output tiles, k in steps of 32, four warps with WMMA 16x16x16
//    bf16 tensor-core products and f32 accumulators. int8 converts to bf16
//    exactly while the tile is staged in shared memory; the scale is
//    applied in the epilogue.
//  - Ragged edges (k = 11008 and n = 32000 are not multiples of 512):
//    loads past k or n read zeros (the TMA fills them) and stores past m or
//    n are skipped; no padded copies are made.
#include "common.cuh"
#include "quantized_matmul.cuh"

#include <mma.h>

namespace {

using ptt::from_f32;
using ptt::kSlabThreads;
using ptt::to_f32;

template <typename T, int M>
__global__ void __launch_bounds__(kSlabThreads)
qmm_gemv_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ scales, T* __restrict__ out,
                int m, int k, int n, bool vec) {
  __shared__ float red[kSlabThreads / 32 * M * ptt::kSlabCols];
  const int row0 = blockIdx.y * M;
  const int mrows = min(M, m - row0);
  const T* xr = x + (size_t)row0 * k;
  ptt::gemv_slab<int8_t, M>(
      [&](int i, int r) { return to_f32(xr[(size_t)i * k + r]); }, w, mrows, k, n,
      blockIdx.x, vec, red, [&](int i, int col, float s) {
        out[(size_t)(row0 + i) * n + col] = from_f32<T>(s * scales[col]);
      });
}

// ---------------------------------------------------------------- GEMV ring
using ptt::qmm::kRingRows;
using ptt::qmm::kRingStages;
using Ring = ptt::SlabRing<int8_t>;

// shared memory of a block: the slab's reductions, 128 bytes of alignment
// slack, then the ring's tiles and barriers
template <int M>
size_t ring_smem() {
  return (size_t)kSlabThreads / 32 * M * ptt::kSlabCols * sizeof(float) + 128 +
         Ring::bytes(kRingStages, kRingRows);
}

// Job j of the grid is (row chunk j / n_slabs, slab j % n_slabs); block b
// takes jobs b, b + G, ... Its tile t is k rows (t % tiles) * kRingRows of
// its job t / tiles, a function of t alone, so any warp can issue any tile.
template <typename T, int M>
__global__ void __launch_bounds__(kSlabThreads)
qmm_ring_kernel(const __grid_constant__ CUtensorMap wmap, const T* __restrict__ x,
                const float* __restrict__ scales, T* __restrict__ out, int m, int k, int n) {
  extern __shared__ unsigned char smem[];
  constexpr int kWarps = kSlabThreads / 32;
  float* red = reinterpret_cast<float*>(smem);
  Ring ring;
  {
    char* base = reinterpret_cast<char*>(smem) + (size_t)kWarps * M * ptt::kSlabCols * 4;
    base += (128 - ptt::smem_u32(base) % 128) % 128;
    ring.buf = reinterpret_cast<const int8_t*>(base);
    ring.bar = reinterpret_cast<uint64_t*>(base + kRingStages * Ring::tile_bytes(kRingRows));
    ring.stages = kRingStages;
    ring.rows = kRingRows;
    ring.used = 0;
  }
  ring.init();
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int G = gridDim.x, b = blockIdx.x;
  const int n_slabs = (n + ptt::kSlabCols - 1) / ptt::kSlabCols;
  const int jobs = n_slabs * ((m + M - 1) / M);
  const int my_jobs = jobs > b ? (jobs - b + G - 1) / G : 0;
  const int tiles = (k + kRingRows - 1) / kRingRows;
  const int total = my_jobs * tiles;
  auto issue = [&](int t) {
    if (t < total) {
      const int j = t / tiles;
      ring.issue(t, &wmap, (b + j * G) % n_slabs * ptt::kSlabCols, (t - j * tiles) * kRingRows);
    }
  };
  if (lane == 0)  // the first tiles, spread over the warps as the rest
    for (int t = warp; t < kRingStages - 2; t += kWarps) issue(t);
  // A step takes two tiles of the job (one when a single tile is left):
  // this thread's four rows of them (kr + 128 q past the step's first row)
  // are loaded together, then summed into its chains in row order, so a
  // chain's rows are `gemv_slab`'s, in its order. Rows past k (zeros from
  // the TMA) are never summed: a step whose rows all lie below k runs
  // without a test; the last step of a job tests each row.
  const int kr = Ring::chain_kr();
  const uint32_t at = (uint32_t)((kr * ptt::kSlabCols + Ring::chain_ct() * Ring::kCols));
  for (int j = 0; j < my_jobs; ++j) {
    const int job = b + j * G;
    const int slab = job % n_slabs, row0 = job / n_slabs * M;
    const int mrows = min(M, m - row0);
    // x rows of the chains: rows past mrows read the last real row (their
    // sums are never emitted)
    const T* xp[M];
#pragma unroll
    for (int i = 0; i < M; ++i) xp[i] = x + (size_t)(row0 + min(i, mrows - 1)) * k + kr;
    float acc[M][Ring::kCols];
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int c = 0; c < Ring::kCols; ++c) acc[i][c] = 0.f;
    // one step: `tested` (the last step of a job) skips rows past k
    auto step = [&](int r0, const uint32_t (&tile)[2], auto tested_t) {
      constexpr bool tested = decltype(tested_t)::value;
      Ring::SW::Pack p[4];
      float xv[4][M];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool in = !tested || r0 + kr + q * Ring::kKRows < k;
        asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(p[q].v.x), "=r"(p[q].v.y), "=r"(p[q].v.z), "=r"(p[q].v.w)
                     : "r"(tile[q / 2] + at +
                           (uint32_t)((q % 2) * Ring::kKRows * ptt::kSlabCols)));
#pragma unroll
        for (int i = 0; i < M; ++i) xv[q][i] = in ? to_f32(xp[i][r0 + q * Ring::kKRows]) : 0.f;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (!tested || r0 + kr + q * Ring::kKRows < k) {
          float w[Ring::kCols];
          Ring::SW::unpack(p[q], w);
#pragma unroll
          for (int i = 0; i < M; ++i)
#pragma unroll
            for (int c = 0; c < Ring::kCols; ++c) acc[i][c] = fmaf(xv[q][i], w[c], acc[i][c]);
        }
      }
    };
    for (int r0 = 0; r0 < k; r0 += 2 * kRingRows) {
      const int nt = k - r0 > kRingRows ? 2 : 1;
      for (int u = 0; u < nt; ++u)
        if (lane == 0 && warp == (ring.used + u) % kWarps) issue(ring.used + u + kRingStages - 2);
      const uint32_t tile[2] = {ring.wait_tile(ring.used),
                                ring.wait_tile(ring.used + nt - 1)};
      if (r0 + 2 * kRingRows <= k)
        step(r0, tile, std::false_type());
      else
        step(r0, tile, std::true_type());
      for (int u = 0; u < nt; ++u) ring.release();
    }
    ptt::slab_reduce<int8_t, M>(acc, mrows, n, slab, red, [&](int i, int col, float s) {
      out[(size_t)(row0 + i) * n + col] = from_f32<T>(s * scales[col]);
    });
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
      ptt::SlabW<int8_t>::Pack p;
      if (gr < k) {
        p = ptt::load_w<int8_t>(w, gr, gc, n, wvec);
      } else {
        p.v = make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int j = 0; j < 16; ++j)
        Bs[r][cc + j] = __float2bfloat16(static_cast<float>(p.e[j]));
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
cudaError_t launch_gemv(const void* x, const int8_t* w, const float* scales, void* out, int m,
                        int k, int n, cudaStream_t s) {
  const bool vec = ptt::slab_vec_ok<int8_t>(w, n);
  dim3 grid((n + ptt::kSlabCols - 1) / ptt::kSlabCols, (m + M - 1) / M);
  qmm_gemv_kernel<T, M><<<grid, kSlabThreads, 0, s>>>(
      static_cast<const T*>(x), w, scales, static_cast<T*>(out), m, k, n, vec);
  return cudaSuccess;
}

// The ring build: as many blocks as the SMs hold at once (the occupancy
// of this instantiation, asked once a device), at most one a job.
template <typename T, int M>
cudaError_t launch_ring(const CUtensorMap& map, const void* x, const float* scales, void* out,
                        int m, int k, int n, int device, cudaStream_t s) {
  constexpr int kDevices = ptt::SmemOptIn::kDevices;
  static ptt::SmemOptIn opt;
  static int resident[kDevices] = {};
  if (device < 0 || device >= kDevices) return cudaErrorInvalidDevice;
  const size_t smem = ring_smem<M>();
  cudaError_t err = opt.allow(qmm_ring_kernel<T, M>, smem, device);
  if (err != cudaSuccess) return err;
  if (resident[device] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, qmm_ring_kernel<T, M>,
                                                        kSlabThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident[device] = sms * per_sm;
  }
  const long long jobs =
      (long long)((n + ptt::kSlabCols - 1) / ptt::kSlabCols) * ((m + M - 1) / M);
  const int grid = (int)(jobs < resident[device] ? jobs : resident[device]);
  qmm_ring_kernel<T, M><<<grid, kSlabThreads, smem, s>>>(
      map, static_cast<const T*>(x), scales, static_cast<T*>(out), m, k, n);
  return cudaSuccess;
}

// M: the rows a block keeps sums for (m rounded up to 1, 2, 4 or 8; wider
// m in chunks of 8)
template <typename T, int M>
cudaError_t launch_gemv_as(const CUtensorMap* map, const void* x, const int8_t* w,
                           const float* scales, void* out, int m, int k, int n, int device,
                           cudaStream_t s) {
  return map != nullptr ? launch_ring<T, M>(*map, x, scales, out, m, k, n, device, s)
                        : launch_gemv<T, M>(x, w, scales, out, m, k, n, s);
}

template <typename T>
cudaError_t launch_gemv_any(const CUtensorMap* map, const void* x, const int8_t* w,
                            const float* scales, void* out, int m, int k, int n, int device,
                            cudaStream_t s) {
  if (m <= 1) return launch_gemv_as<T, 1>(map, x, w, scales, out, m, k, n, device, s);
  if (m <= 2) return launch_gemv_as<T, 2>(map, x, w, scales, out, m, k, n, device, s);
  if (m <= 4) return launch_gemv_as<T, 4>(map, x, w, scales, out, m, k, n, device, s);
  return launch_gemv_as<T, 8>(map, x, w, scales, out, m, k, n, device, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and out share it). route 0: the GEMV
// (any m, in chunks of 8 rows), from the ring when wmap is given (the
// weight's ring map, 128 bytes from ptt_quantized_matmul_map), rows read in
// place when it is null; route 1: the tiled WMMA GEMM (bf16 x only, no map).
extern "C" int ptt_quantized_matmul(const void* x, const void* w, const void* scales,
                                    void* out, int m, int k, int n, int dtype, int route,
                                    const void* wmap, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((dtype != 0 && dtype != 1) || route < 0 || route > 1 ||
      (route == 1 && (dtype != 1 || wmap != nullptr)))
    return (int)cudaErrorInvalidValue;
  if (m == 0 || n == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(scales);
  CUtensorMap map;
  if (wmap != nullptr) memcpy(&map, wmap, sizeof(map));
  const CUtensorMap* mp = wmap != nullptr ? &map : nullptr;
  if (route == 1) {
    const bool xvec = (k % 8 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
    const bool wvec = (n % 16 == 0) && (reinterpret_cast<uintptr_t>(w) % 16 == 0);
    dim3 grid((n + kTBN - 1) / kTBN, (m + kTBM - 1) / kTBM);
    qmm_tiled_bf16_kernel<<<grid, kTiledThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), wq, sc,
        static_cast<__nv_bfloat16*>(out), m, k, n, xvec, wvec);
  } else if (dtype == 1) {
    err = launch_gemv_any<__nv_bfloat16>(mp, x, wq, sc, out, m, k, n, device, s);
  } else {
    err = launch_gemv_any<float>(mp, x, wq, sc, out, m, k, n, device, s);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The tensor map of an int8 [k, n] weight for route 0 (the GEMV ring) or 1
// (the tensor-core GEMM of quantized_matmul_tc.cu), 128 bytes into out
// (host memory). The caller keeps it per (weight address, k, n).
extern "C" int ptt_quantized_matmul_map(const void* w, int k, int n, int route, void* out) {
  return ptt::qmm::weight_map(static_cast<CUtensorMap*>(out), w, k, n, route)
             ? 0
             : (int)cudaErrorInvalidValue;
}
