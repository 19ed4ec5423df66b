// Flash-attention forward on Hopper's warpgroup tensor cores (wgmma), bf16
// [b, s, h, d], d 64 or 128: o = softmax(q k^T * scale + mask, masked at
// keys >= s_true and, when causal, above the diagonal) v, plus lse =
// logsumexp of each row ([b, h, s] f32, natural log). f32 inputs take
// flash_attention.cu (TF32 would break the f32 parity gates).
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py `_fwd_kernel` (called
// from `_flash_fwd` / `make_flash_attention`) in its bf16 builds: causal or
// not, with or without an additive mask, with or without attention dropout.
// On the TPU the key-block axis is the innermost, sequential grid dimension
// and (m, l, acc) persist in VMEM scratch across it; here it is a loop over
// key tiles inside one CTA, (m, l, acc) in registers.
//
// What bounds it on the H100: causal attention does 4 d flops per visible
// (query, key) pair and moves q, k, v and o once, ~s / 4 flops per byte
// against the card's ~295 (989 TFLOP/s bf16 over 3.35 TB/s): at the
// training shapes (s 1024) it sits near the ridge, so only the tensor cores
// bring it near its bound. Dropout adds the keep hash, ~16 integer
// operations per visible pair on the CUDA cores.
//
// Design: one CTA per (batch x head, 128-query tile; causal tiles heaviest
// first): two consumer warpgroups, each owning 64 query rows, and one
// producer warp.
//   - The producer's lane 0 loads the Q tile once and then streams K and V
//     tiles of 64 keys into a ring of kStages (3) shared-memory stages by
//     TMA (cp.async.bulk.tensor, 3-D maps over [b, s, h d] with 64 x 64
//     boxes and the 128-byte swizzle; rows past s are zero-filled), each
//     stage behind a "full" mbarrier (transaction bytes) and an "empty"
//     mbarrier (one arrival per consumer warp): tiles i + 1 and i + 2 are in
//     flight while tile i computes.
//   - S = Q K^T by wgmma m64n64k16, Q and K read from shared memory through
//     descriptors (K-major, 128-byte swizzle; a k16 step moves the start 32
//     bytes inside the swizzle atom; at d 128 a tile is two 64-column
//     atoms, each with its own descriptor offsets), f32 accumulators. The
//     scale (times log2 e) multiplies the f32 scores.
//   - The online softmax runs in registers on wgmma's accumulator layout,
//     per warp the m16n8 C layout repeated across the 64 keys, in log2
//     units: the row max and sum by quad shuffles, the mask add, the
//     s_true and causal tests (the causal test only in the tiles that
//     cross the diagonal), the keep bits on the global (row, col).
//   - O += P V by wgmma m64nDk16 with P packed to bf16 in registers as the
//     A operand and V from shared memory as a transposed (MN-major) B
//     operand; O stays in f32 registers for the whole walk. P enters as two
//     bf16 terms (hi + lo): rounding P to bf16 once flips bf16 outputs in
//     [2, 4) by an ulp (0.0156, over the 1e-2 gate) in rows that see few
//     keys; the second term costs ~13% (measured with one term).
//   - Software pipelining: each step issues S of tile i and P V of tile
//     i - 1 together and runs the softmax of tile i while that P V does;
//     every wgmma group is waited for inside the step that issues it, and
//     both warpgroups walk the CTA's tiles (a tile past a warpgroup's own
//     diagonal is all masked and leaves its bits as they were), so no
//     wgmma crosses a branch or a loop edge (ptxas serializes them there).
//   - o and lse are written once from registers. No atomics and no split
//     over keys: two launches give the same bits.
// The tile walk: causal without a mask, key tiles up to the diagonal; below
// s_true only; with a mask every key tile, as flash_attention.cu (a row a
// bool mask hides entirely stays uniform over every key, lse about -1e30).
// The kDrop and kMask builds differ from the plain one only by the keep
// multiply and the mask add (plus the mask build's extra tiles, whose
// weights are exact zeros), so p = 0 and a causal launch with a zero mask
// give the causal launch's bits. l, and so lse, sums the weights before
// dropout.
//
// ptxas (sm_90a; the build phase of chip_smoke.py): 128-162 registers at d
// 64, 161-168 at d 128, spills only in the mask builds at d 128 (92-124
// B); HGMMA in every instantiation's SASS, no HMMA.
//
// The tensor maps are encoded per launch on the host with the driver's
// cuTensorMapEncodeTiled, fetched through cudaGetDriverEntryPoint: the
// library is not linked against libcuda.
#include <cuda.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using ptt::kNegInf;
using ptt::mma::kLog2e;
using ptt::mma::smem_addr;
using ptt::mma::split_bf16;
using bf16 = __nv_bfloat16;

constexpr int kWG = 2;                        // consumer warpgroups per CTA
constexpr int kConsumerWarps = 4 * kWG;
constexpr int kThreads = 32 * kConsumerWarps + 32;  // + the producer warp
constexpr int kBQ = 64;                       // query rows per warpgroup
constexpr int kBK = 64;                       // keys per tile
constexpr int kStages = 3;
constexpr int kPTerms = 2;                    // bf16 terms of P in P V
constexpr uint32_t kAtomB = 64 * 128;         // [64 rows][64 bf16], 128-byte swizzle
// scores are kept in log2 units (scaled by log2 e): the reference's masked
// logit NEG_INF, and ln 2 to turn the running max back into natural units
constexpr float kNegInf2 = kNegInf * kLog2e;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Layout {
  static constexpr uint32_t kTileB = (D / 64) * kAtomB;  // one [64][D] tile
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kQ + kWG * kTileB;
  static constexpr uint32_t kV = kK + kStages * kTileB;
  static constexpr uint32_t kBar = kV + kStages * kTileB;
  // + the barriers, + slack to align the base to 1024 bytes (the swizzle
  // pattern's period; TMA and the descriptors assume it)
  static constexpr uint32_t kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

// ---------------------------------------------------------------- mbarrier / TMA
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wait for the completion of the barrier's phase of the given parity; a
// phase that never completes (a copy that never lands) traps after ~2^26
// polls, seconds, rather than hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (polls > (1u << 26)) __trap();
  }
}

// one 64 x 64 box (columns c0.., rows c1.., batch c2) of a 3-D map into a
// 1024-aligned shared tile, completing `bytes` on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// 2^x (flushing a denormal result to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Orders the registers' accesses around an asynchronous wgmma: no read of a
// result moves above the wait that completes it.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// ---------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units), layout type 1 (bits 62-63). A
// K-major operand (Q, K: rows of 64 bf16 = 128 bytes) has 8-row groups
// 1024 bytes apart (SBO) and no LBO; a k16 step moves the start 32 bytes
// inside the swizzle atom. The MN-major V (rows = keys, 64 d columns per
// atom) has 8-key groups 1024 bytes apart (SBO) and its two d atoms (d 128)
// kAtomB apart (LBO); a k16 step moves the start 16 rows (2048 bytes).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// K-major tile of D columns (D / 64 atoms): descriptor of k16 step kk
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return desc_sw128(tile + (kk / 4) * kAtomB + (kk % 4) * 32, 16, 1024);
}

// MN-major V tile: descriptor of key step kk (keys 16 kk .. 16 kk + 15)
__device__ __forceinline__ uint64_t desc_v(uint32_t tile, int kk) {
  return desc_sw128(tile + kk * 16 * 128, kAtomB, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Accumulator layout of m64nNk16 (f32, 128 threads): thread (warp w of the
// warpgroup, lane 4 g + t) holds d[4 c + e] = (row 16 w + g + 8 (e >> 1),
// col 8 c + 2 t + (e & 1)): per warp the m16n8 C layout of mma.cuh repeated
// over N / 8 column tiles. The register A operand is per warp the mma A
// fragment of its 16 rows.

// d (+)= A B, m64n64k16: A [64 x 16] and B [16 x 64] both from shared memory
// through descriptors, B K-major (no transpose); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A B, m64n64k16: A [64 x 16] from registers, B [16 x 64] from shared
// memory, MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B, m64n128k16: A [64 x 16] from registers, B [16 x 128] from shared
// memory, MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
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
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 64)
    wgmma_rs_n64(o, a, db);
  else
    wgmma_rs_n128(o, a, db);
}

// ---------------------------------------------------------------- kernel
// key tiles the warpgroup with rows r0 .. r0 + 63 walks
template <bool kMask>
__device__ __forceinline__ int tiles_for(int r0, int S, int s_true, int causal) {
  if (r0 >= S) return 0;
  if (kMask) return (S + kBK - 1) / kBK;
  const int n_valid = (s_true + kBK - 1) / kBK;
  if (!causal) return n_valid;
  return min(min(r0 + kBQ - 1, S - 1) / kBK + 1, n_valid);
}

template <int D, bool kDrop, bool kMask>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
                    float* __restrict__ lse, int S, int H, int s_true, int causal, float scale,
                    ptt::Dropout drop, ptt::AddMask mask) {
  using L = Layout<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base + L::kQ, k_s = base + L::kK, v_s = base + L::kV;
  const uint32_t q_full = base + L::kBar;
  auto full = [&](int st) { return q_full + 8 * (1 + st); };
  auto empty = [&](int st) { return q_full + 8 * (1 + kStages + st); };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y, bi = bh / H, hh = bh % H;
  const int n_qt = (S + kWG * kBQ - 1) / (kWG * kBQ);
  const int q0 = (causal ? n_qt - 1 - (int)blockIdx.x : (int)blockIdx.x) * (kWG * kBQ);
  int n_kt = 0;
#pragma unroll
  for (int w = 0; w < kWG; ++w) n_kt = max(n_kt, tiles_for<kMask>(q0 + w * kBQ, S, s_true, causal));

  if (tid == 0) {
    mbar_init(q_full, 1);
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
      mbar_expect_tx(q_full, kWG * L::kTileB);
      for (int w = 0; w < kWG; ++w)
        for (int half = 0; half < D / 64; ++half)
          tma_load(q_s + w * L::kTileB + half * kAtomB, &tm_q, hh * D + half * 64,
                   q0 + w * kBQ, bi, q_full);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % kStages;
        if (kt >= kStages) mbar_wait(empty(st), ((kt / kStages) & 1) ^ 1);
        mbar_expect_tx(full(st), 2 * L::kTileB);
        for (int half = 0; half < D / 64; ++half) {
          tma_load(k_s + st * L::kTileB + half * kAtomB, &tm_k, hh * D + half * 64, kt * kBK,
                   bi, full(st));
          tma_load(v_s + st * L::kTileB + half * kAtomB, &tm_v, hh * D + half * 64, kt * kBK,
                   bi, full(st));
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows r0 .. r0 + 63, warp wi of it 16.
  // Both warpgroups walk the CTA's n_kt tiles, so that every wgmma sits on
  // a path uniform over the CTA (ptxas serializes wgmma on a divergent
  // one); a tile past a warpgroup's own diagonal is all masked and leaves
  // its rows' bits as they were.
  const int wg = warp / 4, wi = warp % 4, g = lane / 4, t4 = lane % 4;
  const int r0 = q0 + wg * kBQ;
  const int row_a = r0 + 16 * wi + g;  // the thread's rows: row_a, row_a + 8
  const uint32_t my_q = q_s + wg * L::kTileB;
  const float sl2 = scale * kLog2e;

  float oacc[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) oacc[j] = 0.f;
  // running max (log2 units) and sum of each of the thread's two rows
  float m[2] = {kNegInf2, kNegInf2}, l[2] = {0.f, 0.f};
  float s[32];
  uint32_t pa[kPTerms][kBK / 16][4];

  // S = Q K^T of tile kt into s (asynchronous; the caller commits)
  auto issue_s = [&](int kt) {
    const uint32_t kst = k_s + (kt % kStages) * L::kTileB;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64(s, desc_k(my_q, kk), desc_k(kst, kk), kk);
  };

  // P V of tile kt: O += P V from the A fragments in pa (asynchronous)
  auto issue_pv = [&](int kt) {
    const uint32_t vst = v_s + (kt % kStages) * L::kTileB;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int t = 0; t < kPTerms; ++t) wgmma_pv<D>(oacc, pa[t][kk], desc_v(vst, kk));
  };

  // The online softmax of tile kt on its scores in s: the running max, the
  // rescale factors alpha, l, and the (dropped) weights back into s.
  float alpha[2];
  auto softmax = [&](int kt) {
    const int k0 = kt * kBK;
    // scores in log2 units; tests only where a pair may be masked: the
    // tile crossing the diagonal, the tile holding s_true, and every tile
    // of a mask launch
    [[maybe_unused]] const bool test = k0 + kBK > s_true || (causal && k0 + kBK - 1 > r0);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int row = row_a + 8 * ((j >> 1) & 1);
      const int col = k0 + 8 * (j >> 2) + 2 * t4 + (j & 1);
      // never fused into a later add: the plain and mask builds round the
      // scaled score alike
      float x = __fmul_rn(s[j], sl2);
      if constexpr (kMask) {
        // the mask goes into the scaled score before the tests; a key
        // past the tensor's end weighs nothing even in a hidden row
        if (row < S && col < S) x = fmaf(mask.at(bi, hh, row, col), kLog2e, x);
        if (!(col < s_true && (!causal || col <= row))) x = col < S ? kNegInf2 : -INFINITY;
      } else {
        if (test && !(col < s_true && (!causal || col <= row))) x = kNegInf2;
      }
      s[j] = x;
    }
    float mx[2] = {kNegInf2, kNegInf2}, sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 32; ++j) mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], s[j]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = ex2(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int i = (j >> 1) & 1;
      const float p = ex2(s[j] - m[i]);
      sum[i] += p;  // l sums the weights before dropout
      float w = p;
      if constexpr (kDrop) {
        const bool keep = ptt::dropout_keep(drop.seed, bh, row_a + 8 * i,
                                            k0 + 8 * (j >> 2) + 2 * t4 + (j & 1), drop.thresh);
        w = keep ? p * drop.inv_keep : 0.f;
      }
      s[j] = w;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = fmaf(alpha[i], l[i], sum[i]);
    }
  };

  // O *= alpha, then P as kPTerms bf16 terms into pa, each the A fragments
  // of the 4 key steps (key step kk takes the column tiles 2 kk, 2 kk + 1)
  auto rescale_split = [&]() {
#pragma unroll
    for (int j = 0; j < D / 2; ++j) oacc[j] *= alpha[(j >> 1) & 1];
#pragma unroll
    for (int t = 0; t < kPTerms; ++t)
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        float* c0 = s + 8 * kk;
        pa[t][kk][0] = split_bf16(c0[0], c0[1]);
        pa[t][kk][1] = split_bf16(c0[2], c0[3]);
        pa[t][kk][2] = split_bf16(c0[4], c0[5]);
        pa[t][kk][3] = split_bf16(c0[6], c0[7]);
      }
  };

  // The walk is software-pipelined: each step issues S of tile kt and P V
  // of tile kt - 1 together, and the softmax of tile kt runs while that
  // P V does. Every wgmma group is waited for inside the block that issues
  // it (ptxas serializes wgmma whose groups cross a loop edge or a branch).
  mbar_wait(q_full, 0);
  if (n_kt > 0) {
    mbar_wait(full(0), 0);
    wgmma_fence();
    issue_s(0);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);
    softmax(0);
    rescale_split();
  }
  for (int kt = 1; kt < n_kt; ++kt) {
    mbar_wait(full(kt % kStages), (kt / kStages) & 1);
    reg_fence(oacc);
    wgmma_fence();
    issue_s(kt);
    wgmma_commit();
    issue_pv(kt - 1);
    wgmma_commit();
    wgmma_wait<1>();  // S of tile kt; P V of tile kt - 1 may still run
    reg_fence(s);
    softmax(kt);
    wgmma_wait<0>();  // P V of tile kt - 1: O may be rescaled, pa rewritten
    reg_fence(oacc);
    if (lane == 0) mbar_arrive(empty((kt - 1) % kStages));
    rescale_split();
  }
  if (n_kt > 0) {
    reg_fence(oacc);
    wgmma_fence();
    issue_pv(n_kt - 1);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(oacc);
    if (lane == 0) mbar_arrive(empty((n_kt - 1) % kStages));
  }

  const size_t row_stride = (size_t)H * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_a + 8 * i;
    if (row >= S) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    bf16* orow = o + ((size_t)bi * S + row) * row_stride + (size_t)hh * D + 2 * t4;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<uint32_t*>(orow + 8 * c) =
          ptt::mma::pack_bf16(oacc[4 * c + 2 * i] / lc, oacc[4 * c + 2 * i + 1] / lc);
    if (t4 == 0) lse[(size_t)bh * S + row] = m[i] * kLn2 + logf(lc);
  }
}

// ---------------------------------------------------------------- host
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a [b, s, h * d] bf16 tensor as a 3-D map with 64 x 64 boxes, 128-byte
// swizzle, rows past s zero-filled
bool make_map(CUtensorMap* map, const void* ptr, int b, int s, int hd) {
  EncodeTiled enc = encode_fn();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * 2, (cuuint64_t)s * hd * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
             box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, bool kDrop, bool kMask>
cudaError_t launch_as(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
                      void* o, float* lse, int b, int s, int h, int s_true, int causal,
                      float scale, ptt::Dropout drop, ptt::AddMask mask, cudaStream_t st) {
  constexpr size_t smem = Layout<D>::kBytes;
  cudaError_t err = ptt::allow_smem(flash_fwd_tc_kernel<D, kDrop, kMask>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((s + kWG * kBQ - 1) / (kWG * kBQ), b * h);
  flash_fwd_tc_kernel<D, kDrop, kMask><<<grid, kThreads, smem, st>>>(
      mq, mk, mv, static_cast<bf16*>(o), lse, s, h, s_true, causal, scale, drop, mask);
  return cudaSuccess;
}

}  // namespace

// q, k, v, o: [b, s, h, d] bf16, 16-byte aligned; lse [b, h, s] f32. d must
// be 64 or 128. mask, causal and dropout (seed, thresh, inv_keep) as
// ptt_flash_attention_fwd's.
extern "C" int ptt_flash_attention_fwd_tc(const void* q, const void* k, const void* v, void* o,
                                          void* lse, const void* mask, long long msb,
                                          long long msh, long long msq, long long msk, int b,
                                          int s, int h, int d, int s_true, int causal,
                                          float scale, int dropout, unsigned seed,
                                          unsigned thresh, float inv_keep, int device,
                                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b * h > 65535 || (d != 64 && d != 128)) return (int)cudaErrorInvalidValue;  // grid.y
  if (b == 0 || s == 0 || h == 0) return (int)cudaSuccess;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, b, s, h * d) || !make_map(&mk, k, b, s, h * d) ||
      !make_map(&mv, v, b, s, h * d))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const ptt::Dropout drop{dropout, seed, thresh, inv_keep};
  const ptt::AddMask m{static_cast<const float*>(mask), msb, msh, msq, msk};
#define PTT_FWD_TC(D, DROP, MASK) \
  launch_as<D, DROP, MASK>(mq, mk, mv, o, l, b, s, h, s_true, causal, scale, drop, m, st)
  const bool dr = dropout != 0, masked = mask != nullptr;
  if (d == 128)
    err = masked ? (dr ? PTT_FWD_TC(128, true, true) : PTT_FWD_TC(128, false, true))
                 : (dr ? PTT_FWD_TC(128, true, false) : PTT_FWD_TC(128, false, false));
  else
    err = masked ? (dr ? PTT_FWD_TC(64, true, true) : PTT_FWD_TC(64, false, true))
                 : (dr ? PTT_FWD_TC(64, true, false) : PTT_FWD_TC(64, false, false));
#undef PTT_FWD_TC
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
