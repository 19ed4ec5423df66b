// Hopper warpgroup building blocks shared by the wgmma kernels
// (flash_attention_tc.cu, quantized_matmul_tc.cu): mbarriers, TMA tensor
// copies, shared-memory matrix descriptors in the 128-byte swizzle, and
// the wgmma fence / commit / wait.
//
// A 128-byte-swizzled atom holds 8-row groups of 128-byte rows; 16-byte
// chunk c of row r sits at chunk c ^ (r % 8) (TMA's CU_TENSOR_MAP_SWIZZLE_128B
// on a 1024-byte-aligned destination writes exactly this). An atom of
// 64 rows x 64 bf16 is kAtomB bytes.
#pragma once
#include <cuda.h>
#include <stdint.h>

namespace ptt {
namespace wg {

constexpr uint32_t kAtomB = 64 * 128;  // [64 rows][64 bf16], 128-byte swizzle

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

// one box (column c0, row c1) of a 2-D map into shared memory, completing
// its bytes on bar
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
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

}  // namespace wg
}  // namespace ptt
