// Tensor-core building blocks shared by the bf16 attention kernels
// (ragged_paged_attention_tc.cu, flash_attention_bwd_tc.cu): cp.async
// copies into swizzled shared memory, ldmatrix fragment loads and the
// warp-level mma.sync m16n8k16 bf16 product with f32 accumulators.
//
// Fragment layouts of mma.m16n8k16.row.col (lane = 4 g + t, g = lane / 4,
// t = lane % 4):
//   A (16 x 16, row-major)  a[0] = (row g,     k 2t..2t+1)
//                           a[1] = (row g + 8, k 2t..2t+1)
//                           a[2] = (row g,     k 2t+8..2t+9)
//                           a[3] = (row g + 8, k 2t+8..2t+9)
//   B (16 x 8)              b[0] = (k 2t..2t+1, col g), b[1] = (k 2t+8..2t+9, col g)
//   C (16 x 8, f32)         c[0..1] = (row g, cols 2t..2t+1), c[2..3] = (row g + 8, ...)
// Two C tiles side by side (cols 0-7, 8-15) are, packed to bf16, the A
// fragment of a product whose depth is those 16 columns, so a score tile
// feeds the next product from registers.
//
// Shared tiles hold rows of D bf16 (D a multiple of 64): 16-byte chunk c of
// row r sits at chunk c ^ (r % 8), so the 8 rows one ldmatrix phase reads
// at one chunk fall in 8 different bank groups.
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

namespace ptt {
namespace mma {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c of row r in a swizzled tile of D bf16 rows
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * (D * 2) + ((c ^ (r & 7)) << 4));
}

// 16 bytes global -> shared; zero-filled when !pred (src must still be a
// valid address)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}

// 4 bytes global -> shared; zero-filled when !pred
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool pred) {
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a b (16 x 8 x 16, bf16 in, f32 accumulate)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one register of two bf16 (round to nearest even), lo in the
// low half: the element with the smaller column index
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the bf16 pair nearest (lo, hi), as pack_bf16; lo and hi become what is
// left of them (exact in f32), so calling it again packs the next term
__device__ __forceinline__ uint32_t split_bf16(float& lo, float& hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  lo -= __low2float(v);
  hi -= __high2float(v);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A fragment (16 rows x 16 deep) of rows row0.. of a swizzled [rows][D]
// tile, depth chunk pair (2 kk, 2 kk + 1)
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], uint32_t tile, int row0, int kk,
                                       int lane) {
  ldsm_x4(a, tile + swz<D>(row0 + (lane & 15), 2 * kk + (lane >> 4)));
}

// B fragments of two n-tiles (n rows n0..n0+15 of a swizzled [n][D] tile,
// depth chunk pair kk): b[0], b[1] for n0..n0+7 and b[2], b[3] for
// n0+8..n0+15. The product is X [.., D] times the tile's transpose.
template <int D>
__device__ __forceinline__ void load_bt(uint32_t (&b)[4], uint32_t tile, int n0, int kk,
                                        int lane) {
  ldsm_x4(b, tile + swz<D>(n0 + (lane & 7) + ((lane >> 4) << 3), 2 * kk + ((lane >> 3) & 1)));
}

// B fragments of two n-tiles (columns 16 nd .. 16 nd + 15) of depth rows
// k0..k0+15 of a swizzled [k][D] tile: b[0], b[1] for columns 16 nd..+7,
// b[2], b[3] for 16 nd + 8..+15. The product is X [.., k] times the tile.
template <int D>
__device__ __forceinline__ void load_b(uint32_t (&b)[4], uint32_t tile, int k0, int nd,
                                       int lane) {
  ldsm_x4_trans(b, tile + swz<D>(k0 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                 2 * nd + (lane >> 4)));
}

}  // namespace mma
}  // namespace ptt
