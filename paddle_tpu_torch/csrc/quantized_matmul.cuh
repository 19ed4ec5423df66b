// Tile geometry of the int8 matmul's TMA-fed routes, shared by
// quantized_matmul.cu (the GEMV ring and the weights' tensor maps) and
// quantized_matmul_tc.cu (the tensor-core GEMM), and the weight map both
// take: an int8 [k, n] row-major weight as a 2-D tensor map, no swizzle,
// rows and columns past the edges read as zeros.
#pragma once
#include <cuda.h>

#include "common.cuh"

namespace ptt {
namespace qmm {

// route codes of the weight maps (ptt_quantized_matmul_map)
enum : int { kMapRing = 0, kMapTc = 1 };

// the GEMV ring: tiles of kRingRows k rows x one 32-column slab (8 KB of
// int8), kRingStages of them in shared memory
constexpr int kRingRows = 256;
constexpr int kRingStages = 8;

// the tensor-core GEMM: CTA tiles of kTcBM rows of x x kTcBN output
// columns, k in steps of kTcBK
constexpr int kTcBM = 128, kTcBN = 128, kTcBK = 64;

// The weight's map for a route: boxes of kSlabCols x kRingRows, no
// swizzle (ring), or kTcBN x kTcBK in the 128-byte swizzle (tc). False if
// the encode fails (a row not a multiple of 16 bytes, a base off 16 bytes,
// an unknown route).
inline bool weight_map(CUtensorMap* map, const void* w, int k, int n, int route) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr || (route != kMapRing && route != kMapTc)) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)k};
  const cuuint64_t strides[1] = {(cuuint64_t)n};
  const cuuint32_t box[2] = {(cuuint32_t)(route == kMapRing ? kSlabCols : kTcBN),
                             (cuuint32_t)(route == kMapRing ? kRingRows : kTcBK)};
  const cuuint32_t estr[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w), dims, strides, box,
             estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             route == kMapRing ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace qmm
}  // namespace ptt
