// Seg "full": the whole-layer (or whole-step) builds of decode_megakernel.cuh
// and their C entry point. The tensor-parallel segments are built apart, in
// decode_megakernel_tp.cu, so that nvcc compiles the two files in parallel.
#include "decode_megakernel.cuh"

// dtype: 0 = float32, 1 = bfloat16 (h, scratch, pools, norms and dense
// weights share it). wkind: 0 = dense weights of that dtype, 1 = int8
// weights with f32 per-column scales. grid_out (host) receives the grid.
extern "C" int ptt_decode_megakernel(const PttMkArgs* args, int dtype, int wkind, int device,
                                     void* stream, int* grid_out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const PttMkArgs& a = *args;
  if (!args_ok(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && wkind == 0)
    err = launch<__nv_bfloat16, __nv_bfloat16, kSegFull>(a, device, s, grid_out);
  else if (dtype == 1 && wkind == 1)
    err = launch<__nv_bfloat16, int8_t, kSegFull>(a, device, s, grid_out);
  else if (dtype == 0 && wkind == 0)
    err = launch<float, float, kSegFull>(a, device, s, grid_out);
  else if (dtype == 0 && wkind == 1)
    err = launch<float, int8_t, kSegFull>(a, device, s, grid_out);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
