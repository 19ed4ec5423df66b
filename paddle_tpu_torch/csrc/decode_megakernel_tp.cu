// The tensor-parallel segments of the decode megakernel: the qkv / tail /
// down builds of decode_megakernel.cuh and their C entry point.
//
// Replaces: paddle_tpu/ops/pallas/decode_megakernel.py `_mk_kernel` at seg
// "qkv" / "tail" / "down" (SEG_PHASES, decode_megakernel.py:72-77; the
// segment entry :312; the wrapper's rules :709-712, :740-776), run per shard
// by the reference's tensor-parallel engine (scheduler.py:2240-2295).
//
// What bounds it on the H100: the bytes a shard's segment reads. qkv streams
// the shard's column slices of wq / wk / wv (1/tp of them) and its live KV
// rows; tail the whole replicated wo and the shard's 1/tp of gate / up;
// down the whole replicated wd (and the shard's vocab slice of the lm_head).
// A tp-way step so reads (3 + 2 tp) / 5 of the attention block's weight
// bytes and (2 + tp) / 3 of the MLP's, and launches 3 kernels per layer and
// shard. The design is the full build's, entered and left at the gather
// boundaries (header of decode_megakernel.cuh); it aims at right and simple.
//
// Built for bf16 activations (the engine's compute dtype on the card) with
// bf16 or int8 weights.
#include "decode_megakernel.cuh"

// seg: 1 = qkv, 2 = tail, 3 = down (the arguments carry each segment's
// widths: decode_megakernel.cuh, the segments' note). wkind: 0 = bf16
// weights, 1 = int8 weights with f32 per-column scales. grid_out (host)
// receives the grid.
extern "C" int ptt_decode_megakernel_seg(const PttMkArgs* args, int seg, int wkind, int device,
                                         void* stream, int* grid_out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const PttMkArgs& a = *args;
  if (!args_ok(a) || a.n_layers != 1 || (a.head_row >= 0 && seg != kSegDown))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (seg == kSegQkv && wkind == 0)
    err = launch<bf16, bf16, kSegQkv>(a, device, s, grid_out);
  else if (seg == kSegQkv && wkind == 1)
    err = launch<bf16, int8_t, kSegQkv>(a, device, s, grid_out);
  else if (seg == kSegTail && wkind == 0)
    err = launch<bf16, bf16, kSegTail>(a, device, s, grid_out);
  else if (seg == kSegTail && wkind == 1)
    err = launch<bf16, int8_t, kSegTail>(a, device, s, grid_out);
  else if (seg == kSegDown && wkind == 0)
    err = launch<bf16, bf16, kSegDown>(a, device, s, grid_out);
  else if (seg == kSegDown && wkind == 1)
    err = launch<bf16, int8_t, kSegDown>(a, device, s, grid_out);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
