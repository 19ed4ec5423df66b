#!/usr/bin/env python3
"""How fast one persistent block per SM streams a weight, by access pattern.

The decode megakernel reads every weight as 32-column slabs of a [k, n]
row-major matrix, one slab per block at a time, so each k row of a slab is
a short piece (64 bytes of bf16, 32 of int8) of a long row. This probe
streams LLaMA-7B's gate weight ([4096, 11008], bf16 and int8) through 132
blocks of 256 threads, one per SM, each walking whole column strips of
`cols` columns over all of k (strips u = blockIdx.x + j * gridDim.x, as the
megakernel's units), and does no arithmetic beyond touching each tile:

- `tma`: a shared-memory ring of `stages` tiles of `rows` x `cols`, filled
  by 2-D TMA tensor copies issued stages - 1 tiles ahead by lane 0 of
  `issuers` warps in turn (mbarriers, one arrive per warp to release a
  stage), as `ptt::SlabRing`;
- `cp.async`: the same ring filled by every thread's 16-byte `cp.async`
  copies (wait_group and a block barrier per tile);
- `ldg`: 16-byte loads into registers, four k rows in flight per thread
  (the register-fed GEMV's pattern, `ptt::gemv_slab`).

Every block streams six strips, so every SM moves the same bytes (the
weight's width is 3 x blocks x strip columns). Cases: strip rows of 32,
64, 128 and 256 bytes; the bytes in flight per SM (ring stages); one or
two blocks per SM. Prints TB/s and GB/s per SM per case (bytes of the
weight over the time by CUDA events, best of 6 launches) beside the card's
name and power limit.

    python3 tools/stream_probe.py       # needs one CUDA card and nvcc
"""
import ctypes
import json
import os
import pathlib
import subprocess
import sys
import tempfile

SRC = r'''
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t su32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void wait_parity(uint32_t b, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n" : "=r"(done) : "r"(b), "r"(parity) : "memory");
}

// one block walks strips u = blockIdx.x + j gridDim.x of `cols` columns
// (a box of cols x rows per tile) over k rows
extern "C" __global__ void __launch_bounds__(256) tma_stream(const CUtensorMap* map, int k,
    int n_strips, int cols, int rows, int tile_bytes, int stages, int issuers, unsigned* sink) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* buf = smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + (size_t)stages * tile_bytes);
  uint64_t* empty = full + stages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(su32(full + s)));
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 8;\n" :: "r"(su32(empty + s)));
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int tiles_per = (k + rows - 1) / rows;
  int my_strips = 0;
  for (int u = blockIdx.x; u < n_strips; u += gridDim.x) ++my_strips;
  const int total = my_strips * tiles_per;
  // lane 0 of warps 0 .. issuers - 1 issue tiles m = warp, warp + issuers, ...
  const int warp = threadIdx.x / 32;
  int issued = warp;
  auto issue = [&]() {
    const int m = issued, s = m % stages, f = m / stages;
    const int u = blockIdx.x + (m / tiles_per) * gridDim.x, t = m % tiles_per;
    if (f > 0) wait_parity(su32(empty + s), (f - 1) & 1);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(su32(full + s)), "r"(tile_bytes) : "memory");
    asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
                 " [%0], [%1, {%2, %3}], [%4];\n"
                 :: "r"(su32(buf + (size_t)s * tile_bytes)), "l"((uint64_t)map),
                    "r"(u * cols), "r"(t * rows), "r"(su32(full + s)) : "memory");
    issued += issuers;
  };
  unsigned acc = 0;
  for (int n = 0; n < total; ++n) {
    if (threadIdx.x % 32 == 0 && warp < issuers)
      while (issued < total && issued < n + stages - 1) issue();
    const int s = n % stages;
    wait_parity(su32(full + s), (n / stages) & 1);
    const uint4* t = reinterpret_cast<const uint4*>(buf + (size_t)s * tile_bytes);
    for (int e = threadIdx.x; e < tile_bytes / 16; e += 256) acc ^= t[e].x;
    __syncwarp();
    if (threadIdx.x % 32 == 0)
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(su32(empty + s)) : "memory");
  }
  if (acc == 0x12345678u) sink[0] = acc;
}

// the same ring filled by every thread's 16-byte cp.async
extern "C" __global__ void __launch_bounds__(256) cpasync_stream(const unsigned char* w,
    long long row_bytes, int k, int n_strips, int strip_bytes, int rows, int stages,
    unsigned* sink) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tile_bytes = rows * strip_bytes, chunks = tile_bytes / 16, per_row = strip_bytes / 16;
  const int tiles_per = (k + rows - 1) / rows;
  int my_strips = 0;
  for (int u = blockIdx.x; u < n_strips; u += gridDim.x) ++my_strips;
  const int total = my_strips * tiles_per;
  auto issue = [&](int m) {
    if (m < total) {
      const int u = blockIdx.x + (m / tiles_per) * gridDim.x, t = m % tiles_per;
      unsigned char* dst = smem + (size_t)(m % stages) * tile_bytes;
      for (int c = threadIdx.x; c < chunks; c += 256) {
        const int r = c / per_row, q = c % per_row, row = t * rows + r;
        const unsigned char* src = w + (size_t)min(row, k - 1) * row_bytes + (size_t)u * strip_bytes + q * 16;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(su32(dst + c * 16)),
                     "l"(src) : "memory");
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  for (int m = 0; m < stages - 1; ++m) issue(m);
  unsigned acc = 0;
  for (int n = 0; n < total; ++n) {
    switch (stages - 2) {                // tile n has landed
#define PTT_WAIT(N) case N: asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory"); break;
      PTT_WAIT(2) PTT_WAIT(3) PTT_WAIT(4) PTT_WAIT(5) PTT_WAIT(6) PTT_WAIT(7) PTT_WAIT(8)
      PTT_WAIT(9) PTT_WAIT(10) PTT_WAIT(11) PTT_WAIT(12) PTT_WAIT(13) PTT_WAIT(14)
#undef PTT_WAIT
      default: asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const uint4* t = reinterpret_cast<const uint4*>(smem + (size_t)(n % stages) * tile_bytes);
    for (int e = threadIdx.x; e < chunks; e += 256) acc ^= t[e].x;
    __syncthreads();
    issue(n + stages - 1);
  }
  if (acc == 0x12345678u) sink[0] = acc;
}

// 16-byte loads into registers, four k rows in flight per thread
extern "C" __global__ void __launch_bounds__(256) ldg_stream(const unsigned char* w,
    long long row_bytes, int k, int n_strips, int strip_bytes, unsigned* sink) {
  const int per_row = strip_bytes / 16, krows = 256 / per_row;
  const int q = threadIdx.x % per_row, kr = threadIdx.x / per_row;
  unsigned acc = 0;
  for (int u = blockIdx.x; u < n_strips; u += gridDim.x) {
    const unsigned char* base = w + (size_t)u * strip_bytes + q * 16;
    int row = kr;
    for (; row + 3 * krows < k; row += 4 * krows) {
      uint4 p[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        p[j] = __ldg(reinterpret_cast<const uint4*>(base + (size_t)(row + j * krows) * row_bytes));
#pragma unroll
      for (int j = 0; j < 4; ++j) acc ^= p[j].x;
    }
    for (; row < k; row += krows)
      acc ^= __ldg(reinterpret_cast<const uint4*>(base + (size_t)row * row_bytes)).x;
  }
  if (acc == 0x12345678u) sink[0] = acc;
}

using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

extern "C" int probe_map(void* w, int elem_bytes, long long k, long long n, int cols, int rows,
                         int promo, void* out_host) {
  void* f = nullptr;
  cudaDriverEntryPointQueryResult q;
  if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q) != cudaSuccess)
    return 1;
  const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)k};
  const cuuint64_t strides[1] = {(cuuint64_t)(n * elem_bytes)};
  const cuuint32_t box[2] = {(cuuint32_t)cols, (cuuint32_t)rows};
  const cuuint32_t es[2] = {1, 1};
  const CUtensorMapL2promotion pr[3] = {CU_TENSOR_MAP_L2_PROMOTION_NONE,
                                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B};
  return (int)reinterpret_cast<EncodeFn>(f)(
      static_cast<CUtensorMap*>(out_host),
      elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w,
      dims, strides, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      pr[promo], CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

extern "C" int launch_tma(const void* map, int k, int n_strips, int cols, int rows, int tile_bytes,
                          int stages, int issuers, void* sink, int grid) {
  const int smem = stages * tile_bytes + 16 * stages;
  cudaFuncSetAttribute(tma_stream, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  tma_stream<<<grid, 256, smem>>>((const CUtensorMap*)map, k, n_strips, cols, rows, tile_bytes,
                                  stages, issuers, (unsigned*)sink);
  return (int)cudaGetLastError();
}
extern "C" int launch_cpasync(const void* w, long long row_bytes, int k, int n_strips,
                              int strip_bytes, int rows, int stages, void* sink, int grid) {
  const int smem = stages * rows * strip_bytes;
  cudaFuncSetAttribute(cpasync_stream, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cpasync_stream<<<grid, 256, smem>>>((const unsigned char*)w, row_bytes, k, n_strips,
                                      strip_bytes, rows, stages, (unsigned*)sink);
  return (int)cudaGetLastError();
}
extern "C" int launch_ldg(const void* w, long long row_bytes, int k, int n_strips,
                          int strip_bytes, void* sink, int grid) {
  ldg_stream<<<grid, 256>>>((const unsigned char*)w, row_bytes, k, n_strips, strip_bytes,
                            (unsigned*)sink);
  return (int)cudaGetLastError();
}
'''


def main():
    import torch
    if not torch.cuda.is_available():
        print("stream_probe: no CUDA card", file=sys.stderr)
        return 1
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="stream_probe-"))
    (tmp / "probe.cu").write_text(SRC)
    nvcc = os.path.join(os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", "nvcc")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp / "probe.so"),
                    str(tmp / "probe.cu")], check=True)
    lib = ctypes.CDLL(str(tmp / "probe.so"))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.probe_map.argtypes = [P, I, L, L, I, I, I, P]
    lib.launch_tma.argtypes = [P, I, I, I, I, I, I, I, P, I]
    lib.launch_cpasync.argtypes = [P, L, I, I, I, I, I, P, I]
    lib.launch_ldg.argtypes = [P, L, I, I, I, P, I]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    sink = torch.zeros(4, dtype=torch.int32, device=dev)
    k = 4096

    def timed(fn):
        best = None
        for _ in range(6):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            assert fn() == 0
            b.record()
            torch.cuda.synchronize()
            t = a.elapsed_time(b)
            best = t if best is None else min(best, t)
        return best

    def emit(nbytes, ms, **kw):
        print(json.dumps(dict(kw, ms=ms, tb_s=nbytes / ms / 1e9,
                              gb_s_per_sm=nbytes / ms / 1e6 / n_sm)), flush=True)

    # (element bytes, row bytes, tile rows, stages, blocks per SM, issuing
    # warps): whole waves of strips (6 per block), so every SM streams the
    # same bytes
    cases = [(e, rb, 16384 // rb if rb >= 64 else 256, 8, 1, 1)
             for e in (2, 1) for rb in (32, 64, 128, 256)]
    cases += [(2, 64, 128, st, 1, 1) for st in (4, 16, 24)]       # bytes in flight
    cases += [(2, 64, 128, st, 2, 1) for st in (4, 8)]            # 2 blocks an SM
    cases += [(2, 64, rows, 8, 1, iss) for rows in (256, 128) for iss in (2, 4, 8)]
    cases += [(1, 32, 256, st, 1, iss) for st in (8, 16) for iss in (1, 2, 4, 8)]
    cases += [(1, 64, 256, 8, 1, iss) for iss in (2, 4)]
    for elem, rb, rows, stages, per_sm, issuers in cases:
        cols = rb // elem
        grid = n_sm * per_sm
        n = 6 * grid * cols
        w = torch.randint(-100, 100, (k, n * elem), dtype=torch.int8, device=dev)
        nbytes = w.numel()
        tile = rows * rb
        host = torch.zeros(128, dtype=torch.uint8)
        assert lib.probe_map(w.data_ptr(), elem, k, n, cols, rows, 2, host.data_ptr()) == 0
        dmap = host.to(dev)
        kw = dict(dtype="bf16" if elem == 2 else "int8", row_bytes=rb, rows=rows,
                  stages=stages, blocks_per_sm=per_sm, issuers=issuers,
                  in_flight_kb=(stages - 1) * tile / 1024)
        if stages * tile > 227 * 1024 // per_sm:
            continue
        emit(nbytes, timed(lambda: lib.launch_tma(dmap.data_ptr(), k, n // cols, cols, rows, tile,
                                                  stages, issuers, sink.data_ptr(), grid)),
             route="tma", **kw)
        if issuers > 1:
            continue
        if stages >= 4 and per_sm == 1:
            emit(nbytes, timed(lambda: lib.launch_cpasync(w.data_ptr(), n * elem, k, n // cols,
                                                          rb, rows, stages, sink.data_ptr(),
                                                          grid)),
                 route="cp.async", **kw)
        if stages == 8 and per_sm == 1:
            emit(nbytes, timed(lambda: lib.launch_ldg(w.data_ptr(), n * elem, k, n // cols, rb,
                                                      sink.data_ptr(), grid)),
                 route="ldg", dtype=kw["dtype"], row_bytes=rb)
        del w
    return 0


if __name__ == "__main__":
    sys.exit(main())
