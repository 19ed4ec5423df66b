#!/usr/bin/env python3
"""What one SM of the card sustains: shared-memory loads by address
pattern, and f32 FFMA.

Builds one small kernel with nvcc and times, with CUDA events, a loop run
by every warp of 2 blocks of 1024 threads on each SM, the SM clock read
from `nvidia-smi` while it runs. A load pattern reports the SM-clock
cycles one SM spends per warp load instruction, so a pattern served in one
128-byte wavefront reads ~1 and a 16-byte load whose four quarter-warps
are served one after another reads ~4. `ffma` runs 32 independent FFMA
chains a thread and reports TFLOP/s and the FFMAs one SM retires a cycle
(the data sheet's 67 TFLOP/s is 128 a cycle at 1.98 GHz); `ffma_8_warps`
the same with one block of 256 threads an SM, 2 warps a scheduler, as
the f32 flash backward runs. Load patterns (lane = thread index in the
warp):

- `v4_distinct`: 16-byte loads, lane l at chunk l (512 distinct bytes);
- `v4_quarter_bcast`: 16-byte loads, lane l at chunk l / 8 (the 8 lanes
  of a quarter-warp share an address, 4 addresses a warp);
- `v4_half_bcast`: 16-byte loads, lane l at chunk l / 16 (2 addresses);
- `v4_warp_bcast`: 16-byte loads, every lane at one chunk;
- `v4_quarters_alike`: 16-byte loads, lane l at chunk l % 8 (the four
  quarter-warps read the same 128 bytes);
- `v1_distinct`: 4-byte loads, lane l at word l;
- `v1_warp_bcast`: 4-byte loads, every lane at one word.

    python3 tools/sm_probe.py        # needs one CUDA card and nvcc
"""
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import threading

SRC = r'''
#include <cuda_runtime.h>
extern "C" __global__ void probe(float* out, int mode, int iters) {
  __shared__ __align__(16) float buf[4096];
  for (int i = threadIdx.x; i < 4096; i += blockDim.x) buf[i] = (float)i;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  int c;  // 16-byte chunk (or word, modes 5-6) of this lane
  switch (mode) {
    case 0: c = lane; break;
    case 1: c = lane >> 3; break;
    case 2: c = lane >> 4; break;
    case 3: c = 0; break;
    case 4: c = lane & 7; break;
    case 5: c = lane; break;
    default: c = 0; break;
  }
  // volatile loads of the full width, one add a load: the loads set the pace
  float acc = 0.f;
  const unsigned sbase = (unsigned)__cvta_generic_to_shared(buf);
  if (mode >= 7) {  // FFMA: 32 independent chains, 64 FFMAs an iteration
    float r[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) r[k] = buf[lane + 32 * k];
    const float a = buf[lane] * 1e-3f, b = 0.999f;
#pragma unroll 1
    for (int i = 0; i < iters; ++i) {
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int k = 0; k < 32; ++k) r[k] = fmaf(r[k], b, a);
    }
#pragma unroll
    for (int k = 0; k < 32; ++k) acc += r[k];
  } else if (mode < 5) {
#pragma unroll 1
    for (int i = 0; i < iters; ++i) {
      const int base = (i & 7) * 32;  // a uniform offset: no load is hoisted
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        float x, y, z, w;
        asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                     : "=f"(x), "=f"(y), "=f"(z), "=f"(w)
                     : "r"(sbase + 16u * (base + ((c + 4 * u) & 31))));
        acc += x;
      }
    }
  } else {
#pragma unroll 1
    for (int i = 0; i < iters; ++i) {
      const int base = (i & 7) * 128;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        float x;
        asm volatile("ld.shared.f32 %0, [%1];"
                     : "=f"(x)
                     : "r"(sbase + 4u * (base + ((c + 32 * u) & 127))));
        acc += x;
      }
    }
  }
  if (acc == 1234.5f) out[0] = acc;
}
extern "C" int run(float* out, int mode, int iters, int blocks, int threads) {
  probe<<<blocks, threads>>>(out, mode, iters);
  return (int)cudaGetLastError();
}
'''
REPEATS = 100    # launches a pattern: ~0.1-0.5 s, long enough to read the clock
MODES = ("v4_distinct", "v4_quarter_bcast", "v4_half_bcast", "v4_warp_bcast",
         "v4_quarters_alike", "v1_distinct", "v1_warp_bcast", "ffma", "ffma_8_warps")


def main():
    import torch
    if not torch.cuda.is_available():
        print("smem_probe: no CUDA card", file=sys.stderr)
        return 1
    nvcc = os.path.join(os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", "nvcc")
    tmp = tempfile.mkdtemp(prefix="smem_probe-")
    src, lib = os.path.join(tmp, "probe.cu"), os.path.join(tmp, "probe.so")
    with open(src, "w") as f:
        f.write(SRC)
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", lib, src], check=True)
    so = ctypes.CDLL(lib)
    so.run.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int]
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, iters = 2 * sms, 4096
    out = torch.zeros(1, device=dev)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    clocks = []
    stop = threading.Event()

    def sample():
        while not stop.is_set():
            r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                               capture_output=True, text=True).stdout.strip()
            if r:
                clocks.append(float(r.split()[0]))
            stop.wait(0.2)

    rows = []
    for mode, name in enumerate(MODES):
        # every pattern runs 2 blocks of 1024 threads an SM (16 warps a
        # scheduler) but ffma_8_warps: 1 block of 256 (2 warps a scheduler)
        nb, nt = (sms, 256) if name == "ffma_8_warps" else (blocks, 1024)
        assert so.run(out.data_ptr(), mode, 16, nb, nt) == 0
        torch.cuda.synchronize()
        clocks.clear()
        stop.clear()
        th = threading.Thread(target=sample)
        th.start()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(REPEATS):
            so.run(out.data_ptr(), mode, iters, nb, nt)
        b.record()
        torch.cuda.synchronize()
        stop.set()
        th.join()
        ms = a.elapsed_time(b) / REPEATS
        mhz = sum(clocks) / len(clocks) if clocks else float("nan")
        cycles = ms * 1e-3 * mhz * 1e6
        if name.startswith("ffma"):
            ffma = nb * nt * iters * 64                # FFMAs of one launch
            rows.append(dict(pattern=name, ms=ms, sm_mhz=mhz, tflops=2 * ffma / (ms * 1e9),
                             ffma_per_sm_cycle=ffma / sms / cycles))
        else:
            warp_loads_per_sm = 2 * 32 * iters * 8     # blocks an SM x warps x loads
            rows.append(dict(pattern=name, ms=ms, sm_mhz=mhz,
                             cycles_per_warp_load=cycles / warp_loads_per_sm))
        print(json.dumps(rows[-1]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
