#!/usr/bin/env python3
"""Where the f32 flash backward's time goes, phase by phase, on the card.

Copies `paddle_tpu_torch/csrc/flash_attention_bwd.cu` into a temporary
directory, inserts `clock64()` reads at the boundaries of the query-tile
loop's phases (lane 0 of every warp adds each phase's cycles to per-warp
counters in shared memory, and every warp adds them to device counters at
the end), builds that copy alone with nvcc and launches its C entry on
BERT-base's f32 mask row (b 32, s 512, h 12, d 64, a [b, 1, 1, s] padding
mask, non-causal), as `chip_smoke.py`'s `bert_base_f32` case makes it.
Prints the cycles of each phase per warp and query tile, and its share.
The reads cost a few instructions each and move the schedule a little:
the shares are a guide, the kernel's time is `chip_smoke.py`'s.

    python3 tools/bwd_phases.py        # needs one CUDA card and nvcc
"""
import ctypes
import json
import math
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "paddle_tpu_torch" / "csrc"
# (anchor line in the source, phase that ends there); the clock is read
# after the anchor line
PHASES = (
    ("    __syncthreads();  // this tile's stage (and K, V) landed", "wait + barrier 1"),
    ("    dot_tile(sp, Qt, Ks);", "S = Q K^T"),
    ("      p_tile([&](int, int row, int col) { return mask.at(bi, hh, row, col); });",
     "P, P_v written"),
    ("    dot_tile(dp, dOt, Vs);", "dP = dO V^T"),
    ("            make_float4(ds[4 * jc], ds[4 * jc + 1], ds[4 * jc + 2], ds[4 * jc + 3]);\n    }",
     "dS written"),
    ("    __syncthreads();  // P and dS of every pair are in place", "barrier 2"),
    ("    // this key tile's dQ partial: dQ[q, f] = sum_key dS[q, key] K[key, f]", "dV, dK"),
    ("    __syncthreads();  // every thread is done with P, dS and this stage", "dQ + barrier 3"),
)
TOP = "    const int st = (qt - qt0) & 1, q_start = qt * kBQ;"


def patched_source():
    src = (CSRC / "flash_attention_bwd.cu").read_text()
    n = len(PHASES)
    head = ("#define PTT_CLK(k) do { if ((threadIdx.x & 31) == 0) { "
            "const long long now_ = clock64(); clk_s[(threadIdx.x >> 5) * %d + (k)] += "
            "now_ - clk_last; clk_last = now_; } } while (0)\n"
            "__device__ unsigned long long g_clk[%d];\n" % (n, n + 1))
    src = src.replace('#include "mma.cuh"\n', '#include "mma.cuh"\n' + head, 1)
    decl = "  extern __shared__ __align__(16) float smem[];"
    src = src.replace(decl, decl + (
        "\n  __shared__ unsigned long long clk_s[(kThreads / 32) * %d];"
        "\n  for (int i = threadIdx.x; i < (kThreads / 32) * %d; i += kThreads) clk_s[i] = 0;"
        "\n  long long clk_last = 0;") % (n, n), 1)
    assert TOP in src
    src = src.replace(TOP, TOP + "\n    if ((threadIdx.x & 31) == 0) clk_last = clock64();", 1)
    for k, (anchor, _) in enumerate(PHASES):
        assert src.count(anchor) == 1, anchor
        src = src.replace(anchor, anchor + "\n    PTT_CLK(%d);" % k, 1)
    tail = "  cp_async_wait<0>();\n\n#pragma unroll\n  for (int t = 0; t < 4; ++t) {\n    const int key"
    assert src.count(tail) == 1
    src = src.replace(tail, (
        "  if ((threadIdx.x & 31) == 0) {\n"
        "    for (int k = 0; k < %d; ++k) atomicAdd(&g_clk[k], clk_s[(threadIdx.x >> 5) * %d + k]);\n"
        "    atomicAdd(&g_clk[%d], (unsigned long long)(qt_end - qt0));\n"
        "  }\n") % (n, n, n) + tail, 1)
    src += ("\nextern \"C\" int ptt_bwd_phase_clocks(unsigned long long* out, int reset) {\n"
            "  if (reset) { unsigned long long z[%d] = {}; "
            "return (int)cudaMemcpyToSymbol(g_clk, z, sizeof(z)); }\n"
            "  return (int)cudaMemcpyFromSymbol(out, g_clk, sizeof(unsigned long long) * %d);\n}\n"
            ) % (n + 1, n + 1)
    return src


def main():
    import torch
    if not torch.cuda.is_available():
        print("bwd_phases: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from paddle_tpu_torch.ops.pallas import flash_attention as fa
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="bwd_phases-"))
    for name in ("common.cuh", "mma.cuh"):
        shutil.copy(CSRC / name, tmp / name)
    (tmp / "bwd.cu").write_text(patched_source())
    nvcc = os.path.join(os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", "nvcc")
    lib = tmp / "libbwd.so"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-I", str(tmp), "-o", str(lib),
                    str(tmp / "bwd.cu")], check=True)
    so = ctypes.CDLL(str(lib))
    from paddle_tpu_torch import _build
    so.ptt_flash_attention_bwd.argtypes = _build.SIGNATURES["ptt_flash_attention_bwd"]
    so.ptt_bwd_phase_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    dev = torch.device("cuda", 0)
    b, s, h, d = 32, 512, 12, 64
    g = torch.Generator(device=dev).manual_seed(12)
    q, k, v, do = (torch.randn((b, s, h, d), generator=g, device=dev) for _ in range(4))
    mask = cs.make_mask(torch, dev, "key_padding", b, s, h, torch.float32, g)
    scale = d ** -0.5
    o, lse = fa.flash_attention_fwd(q, k, v, False, scale, None, 0.0, None, mask)
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    _, part = fa.flash_bwd_route(torch.float32, b, s, h, d)
    dq_part = torch.empty(part, device=dev)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    m = mask.float().expand(b, h, s, s)
    args = ([ctypes.c_void_p(t.data_ptr()) for t in (q, k, v, do, lse, delta, dq_part)]
            + [part[0]] + [ctypes.c_void_p(t.data_ptr()) for t in (dk, dv)]
            + [ctypes.c_void_p(m.data_ptr()), *m.stride(), b, s, h, d, s, 0, scale, 0, 0, 0,
               0, 1.0, 0, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)])
    counts = (ctypes.c_ulonglong * (len(PHASES) + 1))()
    assert so.ptt_flash_attention_bwd(*args) == 0
    torch.cuda.synchronize()
    assert so.ptt_bwd_phase_clocks(counts, 1) == 0
    for _ in range(5):
        assert so.ptt_flash_attention_bwd(*args) == 0
    torch.cuda.synchronize()
    assert so.ptt_bwd_phase_clocks(counts, 0) == 0
    tiles = counts[len(PHASES)] / 8          # block-tiles (8 warps a block added theirs)
    warp_tiles = tiles * 8
    total = sum(counts[:len(PHASES)])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    for kk, (_, name) in enumerate(PHASES):
        print(json.dumps(dict(phase=name, cycles_per_warp_tile=counts[kk] / warp_tiles,
                              share=counts[kk] / total)))
    ref = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, False, scale, None, 0.0, None, mask)
    err = max(float((a - r).abs().max()) for a, r in zip((dq_part.sum(0), dk, dv), ref))
    print(json.dumps(dict(cycles_per_warp_tile=total / warp_tiles, block_tiles=tiles,
                          max_abs_err=err, finite=math.isfinite(err))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
