#!/usr/bin/env python3
"""The int8 matmul's direct GEMV build of two source trees, side by side
in one process on one card.

`tools/tree_ab.py qmm` runs each tree in its own process, so the spread
between processes (where the weights land, the card's state) enters its
differences. Here each tree builds only its int8 matmul sources in a
subprocess, and both libraries are then loaded into this process
(`ctypes.CDLL`, local symbols), so the two builds read the same weight at
the same address. For LLaMA-7B's four int8 products at m 4 and 8 (bf16 x,
seeded int8 weights), each row holds whether the two outputs are bit
equal and six device times a tree (one call in a replayed CUDA graph, the
trees in turns, either first by halves). Last, the SASS of
`qmm_gemv_kernel`'s instantiations in both libraries (`cuobjdump -sass`,
addresses and constants masked): whether each is the same.

    python3 tools/qmm_lib_ab.py chipwork/parent .   # from the repository root; one CUDA card

Both trees must hold `ptt_quantized_matmul` with the GEMV at route 0:
the form (x, w, scales, out, m, k, n, dtype, device, stream) or the one
with (route, weight map) after dtype.
"""
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

import torch

BUILD = r'''
import sys
sys.path.insert(0, ".")
from paddle_tpu_torch import _build
_all = _build.sources
_build.sources = lambda: [s for s in _all()
                          if s.name.startswith("quantized_matmul") or s.name == "runtime.cu"]
_build.SIGNATURES = {k: v for k, v in _build.SIGNATURES.items()
                     if k.startswith("ptt_quantized_matmul")}
_build.library()
print(_build.build_info()["path"])
print(len(_build.SIGNATURES["ptt_quantized_matmul"]))
'''
P, I = ctypes.c_void_p, ctypes.c_int


def load(tree):
    out = subprocess.run([sys.executable, "-c", BUILD], cwd=tree, capture_output=True,
                         text=True, check=True).stdout.split()
    path, n_args = out[-2], int(out[-1])
    if n_args not in (10, 12):
        raise SystemExit(f"{tree}: ptt_quantized_matmul takes {n_args} arguments")
    lib = ctypes.CDLL(path)
    lib.ptt_quantized_matmul.argtypes = ([P, P, P, P, I, I, I, I, I, P] if n_args == 10
                                         else [P, P, P, P, I, I, I, I, I, P, I, P])
    return dict(path=path, lib=lib, n_args=n_args)


def gemv(t, x, w, s, out):
    """The direct GEMV of tree t (no weight map), device 0, current stream."""
    m, k = x.shape
    st = P(torch.cuda.current_stream().cuda_stream)
    a = [P(x.data_ptr()), P(w.data_ptr()), P(s.data_ptr()), P(out.data_ptr()), m, k,
         w.shape[1], 1]
    a += [0, st] if t["n_args"] == 10 else [0, None, 0, st]
    code = t["lib"].ptt_quantized_matmul(*a)
    if code:
        raise RuntimeError(f"ptt_quantized_matmul returned {code}")


def graph_ms(fn, launches=20, replays=10):
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(launches):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (launches * replays)


def gemv_sass(path):
    """{instantiation: [instructions]} of qmm_gemv_kernel in the library."""
    cuda = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    tool = os.path.join(cuda, "bin", "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
    if tool is None:
        return {}
    funcs, key = {}, None
    for ln in subprocess.run([tool, "-sass", path], capture_output=True, text=True).stdout.splitlines():
        head = re.search(r"Function : (\S+)", ln)
        if head:
            name = re.search(r"qmm_gemv_kernel(\w+)", head.group(1))
            key = name.group(1) if name else None
            if key:
                funcs[key] = []
        elif key:
            ins = re.search(r"/\*[0-9a-f]{4}\*/\s+(.*?);", ln)
            if ins:
                funcs[key].append(re.sub(r"0x[0-9a-f]+", "X", ins.group(1)))
    return funcs


def main(trees):
    if len(trees) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    libs = {t: load(t) for t in trees}
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)
    for k, n in ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000)):
        wq = torch.randint(-127, 128, (k, n), generator=gen, device=dev, dtype=torch.int8)
        sc = torch.rand(n, generator=gen, device=dev) / 100
        for m in (4, 8):
            x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            outs = {t: torch.empty((m, n), dtype=torch.bfloat16, device=dev) for t in trees}
            for t in trees:
                gemv(libs[t], x, wq, sc, outs[t])
            torch.cuda.synchronize()
            a, b = (outs[t].view(torch.int16) for t in trees)
            times = {t: [] for t in trees}
            for order in (trees, trees[::-1]) * 3:
                for t in order:
                    times[t].append(graph_ms(lambda t=t: gemv(libs[t], x, wq, sc, outs[t])))
            print(json.dumps(dict(m=m, k=k, n=n, same_bits=torch.equal(a, b),
                                  device_ms={t: sorted(v) for t, v in times.items()})),
                  flush=True)
        del wq, sc
        torch.cuda.empty_cache()
    sass = [gemv_sass(libs[t]["path"]) for t in trees]
    print(json.dumps(dict(gemv_sass=[dict(instantiation=f, instructions=len(sass[0][f]),
                                          identical=sass[0][f] == sass[1].get(f))
                                     for f in sass[0]])))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
