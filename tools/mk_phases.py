#!/usr/bin/env python3
"""Where the decode megakernel's time goes, phase by phase, on the card.

Copies `paddle_tpu_torch/csrc/decode_megakernel.cuh` and the two sources
that build it (`decode_megakernel.cu`, seg "full"; `decode_megakernel_tp.cu`,
the tensor-parallel segments) into a temporary directory, inserts
`clock64()` reads at the phase boundaries (thread 0 of every block adds each
phase's cycles to a counter in shared memory, and every block adds its
counters to device counters when it ends), builds that copy alone with nvcc
and runs it through the port's own wrapper (`decode_megakernel`, its
library swapped for the copy) at LLaMA-7B's width: 2 layers and the head
(vocab 32000), page 64, bf16 and int8 weights, R 4 and 8 slots as
`chip_smoke.py`'s rows make them (seg "full", greedy head), and one layer
of the tp = 2 segments (qkv, tail, down) of shard 0 at R 8.

The phases: norm1, the q, k and v slabs, the wait at each grid barrier,
attention, O, norm2, gate/up, down, the final norm, the head's slabs and
its argmax (barrier and reduce). Prints each phase's cycles per block and
launch and its share, the time blocks wait at barriers included, and the
launch's time by CUDA events (the timer's reads included). In the ring
design also thread 0's cycles per block and launch inside the GEMVs' tile
loops: waiting for a tile's copy to land, issuing tiles, and the tiles
(the rest of a GEMV phase is arithmetic, the reductions and staging). The reads cost a
few instructions each and move the schedule a little: the shares are a
guide, the kernel's time is `chip_smoke.py`'s.

    python3 tools/mk_phases.py [tree]    # needs one CUDA card and nvcc

`tree` (default: this checkout) is a directory holding `chip_smoke.py` and
`paddle_tpu_torch/`, so the same tool times a parent tree unpacked with
`git archive`. The anchors of both kernel designs are known: the GEMV that
loads weights through registers (`ptt::gemv_slab` in every phase) and the
one fed by the TMA ring (`ptt::SlabRing`).
"""
import ctypes
import json
import os
import pathlib
import re
import subprocess
import sys
import tempfile

PHASES = ("norm1", "q slabs", "k slabs", "v slabs", "barrier after qkv", "attention",
          "barrier after attention", "O slabs", "barrier after O", "norm2", "gate/up slabs",
          "barrier after gate/up", "down slabs", "barrier after down", "final norm",
          "head slabs (or fold)", "head barrier + argmax",
          # inside every norm (the ring design): staging h, the sums of
          # squares and their barrier, the rsqrt and its barrier; the rest
          # of a norm (the scaling pass) stays under norm1 / norm2 / final
          "norm: stage h", "norm: sums", "norm: rsqrt")
N = len(PHASES)
# thread 0's cycles inside the GEMV's tile loop (the ring design): waiting
# for a tile's copy to land, issuing tiles (its share: every 8th), and the
# tiles
RING = ("tile wait", "tile issue", "tiles")
NR = len(RING)
QKV_CLK = "PTT_CLK(wi == P_WQ ? 1 : (wi == P_WK ? 2 : 3));"

# (anchor, replacement) per kernel design; every anchor must occur once
ANCHORS = {
    "registers": [
        ("      block_norm<T>(h, ptr<const T*>(P, P_LN1), xs, R, H, a.eps, aux);\n",
         "      block_norm<T>(h, ptr<const T*>(P, P_LN1), xs, R, H, a.eps, aux);\n"
         "      PTT_CLK(0);\n"),
        ("qkv[(size_t)i * QW + off + col] = emit_t<T>(s, sc, col);\n"
         "                                     });\n",
         "qkv[(size_t)i * QW + off + col] = emit_t<T>(s, sc, col);\n"
         "                                     });\n        " + QKV_CLK + "\n"),
        ("      grid.sync();\n\n      attention_phase<T>(a, P, xs, qkv, attn);\n",
         "      grid.sync();\n      PTT_CLK(4);\n\n      attention_phase<T>(a, P, xs, qkv, attn);\n"
         "      PTT_CLK(5);\n"),
        ("    if constexpr (kSeg == kSegFull) grid.sync();\n\n    if constexpr (kTail) {\n",
         "    if constexpr (kSeg == kSegFull) grid.sync();\n    PTT_CLK(6);\n\n"
         "    if constexpr (kTail) {\n"),
        ("residual(ptr<const float*>(P, P_SO)));\n      }\n      grid.sync();\n",
         "residual(ptr<const float*>(P, P_SO)));\n      }\n      PTT_CLK(7);\n"
         "      grid.sync();\n      PTT_CLK(8);\n"),
        ("      block_norm<T>(h, ptr<const T*>(P, P_LN2), xs, R, H, a.eps, aux);\n",
         "      block_norm<T>(h, ptr<const T*>(P, P_LN2), xs, R, H, a.eps, aux);\n"
         "      PTT_CLK(9);\n"),
        ("    if constexpr (kSeg == kSegFull) grid.sync();\n\n    if constexpr (kDown) {\n",
         "    PTT_CLK(10);\n    if constexpr (kSeg == kSegFull) grid.sync();\n    PTT_CLK(11);\n\n"
         "    if constexpr (kDown) {\n"),
        ("residual(ptr<const float*>(P, P_SD)));\n      }\n"
         "      if (l + 1 < a.n_layers || a.head_row >= 0) grid.sync();\n",
         "residual(ptr<const float*>(P, P_SD)));\n      }\n      PTT_CLK(12);\n"
         "      if (l + 1 < a.n_layers || a.head_row >= 0) grid.sync();\n      PTT_CLK(13);\n"),
        ("    block_norm<T>(h, ptr<const T*>(P, P_NF), xs, R, H, a.eps, aux);\n",
         "    block_norm<T>(h, ptr<const T*>(P, P_NF), xs, R, H, a.eps, aux);\n    PTT_CLK(14);\n"),
        ("      head_fold<T, WT>(a, xs, wh, shs, vh, red, stage);\n",
         "      head_fold<T, WT>(a, xs, wh, shs, vh, red, stage);\n      PTT_CLK(15);\n"),
        ("    __syncthreads();\n    if (tid < R) {\n      a.part_v",
         "    PTT_CLK(15);\n    __syncthreads();\n    if (tid < R) {\n      a.part_v"),
        ("      a.maxv[tid] = bv;\n    }\n", "      a.maxv[tid] = bv;\n    }\n    PTT_CLK(16);\n"),
    ],
}
# the ring design moves two anchors: the q/k/v emit and the fold's call
_RING = {
    ("qkv[(size_t)i * QW + off + col] = emit_t<T>(s, sc, col);\n"
     "                                     });\n"):
    ("qkv[(size_t)i * QW + off + col] = emit_t<T>(s, sc, col);\n"
     "                        });\n",
     "qkv[(size_t)i * QW + off + col] = emit_t<T>(s, sc, col);\n"
     "                        });\n        " + QKV_CLK + "\n"),
    "      head_fold<T, WT>(a, xs, wh, shs, vh, red, stage);\n":
    ("      head_fold<T, WT>(a, xs, wh, shs, ring, &feed, red, stage);\n",
     "      head_fold<T, WT>(a, xs, wh, shs, ring, &feed, red, stage);\n"
     "      PTT_CLK(15);\n"),
}
ANCHORS["ring"] = [_RING.get(a, (a, r)) for a, r in ANCHORS["registers"]] + [
    ("  stage_rows<T>(h, H, 0, H, H, R, xs);\n",
     "  stage_rows<T>(h, H, 0, H, H, R, xs);\n  PTT_CLK(17);\n"),
    ("  __syncthreads();\n  float* inv = aux + kWarps * kMaxRows;\n",
     "  __syncthreads();\n  PTT_CLK(18);\n  float* inv = aux + kWarps * kMaxRows;\n"),
    ("    inv[tid] = rsqrtf(s / (float)H + eps);\n  }\n  __syncthreads();\n",
     "    inv[tid] = rsqrtf(s / (float)H + eps);\n  }\n  __syncthreads();\n  PTT_CLK(19);\n"),
    ("        if (threadIdx.x % 32 == 0 && threadIdx.x / 32 == ring.used % kWarps)\n"
     "          feed_issue(a, *feed, ring, ring.used + ring.stages - 2);\n"
     "        const uint32_t tile = ring.wait_next();\n",
     "        if (threadIdx.x %% 32 == 0 && threadIdx.x / 32 == ring.used %% kWarps) {\n"
     "          const long long t0_ = clock64();\n"
     "          feed_issue(a, *feed, ring, ring.used + ring.stages - 2);\n"
     "          if (threadIdx.x == 0) mk_clk_s[%d] += clock64() - t0_;\n"
     "        }\n"
     "        const long long t1_ = clock64();\n"
     "        const uint32_t tile = ring.wait_next();\n"
     "        if (threadIdx.x == 0) {\n"
     "          mk_clk_s[%d] += clock64() - t1_;\n"
     "          mk_clk_s[%d] += 1;\n"
     "        }\n" % (N + 1, N, N + 2))]
# the kernel's first line, either design's launch bounds
KERNEL = re.compile(r"template <typename T, typename WT, int kSeg>\n"
                    r"__global__ void __launch_bounds__\((kThreads(?:, 1)?)\) "
                    r"decode_megakernel_kernel\(const PttMkArgs a\) \{\n")
BODY = ("template <typename T, typename WT, int kSeg>\n"
        "__device__ __forceinline__ void mk_body(const PttMkArgs a) {\n")
WRAPPER = """template <typename T, typename WT, int kSeg>
__global__ void __launch_bounds__(%(bounds)s) decode_megakernel_kernel(const PttMkArgs a) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < %(n)d; ++i) mk_clk_s[i] = 0;
    mk_clk_last = clock64();
  }
  mk_body<T, WT, kSeg>(a);
  if (threadIdx.x == 0) {
    for (int i = 0; i < %(n)d; ++i) atomicAdd(&g_mk_clk[i], mk_clk_s[i]);
    atomicAdd(&g_mk_clk[%(n)d], 1ull);
  }
}

"""
HEAD = """namespace {
__device__ unsigned long long g_mk_clk[%(n1)d];
__shared__ unsigned long long mk_clk_s[%(n)d];
__shared__ long long mk_clk_last;
}  // namespace
#define PTT_CLK(k) do { if (threadIdx.x == 0) { const long long now_ = clock64(); \\
  mk_clk_s[(k)] += now_ - mk_clk_last; mk_clk_last = now_; } } while (0)
""" % dict(n=N + NR, n1=N + NR + 1)
READER = """
extern "C" int %(name)s(unsigned long long* out, int reset) {
  if (reset) {
    unsigned long long z[%(n1)d] = {};
    return (int)cudaMemcpyToSymbol(g_mk_clk, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(out, g_mk_clk, sizeof(unsigned long long) * %(n1)d);
}
"""


def patched_header(src):
    for design, pairs in ANCHORS.items():
        if all(src.count(a) == 1 for a, _ in pairs):
            break
    else:
        missing = {d: [a[:60] for a, _ in p if src.count(a) != 1] for d, p in ANCHORS.items()}
        raise SystemExit(f"mk_phases: the kernel's phase anchors were not found: {missing}")
    for anchor, repl in pairs:
        src = src.replace(anchor, repl, 1)
    found = KERNEL.findall(src)
    assert len(found) == 1
    src = KERNEL.sub(BODY, src, count=1)
    tail = "template <typename T, typename WT, int kSeg>\ncudaError_t launch("
    assert src.count(tail) == 1
    src = src.replace(tail, WRAPPER % dict(n=N + NR, bounds=found[0]) + tail, 1)
    inc = '#include "common.cuh"\n'
    return design, src.replace(inc, inc + HEAD, 1)


def build(tree, tmp):
    csrc = tree / "paddle_tpu_torch" / "csrc"
    for f in csrc.glob("*.cuh"):
        (tmp / f.name).write_text(f.read_text())
    design, hdr = patched_header((csrc / "decode_megakernel.cuh").read_text())
    (tmp / "decode_megakernel.cuh").write_text(hdr)
    srcs = []
    for name, reader in (("decode_megakernel.cu", "ptt_mk_clocks_full"),
                         ("decode_megakernel_tp.cu", "ptt_mk_clocks_seg"),
                         ("runtime.cu", None)):
        text = (csrc / name).read_text()
        if reader:
            text += READER % dict(name=reader, n1=N + NR + 1)
        (tmp / name).write_text(text)
        srcs.append(tmp / name)
    nvcc = os.path.join(os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", "nvcc")
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-I", str(tmp)]
    procs = [(s, subprocess.Popen([nvcc, *flags, "-Xptxas", "-v", "-c", str(s), "-o",
                                   str(s.with_suffix(".o"))], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)) for s in srcs]
    log = ""
    for s, p in procs:
        out, _ = p.communicate()
        log += out
        if p.returncode != 0:
            raise SystemExit(f"mk_phases: nvcc failed on {s.name}:\n{out}")
    lib = tmp / "libmk_phases.so"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o",
                    str(lib), *[str(s.with_suffix(".o")) for s in srcs]], check=True)
    return design, lib, log


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("mk_phases: no CUDA card", file=sys.stderr)
        return 1
    tree = pathlib.Path(argv[0] if argv else pathlib.Path(__file__).resolve().parents[1])
    tree = tree.resolve()
    sys.path.insert(0, str(tree))
    import chip_smoke as cs
    from paddle_tpu_torch import _build
    from paddle_tpu_torch.inference.scheduler import ContinuousBatchingEngine
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops.pallas.decode_megakernel import decode_megakernel

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="mk_phases-"))
    design, lib_path, log = build(tree, tmp)
    so = ctypes.CDLL(str(lib_path))
    for name, argtypes in _build.SIGNATURES.items():
        if hasattr(so, name):
            getattr(so, name).argtypes = argtypes
            getattr(so, name).restype = ctypes.c_int
    so.ptt_error_string.argtypes = [ctypes.c_int]
    so.ptt_error_string.restype = ctypes.c_char_p
    for name in ("ptt_mk_clocks_full", "ptt_mk_clocks_seg"):
        getattr(so, name).argtypes = [ctypes.c_void_p, ctypes.c_int]
    _build._lib = so                     # the wrapper launches the timed copy
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    print(json.dumps(dict(tree=str(tree), design=design,
                          ptxas=[ln for ln in cs.ptxas_summary(log) if "megakernel" in ln])),
          flush=True)

    dev = torch.device("cuda", 0)
    cfg = LlamaConfig(hidden_size=4096, intermediate_size=11008, num_hidden_layers=2,
                      num_attention_heads=32)   # 7B width
    model = LlamaForCausalLM(cfg, device=dev, seed=11)
    reps = 5

    def timed(reader, fn):
        fn()
        torch.cuda.synchronize()
        counts = (ctypes.c_ulonglong * (N + NR + 1))()
        assert reader(counts, 1) == 0
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        assert reader(counts, 0) == 0
        blocks = counts[N + NR]                # blocks x launches
        total = sum(counts[:N])
        phases = {PHASES[k]: dict(cycles=counts[k] / blocks, share=counts[k] / total)
                  for k in range(N) if counts[k]}
        ring = {RING[k]: counts[N + k] / blocks for k in range(NR)}
        return dict(ms=a.elapsed_time(b) / reps, grid=decode_megakernel.grid,
                    cycles_per_block=total / blocks, phases=phases, ring=ring)

    for wname, quant in (("bf16", None), ("int8", "int8")):
        kw = dict(megakernel="multi", max_len=512, page_size=64, max_batch=8, quant=quant,
                  weight_dtype="bfloat16")
        one = ContinuousBatchingEngine(model, device=dev, **kw)
        for R in (4, 8):
            tok, table, lens, act = cs.topk_inputs(torch, dev, one, R, seed=12)
            h0 = one.weights["emb"][tok].to(torch.bfloat16)
            h = h0.clone()

            def step():
                h.copy_(h0)
                decode_megakernel(h, one._mk_pack, table, lens, act, head=True)

            r = timed(so.ptt_mk_clocks_full, step)
            print(json.dumps(dict(case=f"full {wname} R{R}", layers=2, head=True, **r)),
                  flush=True)
        eng = ContinuousBatchingEngine(model, tp=2, device=[dev] * 2, **kw)
        tok, table, lens, act = cs.topk_inputs(torch, dev, one, 8, seed=12)
        cs.shard_pools(one, eng)
        pk = eng._mk_packs[0]
        h0 = one.weights["emb"][tok].to(torch.bfloat16)
        h = h0.clone()
        attn = torch.zeros((8, cfg.hidden_size), dtype=torch.bfloat16, device=dev)
        act_in = torch.zeros((8, cfg.intermediate_size), dtype=torch.bfloat16, device=dev)
        segs = dict(
            qkv=lambda: decode_megakernel(h, pk, table, lens, act, layer=0, seg="qkv"),
            tail=lambda: decode_megakernel(h, pk, layer=0, seg="tail", attn_in=attn),
            down=lambda: decode_megakernel(h, pk, layer=0, seg="down", act_in=act_in))
        for seg, fn in segs.items():
            def run(fn=fn):
                h.copy_(h0)
                fn()

            r = timed(so.ptt_mk_clocks_seg, run)
            print(json.dumps(dict(case=f"tp2 {seg} {wname} R8", layers=1, head=False, **r)),
                  flush=True)
        del one, eng
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
