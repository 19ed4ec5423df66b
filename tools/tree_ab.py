#!/usr/bin/env python3
"""Time one probe of several source trees on one card, in turns.

Each tree (a directory holding `chip_smoke.py` and `paddle_tpu_torch/`, for
example a parent commit unpacked with `git archive <commit> | tar -x -C
<dir>` into a git-ignored directory) runs the probe in its own process,
which builds its kernels and prints one JSON line. The trees run in the
order given, then again in reverse, so drift on the card shows as a
difference between a tree's two rows. Probes:

- `megakernel`: the build's ptxas registers and spills of the decode
  megakernel, `chip_smoke.check_megakernel`'s greedy rows (bf16 and int8,
  ms and one "layer" launch's ms) and, where the tree has them,
  `check_megakernel_topk`'s fold rows and `check_megakernel_verify`'s
  speculative verify rows (tq = 4); and a digest of the outputs' bytes of
  seg "full" launches on seeded inputs (bf16 and int8 weights, 8 slots:
  the greedy whole step, the top-8 fold, one layer), so equal digests
  across trees mean bit-equal outputs.
- `flash`: the flash kernels' launches: the causal forward and backward,
  with and without dropout, on seeded inputs at the training and serving
  shapes of `chip_smoke.py`'s rows (the forward also at llama350m's and
  llama1p3b's shapes, and an f32 dropout row), and the backward of
  BERT-base's masked non-causal row; each row's ms (CUDA events) and a
  digest of its outputs' bytes, so equal digests across trees mean
  bit-equal outputs.
- `mask`: the forward's mask rows: BERT-base's padding mask (bf16, with
  and without dropout, and f32) and a causal launch with the mask.
- `f32`: the f32 builds of both flash kernels (`csrc/flash_attention.cu`,
  `csrc/flash_attention_bwd.cu`), forward and backward each: BERT-base's
  padding-mask rows (b 32, s 512, h 12, d 64, non-causal) with and
  without dropout 0.1, d 128 causal (2 x 1024 x 16 x 128), the f32 LLaMA
  parity shape (causal, 4 x 256 x 16 x 64) and chip_smoke's
  `d128_mask_dropout` case (2 x 300 x 4 x 128, padding mask, dropout
  0.1), on seeded inputs. Each row: ms by CUDA events around back-to-back
  wrapper calls (the backward's delta and partial sum included), device
  ms of one call from a replayed CUDA graph, and a digest of the outputs'
  bytes; the BERT rows also the SM clock (`nvidia-smi`, sampled) while
  they run back to back. With the build's ptxas lines (registers,
  spills) and the static SASS mix (FFMA, LDS, all instructions) of every
  f32 instantiation.
- `ragged`: the ragged kernel's chunked-prefill entry at `chip_smoke.py`'s
  main and GQA rows (bf16, 8 and 4 slots of 128-token chunks, d 128, page
  64), with the build's ragged ptxas lines; each row's ms and a digest of
  its output.
- `paged`: the decode kernel (#4) and the ragged kernel's per-page build
  (#5 at tq = 1, #5v the verify entry): `chip_smoke.check_paged_attention`'s
  "mha" row (bf16, 4 slots, 32 heads of d 128, page 64) and
  `check_spec_verify`'s main row (bf16, 8 slots, T = 4), then every case
  of `tq1_identity` (#4 and #5 at tq = 1) and of `verify_identity` (#5v)
  (bf16 and f32, page 64 and 8, MHA and a GQA group of 4), on the same
  seeded inputs as those functions. Each row: ms by CUDA events around
  back-to-back wrapper calls (as `chip_smoke.time_ms`, the host's issue
  included), device ms of one launch from a CUDA graph of 20 launches
  replayed (the host out of the way), the walk (`paged_route`, "direct"
  on a tree without it) and its stage count, and a digest of the output's
  bytes: equal digests across trees mean bit-equal outputs. With the
  build's ptxas lines of both kernels.

- `serving`: what the decode kernel's time does to the serving path: at
  LLaMA-7B's full width and depth (random weights, seed 0), the static
  engine's decode ms per step and prefill ms (bf16, 4 x 12 and 4 x 300
  prompts, 16 new tokens, device loop; as `chip_smoke.serve_7b` times
  them), and `chip_smoke.cb_stream`'s 12 requests through the
  continuous-batching engine at decode_block 8 in bf16 on the op chain
  (32 decode-kernel launches a micro-step) and on the "multi" megakernel
  (none: its row shows the card's and the host's drift between turns):
  ms per decode micro-step and generated tokens/s.

    python3 tools/tree_ab.py flash chipwork/parent .     # needs one CUDA card
    python3 tools/tree_ab.py mask chipwork/parent .
    python3 tools/tree_ab.py f32 chipwork/parent .
    python3 tools/tree_ab.py ragged chipwork/parent .
    python3 tools/tree_ab.py paged chipwork/parent .
    python3 tools/tree_ab.py serving chipwork/parent .
"""
import json
import subprocess
import sys

MEGAKERNEL = r'''
import json, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from paddle_tpu_torch import _build
t = time.perf_counter()
_build.library()
ptx = [l for l in cs.ptxas_summary(_build.build_log() or "") if "megakernel" in l]
dev = torch.device("cuda", 0)
out = dict(build_s=time.perf_counter() - t, ptxas=ptx, greedy=[], fold=[], verify=[])
for r in cs.check_megakernel(torch, dev):
    if "ms" in r:
        out["greedy"].append(dict(weights=r["weights"], ms=r["ms"],
                                  layer_ms=r["layer_ms"], ok=r["ok"]))
if hasattr(cs, "check_megakernel_topk"):
    for r in cs.check_megakernel_topk(torch, dev, ptx):
        if "ms" in r:
            out["fold"].append(dict(weights=r["weights"], R=r["R"], K=r["head_k"],
                                    ms=r["ms"], greedy_ms=r["greedy_ms"],
                                    library_ms=r["library_ms"], ok=r["ok"]))
if hasattr(cs, "check_megakernel_verify"):
    for r in cs.check_megakernel_verify(torch, dev, ptx):
        out["verify"].append(dict(weights=r["weights"], ms=r["ms"],
                                  sequential_ms=r["sequential_ms"], ok=r["ok"]))
import hashlib
from paddle_tpu_torch.inference.scheduler import ContinuousBatchingEngine
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops.pallas.decode_megakernel import decode_megakernel
model = LlamaForCausalLM(LlamaConfig(hidden_size=4096, intermediate_size=11008,
                                     num_hidden_layers=2, num_attention_heads=32),
                         device=dev, seed=11)
out["digests"] = {}
for quant in (None, "int8"):
    eng = ContinuousBatchingEngine(model, megakernel="multi", max_len=512, page_size=64,
                                   max_batch=8, quant=quant, weight_dtype="bfloat16",
                                   device=dev)
    tok, table, lens, act = cs.topk_inputs(torch, dev, eng, 8, seed=12)
    h0 = eng.weights["emb"][tok].to(torch.bfloat16)
    res = (decode_megakernel(h0.clone(), cs.clone_pack(eng._mk_pack), table, lens, act,
                             head=True)
           + decode_megakernel(h0.clone(), cs.clone_pack(eng._mk_pack), table, lens, act,
                               head=True, head_k=8)
           + (decode_megakernel(h0.clone(), cs.clone_pack(eng._mk_pack), table, lens, act,
                                layer=0),))
    torch.cuda.synchronize()
    h = hashlib.sha256()
    for x in res:
        h.update(x.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    out["digests"][quant or "bf16"] = h.hexdigest()[:16]
    del eng
    torch.cuda.empty_cache()
print("RESULT " + json.dumps(out), flush=True)
'''

# the timing and digest helpers of the `flash` and `ragged` probes
TIMED = r'''
import hashlib, json, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from paddle_tpu_torch import _build
t = time.perf_counter()
_build.library()
dev = torch.device("cuda", 0)
out = dict(build_s=time.perf_counter() - t, rows=[])


def ms(fn, iters, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def digest(ts):
    h = hashlib.sha256()
    for x in ts:
        h.update(x.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


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
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (launches * replays)
'''

FLASH = TIMED + r'''
from paddle_tpu_torch.ops.pallas.flash_attention import (flash_attention_bwd,
                                                         flash_attention_fwd)
out["ptxas"] = [l for l in cs.ptxas_summary(_build.build_log() or "") if "flash" in l
                or "bwd" in l]


# (kind, b, s, h, d, s_true, dropout_p, dtype): chip_smoke's causal forward
# rows (serving prefill, llama350m's and llama1p3b's shapes), the backward
# at llama350m's and llama1p3b's shapes, the dropout rows at gpt3_1p3b's,
# and an f32 dropout forward
for kind, b, s, h, d, s_true, p, dt in (
        ("fwd", 4, 320, 32, 128, 300, 0.0, torch.bfloat16),
        ("fwd", 32, 1024, 16, 64, None, 0.0, torch.bfloat16),
        ("fwd", 8, 1024, 16, 128, None, 0.0, torch.bfloat16),
        ("bwd", 32, 1024, 16, 64, None, 0.0, torch.bfloat16),
        ("bwd", 8, 1024, 16, 128, None, 0.0, torch.bfloat16),
        ("fwd", 8, 1024, 16, 128, None, 0.1, torch.bfloat16),
        ("bwd", 8, 1024, 16, 128, None, 0.1, torch.bfloat16),
        ("fwd", 2, 1024, 16, 128, None, 0.1, torch.float32)):
    g = torch.Generator(device=dev).manual_seed(21)
    q, k, v, do = (torch.randn((b, s, h, d), generator=g, device=dev).to(dt)
                   for _ in range(4))
    seed = 1234567 if p > 0 else None
    scale = d ** -0.5
    o, lse = flash_attention_fwd(q, k, v, True, scale, s_true, p, seed)
    if kind == "fwd":
        fn = lambda: flash_attention_fwd(q, k, v, True, scale, s_true, p, seed)
        res, iters = (o, lse), 20
    else:
        fn = lambda: flash_attention_bwd(q, k, v, o, lse, do, True, scale, s_true, None, p, seed)
        res, iters = fn(), 5
    torch.cuda.synchronize()
    out["rows"].append(dict(kind=kind, b=b, s=s, h=h, d=d, dropout_p=p, dtype=str(dt),
                            ms=ms(fn, iters), digest=digest(res)))
    del q, k, v, do, o, lse, res
    torch.cuda.empty_cache()
# BERT-base's masked, non-causal backward (chip_smoke's bert_base mask row)
g = torch.Generator(device=dev).manual_seed(12)
b, s, h, d = 32, 512, 12, 64
q, k, v, do = (torch.randn((b, s, h, d), generator=g, device=dev).to(torch.bfloat16)
               for _ in range(4))
mask = cs.make_mask(torch, dev, "key_padding", b, s, h, torch.bfloat16, g)
o, lse = flash_attention_fwd(q, k, v, False, d ** -0.5, None, 0.0, None, mask)
fn = lambda: flash_attention_bwd(q, k, v, o, lse, do, False, d ** -0.5, None, mask)
res = fn()
torch.cuda.synchronize()
out["rows"].append(dict(kind="bwd_masked", b=b, s=s, h=h, d=d, dropout_p=0.0,
                        ms=ms(fn, 5), digest=digest(res)))
print("RESULT " + json.dumps(out), flush=True)
'''

MASK = TIMED + r'''
from paddle_tpu_torch.ops.pallas.flash_attention import flash_attention_fwd
# chip_smoke's forward mask rows: BERT-base's [b, 1, 1, s] padding mask
# (bf16, with dropout 0.1, f32) and causal plus the mask
for case, b, s, h, d, dt, causal, p in (
        ("bert_base", 32, 512, 12, 64, torch.bfloat16, False, 0.0),
        ("bert_base_dropout", 32, 512, 12, 64, torch.bfloat16, False, 0.1),
        ("bert_base_f32", 32, 512, 12, 64, torch.float32, False, 0.0),
        ("causal_mask", 4, 512, 12, 64, torch.bfloat16, True, 0.0)):
    g = torch.Generator(device=dev).manual_seed(11)
    q, k, v = (torch.randn((b, s, h, d), generator=g, device=dev).to(dt) for _ in range(3))
    mask = cs.make_mask(torch, dev, "key_padding", b, s, h, dt, g)
    seed = 2468 if p > 0 else None
    fn = lambda: flash_attention_fwd(q, k, v, causal, d ** -0.5, None, p, seed, mask)
    res = fn()
    torch.cuda.synchronize()
    out["rows"].append(dict(case=case, dtype=str(dt), ms=ms(fn, 10), digest=digest(res)))
    del q, k, v, mask, res
    torch.cuda.empty_cache()
print("RESULT " + json.dumps(out), flush=True)
'''

F32 = TIMED + r'''
import os, re, shutil, subprocess
from paddle_tpu_torch.ops.pallas.flash_attention import (flash_attention_bwd,
                                                         flash_attention_fwd)
f32_names = ("flash_fwd_kernel", "flash_bwd_kernel")
out["ptxas"] = [l for l in cs.ptxas_summary(_build.build_log() or "")
                if l.startswith(f32_names)]
tool = os.path.join(os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", "cuobjdump")
sass = subprocess.run([tool, "-sass", _build.build_info()["path"]], capture_output=True,
                      text=True).stdout if os.path.exists(tool) else ""
mix, cur = {}, None
for ln in sass.splitlines():
    m = re.search(r"Function : (\S+)", ln)
    if m:
        cur = m.group(1) if any(n in m.group(1) for n in f32_names) else None
        if cur:
            mix[cur] = dict(all=0, FFMA=0, LDS=0, STS=0, BAR=0, SHFL=0, MUFU=0)
        continue
    m = re.match(r"\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", ln)
    if cur and m:
        mix[cur]["all"] += 1
        if m.group(1) in mix[cur]:
            mix[cur][m.group(1)] += 1
out["sass"] = mix
f32 = torch.float32


def sm_mhz(fn, seconds=0.6):
    """The SM clock (nvidia-smi, sampled) while fn() runs back to back."""
    import threading, time
    clocks, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                                "--format=csv,noheader,nounits"], capture_output=True,
                               text=True).stdout.split()
            if r:
                clocks.append(float(r[0]))
            stop.wait(0.1)

    th = threading.Thread(target=sample)
    th.start()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    stop.set()
    th.join()
    return sum(clocks) / len(clocks) if clocks else None


# (name, kind, b, s, h, d, causal, mask, dropout_p)
for name, kind, b, s, h, d, causal, masked, p in (
        ("bert_base_f32", "fwd", 32, 512, 12, 64, False, True, 0.0),
        ("bert_base_f32", "bwd", 32, 512, 12, 64, False, True, 0.0),
        ("bert_base_f32_dropout", "fwd", 32, 512, 12, 64, False, True, 0.1),
        ("bert_base_f32_dropout", "bwd", 32, 512, 12, 64, False, True, 0.1),
        ("d128_causal", "fwd", 2, 1024, 16, 128, True, False, 0.0),
        ("d128_causal", "bwd", 2, 1024, 16, 128, True, False, 0.0),
        ("llama_parity", "fwd", 4, 256, 16, 64, True, False, 0.0),
        ("llama_parity", "bwd", 4, 256, 16, 64, True, False, 0.0),
        ("d128_mask_dropout", "fwd", 2, 300, 4, 128, False, True, 0.1),
        ("d128_mask_dropout", "bwd", 2, 300, 4, 128, False, True, 0.1)):
    g = torch.Generator(device=dev).manual_seed(22)
    q, k, v, do = (torch.randn((b, s, h, d), generator=g, device=dev) for _ in range(4))
    mask = cs.make_mask(torch, dev, "key_padding", b, s, h, f32, g) if masked else None
    seed = 2468 if p > 0 else None
    scale = d ** -0.5
    o, lse = flash_attention_fwd(q, k, v, causal, scale, None, p, seed, mask)
    if kind == "fwd":
        fn = lambda: flash_attention_fwd(q, k, v, causal, scale, None, p, seed, mask)
        res, iters = (o, lse), 20
    else:
        fn = lambda: flash_attention_bwd(q, k, v, o, lse, do, causal, scale, None, mask, p,
                                         seed)
        res, iters = fn(), 10
    torch.cuda.synchronize()
    row = dict(case=name, kind=kind, b=b, s=s, h=h, d=d, causal=causal, dropout_p=p,
               ms=ms(fn, iters), device_ms=graph_ms(fn, 10, 5), digest=digest(res))
    if name == "bert_base_f32":
        row["sm_mhz"] = sm_mhz(fn)
    out["rows"].append(row)
    del q, k, v, do, o, lse, res, mask
    torch.cuda.empty_cache()
print("RESULT " + json.dumps(out), flush=True)
'''
RAGGED = TIMED + r'''
from paddle_tpu_torch.ops.pallas.paged_attention import ragged_paged_attention
out["ptxas"] = [l for l in cs.ptxas_summary(_build.build_log() or "") if "ragged" in l]
# chip_smoke.check_ragged's main and GQA rows
for name, b, tq, h, h_kv, d, p, mp, starts, ctx, active in (
        ("main", 8, 128, 32, 32, 128, 64, 16, [0, 128, 384, 640, 0, 256, 512, 0],
         [128, 256, 512, 690, 128, 384, 640, 128], [1, 1, 1, 1, 1, 1, 1, 0]),
        ("gqa rep=4", 4, 128, 32, 8, 128, 64, 16, [0, 200, 64, 700],
         [128, 328, 100, 828], [1, 1, 1, 1])):
    q, kp, vp, table = cs.ragged_inputs(torch, dev, b, tq, h, h_kv, d, p, mp,
                                        torch.bfloat16, seed=4)
    st, cl, act = (torch.tensor(x, dtype=torch.int32, device=dev)
                   for x in (starts, ctx, active))
    fn = lambda: ragged_paged_attention(q, kp, vp, table, cl, st, active=act)
    res = fn()
    torch.cuda.synchronize()
    out["rows"].append(dict(case=name, ms=ms(fn, 50), digest=digest([res])))
print("RESULT " + json.dumps(out), flush=True)
'''
PAGED = TIMED + r'''
import math
from paddle_tpu_torch.ops.pallas import paged_attention as pa
out["ptxas"] = [l for l in cs.ptxas_summary(_build.build_log() or "")
                if "paged" in l or "ragged_kernel" in l or "ragged_staged" in l]


def walk(dt, d, p):
    if not hasattr(pa, "paged_route"):
        return "direct", 0
    return pa.paged_route(dt, d, p), pa.paged_stage_plan(dt, d, p)[0]


def row(case, dt, d, p, fn):
    res = fn()
    torch.cuda.synchronize()
    route, stages = walk(dt, d, p)
    out["rows"].append(dict(case=case, dtype=str(dt), p=p, route=route, stages=stages,
                            ms=ms(fn, 100, warmup=20), device_ms=graph_ms(fn),
                            digest=digest([res])))


bf16, f32 = torch.bfloat16, torch.float32
# chip_smoke.check_paged_attention's "mha" row (#4)
lens, active = [300, 257, 311, 290], [1, 1, 1, 0]
q, kp, vp, table, ln, act = cs.paged_inputs(torch, dev, 4, 32, 32, 128, 64, lens, active,
                                            bf16, seed=2)
row("#4 mha", bf16, 128, 64, lambda: pa.paged_attention(q, kp, vp, table, ln, active=act))
# chip_smoke.check_spec_verify's main row (#5v)
T = cs.SPEC_T
q, kp, vp, table = cs.ragged_inputs(torch, dev, 8, T, 32, 32, 128, 64, 16, bf16, seed=7)
ln = torch.tensor(cs.SPEC_LENS, dtype=torch.int32, device=dev)
act = torch.tensor(cs.SPEC_ACTIVE, dtype=torch.int32, device=dev)
row("#5v main", bf16, 128, 64,
    lambda: pa.spec_verify_attention(q, kp, vp, table, ln, active=act))
# chip_smoke.tq1_identity's and verify_identity's cases, their inputs
for kind in ("tq1", "verify"):
    for dt in (bf16, f32):
        for p in (64, 8):
            for h, h_kv in ((32, 32), (32, 8)):
                if kind == "tq1":
                    lens, active, seed, extra = [300, 257, 1, 290, 129], [1, 1, 1, 0, 1], 5, 0
                else:
                    lens, active, seed, extra = [300, 257, 0, 290, 129], [1, 1, 1, 0, 1], 6, T
                b, d, mp = len(lens), 128, -(-(max(lens) + extra) // p)
                g = torch.Generator(device=dev).manual_seed(seed)
                shape = (b, h, d) if kind == "tq1" else (b, T, h, d)
                q = torch.randn(shape, generator=g, device=dev).to(dt)
                kp = torch.randn((b * mp, p, h_kv, d), generator=g, device=dev).to(dt)
                vp = torch.randn((b * mp, p, h_kv, d), generator=g, device=dev).to(dt)
                table = torch.randperm(b * mp, generator=g, device=dev)
                table = table.reshape(b, mp).to(torch.int32)
                ln = torch.tensor(lens, dtype=torch.int32, device=dev)
                ac = torch.tensor(active, dtype=torch.int32, device=dev)
                name = f"{dt} p{p} h_kv{h_kv}"
                if kind == "tq1":
                    row("#4 tq1 case " + name, dt, d, p,
                        lambda: pa.paged_attention(q, kp, vp, table, ln, active=ac))
                    row("#5 tq=1 case " + name, dt, d, p,
                        lambda: pa.ragged_paged_attention(q[:, None], kp, vp, table, ln,
                                                          ln - 1, active=ac))
                else:
                    row("#5v verify case " + name, dt, d, p,
                        lambda: pa.spec_verify_attention(q, kp, vp, table, ln, active=ac))
print("RESULT " + json.dumps(out), flush=True)
'''
SERVING = r'''
import json, sys, time
sys.path.insert(0, ".")
import numpy as np
import torch
import chip_smoke as cs
from paddle_tpu_torch import _build
from paddle_tpu_torch.inference.scheduler import ContinuousBatchingEngine
from paddle_tpu_torch.inference.serving import LLMEngine
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
_build.library()
dev = torch.device("cuda", 0)
cfg = LlamaConfig.llama_7b()
model = LlamaForCausalLM(cfg, device=dev, seed=0)
out = dict(static=[], cb=[])
eng = LLMEngine(model, max_len=512, page_size=64, max_batch=4, weight_dtype="bfloat16",
                device=dev)
rng = np.random.RandomState(0)
n_new = 16
for name, t0_len in (("4x12", 12), ("4x300", 300)):
    ids = rng.randint(0, cfg.vocab_size, (4, t0_len)).astype(np.int64)
    n_loop = min(-(-(n_new - 1) // 32) * 32, eng.max_len - t0_len - 1)
    eng.generate(ids, max_new_tokens=n_new, device_loop=True)
    torch.cuda.synchronize()
    t = time.perf_counter()
    eng.generate(ids, max_new_tokens=n_new, device_loop=True)
    torch.cuda.synchronize()
    total = time.perf_counter() - t
    t = time.perf_counter()
    eng.generate(ids, max_new_tokens=1, device_loop=True)
    torch.cuda.synchronize()
    prefill = time.perf_counter() - t
    out["static"].append(dict(prompts=name, decode_ms_per_step=1e3 * (total - prefill) / n_loop,
                              prefill_ms=1e3 * prefill))
del eng
torch.cuda.empty_cache()
prompts, budgets = cs.cb_stream(cfg)
for name, mk in (("op chain K=8 bf16", False), ("multi K=8 bf16", "multi")):
    eng = ContinuousBatchingEngine(model, decode_block=8, megakernel=mk, page_size=64,
                                   max_len=1024, max_batch=8, prefill_chunk=128,
                                   prefix_cache=True, weight_dtype="bfloat16", device=dev)
    outs, wall, dec_ms = cs.drive_cb(torch, eng, prompts, budgets)
    gen = int(sum(o.size - p.size for o, p in zip(outs, prompts)))
    out["cb"].append(dict(run=name, ms_per_decode_microstep=dec_ms,
                          generated_tokens_per_s=gen / wall))
    del eng
    torch.cuda.empty_cache()
print("RESULT " + json.dumps(out), flush=True)
'''
PROBES = dict(megakernel=MEGAKERNEL, flash=FLASH, mask=MASK, f32=F32, ragged=RAGGED,
              paged=PAGED, serving=SERVING)


def main(argv):
    if len(argv) < 2 or argv[0] not in PROBES:
        print(__doc__, file=sys.stderr)
        return 2
    probe, trees = PROBES[argv[0]], argv[1:]
    ok = True
    for tree in list(trees) + list(reversed(trees)):
        p = subprocess.run([sys.executable, "-c", probe], cwd=tree,
                           capture_output=True, text=True)
        line = next((ln for ln in p.stdout.splitlines()
                     if ln.startswith("RESULT ")), None)
        r = json.loads(line[7:]) if line else dict(error=p.stderr[-2000:])
        ok &= line is not None
        print(json.dumps(dict(tree=tree, **r)), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
