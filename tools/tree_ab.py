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
- `ragged`: the ragged kernel's chunked-prefill entry at `chip_smoke.py`'s
  main and GQA rows (bf16, 8 and 4 slots of 128-token chunks, d 128, page
  64), with the build's ragged ptxas lines; each row's ms and a digest of
  its output.

    python3 tools/tree_ab.py flash chipwork/parent .     # needs one CUDA card
    python3 tools/tree_ab.py mask chipwork/parent .
    python3 tools/tree_ab.py ragged chipwork/parent .
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


def ms(fn, iters):
    for _ in range(3):
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
PROBES = dict(megakernel=MEGAKERNEL, flash=FLASH, mask=MASK, ragged=RAGGED)


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
