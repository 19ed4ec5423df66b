#!/usr/bin/env python3
"""A short card check of chosen `chip_smoke.py` phases.

Builds the kernels, prints the card's name and power limit and the flash
kernels' ptxas lines, then runs the phases named on the command line, in
the order given. One JSON line per row; the last line says whether every
gate held. It is the quick first call after a change to a flash kernel or
to a training path; `chip_smoke.py` is the whole check. Phases:

- `ragged`: the decode kernel's rows (with the dense-cache wrapper's), the
  ragged kernel's rows (the chunked-prefill entry on its tensor-core
  build, the per-page build's f32 row), the tq = 1 identity with the
  decode kernel and the verify entry's rows, each staged walk against its
  direct walk;
- `flash`: the flash rows without a mask (the causal forward, the backward
  at the llama350m, llama1p3b / gpt3_1p3b shapes and the small f32 rows,
  both dropout branches);
- `mask`: the mask and non-causal rows and the mask bit gates;
- `gpt`: `train_llama.run_config("gpt3_1p3b")` for 1 warmup + 3 timed
  steps plus one profiled step with exact launch counts, then the GPT
  card-against-CPU parity phase;
- `bert`: `train_bert.run_bert("base")` in f32 and bf16 for 1 warmup + 2
  timed steps plus one profiled step with exact launch counts, then the
  BERT card-against-CPU parity phase;
- `tp`: the decode megakernel's tensor-parallel segment rows
  (`check_megakernel_tp`) and the tp = 1 greedy rows beside them;
- `tp_path`: LLaMA-7B at full width and depth, the cb_stream through
  `tp_cb_runs` (tp = 2, both shards on the card), after the tp = 1 runs
  it is held against; then the tp = 2 card-against-CPU parity row.
- `width`: whether a row of the op chain's products depends on how many
  rows share the product (cuBLAS picks its kernel by the row count; the
  int8 matmul takes its GEMV at m <= 8). LLaMA-7B's products (q, k, v, o,
  gate, up, down, the head), bf16 and int8 weights, on seeded inputs: each
  row of an M-row product against the same row of the full-width product,
  bit for bit, at the prefill widths M = 128, 256, 512, 1024 (full 8 x
  128), the verify widths M = 4 w (full 8 x 4) and the decode (and
  prefill head) widths M = w (full 8), w = 1..8; and the same rows moved
  one slot down the full product. Then the cost of running the op chain
  at the full width: the 7B cb_stream's wall with the padding on and off,
  in turns (op chain K=8 and K=1, and at speculate=4 in bf16 and int8).

    python3 tools/card_check.py ragged flash mask bert   # from the repository root; needs one CUDA card
"""
import json
import subprocess
import sys
import time

sys.path.insert(0, ".")

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from paddle_tpu_torch import _build  # noqa: E402


def ragged(dev):
    for name, fn in (("paged_attention", C.check_paged_attention),
                     ("ragged_paged_attention", C.check_ragged),
                     ("spec_verify_attention", C.check_spec_verify)):
        for r in fn(torch, dev):
            yield dict(kernel=name, **r)


def flash(dev):
    for name, fn in (("flash_attention_fwd", C.check_flash),
                     ("flash_attention_bwd", C.check_flash_bwd),
                     ("fwd_dropout", C.check_flash_dropout),
                     ("bwd_dropout", C.check_flash_bwd_dropout)):
        for r in fn(torch, dev):
            yield dict(kernel=name, **r)


def mask(dev):
    for name, fn in (("fwd_masked", C.check_flash_masked),
                     ("bwd_masked", C.check_flash_bwd_masked),
                     ("mask_gates", C.flash_mask_gates)):
        for r in fn(torch, dev):
            yield dict(kernel=name, **r)


def gpt(dev):
    yield from C.train_path(torch, dev, (("gpt3_1p3b", 1, 3, C.GPT_TRAIN_RUNS[0][3]),))[0]
    yield from C.gpt_train_parity(torch, dev)


def bert(dev):
    C.BERT_TRAIN_RUNS = tuple((dt, 1, 2) for dt, _, _ in C.BERT_TRAIN_RUNS)
    yield from C.bert_train_path(torch, dev)[0]
    yield from C.bert_train_parity(torch, dev)


def tp(dev):
    ptx = C.ptxas_summary(_build.build_log() or "")
    for r in C.check_megakernel_tp(torch, dev, ptx):
        yield dict(kernel="decode_megakernel_tp", **r)


def tp_path(dev):
    from paddle_tpu_torch.inference.scheduler import ContinuousBatchingEngine
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.llama_7b()
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    geom = dict(page_size=64, max_len=1024, max_batch=8, prefill_chunk=128,
                prefix_cache=True, weight_dtype="bfloat16", device=dev)
    prompts, budgets = C.cb_stream(cfg)
    specs = C.sampled_specs(len(prompts))
    streams = {}
    for ref in sorted({r[6] for r in C.TP_RUNS}):
        mk = "multi" if "multi" in ref else "layer" if "layer" in ref else False
        eng = ContinuousBatchingEngine(model, decode_block=8, megakernel=mk,
                                       quant="int8" if "int8" in ref else None,
                                       sample_k=8, **geom)
        streams[ref] = C.drive_cb(torch, eng, prompts, budgets,
                                  specs if ref.startswith("sampled") else None)[0]
        del eng
        torch.cuda.empty_cache()
    out = C.tp_cb_runs(torch, model, geom, prompts, budgets, streams, {})
    del model
    torch.cuda.empty_cache()
    yield from out["runs"]
    yield dict(peak_gb=out["peak_gb"], seconds=out["seconds"], ok=True)
    yield from (r for r in C.parity_cb_2layer(torch, dev) if r["tp"] == 2)


WIDTH_PRODUCTS = (("q", 4096, 4096), ("k", 4096, 4096), ("v", 4096, 4096),
                  ("o", 4096, 4096), ("gate", 4096, 11008), ("up", 4096, 11008),
                  ("down", 11008, 4096), ("head", 4096, 32000))
# (phase, full width, widths): max_batch 8 x chunk 128, 8 x T 4, and the
# 8 rows of a decode step or of the prefill's head
WIDTH_CASES = (("prefill", 1024, (128, 256, 512, 1024)),
               ("verify", 32, tuple(4 * w for w in range(1, 9))),
               ("decode, head", 8, tuple(range(1, 9))))


def width(dev):
    from paddle_tpu_torch.inference.scheduler import ContinuousBatchingEngine
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops.pallas.quantized_matmul import quantize_weights, quantized_matmul
    bf16 = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(17)
    for name, k, n in WIDTH_PRODUCTS:
        w = torch.randn((k, n), generator=g, device=dev) * k ** -0.5
        wq, sc = quantize_weights(w)
        wb = w.to(bf16)
        del w
        for weights, prod in (("bf16", lambda x: x @ wb),
                              ("int8", lambda x: quantized_matmul(x, wq, sc))):
            for phase, full, widths in WIDTH_CASES:
                x = torch.randn((full, k), generator=g, device=dev).to(bf16)
                ref = prod(x)
                differ = {str(m): int((prod(x[:m]) != ref[:m]).any(-1).sum()) for m in widths}
                shift = full // 8     # one slot's rows
                moved = prod(torch.roll(x, shift, 0)).roll(-shift, 0)
                yield dict(probe="width", product=name, k=k, n=n, weights=weights, phase=phase,
                           full_rows=full, rows_differing=differ,
                           moved_rows_differing=int((moved != ref).any(-1).sum()), ok=True)
        del wq, sc, wb
        torch.cuda.empty_cache()

    # the cost of the full width on the 7B stream, padding on and off in turns
    cfg = LlamaConfig.llama_7b()
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    geom = dict(page_size=64, max_len=1024, max_batch=8, prefill_chunk=128,
                prefix_cache=True, weight_dtype="bfloat16", device=dev)
    prompts, budgets = C.cb_stream(cfg)
    full = ContinuousBatchingEngine._at_full_width
    try:
        for run, K, spec, quant in (("K=8 bf16", 8, 0, None), ("K=1 bf16", 1, 0, None),
                                    ("spec=4 K=8 bf16", 8, 4, None),
                                    ("spec=4 K=8 int8", 8, 4, "int8")):
            walls, outs = {True: [], False: []}, {}
            for pad in (True, False, False, True):
                ContinuousBatchingEngine._at_full_width = (full if pad else lambda self: False)
                eng = ContinuousBatchingEngine(model, decode_block=K, megakernel=False,
                                               speculate=spec or None, quant=quant, **geom)
                o, wall, _ = C.drive_cb(torch, eng, prompts, budgets)
                walls[pad].append(wall)
                outs[pad] = o
                del eng
                torch.cuda.empty_cache()
            on, off = (sum(walls[p]) / 2 for p in (True, False))
            yield dict(probe="width_cost", run=run, wall_s_padded=walls[True],
                       wall_s_unpadded=walls[False], ms_per_stream=1e3 * (on - off),
                       ids_equal=all((a == b).all() for a, b in zip(outs[True], outs[False])),
                       ok=True)
    finally:
        ContinuousBatchingEngine._at_full_width = full
    del model
    torch.cuda.empty_cache()


PHASES = dict(ragged=ragged, flash=flash, mask=mask, gpt=gpt, bert=bert, tp=tp, tp_path=tp_path,
              width=width)


def main(names):
    if not names or any(n not in PHASES for n in names):
        print(__doc__, file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    _build.library()
    print(json.dumps(dict(build_s=time.perf_counter() - t0)))
    print("\n".join(l for l in C.ptxas_summary(_build.build_log() or "")
                    if "flash" in l or "megakernel" in l or "bwd" in l or "ragged" in l
                    or "paged" in l))
    # nvcc's own lines for the wgmma build and the staged page walks
    # (warnings such as wgmma serialization show here)
    log = (_build.build_log() or "").split("\n== ")
    print("\n".join(b for b in log if b.startswith(("flash_attention_tc.cu",
                                                      "paged_attention.cu",
                                                      "ragged_paged_attention.cu"))))
    sass = C.sass_mma_counts(_build.build_info()["path"])
    print(json.dumps(dict(tensor_core_sass=sass, ok=C.tc_sass_ok(sass))))
    ok = C.tc_sass_ok(sass)
    for n in names:
        for r in PHASES[n](dev):
            print(json.dumps(r), flush=True)
            ok &= r["ok"]
    print(json.dumps(dict(elapsed_s=time.perf_counter() - t0, ok=ok)))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
