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
- `f32`: the f32 rows alone of `flash` and `mask` (the f32 builds of both
  flash kernels: the causal rows, the dropout rows with their bit gates,
  the mask rows with BERT-base's f32 rows timed) and the mask bit gates;
- `gpt`: `train_llama.run_config("gpt3_1p3b")` for 1 warmup + 3 timed
  steps plus one profiled step with exact launch counts, then the GPT
  card-against-CPU parity phase;
- `bert`: `train_bert.run_bert("base")` in f32 and bf16 for 1 warmup + 2
  timed steps plus one profiled step with exact launch counts, then the
  BERT card-against-CPU parity phase;
- `tp`: the decode megakernel's tensor-parallel segment rows
  (`check_megakernel_tp`) and the tp = 1 greedy rows beside them;
- `tp_path`: LLaMA-7B's width at `CUT_LAYERS` layers, the cb_stream
  through `tp_cb_runs` (tp = 2, both shards on the card), after the tp = 1
  runs it is held against (`tp_cut_runs`, phase 6's tp leg); then the
  tp = 2 card-against-CPU parity row.
- `qmm`: the int8 matmul's rows (every route: the decode GEMV on both
  builds, the tensor-core build at the prefill and verify widths, the
  tiled build off the main path), with the ring-equals-direct and
  tc-rows-independent-of-m bit gates;
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
  `width_rows` runs the row checks alone; they include the premise of the
  op chain's single product row count R = 32: each row of an R-row
  product (bf16 and int8) and of RMSNorm against the same row moved to
  other positions of the call, and RMSNorm at 1, 8, 16 and 32 rows and in
  a verify pass's [8, 4, H] shape against the 32-row call.
- `width_price`: the op chain's ms per decode micro-step and per verify
  pass on the 7B cb_stream (K=8, bf16 and int8, speculate off and 4); run
  from another tree's root to price that tree (parent and change in
  turns, separate processes).
- `router`: `chip_smoke.py`'s phase 17 alone (multi-replica serving over
  one shared bf16 model of LLaMA-7B's width and `CUT_LAYERS` layers:
  route, failover, prefix, disagg, adapters,
  hot_swap), with the phase's seconds, its non-zero launch counts and the
  peak memory.
- `fleet`: `chip_smoke.py`'s phase 18 alone (the process fleet: route,
  kill9, disagg, autoscale over worker processes of phase 17's model),
  after the
  single engine's ids it is held against (built and dropped in this
  process first); the workers' non-zero launch counts.
- `plan`: `chip_smoke.py`'s phase 19 alone (the cost-model search over
  LLaMA-7B on the checked-in H100 calibration, the searched spec built
  and run on the cb_path stream, its probes, dense-KV generate), after the
  ids it is held against: phase 4's bf16 static engine on the 4 x 12
  prompts and cb_path's runs of the knobs the search ranks (built and
  dropped in this process first).
- `dp`: `chip_smoke.py`'s phase 20 alone (Fleet data parallelism: two
  spawned ranks on the card train BERT-base under fleet.distributed_model
  over gloo, held bit for bit to each other and to one process training
  the whole batch; the verb set on CUDA tensors, one RPC each way), with
  the phase's seconds and the ranks' non-zero launch counts.
- `tp_train`: `chip_smoke.py`'s phase 21 alone (tensor-parallel training:
  two spawned model-parallel ranks on the card train LLaMA at 7B's width
  with 2 layers at mp 2 over gloo, in f32 and in bf16, held to one
  process training the dense model from the same weights), with the
  phase's seconds and the ranks' non-zero launch counts (`tp` above is
  the decode megakernel's tensor-parallel rows).

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


def qmm(dev):
    yield from (dict(phase="qmm", **r) for r in C.check_quantized_matmul(torch, dev))


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


def f32(dev):
    # chip_smoke's case tables cut to their f32 rows for this run
    cut = dict(FLASH_CASES=-1, FLASH_BWD_CASES=-1, FLASH_DROPOUT_CASES=-1, MASK_CASES=5)
    saved = {name: getattr(C, name) for name in cut}
    try:
        for name, i in cut.items():
            setattr(C, name, tuple(c for c in saved[name] if c[i] == "float32"))
        yield from flash(dev)
        yield from mask(dev)
    finally:
        for name, cases in saved.items():
            setattr(C, name, cases)


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
    out = C.tp_cut_runs(torch, dev, {})
    yield from out["runs"]
    yield dict(peak_gb=out["peak_gb"], seconds=out["seconds"], layers=out["layers"], ok=True)
    yield from (r for r in C.parity_cb_2layer(torch, dev) if r["tp"] == 2)


WIDTH_PRODUCTS = (("q", 4096, 4096), ("k", 4096, 4096), ("v", 4096, 4096),
                  ("o", 4096, 4096), ("gate", 4096, 11008), ("up", 4096, 11008),
                  ("down", 11008, 4096), ("head", 4096, 32000))
# (phase, full width, widths): max_batch 8 x chunk 128, 8 x T 4, and the
# 8 rows of a decode step or of the prefill's head
WIDTH_CASES = (("prefill", 1024, (128, 256, 512, 1024)),
               ("verify", 32, tuple(4 * w for w in range(1, 9))),
               ("decode, head", 8, tuple(range(1, 9))))
# R = 4 x max_batch = 32, the op chain's one row count of every decode-step
# and verify-pass product: the rows rolled by these counts (a row moved to
# every kind of position in the call), and reversed
R_ROWS, R_SHIFTS = 32, (1, 3, 4, 5, 13, 16, 31)


def position_rows(prod, x):
    """{shift: rows of prod(rolled x) that differ from prod(x) at the same
    row}, and "reversed"."""
    ref = prod(x)
    out = {str(s): int((prod(torch.roll(x, s, 0)).roll(-s, 0) != ref).any(-1).sum())
           for s in R_SHIFTS}
    out["reversed"] = int((prod(x.flip(0)).flip(0) != ref).any(-1).sum())
    return out


def width_rows(dev):
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
            # the R rule's premise: a row's bits in an R-row call do not
            # depend on where the row sits in it
            x = torch.randn((R_ROWS, k), generator=g, device=dev).to(bf16)
            moved = position_rows(prod, x)
            yield dict(probe="width_position", product=name, k=k, n=n, weights=weights,
                       rows=R_ROWS, rows_differing_by_shift=moved,
                       ok=not any(moved.values()))
        del wq, sc, wb
        torch.cuda.empty_cache()
    # the norms of a decode step (R slots x 1 row) and of a verify pass
    # (8 slots x T 4 rows): RMSNorm's row reduction at 1, 8 and 32 rows and
    # under the same shifts
    from paddle_tpu_torch.ops.pallas.rms_norm import rms_rows
    w = torch.randn(4096, generator=g, device=dev).to(bf16)
    x = torch.randn((R_ROWS, 4096), generator=g, device=dev).to(bf16)
    ref = rms_rows(x, w, 1e-6)
    differ = {str(m): int((rms_rows(x[:m], w, 1e-6) != ref[:m]).any(-1).sum())
              for m in (1, 8, 16, 32)}
    shaped = int((rms_rows(x.reshape(8, 4, 4096), w, 1e-6).reshape(R_ROWS, -1) != ref)
                 .any(-1).sum())
    moved = position_rows(lambda t: rms_rows(t, w, 1e-6), x)
    yield dict(probe="width_rms", rows=R_ROWS, rows_differing=differ,
               verify_shape_rows_differing=shaped, rows_differing_by_shift=moved,
               ok=not any(differ.values()) and not shaped and not any(moved.values()))


def width_price(dev):
    """The op chain's cost per decode micro-step and per verify pass on the
    7B cb_stream (K=8, bf16 and int8, unspeculated and at speculate=4,
    n-gram drafts), each stream once after one warm-up stream. Run it
    from a tree's root (`cd chipwork/parent && python3
    ../../tools/card_check.py width_price`) to price that tree: parent,
    change, change, parent in turns."""
    import os
    from paddle_tpu_torch.inference.scheduler import ContinuousBatchingEngine
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.llama_7b()
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    geom = dict(page_size=64, max_len=1024, max_batch=8, prefill_chunk=128,
                prefix_cache=True, weight_dtype="bfloat16", device=dev)
    prompts, budgets = C.cb_stream(cfg)
    streams = {}
    for run, spec, quant in (("K=8 bf16", None, None), ("K=8 int8", None, "int8"),
                             ("spec K=8 bf16", 4, None), ("spec K=8 int8", 4, "int8")):
        eng = ContinuousBatchingEngine(model, decode_block=8, megakernel=False,
                                       speculate=spec, quant=quant, **geom)
        C.drive_cb(torch, eng, prompts[:8], budgets[:8])          # warm-up
        eng = ContinuousBatchingEngine(model, decode_block=8, megakernel=False,
                                       speculate=spec, quant=quant, **geom)
        outs, wall, ms = C.drive_cb(torch, eng, prompts, budgets)
        streams[run] = outs
        del eng
        torch.cuda.empty_cache()
        ref = streams.get(run.replace("spec ", ""))
        yield dict(probe="width_price", tree=os.getcwd(), run=run, wall_s=wall,
                   ms_per_step=ms, unit="ms per verify pass" if spec else
                   "ms per decode micro-step",
                   ids_equal_unspeculated=None if spec is None else all(
                       (a == b).all() for a, b in zip(outs, ref)), ok=True)
    del model
    torch.cuda.empty_cache()



def width(dev):
    from paddle_tpu_torch.inference.scheduler import ContinuousBatchingEngine
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    yield from width_rows(dev)
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


def router(dev):
    t = time.perf_counter()
    model, geom = C.router_model(torch, dev)
    rows, launches, _ = C.cb_router(torch, model, geom)
    yield from (dict(phase="router", **r) for r in rows)
    del model
    torch.cuda.empty_cache()
    yield dict(phase="router", seconds=time.perf_counter() - t,
               launches={k: v for k, v in launches.items() if v},
               peak_gb=torch.cuda.max_memory_allocated() / 1e9, ok=True)


def fleet(dev):
    t = time.perf_counter()
    ref = C.fleet_reference(torch, C.CUT_LAYERS)
    ref_s = time.perf_counter() - t
    rows, launches = C.cb_fleet(torch, dev, ref)
    yield from (dict(phase="fleet", **r) for r in rows)
    yield dict(phase="fleet", seconds=time.perf_counter() - t, reference_s=ref_s,
               launches={k: v for k, v in launches.items() if v},
               parent_peak_gb=torch.cuda.max_memory_allocated() / 1e9, ok=True)


def plan(dev):
    import numpy as np
    from paddle_tpu_torch.cost_model import Calibration, search_plan, spec_from_fleet_dict
    from paddle_tpu_torch.inference.scheduler import ContinuousBatchingEngine
    from paddle_tpu_torch.inference.serving import LLMEngine
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    t = time.perf_counter()
    cfg = LlamaConfig.llama_7b()
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    eng = LLMEngine(model, max_len=512, page_size=64, max_batch=4, weight_dtype="bfloat16",
                    device=dev)
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (4, 12)).astype(np.int64)
    eng.generate(ids, max_new_tokens=C.GEN_NEW, device_loop=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.generate(ids, max_new_tokens=C.GEN_NEW, device_loop=True)
    total = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng.generate(ids, max_new_tokens=1, device_loop=True)
    prefill = time.perf_counter() - t0
    held_path = dict(prompts=ids, ids=out, decode_ms_per_step=1e3 * (total - prefill) / 32)
    del eng
    # cb_path's runs of the knobs the search ranks first (and the first
    # with held ids), on the cb_stream
    prompts, budgets = C.cb_stream(cfg)
    ranked = search_plan(cfg, 1, mode="serving", base_spec=spec_from_fleet_dict(C.fleet_spec()),
                         calib=Calibration.load(), top_k=None, prompt_len=C.PLAN_PROMPT,
                         gen_tokens=round(float(np.mean(budgets))))
    knobs = [k for k in C.PLAN_HELD if k in {(r.plan.megakernel, r.plan.decode_block)
                                             for r in ranked[:1]}]
    if not knobs:
        knobs = [next((r.plan.megakernel, r.plan.decode_block) for r in ranked
                      if (r.plan.megakernel, r.plan.decode_block) in C.PLAN_HELD)]
    held_cb = {}
    for mk, K in knobs:
        eng = ContinuousBatchingEngine(model, decode_block=K, megakernel=mk, page_size=64,
                                       max_len=1024, max_batch=8, prefill_chunk=128,
                                       prefix_cache=True, weight_dtype="bfloat16", device=dev)
        held_cb[C.PLAN_HELD[(mk, K)]] = C.drive_cb(torch, eng, prompts, budgets)[0]
        del eng
    del model
    C.release(torch)
    held_s = time.perf_counter() - t
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    t = time.perf_counter()
    rows, launches = C.plan_phase(torch, dev, smi, held_cb, held_path)
    yield from (dict(phase="plan", **r) for r in rows)
    yield dict(phase="plan", seconds=time.perf_counter() - t, held_s=held_s,
               launches={k: v for k, v in launches.items() if v},
               peak_gb=torch.cuda.max_memory_allocated() / 1e9, ok=True)


def dp(dev):
    t = time.perf_counter()
    rows, launches = C.dp_phase(torch, dev)
    yield from (dict(phase="dp", **r) for r in rows)
    yield dict(phase="dp", seconds=time.perf_counter() - t,
               launches={k: v for k, v in launches.items() if v}, ok=True)


def tp_train(dev):
    t = time.perf_counter()
    rows, launches = C.tp_phase(torch, dev)
    yield from (dict(phase="tp_train", **r) for r in rows)
    yield dict(phase="tp_train", seconds=time.perf_counter() - t,
               launches={k: v for k, v in launches.items() if v}, ok=True)


PHASES = dict(qmm=qmm, ragged=ragged, flash=flash, mask=mask, f32=f32, gpt=gpt, bert=bert, tp=tp,
              tp_path=tp_path, width=width, width_rows=width_rows, width_price=width_price,
              router=router, fleet=fleet, plan=plan, dp=dp, tp_train=tp_train)


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
                    or "paged" in l or "qmm" in l))
    # nvcc's own lines for the wgmma build and the staged page walks
    # (warnings such as wgmma serialization show here)
    log = (_build.build_log() or "").split("\n== ")
    print("\n".join(b for b in log if b.startswith(("flash_attention_tc.cu",
                                                      "flash_attention.cu",
                                                      "flash_attention_bwd.cu",
                                                      "paged_attention.cu",
                                                      "ragged_paged_attention.cu",
                                                      "quantized_matmul.cu",
                                                      "quantized_matmul_tc.cu"))))
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
