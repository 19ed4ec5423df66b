"""Serve LLaMA through paddle_tpu_torch's engines.

Two modes of `examples/serve_llama.py`. The default: one batch of random
prompts, `LLMEngine.generate(device_loop=True)`. `--scheduler`: three
ragged requests through `ContinuousBatchingEngine`, the second sharing the
first's prompt prefix (prefix-cache hits). Greedy unless `--temperature` is
given: then every request samples (request i with seed `--seed` + i, its
own key stream), or every other one with `--sample-rotate` (a mixed
greedy / sampled batch). `--speculate T` verifies up to T - 1 drafts per
pass (`--drafter ngram|prefix`); the outputs stay those of unspeculated
serving. `--tp N` shards one engine over N devices (`--device` takes a
comma-separated list, one per shard; the same card may repeat), exact by
default, or `--tp-mode psum` with `--tp-compress int8`. Weights are random,
drawn from a seed.

    python -m paddle_tpu_torch.serve_llama --model 7b --quant int8
    python -m paddle_tpu_torch.serve_llama --scheduler --decode-block 8
    python -m paddle_tpu_torch.serve_llama --model 7b --scheduler \
        --decode-block 8 --megakernel multi
    python -m paddle_tpu_torch.serve_llama --model tiny --device cpu
    python -m paddle_tpu_torch.serve_llama --scheduler --megakernel multi \
        --decode-block 4 --temperature 0.8 --top-k 6 --top-p 0.95 --seed 42
    python -m paddle_tpu_torch.serve_llama --model 7b --scheduler \
        --decode-block 8 --megakernel multi --speculate 4 --drafter ngram
    python -m paddle_tpu_torch.serve_llama --model 7b --tp 2 \
        --device cuda:0,cuda:0 --scheduler --decode-block 8 --megakernel multi
    python -m paddle_tpu_torch.serve_llama --tp 2 --device cpu --scheduler
"""
import argparse
import warnings

import numpy as np
import torch

from . import resolve_device
from .inference.scheduler import (ContinuousBatchingEngine, EngineBusyError,
                                  RequestFailedError)
from .inference.serving import LLMEngine
from .models.llama import LlamaConfig, LlamaForCausalLM

MEGAKERNEL = {"auto": None, "off": False, "layer": "layer", "multi": "multi"}
GEOMETRIES = {
    "tiny": dict(cfg=LlamaConfig.tiny(), max_len=64, page=16, bs=2),
    "350m": dict(cfg=LlamaConfig(vocab_size=32000, hidden_size=1024,
                                 intermediate_size=2816, num_hidden_layers=16,
                                 num_attention_heads=16,
                                 max_position_embeddings=2048),
                 max_len=512, page=64, bs=4),
    "7b": dict(cfg=LlamaConfig.llama_7b(), max_len=256, page=64, bs=1),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=sorted(GEOMETRIES), default="tiny")
    ap.add_argument("--quant", choices=("none", "int8"), default="none")
    ap.add_argument("--max_new_tokens", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu; with --tp N > 1 a "
                         "comma-separated list of N devices, one per shard "
                         "(cuda:0,cuda:0 runs both shards on one card), or "
                         "cpu for every shard")
    ap.add_argument("--tp", type=int, default=1,
                    help="N > 1: tensor-parallel serving, one engine split "
                         "over N devices (heads and KV pools over heads, "
                         "column/row-parallel projections); greedy outputs "
                         "those of tp=1 in the default exact mode")
    ap.add_argument("--tp-mode", choices=["exact", "psum"], default="exact",
                    help="the tp tail: 'exact' gathers before a replicated "
                         "o/down projection; 'psum' sums row-parallel "
                         "partial products (close to tp=1, not equal)")
    ap.add_argument("--tp-compress", choices=["none", "int8"],
                    default="none",
                    help="int8-quantize the psum-mode reduce")
    ap.add_argument("--scheduler", action="store_true",
                    help="serve ragged requests through the "
                         "continuous-batching engine")
    ap.add_argument("--decode-block", type=int, default=1,
                    help="--scheduler: decode steps per fused block")
    ap.add_argument("--queue-limit", type=int, default=None,
                    help="--scheduler: bounded admission queue")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="--scheduler: default per-request deadline")
    ap.add_argument("--megakernel", choices=sorted(MEGAKERNEL),
                    default="auto",
                    help="--scheduler: decode through the megakernel, one "
                         "launch per layer or per step (auto: per layer on "
                         "CUDA where the kernel takes the model)")
    ap.add_argument("--speculate", type=int, default=0,
                    help="--scheduler: T >= 2 turns on speculative "
                         "decoding: a drafter proposes up to T-1 tokens "
                         "per verify pass, the target scores them in one "
                         "multi-token pass and accepts the agreeing "
                         "prefix on the device; outputs stay those of "
                         "unspeculated serving")
    ap.add_argument("--drafter", choices=["ngram", "prefix"],
                    default="ngram",
                    help="--speculate: 'ngram' = prompt lookup over the "
                         "request's own context; 'prefix' = continuations "
                         "walked from the prefix cache")
    ap.add_argument("--temperature", type=float, default=None,
                    help="sampled decoding: softmax temperature (unset = "
                         "greedy). With --scheduler --megakernel multi the "
                         "top-K candidates come out of the whole-step "
                         "kernel and the [batch, vocab] logits never exist")
    ap.add_argument("--top-k", type=int, default=0,
                    help="sampled decoding: keep the k most likely tokens "
                         "(0 = no cut; at most the engine's sample_k in "
                         "--scheduler mode)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="sampled decoding: nucleus cutoff (1.0 = off)")
    ap.add_argument("--seed", type=int, default=0,
                    help="sampled decoding: base seed; in --scheduler mode "
                         "request i draws from seed + i")
    ap.add_argument("--sample-rotate", action="store_true",
                    help="--scheduler: alternate sampled and greedy "
                         "requests (a mixed batch; needs --temperature)")
    args = ap.parse_args(argv)
    if args.temperature is None and (args.top_k or args.top_p != 1.0
                                     or args.seed or args.sample_rotate):
        warnings.warn(
            "--top-k/--top-p/--seed/--sample-rotate do nothing without "
            "--temperature (decoding stays greedy); set --temperature to "
            "sample", DeprecationWarning, stacklevel=1)

    g = GEOMETRIES[args.model]
    shard_devs = args.device.split(",") if args.device else None
    device = resolve_device(shard_devs[0] if shard_devs else None)
    # what the engines take: one device at tp = 1, else one per shard (a
    # single cpu covers every shard; None takes one CUDA card each)
    if shard_devs and len(shard_devs) > 1:
        args.engine_device = shard_devs
    elif args.tp == 1:
        args.engine_device = device
    else:
        args.engine_device = shard_devs[0] if shard_devs else None
    args.tp_kw = dict(tp=args.tp, tp_mode=args.tp_mode,
                      tp_compress=None if args.tp_compress == "none"
                      else args.tp_compress)
    # 7b: weights serve in bf16, as the reference's checkpoint-scale mode
    weight_dtype = "bfloat16" if args.model == "7b" else None
    model = LlamaForCausalLM(g["cfg"], device=device, seed=0)
    quant = None if args.quant == "none" else args.quant
    if args.scheduler:
        return serve_scheduler(args, g, model, quant, weight_dtype, device)
    engine = LLMEngine(model, max_len=g["max_len"], page_size=g["page"],
                       max_batch=g["bs"], quant=quant,
                       weight_dtype=weight_dtype, device=args.engine_device,
                       **args.tp_kw)
    del model     # the engine holds its own snapshot
    if device.type == "cuda":
        torch.cuda.empty_cache()

    rng = np.random.RandomState(0)
    prompts = rng.randint(0, g["cfg"].vocab_size,
                          (g["bs"], args.prompt_len)).astype(np.int64)
    sample_kw = {}
    if args.temperature is not None:
        sample_kw = dict(do_sample=True, temperature=args.temperature,
                         top_k=args.top_k, top_p=args.top_p, seed=args.seed)
    out = engine.generate(prompts, max_new_tokens=args.max_new_tokens,
                          device_loop=True, **sample_kw)
    print(f"model={args.model} quant={args.quant} tp={args.tp} "
          f"prompt={prompts.shape} -> generated={out.shape}")
    print("first sequence tail:", out[0, -args.max_new_tokens:].tolist())


def sampling_for(args, i):
    """The sampling spec of demo request i (None: greedy)."""
    if args.temperature is None or (args.sample_rotate and i % 2 == 1):
        return None
    return {"do_sample": True, "temperature": args.temperature,
            "top_k": args.top_k, "top_p": args.top_p, "seed": args.seed + i}


def serve_scheduler(args, g, model, quant, weight_dtype, device):
    """Three ragged requests; request 1 is the first page of request 0's
    prompt and arrives once request 0 has published it."""
    engine = ContinuousBatchingEngine(
        model, max_len=g["max_len"], page_size=g["page"],
        max_batch=max(2, g["bs"]), quant=quant, weight_dtype=weight_dtype,
        queue_limit=args.queue_limit, default_deadline_ms=args.deadline_ms,
        decode_block=args.decode_block,
        megakernel=MEGAKERNEL[args.megakernel],
        speculate=args.speculate or None, drafter=args.drafter,
        device=args.engine_device, **args.tp_kw)
    del model
    if device.type == "cuda":
        torch.cuda.empty_cache()
    rng = np.random.RandomState(0)
    page = g["page"]
    base = rng.randint(0, g["cfg"].vocab_size, (page + 4,)).astype(np.int64)
    # request 1 is request 0's first page: it shares that page and copies
    # it on its first write (its last prompt token re-runs there)
    prompts = [base, base[:page],
               rng.randint(0, g["cfg"].vocab_size, (5,)).astype(np.int64)]
    submitted = [(0, engine.add_request(prompts[0], args.max_new_tokens,
                                        sampling=sampling_for(args, 0)))]
    while engine.status(submitted[0][1]) in ("queued", "prefill"):
        engine.step()            # request 0 publishes its prompt pages
    for i, p in enumerate(prompts[1:], start=1):
        try:
            submitted.append((i, engine.add_request(
                p, args.max_new_tokens, sampling=sampling_for(args, i))))
        except EngineBusyError as e:
            print(f"  request {i} shed by backpressure: {e}")
    engine.drain()
    h = engine.health()
    fused = (f"{h['fused_blocks']} fused blocks ({h['chained_blocks']} "
             f"chained), " if args.decode_block > 1 else "")
    if h["speculate"]:
        fused += (f"speculate={h['speculate']}/{h['drafter']}: "
                  f"{h['spec_emitted']} tokens in {h['spec_passes']} verify "
                  f"passes ({h['spec_tokens_per_pass']:.2f}/pass, accept "
                  f"{h['spec_accept_rate']:.2f}), ")
    tp = (f", tp={h['tp']} {h['tp_mode']}"
          + (f" {h['tp_compress']}" if h["tp_compress"] else "")
          if h["tp"] > 1 else "")
    print(f"model={args.model} quant={args.quant} scheduler "
          f"(megakernel {h['megakernel']}{tp}): "
          f"{len(submitted)} ragged requests in {h['steps']} steps "
          f"({h['prefill_steps']} prefill / {h['decode_steps']} decode), "
          f"{fused}{h['prefix_hits']} prefix-page hits, "
          f"{h['cow_copies']} copy-on-writes, "
          f"{h['sampled_requests']} sampled")
    for i, u in submitted:
        try:
            o = engine.result(u)
            print(f"  request {i}: {prompts[i].size} -> {o.size} tokens, "
                  f"tail {o[-4:].tolist()}")
        except RequestFailedError as e:
            print(f"  request {i}: failed — {e.failure}")
    print(f"  health: {h['done']} done / {h['failed']} failed, "
          f"{h['pages_free']}/{h['pages_total']} pages free, "
          f"{h['prefix_pages']} held by the prefix cache")


if __name__ == "__main__":
    main()
