"""Serve LLaMA through paddle_tpu_torch's engines.

Two modes of `examples/serve_llama.py`. The default: one batch of random
prompts, greedy, `LLMEngine.generate(device_loop=True)`. `--scheduler`:
three ragged requests through `ContinuousBatchingEngine`, the second
sharing the first's prompt prefix (prefix-cache hits), greedy. Weights are
random, drawn from a seed.

    python -m paddle_tpu_torch.serve_llama --model 7b --quant int8
    python -m paddle_tpu_torch.serve_llama --scheduler --decode-block 8
    python -m paddle_tpu_torch.serve_llama --model 7b --scheduler \
        --decode-block 8 --megakernel multi
    python -m paddle_tpu_torch.serve_llama --model tiny --device cpu
"""
import argparse

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
                    help="cuda (the default) or cpu")
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
    args = ap.parse_args(argv)

    g = GEOMETRIES[args.model]
    device = resolve_device(args.device)
    # 7b: weights serve in bf16, as the reference's checkpoint-scale mode
    weight_dtype = "bfloat16" if args.model == "7b" else None
    model = LlamaForCausalLM(g["cfg"], device=device, seed=0)
    quant = None if args.quant == "none" else args.quant
    if args.scheduler:
        return serve_scheduler(args, g, model, quant, weight_dtype, device)
    engine = LLMEngine(model, max_len=g["max_len"], page_size=g["page"],
                       max_batch=g["bs"], quant=quant,
                       weight_dtype=weight_dtype, device=device)
    del model     # the engine holds its own snapshot
    if device.type == "cuda":
        torch.cuda.empty_cache()

    rng = np.random.RandomState(0)
    prompts = rng.randint(0, g["cfg"].vocab_size,
                          (g["bs"], args.prompt_len)).astype(np.int64)
    out = engine.generate(prompts, max_new_tokens=args.max_new_tokens,
                          device_loop=True)
    print(f"model={args.model} quant={args.quant} "
          f"prompt={prompts.shape} -> generated={out.shape}")
    print("first sequence tail:", out[0, -args.max_new_tokens:].tolist())


def serve_scheduler(args, g, model, quant, weight_dtype, device):
    """Three ragged greedy requests; request 1 is the first page of
    request 0's prompt and arrives once request 0 has published it."""
    engine = ContinuousBatchingEngine(
        model, max_len=g["max_len"], page_size=g["page"],
        max_batch=max(2, g["bs"]), quant=quant, weight_dtype=weight_dtype,
        queue_limit=args.queue_limit, default_deadline_ms=args.deadline_ms,
        decode_block=args.decode_block,
        megakernel=MEGAKERNEL[args.megakernel], device=device)
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
    submitted = [(0, engine.add_request(prompts[0], args.max_new_tokens))]
    while engine.status(submitted[0][1]) in ("queued", "prefill"):
        engine.step()            # request 0 publishes its prompt pages
    for i, p in enumerate(prompts[1:], start=1):
        try:
            submitted.append((i, engine.add_request(p, args.max_new_tokens)))
        except EngineBusyError as e:
            print(f"  request {i} shed by backpressure: {e}")
    engine.drain()
    h = engine.health()
    fused = (f"{h['fused_blocks']} fused blocks ({h['chained_blocks']} "
             f"chained), " if args.decode_block > 1 else "")
    print(f"model={args.model} quant={args.quant} scheduler "
          f"(megakernel {h['megakernel']}): "
          f"{len(submitted)} ragged requests in {h['steps']} steps "
          f"({h['prefill_steps']} prefill / {h['decode_steps']} decode), "
          f"{fused}{h['prefix_hits']} prefix-page hits, "
          f"{h['cow_copies']} copy-on-writes")
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
