"""Serve LLaMA through paddle_tpu_torch's LLMEngine.

The default mode of `examples/serve_llama.py` (no scheduler, replicas or
fleet): one batch of random prompts, greedy, `generate(device_loop=True)`.
Weights are random, drawn from a seed.

    python -m paddle_tpu_torch.serve_llama --model 7b --quant int8
    python -m paddle_tpu_torch.serve_llama --model tiny --device cpu
"""
import argparse

import numpy as np
import torch

from . import resolve_device
from .inference.serving import LLMEngine
from .models.llama import LlamaConfig, LlamaForCausalLM

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
    args = ap.parse_args(argv)

    g = GEOMETRIES[args.model]
    device = resolve_device(args.device)
    # 7b: weights serve in bf16, as the reference's checkpoint-scale mode
    weight_dtype = "bfloat16" if args.model == "7b" else None
    model = LlamaForCausalLM(g["cfg"], device=device, seed=0)
    quant = None if args.quant == "none" else args.quant
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


if __name__ == "__main__":
    main()
