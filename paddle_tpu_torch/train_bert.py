"""Pretrain BERT (masked LM) for a few steps: the reference's config-2 loop
(`BertForMaskedLM`, `loss.backward()`, `AdamW.step()`) on one device.

The model is `BertForMaskedLM(BertConfig.base())` (vocab 30522, hidden
768, 12 layers, 12 heads, d 64, ffn 3072, 512 positions; ~110M
parameters) or `BertConfig.tiny()`, random weights from `seed`, in
training mode (hidden and attention dropout 0.1, every draw from the
global generator, seeded by `seed`). One batch from
`numpy.random.RandomState(0)`, repeated every step: true lengths drawn in
[s / 4, s] with `attention_mask` 0 past them, two `token_type_ids`
segments (the second half of each true length is segment 1), and about
15% of the true tokens labelled (the rest -100). `AdamW(lr,
weight_decay=0.01)`, with `multi_precision=True` for bf16 parameters.

It prints one JSON line: ms per step, tokens/s (over b x s positions),
peak device memory and MFU = tokens/s x (6 N + 12 L H s) / 989e12
(non-causal attention over all s positions; N counts every parameter) on
a card; on the CPU the device metrics are null. `--profile` runs one more
step under `torch.profiler` (`train_llama.profile_step`).

    python -m paddle_tpu_torch.train_bert --config base --dtype bfloat16 --profile
    python -m paddle_tpu_torch.train_bert --config tiny --device cpu
"""
import argparse
import json
import time

import numpy as np
import torch

from . import resolve_device
from .framework import random as frnd
from .models.bert import BertConfig, BertForMaskedLM
from .optimizer import AdamW
from .train_llama import H100_BF16_FLOPS_PER_S, profile_step

CONFIGS = {
    "base": dict(model={}, bs=32, seq=512, steps=5, warmup=2),
    "tiny": dict(model={}, bs=4, seq=64, steps=5, warmup=2),
}


def mlm_batch(cfg, bs, seq, seed=0):
    """(input_ids, token_type_ids, attention_mask, labels), int64 numpy
    [bs, seq], from RandomState(seed)."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(seq // 4, seq + 1, size=bs)
    ids = rng.randint(0, cfg.vocab_size, (bs, seq)).astype(np.int64)
    pos = np.arange(seq)[None, :]
    real = pos < lens[:, None]
    am = real.astype(np.int64)
    tt = (real & (pos >= lens[:, None] // 2)).astype(np.int64)
    picked = real & (rng.rand(bs, seq) < 0.15)
    labels = np.where(picked, ids, -100).astype(np.int64)
    return ids, tt, am, labels


def model_flops_per_token(cfg, n_params, seq):
    """6 N dense plus non-causal attention 12 L H s (model flops only)."""
    return 6 * n_params + 12 * cfg.num_hidden_layers * cfg.hidden_size * seq


def build(config, dtype, device, seed=0, lr=1e-4, **model_kw):
    """(model, AdamW) of the configuration on `device` in `dtype`."""
    cfg = getattr(BertConfig, config)(**model_kw)
    model = BertForMaskedLM(cfg, device=device, seed=seed)
    dt = getattr(torch, dtype)
    if dt != torch.float32:
        model = model.to(dt)
    opt = AdamW(lr, parameters=model.named_parameters(), weight_decay=0.01,
                multi_precision=dt != torch.float32)
    return model, opt


def run_bert(config="base", dtype="float32", steps=None, warmup=None,
             device=None, seed=0, profile=False, lr=1e-4, **model_kw):
    """Build the model and optimizer on `device` (CUDA by default), run
    `warmup` then `steps` timed steps on the repeated batch, and return a
    dict of the measurements and every step's loss. `profile` (on a card)
    runs one more step under the profiler. `model_kw` overrides the
    configuration's fields."""
    spec = CONFIGS[config]
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    steps = spec["steps"] if steps is None else steps
    warmup = spec["warmup"] if warmup is None else warmup
    bs, seq = spec["bs"], spec["seq"]
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    frnd.seed(seed)
    model, opt = build(config, dtype, dev, seed, lr, **model_kw)
    cfg = model.config
    n_params = sum(p.numel() for p in model.parameters())
    batch = [torch.from_numpy(a).to(dev) for a in mlm_batch(cfg, bs, seq)]
    ids, tt, am, labels = batch

    def step():
        loss = model(ids, tt, am, labels=labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    losses = [step() for _ in range(warmup)]
    sync()
    t0 = time.perf_counter()
    losses += [step() for _ in range(steps)]
    sync()
    dt = time.perf_counter() - t0
    tokens_per_s = bs * seq * steps / dt if steps else None
    prof = None
    if profile and on_card and steps:
        prof = profile_step(lambda: losses.append(step()), 1e3 * dt / steps)
    flops = model_flops_per_token(cfg, n_params, seq)
    return dict(
        config=config, dtype=dtype, device=str(dev),
        device_name=torch.cuda.get_device_name(dev) if on_card else "cpu",
        n_params=n_params, num_hidden_layers=cfg.num_hidden_layers,
        batch_size=bs, seq=seq, warmup=warmup, steps=steps,
        labelled=int((labels >= 0).sum()),
        ms_per_step=1e3 * dt / steps if steps else None,
        tokens_per_s=tokens_per_s,
        mfu=(tokens_per_s * flops / H100_BF16_FLOPS_PER_S
             if on_card and steps else None),
        peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9 if on_card else None,
        losses=[float(x) for x in losses], profile=prof)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", choices=sorted(CONFIGS), default="base")
    ap.add_argument("--dtype", choices=["float32", "bfloat16"],
                    default="float32")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--warmup", type=int, default=None)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--profile", action="store_true",
                    help="one more step under torch.profiler (on a card)")
    args = ap.parse_args(argv)
    print(json.dumps(run_bert(args.config, args.dtype, args.steps,
                              args.warmup, args.device,
                              profile=args.profile)))


if __name__ == "__main__":
    main()
