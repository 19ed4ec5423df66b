"""Train LLaMA or GPT for a few steps through paddle_tpu_torch's `SpmdTrainer`.

The port of `bench.py`'s `_measure` / `_run_config`, with the same two
LLaMA configurations (random weights from a seed, one repeated batch from
`numpy.random.RandomState(0)`, labels the ids shifted by one), and GPT:

- llama350m: vocab 32000, hidden 1024, ffn 2816, 16 layers, 16 heads
  (d 64), batch 32 x 1024 tokens, bf16 params, f32 moments, recompute
  with policy save_attn, ce_chunk 4096, lr 1e-4;
- llama1p3b: hidden 2048, ffn 5504, 24 layers, 16 heads (d 128), batch
  8 x 1024, bf16 params and moments, recompute with policy full,
  ce_chunk 2048, lr 1e-4;
- tiny: `LlamaConfig.tiny()`, batch 4 x 64, f32, no recompute (bench.py's
  smoke mode);
- gpt3_1p3b: `GPTConfig.gpt3_1p3b()` (vocab 50304, hidden 2048, 24
  layers, 16 heads, d 128, 1024 positions, hidden and attention dropout
  0.1) with llama1p3b's trainer settings: batch 8 x 1024, bf16 params and
  moments, recompute full, ce_chunk 2048, lr 1e-4; each step draws its
  dropout key from the global generator, seeded by `seed`;
- gpt_tiny: `GPTConfig.tiny()`, batch 4 x 64, f32, no recompute.

It prints one JSON line: ms per step, tokens/s, peak device memory and
MFU = tokens/s x (6 N + 12 L H s / 2) / 989e12 (bench.py's accounting over
the H100 SXM dense bf16 peak; N counts every parameter) on a card; on the
CPU the device metrics are null. `--profile` runs one more step under
`torch.profiler` and adds the device time of that step by kernel group
(the port's three training kernels, cuBLAS products, the rest) and its
busy share of the unprofiled ms per step.

    python -m paddle_tpu_torch.train_llama --config llama350m --profile
    python -m paddle_tpu_torch.train_llama --config tiny --device cpu

Tensor parallelism: `tp_rank(spec, out_dir)` is one model-parallel rank,
a target for `distributed.spawn` (PADDLE_TRAINER_ID / PADDLE_TRAINERS_NUM
from spawn, MASTER_ADDR / MASTER_PORT from the parent's environment). It
brings the world up with `fleet.init(mp_degree=spec["mp"])` on
`spec["device"]` (CUDA unless "cpu"), then for each run of
`spec["runs"]` builds the model from the run's config and seed (under the
fleet its layers are the model-parallel ones; with `weights`, an .npz of
the reference's full parameters, each rank loads its shards through
`convert.shard_numpy_params`), trains it with `SpmdTrainer(model,
mesh={"model": mp})` on the run's batch for len(keys) steps (step i keyed
by `framework.random.key(keys[i])`, or by the global generator, seeded by
the run's seed, for None), and writes `<run>_rank<r>.json` (losses, ms a
step past the warmup, peak memory, kernel launches, the model-parallel
collectives' calls, bytes and, over one more step timed collective by
collective, ms) and, with "save", `<run>_rank<r>.pt` (the rank's
parameter shards, its step-0 gradients, the parameters' `dist_attr`s and,
with "save_moments", its moments) into `out_dir`;
with "canonical", rank 0 writes the gathered `canonical_state` as
`<run>_canonical.npz` ("params.outer.0", "opt.stacked.3.m", ...).
"""
import argparse
import json
import re
import time

import numpy as np
import torch

from . import resolve_device
from .framework import random as frnd
from .models.gpt import GPTConfig, GPTForCausalLM
from .models.llama import LlamaConfig, LlamaForCausalLM
from .models.train_step import SpmdTrainer

H100_BF16_FLOPS_PER_S = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)

CONFIGS = {
    "llama350m": dict(
        model=dict(vocab_size=32000, hidden_size=1024, intermediate_size=2816,
                   num_hidden_layers=16, num_attention_heads=16,
                   max_position_embeddings=1024),
        bs=32, seq=1024, steps=20, warmup=3,
        trainer=dict(param_dtype="bfloat16", moment_dtype="float32",
                     recompute=True, recompute_policy="save_attn",
                     ce_chunk=4096)),
    "llama1p3b": dict(
        model=dict(vocab_size=32000, hidden_size=2048, intermediate_size=5504,
                   num_hidden_layers=24, num_attention_heads=16,
                   max_position_embeddings=1024),
        bs=8, seq=1024, steps=10, warmup=2,
        trainer=dict(param_dtype="bfloat16", moment_dtype="bfloat16",
                     recompute=True, recompute_policy="full", ce_chunk=2048)),
    "tiny": dict(model={}, bs=4, seq=64, steps=5, warmup=2,
                 trainer=dict(param_dtype="float32", recompute=False)),
    "gpt3_1p3b": dict(
        family="gpt", model=dict(hidden_size=2048, num_hidden_layers=24,
                                 num_attention_heads=16),
        bs=8, seq=1024, steps=10, warmup=2,
        trainer=dict(param_dtype="bfloat16", moment_dtype="bfloat16",
                     recompute=True, recompute_policy="full", ce_chunk=2048)),
    "gpt_tiny": dict(family="gpt", model={}, bs=4, seq=64, steps=5, warmup=2,
                     trainer=dict(param_dtype="float32", recompute=False)),
}


def build_model(name, device, seed=0):
    """The configuration's model (random weights from `seed`)."""
    spec = CONFIGS[name]
    if spec.get("family") == "gpt":
        cfg = GPTConfig.tiny(**spec["model"]) if name == "gpt_tiny" \
            else GPTConfig(**spec["model"])
        return GPTForCausalLM(cfg, device=device, seed=seed)
    cfg = LlamaConfig.tiny(**spec["model"]) if name == "tiny" \
        else LlamaConfig(**spec["model"])
    return LlamaForCausalLM(cfg, device=device, seed=seed)


def model_flops_per_token(cfg, n_params, seq):
    """bench.py's accounting: 6 N dense plus causal attention
    12 L H s / 2; recompute is not counted (model flops only)."""
    return 6 * n_params + 12 * cfg.num_hidden_layers * cfg.hidden_size * seq // 2


# kernel name -> group, first match wins (names as the CUDA profiler
# reports them; the port's kernels sit in an anonymous namespace)
KERNEL_GROUPS = (
    ("flash_attention_bwd", re.compile(r"flash_bwd_kernel|bwd_dkdv_kernel|bwd_dq_kernel")),
    ("flash_attention_fwd", re.compile(r"flash_fwd_kernel|flash_fwd_tc_kernel")),
    ("rms_norm", re.compile(r"rms_fwd_kernel")),
    ("matmul", re.compile(r"gemm|nvjet|xmma|cutlass|cublas", re.I)),
)


def profile_step(step_fn, ms_per_step):
    """Device time of one `step_fn()` under torch.profiler: every CUDA
    event (kernels, copies, fills) of the step summed by kernel group
    (ms), the ten longest other kernels, and the busy share of
    `ms_per_step`. The sums are None when the profiler saw no device
    event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step_fn()
        torch.cuda.synchronize()
    groups = {g: 0.0 for g, _ in KERNEL_GROUPS}
    groups["other"] = 0.0
    others = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        g = next((g for g, pat in KERNEL_GROUPS if pat.search(e.name)), "other")
        groups[g] += ms
        if g == "other":
            others[e.name[:80]] = others.get(e.name[:80], 0.0) + ms
    busy = sum(groups.values())
    if busy <= 0:
        return dict(device_ms=None, busy_ms=None, busy_share=None, top_other_ms=None)
    top = sorted(others.items(), key=lambda kv: -kv[1])[:10]
    return dict(device_ms=groups, busy_ms=busy, busy_share=busy / ms_per_step,
                top_other_ms=dict(top))


def run_config(name, steps=None, warmup=None, device=None, seed=0,
               profile=False):
    """Build the configuration's model and trainer on `device` (CUDA by
    default), run `warmup` then `steps` timed steps on one repeated batch,
    and return a dict of the measurements and every step's loss.
    `profile` (on a card) runs one more step under the profiler
    (`profile_step`)."""
    spec = CONFIGS[name]
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    steps = spec["steps"] if steps is None else steps
    warmup = spec["warmup"] if warmup is None else warmup
    bs, seq = spec["bs"], spec["seq"]
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    frnd.seed(seed)
    model = build_model(name, dev, seed)
    cfg = model.config
    n_params = sum(p.numel() for p in model.parameters())
    trainer = SpmdTrainer(model, lr=1e-4, **spec["trainer"])
    state = trainer.init_state()

    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, (bs, seq)).astype(np.int64)
    labels = np.roll(ids, -1, axis=1)
    ids_t = torch.from_numpy(ids).to(dev)
    labels_t = torch.from_numpy(labels).to(dev)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    losses = []
    for _ in range(warmup):
        state, loss = trainer.step(state, ids_t, labels_t)
        losses.append(loss)
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, loss = trainer.step(state, ids_t, labels_t)
        losses.append(loss)
    sync()
    dt = time.perf_counter() - t0
    tokens_per_s = bs * seq * steps / dt if steps else None
    flops = model_flops_per_token(cfg, n_params, seq)
    prof = None
    if profile and on_card and steps:
        def one_step():
            nonlocal state
            state, loss = trainer.step(state, ids_t, labels_t)
            losses.append(loss)
        prof = profile_step(one_step, 1e3 * dt / steps)
    return dict(
        config=name, device=str(dev),
        device_name=torch.cuda.get_device_name(dev) if on_card else "cpu",
        n_params=n_params, num_hidden_layers=cfg.num_hidden_layers,
        batch_size=bs, seq=seq, warmup=warmup, steps=steps,
        ms_per_step=1e3 * dt / steps if steps else None,
        tokens_per_s=tokens_per_s,
        mfu=(tokens_per_s * flops / H100_BF16_FLOPS_PER_S
             if on_card and steps else None),
        peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9 if on_card else None,
        losses=[float(x) for x in losses], profile=prof,
        **{k: v for k, v in spec["trainer"].items()})


def _tp_batch(run, vocab):
    if run.get("data"):
        d = np.load(run["data"])
        return d["ids"], d["labels"]
    bs, seq = run["batch"]
    ids = np.random.RandomState(0).randint(0, vocab, (bs, seq)).astype(np.int64)
    return ids, np.roll(ids, -1, axis=1)


def _tp_model(run, dev, mp, rank):
    from .convert import dist_attrs_of, load_numpy_params, shard_numpy_params
    if run.get("family", "llama") == "gpt":
        model = GPTForCausalLM(GPTConfig(**run["model"]), device=dev,
                               seed=run.get("seed", 0))
    else:
        model = LlamaForCausalLM(LlamaConfig(**run["model"]), device=dev,
                                 seed=run.get("seed", 0))
    if run.get("weights"):
        full = dict(np.load(run["weights"]))
        load_numpy_params(model, shard_numpy_params(full, rank, mp,
                                                    dist_attrs_of(model)))
    return model


def _tp_train(run, dev, mp, rank, out_dir):
    """One run of `tp_rank` on this rank; returns its report."""
    import os
    from .convert import dist_attrs_of
    from .distributed.fleet.meta_parallel import mp_ops
    from .ops import kernel_launches, reset_kernel_launches
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    frnd.seed(run.get("seed", 0))
    model = _tp_model(run, dev, mp, rank)
    trainer = SpmdTrainer(model, mesh={"model": mp}, **run["trainer"])
    state = trainer.init_state()
    ids, labels = (torch.from_numpy(a).to(dev) for a in
                   _tp_batch(run, model.config.vocab_size))
    keys = [None if k is None else frnd.key(k) for k in run["keys"]]
    warmup = run.get("warmup", 0)
    grads0, losses, times = {}, [], []
    mp_ops.reset_comm_stats()
    reset_kernel_launches()
    for i, key in enumerate(keys):
        if i == warmup:
            calls, nbytes = mp_ops.comm_stats["calls"], mp_ops.comm_stats["bytes"]
        sync()
        t = time.perf_counter()
        state, loss = trainer.step(state, ids, labels, key=key,
                                   grads_out=grads0 if i == 0 and run.get("save") else None)
        losses.append(float(loss))
        times.append(time.perf_counter() - t)
    timed = len(keys) - warmup
    rep = dict(run=run["name"], rank=rank, losses=losses,
               ms_per_step=[1e3 * x for x in times[warmup:]],
               launches=kernel_launches(), steps=len(keys),
               comm_calls_per_step=(mp_ops.comm_stats["calls"] - calls) / timed,
               comm_bytes_per_step=(mp_ops.comm_stats["bytes"] - nbytes) / timed,
               peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9 if on_card else None)
    if run.get("save"):
        cpu = {n: t.detach().cpu() for n, t in state["params"].items()}
        saved = {"params": cpu, "dist_attrs": dist_attrs_of(model),
                 "grads0": {n: g.detach().cpu() for n, g in grads0.items()}}
        if run.get("save_moments"):
            saved["opt"] = {n: {k: v.cpu() for k, v in st.items()}
                            for n, st in state["opt"].items()}
        torch.save(saved, os.path.join(out_dir, f"{run['name']}_rank{rank}.pt"))
    if run.get("canonical"):
        canon = trainer.canonical_state(state)
        if rank == 0:
            flat = {f"params.{kind}.{i}": t.detach().cpu().numpy()
                    for kind in ("outer", "stacked")
                    for i, t in enumerate(canon["params"][kind])}
            flat.update({f"opt.{kind}.{i}.{k}": ent[k].detach().cpu().numpy()
                         for kind in ("outer", "stacked")
                         for i, ent in enumerate(canon["opt"][kind])
                         for k in ("m", "v")})
            np.savez(os.path.join(out_dir, f"{run['name']}_canonical.npz"), **flat)
    if run.get("comm_timed"):
        # one more step (after the saves), each collective timed alone (the device
        # synchronized around it): the collectives' ms a step
        before = mp_ops.comm_stats["seconds"]
        with mp_ops.comm_timing():
            state, loss = trainer.step(state, ids, labels, key=keys[-1])
        rep["comm_ms_per_step"] = 1e3 * (mp_ops.comm_stats["seconds"] - before)
        rep["comm_timed_loss"] = float(loss)
    del trainer, state, model
    return rep


def tp_rank(spec, out_dir, spawn_t=None):
    """One model-parallel rank (see the module docstring)."""
    import os
    from . import distributed as dist
    from .distributed import fleet
    dev = resolve_device(spec.get("device"))
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    mp = int(spec["mp"])
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": mp,
                               "pp_degree": 1, "sharding_degree": 1}
    fleet.init(is_collective=True, strategy=strategy, device=dev)
    hcg = fleet.get_hybrid_communicate_group()
    rank = hcg.get_model_parallel_rank()
    head = dict(rank=rank, pid=os.getpid(), backend=dist.get_backend(),
                mode=hcg.get_parallel_mode(),
                rendezvous_s=None if spawn_t is None else time.time() - spawn_t)
    for run in spec["runs"]:
        rep = dict(head, **_tp_train(run, dev, mp, rank, out_dir))
        with open(os.path.join(out_dir, f"{run['name']}_rank{rank}.json"), "w") as f:
            json.dump(rep, f)
    dist.barrier()
    dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", choices=sorted(CONFIGS), default="llama350m")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--warmup", type=int, default=None)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--profile", action="store_true",
                    help="one more step under torch.profiler (on a card)")
    args = ap.parse_args(argv)
    print(json.dumps(run_config(args.config, args.steps, args.warmup,
                                args.device, profile=args.profile)))


if __name__ == "__main__":
    main()
