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

Router modes (in-process replicas behind `inference/router.py`'s
EngineRouter, each a continuous-batching engine over the one model):
`--replicas N` health-balances four requests over N replicas;
`--prefix-routing` lets three of them share request 0's prompt pages and
routes them by the fleet prefix index; `--hot-swap DIR` rolls the weight
snapshot in DIR through the fleet mid-stream (saved first from the live
weights when DIR does not exist; needs N >= 2); `--disagg P:D` serves
through P prefill and D decode workers with a KV-page handoff at the first
token.

Process fleet (`inference/fleet.py`): `--fleet N` spawns N worker
processes, each building its own engine from one spec dict (the same seed
draws the same weights in every process), and routes the four requests
over them by RPC; with `--disagg P:D` (P + D = N) the KV handoff crosses
processes over the store transport. `--fleet-worker --fleet-store
HOST:PORT --fleet-name NAME` runs this process as one worker of a fleet
whose router runs elsewhere. `--autoscale` ticks an SLO-driven
FleetController (`inference/autoscale.py`) in every router mode
(`--replicas`, `--disagg`, `--fleet`): scale out on a windowed p99 breach
(`--slo-queue-wait-ms`, `--slo-ttft-ms`), drain-then-retire on slack,
within `--min-replicas` / `--max-replicas`.

The cost-model planner (`cost_model.py`): `--plan auto` searches the
feasible tp x topology x megakernel x decode_block space for `--model` on
the visible devices (the CUDA cards, or one with `--device cpu`) under the
chosen device's calibration and applies the top-ranked EngineSpec;
`--plan PATH.json` loads a spec saved by `EngineSpec.save`. The plan
subsumes `--tp`, `--tp-mode`, `--tp-compress`, `--decode-block`,
`--megakernel`, `--replicas` and `--disagg` (they still parse, but the
plan's values win with a DeprecationWarning); the chosen plan and its
predicted TTFT / TPOT are printed at startup.

Engine features (continuous-batching modes): `--kv-tier host|disk`
(`--tier-dir`) demotes cold request pages to host RAM or disk;
`--adapters NAME=PATH,...` loads LoRA adapters into the engines' pool
(missing paths are created as random rank `--adapter-rank` adapters
first), `--adapter-rotate` spreads the requests over base and every
adapter; `--calibrate NPZ` runs PTQ calibration over the model, saves the
int8 scales and serves int8 with them. Telemetry: `--trace-out PATH`
writes the request timeline as chrome-trace JSON, `--metrics-every N`
prints a snapshot every N steps, `--metrics-port P` serves the router's
Prometheus text at http://127.0.0.1:P/metrics.

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
    python -m paddle_tpu_torch.serve_llama --replicas 2 --prefix-routing
    python -m paddle_tpu_torch.serve_llama --replicas 2 --hot-swap snap_dir
    python -m paddle_tpu_torch.serve_llama --disagg 1:1
    python -m paddle_tpu_torch.serve_llama --fleet 2 --device cpu
    python -m paddle_tpu_torch.serve_llama --fleet 2 --disagg 1:1 --autoscale \
        --slo-queue-wait-ms 1 --max-replicas 3 --device cpu
    python -m paddle_tpu_torch.serve_llama --model 7b --plan auto
    python -m paddle_tpu_torch.serve_llama --scheduler --kv-tier host \
        --adapters a=ad_a,b=ad_b --adapter-rotate --trace-out trace.json
    python -m paddle_tpu_torch.serve_llama --scheduler --calibrate scales.npz
"""
import os

import argparse
import json
import tempfile
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
    ap.add_argument("--plan", metavar="auto|PATH.json", default=None,
                    help="serving plan from the cost-model planner: 'auto' "
                         "searches the feasible tp x topology x megakernel "
                         "x decode_block space for this --model on the "
                         "visible devices and applies the top-ranked "
                         "EngineSpec; a PATH.json loads a spec saved by "
                         "EngineSpec.save. The plan SUBSUMES --tp/"
                         "--tp-mode/--tp-compress/--decode-block/"
                         "--megakernel/--replicas/--disagg (still accepted, "
                         "but the plan's values win with a "
                         "DeprecationWarning). Prints the chosen plan and "
                         "its predicted TTFT/TPOT at startup")
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
    ap.add_argument("--replicas", type=int, default=1,
                    help="N > 1: serve through the fault-tolerant "
                         "EngineRouter — N engine replicas, health-balanced "
                         "routing, failover with in-flight re-queue, "
                         "circuit-breaker quarantine")
    ap.add_argument("--hot-swap", metavar="DIR", default=None,
                    help="mid-stream zero-downtime rolling weight swap from "
                         "this CRC32-manifest snapshot directory (saved "
                         "first from the live weights when it does not "
                         "exist); needs --replicas >= 2")
    ap.add_argument("--prefix-routing", action="store_true",
                    help="cache-aware routing: replicas publish their prefix "
                         "chains into a fleet index and each admission lands "
                         "on the replica with the longest cached prefix "
                         "(a loaded one ships its pages to a free replica)")
    ap.add_argument("--disagg", metavar="P:D", default=None,
                    help="disaggregated serving: P prefill workers + D "
                         "decode workers behind the router; requests move "
                         "at first token via the CRC-checked KV-page handoff")
    ap.add_argument("--fleet", type=int, default=0, metavar="N",
                    help="process-backed fleet: spawn N worker processes "
                         "(each building its own engine from one spec "
                         "dict) and route over them by RPC through a "
                         "TCPStore rendezvous; the fleet prefix index is "
                         "wired; with --disagg P:D (P + D = N) the KV "
                         "handoff crosses processes over the store "
                         "transport")
    ap.add_argument("--fleet-worker", action="store_true",
                    help="run this process as one fleet worker: build the "
                         "engine from the same flags and serve the replica "
                         "surface until shut down (one per host, all "
                         "pointing at --fleet-store)")
    ap.add_argument("--fleet-store", metavar="HOST:PORT", default=None,
                    help="rendezvous TCPStore for --fleet-worker (--fleet "
                         "creates its own)")
    ap.add_argument("--fleet-name", default="w0",
                    help="this worker's replica name (--fleet-worker)")
    ap.add_argument("--autoscale", action="store_true",
                    help="tick an SLO-driven FleetController while "
                         "draining: scale out on a windowed p99 breach, "
                         "drain-then-retire on sustained slack, rebalance "
                         "the prefill:decode split under --disagg, shed "
                         "load as the last resort (router modes: "
                         "--replicas, --disagg, --fleet)")
    ap.add_argument("--slo-ttft-ms", type=float, default=None, metavar="MS",
                    help="--autoscale: p99 TTFT target over the sliding "
                         "window (unset = not watched)")
    ap.add_argument("--slo-queue-wait-ms", type=float, default=50.0,
                    metavar="MS",
                    help="--autoscale: p99 queue-wait target over the "
                         "sliding window (default 50)")
    ap.add_argument("--min-replicas", type=int, default=1, metavar="N",
                    help="--autoscale: never drain the fleet below N")
    ap.add_argument("--max-replicas", type=int, default=4, metavar="N",
                    help="--autoscale: never grow the fleet past N "
                         "(breaches beyond the cap fall through to "
                         "load-shedding)")
    ap.add_argument("--kv-tier", choices=["host", "disk"], default=None,
                    help="KV tiering: demote cold request pages out of the "
                         "device pool to host RAM ('host') or host+disk "
                         "('disk', spilling under --tier-dir) in the "
                         "CRC-stamped page-export format, restoring on "
                         "demand at a block boundary; admission "
                         "oversubscribes device pages against the tier "
                         "(scheduler and router modes)")
    ap.add_argument("--tier-dir", default=None,
                    help="spill directory for --kv-tier disk (default: "
                         "paddle_tpu_kv_tier under the temporary directory)")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="P",
                    help="serve router.prometheus() at "
                         "http://127.0.0.1:P/metrics on a stdlib "
                         "http.server thread (0 = ephemeral; router modes: "
                         "--replicas/--disagg/--fleet)")
    ap.add_argument("--trace-out", metavar="PATH", default=None,
                    help="write the request-lifecycle timeline as "
                         "chrome-trace/perfetto JSON to PATH when the demo "
                         "finishes (admission/queue/prefill/TTFT/decode "
                         "spans per request, plus demote/handoff/failover "
                         "legs and fault events; scheduler and router "
                         "modes)")
    ap.add_argument("--metrics-every", type=int, metavar="N", default=0,
                    help="print a compact telemetry snapshot every N "
                         "engine/router steps while draining: TTFT/TPOT/"
                         "queue-wait p50+p99, counters, and rate-converted "
                         "health() deltas")
    ap.add_argument("--adapters", metavar="NAME=PATH,...", default=None,
                    help="multi-LoRA serving: load each NAME=PATH LoRA "
                         "adapter into the engine's paged adapter pool (a "
                         "path that does not exist yet is CREATED as a "
                         "random rank --adapter-rank adapter first, a "
                         "self-contained round-trip demo); deploying to a "
                         "router/fleet is ONE registry write fanned to "
                         "every replica")
    ap.add_argument("--adapter-rotate", action="store_true",
                    help="round-robin the demo requests across the "
                         "--adapters names (plus one base-weights request), "
                         "a MIXED batch: each row equals its adapter's "
                         "dedicated engine")
    ap.add_argument("--adapter-rank", type=int, default=8,
                    help="rank of the adapter pool (and of the demo "
                         "adapters created for missing --adapters paths)")
    ap.add_argument("--calibrate", metavar="NPZ", default=None,
                    help="PTQ: run quantization.ptq.calibrate over the model "
                         "on a small sample stream, save the per-channel "
                         "int8 scales to NPZ, and serve through "
                         "quant='int8' WITH them (implies --quant int8)")
    args = ap.parse_args(argv)
    if args.disagg:
        try:
            args.disagg = tuple(int(x) for x in args.disagg.split(":"))
            if len(args.disagg) != 2:
                raise ValueError
        except ValueError:
            ap.error("--disagg expects P:D (e.g. --disagg 1:2)")
    g = GEOMETRIES[args.model]
    shard_devs = args.device.split(",") if args.device else None
    device = resolve_device(shard_devs[0] if shard_devs else None)
    if args.plan:
        apply_plan(args, g, ap, device)
    if args.autoscale and not (args.fleet or args.disagg
                               or args.replicas > 1):
        ap.error("--autoscale needs a router mode (--replicas >= 2, "
                 "--disagg P:D, or --fleet N)")
    if args.fleet_worker and not args.fleet_store:
        ap.error("--fleet-worker needs --fleet-store HOST:PORT")
    if args.hot_swap and args.replicas < 2:
        ap.error("--hot-swap needs --replicas >= 2 (the router keeps "
                 "serving from the other replicas while one flips)")
    if args.prefix_routing and args.replicas < 2 and not args.disagg:
        ap.error("--prefix-routing needs --replicas >= 2 (a fleet to "
                 "route across)")
    if args.temperature is None and (args.top_k or args.top_p != 1.0
                                     or args.seed or args.sample_rotate):
        warnings.warn(
            "--top-k/--top-p/--seed/--sample-rotate do nothing without "
            "--temperature (decoding stays greedy); set --temperature to "
            "sample", DeprecationWarning, stacklevel=1)
    args.adapter_list = []
    if args.adapters:
        for item in args.adapters.split(","):
            name, _, path = item.partition("=")
            if not name.strip() or not path.strip():
                ap.error("--adapters expects NAME=PATH[,NAME=PATH...]")
            args.adapter_list.append((name.strip(), path.strip()))
    if args.adapter_list and not (args.scheduler or args.replicas > 1
                                  or args.disagg or args.fleet
                                  or args.fleet_worker):
        ap.error("--adapters needs a continuous-batching mode (--scheduler, "
                 "--replicas N, --disagg P:D, or --fleet N): the static "
                 "LLMEngine path has no adapter pool")
    # the continuous-batching engines' feature kwargs: adapters, tiering
    args.feature_kw = {}
    if args.adapter_list:
        args.feature_kw["adapters"] = {
            "rank": args.adapter_rank,
            "max_adapters": max(4, len(args.adapter_list))}
    if args.kv_tier:
        args.feature_kw.update(kv_tier=args.kv_tier, tier_dir=(
            (args.tier_dir or os.path.join(tempfile.gettempdir(),
                                           "paddle_tpu_kv_tier"))
            if args.kv_tier == "disk" else None))
    # observability: --trace-out / --metrics-every / --metrics-port turn
    # the telemetry plane on (and --autoscale, whose controller reads the
    # windowed fleet percentiles)
    args.want_tel = bool(args.trace_out or args.metrics_every
                         or args.metrics_port is not None or args.autoscale)

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
    quant = None if args.quant == "none" else args.quant
    if args.fleet or args.fleet_worker:
        if args.calibrate:
            ap.error("--calibrate needs an in-process model (fleet workers "
                     "build their own engines; calibrate once, ship the "
                     "NPZ, load via quant_scales=)")
        # every worker process builds its own engine from the spec: the
        # router side never holds the weights
        spec = _fleet_spec(args, g, ap, quant)
        if args.fleet_worker:
            return serve_fleet_worker(args, spec)
        return serve_fleet(args, g, spec, ap)
    model = LlamaForCausalLM(g["cfg"], device=device, seed=0)
    # PTQ calibration (quantization/ptq.py): observe the model, save the
    # per-channel int8 scales, serve int8 WITH them
    args.quant_scales = None
    if args.calibrate:
        if args.model == "7b":
            ap.error("--calibrate runs eager forwards (calibrate the "
                     "checkpoint before serving 7b)")
        from .quantization import ptq
        c_rng = np.random.RandomState(42)
        batches = [c_rng.randint(0, g["cfg"].vocab_size, (2, 12))
                   for _ in range(4)]
        args.quant_scales = ptq.calibrate(model, sample_batches=batches)
        args.quant_scales.save(args.calibrate)
        quant = args.quant = "int8"
        print(f"  PTQ: calibrated {len(batches)} batches -> "
              f"{args.calibrate} (serving int8 with calibrated scales)")
    if args.disagg or args.replicas > 1:
        return serve_router(args, g, model, quant, weight_dtype, device)
    if args.scheduler:
        return serve_scheduler(args, g, model, quant, weight_dtype, device)
    engine = LLMEngine(model, max_len=g["max_len"], page_size=g["page"],
                       max_batch=g["bs"], quant=quant,
                       quant_scales=args.quant_scales,
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


def apply_plan(args, g, ap, device):
    """--plan: the searched (auto) or saved (PATH.json) EngineSpec pins the
    knobs it carries; the flags it subsumes still parse but lose, with a
    DeprecationWarning. The search runs over the visible devices (the CUDA
    cards, or one with --device cpu) under that device's calibration."""
    from .cost_model import (Calibration, EngineSpec, predict_serving,
                             search_plan)
    subsumed = [("--tp", args.tp != 1),
                ("--tp-mode", args.tp_mode != "exact"),
                ("--tp-compress", args.tp_compress != "none"),
                ("--decode-block", args.decode_block != 1),
                ("--megakernel", args.megakernel != "auto"),
                ("--replicas", args.replicas != 1),
                ("--disagg", args.disagg is not None)]
    for flag, was_set in subsumed:
        if was_set:
            warnings.warn(
                f"{flag} is subsumed by --plan; the plan's value wins (drop "
                f"the flag, or edit the plan JSON)", DeprecationWarning,
                stacklevel=1)
    calib = Calibration.load(backend="cpu" if device.type == "cpu" else None)
    if args.plan == "auto":
        base = EngineSpec.from_model_cfg(
            g["cfg"], seed=0, max_len=g["max_len"], page_size=g["page"],
            max_batch=max(2, g["bs"]),
            quant=(None if args.quant == "none" else args.quant))
        if args.model == "tiny":
            base.model = {"preset": "tiny", "seed": 0}
        n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
        ranked = search_plan(g["cfg"], n_dev, mode="serving", base_spec=base,
                             calib=calib, prompt_len=16,
                             gen_tokens=args.max_new_tokens)
        if not ranked:
            ap.error(f"--plan auto: no feasible serving plan for "
                     f"{args.model} on {n_dev} device(s)")
        spec, cost = ranked[0].plan, ranked[0].cost
    else:
        spec = EngineSpec.load(args.plan)
        cost = predict_serving(g["cfg"], spec, calib=calib, prompt_len=16,
                               gen_tokens=args.max_new_tokens)
    # the spec is the source of truth: its knobs go back into args, so
    # every mode below consumes them unchanged
    args.tp = spec.tp
    args.tp_mode = spec.tp_mode
    args.tp_compress = spec.tp_compress or "none"
    args.decode_block = spec.decode_block
    args.megakernel = {False: "off", None: "auto"}.get(spec.megakernel,
                                                       spec.megakernel)
    if spec.quant is not None:
        args.quant = spec.quant
    topo = spec.topology()
    if args.fleet:
        if spec.replicas != args.fleet:
            ap.error(f"--fleet {args.fleet} but the plan wants "
                     f"{spec.replicas} replicas")
        args.disagg = (topo["prefill"], topo["decode"]) if topo else None
    elif topo:
        args.disagg = (topo["prefill"], topo["decode"])
        args.replicas = 1
    else:
        args.replicas = spec.replicas
        args.disagg = None
    if spec.replicas == 1 and not args.fleet:
        # the searched knobs (decode_block / megakernel) live on the
        # continuous-batching engine: route through --scheduler
        args.scheduler = True
    print(f"plan[{'auto' if args.plan == 'auto' else args.plan}]: "
          f"tp={spec.tp}({spec.tp_mode}) replicas={spec.replicas}"
          + (f" disagg={topo['prefill']}:{topo['decode']}" if topo else "")
          + f" megakernel={spec.megakernel}"
            f" decode_block={spec.decode_block}")
    print(f"  predicted: TTFT {cost.meta['ttft_ms']:.2f} ms, "
          f"TPOT {cost.meta['tpot_ms']:.3f} ms/tok — {cost.why()} "
          f"[{cost.meta['calibration']}]")
    return spec, cost


def adapter_for(args, i):
    """The adapter of demo request i: round-robin over base and every named
    adapter (--adapter-rotate), else the first name (None without
    --adapters)."""
    if not args.adapter_list:
        return None
    if args.adapter_rotate:
        names = [None] + [n for n, _ in args.adapter_list]
        return names[i % len(names)]
    return args.adapter_list[0][0]


def deploy_adapters(args, g, target):
    """Materialize missing demo adapter files (random adapters of the
    engine geometry), then one registry write per adapter on the target
    (an engine prints its pool slot, a router its per-replica summary)."""
    if not args.adapter_list:
        return
    from .inference.adapters import make_lora_adapter, save_adapter
    for i, (name, path) in enumerate(args.adapter_list):
        if not os.path.isdir(path):
            save_adapter(path, make_lora_adapter(
                g["cfg"], rank=args.adapter_rank, seed=100 + i))
            print(f"  adapter {name}: wrote random rank-{args.adapter_rank} "
                  f"demo adapter -> {path}")
    for name, path in args.adapter_list:
        print(f"  adapter {name}: {target.load_adapter(name, path)}")


def metrics_endpoint(args, router):
    """--metrics-port: the Prometheus scrape endpoint over the live router
    (telemetry.serve_prometheus); returns the server or None."""
    if args.metrics_port is None:
        return None
    from .inference.telemetry import serve_prometheus
    srv = serve_prometheus(router, port=args.metrics_port)
    print(f"  metrics: http://127.0.0.1:{srv.server_address[1]}/metrics")
    return srv


def router_trace_out(args, router):
    if args.trace_out and args.want_tel:
        router.export_chrome_trace(args.trace_out)
        print(f"  trace written: {args.trace_out} (fleet timeline; load in "
              "Perfetto / chrome://tracing)")


def sampling_for(args, i):
    """The sampling spec of demo request i (None: greedy)."""
    if args.temperature is None or (args.sample_rotate and i % 2 == 1):
        return None
    return {"do_sample": True, "temperature": args.temperature,
            "top_k": args.top_k, "top_p": args.top_p, "seed": args.seed + i}


def serve_router(args, g, model, quant, weight_dtype, device):
    """Four requests through an EngineRouter over in-process replicas of
    one model (--replicas N, or --disagg P:D); with --prefix-routing the
    first three share request 0's prompt, which finishes (and publishes its
    pages) before they arrive; with --hot-swap a snapshot rolls through the
    fleet two router steps into the stream."""
    from .inference.router import EngineRouter

    def factory():
        return ContinuousBatchingEngine(
            model, max_len=g["max_len"], page_size=g["page"],
            max_batch=max(2, g["bs"]), quant=quant,
            quant_scales=args.quant_scales, weight_dtype=weight_dtype,
            decode_block=args.decode_block,
            megakernel=MEGAKERNEL[args.megakernel],
            device=args.engine_device, **args.tp_kw, **args.feature_kw)

    if args.disagg:
        p_n, d_n = args.disagg
        router = EngineRouter(factory, topology={"prefill": p_n,
                                                 "decode": d_n},
                              prefix_routing=args.prefix_routing,
                              telemetry=args.want_tel)
        mode = f"disagg {p_n}:{d_n}"
    else:
        router = EngineRouter(factory, replicas=args.replicas,
                              prefix_routing=args.prefix_routing,
                              telemetry=args.want_tel)
        mode = f"replicas={args.replicas}"
    srv = metrics_endpoint(args, router)
    deploy_adapters(args, g, router)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, g["cfg"].vocab_size, (t,)).astype(np.int64)
               for t in (16, 9, 5, 12)]
    uids = []
    if args.prefix_routing:
        # a shared system prompt: requests 1-3 reuse request 0's published
        # pages, and the index steers them to its replica
        prompts = [np.concatenate([prompts[0], p[:4]])
                   for p in prompts[:3]] + [prompts[3]]
        uids.append(router.add_request(prompts[0], args.max_new_tokens,
                                       sampling=sampling_for(args, 0)))
        router.drain()
    uids += [router.add_request(p, args.max_new_tokens,
                                adapter=(None if args.prefix_routing
                                         else adapter_for(args, i)),
                                sampling=sampling_for(args, i))
             for i, p in enumerate(prompts) if i >= len(uids)]
    for _ in range(2):
        router.step()                       # replicas mid-flight
    if args.hot_swap:
        if not os.path.isdir(args.hot_swap):
            # round-trip demo: snapshot the live weights first
            router.save_weights_snapshot(args.hot_swap, step=0)
        print(f"  hot-swap: {router.hot_swap(args.hot_swap)}")
    # in-process elastic fleet: the router's own factory is the spawner
    drive_router(args, router, make_controller(args, router))
    router_trace_out(args, router)
    h = router.health()
    print(f"model={args.model} quant={args.quant} router {mode}: "
          f"{h['done']} done / {h['failed']} failed, {h['failovers']} "
          f"failovers, {h['kv_handoffs']} KV handoffs "
          f"({dict(router.handoff_transports)}), {h['prefix_routed']} "
          f"prefix-routed, {h['prefix_ships']} prefix ships, "
          f"{h['hot_swaps']} hot swaps")
    if args.kv_tier:
        print("  kv tier:", {rep.name: {"demotions": rep.engine.demotions,
                                        "restores": rep.engine.restores}
                             for rep in router._replicas})
    for name, rh in h["replicas"].items():
        print(f"  {name} [{rh['role']}]: breaker={rh['breaker']} "
              f"swaps={rh['swaps']} pages_free={rh.get('pages_free')}")
    for i, u in enumerate(uids):
        o = router.result(u)
        print(f"  request {i}: {prompts[i].size} -> {o.size} tokens, "
              f"tail {o[-4:].tolist()}")
    if srv is not None:
        srv.shutdown()
    return router


def _fleet_spec(args, g, ap, quant):
    """The engine spec of a fleet worker, as plain data
    (`fleet.build_engine_from_spec`): the model the in-process modes build
    (seed 0) and their engine geometry, so a worker needs no code shipped
    and every process draws the same weights."""
    if args.model == "tiny":
        model_spec = {"preset": "tiny", "seed": 0}
    elif args.model == "350m":
        # every field of the config is a plain scalar: the spec carries
        # the geometries table's config exactly
        model_spec = {"preset": "config", "seed": 0, **vars(g["cfg"])}
    else:
        ap.error("--fleet/--fleet-worker supports tiny/350m (each worker "
                 "would draw its own 7B weights; serve 7B through "
                 "spawn_fleet with a spec dict, as chip_smoke.py's fleet "
                 "phase does)")
    engine = dict(max_len=g["max_len"], page_size=g["page"],
                  max_batch=max(2, g["bs"]), quant=quant,
                  decode_block=args.decode_block,
                  megakernel=MEGAKERNEL[args.megakernel], **args.tp_kw,
                  **args.feature_kw)
    if args.engine_device is not None:
        engine["device"] = ([str(d) for d in args.engine_device]
                            if isinstance(args.engine_device, list)
                            else str(args.engine_device))
    return {"model": model_spec, "engine": engine}


def make_controller(args, router, spawner=None, retirer=None):
    """--autoscale: the SLO-driven FleetController that drive_router ticks
    between router steps (None without --autoscale)."""
    if not args.autoscale:
        return None
    from .inference.autoscale import FleetController, SLOTarget
    slo = SLOTarget(ttft_p99_ms=args.slo_ttft_ms,
                    queue_wait_p99_ms=args.slo_queue_wait_ms)
    return FleetController(router, slo, spawner=spawner, retirer=retirer,
                           min_replicas=args.min_replicas,
                           max_replicas=args.max_replicas)


def drive_router(args, router, ctl=None):
    """Drain the router, printing a compact fleet-metrics line every
    --metrics-every steps (TTFT/TPOT/queue-wait p50s from the merged
    per-replica histograms); with --autoscale the controller ticks every 4
    router steps, the cadence the traffic advances at."""
    n = 0
    while router.step():
        n += 1
        if ctl is not None:
            ctl.maybe_tick(every_steps=4)
        if args.metrics_every and n % args.metrics_every == 0:
            hists = (router.metrics().get("fleet") or {}).get(
                "histograms", {})
            line = {k: {"p50_ms": v.get("p50_ms"), "n": v.get("count")}
                    for k, v in hists.items() if v.get("count")}
            print(f"  metrics@{n}: {json.dumps(line)}")
    router.drain()                          # the final collect pass
    if ctl is not None:
        st = ctl.stats()
        last = st["last_decision"]
        print(f"  autoscale: {st['ticks']} ticks, +{st['scale_outs']}/"
              f"-{st['scale_ins']} replicas ({st['replicas']} final), "
              f"{st['rebalances']} rebalances, {st['sheds']} sheds, "
              f"last={last and last['action']}")


def serve_fleet_worker(args, spec):
    """--fleet-worker: one worker of a fleet whose router runs elsewhere;
    serves until the router shuts it down."""
    from .distributed.store import TCPStore
    from .inference.fleet import EngineHost, build_engine_from_spec
    host_s, _, port_s = args.fleet_store.partition(":")
    store = TCPStore(host_s, int(port_s))
    host = EngineHost(build_engine_from_spec(spec), args.fleet_name, store)
    print(f"fleet worker {args.fleet_name} serving {host.ip}:{host.port} "
          f"(store {args.fleet_store})", flush=True)
    host.serve_forever()
    return host


def serve_fleet(args, g, spec, ap):
    """--fleet N: four requests through an EngineRouter over N worker
    processes (ProcessReplicas); --disagg P:D makes P of them prefill and
    D decode workers; --autoscale spawns and retires real processes
    through the fleet handle."""
    from .inference.fleet import spawn_fleet
    from .inference.router import EngineRouter
    topo = roles = None
    if args.disagg:
        p_n, d_n = args.disagg
        if p_n + d_n != args.fleet:
            ap.error(f"--disagg {p_n}:{d_n} needs --fleet {p_n + d_n}")
        topo = {"prefill": p_n, "decode": d_n}
        roles = ["prefill"] * p_n + ["decode"] * d_n
    handle = spawn_fleet(spec, args.fleet, roles=roles)
    srv = None
    try:
        # the workers are non-daemon processes: whatever raises after the
        # spawn must still shut them down
        router = EngineRouter(backends=handle.replicas, topology=topo,
                              prefix_index=handle.prefix_index,
                              telemetry=args.want_tel)
        srv = metrics_endpoint(args, router)
        # registry write over the ProcessReplica RPC surface: every worker
        # loads from the shared path
        deploy_adapters(args, g, router)
        rng = np.random.RandomState(0)
        prompts = [rng.randint(0, g["cfg"].vocab_size, (t,)).astype(np.int64)
                   for t in (16, 9, 5, 12)]
        uids = [router.add_request(p, args.max_new_tokens,
                                   adapter=adapter_for(args, i),
                                   sampling=sampling_for(args, i))
                for i, p in enumerate(prompts)]
        drive_router(args, router, make_controller(
            args, router, spawner=lambda role: handle.spawn_worker(role=role),
            retirer=handle.retire_worker))
        router_trace_out(args, router)
        h = router.health()
        print(f"model={args.model} quant={args.quant} fleet {args.fleet} "
              "processes" + (f" (disagg {topo['prefill']}:{topo['decode']})"
                             if topo else "")
              + f": {h['done']} done / {h['failed']} failed, "
              f"{h['failovers']} failovers, {h['kv_handoffs']} KV handoffs "
              f"(transports {dict(router.handoff_transports)})")
        for name, rh in h["replicas"].items():
            print(f"  {name} [{rh['role']}]: breaker={rh['breaker']} "
                  f"worker={json.dumps(rh.get('worker'))}")
        for i, u in enumerate(uids):
            o = router.result(u)
            print(f"  request {i}: {prompts[i].size} -> {o.size} tokens, "
                  f"tail {o[-4:].tolist()}")
        return router
    finally:
        if srv is not None:
            srv.shutdown()
        handle.shutdown()


def serve_scheduler(args, g, model, quant, weight_dtype, device):
    """Three ragged requests; request 1 is the first page of request 0's
    prompt and arrives once request 0 has published it (an adapter request
    shares nothing: its KV carries the adapter's deltas)."""
    tel = None
    if args.want_tel:
        from .inference.telemetry import Telemetry
        tel = Telemetry()
    engine = ContinuousBatchingEngine(
        model, max_len=g["max_len"], page_size=g["page"],
        max_batch=max(2, g["bs"]), quant=quant,
        quant_scales=args.quant_scales, weight_dtype=weight_dtype,
        queue_limit=args.queue_limit, default_deadline_ms=args.deadline_ms,
        decode_block=args.decode_block,
        megakernel=MEGAKERNEL[args.megakernel],
        speculate=args.speculate or None, drafter=args.drafter,
        device=args.engine_device, telemetry=tel, **args.tp_kw,
        **args.feature_kw)
    del model
    deploy_adapters(args, g, engine)
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
                                        adapter=adapter_for(args, 0),
                                        sampling=sampling_for(args, 0)))]
    while engine.status(submitted[0][1]) in ("queued", "prefill"):
        engine.step()            # request 0 publishes its prompt pages
    for i, p in enumerate(prompts[1:], start=1):
        try:
            submitted.append((i, engine.add_request(
                p, args.max_new_tokens, adapter=adapter_for(args, i),
                sampling=sampling_for(args, i))))
        except EngineBusyError as e:
            print(f"  request {i} shed by backpressure: {e}")
    if args.metrics_every:
        # metered drain: the telemetry plane's periodic snapshot
        n = 0
        while engine.step():
            n += 1
            if n % args.metrics_every == 0:
                tel.sample(engine.health())
                print(f"  metrics@{n}: {json.dumps(tel.summary())}")
    else:
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
    if args.adapter_list:
        a = h["adapters"]
        print(f"  adapters: {a['loaded']} loaded "
              f"({a['pages_total'] - a['pages_free']}/{a['pages_total']} "
              f"pool pages), per-adapter requests {a['requests']}, tokens "
              f"{a['tokens']}")
    if args.kv_tier:
        print(f"  kv tier ({h['kv_tier']}): {h['demotions']} demotions / "
              f"{h['restores']} restores ({h['restore_failures']} failed), "
              f"tier={h['tier']}")
    if tel is not None:
        print(f"  telemetry: {json.dumps(tel.summary())}")
        if args.trace_out:
            tel.export_chrome_trace(args.trace_out)
            print(f"  trace written: {args.trace_out} "
                  f"({len(tel.done_traces())} request span chains; load in "
                  "Perfetto / chrome://tracing)")
    return engine


if __name__ == "__main__":
    main()
