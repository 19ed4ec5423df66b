#!/usr/bin/env python3
"""Measure the cost model's H100 calibration on one card.

Writes `paddle_tpu_torch/calib/h100.json` (and a copy under `chiprun_out/`):
the H100 SXM5 datasheet figures (`peak_flops` 989e12 bf16 dense,
`hbm_gbps` 3350, `hbm_cap_gb` 80) and what this card measures:

- `mfu`: a bf16 `torch.matmul` of two 8192 x 8192 matrices
  (`CostModel.measure_peak_flops`, CUDA events) over `peak_flops`;
- `collectives`: the port's tensor-parallel reassembly, which runs on one
  card (its tp shards run one after another there): `TPContext.gather_cols`
  of two bf16 shards ("allreduce" / "exact", the exact mode's
  concatenation) and `comm_compress.quantized_psum` of two f32 shards
  ("allreduce" / "int8"), each at payloads of 64 KiB to 64 MiB, CUDA events
  around back-to-back calls. `coll_lat_ms` is the exact row's time at the
  smallest payload (one reassembly's fixed cost), `coll_gbps` its rate at
  the largest. No "reducescatter" row: the port runs none, so it prices at
  `coll_gbps`, as the reference does;
- `host_block_ms`: LLaMA-7B (bf16, seed 0, chip_smoke.py's serving
  geometry) on the op chain at decode_block 1, 8 requests of 64 tokens
  decoding together: the wall of a decode step less its device time
  (`probe_device_step_seconds`: the same step queued back to back, one
  synchronize).

It also writes the training residual of `calib/h100_residuals.json`
(`training.step`: llama350m's measured ms per step, `train_llama.
run_config`, over `predict_train_step` on the new constants) and keeps the
file's serving residuals, which come from chip_smoke.py's phase `plan`.
Re-measure after a change to the op chain, the scheduler's host path, the
tp reassembly or `quantized_psum`, and on another card or power limit.

    python3 tools/calibrate_h100.py       # from the repository root; one CUDA card
"""
import datetime
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, ".")

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from paddle_tpu_torch.cost_model import (DEFAULT_CALIB_PATH,  # noqa: E402
                                         DEFAULT_RESIDUALS_PATH, Calibration,
                                         CostModel, Plan, predict_train_step)

SIZES = [1 << s for s in range(16, 27, 2)]      # 64 KiB .. 64 MiB
DATASHEET = "H100 SXM5 datasheet"


def smi_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else "n/a"


def collective_rows(dev):
    """The on-card tp reassembly, by payload: exact gather and int8 psum."""
    from paddle_tpu_torch.distributed.comm_compress import quantized_psum
    from paddle_tpu_torch.inference.tp import TPContext
    tpc = TPContext(2, "exact", None, [dev, dev])
    rows = []
    for size in SIZES:
        cols = size // 2 // 2 // 8                   # 8 rows of bf16, 2 shards
        xs = [torch.randn(8, cols, device=dev).to(torch.bfloat16) for _ in range(2)]
        ms = C.time_ms(torch, lambda: tpc.gather_cols(xs), iters=50, warmup=5)
        rows.append(dict(verb="allreduce", kind="exact", devices=2, size_bytes=size,
                         gbps=size / (ms / 1e3) / 1e9, step_time_ms=ms,
                         op="TPContext.gather_cols, 2 bf16 shards on one card"))
        n = size // 4 // 2                          # f32 elements of one shard
        xs = [torch.randn(n, device=dev) for _ in range(2)]
        wire = 2 * (n + 4 * (-(-n // 256)))          # int8 payload + f32 scales
        ms = C.time_ms(torch, lambda: quantized_psum(xs), iters=20, warmup=3)
        rows.append(dict(verb="allreduce", kind="int8", devices=2, size_bytes=wire,
                         gbps=wire / (ms / 1e3) / 1e9, step_time_ms=ms,
                         op="comm_compress.quantized_psum, 2 f32 shards on one card"))
    return rows


def host_block(dev):
    """(wall ms of a decode step, probe ms, host_block_ms) at 7B, op chain,
    decode_block 1, 8 requests decoding together."""
    from paddle_tpu_torch.inference.scheduler import ContinuousBatchingEngine
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.llama_7b()
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    eng = ContinuousBatchingEngine(model, page_size=64, max_len=1024, max_batch=8,
                                   prefill_chunk=128, prefix_cache=True,
                                   weight_dtype="bfloat16", decode_block=1,
                                   megakernel=False, device=dev)
    del model
    torch.cuda.empty_cache()
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, cfg.vocab_size, 64).astype(np.int64) for _ in range(8)]
    C.drive_cb(torch, eng, prompts, [9] * 8)                   # warm
    _, _, wall_ms = C.drive_cb(torch, eng, prompts, [33] * 8)
    probe_ms = 1e3 * eng.probe_device_step_seconds(iters=30)
    del eng
    torch.cuda.empty_cache()
    return wall_ms, probe_ms, wall_ms - probe_ms


def train_residual(dev, calib):
    """llama350m (train_llama's configuration): measured ms per step over
    predict_train_step's on `calib` (no residuals)."""
    from paddle_tpu_torch.train_llama import CONFIGS, run_config
    spec = CONFIGS["llama350m"]
    r = run_config("llama350m", steps=5, warmup=2, device=dev)
    cfg = dict(spec["model"], preset="config")
    pred = predict_train_step(cfg, Plan(recompute=True), calib=calib,
                              global_batch=spec["bs"], seq=spec["seq"],
                              dtype="bfloat16", moment_dtype="float32")
    torch.cuda.empty_cache()
    return r["ms_per_step"], pred.total_ms


def main():
    if not torch.cuda.is_available():
        print("calibrate_h100: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    device = smi_line()
    print(device, flush=True)
    now = datetime.datetime.now(datetime.timezone.utc)
    run = "h100-calib-" + now.strftime("%Y%m%dT%H%M%SZ")
    peak = 989e12
    achieved = CostModel().measure_peak_flops(dim=8192, iters=20, dtype="bfloat16")
    rows = collective_rows(dev)
    exact = sorted((r for r in rows if r["kind"] == "exact"), key=lambda r: r["size_bytes"])
    wall_ms, probe_ms, hb = host_block(dev)
    src = f"tools/calibrate_h100.py, run {run}"
    d = {
        "backend": "cuda", "device": device, "run": run, "date": now.strftime("%Y-%m-%d"),
        "source": src,
        "peak_flops": {"value": peak, "source": f"{DATASHEET} (bf16 dense)"},
        "hbm_gbps": {"value": 3350.0, "source": DATASHEET},
        "hbm_cap_gb": {"value": 80.0, "source": DATASHEET},
        "mfu": {"value": achieved / peak, "source": (
            f"{src}: bf16 torch.matmul 8192^3, {achieved / 1e12:.1f} TFLOP/s over "
            "peak_flops")},
        "coll_lat_ms": {"value": exact[0]["step_time_ms"], "source": (
            f"{src}: one on-card tp reassembly (2 bf16 shards concatenated) at "
            f"{exact[0]['size_bytes']} bytes")},
        "coll_gbps": {"value": exact[-1]["gbps"], "source": (
            f"{src}: the on-card tp reassembly at {exact[-1]['size_bytes']} bytes "
            "(the cost model's nominal cuda entry carries it)")},
        "host_block_ms": {"value": hb, "source": (
            f"{src}: LLaMA-7B bf16 op chain, decode_block 1, 8 slots: "
            f"{wall_ms:.3f} ms a decode step less {probe_ms:.3f} ms "
            "(probe_device_step_seconds)")},
        "collectives": rows,
    }
    os.makedirs("chiprun_out", exist_ok=True)
    for path in (DEFAULT_CALIB_PATH, os.path.join("chiprun_out", "h100.json")):
        with open(path, "w") as f:
            json.dump(d, f, indent=1)
            f.write("\n")
    calib = Calibration.load(residuals_path=os.path.join("chiprun_out", "none.json"))
    assert calib.source == "calib:h100.json", calib.source
    measured, predicted = train_residual(dev, calib)
    try:
        with open(DEFAULT_RESIDUALS_PATH) as f:
            res = json.load(f)
    except FileNotFoundError:
        res = {"backend": "cuda", "residuals": {"serving": {}}}
    res["residuals"]["training"] = {"step": {"value": measured / predicted, "source": (
        f"{src}: llama350m {measured:.3f} ms a step (train_llama.run_config, "
        f"2 + 5 steps) over predict_train_step's {predicted:.3f} ms")}}
    res.update(backend="cuda", device=device)
    for path in (DEFAULT_RESIDUALS_PATH, os.path.join("chiprun_out", "h100_residuals.json")):
        with open(path, "w") as f:
            json.dump(res, f, indent=1)
            f.write("\n")
    print(json.dumps(dict(run=run, mfu=d["mfu"]["value"], achieved_tflops=achieved / 1e12,
                          coll_lat_ms=d["coll_lat_ms"]["value"],
                          coll_gbps=d["coll_gbps"]["value"], host_block_ms=hb,
                          decode_wall_ms=wall_ms, probe_ms=probe_ms,
                          train_ms=measured, train_predicted_ms=predicted,
                          rows=[(r["kind"], r["size_bytes"], round(r["step_time_ms"], 4),
                                 round(r["gbps"], 2)) for r in rows],
                          seconds=time.perf_counter() - t0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
