"""serve_llama's planner, tiering, telemetry, adapter and PTQ flags.

`paddle_tpu_torch.serve_llama.main(argv)` in-process at the tiny model on
the CPU, one test per flag group: `--plan auto` (the cost model's top
spec for one device under the CPU calibration) and a saved plan JSON (its
knobs win over the flags it subsumes, with a DeprecationWarning);
`--kv-tier host|disk` with `--tier-dir`; `--trace-out`, `--metrics-every`
and `--metrics-port`; `--adapters` / `--adapter-rotate` / `--adapter-rank`;
`--calibrate` with an NPZ made in tmp_path. Greedy outputs do not depend
on the planner's knobs, the tier, telemetry or the calibrated scales, so
each run's request tails equal the plain run's.
"""
import json
import re
import warnings

import numpy as np
import pytest
import torch

from paddle_tpu_torch import serve_llama
from paddle_tpu_torch.cost_model import Calibration, EngineSpec, search_plan
from paddle_tpu_torch.models.llama import LlamaConfig

torch.set_num_threads(1)
BASE = ["--device", "cpu", "--max_new_tokens", "6"]


def run(capsys, *argv):
    out = serve_llama.main(list(argv) + BASE)
    return out, capsys.readouterr().out


def tails(text):
    return re.findall(r"request \d+: .*tail (\[.*\])", text)


@pytest.fixture(scope="module")
def plain():
    """The request tails of the plain scheduler and router runs."""
    import io
    import contextlib
    got = {}
    for mode, argv in (("scheduler", ["--scheduler"]),
                       ("router", ["--replicas", "2"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            serve_llama.main(argv + BASE)
        got[mode] = tails(buf.getvalue())
    return got


def test_plan_auto_applies_the_searched_spec(capsys, plain):
    g = serve_llama.GEOMETRIES["tiny"]
    base = EngineSpec(model={"preset": "tiny", "seed": 0}, max_len=64,
                      page_size=16, max_batch=2)
    top = search_plan(LlamaConfig.tiny(), 1, mode="serving", base_spec=base,
                      calib=Calibration(backend="cpu"), prompt_len=16,
                      gen_tokens=6)[0].plan
    eng, text = run(capsys, "--plan", "auto")
    assert f"plan[auto]: tp=1(exact) replicas=1 megakernel={top.megakernel}" \
        f" decode_block={top.decode_block}" in text
    assert "predicted: TTFT" in text and "[nominal]" in text
    assert eng.decode_block == top.decode_block
    assert eng.health()["megakernel"] == (top.megakernel or "off")
    assert g["max_len"] == eng.max_len
    assert tails(text) == plain["scheduler"]


def test_saved_plan_wins_over_subsumed_flags(capsys, plain, tmp_path):
    path = str(tmp_path / "plan.json")
    EngineSpec(model={"preset": "tiny", "seed": 0}, max_len=64,
               page_size=16, max_batch=2, decode_block=4,
               megakernel=False).save(path)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        eng, text = run(capsys, "--plan", path, "--decode-block", "8",
                        "--megakernel", "layer")
    msgs = [str(x.message) for x in w if x.category is DeprecationWarning]
    assert any("--decode-block is subsumed by --plan" in m for m in msgs)
    assert any("--megakernel is subsumed by --plan" in m for m in msgs)
    assert eng.decode_block == 4 and eng.health()["megakernel"] == "off"
    assert f"plan[{path}]" in text
    assert tails(text) == plain["scheduler"]
    # a two-replica plan routes through the router
    EngineSpec(model={"preset": "tiny", "seed": 0}, max_len=64,
               page_size=16, max_batch=2, replicas=2).save(path)
    router, text = run(capsys, "--plan", path)
    assert len(router._replicas) == 2
    assert tails(text) == plain["router"]


@pytest.mark.parametrize("tier", ["host", "disk"])
def test_kv_tier_flags(capsys, plain, tmp_path, tier):
    tdir = tmp_path / "tier"
    eng, text = run(capsys, "--scheduler", "--kv-tier", tier,
                    "--tier-dir", str(tdir))
    h = eng.health()
    assert h["kv_tier"] == tier and h["tier"]["kind"] == tier
    assert h["restore_failures"] == 0
    assert f"kv tier ({tier})" in text
    assert tails(text) == plain["scheduler"]
    router, text = run(capsys, "--replicas", "2", "--kv-tier", tier,
                       "--tier-dir", str(tdir))
    assert all(rep.engine.health()["kv_tier"] == tier
               for rep in router._replicas)
    assert tails(text) == plain["router"]


def test_telemetry_outputs(capsys, plain, tmp_path):
    trace = tmp_path / "trace.json"
    eng, text = run(capsys, "--scheduler", "--trace-out", str(trace),
                    "--metrics-every", "3")
    assert "metrics@3:" in text and "telemetry:" in text
    with open(trace) as f:
        ev = json.load(f)["traceEvents"]
    assert ev and {e["ph"] for e in ev} >= {"X"}
    assert tails(text) == plain["scheduler"]
    trace2 = tmp_path / "fleet_trace.json"
    router, text = run(capsys, "--replicas", "2", "--trace-out",
                       str(trace2), "--metrics-every", "2",
                       "--metrics-port", "0")
    assert re.search(r"metrics: http://127\.0\.0\.1:\d+/metrics", text)
    assert "metrics@2:" in text
    with open(trace2) as f:
        assert json.load(f)["traceEvents"]
    assert tails(text) == plain["router"]


def test_adapter_flags(capsys, plain, tmp_path):
    a, b = str(tmp_path / "ad_a"), str(tmp_path / "ad_b")
    eng, text = run(capsys, "--scheduler", "--adapters", f"a={a},b={b}",
                    "--adapter-rotate", "--adapter-rank", "4")
    assert "wrote random rank-4 demo adapter" in text
    h = eng.health()["adapters"]
    assert h["loaded"] == 2 and h["requests"] == {"a": 1, "b": 1}
    # request 0 is base weights under --adapter-rotate
    assert tails(text)[0] == plain["scheduler"][0]
    assert tails(text)[1:] != plain["scheduler"][1:]
    # the files exist now: a second deploy loads them, on a router
    router, text = run(capsys, "--replicas", "2", "--adapters", f"a={a}",
                       "--adapter-rank", "4")
    assert "wrote random" not in text
    assert "adapter a: {'r0': 'loaded', 'r1': 'loaded'}" in text
    with pytest.raises(SystemExit):
        serve_llama.main(["--adapters", f"a={a}"] + BASE)


def test_calibrate_flag(capsys, tmp_path):
    npz = str(tmp_path / "scales.npz")
    eng, text = run(capsys, "--scheduler", "--calibrate", npz)
    assert "PTQ: calibrated 4 batches" in text and "quant=int8" in text
    assert eng.quant_scales is not None
    assert eng.weights["layers"][0]["wq"][0].dtype == torch.int8
    with np.load(npz) as z:
        assert len(z.files) > 0
    # calibrated scales equal the absmax-from-weights engine's
    _, ref = run(capsys, "--scheduler", "--quant", "int8")
    assert tails(text) == tails(ref)
