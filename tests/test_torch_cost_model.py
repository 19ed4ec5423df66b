"""The cost-model planner of paddle_tpu_torch against the JAX package's.

Replays each of the 19 tests of tests/test_cost_model.py against the port
(HBM fit, monotonicity, search against brute force, Plan / EngineSpec round
trips, the trainer consuming a plan, calibration files, the searched spec
building the hand-built engine, the `--check` CLI, the back-compat
surface), then holds the port's numbers to the reference's. These parity
tests pin EXACT values (`==` on floats): the port keeps the reference's
arithmetic term for term and in the same order, so on the same
calibration (the CPU nominal entry, `Calibration(backend="cpu")`, or the
same inline collective rows and residuals built here, never read from
`benchmarks/`) `predict_train_step`, `predict_serving`, `size_fleet` and
`search_plan` give the reference's floats and rankings.

Where the lists differ: the megakernel gates. The port lists "layer" and
"multi" specs where ITS kernel takes the geometry (d a multiple of 16);
the reference's gate wants d a multiple of 128. At 7B and 1.3B both take
it and the lists are equal; at `LlamaConfig.tiny()` (d 16) the port's
list less its megakernel specs is the reference's list.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu.cost_model as jcm
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu_torch.cost_model import (Calibration, CostModel, EngineSpec,
                                         Plan, brute_force_plans,
                                         enumerate_train_plans, model_params,
                                         predict_serving, predict_train_step,
                                         search_plan, size_fleet)
from paddle_tpu_torch.models.llama import LlamaConfig

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"preset": "tiny"}
SEVEN_B = {"preset": "config", "vocab_size": 32000, "hidden_size": 4096,
           "intermediate_size": 11008, "num_hidden_layers": 32,
           "num_attention_heads": 32, "max_position_embeddings": 2048}
ONE_P3B = {"preset": "config", "vocab_size": 32000, "hidden_size": 2048,
           "intermediate_size": 5504, "num_hidden_layers": 24,
           "num_attention_heads": 16, "max_position_embeddings": 2048}
CONFIGS = {"tiny": TINY, "7b": SEVEN_B, "1p3b": ONE_P3B}

# nominal-only calibration, as the reference's tests use
CAL = Calibration(backend="cpu")
JCAL = jcm.Calibration(backend="cpu")

# inline measured tables (made up here, the same for both packages)
ROWS = [{"verb": "allreduce", "kind": "exact", "size_bytes": 1 << 16,
         "gbps": 3.5},
        {"verb": "allreduce", "kind": "exact", "size_bytes": 1 << 22,
         "gbps": 41.0},
        {"verb": "allreduce", "kind": "exact", "size_bytes": 1 << 28,
         "gbps": 190.0},
        {"verb": "allreduce", "kind": "int8", "size_bytes": 1 << 18,
         "gbps": 1.25},
        {"verb": "allreduce", "kind": "int8", "size_bytes": 1 << 26,
         "gbps": 22.0},
        {"verb": "reducescatter", "kind": "exact", "size_bytes": 1 << 20,
         "gbps": 9.0}]
RESID = {"serving": {"tpot": 1.7, "ttft": 3.25},
         "training": {"step": 0.83}}


def calibs():
    """(port, JAX) calibration pairs the parity tests price under."""
    return {"nominal": (CAL, JCAL),
            "inline": (Calibration(backend="cpu", collectives=ROWS,
                                   residuals=RESID, coll_lat_ms=0.013),
                       jcm.Calibration(backend="cpu", collectives=ROWS,
                                       residuals=RESID, coll_lat_ms=0.013))}


def _same(a, b):
    """Ranked lists equal in plan fields, order and every cost float."""
    return ([(r.plan.to_json(), r.cost.total_ms, r.cost.breakdown,
              r.cost.hbm_gb, r.cost.fits, r.cost.dominant, r.rank)
             for r in a]
            == [(r.plan.to_json(), r.cost.total_ms, r.cost.breakdown,
                 r.cost.hbm_gb, r.cost.fits, r.cost.dominant, r.rank)
                for r in b])


# --------------------------------------------------------------------------
# the reference's 19 tests, on the port
# --------------------------------------------------------------------------

def test_hbm_fit_rejects_oversized_plan():
    cost = predict_train_step(SEVEN_B, Plan(), calib=CAL, hbm_cap_gb=16,
                              global_batch=8, seq=128)
    assert not cost.fits
    assert cost.hbm_gb > 16
    assert predict_train_step(SEVEN_B, Plan(), calib=CAL,
                              hbm_cap_gb=1000, global_batch=8,
                              seq=128).fits


def test_hbm_fit_prunes_from_search():
    ranked = search_plan(SEVEN_B, 1, mode="training", calib=CAL,
                         hbm_cap_gb=16, global_batch=8, seq=128)
    assert ranked == []
    unpruned = brute_force_plans(SEVEN_B, 1, mode="training", calib=CAL,
                                 hbm_cap_gb=16, global_batch=8, seq=128)
    assert unpruned and not any(r.cost.fits for r in unpruned)


def test_serving_hbm_accounts_tp_shrink():
    big = predict_serving(SEVEN_B, EngineSpec(), calib=CAL, hbm_cap_gb=16)
    tp4 = predict_serving(SEVEN_B, EngineSpec(tp=4), calib=CAL,
                          hbm_cap_gb=16)
    assert tp4.hbm_gb < big.hbm_gb


def test_cost_monotone_in_model_size():
    small = predict_train_step(TINY, Plan(), calib=CAL, global_batch=8,
                               seq=64)
    big = predict_train_step(SEVEN_B, Plan(), calib=CAL, global_batch=8,
                             seq=64)
    assert big.total_ms > small.total_ms
    s2 = predict_serving(TINY, EngineSpec(), calib=CAL)
    b2 = predict_serving(SEVEN_B, EngineSpec(), calib=CAL)
    assert b2.meta["tpot_ms"] > s2.meta["tpot_ms"]
    assert b2.meta["ttft_ms"] > s2.meta["ttft_ms"]


def test_cost_monotone_in_collective_volume():
    lo = predict_train_step(SEVEN_B, Plan(dp=2), calib=CAL,
                            global_batch=16, seq=64, hbm_cap_gb=1e9)
    hi = predict_train_step(SEVEN_B, Plan(dp=8), calib=CAL,
                            global_batch=16, seq=64, hbm_cap_gb=1e9)
    assert hi.breakdown["dp_sync"] > lo.breakdown["dp_sync"]
    assert (CAL.coll_ms("allreduce", "exact", 1 << 24)
            > CAL.coll_ms("allreduce", "exact", 1 << 20) > 0)


def test_int8_compression_cuts_predicted_wire_time():
    exact = predict_train_step(SEVEN_B, Plan(dp=8), calib=CAL,
                               global_batch=16, seq=64, hbm_cap_gb=1e9)
    int8 = predict_train_step(SEVEN_B, Plan(dp=8, grad_compress="int8"),
                              calib=CAL, global_batch=16, seq=64,
                              hbm_cap_gb=1e9)
    assert int8.breakdown["dp_sync"] < exact.breakdown["dp_sync"]


def test_search_returns_ranked_plans_both_modes():
    train = search_plan(TINY, 8, mode="training", calib=CAL,
                        global_batch=8, seq=64)
    serve = search_plan(TINY, 4, mode="serving", calib=CAL)
    for ranked in (train, serve):
        assert ranked
        totals = [r.cost.total_ms for r in ranked]
        assert totals == sorted(totals)
        assert [r.rank for r in ranked] == list(range(len(ranked)))
        assert all(r.cost.fits for r in ranked)
        assert ranked[0].why()
    assert all(isinstance(r.plan, Plan) for r in train)
    assert all(isinstance(r.plan, EngineSpec) for r in serve)
    for r in train:
        assert r.plan.devices() == 8
        assert 4 % r.plan.mp == 0 and 4 % r.plan.pp == 0


def test_search_matches_brute_force_tiny():
    kw = dict(mode="training", calib=CAL, global_batch=8, seq=64)
    top = search_plan(TINY, 4, top_k=3, **kw)
    oracle = [r for r in brute_force_plans(TINY, 4, **kw) if r.cost.fits]
    assert [r.plan for r in top] == [r.plan for r in oracle[:3]]
    assert [r.cost.total_ms for r in top] == \
        [r.cost.total_ms for r in oracle[:3]]


def test_search_is_deterministic():
    a = search_plan(TINY, 8, mode="serving", calib=CAL)
    b = search_plan(TINY, 8, mode="serving", calib=CAL)
    assert [r.plan for r in a] == [r.plan for r in b]


def test_enumerate_respects_divisibility():
    for p in enumerate_train_plans(TINY, 8):
        assert p.devices() == 8
        assert 4 % p.mp == 0
        assert 4 % p.pp == 0
        assert not (p.grad_accum > 1 and p.pp > 1)


def test_plan_json_round_trip(tmp_path):
    p = Plan(dp=2, mp=2, pp=1, sharding=2, sharding_stage=3,
             grad_compress="int8", grad_accum=4)
    assert Plan.from_json(p.to_json()) == p
    path = str(tmp_path / "plan.json")
    p.save(path)
    assert Plan.load(path) == p
    with pytest.raises(ValueError):
        Plan.from_json({"dp": 2, "bogus_knob": 1})
    assert p.mesh_axes() == {"data": 2, "pipe": 1, "sharding": 2,
                             "model": 2}
    # the saved file is the reference's, byte for byte
    jpath = str(tmp_path / "jplan.json")
    jcm.Plan(**p.to_json()).save(jpath)
    assert open(path).read() == open(jpath).read()
    assert Plan().build_mesh() == Plan().mesh_axes()
    with pytest.raises(NotImplementedError, match="A8"):
        p.build_mesh()


def test_engine_spec_round_trip(tmp_path):
    s = EngineSpec(model={"preset": "tiny", "seed": 0}, max_len=64,
                   page_size=16, max_batch=2, tp=2, megakernel="layer",
                   decode_block=4, replicas=2, prefill=1, decode=1)
    assert EngineSpec.from_json(s.to_json()) == s
    path = str(tmp_path / "spec.json")
    s.save(path)
    assert EngineSpec.load(path) == s
    assert s.topology() == {"prefill": 1, "decode": 1}
    kw = s.engine_kwargs()
    assert kw["tp"] == 2 and kw["decode_block"] == 4
    assert kw["megakernel"] == "layer"
    Plan().save(str(tmp_path / "p.json"))
    with pytest.raises(ValueError):
        EngineSpec.load(str(tmp_path / "p.json"))
    # a spec saved by the reference loads in the port, and back
    jpath = str(tmp_path / "jspec.json")
    jcm.EngineSpec(**s.to_json()).save(jpath)
    assert EngineSpec.load(jpath) == s
    assert open(path).read() == open(jpath).read()


def test_model_params_matches_built_model():
    for cfg in (LlamaConfig.tiny(), LlamaConfig.tiny(num_key_value_heads=2)):
        model = _cpu_model(cfg)
        real = sum(int(np.prod(p.shape)) for p in model.parameters())
        assert model_params(cfg) == real


def _cpu_model(cfg):
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    return LlamaForCausalLM(cfg, device="cpu", seed=0)


def test_trainer_consumes_plan():
    """The reference's test with grad_compress=None: the port's trainer
    takes int8 gradient compression with multi-device training (ROADMAP
    A8.2), so a plan that carries it raises the typed A8 refusal."""
    from paddle_tpu_torch.models.train_step import SpmdTrainer
    model = _cpu_model(LlamaConfig.tiny(num_hidden_layers=1))
    mesh = {"data": 1, "pipe": 1, "sharding": 1, "model": 1}
    plan = Plan(sharding_stage=3, grad_compress=None, grad_accum=2)
    tr = SpmdTrainer(model, mesh, plan=plan)
    assert tr.sharding_stage == 3
    assert tr.grad_compress is None
    assert tr.grad_accum == 2
    assert tr.plan == plan
    tr2 = SpmdTrainer(model, mesh, plan=plan.to_json())
    assert tr2.plan == plan
    assert SpmdTrainer(model, None, plan=plan).plan == plan
    with pytest.raises(ValueError, match="mesh axis"):
        SpmdTrainer(model, mesh, plan=Plan(dp=2))
    # the plan's fields go through the port's own checks after the mesh's
    with pytest.raises(NotImplementedError, match="A8"):
        SpmdTrainer(model, mesh, plan=Plan(grad_compress="int8"))
    with pytest.raises(NotImplementedError, match="A8"):
        SpmdTrainer(model, dict(mesh, data=2), plan=Plan(dp=2))
    assert SpmdTrainer(model, mesh).plan is None


def test_calibration_file_round_trip(tmp_path):
    path = str(tmp_path / "collectives.json")
    rows = [{"verb": "allreduce", "kind": "exact",
             "size_bytes": 1 << 20, "gbps": 1.0},
            {"verb": "allreduce", "kind": "exact",
             "size_bytes": 1 << 24, "gbps": 8.0}]
    with open(path, "w") as f:
        json.dump({"backend": "cpu", "collectives": rows}, f)
    cal = Calibration.load(path=path,
                           residuals_path=str(tmp_path / "none.json"))
    assert cal.source.startswith("calib:") and cal.backend == "cpu"
    assert cal.gbps("allreduce", "exact", 1 << 20) == 1.0
    assert cal.gbps("allreduce", "exact", 1 << 24) == 8.0
    mid = cal.gbps("allreduce", "exact", 1 << 22)
    assert 1.0 < mid < 8.0
    assert mid == jcm.Calibration(backend="cpu", collectives=rows).gbps(
        "allreduce", "exact", 1 << 22)
    assert cal.gbps("reducescatter", "int8", 1 << 20) == cal.coll_gbps
    with pytest.warns(UserWarning, match="no calibration file"):
        nom = Calibration.load(path=str(tmp_path / "missing.json"),
                               residuals_path=str(tmp_path / "n.json"))
    assert nom.source == "nominal" and nom.backend == "cuda"
    # a file measured on one backend prices nothing on another
    other = Calibration.load(path=path, backend="cuda",
                             residuals_path=str(tmp_path / "none.json"))
    assert other.source == "nominal" and not other.collectives
    with pytest.raises(ValueError, match="'cuda'"):
        Calibration(backend="tpu")


def test_checked_in_calibration_loads(monkeypatch):
    """The port ships its own H100 calibration (never the JAX package's
    CPU tables): measured constants, the on-card collective rows and the
    residuals, each value naming its source, the card named with its power
    limit. `Calibration.load()` reads it by default."""
    monkeypatch.delenv("PADDLE_TPU_CALIB", raising=False)
    path = os.path.join(ROOT, "paddle_tpu_torch", "calib", "h100.json")
    assert os.path.exists(path)
    cal = Calibration.load(path=path)
    assert cal.collectives
    assert cal.source.startswith("calib:")
    default = Calibration.load()
    assert default.backend == "cuda"
    assert default.source == "calib:h100.json+residuals"
    assert default.collectives == cal.collectives
    for k in ("tpot", "ttft"):
        assert default.residual("serving", k) > 0
    assert default.residual("training", "step") > 0
    with open(path) as f:
        d = json.load(f)
    assert d["backend"] == "cuda"
    assert d["device"].startswith("NVIDIA H100") and " W" in d["device"]
    assert d["run"] and d["date"]
    for k in ("peak_flops", "hbm_gbps", "hbm_cap_gb", "coll_lat_ms",
              "host_block_ms", "mfu"):
        assert d[k]["source"] and d[k]["value"] > 0
    assert {r["verb"] for r in d["collectives"]} == {"allreduce"}
    # --device cpu (the only CPU door) leaves the H100 figures out
    cpu = Calibration.load(backend="cpu")
    assert cpu.backend == "cpu" and cpu.source == "nominal"
    import paddle_tpu_torch.cost_model as tcm
    assert os.path.dirname(tcm.DEFAULT_CALIB_PATH) == os.path.dirname(path)
    with open(tcm.__file__) as f:
        src = f.read()
    assert "benchmarks/calib" not in src and '"benchmarks"' not in src


def test_searched_spec_builds_byte_identical_engine():
    """The top searched serving plan for the micro model, run through
    build_engine_from_spec, gives the hand-picked baseline engine's ids.
    On the CPU the port's search ranks its megakernel first (its gate
    takes tiny, the reference's does not); the hand-built dict carries the
    searched knobs, and the megakernel's plain version gives the op
    chain's ids."""
    from paddle_tpu_torch.inference.fleet import build_engine_from_spec
    base = EngineSpec(model={"preset": "tiny", "seed": 0}, max_len=64,
                      page_size=16, max_batch=2,
                      engine_extra={"device": "cpu"})
    ranked = search_plan(TINY, 1, mode="serving", base_spec=base, calib=CAL)
    assert ranked
    top = ranked[0].plan
    assert top.replicas == 1
    hand = {"model": {"preset": "tiny", "seed": 0},
            "engine": {"max_len": 64, "page_size": 16, "max_batch": 2,
                       "quant": None, "megakernel": top.megakernel,
                       "decode_block": top.decode_block, "device": "cpu"}}
    assert top.fleet_spec() == hand

    def run(spec):
        eng = build_engine_from_spec(spec)
        prompt = np.arange(1, 13, dtype=np.int64) % 128
        uid = eng.add_request(prompt, max_new_tokens=6)
        eng.drain()
        return eng.result(uid)

    out_searched = run(top)
    baseline = {"model": {"preset": "tiny", "seed": 0},
                "engine": {"max_len": 64, "page_size": 16,
                           "max_batch": 2, "device": "cpu"}}
    np.testing.assert_array_equal(out_searched, run(baseline))
    # the reference's pick on its own gate: the op chain, equal ids too
    jtop = jcm.search_plan(TINY, 1, mode="serving", calib=JCAL,
                           base_spec=jcm.EngineSpec(**{
                               **base.to_json(), "engine_extra": {}}))[0].plan
    assert jtop.megakernel is False
    np.testing.assert_array_equal(
        run(dict(jtop.fleet_spec(), engine=dict(
            jtop.fleet_spec()["engine"], device="cpu"))), out_searched)


def test_cost_model_check_cli():
    r = subprocess.run([sys.executable, "-m", "paddle_tpu_torch.cost_model",
                        "--check"], capture_output=True, text=True,
                       timeout=120, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "cost_model check: OK" in r.stdout
    assert "backend=cuda" in r.stdout


def test_cost_model_back_compat_surface():
    cm = CostModel()
    assert cm.static_cost_data() == {}
    assert cm.get_static_op_time("matmul") == {}
    cost = cm.analyze(lambda a: a @ a, torch.ones((8, 8)))
    assert cost == {"flops": 2.0 * 8 ** 3}
    with pytest.raises(NotImplementedError, match="A9.3"):
        cm.profile_measure()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cm.measure_peak_flops(dim=8, iters=1)
    assert CostModel(CAL).predict_serving(TINY, EngineSpec()).total_ms == \
        predict_serving(TINY, EngineSpec(), calib=CAL).total_ms


# --------------------------------------------------------------------------
# parity with the reference: exact floats and orders
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cal", ["nominal", "inline"])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_predictions_equal_reference_exactly(cfg, n, cal):
    """Every enumerated training plan and serving spec priced by both
    packages (brute force: no pruning, every float compared with ==), and
    size_fleet's replica count and record."""
    model = CONFIGS[cfg]
    tc, jc = calibs()[cal]
    knobs = {"megakernel": (False,)} if cfg == "tiny" else None
    for mode, kw in (("training", dict(global_batch=16, seq=256)),
                     ("serving", dict(prompt_len=96, gen_tokens=40,
                                      knobs=knobs))):
        got = brute_force_plans(model, n, mode=mode, calib=tc, **kw)
        want = jcm.brute_force_plans(model, n, mode=mode, calib=jc, **kw)
        assert got and _same(got, want)
    spec = {"model": dict(model, seed=0),
            "engine": {"max_len": 512, "page_size": 64, "max_batch": 4,
                       "weight_dtype": "bfloat16", "decode_block": 8}}
    for qps in (0.5, 40.0):
        got = size_fleet(spec, qps=qps * n, calib=tc)
        assert got == jcm.size_fleet(spec, qps=qps * n, calib=jc)


@pytest.mark.parametrize("mode", ["training", "serving"])
def test_search_ranking_equals_reference_at_7b(mode):
    """The default knobs at 7B (both megakernel gates take it)."""
    for n in (1, 2, 4, 8):
        assert _same(search_plan(SEVEN_B, n, mode=mode, calib=CAL),
                     jcm.search_plan(SEVEN_B, n, mode=mode, calib=JCAL))


def test_search_ranking_equals_reference_tiny_without_megakernel():
    for n in (1, 2, 4, 8):
        assert _same(search_plan(TINY, n, mode="serving", calib=CAL,
                                 knobs={"megakernel": (False,)}),
                     jcm.search_plan(TINY, n, mode="serving", calib=JCAL,
                                     knobs={"megakernel": (False,)}))


def test_tiny_megakernel_gate_divergence():
    """The one place the lists part: at tiny (d 16) the port's gate takes
    the geometry and the reference's (d % 128) does not. The port's ranked
    list less its megakernel specs is the reference's list, in order,
    floats equal; at 7B and 1.3B the gates agree."""
    from paddle_tpu.ops.pallas.decode_megakernel import \
        megakernel_supported as jgate
    from paddle_tpu_torch.ops.pallas.decode_megakernel import \
        megakernel_supported as tgate
    assert tgate(4, 4, 16, 64, 128) and not jgate(4, 4, 16, 64, 128)
    for geo in ((32, 32, 128, 4096, 11008), (16, 16, 128, 2048, 5504)):
        assert tgate(*geo) and jgate(*geo)
    for n in (1, 4):
        got = search_plan(TINY, n, mode="serving", calib=CAL, top_k=None)
        want = jcm.search_plan(TINY, n, mode="serving", calib=JCAL,
                               top_k=None)
        assert any(r.plan.megakernel for r in got)
        assert not any(r.plan.megakernel for r in want)
        rest = [r for r in got if r.plan.megakernel in (False, None)]
        key = [(r.plan.to_json(), r.cost.total_ms) for r in rest]
        assert key == [(r.plan.to_json(), r.cost.total_ms) for r in want]


def test_engine_spec_from_model_cfg_json_equal():
    """The config's fields cross as plain data: vars() of both packages'
    LlamaConfig.tiny() / llama_7b() hold the same 13 keys and values, so
    the spec JSON is equal."""
    for t, j in ((LlamaConfig.tiny(), JaxConfig.tiny()),
                 (LlamaConfig.llama_7b(), JaxConfig.llama_7b()),
                 (LlamaConfig.tiny(num_key_value_heads=2),
                  JaxConfig.tiny(num_key_value_heads=2))):
        assert vars(t) == vars(j) and len(vars(t)) == 13
        assert (EngineSpec.from_model_cfg(t, seed=5, max_len=128).to_json()
                == jcm.EngineSpec.from_model_cfg(j, seed=5,
                                                 max_len=128).to_json())
