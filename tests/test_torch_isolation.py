"""paddle_tpu_torch stands alone: importing it (every submodule) loads
neither jax nor paddle_tpu, no source of the port imports them, and on a
machine without CUDA its entry points refuse to run unless asked for the
CPU."""
import math
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "paddle_tpu_torch"

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import paddle_tpu_torch
for m in pkgutil.walk_packages(paddle_tpu_torch.__path__, "paddle_tpu_torch."):
    importlib.import_module(m.name)
importlib.import_module("paddle_tpu_torch.serve_llama")
importlib.import_module("paddle_tpu_torch.train_llama")
assert "paddle_tpu_torch.inference.sampling" in sys.modules
assert "paddle_tpu_torch.framework.random" in sys.modules
assert "paddle_tpu_torch.models.gpt" in sys.modules
assert "paddle_tpu_torch.models.bert" in sys.modules
assert "paddle_tpu_torch.nn.transformer" in sys.modules
assert "paddle_tpu_torch.optimizer.optimizers" in sys.modules
assert "paddle_tpu_torch.failsafe" in sys.modules
assert "paddle_tpu_torch.inference.telemetry" in sys.modules
assert "paddle_tpu_torch.quantization.ptq" in sys.modules
assert "paddle_tpu_torch.quantization.observers" in sys.modules
assert "paddle_tpu_torch.inference.adapters" in sys.modules
assert "paddle_tpu_torch.inference.handoff" in sys.modules
assert "paddle_tpu_torch.inference.tiering" in sys.modules
assert "paddle_tpu_torch.ops.lora" in sys.modules
assert "paddle_tpu_torch.inference.router" in sys.modules
assert "paddle_tpu_torch.inference.prefix_index" in sys.modules
assert "paddle_tpu_torch.inference.fleet" in sys.modules
assert "paddle_tpu_torch.distributed.checkpoint" in sys.modules
assert "paddle_tpu_torch.distributed.store" in sys.modules
assert "paddle_tpu_torch.distributed.rpc" in sys.modules
assert "paddle_tpu_torch.distributed.spawn" in sys.modules
assert "paddle_tpu_torch.inference.autoscale" in sys.modules
assert "paddle_tpu_torch.cost_model" in sys.modules
assert "paddle_tpu_torch.models.generation" in sys.modules
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.") or n == "jaxlib"
             or n == "paddle_tpu" or n.startswith("paddle_tpu."))
print("LOADED", len([n for n in sys.modules if n.startswith("paddle_tpu_torch")]))
print("BAD", bad)
"""


def test_import_loads_neither_jax_nor_paddle_tpu():
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout
    n_loaded = int(r.stdout.split("LOADED ")[1].split()[0])
    assert n_loaded >= 13, r.stdout


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+jaxlib\b|"
    r"import\s+paddle_tpu(?!_torch)\b|from\s+paddle_tpu(?!_torch)\b)",
    re.MULTILINE)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in list(PORT.rglob("*.py"))
    + [ROOT / "chip_smoke.py"]))
def test_source_imports_neither_jax_nor_paddle_tpu(path):
    text = (ROOT / path).read_text()
    hits = _FORBIDDEN.findall(text)
    assert not hits, f"{path} imports {hits}"


_PROBE = """
import sys
from paddle_tpu_torch.inference.fleet import build_engine_from_spec


def factory():
    eng = build_engine_from_spec({
        "model": {"preset": "tiny", "seed": 0, "num_hidden_layers": 1},
        "engine": {"max_len": 32, "page_size": 8, "max_batch": 2,
                   "device": "cpu"}})
    health = eng.health

    def probed():
        # what the worker process has loaded by now, read at call time
        bad = sorted(n for n in sys.modules
                     if n == "jax" or n.startswith("jax.") or n == "jaxlib"
                     or n == "paddle_tpu" or n.startswith("paddle_tpu."))
        return dict(health(), probe_bad=bad, probe_port=len(
            [n for n in sys.modules if n.startswith("paddle_tpu_torch")]))
    eng.health = probed
    return eng
"""


def test_spawned_fleet_worker_loads_neither_jax_nor_paddle_tpu(
        tmp_path, monkeypatch):
    """A worker process of `spawn_fleet` (the `spawn` start method, the
    fleet's engine, store, RPC and prefix-index modules, a routed request,
    telemetry pulls) never imports jax or paddle_tpu, even when the process
    that spawns it has both loaded."""
    from paddle_tpu_torch.inference.fleet import spawn_fleet
    from paddle_tpu_torch.inference.router import EngineRouter
    (tmp_path / "ptt_isolation_probe.py").write_text(_PROBE)
    monkeypatch.syspath_prepend(str(tmp_path))
    handle = spawn_fleet("ptt_isolation_probe:factory", 1)
    try:
        router = EngineRouter(backends=handle.replicas,
                              prefix_index=handle.prefix_index,
                              telemetry=True)
        u = router.add_request(np.arange(1, 9), 4)
        router.drain()
        assert router.result(u).size == 12
        router.metrics()
        h = handle.replicas[0].health()
        assert h["probe_bad"] == [] and h["probe_port"] >= 13, h
        assert handle.replicas[0].transport_endpoint()["backend"] == "cpu"
    finally:
        handle.shutdown()


def test_engine_refuses_cpu_without_being_asked():
    from paddle_tpu_torch.inference.serving import LLMEngine
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(LlamaConfig.tiny())
    model = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1),
                             device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLMEngine(model, max_len=32, page_size=16, max_batch=1)
    LLMEngine(model, max_len=32, page_size=16, max_batch=1, device="cpu")


def test_cb_engine_refuses_cpu_without_being_asked():
    from paddle_tpu_torch.inference.scheduler import ContinuousBatchingEngine
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    model = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1),
                             device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousBatchingEngine(model, max_len=32, page_size=16,
                                 max_batch=1)
    eng = ContinuousBatchingEngine(model, max_len=32, page_size=16,
                                   max_batch=1, device="cpu")
    assert eng.device == torch.device("cpu")


def test_kernel_wrappers_count_only_kernel_launches():
    """CPU tensors take the plain versions, which launch nothing; a
    training step (every norm, attention forward and backward), a GPT
    training step with attention dropout, a BERT MLM step (masked,
    non-causal attention with dropout, AdamW), and
    megakernel decode steps on the CPU, greedy and sampled through the
    top-K fold, speculative verify passes (the op chain's verify entry and
    the megakernel's tq > 1 schedule) and tensor-parallel megakernel steps
    (the segments, tp = 2) launch nothing either, nor does an adapter
    request's LoRA delta (`ops/lora.py`'s plain version)."""
    from paddle_tpu_torch.inference.sampling import SamplingParams
    from paddle_tpu_torch.inference.scheduler import ContinuousBatchingEngine
    from paddle_tpu_torch.models import SpmdTrainer
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from paddle_tpu_torch.ops.pallas.quantized_matmul import (
        quantize_weights, quantized_matmul)
    reset_kernel_launches()
    wq, sc = quantize_weights(torch.randn(32, 16))
    quantized_matmul(torch.randn(2, 32), wq, sc)
    tr = SpmdTrainer(LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1),
                                      device="cpu"), recompute=True)
    ids = torch.randint(0, 128, (2, 8))
    tr.step(tr.init_state(), ids, ids)
    eng = ContinuousBatchingEngine(tr.model, max_len=32, page_size=8,
                                   max_batch=2, megakernel="multi",
                                   device="cpu")
    eng.generate_many([np.arange(5), np.arange(3)], max_new_tokens=3)
    eng.add_request(np.arange(4), 3,
                    sampling=SamplingParams(do_sample=True, seed=1))
    eng.drain()
    for mk in (False, "multi"):
        spec = ContinuousBatchingEngine(tr.model, max_len=32, page_size=8,
                                        max_batch=2, megakernel=mk,
                                        speculate=3, device="cpu")
        spec.generate_many([np.arange(5) % 2, np.arange(3)],
                           max_new_tokens=4)
        assert spec.health()["spec_passes"] > 0
    tp2 = ContinuousBatchingEngine(tr.model, max_len=32, page_size=8,
                                   max_batch=2, megakernel="multi", tp=2,
                                   device="cpu")
    tp2.generate_many([np.arange(5), np.arange(3)], max_new_tokens=3)
    from paddle_tpu_torch.inference.adapters import make_lora_adapter
    lora = ContinuousBatchingEngine(tr.model, max_len=32, page_size=8,
                                    max_batch=2, adapters={"rank": 2},
                                    device="cpu")
    lora.load_adapter("a", make_lora_adapter(tr.model.config, rank=2))
    lora.add_request(np.arange(5), 3, adapter="a")
    assert lora.drain()
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    gpt = SpmdTrainer(GPTForCausalLM(GPTConfig.tiny(num_hidden_layers=1),
                                     device="cpu"), recompute=True)
    gpt.step(gpt.init_state(), ids, ids)
    from paddle_tpu_torch.models.bert import BertConfig, BertForMaskedLM
    from paddle_tpu_torch.optimizer import AdamW
    bert = BertForMaskedLM(BertConfig.tiny(num_hidden_layers=1),
                           device="cpu")
    opt = AdamW(1e-3, parameters=bert.parameters())
    am = torch.ones(2, 8, dtype=torch.int64)
    am[1, 5:] = 0
    bert(ids, attention_mask=am, labels=ids).backward()
    opt.step()
    assert kernel_launches() == {"quantized_matmul": 0, "paged_attention": 0,
                                 "flash_attention_fwd": 0,
                                 "ragged_paged_attention": 0,
                                 "spec_verify_attention": 0, "rms_norm": 0,
                                 "flash_attention_bwd": 0,
                                 "decode_megakernel": 0,
                                 "decode_megakernel_topk": 0,
                                 "decode_megakernel_verify": 0,
                                 "decode_megakernel_tp": 0,
                                 "ragged_paged_attention_tc": 0,
                                 "flash_attention_fwd_tc": 0,
                                 "flash_attention_bwd_tc": 0,
                                 "flash_attention_fwd_dropout": 0,
                                 "flash_attention_bwd_dropout": 0,
                                 "flash_attention_fwd_masked": 0,
                                 "flash_attention_bwd_masked": 0,
                                 "flash_attention_fwd_noncausal": 0,
                                 "flash_attention_bwd_noncausal": 0,
                                 "paged_attention_staged": 0,
                                 "ragged_paged_attention_staged": 0,
                                 "spec_verify_attention_staged": 0,
                                 "quantized_matmul_tc": 0,
                                 "quantized_matmul_ring": 0,
                                 "lora": 0}


def test_fleet_worker_refuses_cpu_without_being_asked():
    """A fleet worker's engine runs on CUDA unless its spec asks for the
    CPU: without a card, a spec with no device raises, one with "cpu"
    builds."""
    from paddle_tpu_torch.inference.fleet import build_engine_from_spec
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    spec = {"model": {"preset": "tiny", "seed": 0, "num_hidden_layers": 1},
            "engine": {"max_len": 32, "page_size": 8, "max_batch": 1}}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_engine_from_spec(spec)
    spec["engine"]["device"] = "cpu"
    assert build_engine_from_spec(spec).device == torch.device("cpu")


def test_training_entry_points_refuse_cpu_without_being_asked():
    from paddle_tpu_torch.train_llama import run_config
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_config("tiny", steps=1, warmup=0)
    r = run_config("tiny", steps=1, warmup=1, device="cpu")
    assert r["device"] == "cpu" and r["mfu"] is None and r["peak_gb"] is None
    assert len(r["losses"]) == 2 and all(map(math.isfinite, r["losses"]))


def test_gpt_entry_points_refuse_cpu_without_being_asked():
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.train_llama import run_config
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPTForCausalLM(GPTConfig.tiny())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_config("gpt_tiny", steps=1, warmup=0)
    r = run_config("gpt_tiny", steps=1, warmup=1, device="cpu")
    assert r["device"] == "cpu" and r["mfu"] is None and r["peak_gb"] is None
    assert r["n_params"] == sum(
        p.numel() for p in GPTForCausalLM(GPTConfig.tiny(),
                                          device="cpu").parameters())
    assert len(r["losses"]) == 2 and all(map(math.isfinite, r["losses"]))


def test_bert_entry_points_refuse_cpu_without_being_asked():
    """The BERT models and the encoder layers run on CUDA by default and
    refuse the CPU unless asked; AdamW keeps its state on its parameters'
    device (it picks none), so over a CPU model it steps on the CPU."""
    from paddle_tpu_torch.models.bert import (BertConfig, BertForMaskedLM,
                                              BertForSequenceClassification)
    from paddle_tpu_torch.nn.transformer import (MultiHeadAttention,
                                                 TransformerEncoderLayer)
    from paddle_tpu_torch.optimizer import AdamW
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg = BertConfig.tiny(num_hidden_layers=1)
    for make in (lambda: BertForMaskedLM(cfg),
                 lambda: BertForSequenceClassification(cfg),
                 lambda: MultiHeadAttention(16, 2),
                 lambda: TransformerEncoderLayer(16, 2, 32)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    model = BertForMaskedLM(cfg, device="cpu")
    opt = AdamW(1e-3, parameters=model.parameters())
    ids = torch.randint(0, cfg.vocab_size, (2, 8))
    model(ids, labels=ids).backward()
    opt.step()
    state = opt._accumulators["__state__"]
    assert state and all(t.device.type == "cpu" for st in state.values()
                         for t in st.values())


def test_unsupported_device_raises():
    from paddle_tpu_torch import resolve_device
    with pytest.raises(ValueError):
        resolve_device("meta")
    assert resolve_device("cpu") == torch.device("cpu")
