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
    assert n_loaded >= 12, r.stdout


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
    training step (every norm, attention forward and backward) and
    megakernel decode steps on the CPU launch nothing either."""
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
    assert kernel_launches() == {"quantized_matmul": 0, "paged_attention": 0,
                                 "flash_attention_fwd": 0,
                                 "ragged_paged_attention": 0, "rms_norm": 0,
                                 "flash_attention_bwd": 0,
                                 "decode_megakernel": 0}


def test_training_entry_points_refuse_cpu_without_being_asked():
    from paddle_tpu_torch.train_llama import run_config
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_config("tiny", steps=1, warmup=0)
    r = run_config("tiny", steps=1, warmup=1, device="cpu")
    assert r["device"] == "cpu" and r["mfu"] is None and r["peak_gb"] is None
    assert len(r["losses"]) == 2 and all(map(math.isfinite, r["losses"]))


def test_unsupported_device_raises():
    from paddle_tpu_torch import resolve_device
    with pytest.raises(ValueError):
        resolve_device("meta")
    assert resolve_device("cpu") == torch.device("cpu")
