"""Dense-KV generation: paddle_tpu_torch's `models.generation.generate`
against the JAX package's.

Same weights (drawn in JAX, carried over with `convert.load_numpy_params`),
same prompts, tiny config in f32 on the CPU. The ids must be EXACTLY equal:
greedy (MHA and GQA with 2 kv heads, the reference's GQA regression), and
sampled with top-k / top-p for two seeds (the reference's key flow:
`key(seed)` draws the first token, one `split` before each later one).
EOS stops the loop once every row emitted it. The port's paged `LLMEngine`
equals the port's `generate` token for token (the reference's
`test_serving_engine.py` pattern). The seeds are pinned: exact equality
rests on them, because a near-tie between the top two logits could flip an
argmax between the two packages' roundings.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.generation import generate as jgenerate
from paddle_tpu_torch.convert import load_numpy_params
from paddle_tpu_torch.inference.serving import LLMEngine
from paddle_tpu_torch.models.generation import generate
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

torch.set_num_threads(1)
_MODELS = {}


def pair(seed=3, **kw):
    """(JAX model, port model) with identical weights drawn in JAX."""
    key = (seed, tuple(sorted(kw.items())))
    if key not in _MODELS:
        paddle.seed(seed)
        jm = JaxLlama(JaxConfig.tiny(**kw))
        tm = LlamaForCausalLM(LlamaConfig.tiny(**kw), device="cpu")
        load_numpy_params(tm, {n: np.asarray(p.data)
                               for n, p in jm.named_parameters()})
        _MODELS[key] = (jm, tm)
    return _MODELS[key]


def prompts(b=2, t=12, seed=0, vocab=128):
    return np.random.RandomState(seed).randint(0, vocab, (b, t)).astype(
        np.int64)


@pytest.mark.parametrize("kv", [None, 2], ids=["mha", "gqa2"])
def test_greedy_ids_equal_jax(kv):
    jm, tm = pair(**({} if kv is None else {"num_key_value_heads": kv}))
    ids = prompts()
    want = np.asarray(jgenerate(jm, ids, max_new_tokens=8))
    got = generate(tm, ids, max_new_tokens=8)
    assert got.shape == (2, 20) and got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 7])
def test_sampled_ids_equal_jax(seed):
    jm, tm = pair()
    ids = prompts(seed=1)
    kw = dict(max_new_tokens=8, do_sample=True, temperature=0.8, top_k=20,
              top_p=0.9, seed=seed)
    want = np.asarray(jgenerate(jm, ids, **kw))
    got = generate(tm, ids, **kw)
    np.testing.assert_array_equal(got, want)
    # the draws follow the key: another seed gives another stream
    other = generate(tm, ids, **dict(kw, seed=seed + 1))
    assert not np.array_equal(other, got)


def test_eos_stops_when_every_row_hit_it():
    jm, tm = pair()
    ids = prompts(b=1)
    full = generate(tm, ids, max_new_tokens=8)
    eos = int(full[0, 14])                 # the third generated token
    want = np.asarray(jgenerate(jm, ids, max_new_tokens=8,
                                eos_token_id=eos))
    got = generate(tm, ids, max_new_tokens=8, eos_token_id=eos)
    np.testing.assert_array_equal(got, want)
    first = int(np.argmax(full[0, 12:] == eos))
    assert got.shape == (1, 12 + first + 1) and got[0, -1] == eos


@pytest.mark.parametrize("kv", [None, 2], ids=["mha", "gqa2"])
def test_paged_engine_equals_generate(kv):
    _, tm = pair(seed=5, **({} if kv is None else {"num_key_value_heads": kv}))
    ids = prompts(seed=2)
    ref = generate(tm, ids, max_new_tokens=8)
    eng = LLMEngine(tm, max_len=64, page_size=16, max_batch=2, device="cpu")
    np.testing.assert_array_equal(eng.generate(ids, max_new_tokens=8), ref)


def test_generate_takes_a_tensor_and_refuses_other_models():
    _, tm = pair()
    ids = prompts(b=1)
    np.testing.assert_array_equal(
        generate(tm, torch.as_tensor(ids), max_new_tokens=3),
        generate(tm, ids, max_new_tokens=3))
    with pytest.raises(AssertionError, match="LLaMA"):
        generate(torch.nn.Linear(2, 2), ids)
