"""LLaMA model: paddle_tpu_torch against the JAX reference.

Parameters cross by name with no transposes and come back bit-exact; the
forward logits of the tiny config (MHA and GQA), and of
`__graft_entry__.entry()`'s model, match the JAX model on the same weights
within atol = rtol = 1e-4 in f32 (matmuls and softmax sum in another
order), with equal argmax ids; the pretraining criterion matches the
reference's token-mean CE within rtol 1e-6.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.convert import load_numpy_params
from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                           _rope_cache)

torch.set_num_threads(1)


def _pair(seed, **kw):
    paddle.seed(seed)
    jm = JaxLlama(JaxConfig.tiny(**kw))
    arrays = {n: np.asarray(p.data) for n, p in jm.named_parameters()}
    tm = LlamaForCausalLM(LlamaConfig.tiny(**kw), device="cpu", seed=seed)
    return jm, tm, arrays


def test_parameter_round_trip_bit_exact():
    jm, tm, arrays = _pair(11, num_key_value_heads=2)
    assert [n for n, _ in tm.named_parameters()] == list(arrays)
    load_numpy_params(tm, arrays)
    for name, p in tm.named_parameters():
        np.testing.assert_array_equal(
            p.detach().numpy().view(np.uint32), arrays[name].view(np.uint32))


def test_load_rejects_mismatch():
    _, tm, arrays = _pair(12, num_hidden_layers=1)
    bad = dict(arrays)
    bad["lm_head.weight"] = bad["lm_head.weight"].T
    with pytest.raises(ValueError, match="shape"):
        load_numpy_params(tm, bad)
    bad = dict(arrays)
    bad.pop("llama.norm.weight")
    with pytest.raises(ValueError, match="missing"):
        load_numpy_params(tm, bad)


@pytest.mark.parametrize("kv_heads", [None, 2], ids=["mha", "gqa2"])
def test_forward_logits_match_jax(kv_heads):
    jm, tm, arrays = _pair(13, num_key_value_heads=kv_heads,
                           num_hidden_layers=2)
    load_numpy_params(tm, arrays)
    ids = np.random.RandomState(5).randint(0, 128, (2, 10)).astype(np.int64)
    ref = np.asarray(jm(paddle.to_tensor(ids)).numpy())
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_init_distributions():
    """Xavier-uniform projections, Xavier-normal embedding, unit norms —
    the reference's initialisers (the draws themselves differ)."""
    cfg = LlamaConfig.tiny(vocab_size=512, hidden_size=128,
                           num_hidden_layers=1)
    m = LlamaForCausalLM(cfg, device="cpu", seed=0)
    wq = m.llama.layers[0].self_attn.q_proj.weight.detach()
    limit = (6.0 / (128 + 128)) ** 0.5
    assert float(wq.abs().max()) <= limit
    assert float(wq.abs().max()) > 0.95 * limit
    emb = m.llama.embed_tokens.weight.detach()
    std = (2.0 / (512 + 128)) ** 0.5
    assert abs(float(emb.std()) - std) < 0.05 * std
    assert torch.equal(m.llama.norm.weight, torch.ones(128))
    again = LlamaForCausalLM(cfg, device="cpu", seed=0)
    assert torch.equal(again.lm_head.weight, m.lm_head.weight)


def test_rope_cache_matches_jax():
    from paddle_tpu.models.llama import _rope_cache as jax_rope
    import jax.numpy as jnp
    c, s = _rope_cache(64, 16, 10000.0)
    jc, js = jax_rope(64, 16, 10000.0, jnp.float32)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_forward_matches_graft_entry():
    """`entry()`'s forward (LlamaConfig.tiny(), paddle.seed(0)) on its own
    example ids, and on random ones, through the weights it returns."""
    import jax
    from __graft_entry__ import entry
    fn, args = entry()
    ids, weights = args[0], args[1:]
    ids2 = np.random.RandomState(9).randint(0, 128, (2, 16)).astype(np.int64)
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    names = [n for n, _ in tm.named_parameters()]
    assert len(names) == len(weights)
    load_numpy_params(tm, {n: np.asarray(w) for n, w in zip(names, weights)})
    jfn = jax.jit(fn)
    for x in (ids, ids2):
        ref = np.asarray(jfn(x, *weights))
        with torch.no_grad():
            got = tm(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


def test_pretraining_criterion_matches_jax():
    from paddle_tpu.models.llama import (
        LlamaPretrainingCriterion as JaxCriterion)
    from paddle_tpu_torch.models import LlamaPretrainingCriterion
    rs = np.random.RandomState(4)
    logits = rs.standard_normal((2, 6, 40)).astype(np.float32) * 2
    labels = rs.randint(0, 40, (2, 6)).astype(np.int64)
    labels[0, :2] = -100
    ref = float(JaxCriterion(JaxConfig.tiny())(paddle.to_tensor(logits),
                                               paddle.to_tensor(labels)))
    got = LlamaPretrainingCriterion()(torch.from_numpy(logits),
                                      torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), ref, rtol=1e-6)
    tm = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1), device="cpu")
    ids = torch.from_numpy(labels.clip(0))
    with torch.no_grad():
        loss = tm(ids, torch.from_numpy(labels))
        want = LlamaPretrainingCriterion()(tm(ids), torch.from_numpy(labels))
    assert torch.equal(loss, want)
