"""GPT model: paddle_tpu_torch against the JAX reference, and the nn pieces
it is built from.

What each test pins:
  - exact bits: parameter names and order equal the reference's and come
    back bit for bit through `convert.load_numpy_params`;
  - tolerance, dropout off (eval mode, the reference's XLA sdpa): logits
    and loss of `GPTConfig.tiny(num_hidden_layers=2)` within
    atol = rtol = 1e-4 in f32 (products and softmax sum in another order);
  - tolerance, dropout on (training mode, hidden 0.1 and attention 0.1,
    both sides in one `key_scope`; the reference under
    `force_backend("pallas")` with interpret flash builds patched in, as
    `tests/test_flash_dropout.py` runs them): loss within rtol 1e-5 and
    every parameter's grad within atol 1e-5 (f32 sums in another order;
    the dropout masks are the same bits, so a wrong bit would move a grad
    by ~1e-2);
  - exact bits: `F.dropout` (f32 and bf16, so the division by 1 - p in
    the input's dtype), against the reference's under one key;
  - tolerance: `F.layer_norm` within 1e-6 in f32 and, in bf16, one ulp
    at the outputs' magnitude (|y| < 4: 2^-6);
    `F.gelu(approximate=True)` within 1e-6 in f32;
  - the initialisers' distributions and the refusals (the pipeline
    LayerDesc list, ROADMAP A8.7).
"""
import numpy as np
import pytest
import torch

import jax
import paddle_tpu as paddle
from paddle_tpu.framework import random as jrnd
from paddle_tpu.models.gpt import GPTConfig as JaxConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops import force_backend
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch.convert import load_numpy_params
from paddle_tpu_torch.framework import random as R
from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForCausalLM,
                                         gpt_pipeline_layers)
from paddle_tpu_torch.nn import functional as F

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    paddle.seed(5)
    jm = JaxGPT(JaxConfig.tiny(num_hidden_layers=2))
    arrays = {n: np.asarray(p.data) for n, p in jm.named_parameters()}
    tm = GPTForCausalLM(GPTConfig.tiny(num_hidden_layers=2), device="cpu")
    return jm, tm, arrays


def _batch(seed=0, b=2, s=32):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 128, (b, s)).astype(np.int64)
    labels = np.roll(ids, -1, axis=1)
    labels[0, :3] = -100
    return ids, labels


def test_parameter_round_trip_bit_exact(pair):
    jm, tm, arrays = pair
    assert [n for n, _ in tm.named_parameters()] == list(arrays)
    load_numpy_params(tm, arrays)
    for name, p in tm.named_parameters():
        np.testing.assert_array_equal(
            p.detach().numpy().view(np.uint32), arrays[name].view(np.uint32))


@pytest.fixture(scope="module")
def eval_reference(pair):
    """The reference's logits and loss in eval mode (dropout off)."""
    jm, _, _ = pair
    ids, labels = _batch(1)
    jm.eval()
    try:
        ref = np.asarray(jm(paddle.to_tensor(ids)).numpy())
        ref_loss = float(jm(paddle.to_tensor(ids), paddle.to_tensor(labels)))
    finally:
        jm.train()
    return ids, labels, ref, ref_loss


def test_forward_and_loss_dropout_off_match_jax(pair, eval_reference):
    _, tm, arrays = pair
    load_numpy_params(tm, arrays)
    ids, labels, ref, ref_loss = eval_reference
    tm.eval()
    try:
        with torch.no_grad():
            got = tm(torch.from_numpy(ids)).numpy()
            loss = float(tm(torch.from_numpy(ids), torch.from_numpy(labels)))
    finally:
        tm.train()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)


@pytest.fixture(scope="module")
def dropout_reference(pair):
    """The reference's loss and grads in training mode (dropout on), in
    key_scope(key(9)), through the Pallas sdpa with interpret builds."""
    jm, _, _ = pair
    ids, labels = _batch(2)
    key = jax.random.key(9)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jfa._dropout_flash_cache, 0.1, jfa.make_flash_attention(
            bq=32, bk=32, interpret=True, dropout_p=0.1))
        mp.setattr(jfa, "_default_flash",
                   jfa.make_flash_attention(bq=32, bk=32, interpret=True))
        for p in jm.parameters():
            p.grad = None
        with force_backend("pallas"), jrnd.key_scope(key):
            loss = jm(paddle.to_tensor(ids), paddle.to_tensor(labels))
            loss.backward()
    grads = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()}
    for p in jm.parameters():
        p.grad = None
    return float(loss), grads, ids, labels, np.asarray(jax.random.key_data(key))


def test_dropout_on_matches_pallas_reference(pair, dropout_reference):
    _, tm, arrays = pair
    load_numpy_params(tm, arrays)
    ref_loss, ref_grads, ids, labels, kd = dropout_reference
    tm.zero_grad(set_to_none=True)
    with R.key_scope(kd) as box:
        loss = tm(torch.from_numpy(ids), torch.from_numpy(labels))
        loss.backward()
        # the embedding, then (attention seed, hidden dropout) per layer
        assert box[1] == 1 + 2 * 2
    np.testing.assert_allclose(float(loss), ref_loss, rtol=1e-5)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[name], rtol=0,
                                   atol=1e-5, err_msg=name)
    # another key, another loss
    with R.key_scope(R.key(10)):
        other = float(tm(torch.from_numpy(ids), torch.from_numpy(labels)))
    assert other != float(loss)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("axis", [None, 1])
def test_dropout_bits_equal_reference(dtype, axis):
    x = np.random.RandomState(3).randn(4, 6, 8).astype(np.float32)
    key = jax.random.key(17)
    jx = paddle.to_tensor(x).astype(dtype)
    with jrnd.key_scope(key):
        ref = np.asarray(JF.dropout(jx, 0.1, axis=axis).astype(
            "float32").numpy())
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    with R.key_scope(np.asarray(jax.random.key_data(key))):
        got = F.dropout(tx, 0.1, axis=axis)
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(got.float().numpy(), ref)
    assert F.dropout(tx, 0.1, training=False) is tx
    if dtype == "float32":
        np.testing.assert_allclose(
            F.dropout(tx, 0.1, training=False,
                      mode="downscale_in_infer").numpy(), x * 0.9, rtol=1e-6)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-6),
                                        ("bfloat16", 2 ** -6)])
def test_layer_norm_matches_reference(dtype, atol):
    rng = np.random.RandomState(4)
    x = (rng.randn(3, 5, 64) * 3 + 1).astype(np.float32)
    w = (1 + 0.1 * rng.randn(64)).astype(np.float32)
    b = (0.1 * rng.randn(64)).astype(np.float32)
    ref = JF.layer_norm(paddle.to_tensor(x).astype(dtype), 64,
                        paddle.to_tensor(w).astype(dtype),
                        paddle.to_tensor(b).astype(dtype))
    ref = np.asarray(ref.astype("float32").numpy())
    t = getattr(torch, dtype)
    got = F.layer_norm(torch.from_numpy(x).to(t), 64,
                       torch.from_numpy(w).to(t), torch.from_numpy(b).to(t))
    assert got.dtype == t
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=atol)


def test_gelu_matches_reference():
    x = np.linspace(-6, 6, 301).astype(np.float32)
    for approximate in (True, False):
        ref = np.asarray(JF.gelu(paddle.to_tensor(x),
                                 approximate=approximate).numpy())
        got = F.gelu(torch.from_numpy(x), approximate=approximate).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_init_distributions_and_refusals():
    cfg = GPTConfig.tiny(vocab_size=512, hidden_size=128, num_hidden_layers=1)
    m = GPTForCausalLM(cfg, device="cpu", seed=0)
    wq = m.gpt.h[0].attn.q_proj.weight.detach()
    limit = (6.0 / (128 + 128)) ** 0.5
    assert limit * 0.95 < float(wq.abs().max()) <= limit
    assert torch.equal(m.gpt.h[0].attn.q_proj.bias, torch.zeros(128))
    emb = m.gpt.embeddings.word_embeddings.weight.detach()
    std = (2.0 / (512 + 128)) ** 0.5
    assert abs(float(emb.std()) - std) < 0.05 * std
    pos = m.gpt.embeddings.position_embeddings.weight.detach()
    assert abs(float(pos.std()) - 1.0) < 0.05
    assert torch.equal(m.gpt.ln_f.weight, torch.ones(128))
    assert m.lm_head.bias is None
    again = GPTForCausalLM(cfg, device="cpu", seed=0)
    assert torch.equal(again.lm_head.weight, m.lm_head.weight)
    assert cfg.intermediate_size == 512
    big = GPTConfig.gpt3_1p3b()
    assert (big.vocab_size, big.hidden_size, big.num_hidden_layers,
            big.num_attention_heads, big.max_position_embeddings) == (
                50304, 2048, 24, 16, 1024)
    with pytest.raises(NotImplementedError, match="A8.7"):
        gpt_pipeline_layers(cfg)


@pytest.fixture(scope="module")
def eager_reference(pair):
    """Two training-mode losses of the reference's eager model after
    seed(21) (Pallas sdpa, interpret builds), its global generator
    restored after."""
    jm, _, _ = pair
    ids, labels = _batch(3)
    saved = jrnd.get_rng_state()
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setitem(jfa._dropout_flash_cache, 0.1,
                       jfa.make_flash_attention(bq=32, bk=32, interpret=True,
                                                dropout_p=0.1))
            jrnd.seed(21)
            with force_backend("pallas"):
                ref = [float(jm(paddle.to_tensor(ids),
                                paddle.to_tensor(labels))) for _ in range(2)]
    finally:
        jrnd.set_rng_state(saved)
    return ids, labels, ref


def test_eager_dropout_draws_the_global_generator(pair, eager_reference):
    """Outside a key scope each dropout draws the global generator's next
    key, as the reference's eager model does: after seed(21) on both sides
    two training-mode losses match the reference's within rtol 1e-5, and
    differ from each other."""
    _, tm, arrays = pair
    load_numpy_params(tm, arrays)
    ids, labels, ref = eager_reference
    R.seed(21)
    with torch.no_grad():
        got = [float(tm(torch.from_numpy(ids), torch.from_numpy(labels)))
               for _ in range(2)]
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    assert got[0] != got[1]
