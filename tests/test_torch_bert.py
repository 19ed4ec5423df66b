"""BERT MLM pretraining: paddle_tpu_torch against the JAX reference, with
the nn pieces it adds (`cross_entropy`, `tanh`, the Transformer encoder).

`BertConfig.tiny()` on both sides, the reference's weights carried across
by `convert.load_numpy_params`; batches from seeded numpy with a padding
`attention_mask` and two token-type segments. The reference's parameters
get their `named_parameters()` names as `Parameter.name` before its
optimizer is built: its deep-copied encoder layers otherwise share the
first layer's names, and its optimizer keys state by name (ROADMAP Queue
C).

What each test pins:
  - exact bits: parameter names and order equal the reference's and come
    back bit for bit; the -1e9 mask in bf16 is the reference's
    (-998244352, -1e9 rounded to nearest);
  - tolerance, dropout off (eval mode, the reference's XLA sdpa): MLM
    logits within atol = rtol = 1e-4 in f32 (sums in another order; the
    erf gelu is torch's, within 1e-6 of jax.nn.gelu); the
    sequence-classification logits the same;
  - tolerance, dropout on (training mode, hidden and attention 0.1, the
    global generator seeded alike on both sides: `paddle.seed(1)` and
    `framework.random.seed(1)`; the reference under
    `force_backend("pallas")` with interpret flash builds, as
    `tests/test_torch_gpt.py` runs it): the loss within rtol 1e-5 and
    every gradient within atol 1e-5 (the draws are the same bits in the
    same order, so a wrong mask would move the loss by ~1e-2);
  - tolerance: the reference's config-2 loop (`test_config2_bert_dp`:
    ids 4 x 16, labels -100 at even positions, here with a padding mask),
    3 AdamW(1e-3) steps with dropout on both sides: losses within rtol
    1e-5 and falling; parameters within atol 1e-5 after step 3, the
    attention key biases within 3 x steps x lr (their gradient is zero in
    exact arithmetic, softmax being shift invariant, so Adam moves them
    by noise);
  - `cross_entropy` against the reference (ignore_index, the reductions,
    weight, axis, label smoothing) within 1e-6; soft labels refused.
"""
import numpy as np
import pytest
import torch

import jax
import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.framework import random as jrnd
from paddle_tpu.models.bert import BertConfig as JaxConfig
from paddle_tpu.models.bert import BertForMaskedLM as JaxMLM
from paddle_tpu.models.bert import BertForSequenceClassification as JaxCls
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops import force_backend
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch.convert import load_numpy_params
from paddle_tpu_torch.framework import random as R
from paddle_tpu_torch.models.bert import (BertConfig, BertForMaskedLM,
                                          BertForSequenceClassification,
                                          BertModel)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import AdamW

torch.set_num_threads(1)

jax.config.update("jax_platforms", "cpu")


def _batch(seed=0, b=4, s=16, vocab=256):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (b, s)).astype(np.int64)
    labels = rng.randint(0, vocab, (b, s)).astype(np.int64)
    labels[:, ::2] = -100
    am = np.ones((b, s), np.int64)
    am[1, 10:] = 0
    am[3, 5:] = 0
    tt = np.zeros((b, s), np.int64)
    tt[:, s // 2:] = 1
    return ids, tt, am, labels


def _named(jm):
    for n, p in jm.named_parameters():
        p.name = n
    return jm


@pytest.fixture(scope="module")
def pair():
    paddle.seed(5)
    jm = _named(JaxMLM(JaxConfig.tiny()))
    arrays = {n: np.asarray(p.data) for n, p in jm.named_parameters()}
    return jm, arrays


def _pallas_interpret(mp):
    """The reference's Pallas sdpa with interpret builds (its dropout and
    plain entries), patched in for the test's scope."""
    mp.setitem(jfa._dropout_flash_cache, 0.1, jfa.make_flash_attention(
        bq=16, bk=16, interpret=True, dropout_p=0.1))
    mp.setattr(jfa, "_default_flash",
               jfa.make_flash_attention(bq=16, bk=16, interpret=True))


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _port(arrays, cls=BertForMaskedLM, **kw):
    tm = cls(BertConfig.tiny(), device="cpu", **kw)
    return load_numpy_params(tm, arrays)


def test_parameter_round_trip_bit_exact(pair):
    _, arrays = pair
    tm = BertForMaskedLM(BertConfig.tiny(), device="cpu")
    assert [n for n, _ in tm.named_parameters()] == list(arrays)
    load_numpy_params(tm, arrays)
    for name, p in tm.named_parameters():
        np.testing.assert_array_equal(
            p.detach().numpy().view(np.uint32), arrays[name].view(np.uint32))
    # the encoder's layers start as copies of the first
    again = BertForMaskedLM(BertConfig.tiny(), device="cpu", seed=3)
    l0, l1 = again.bert.encoder.layers
    for (n0, a), (n1, c) in zip(l0.named_parameters(), l1.named_parameters()):
        assert n0 == n1 and torch.equal(a, c) and a is not c


def test_bf16_mask_value_is_the_reference_rounding():
    am = np.array([[1, 1, 0]], np.int64)
    model = BertModel(BertConfig.tiny(), torch.Generator().manual_seed(0),
                      torch.device("cpu")).to(torch.bfloat16)
    seen = {}

    def spy(src, src_mask=None, cache=None):
        seen["mask"] = src_mask
        return src

    model.encoder.forward = spy
    model(torch.tensor([[1, 2, 3]]), attention_mask=torch.from_numpy(am))
    m = seen["mask"]
    assert m.dtype == torch.bfloat16 and tuple(m.shape) == (1, 1, 1, 3)
    import jax.numpy as jnp
    want = jnp.where(jnp.asarray(am)[:, None, None, :] > 0, 0.0,
                     -1e9).astype(jnp.bfloat16)
    assert m.float().tolist() == np.asarray(want.astype(jnp.float32)).tolist()
    assert m.float().tolist() == [[[[0.0, 0.0, -998244352.0]]]]


@pytest.fixture(scope="module")
def eval_reference(pair):
    """The reference's MLM and classifier logits in eval mode (dropout
    off, its default XLA sdpa)."""
    jm, arrays = pair
    ids, tt, am, _ = _batch(1)
    paddle.seed(6)
    jc = JaxCls(JaxConfig.tiny(), num_classes=3)
    cls_arrays = {n: np.asarray(p.data) for n, p in jc.named_parameters()}
    jm.eval()
    jc.eval()
    try:
        args = [paddle.to_tensor(x) for x in (ids, tt, am)]
        mlm = np.asarray(jm(*args).numpy())
        cls = np.asarray(jc(*args).numpy())
    finally:
        jm.train()
    return (ids, tt, am), mlm, cls, cls_arrays


def test_logits_dropout_off_match_reference(pair, eval_reference):
    _, arrays = pair
    batch, mlm, cls, cls_arrays = eval_reference
    tm = _port(arrays).eval()
    with torch.no_grad():
        got = tm(*_torch(*batch)).numpy()
    np.testing.assert_allclose(got, mlm, rtol=1e-4, atol=1e-4)
    tc = _port(cls_arrays, BertForSequenceClassification,
               num_classes=3).eval()
    with torch.no_grad():
        got = tc(*_torch(*batch)).numpy()
    assert got.shape == (4, 3)
    np.testing.assert_allclose(got, cls, rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def dropout_reference(pair):
    """The reference's training-mode loss and grads after paddle.seed(1)
    (Pallas sdpa, interpret builds), its global generator restored."""
    jm, _ = pair
    ids, tt, am, labels = _batch(2)
    saved = jrnd.get_rng_state()
    try:
        with pytest.MonkeyPatch.context() as mp:
            _pallas_interpret(mp)
            for p in jm.parameters():
                p.grad = None
            paddle.seed(1)
            with force_backend("pallas"):
                loss = jm(*(paddle.to_tensor(x) for x in (ids, tt, am)),
                          labels=paddle.to_tensor(labels))
                loss.backward()
    finally:
        jrnd.set_rng_state(saved)
    grads = {n: None if p.grad is None else np.asarray(p.grad.numpy())
             for n, p in jm.named_parameters()}
    for p in jm.parameters():
        p.grad = None
    return float(loss), grads, (ids, tt, am, labels)


def test_loss_and_grads_dropout_on_match_pallas_reference(pair,
                                                          dropout_reference):
    _, arrays = pair
    ref_loss, ref_grads, batch = dropout_reference
    tm = _port(arrays)
    ids, tt, am, labels = _torch(*batch)
    R.seed(1)
    loss = tm(ids, tt, am, labels=labels)
    loss.backward()
    np.testing.assert_allclose(float(loss), ref_loss, rtol=1e-5)
    for name, p in tm.named_parameters():
        want = ref_grads[name]
        if want is None:      # the pooler does not reach the MLM loss
            assert p.grad is None, name
            continue
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0, atol=1e-5,
                                   err_msg=name)
    # the next draws differ: another loss
    with torch.no_grad():
        other = float(tm(ids, tt, am, labels=labels))
    assert other != float(loss)


STEPS, LR = 3, 1e-3


@pytest.fixture(scope="module")
def config2_reference():
    """`test_config2_bert_dp`'s loop on the reference (one device), with a
    padding mask: 3 AdamW steps, dropout on (Pallas sdpa, interpret
    builds), after paddle.seed(3); its global generator restored."""
    paddle.seed(1)
    jm = _named(JaxMLM(JaxConfig.tiny()))
    arrays = {n: np.asarray(p.data) for n, p in jm.named_parameters()}
    ids, _, am, labels = _batch(0)
    opt = jopt.AdamW(LR, parameters=jm.parameters())
    losses = []
    saved = jrnd.get_rng_state()
    try:
        with pytest.MonkeyPatch.context() as mp:
            _pallas_interpret(mp)
            paddle.seed(3)
            with force_backend("pallas"):
                for _ in range(STEPS):
                    loss = jm(paddle.to_tensor(ids),
                              attention_mask=paddle.to_tensor(am),
                              labels=paddle.to_tensor(labels))
                    loss.backward()
                    opt.step()
                    opt.clear_grad()
                    losses.append(float(loss))
    finally:
        jrnd.set_rng_state(saved)
    after = {n: np.asarray(p.data) for n, p in jm.named_parameters()}
    return arrays, (ids, am, labels), losses, after


def test_config2_adamw_loop_matches_reference(config2_reference):
    arrays, batch, ref_losses, ref_after = config2_reference
    tm = _port(arrays)
    ids, am, labels = _torch(*batch)
    opt = AdamW(LR, parameters=tm.named_parameters())
    R.seed(3)
    losses = []
    for _ in range(STEPS):
        loss = tm(ids, attention_mask=am, labels=labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    assert losses[-1] < losses[0] and all(map(np.isfinite, losses))
    for name, p in tm.named_parameters():
        atol = STEPS * LR if name.endswith("k_proj.bias") else 1e-5
        np.testing.assert_allclose(p.detach().numpy(), ref_after[name],
                                   rtol=0, atol=atol, err_msg=name)


CE_CASES = {
    "mean": dict(),
    "sum": dict(reduction="sum"),
    "none": dict(reduction="none"),
    "ignore_7": dict(ignore_index=7),
    "weight": dict(weight=True),
    "weight_sum": dict(weight=True, reduction="sum"),
    "smoothing": dict(label_smoothing=0.1),
    "axis_1": dict(axis=1),
    "no_softmax": dict(use_softmax=False),
}


@pytest.mark.parametrize("case", sorted(CE_CASES))
def test_cross_entropy_matches_reference(case):
    kw = dict(CE_CASES[case])
    rng = np.random.RandomState(len(case))
    n_cls = 11
    if kw.get("axis") == 1:
        logits = rng.randn(3, n_cls, 5).astype(np.float32)
        labels = rng.randint(0, n_cls, (3, 5)).astype(np.int64)
    else:
        logits = rng.randn(3, 5, n_cls).astype(np.float32)
        labels = rng.randint(0, n_cls, (3, 5)).astype(np.int64)
    if kw.get("use_softmax") is False:
        logits = np.abs(logits) / 10
    labels[0, :2] = kw.get("ignore_index", -100)
    jkw, tkw = dict(kw), dict(kw)
    if kw.pop("weight", False):
        w = rng.rand(n_cls).astype(np.float32)
        jkw["weight"], tkw["weight"] = paddle.to_tensor(w), torch.from_numpy(w)
    ref = np.asarray(JF.cross_entropy(paddle.to_tensor(logits),
                                      paddle.to_tensor(labels),
                                      **jkw).numpy())
    got = F.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                          **tkw).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_cross_entropy_all_ignored_and_soft_label():
    logits = torch.randn(2, 4)
    labels = torch.full((2,), -100)
    assert float(F.cross_entropy(logits, labels)) == 0.0
    with pytest.raises(NotImplementedError, match="A9.1"):
        F.cross_entropy(logits, torch.softmax(logits, -1), soft_label=True)


def test_tanh_and_relu_match_reference():
    x = np.linspace(-4, 4, 101).astype(np.float32)
    for name in ("tanh", "relu"):
        ref = np.asarray(getattr(JF, name)(paddle.to_tensor(x)).numpy())
        got = getattr(F, name)(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def test_sdpa_routes_masks_as_the_reference():
    """`F.scaled_dot_product_attention` on [b, s, h, d] with GQA heads and
    a [b, 1, 1, s] mask: dropout off, within 1e-5 of the reference's (its
    XLA sdpa); a mask without a gradient goes through `FlashAttention`
    (the same bits as calling it), and one that requires its gradient
    goes to the plain `_sdpa_xla` and gets that gradient; eval mode turns
    dropout off."""
    from paddle_tpu_torch.ops.pallas import FlashAttention
    rng = np.random.RandomState(8)
    q = rng.randn(2, 12, 4, 16).astype(np.float32)
    k, v = (rng.randn(2, 12, 2, 16).astype(np.float32) for _ in range(2))
    m = np.where(np.arange(12)[None, :] < np.array([[12], [7]]), 0.0,
                 -1e9).astype(np.float32)[:, None, None, :]
    ref = np.asarray(JF.scaled_dot_product_attention(
        *(paddle.to_tensor(x) for x in (q, k, v, m))).numpy())
    qt, kt, vt, mt = _torch(q, k, v, m)
    got = F.scaled_dot_product_attention(qt, kt, vt, mt)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    rep = [x.repeat_interleave(2, dim=2) for x in (kt, vt)]
    assert torch.equal(got, FlashAttention.apply(qt, *rep, False, None, None,
                                                 0.0, None, mt))
    mg = mt.clone().requires_grad_(True)
    out = F.scaled_dot_product_attention(qt, kt, vt, mg)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-5,
                               atol=1e-5)
    out.sum().backward()
    assert mg.grad is not None and mg.grad.shape == mg.shape
    with R.key_scope(R.key(3)) as box:
        F.scaled_dot_product_attention(qt, kt, vt, mt, dropout_p=0.5,
                                       training=False)
        assert box[1] == 0


@pytest.mark.parametrize("normalize_before", [False, True],
                         ids=["post_norm", "pre_norm"])
def test_encoder_layer_matches_reference(normalize_before):
    """A two-layer `TransformerEncoder` of relu `TransformerEncoderLayer`s
    (post-norm and pre-norm), dropout off, with a bool mask: within 1e-5
    of the reference's with the same weights; the cache forms refuse."""
    from paddle_tpu.nn.layer import transformer as jtr
    from paddle_tpu_torch.nn import transformer as ttr
    paddle.seed(11)
    jl = jtr.TransformerEncoderLayer(32, 4, 64, dropout=0.0,
                                     normalize_before=normalize_before)
    jenc = jtr.TransformerEncoder(jl, 2)
    tl = ttr.TransformerEncoderLayer(32, 4, 64, dropout=0.0,
                                     normalize_before=normalize_before,
                                     device="cpu")
    tenc = ttr.TransformerEncoder(tl, 2)
    load_numpy_params(tenc, {n: np.asarray(p.data)
                             for n, p in jenc.named_parameters()})
    rng = np.random.RandomState(12)
    x = rng.randn(2, 16, 32).astype(np.float32)
    m = rng.rand(2, 1, 16, 16) > 0.2
    m[..., 0] = True
    jenc.eval()
    ref = np.asarray(jenc(paddle.to_tensor(x), paddle.to_tensor(m)).numpy())
    got = tenc.eval()(torch.from_numpy(x), torch.from_numpy(m))
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(NotImplementedError, match="A9.1"):
        tenc(torch.from_numpy(x), None, cache=[None, None])
    with pytest.raises(NotImplementedError, match="A9.1"):
        tl.self_attn.gen_cache(torch.from_numpy(x))
    with pytest.raises(NotImplementedError, match="A9.1"):
        ttr.MultiHeadAttention(32, 4, weight_attr=object(), device="cpu")
    mha = ttr.MultiHeadAttention(32, 4, need_weights=True, bias_attr=False,
                                 device="cpu")
    out, weights = mha(torch.from_numpy(x))
    assert out.shape == (2, 16, 32) and weights is None
    assert mha.q_proj.bias is None


def test_card_parity_param_gate():
    """`chip_smoke.param_gate`, which holds the card's parameters to the
    CPU's after the parity phases' steps (lr 1e-4, 3 steps): f32 within
    1e-4, attention key biases within 3 x steps x lr; bf16 within 2^-7
    |ref| + 3 x steps x lr. Exact: the limits on hand-made differences."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    ref = {"w": torch.tensor([4.0, 0.02, 0.0]),
           "attn.k_proj.bias": torch.tensor([0.0, 0.5])}

    def gate(bf16, w, kb):
        got = {"w": ref["w"] + torch.tensor(w),
               "attn.k_proj.bias": ref["attn.k_proj.bias"] + torch.tensor(kb)}
        return cs.param_gate(got, ref, bf16, 1e-4, 3)

    r, name = gate(False, [5e-5, -5e-5, 0.0], [8e-4, 0.0])
    assert r <= 1 and name == "attn.k_proj.bias"
    r, name = gate(False, [0.0, 2e-4, 0.0], [0.0, 0.0])
    assert r > 1 and name == "w"
    r, _ = gate(True, [4.0 * 2 ** -8, 8e-4, -8e-4], [8e-4, 0.0])
    assert r <= 1
    r, name = gate(True, [0.0, 0.0, 0.0], [0.0, 0.5 * 2 ** -7 + 1e-3])
    assert r > 1 and name == "attn.k_proj.bias"
