"""Flash attention: paddle_tpu_torch against the JAX reference (masks in
tests/test_torch_flash_mask.py).

The plain forward (o and lse) is held to the Pallas `_fwd_kernel` in
interpret mode and to `_xla_ref`, on the same seeded numpy inputs, in f32
within atol = rtol = 1e-5: the kernel folds the softmax block by block,
the plain version in one pass. `FlashAttention`'s gradients (the plain
backward on the CPU) are held to `make_flash_attention(bq=32, bk=32,
interpret=True)` under `jax.vjp` (its `_fused_bwd_kernel`) in f32 within
atol = rtol = 1e-4 (dQ is a sum of per-key-block partials there, one f32
sum here).
"""
import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import flash_attention as jf
from paddle_tpu_torch.ops.pallas import flash_attention as tf

torch.set_num_threads(1)

BLK = 16   # small Pallas blocks keep interpret mode quick


def _qkv(b, s, h, d, seed):
    rs = np.random.RandomState(seed)
    return [rs.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(3)]


def _jax_lse(q, k, v, scale, s_true):
    """lse of the Pallas forward ([b, h, s_true]), through `_flash_fwd` on
    the [b*h, s_pad, d] layout the JAX wrapper uses for any head dim."""
    b, s, h, d = q.shape

    def lay(x):
        x = np.swapaxes(x[:, :s_true], 1, 2).reshape(b * h, s_true, d)
        pad = (-s_true) % BLK
        return jnp.asarray(np.pad(x, ((0, 0), (0, pad), (0, 0))))

    _, lse = jf._flash_fwd(lay(q), lay(k), lay(v), None, 1, True, scale,
                           BLK, BLK, s_true, True)
    return np.asarray(lse)[:, 0, :s_true, 0].reshape(b, h, s_true)


@pytest.mark.parametrize("d", [16, 128])
def test_plain_matches_pallas_interpret(d):
    b, s, h = 2, 40, 2
    q, k, v = _qkv(b, s, h, d, d)
    scale = 1.0 / math.sqrt(d)
    flash = jf.make_flash_attention(bq=BLK, bk=BLK, interpret=True)
    o_ref = np.asarray(flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             True, scale))
    o, lse = tf.flash_attention_fwd(*(torch.from_numpy(a) for a in (q, k, v)),
                                    True, scale)
    np.testing.assert_allclose(o.numpy(), o_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), _jax_lse(q, k, v, scale, s),
                               rtol=1e-5, atol=1e-5)


def test_padding_past_s_true_matches_unpadded_reference():
    """Keys at or past s_true are masked: the rows below s_true equal the
    reference run on the unpadded sequence."""
    b, s, s_true, h, d = 2, 48, 37, 3, 16
    q, k, v = _qkv(b, s, h, d, 7)
    scale = 0.25
    o, lse = tf.flash_attention_fwd(*(torch.from_numpy(a) for a in (q, k, v)),
                                    True, scale, s_true=s_true)
    o_xla = np.asarray(jf._xla_ref(*(jnp.asarray(a[:, :s_true])
                                     for a in (q, k, v)), True, scale))
    np.testing.assert_allclose(o.numpy()[:, :s_true], o_xla, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(lse.numpy()[:, :, :s_true],
                               _jax_lse(q, k, v, scale, s_true),
                               rtol=1e-5, atol=1e-5)
    # padded rows attend only real keys: finite, and equal to a reference
    # that masks the same keys
    o_ref, _ = tf.flash_attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), True, scale, s_true)
    assert torch.isfinite(o).all()
    torch.testing.assert_close(o, o_ref, rtol=0, atol=0)


def test_non_causal_plain_matches_xla_ref():
    q, k, v = _qkv(1, 24, 2, 16, 9)
    o, _ = tf.flash_attention_fwd(*(torch.from_numpy(a) for a in (q, k, v)),
                                  False, 0.5)
    o_xla = np.asarray(jf._xla_ref(*(jnp.asarray(a) for a in (q, k, v)),
                                   False, 0.5))
    np.testing.assert_allclose(o.numpy(), o_xla, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", [64, 128])
def test_flash_attention_grads_match_pallas_interpret(d):
    b, s, h = 1, 40, 2          # s = 40: not a multiple of the 32-blocks
    q, k, v = _qkv(b, s, h, d, 20 + d)
    g = np.random.RandomState(d).standard_normal((b, s, h, d)).astype(np.float32)
    scale = 1.0 / math.sqrt(d)
    flash = jf.make_flash_attention(bq=32, bk=32, interpret=True)
    o_ref, vjp = jax.vjp(lambda a, c, e: flash(a, c, e, True, scale),
                         *(jnp.asarray(a) for a in (q, k, v)))
    grads_ref = vjp(jnp.asarray(g))

    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    o = tf.FlashAttention.apply(qt, kt, vt, True, scale)
    o.backward(torch.from_numpy(g))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_ref),
                               rtol=1e-5, atol=1e-5)
    for got, ref in zip((qt.grad, kt.grad, vt.grad), grads_ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-4)


def test_backward_masks_keys_past_s_true():
    """Keys at or past s_true get zero dK and dV; with a zero cotangent on
    the padded rows (as the reference pads it), the rows below s_true get
    the gradients of the unpadded problem."""
    b, s, s_true, h, d = 1, 24, 17, 2, 16
    q, k, v = (torch.from_numpy(a) for a in _qkv(b, s, h, d, 31))
    do = torch.from_numpy(np.random.RandomState(3).standard_normal(
        (b, s, h, d)).astype(np.float32))
    do[:, s_true:] = 0
    o, lse = tf.flash_attention_fwd(q, k, v, True, 0.25, s_true=s_true)
    dq, dk, dv = tf.flash_attention_bwd(q, k, v, o, lse, do, True, 0.25,
                                        s_true=s_true)
    assert not dk[:, s_true:].any() and not dv[:, s_true:].any()
    sl = slice(0, s_true)
    o2, lse2 = tf.flash_attention_fwd(q[:, sl], k[:, sl], v[:, sl], True, 0.25)
    dq2, dk2, dv2 = tf.flash_attention_bwd(q[:, sl], k[:, sl], v[:, sl], o2,
                                           lse2, do[:, sl], True, 0.25)
    for got, ref in ((dq[:, sl], dq2), (dk[:, sl], dk2), (dv[:, sl], dv2)):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)


def test_backward_refuses_masks_and_dropout():
    """The backward takes the forward's additive mask and applies it (a
    key the mask hides gets no dK or dV, and the gradients differ from the
    unmasked ones); dropout needs the forward's seed: without one it is
    refused, with a mask too."""
    rs = np.random.RandomState(5)
    q, k, v, do = (torch.from_numpy(rs.standard_normal((1, 8, 1, 16)).astype(
        np.float32)) for _ in range(4))
    mask = torch.zeros(8, 8)
    mask[:, 6:] = tf.NEG_INF
    o, lse = tf.flash_attention_fwd(q, k, v, False, mask=mask)
    dq, dk, dv = tf.flash_attention_bwd(q, k, v, o, lse, do, False,
                                        mask=mask)
    assert not dk[:, 6:].any() and not dv[:, 6:].any()
    assert dv[:, :6].abs().min() > 0
    o0, lse0 = tf.flash_attention_fwd(q, k, v, False)
    dq0, _, _ = tf.flash_attention_bwd(q, k, v, o0, lse0, do, False)
    assert not torch.allclose(dq, dq0)
    for m in (None, mask):
        with pytest.raises(ValueError, match="seed"):
            tf.flash_attention_bwd(q, q, q, q, lse, q, mask=m, dropout_p=0.1)
    dq, dk, dv = tf.flash_attention_bwd(q, q, q, q, lse, q, mask=mask,
                                        dropout_p=0.1, seed=3)
    assert dq.shape == dk.shape == dv.shape == q.shape


def test_stash_replays_residuals_without_a_second_forward(monkeypatch):
    """Inside an AttnResidualStash region the first run computes (o, lse)
    and every later run of the region replays them."""
    calls = []
    real = tf.flash_attention_fwd
    monkeypatch.setattr(tf, "flash_attention_fwd",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 1, 16, 5))
    stash = tf.AttnResidualStash()
    with stash.region():
        o1 = tf.FlashAttention.apply(q, k, v, True, 0.25)
    with stash.region():
        o2 = tf.FlashAttention.apply(q, k, v, True, 0.25)
    assert len(calls) == 1 and torch.equal(o1, o2)
    with stash.region(), pytest.raises(RuntimeError, match="more attention"):
        tf.FlashAttention.apply(q, k, v, True, 0.25)
        tf.FlashAttention.apply(q, k, v, True, 0.25)
