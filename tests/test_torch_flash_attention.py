"""Causal flash-attention forward: paddle_tpu_torch against the JAX
reference.

The plain PyTorch version (o and lse) is held to the Pallas `_fwd_kernel`
in interpret mode and to `_xla_ref`, on the same seeded numpy inputs, in
f32 within atol = rtol = 1e-5: the kernel folds the softmax block by
block, the plain version in one pass.
"""
import math

import numpy as np
import pytest
import torch
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
