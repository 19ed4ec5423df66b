"""Attention dropout of the flash kernels: paddle_tpu_torch's plain
versions against the reference's Pallas kernels (interpret mode, the way
`tests/test_flash_dropout.py` runs them on the CPU).

What each test pins:
  - exact bits: the plain `dropout_keep` equals the reference's
    `_dropout_keep` called on jnp arrays, over seeds (0 and 2^31 - 2
    among them), p in {0.1, 0.3, 0.9}, ragged b / h / s, and at a block
    offset (the bit is a function of global positions only);
  - tolerance: the plain forward's o and its grads (the plain backward
    through `FlashAttention`) against `make_flash_attention(bq=32, bk=32,
    interpret=True, dropout_p=p).dropout` under `jax.vjp`, f32, within
    atol = rtol = 2e-5 (the same f32 math summed in another order; the
    masks are the same bits, so a wrong mask bit would show as an error
    of the weight's size, ~1e-2);
  - exact bits: `dropout_p = 0` computes what the entries without dropout
    compute; the `sdpa` slot draws its seed as the reference's
    `flash_attention_pallas` does (`randint(next_key(), ...)`) and, in one
    key scope, matches that entry within the tolerance above;
  - masks and non-causal attention combine with dropout (the old
    refusals are gone); a dropout without a seed, or p outside [0, 1),
    raises.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu  # noqa: F401  (x64 on, as the reference runs)
from paddle_tpu.framework import random as jrnd
from paddle_tpu.ops.pallas import flash_attention as J
from paddle_tpu_torch.framework import random as R
from paddle_tpu_torch.ops import kernel_launches, reset_kernel_launches
from paddle_tpu_torch.ops.pallas import FlashAttention, sdpa
from paddle_tpu_torch.ops.pallas import flash_attention as T

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)


def _ref_keep(seed, b, h, sq, sk, p, q_start=0, k_start=0):
    out = np.zeros((b, h, sq, sk), bool)
    for bi in range(b):
        for hh in range(h):
            out[bi, hh] = np.asarray(J._dropout_keep(
                jnp.asarray([seed], jnp.int32), jnp.int32(bi * h + hh),
                q_start, k_start, sq, sk, p))
    return out


@pytest.mark.parametrize("p", [0.1, 0.3, 0.9])
@pytest.mark.parametrize("seed", [0, 1, 977, 2 ** 31 - 2])
def test_dropout_keep_bits_equal_reference(seed, p):
    got = T.dropout_keep(seed, 2, 3, 37, 45, p).numpy()
    np.testing.assert_array_equal(got, _ref_keep(seed, 2, 3, 37, 45, p))
    # a block at an offset: the same bits as the slice of the whole mask
    blk = _ref_keep(seed, 2, 3, 8, 16, p, q_start=24, k_start=16)
    np.testing.assert_array_equal(got[:, :, 24:32, 16:32], blk)
    kept = got.mean()
    assert abs(kept - (1 - p)) < 0.05


def test_threshold_and_scale_as_the_reference_computes_them():
    for p in (0.1, 0.3, 0.9, 1e-12, 0.999999999999):
        assert T.dropout_threshold(p) == min(int(p * 4294967296.0),
                                             4294967295)
        assert T.dropout_inv_keep(p) == float(np.float32(1.0 / (1.0 - p)))


# (b, s, h, d): the reference's fallback layout (d 16) and its fast layout
# (d 128, s 40 padded to the block in the reference)
CASES = [(2, 64, 2, 16), (1, 40, 2, 128)]
SEED = 77


@pytest.fixture(scope="module", params=[0.1, 0.3], ids=["p0.1", "p0.3"])
def reference(request):
    """The reference's dropout flash (interpret) forward and vjp on each
    case: {case: (q, k, v, do, o, (dq, dk, dv))} as numpy."""
    p = request.param
    fl = J.make_flash_attention(bq=32, bk=32, interpret=True, dropout_p=p)
    out = {}
    for b, s, h, d in CASES:
        rng = np.random.RandomState(b * 100 + d)
        q, k, v, do = (rng.randn(b, s, h, d).astype(np.float32)
                       for _ in range(4))
        scale = 1.0 / math.sqrt(d)
        o, vjp = jax.vjp(lambda q_, k_, v_: fl.dropout(
            q_, k_, v_, jnp.int32(SEED), True, scale), *map(jnp.asarray,
                                                            (q, k, v)))
        grads = [np.asarray(g) for g in vjp(jnp.asarray(do))]
        out[(b, s, h, d)] = (q, k, v, do, np.asarray(o), grads)
    return p, out


@pytest.mark.parametrize("case", CASES, ids=["d16", "d128_s40"])
def test_plain_forward_and_grads_match_reference(reference, case):
    p, out = reference
    q, k, v, do, o_ref, g_ref = out[case]
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    o = FlashAttention.apply(qt, kt, vt, True, None, None, p, SEED)
    np.testing.assert_allclose(o.detach().numpy(), o_ref, **TOL)
    o.backward(torch.from_numpy(do))
    for name, got, want in zip("qkv", (qt.grad, kt.grad, vt.grad), g_ref):
        np.testing.assert_allclose(got.numpy(), want, err_msg=f"d{name}",
                                   **TOL)


def _qkv(b=2, s=48, h=2, d=16, seed=3):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(b, s, h, d).astype(np.float32))
            for _ in range(4)]


def test_dropout_p0_is_the_entry_without_dropout():
    """Exact bits: dropout_p = 0 (with or without a seed) is the causal
    attention without dropout, forward and backward; a positive p is
    not."""
    q, k, v, do = _qkv()
    base = T.flash_attention_fwd(q, k, v, True)
    for seed in (None, 123):
        got = T.flash_attention_fwd(q, k, v, True, None, None, 0.0, seed)
        assert all(torch.equal(a, b) for a, b in zip(got, base))
    gb = T.flash_attention_bwd(q, k, v, *base, do, True)
    g0 = T.flash_attention_bwd(q, k, v, *base, do, True, None, None, None,
                               0.0, 5)
    assert all(torch.equal(a, b) for a, b in zip(g0, gb))
    dropped = T.flash_attention_fwd(q, k, v, True, None, None, 0.2, 5)
    assert not torch.equal(dropped[0], base[0])
    # lse is the logsumexp before dropout
    assert torch.equal(dropped[1], base[1])


def test_sdpa_draws_the_reference_seed_and_matches_it():
    """In one key scope the slot draws randint(fold_in(key, 1), (), 0,
    2^31 - 1) and attends as the reference's `flash_attention_pallas`
    (interpret build patched in) within TOL."""
    q, k, v, _ = _qkv(seed=4)
    key = jax.random.key(31)
    want_seed = int(jax.random.randint(jax.random.fold_in(key, 1), (), 0,
                                       2 ** 31 - 1, jnp.int32))
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(J._dropout_flash_cache, 0.3, J.make_flash_attention(
            bq=16, bk=16, interpret=True, dropout_p=0.3))
        with jrnd.key_scope(key):
            ref = np.asarray(J.flash_attention_pallas(
                *(jnp.asarray(x.numpy()) for x in (q, k, v)), causal=True,
                dropout_p=0.3))
    kd = np.asarray(jax.random.key_data(key))
    with R.key_scope(kd) as box:
        got = sdpa(q, k, v, causal=True, dropout_p=0.3)
        assert box[1] == 1
    explicit = FlashAttention.apply(q, k, v, True, None, None, 0.3, want_seed)
    assert torch.equal(got, explicit)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    # no dropout: no draw
    with R.key_scope(kd) as box:
        sdpa(q, k, v, causal=True)
        assert box[1] == 0


def test_refusals():
    """Masks and non-causal attention are taken (the `_refuse_unported`
    gate is gone): with dropout they compute what the plain version
    computes with the same seed. A dropout without a seed, or p outside
    [0, 1), raises."""
    q, k, v, do = _qkv(b=1, s=8)
    assert not hasattr(T, "_refuse_unported")
    mask = torch.zeros(1, 1, 8, 8)
    mask[..., 5:] = -1e9
    o, lse = T.flash_attention_fwd(q, k, v, False, None, None, 0.1, 3, mask)
    want = T.flash_attention_reference(q, k, v, False, None, None, 0.1, 3,
                                       mask)
    assert torch.equal(o, want[0]) and torch.equal(lse, want[1])
    dq, dk, dv = T.flash_attention_bwd(q, k, v, o, lse, do, False, None,
                                       None, mask, 0.1, 3)
    assert not dk[:, 5:].any() and not dv[:, 5:].any()
    with pytest.raises(ValueError, match="seed"):
        T.flash_attention_fwd(q, k, v, True, None, None, 0.1)
    with pytest.raises(ValueError, match="dropout_p"):
        T.flash_attention_fwd(q, k, v, True, None, None, 1.0, 3)


def test_cpu_dropout_launches_nothing():
    reset_kernel_launches()
    q, k, v, do = _qkv(b=1, s=8)
    qt = q.clone().requires_grad_(True)
    FlashAttention.apply(qt, k, v, True, None, None, 0.1, 9).sum().backward()
    counts = kernel_launches()
    assert counts["flash_attention_fwd_dropout"] == 0
    assert counts["flash_attention_bwd_dropout"] == 0
    assert counts["flash_attention_fwd"] == counts["flash_attention_bwd"] == 0
