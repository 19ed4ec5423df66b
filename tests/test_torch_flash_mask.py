"""Additive masks and non-causal attention of the flash kernels:
paddle_tpu_torch's plain versions against the reference's Pallas kernels
(interpret mode, `make_flash_attention(bq=32, bk=32, interpret=True)`, as
`tests/test_pallas_kernels.py` and `tests/test_flash_dropout.py` run them
on the CPU).

What each test pins:
  - exact bits: `norm_mask` equals the reference's `_norm_mask` (bool and
    float masks, ranks 1 to 4); a [b, 1, 1, s] mask gives the bits of the
    same mask expanded to [b, h, s, s] (it applies to every query row);
    a zero additive mask gives the bits of no mask; with dropout_p = 0
    the masked-dropout entry gives the masked entry's bits;
  - tolerance, f32, atol = rtol = 2e-5 (the same f32 math summed in
    another order; the reference folds the softmax block by block): the
    plain forward's o and its grads (the plain backward through
    `FlashAttention`) against the reference's `.masked` (and
    `.masked_dropout`, the same dropout bits) under `jax.vjp`, for masks
    [b, 1, 1, s] (key padding at -1e9, as BERT's), [1, h, s, s] and
    [b, h, s, s] (random), a bool mask with one row fully False, causal
    plus a mask, and the plain non-causal entry without a mask; d 16 (the
    reference's b*h-slice layout) and d 128 (its fast layout, s 40 padded
    to the block there). A hidden row is uniform over the keys (weights
    1/s) in both; it is tested at s 64, where the reference pads nothing
    (padded, the reference also weighs its zero padding keys);
  - refusals: a mask that does not broadcast to [b, h, s, s], a mask of
    rank 5; the dropout seed still required with a mask.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu  # noqa: F401  (x64 on, as the reference runs)
from paddle_tpu.ops.pallas import flash_attention as J
from paddle_tpu_torch.ops.pallas import FlashAttention
from paddle_tpu_torch.ops.pallas import flash_attention as T

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)
P_DROP, SEED = 0.1, 4321


def _mask(kind, b, s, h, rng):
    """(numpy mask as the caller gives it, causal)."""
    if kind in ("key_padding", "causal_key_padding"):
        lens = rng.randint(s // 2, s + 1, size=b)
        lens[0] = s
        m = np.where(np.arange(s)[None, :] < lens[:, None], 0.0, -1e9)
        return m[:, None, None, :].astype(np.float32), kind.startswith("causal")
    if kind == "head":
        return rng.randn(1, h, s, s).astype(np.float32), False
    if kind == "full":
        return rng.randn(b, h, s, s).astype(np.float32), False
    if kind == "bool_hidden_row":
        m = rng.rand(b, 1, s, s) > 0.3
        m[:, :, :, 0] = True
        m[0, 0, 5, :] = False            # row 5 of batch 0: every key hidden
        return m, False
    assert kind == "none"
    return None, False


# (b, s, h, d): the reference's fallback layout (d 16) and its fast layout
# (d 128; s 40 is padded to 64 there)
SHAPES = {"d16": (2, 64, 2, 16), "d128": (2, 40, 2, 128),
          "d128_s64": (1, 64, 2, 128)}
CASES = [("d16", "key_padding"), ("d128", "key_padding"), ("d16", "head"),
         ("d128", "full"), ("d16", "full"), ("d16", "bool_hidden_row"),
         ("d128_s64", "bool_hidden_row"), ("d16", "causal_key_padding"),
         ("d128", "causal_key_padding"), ("d16", "none"), ("d128", "none")]


def _inputs(shape, kind):
    b, s, h, d = SHAPES[shape]
    rng = np.random.RandomState(b * 1000 + s * 10 + d)
    q, k, v, do = (rng.randn(b, s, h, d).astype(np.float32) for _ in range(4))
    mask, causal = _mask(kind, b, s, h, rng)
    return q, k, v, do, mask, causal


@pytest.fixture(scope="module")
def reference():
    """{(shape, kind, dropout): (o, (dq, dk, dv))} of the reference's
    interpret kernels as numpy: `.masked` / `.masked_dropout` (seed SEED,
    p 0.1) with the mask through `_norm_mask`, the plain entry without a
    mask."""
    fl = J.make_flash_attention(bq=32, bk=32, interpret=True,
                                dropout_p=P_DROP)
    out = {}
    for shape, kind in CASES:
        q, k, v, do, mask, causal = _inputs(shape, kind)
        scale = 1.0 / math.sqrt(q.shape[-1])
        jm = None if mask is None else J._norm_mask(jnp.asarray(mask))
        for drop in (False, True):
            if jm is None and drop:
                continue
            if jm is None:
                def f(a, c, e):
                    return fl(a, c, e, causal, scale)
            elif drop:
                def f(a, c, e):
                    return fl.masked_dropout(a, c, e, jm, jnp.int32(SEED),
                                             causal, scale)
            else:
                def f(a, c, e):
                    return fl.masked(a, c, e, jm, causal, scale)
            o, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
            out[(shape, kind, drop)] = (np.asarray(o), [
                np.asarray(g) for g in vjp(jnp.asarray(do))])
    return out


# every case without dropout, and with it where the reference has a
# masked-dropout entry (a mask is given)
RUNS = [(s, k, drop) for s, k in CASES for drop in (False, True)
        if not (drop and k == "none")]


@pytest.mark.parametrize("shape,kind,drop", RUNS, ids=[
    f"{s}-{k}-{'masked_dropout' if dr else 'masked'}" for s, k, dr in RUNS])
def test_plain_forward_and_grads_match_reference(reference, shape, kind,
                                                 drop):
    q, k, v, do, mask, causal = _inputs(shape, kind)
    o_ref, g_ref = reference[(shape, kind, drop)]
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    m = None if mask is None else torch.from_numpy(mask)
    p, seed = (P_DROP, SEED) if drop else (0.0, None)
    o = FlashAttention.apply(qt, kt, vt, causal, None, None, p, seed, m)
    np.testing.assert_allclose(o.detach().numpy(), o_ref, **TOL)
    o.backward(torch.from_numpy(do))
    for name, got, want in zip("qkv", (qt.grad, kt.grad, vt.grad), g_ref):
        np.testing.assert_allclose(got.numpy(), want, err_msg=f"d{name}",
                                   **TOL)


def test_hidden_row_is_uniform_over_the_keys():
    """A bool row that is False everywhere: every key weighs 1/s (o is the
    mean of v over the keys), lse is about -1e30, and no value is NaN."""
    q, k, v, _, mask, _ = _inputs("d16", "bool_hidden_row")
    o, lse = T.flash_attention_fwd(*(torch.from_numpy(x) for x in (q, k, v)),
                                   False, mask=torch.from_numpy(mask))
    assert torch.isfinite(o).all()
    np.testing.assert_allclose(o[0, 5].numpy(), v[0].mean(0), rtol=1e-5,
                               atol=1e-6)
    assert float(lse[0, :, 5].max()) <= -1e29


@pytest.mark.parametrize("rank", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", ["bool", "float32"])
def test_norm_mask_bits_equal_reference(rank, dtype):
    rng = np.random.RandomState(rank)
    shape = (2, 3, 5, 5)[4 - rank:]
    m = (rng.rand(*shape) > 0.5) if dtype == "bool" else \
        rng.randn(*shape).astype(np.float32)
    want = np.asarray(J._norm_mask(jnp.asarray(m)))
    got = T.norm_mask(torch.from_numpy(m)).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_key_padding_mask_applies_to_every_query_row():
    """Exact bits: [b, 1, 1, s] is the same mask as its [b, h, s, s]
    expansion, forward and backward; it is not a mask of query row 0."""
    q, k, v, do, mask, _ = _inputs("d16", "key_padding")
    q, k, v, do = (torch.from_numpy(x) for x in (q, k, v, do))
    b, s, h, _ = q.shape
    m = torch.from_numpy(mask)
    full = m.expand(b, h, s, s).contiguous()
    o1, lse1 = T.flash_attention_fwd(q, k, v, False, mask=m)
    o2, lse2 = T.flash_attention_fwd(q, k, v, False, mask=full)
    assert torch.equal(o1, o2) and torch.equal(lse1, lse2)
    g1 = T.flash_attention_bwd(q, k, v, o1, lse1, do, False, mask=m)
    g2 = T.flash_attention_bwd(q, k, v, o1, lse1, do, False, mask=full)
    assert all(torch.equal(a, c) for a, c in zip(g1, g2))
    # batch 1 pads its keys: every one of its rows ignores them
    pad = mask[1, 0, 0] < 0
    assert pad.any()
    row0_only = torch.zeros(b, h, s, s)
    row0_only[:, :, :1] = m[:, :, 0]
    o3, _ = T.flash_attention_fwd(q, k, v, False, mask=row0_only)
    assert not torch.allclose(o3[1, 1:], o1[1, 1:])


def test_zero_mask_and_p0_are_exact():
    """Exact bits: an all-zero additive mask computes what no mask
    computes (causal and not), forward and backward; the masked-dropout
    entry at dropout_p = 0 computes the masked entry."""
    q, k, v, do, mask, _ = _inputs("d16", "key_padding")
    q, k, v, do = (torch.from_numpy(x) for x in (q, k, v, do))
    zero = torch.zeros(q.shape[0], 1, 1, q.shape[1])
    m = torch.from_numpy(mask)
    for causal in (True, False):
        base = T.flash_attention_fwd(q, k, v, causal)
        got = T.flash_attention_fwd(q, k, v, causal, mask=zero)
        assert all(torch.equal(a, c) for a, c in zip(got, base))
        gb = T.flash_attention_bwd(q, k, v, *base, do, causal)
        gz = T.flash_attention_bwd(q, k, v, *base, do, causal, mask=zero)
        assert all(torch.equal(a, c) for a, c in zip(gz, gb))
    masked = T.flash_attention_fwd(q, k, v, False, mask=m)
    p0 = T.flash_attention_fwd(q, k, v, False, None, None, 0.0, 7, m)
    assert all(torch.equal(a, c) for a, c in zip(masked, p0))


def test_mask_refusals():
    q, k, v, do, _, _ = _inputs("d16", "none")
    q, k, v = (torch.from_numpy(x) for x in (q, k, v))
    b, s, h, _ = q.shape
    for bad in (torch.zeros(b, h, s, s - 1), torch.zeros(3, 1, 1, s),
                torch.zeros(1, 1, 1, 1, s)):
        with pytest.raises(ValueError, match="mask"):
            T.flash_attention_fwd(q, k, v, False, mask=bad)
    with pytest.raises(ValueError, match="seed"):
        T.flash_attention_fwd(q, k, v, False, None, None, 0.1, None,
                              torch.zeros(b, 1, 1, s))
