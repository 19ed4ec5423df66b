"""Paged-attention decode: paddle_tpu_torch against the JAX reference.

The plain PyTorch version is held to the Pallas `_decode_kernel` in
interpret mode on the same seeded numpy inputs, f32, atol = rtol = 1e-5
(the kernel folds the softmax page by page, the plain version in one
pass: the same sums in another order).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from paddle_tpu.ops.pallas import paged_attention as jp
from paddle_tpu_torch.ops.pallas import paged_attention as tp

torch.set_num_threads(1)


def _inputs(b, h, h_kv, d, p, max_pages, lens, seed):
    rs = np.random.RandomState(seed)
    n_pages = b * max_pages + 3
    q = rs.standard_normal((b, h, d)).astype(np.float32)
    kp = rs.standard_normal((n_pages, p, h_kv, d)).astype(np.float32)
    vp = rs.standard_normal((n_pages, p, h_kv, d)).astype(np.float32)
    table = rs.permutation(n_pages)[:b * max_pages].reshape(b, max_pages)
    return q, kp, vp, table.astype(np.int32), np.asarray(lens, np.int32)


@pytest.mark.parametrize("h,h_kv", [(4, 4), (4, 2)], ids=["mha", "gqa2"])
def test_plain_matches_pallas_interpret(h, h_kv):
    q, kp, vp, table, lens = _inputs(3, h, h_kv, 16, 8, 5, [13, 40, 1], 0)
    ref = np.asarray(jp.paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lens), interpret=True))
    got = tp.paged_attention(*(torch.from_numpy(a) for a in
                               (q, kp, vp, table, lens)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_active_mask_zero_rows():
    q, kp, vp, table, lens = _inputs(3, 4, 2, 16, 8, 4, [9, 17, 30], 1)
    active = np.asarray([1, 0, 1], np.int32)
    ref = np.asarray(jp.paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lens), interpret=True, active=jnp.asarray(active)))
    got = tp.paged_attention(*(torch.from_numpy(a) for a in
                               (q, kp, vp, table, lens)),
                             active=torch.from_numpy(active))
    assert np.all(got.numpy()[1] == 0.0)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_matches_jax_reference_with_scale():
    q, kp, vp, table, lens = _inputs(2, 4, 1, 32, 8, 3, [24, 5], 2)
    ref = np.asarray(jp.paged_attention_reference(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lens), scale=0.3))
    got = tp.paged_attention(*(torch.from_numpy(a) for a in
                               (q, kp, vp, table, lens)), scale=0.3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_expand_kv_heads_matches_jax():
    x = np.random.RandomState(3).standard_normal((2, 5, 2, 8)).astype(
        np.float32)
    np.testing.assert_array_equal(
        tp.expand_kv_heads(torch.from_numpy(x), 6).numpy(),
        np.asarray(jp.expand_kv_heads(jnp.asarray(x), 6)))


# paged_attention_dense: [b, L, h, d] caches viewed as identity-tabled pages.
# The reference's interpret kernel and the port's plain version both
# compute in f32 and round once to the inputs' dtype: f32 agrees to 1e-5
# (the same sums in another order); bf16 outputs may differ by one bf16
# ulp where the f32 results straddle a rounding boundary (2^-7 of values
# below 2: atol 1e-2).
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seq_len", ["scalar", "per_slot"])
@pytest.mark.parametrize("page_size", [None, 4], ids=["default_page", "page4"])
def test_dense_matches_reference(dtype, seq_len, page_size):
    b, L, h, d = 2, 24, 4, 16      # the default page: 128 halved to 8
    rs = np.random.RandomState(7)
    q, kc, vc = (rs.standard_normal(shape).astype(np.float32)
                 for shape in ((b, h, d), (b, L, h, d), (b, L, h, d)))
    sl = 13 if seq_len == "scalar" else np.asarray([13, 24], np.int32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = jp.paged_attention_dense(
        *(jnp.asarray(a).astype(jdt) for a in (q, kc, vc)),
        sl if seq_len == "scalar" else jnp.asarray(sl), page_size=page_size,
        interpret=True)
    tdt = getattr(torch, dtype)
    got = tp.paged_attention_dense(
        *(torch.from_numpy(a).to(tdt) for a in (q, kc, vc)),
        sl if seq_len == "scalar" else torch.from_numpy(sl),
        page_size=page_size)
    assert got.dtype == tdt and tuple(got.shape) == (b, h, d)
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_dense_refuses_a_page_that_does_not_divide_the_cache():
    kc = torch.zeros(1, 24, 2, 16)
    with pytest.raises(ValueError, match="divide"):
        tp.paged_attention_dense(torch.zeros(1, 2, 16), kc, kc, 5, page_size=5)
