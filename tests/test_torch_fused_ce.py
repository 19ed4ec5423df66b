"""Chunked fused lm-head + CE: paddle_tpu_torch against the JAX reference.

`fused_linear_ce` is held to `paddle_tpu.ops.fused_ce.fused_linear_ce`
(value, valid-row count, and the gradients of the total in h and w through
`jax.vjp`) on seeded numpy inputs with N = 37 rows in chunks of 16 (the
last chunk padded) and ignored rows, in f32 within atol = rtol = 1e-5 (the
same sums in another order). `vocab_parallel_ce_rows` is held to the
reference's row losses the same way.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from paddle_tpu.ops import fused_ce as jce
from paddle_tpu_torch.ops import fused_ce as tce

torch.set_num_threads(1)


def _inputs(n, hid, vocab, seed):
    rs = np.random.RandomState(seed)
    h = rs.standard_normal((n, hid)).astype(np.float32)
    w = (rs.standard_normal((hid, vocab)) / np.sqrt(hid)).astype(np.float32)
    labels = rs.randint(0, vocab, n).astype(np.int64)
    labels[[0, 5, 36]] = -100
    return h, w, labels


def test_fused_linear_ce_value_and_grads_match_jax():
    h, w, labels = _inputs(37, 24, 50, 0)
    (tot_ref, cnt_ref), vjp = jax.vjp(
        lambda a, b: jce.fused_linear_ce(a, b, jnp.asarray(labels), chunk=16),
        jnp.asarray(h), jnp.asarray(w))
    gh_ref, gw_ref = vjp((jnp.float32(1.0), jnp.float32(0.0)))

    ht = torch.from_numpy(h).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    tot, cnt = tce.fused_linear_ce(ht, wt, torch.from_numpy(labels), chunk=16)
    tot.backward()
    assert float(cnt) == float(cnt_ref) == 34.0
    np.testing.assert_allclose(float(tot.detach()), float(tot_ref), rtol=1e-5)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(gh_ref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw_ref),
                               rtol=1e-5, atol=1e-5)
    assert not ht.grad[[0, 5, 36]].any()      # ignored rows: no gradient


@pytest.mark.parametrize("chunk", [16, 64], ids=["chunked", "one_chunk"])
def test_chunking_does_not_change_the_sum(chunk):
    h, w, labels = _inputs(37, 24, 50, 1)
    tot, cnt = tce.fused_linear_ce(torch.from_numpy(h), torch.from_numpy(w),
                                   torch.from_numpy(labels), chunk=chunk)
    logits = torch.from_numpy(h) @ torch.from_numpy(w)
    ref = torch.nn.functional.cross_entropy(logits, torch.from_numpy(labels),
                                            ignore_index=-100, reduction="sum")
    torch.testing.assert_close(tot, ref, rtol=1e-5, atol=1e-5)
    assert float(cnt) == 34.0


def test_ce_rows_match_jax():
    rs = np.random.RandomState(2)
    logits = rs.standard_normal((5, 7, 30)).astype(np.float32) * 3
    labels = rs.randint(0, 30, (5, 7)).astype(np.int64)
    labels[1, 2] = -100
    ref, _, gsum_ref = jce.vocab_parallel_ce_rows(jnp.asarray(logits),
                                                  jnp.asarray(labels))
    loss, _, gsum = tce.vocab_parallel_ce_rows(torch.from_numpy(logits),
                                               torch.from_numpy(labels))
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(gsum.numpy(), np.asarray(gsum_ref), rtol=1e-5)
    assert float(loss[1, 2]) == 0.0


def test_vocab_axis_is_not_ported():
    with pytest.raises(NotImplementedError, match="A8"):
        tce.fused_linear_ce(torch.zeros(2, 4), torch.zeros(4, 3),
                            torch.zeros(2, dtype=torch.long), axis="model")
