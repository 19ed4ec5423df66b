"""Ragged paged attention: paddle_tpu_torch against the JAX reference.

The plain PyTorch version is held to the Pallas `_ragged_kernel` in
interpret mode on the same seeded numpy inputs (f32), on valid rows only:
rows past a slot's real chunk end are garbage by contract. The cases are
those of tests/test_decode_kernels.py's ragged class. Tolerance 2e-5 (MHA)
and 1e-4 (GQA): the kernel folds the softmax page by page, the plain
version in one pass — the same sums in another order.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from paddle_tpu.ops.pallas import paged_attention as jp
from paddle_tpu_torch.ops.pallas import paged_attention as tp

torch.set_num_threads(1)


def _rand(seed, b, tq, h, h_kv, d, p, n_pages, max_pages):
    rng = np.random.RandomState(seed)
    q = (rng.randn(b, tq, h, d) * 0.3).astype(np.float32)
    kp = (rng.randn(n_pages, p, h_kv, d) * 0.3).astype(np.float32)
    vp = (rng.randn(n_pages, p, h_kv, d) * 0.3).astype(np.float32)
    table = rng.randint(0, n_pages, (b, max_pages)).astype(np.int32)
    return q, kp, vp, table


def _check(q, kp, vp, table, ctx, starts, act=None, tol=2e-5):
    ctx = np.asarray(ctx, np.int32)
    starts = np.asarray(starts, np.int32)
    ref = np.asarray(jp.ragged_paged_attention(
        *(jnp.asarray(a) for a in (q, kp, vp, table, ctx, starts)),
        active=None if act is None else jnp.asarray(act, jnp.int32),
        interpret=True))
    got = tp.ragged_paged_attention(
        *(torch.from_numpy(a) for a in (q, kp, vp, table, ctx, starts)),
        active=None if act is None else torch.tensor(act, dtype=torch.int32))
    got = got.numpy()
    assert got.shape == q.shape and got.dtype == np.float32
    tq = q.shape[1]
    for i in range(q.shape[0]):
        if act is not None and not act[i]:
            assert np.all(got[i] == 0), "inactive slot must emit zeros"
            continue
        n_valid = max(0, min(tq, int(ctx[i]) - int(starts[i])))
        np.testing.assert_allclose(got[i, :n_valid], ref[i, :n_valid],
                                   rtol=tol, atol=tol, err_msg=f"slot {i}")
        assert np.isfinite(got[i]).all()


def test_slots_at_different_offsets():
    q, kp, vp, table = _rand(0, 4, 8, 4, 4, 32, 8, 16, 6)
    _check(q, kp, vp, table, [8, 13, 31, 19], [0, 5, 23, 11])


def test_partial_chunk_and_active_mask():
    q, kp, vp, table = _rand(1, 4, 4, 2, 2, 32, 8, 8, 4)
    # slot 1 ends mid-chunk (ctx < start + tq); slot 2 is inactive
    _check(q, kp, vp, table, [4, 8, 6, 13], [0, 6, 2, 9], act=[1, 1, 0, 1])


def test_gqa_grouped_heads():
    q, kp, vp, table = _rand(2, 2, 4, 8, 2, 32, 8, 16, 4)
    _check(q, kp, vp, table, [7, 21], [3, 17], tol=1e-4)


def test_decode_is_the_tq1_special_case():
    """tq=1 with q_start = ctx - 1 agrees with the decode attention (the
    port's plain versions, and the JAX decode kernel)."""
    q, kp, vp, table = _rand(3, 3, 1, 4, 4, 32, 8, 16, 4)
    lens = np.asarray([3, 17, 30], np.int32)
    tq = [torch.from_numpy(a) for a in (q, kp, vp, table, lens)]
    rag = tp.ragged_paged_attention(tq[0], tq[1], tq[2], tq[3], tq[4],
                                    tq[4] - 1)[:, 0]
    dec = tp.paged_attention(tq[0][:, 0], tq[1], tq[2], tq[3], tq[4])
    np.testing.assert_allclose(rag.numpy(), dec.numpy(), rtol=2e-5,
                               atol=2e-5)
    jdec = np.asarray(jp.paged_attention(
        *(jnp.asarray(a) for a in (q[:, 0], kp, vp, table, lens)),
        interpret=True))
    np.testing.assert_allclose(rag.numpy(), jdec, rtol=2e-5, atol=2e-5)


def test_table_ids_clamped_and_zero_context():
    """Out-of-range table ids clamp to [0, n_pages) as the reference's do;
    an active slot with ctx 0 has no visible key and emits zeros."""
    q, kp, vp, table = _rand(4, 2, 4, 2, 2, 16, 4, 6, 3)
    table[0, 1] = 99
    table[1, 0] = -5
    clamped = np.clip(table, 0, 5)
    got = tp.ragged_paged_attention(
        *(torch.from_numpy(a) for a in (q, kp, vp, table)),
        torch.tensor([9, 0], dtype=torch.int32),
        torch.tensor([5, 0], dtype=torch.int32))
    ref = np.asarray(jp.ragged_paged_attention_reference(
        *(jnp.asarray(a) for a in (q, kp, vp, clamped)),
        jnp.asarray([9, 0], jnp.int32), jnp.asarray([5, 0], jnp.int32)))
    np.testing.assert_allclose(got.numpy()[0, :4], ref[0, :4], rtol=2e-5,
                               atol=2e-5)
    assert np.all(got.numpy()[1] == 0)


def test_cuda_path_validates_before_launch():
    """A non-CPU tensor never reaches the plain version: on a device this
    build cannot serve, the wrapper raises."""
    q, kp, vp, table = _rand(5, 1, 2, 2, 2, 16, 4, 2, 2)
    args = [torch.from_numpy(a).to("meta") for a in (q, kp, vp, table)]
    lens = torch.tensor([2], dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tp.ragged_paged_attention(*args, lens, lens)
