"""int8 weight-only matmul: paddle_tpu_torch against the JAX reference.

The same seeded numpy inputs go to both packages. Quantization is pinned
bit for bit (int8 values equal, scales bitwise equal). The plain PyTorch
product is held to the Pallas kernel in interpret mode within rtol = atol
= 1e-5 in f32: both sum f32 partial products over k tiles of 512, but in
another order inside a tile.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from paddle_tpu.ops.pallas import quantized_matmul as jq
from paddle_tpu_torch.ops.pallas import quantized_matmul as tq

torch.set_num_threads(1)


@pytest.mark.parametrize("k,n", [(64, 48), (600, 80), (1100, 33)])
def test_quantize_weights_bitwise(k, n):
    w = np.random.RandomState(k + n).standard_normal((k, n)).astype(np.float32)
    w[:, 0] = 0.0                      # an all-zero channel: scale 0
    wq_j, sc_j = jq.quantize_weights(jnp.asarray(w))
    wq_t, sc_t = tq.quantize_weights(torch.from_numpy(w))
    assert wq_t.dtype == torch.int8 and sc_t.dtype == torch.float32
    np.testing.assert_array_equal(wq_t.numpy(), np.asarray(wq_j))
    np.testing.assert_array_equal(sc_t.numpy().view(np.uint32),
                                  np.asarray(sc_j).view(np.uint32))


@pytest.mark.parametrize("m,k,n", [(3, 600, 80), (1, 1030, 64), (5, 64, 17)])
def test_plain_matches_pallas_interpret(m, k, n):
    rs = np.random.RandomState(m * 1000 + k)
    x = rs.standard_normal((m, k)).astype(np.float32)
    w = rs.standard_normal((k, n)).astype(np.float32)
    wq_j, sc_j = jq.quantize_weights(jnp.asarray(w))
    ref = np.asarray(jq.quantized_matmul(jnp.asarray(x), wq_j, sc_j,
                                         interpret=True))
    wq_t, sc_t = tq.quantize_weights(torch.from_numpy(w))
    got = tq.quantized_matmul(torch.from_numpy(x), wq_t, sc_t)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_bf16_cpu_path_keeps_dtype():
    x = torch.randn(2, 40, dtype=torch.bfloat16)
    wq, sc = tq.quantize_weights(torch.randn(40, 24))
    out = tq.quantized_matmul(x, wq, sc)
    assert out.dtype == torch.bfloat16
    ref = (x.float() @ wq.float()) * sc
    torch.testing.assert_close(out.float(), ref, rtol=1e-2, atol=1e-2)


def test_shape_mismatch_raises():
    wq, sc = tq.quantize_weights(torch.randn(8, 4))
    with pytest.raises(ValueError):
        tq.quantized_matmul(torch.randn(2, 9), wq, sc)
