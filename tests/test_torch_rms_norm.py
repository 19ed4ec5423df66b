"""RMSNorm (training cast order): paddle_tpu_torch against the JAX reference.

The plain forward and the analytic backward are held to the Pallas
`make_rms_norm(rows=8, interpret=True)` (its custom VJP) under `jax.vjp`,
on seeded numpy inputs with a row count (21) that is not a multiple of the
8-row block. f32: atol = rtol = 1e-5 (the same f32 formulas, sums in
another order). bf16: both sides compute in f32 and round once, so they
differ by at most one bf16 rounding: rtol = 2^-7, atol = 1e-2 for
gradients whose f32 sums cancel.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas.rms_norm import make_rms_norm
from paddle_tpu_torch.ops.pallas import rmsnorm
from paddle_tpu_torch.ops.pallas import rms_norm as tr

torch.set_num_threads(1)

_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
        "bfloat16": dict(rtol=2 ** -7, atol=1e-2)}


def _inputs(rows, d, seed):
    rs = np.random.RandomState(seed)
    x = rs.standard_normal((3, rows // 3, d)).astype(np.float32) * 2.0
    w = (1.0 + 0.1 * rs.standard_normal(d)).astype(np.float32)
    g = rs.standard_normal(x.shape).astype(np.float32)
    return x, w, g


def _as(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_grads_match_pallas_interpret(dtype):
    x, w, g = _inputs(21, 64, 0)
    eps = 1e-6
    jdt = jnp.dtype(dtype)
    rms = make_rms_norm(rows=8, interpret=True)
    y_ref, vjp = jax.vjp(lambda a, b: rms(a, b, eps), jnp.asarray(x, jdt),
                         jnp.asarray(w, jdt))
    gx_ref, gw_ref = vjp(jnp.asarray(g, jdt))

    xt = _as(x, dtype).requires_grad_(True)
    wt = _as(w, dtype).requires_grad_(True)
    y = rmsnorm(xt, wt, eps)
    y.backward(_as(g, dtype))
    assert y.dtype == xt.dtype and xt.grad.dtype == xt.dtype
    assert wt.grad.dtype == wt.dtype
    tol = _TOL[dtype]
    for got, ref in ((y, y_ref), (xt.grad, gx_ref), (wt.grad, gw_ref)):
        np.testing.assert_allclose(got.detach().float().numpy(),
                                   np.asarray(ref.astype(jnp.float32)), **tol)


def test_plain_forward_is_the_training_cast_order():
    """The weight multiplies in f32 before the one rounding to bf16: not
    the serving order (cast, then weight), which rounds twice."""
    x, w, _ = _inputs(21, 64, 1)
    xb, wb = _as(x, "bfloat16"), _as(w, "bfloat16")
    y = tr.rms_norm_fwd(xb, wb, 1e-6)
    x32 = xb.float()
    inv = torch.rsqrt(x32.square().mean(-1, keepdim=True) + 1e-6)
    torch.testing.assert_close(y, (x32 * inv * wb.float()).to(torch.bfloat16),
                               rtol=0, atol=0)
    serving = (x32 * inv).to(torch.bfloat16) * wb
    assert not torch.equal(y, serving)


def test_cpu_call_launches_nothing():
    tr.rms_norm_fwd.launches = 0
    x, w, _ = _inputs(6, 16, 2)
    tr.rms_norm_fwd(torch.from_numpy(x), torch.from_numpy(w))
    assert tr.rms_norm_fwd.launches == 0
    with pytest.raises(ValueError, match="weight"):
        tr.rms_norm_fwd(torch.from_numpy(x), torch.ones(8))
