"""RMSNorm in the training cast order, with its analytic gradient.

Counterpart of `paddle_tpu/ops/pallas/rms_norm.py` (`make_rms_norm`): the
forward is the Pallas TPU kernel `_rms_fwd_kernel`, replaced here by
`csrc/rms_norm.cu`; the backward is the reference's VJP written in jnp
(`make_rms_norm.bwd`), written here in torch ops. `rms_norm_reference` is
the plain version (the counterpart of `nn/functional/norm.py`
`_rms_norm_xla`); it serves CPU tensors and is the yardstick the kernel is
held against on the card.

Training cast order: y = (x * rsqrt(mean(x^2) + eps) * w) in f32, rounded
once to x's dtype. The serving engine's `_rms` casts x * rsqrt back to
x's dtype BEFORE the weight multiply (the reference's `rms_rows`); the
two give different bits in bf16, so serving keeps its own
(`inference/serving.py`) and the two are not merged.
"""
import ctypes

import torch

from ... import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def rms_norm_reference(x, w, eps=1e-6):
    """Plain version, training cast order (f32 math, one rounding)."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def rms_norm_fwd(x, w, eps=1e-6):
    """RMSNorm forward over the last dim of x (any leading shape).

    A CPU tensor takes the plain version. A CUDA tensor launches
    `csrc/rms_norm.cu` (bf16/f32 x and w, the last dim a multiple of 8)
    or raises; there is no fallback."""
    d = x.shape[-1]
    if tuple(w.shape) != (d,):
        raise ValueError(f"rms_norm: weight {tuple(w.shape)} does not match "
                         f"the last dim {d} of x")
    if x.device.type == "cpu":
        return rms_norm_reference(x, w, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm: unsupported device {x.device}")
    if w.device != x.device:
        raise ValueError("rms_norm: x and weight on different devices")
    if x.dtype not in _DTYPE_CODE or w.dtype not in _DTYPE_CODE:
        raise ValueError(f"rms_norm kernel takes bf16/f32 x and weight; got "
                         f"{x.dtype}, {w.dtype}")
    if d % 8:
        raise ValueError(f"rms_norm kernel takes a last dim that is a "
                         f"multiple of 8; got {d}")
    x2 = _aligned(x.reshape(-1, d))
    w = _aligned(w)
    y = torch.empty_like(x2)
    n = x2.shape[0]
    if n == 0:
        return y.reshape(x.shape)
    dev = x.device
    code = _build.library().ptt_rms_norm_fwd(
        ctypes.c_void_p(x2.data_ptr()), ctypes.c_void_p(w.data_ptr()),
        ctypes.c_void_p(y.data_ptr()), n, d, float(eps),
        _DTYPE_CODE[x.dtype], _DTYPE_CODE[w.dtype], dev.index,
        _build.stream_ptr(dev))
    _build.check(code, "rms_norm")
    rms_norm_fwd.launches += 1
    return y.reshape(x.shape)


rms_norm_fwd.launches = 0


def _aligned(t):
    """Contiguous, and 16-byte aligned for the kernel's vector loads."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def rms_norm_bwd(x, w, g, eps=1e-6):
    """The reference's analytic VJP (`make_rms_norm.bwd`), in f32:
    gx = inv * (g*w - xhat * mean(g*w*xhat)), gw = sum over rows of
    g * xhat. Returns (gx in x's dtype, gw in w's dtype)."""
    d = x.shape[-1]
    x2 = x.reshape(-1, d).float()
    g2 = g.reshape(-1, d).float()
    inv = torch.rsqrt(x2.square().mean(dim=-1, keepdim=True) + eps)
    xhat = x2 * inv
    gw = (g2 * xhat).sum(dim=0).to(w.dtype)
    gxhat = g2 * w.float()
    gx = inv * (gxhat - xhat * (gxhat * xhat).mean(dim=-1, keepdim=True))
    return gx.reshape(x.shape).to(x.dtype), gw


class RMSNormFunction(torch.autograd.Function):
    """Forward: `rms_norm_fwd` (the kernel on CUDA); backward: the analytic
    VJP. Saves x and w, as the reference's custom VJP does."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return rms_norm_fwd(x, w, eps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx, gw = rms_norm_bwd(x, w, g, ctx.eps)
        return gx, gw, None


def rms_norm(x, w, eps=1e-6):
    """Differentiable RMSNorm (training cast order)."""
    return RMSNormFunction.apply(x, w, eps)
