"""int8 weight-only matmul: out[m, n] = (x @ w_int8)[m, n] * scale[n].

Counterpart of `paddle_tpu/ops/pallas/quantized_matmul.py`. The Pallas
TPU kernel `_qmm_kernel` is replaced by `csrc/quantized_matmul.cu`; the
plain PyTorch version beside it serves CPU tensors and is the yardstick
the kernel is held against on the card.

Weights keep Paddle's [k, n] ("[in, out]") layout with one f32 scale per
output channel, exactly as `quantize_weights` produces them.
"""
import ctypes

import torch

from ... import _build

K_TILE = 512   # the reference's k tile: f32 partial sums are added per tile

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def quantize_weights(w, axis=0):
    """Symmetric per-channel int8 quantization of a [k, n] weight.
    Returns (w_int8 [k, n], scales [n] f32): absmax over `axis` / 127,
    round half to even, clip to +-127. Plain torch, not a kernel."""
    w = w.float()
    amax = torch.amax(torch.abs(w), dim=axis, keepdim=True)
    scales = amax / 127.0
    wq = torch.clamp(torch.round(w / torch.clamp(scales, min=1e-12)),
                     -127, 127)
    return wq.to(torch.int8), scales.reshape(-1)


def quantized_matmul_reference(x, w_int8, scales, out_dtype=None):
    """Plain version: f32 partial products over k tiles of 512, summed
    tile by tile as the reference kernel does, scale applied once at the
    end."""
    m, k = x.shape
    out_dtype = out_dtype or x.dtype
    xf = x.float()
    acc = torch.zeros((m, w_int8.shape[1]), dtype=torch.float32,
                      device=x.device)
    for k0 in range(0, k, K_TILE):
        acc += xf[:, k0:k0 + K_TILE] @ w_int8[k0:k0 + K_TILE].float()
    return (acc * scales.float()[None, :]).to(out_dtype)


def quantized_matmul(x, w_int8, scales, out_dtype=None):
    """x: [m, k] float; w_int8: [k, n] int8; scales: [n] f32.
    Returns [m, n] in out_dtype (default x.dtype).

    A CPU tensor takes the plain version. A CUDA tensor launches
    `csrc/quantized_matmul.cu` (bf16 or f32 x, output in x's dtype) or
    raises; there is no fallback."""
    if x.dim() != 2 or w_int8.dim() != 2 or x.shape[1] != w_int8.shape[0] \
            or scales.shape != (w_int8.shape[1],):
        raise ValueError(
            f"quantized_matmul shapes: x {tuple(x.shape)}, w "
            f"{tuple(w_int8.shape)}, scales {tuple(scales.shape)}")
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return quantized_matmul_reference(x, w_int8, scales, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"quantized_matmul: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODE or out_dtype != x.dtype:
        raise ValueError(
            f"quantized_matmul kernel takes bf16/f32 x and emits x's dtype; "
            f"got x {x.dtype}, out {out_dtype}")
    if w_int8.dtype != torch.int8 or scales.dtype != torch.float32:
        raise ValueError(
            f"quantized_matmul kernel takes int8 w and f32 scales; got "
            f"{w_int8.dtype}, {scales.dtype}")
    for t in (w_int8, scales):
        if t.device != x.device:
            raise ValueError("quantized_matmul: operands on different devices")
    x = x.contiguous()
    w_int8 = w_int8.contiguous()
    scales = scales.contiguous()
    m, k = x.shape
    n = w_int8.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    lib = _build.library()
    code = lib.ptt_quantized_matmul(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(w_int8.data_ptr()),
        ctypes.c_void_p(scales.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        m, k, n, _DTYPE_CODE[x.dtype], x.device.index,
        _build.stream_ptr(x.device))
    _build.check(code, "quantized_matmul")
    quantized_matmul.launches += 1
    return out


quantized_matmul.launches = 0
