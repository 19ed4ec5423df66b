"""Flash-attention forward (causal) on [b, s, h, d].

Counterpart of the forward of `paddle_tpu/ops/pallas/flash_attention.py`
(`_fwd_kernel` via `_flash_fwd` / `make_flash_attention`). The Pallas TPU
kernel is replaced by `csrc/flash_attention.cu`; the plain PyTorch
version beside it (the counterpart of `_xla_ref`) serves CPU tensors and
is the yardstick the kernel is held against on the card.

Keys at positions >= s_true are masked (padding inside a padded prompt).
Returns o in the input dtype and lse = logsumexp of each query row's
scaled logits, [b, h, s] f32 (the residual the training slice's backward
needs). Additive masks, dropout and the backward kernel belong to later
slices.
"""
import ctypes
import math

import torch

from ... import _build

NEG_INF = -1e30

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_reference(q, k, v, causal=True, scale=None, s_true=None):
    """Plain version: dense scores in f32, masked by s_true and (when
    causal) by position, softmax, then P @ V. Returns (o, lse)."""
    b, s, h, d = q.shape
    sk = k.shape[1]
    s_true = sk if s_true is None else int(s_true)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    cols = torch.arange(sk, device=q.device)[None, :]
    valid = cols < s_true
    if causal:
        rows = torch.arange(s, device=q.device)[:, None]
        valid = valid & (rows >= cols)
    logits = torch.where(valid, logits, torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    o = torch.einsum("bhqk,bkhd->bqhd", p / l, v.float()).to(q.dtype)
    lse = (m + torch.log(l))[..., 0]
    return o, lse


def flash_attention_fwd(q, k, v, causal=True, scale=None, s_true=None):
    """Causal flash-attention forward. q, k, v: [b, s, h, d] with k/v
    already at q's head count. Returns (o [b, s, h, d], lse [b, h, s]).

    A CPU tensor takes the plain version. A CUDA tensor launches
    `csrc/flash_attention.cu` (causal only, d 64 or 128, bf16 or f32) or
    raises; there is no fallback."""
    if q.dim() != 4 or tuple(k.shape) != tuple(q.shape) \
            or tuple(v.shape) != tuple(q.shape):
        raise ValueError(
            f"flash_attention_fwd takes equal [b, s, h, d] q/k/v; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    s_true = s if s_true is None else int(s_true)
    if not 0 <= s_true <= s:
        raise ValueError(f"s_true={s_true} outside [0, {s}]")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, scale, s_true)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: unsupported device {q.device}")
    if not causal:
        raise ValueError("flash_attention_fwd kernel is causal only")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_attention_fwd kernel takes bf16/f32 q/k/v of one dtype; "
            f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in (64, 128):
        raise ValueError(f"flash_attention_fwd kernel takes d 64 or 128; "
                         f"got {d}")
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError("flash_attention_fwd: operands on different devices")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=dev)
    if b * h * s == 0:
        return o, lse
    lib = _build.library()
    code = lib.ptt_flash_attention_fwd(
        ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
        ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(o.data_ptr()),
        ctypes.c_void_p(lse.data_ptr()),
        b, s, h, d, s_true, float(scale), _DTYPE_CODE[q.dtype],
        dev.index, _build.stream_ptr(dev))
    _build.check(code, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0
