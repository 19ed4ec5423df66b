"""The batched LoRA delta of multi-adapter serving (`inference/adapters.py`).

Counterpart of `paddle_tpu/inference/adapters.py` `lora_delta` /
`lora_apply`, which the reference computes as two jnp.einsum calls; no
Pallas kernel stands behind them. On CUDA the delta is the hand-written
shrink / expand pair of `csrc/lora_bgmv.cu`: each row is summed in one
fixed order, so its bits depend only on that row, its adapter and the
factors, never on how many rows share the call (a decode step's 1 per
request or a verify pass's T). The plain version (`lora_delta_reference`,
the einsum pair in torch) serves CPU tensors and is what the kernel is held
against on the card.

Meaning, as the reference's: f32 accumulation; xa = (x . A[aid]) * scale,
then xa . B[aid]; the result `y + delta.to(y.dtype)`, where-gated per row
so a row with aid 0 keeps y's exact bits (a -0.0 included).
"""
import ctypes

import torch

from .. import _build

MAX_RANK = 64      # the largest pool rank the CUDA build takes
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def lora_delta_reference(x, a_stack, b_stack, aid, scale):
    """Plain version: x [w, t, in], a_stack [C, in, r], b_stack [C, r, out],
    aid [w] pool-slot ids, scale [w] f32 (alpha / r per row). The grouped
    einsum pair in f32; returns the f32 delta [w, t, out]."""
    a_sel = a_stack[aid.long()].float()
    b_sel = b_stack[aid.long()].float()
    xa = torch.einsum("wti,wir->wtr", x.float(), a_sel)
    xa = xa * scale.float()[:, None, None]
    return torch.einsum("wtr,wro->wto", xa, b_sel)


def lora_apply_reference(y, x, a_stack, b_stack, aid, scale):
    """Plain version of one target's gated apply: y + delta in y's dtype
    where aid > 0, y's own values elsewhere."""
    d = lora_delta_reference(x, a_stack, b_stack, aid, scale)
    return torch.where((aid > 0)[:, None, None], y + d.to(y.dtype), y)


def _check(x, a_stack, b_stack, aid, scale, y=None):
    """The CUDA build's contract: x [w, t, in] (bf16 / f32, contiguous), y
    [w, t, out] of x's dtype, f32 contiguous stacks of one pool rank <=
    MAX_RANK, int32 aid and f32 scale of w entries, all on one card."""
    if x.dim() != 3:
        raise ValueError(f"lora: x must be [w, t, in], got {tuple(x.shape)}")
    w, t, din = x.shape
    tensors = [x, a_stack, b_stack, aid, scale] + ([] if y is None else [y])
    if any(v.device != x.device for v in tensors):
        raise ValueError("lora: operands on different devices")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"lora kernel takes bf16/f32 activations; got {x.dtype}")
    if a_stack.dtype != torch.float32 or b_stack.dtype != torch.float32:
        raise ValueError("lora kernel takes f32 factor stacks")
    if aid.dtype != torch.int32 or scale.dtype != torch.float32:
        raise ValueError(f"lora kernel takes int32 aid and f32 scale; got "
                         f"{aid.dtype}, {scale.dtype}")
    if tuple(aid.shape) != (w,) or tuple(scale.shape) != (w,):
        raise ValueError(f"lora: aid {tuple(aid.shape)} / scale "
                         f"{tuple(scale.shape)} must have the {w} slots of x")
    r = a_stack.shape[2]
    if a_stack.dim() != 3 or a_stack.shape[1] != din or b_stack.dim() != 3 \
            or b_stack.shape[:2] != (a_stack.shape[0], r):
        raise ValueError(f"lora: stacks {tuple(a_stack.shape)} / "
                         f"{tuple(b_stack.shape)} do not fit x {tuple(x.shape)}")
    if r > MAX_RANK:
        raise ValueError(f"lora kernel takes a pool rank <= {MAX_RANK}; got {r}")
    if y is not None and (y.dtype != x.dtype
                          or tuple(y.shape) != (w, t, b_stack.shape[2])):
        raise ValueError(f"lora: y {tuple(y.shape)} {y.dtype} does not fit x "
                         f"{tuple(x.shape)} {x.dtype} and B {tuple(b_stack.shape)}")
    if w * t > 65535:
        raise ValueError(f"lora kernel takes at most 65535 rows; got {w * t}")
    if not all(v.is_contiguous() for v in tensors):
        raise ValueError("lora kernel takes contiguous operands")


def lora_bgmv(x, a_stack, b_stack, aid, scale, y=None):
    """The CUDA shrink / expand pair on x [w, t, in] (t rows per request
    slot, aid / scale [w]). With y [w, t, out]: returns y + delta, gated on
    aid > 0 (an aid-0 row is y's copy); without: the f32 delta (0 on aid-0
    rows). Raises on what the build does not take; there is no fallback."""
    if x.device.type != "cuda":
        raise ValueError(f"lora: unsupported device {x.device} (the plain "
                         "version serves CPU tensors)")
    _check(x, a_stack, b_stack, aid, scale, y)
    return _launch(x, a_stack, b_stack, aid, scale, y)


def _launch(x, a_stack, b_stack, aid, scale, y):
    w, t, din = x.shape
    r, n = a_stack.shape[2], b_stack.shape[2]
    m = w * t
    dev = x.device
    xa = torch.empty((m, r), dtype=torch.float32, device=dev)
    out = torch.empty((w, t, n), dtype=torch.float32 if y is None else y.dtype,
                      device=dev)
    if m == 0:
        return out
    lib = _build.library()
    stream = _build.stream_ptr(dev)
    code = _DTYPE_CODE[x.dtype]
    _build.check(lib.ptt_lora_shrink(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(a_stack.data_ptr()),
        ctypes.c_void_p(aid.data_ptr()), ctypes.c_void_p(scale.data_ptr()),
        ctypes.c_void_p(xa.data_ptr()), m, t, din, r, code, dev.index,
        stream), "lora_shrink")
    _build.check(lib.ptt_lora_expand(
        ctypes.c_void_p(xa.data_ptr()), ctypes.c_void_p(b_stack.data_ptr()),
        ctypes.c_void_p(aid.data_ptr()),
        ctypes.c_void_p(0 if y is None else y.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), m, t, r, n, code, dev.index,
        stream), "lora_expand")
    lora_bgmv.launches += 1
    return out


lora_bgmv.launches = 0


def _as3(x):
    """[w, t, k] view of x ([w, k] is one row per slot)."""
    return x if x.dim() == 3 else x.reshape(x.shape[0], -1, x.shape[-1])


def lora_delta(x, a_stack, b_stack, aid, scale):
    """The grouped low-rank delta of one target (f32, [w, t, out]): the
    plain version for CPU tensors, `csrc/lora_bgmv.cu` for CUDA ones."""
    if x.device.type == "cpu":
        return lora_delta_reference(x, a_stack, b_stack, aid, scale)
    return lora_bgmv(_as3(x), a_stack, b_stack, aid, scale) \
        .reshape(*x.shape[:-1], -1)


def lora_apply(y, x, target, sel):
    """y + the target's delta, where-gated per row: aid == 0 rows keep y's
    bits. sel is the per-layer selection tuple the engine builds
    (`_ad_sel`): (a_dict, b_dict, aid, scale, gate); the CUDA build gates
    on aid itself."""
    a_l, b_l, aid, scale, gate = sel
    if target not in a_l:
        return y
    a, b = a_l[target], b_l[target]
    if y.device.type == "cpu":
        d = lora_delta_reference(_as3(x), a, b, aid, scale) \
            .reshape(*y.shape[:-1], -1)
        g = gate.reshape(-1, *([1] * (y.dim() - 1)))
        return torch.where(g, y + d.to(y.dtype), y)
    return lora_bgmv(_as3(x), a, b, aid, scale, y=_as3(y)).reshape(y.shape)
