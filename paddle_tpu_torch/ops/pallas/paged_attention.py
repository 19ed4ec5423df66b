"""Paged-attention decode: one query token per slot over its KV pages.

Counterpart of `paddle_tpu/ops/pallas/paged_attention.py`. The Pallas
TPU kernel `_decode_kernel` is replaced by `csrc/paged_attention.cu`; the
plain PyTorch version beside it serves CPU tensors and is the yardstick
the kernel is held against on the card.

Layout (as in the reference):
  q          : [b, h, d]
  k/v_pages  : [n_pages, p, h_kv, d]   (GQA: q head i reads kv head
                                         i // (h // h_kv))
  page_table : [b, max_pages] int32
  seq_lens   : [b] int32   (keys at positions >= seq_lens[b] are masked)
  active     : optional [b] mask; inactive slots emit zeros
"""
import ctypes
import math

import torch

from ... import _build

NEG_INF = -1e30

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 256
MAX_REP_D = 2048   # rep * d the kernel's per-thread accumulators cover


def expand_kv_heads(x, h_q):
    """[..., h_kv, d] -> [..., h_q, d], each kv head repeated over its
    query group (the GQA convention every path shares). Identity when
    the head counts already match."""
    h_kv = x.shape[-2]
    if h_kv == h_q:
        return x
    if h_q % h_kv:
        raise ValueError(f"{h_q} query heads do not group {h_kv} kv heads")
    return torch.repeat_interleave(x, h_q // h_kv, dim=-2)


def paged_attention_reference(q, k_pages, v_pages, page_table, seq_lens,
                              scale=None, active=None):
    """Plain version: gather each slot's pages, mask by length, softmax in
    f32. Inactive slots (and slots of length 0) emit zeros."""
    b, h, d = q.shape
    n_pages, p, h_kv, _ = k_pages.shape
    max_pages = page_table.shape[1]
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    table = page_table.long().clamp(0, n_pages - 1)
    out = torch.zeros((b, h, d), dtype=torch.float32, device=q.device)
    for i in range(b):
        L = min(int(seq_lens[i]), max_pages * p)
        if L <= 0 or (active is not None and not bool(active[i])):
            continue
        ks = k_pages[table[i]].reshape(max_pages * p, h_kv, d)[:L]
        vs = v_pages[table[i]].reshape(max_pages * p, h_kv, d)[:L]
        ks = expand_kv_heads(ks, h).float()
        vs = expand_kv_heads(vs, h).float()
        logits = torch.einsum("hd,khd->hk", q[i].float(), ks) * s
        w = torch.softmax(logits, dim=-1)
        out[i] = torch.einsum("hk,khd->hd", w, vs)
    return out.to(q.dtype)


def paged_attention(q, k_pages, v_pages, page_table, seq_lens, scale=None,
                    active=None):
    """Decode attention over a paged KV cache. Returns [b, h, d] in q's
    dtype.

    A CPU tensor takes the plain version. A CUDA tensor launches
    `csrc/paged_attention.cu` (bf16 or f32, d a multiple of 16 up to 256)
    or raises; there is no fallback."""
    b, h, d = q.shape
    n_pages, p, h_kv, dd = k_pages.shape
    if dd != d or h % h_kv or tuple(v_pages.shape) != tuple(k_pages.shape) \
            or page_table.dim() != 2 or page_table.shape[0] != b \
            or tuple(seq_lens.shape) != (b,):
        raise ValueError(
            f"paged_attention shapes: q {tuple(q.shape)}, pages "
            f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}, table "
            f"{tuple(page_table.shape)}, lens {tuple(seq_lens.shape)}")
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, page_table,
                                         seq_lens, s, active)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    rep = h // h_kv
    if q.dtype not in _DTYPE_CODE or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise ValueError(
            f"paged_attention kernel takes bf16/f32 q and pages of the same "
            f"dtype; got q {q.dtype}, pages {k_pages.dtype}/{v_pages.dtype}")
    if d % 16 or d > MAX_D or rep * d > MAX_REP_D:
        raise ValueError(
            f"paged_attention kernel takes d a multiple of 16 up to {MAX_D} "
            f"and rep*d <= {MAX_REP_D}; got d={d}, rep={rep}")
    dev = q.device
    q = q.contiguous()
    k_pages = k_pages.contiguous()
    v_pages = v_pages.contiguous()
    table = page_table.to(device=dev, dtype=torch.int32).contiguous()
    lens = seq_lens.to(device=dev, dtype=torch.int32).contiguous()
    act = None if active is None else \
        active.to(device=dev, dtype=torch.int32).contiguous()
    for t in (k_pages, v_pages):
        if t.device != dev:
            raise ValueError("paged_attention: operands on different devices")
    out = torch.empty_like(q)
    if b == 0:
        return out
    lib = _build.library()
    code = lib.ptt_paged_attention(
        ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k_pages.data_ptr()),
        ctypes.c_void_p(v_pages.data_ptr()), ctypes.c_void_p(table.data_ptr()),
        ctypes.c_void_p(lens.data_ptr()),
        ctypes.c_void_p(0 if act is None else act.data_ptr()),
        ctypes.c_void_p(out.data_ptr()),
        b, h, h_kv, d, p, n_pages, table.shape[1], float(s),
        _DTYPE_CODE[q.dtype], dev.index, _build.stream_ptr(dev))
    _build.check(code, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
