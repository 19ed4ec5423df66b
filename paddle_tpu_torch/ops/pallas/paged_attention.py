"""Paged attention: one query token per slot over its KV pages (decode),
and tq tokens per slot at ragged offsets (`ragged_paged_attention`,
chunked prefill; `spec_verify_attention`, its speculative-verify entry).

Counterpart of `paddle_tpu/ops/pallas/paged_attention.py`. The Pallas
TPU kernels `_decode_kernel` and `_ragged_kernel` are replaced by
`csrc/paged_attention.cu` and two builds of the ragged kernel, chosen by
`ragged_route`: `csrc/ragged_paged_attention_tc.cu` (tensor cores, the
bf16 chunked prefill) and `csrc/ragged_paged_attention.cu` (per page, on
the CUDA cores: tq = 1, the verify entry, f32). The plain PyTorch versions
beside them serve CPU tensors and are the yardsticks the kernels are held
against on the card.

Decode layout (as in the reference):
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


def ragged_causal_mask(shape, tq, q_start, page_start, ctx_len,
                       device=None):
    """The ragged multi-token-q causal mask over a [rows, keys] logits
    block whose rows are (head, token)-flattened with the token minor (row
    r is chunk offset r % tq): key column c (global position page_start +
    c) is visible to row r iff it is at or before the row's own position
    q_start + r % tq and inside the context (< ctx_len). q_start and
    ctx_len may be tensors that broadcast against [rows, keys] (one per
    slot: shape [b, 1, 1] gives a [b, rows, keys] mask). One definition
    for the ragged kernel's plain version and the verify entry, as in the
    reference (`paged_attention.py` `ragged_causal_mask`)."""
    rows = torch.arange(shape[0], device=device)[:, None] % tq
    kpos = torch.arange(shape[1], device=device)[None, :] + page_start
    return (kpos <= q_start + rows) & (kpos < ctx_len)


def ragged_paged_attention_reference(q, k_pages, v_pages, page_table,
                                     ctx_lens, q_starts, active=None,
                                     scale=None):
    """Plain version: gather each slot's pages, mask key c for the row at
    chunk offset qi unless c <= q_starts[b] + qi and c < ctx_lens[b],
    softmax in f32. Rows with no visible key (inactive slots included)
    emit zeros."""
    b, tq, h, d = q.shape
    n_pages, p, h_kv, _ = k_pages.shape
    max_pages = page_table.shape[1]
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    table = page_table.long().clamp(0, n_pages - 1)
    ks = expand_kv_heads(k_pages[table].reshape(b, max_pages * p, h_kv, d), h)
    vs = expand_kv_heads(v_pages[table].reshape(b, max_pages * p, h_kv, d), h)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), ks.float()) * s
    dev = q.device
    ok = ragged_causal_mask((h * tq, max_pages * p), tq,
                            q_starts.to(dev).long()[:, None, None], 0,
                            ctx_lens.to(dev).long()[:, None, None],
                            device=dev).reshape(b, h, tq, max_pages * p)
    if active is not None:
        ok = ok & (active.to(dev) != 0)[:, None, None, None]
    logits = torch.where(ok, logits, torch.full_like(logits, NEG_INF))
    w = torch.softmax(logits, dim=-1)
    w = torch.where(ok.any(-1, keepdim=True), w, torch.zeros_like(w))
    return torch.einsum("bhqk,bkhd->bqhd", w, vs.float()).to(q.dtype)


TC_DIMS = (64, 128)      # head dims of the tensor-core build
TC_MAX_PAGE = 128        # its largest page (a multiple of 16)


def ragged_route(entry, dtype, d, p, tq):
    """The build a CUDA launch of the ragged kernel takes, by entry, dtype
    and shape alone: "tc" (`csrc/ragged_paged_attention_tc.cu`, tensor
    cores) for the chunked-prefill entry ("prefill") in bf16 at tq > 1, d
    64 or 128 and a page size a multiple of 16 up to 128; "page"
    (`csrc/ragged_paged_attention.cu`, per page on the CUDA cores)
    otherwise. The verify entry ("verify") and tq = 1 stay per page: their
    rows equal sequential decode steps (`paged_attention`) bit for bit,
    which an mma's sum order cannot give; f32 on the tensor cores would be
    TF32."""
    if entry not in ("prefill", "verify"):
        raise ValueError(f"ragged_route: unknown entry {entry!r}")
    if entry == "prefill" and dtype == torch.bfloat16 and tq > 1 \
            and d in TC_DIMS and p % 16 == 0 and 0 < p <= TC_MAX_PAGE:
        return "tc"
    return "page"


def _ragged(entry, q, k_pages, v_pages, page_table, ctx_lens, q_starts,
            active, scale):
    """The ragged kernel's dispatch, shared by its two entries (each counts
    its own launches): the plain version for a CPU tensor, the build
    `ragged_route` picks or a raise for a CUDA one. Returns (out, build),
    build None for the plain version."""
    b, tq, h, d = q.shape
    n_pages, p, h_kv, dd = k_pages.shape
    if dd != d or h % h_kv or tuple(v_pages.shape) != tuple(k_pages.shape) \
            or page_table.dim() != 2 or page_table.shape[0] != b \
            or tuple(ctx_lens.shape) != (b,) \
            or tuple(q_starts.shape) != (b,):
        raise ValueError(
            f"ragged_paged_attention shapes: q {tuple(q.shape)}, pages "
            f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}, table "
            f"{tuple(page_table.shape)}, ctx {tuple(ctx_lens.shape)}, "
            f"starts {tuple(q_starts.shape)}")
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return ragged_paged_attention_reference(
            q, k_pages, v_pages, page_table, ctx_lens, q_starts,
            active=active, scale=s), None
    if q.device.type != "cuda":
        raise ValueError(
            f"ragged_paged_attention: unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODE or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise ValueError(
            f"ragged_paged_attention kernel takes bf16/f32 q and pages of "
            f"the same dtype; got q {q.dtype}, pages "
            f"{k_pages.dtype}/{v_pages.dtype}")
    if d % 16 or d > MAX_D:
        raise ValueError(
            f"ragged_paged_attention kernel takes d a multiple of 16 up to "
            f"{MAX_D}; got d={d}")
    dev = q.device
    for t in (k_pages, v_pages):
        if t.device != dev:
            raise ValueError(
                "ragged_paged_attention: operands on different devices")
    build = ragged_route(entry, q.dtype, d, p, tq)
    q = q.contiguous()
    k_pages = k_pages.contiguous()
    v_pages = v_pages.contiguous()
    if build == "tc":
        q = _build.aligned16(q)
        if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
            raise ValueError("ragged_paged_attention: the KV pools must "
                             "start on 16 bytes")
    table = page_table.to(device=dev, dtype=torch.int32).contiguous()
    ctx = ctx_lens.to(device=dev, dtype=torch.int32).contiguous()
    starts = q_starts.to(device=dev, dtype=torch.int32).contiguous()
    act = None if active is None else \
        active.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    if b == 0:
        return out, build
    lib = _build.library()
    ptrs = [ctypes.c_void_p(t.data_ptr())
            for t in (q, k_pages, v_pages, table, ctx, starts)]
    ptrs += [ctypes.c_void_p(0 if act is None else act.data_ptr()),
             ctypes.c_void_p(out.data_ptr())]
    dims = (b, tq, h, h_kv, d, p, n_pages, table.shape[1], float(s))
    if build == "tc":
        code = lib.ptt_ragged_paged_attention_tc(
            *ptrs, *dims, dev.index, _build.stream_ptr(dev))
    else:
        code = lib.ptt_ragged_paged_attention(
            *ptrs, *dims, _DTYPE_CODE[q.dtype], dev.index,
            _build.stream_ptr(dev))
    _build.check(code, "ragged_paged_attention")
    return out, build


def ragged_paged_attention(q, k_pages, v_pages, page_table, ctx_lens,
                           q_starts, active=None, scale=None):
    """Ragged-chunk attention over a paged KV cache: slot b holds tq query
    tokens at global positions q_starts[b] + [0, tq) and attends its own
    pages causally, up to ctx_lens[b] (the tokens cached after this
    chunk's write). Returns [b, tq, h, d] in q's dtype; rows past a slot's
    real chunk end are garbage by contract, but finite.

      q          : [b, tq, h, d]
      k/v_pages  : [n_pages, p, h_kv, d]
      page_table : [b, max_pages] int32 (ids clamped to [0, n_pages))
      ctx_lens, q_starts : [b] int32
      active     : optional [b] mask; inactive slots emit zeros

    A CPU tensor takes the plain version. A CUDA tensor launches the build
    `ragged_route("prefill", ...)` picks, or raises; there is no fallback:
    `csrc/ragged_paged_attention_tc.cu` (bf16, tq > 1, d 64 or 128, page a
    multiple of 16 up to 128; counted in `.tc_launches` too) or
    `csrc/ragged_paged_attention.cu` (bf16 or f32, d a multiple of 16 up
    to 256)."""
    out, build = _ragged("prefill", q, k_pages, v_pages, page_table,
                         ctx_lens, q_starts, active, scale)
    if build is not None and q.shape[0]:
        ragged_paged_attention.launches += 1
        ragged_paged_attention.tc_launches += build == "tc"
    return out


ragged_paged_attention.launches = 0
ragged_paged_attention.tc_launches = 0


def spec_verify_attention(q, k_pages, v_pages, page_table, lens,
                          active=None, scale=None):
    """The speculative-decoding verify entry: slot b holds lens[b]
    committed tokens, and its T feed tokens (the pending token and up to
    T - 1 drafts, q [b, T, h, d]) sit at positions lens[b] + [0, T), their
    k/v already written into the slot's pages (write-gated: a rejected
    draft's row stays, and `lens` never advances over it). Row j attends
    causally up to its own position lens[b] + j: the ragged kernel at
    tq = T with ctx = lens + T and q_starts = lens. The mask is the one a
    decode step applies to one token, and the ragged kernel walks the
    decode kernel's per-page softmax step (a page whose keys a row may not
    see leaves that row's softmax state as it was), so on the card row j
    equals the j-th of T sequential `paged_attention` steps bit for bit.
    Returns [b, T, h, d].

    A CPU tensor takes the ragged kernel's plain version. A CUDA tensor
    launches `csrc/ragged_paged_attention.cu` (the per-page build, always:
    `ragged_route("verify", ...)`) or raises; launches count as
    `spec_verify_attention.launches` (not the ragged wrapper's)."""
    T = q.shape[1]
    lens = lens.to(torch.int32)
    out, build = _ragged("verify", q, k_pages, v_pages, page_table, lens + T,
                         lens, active, scale)
    if build is not None and q.shape[0]:
        spec_verify_attention.launches += 1
    return out


spec_verify_attention.launches = 0
