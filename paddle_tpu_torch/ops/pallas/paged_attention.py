"""Paged attention: one query token per slot over its KV pages (decode),
and tq tokens per slot at ragged offsets (`ragged_paged_attention`,
chunked prefill; `spec_verify_attention`, its speculative-verify entry).

Counterpart of `paddle_tpu/ops/pallas/paged_attention.py`. The Pallas
TPU kernels `_decode_kernel` and `_ragged_kernel` are replaced by
`csrc/paged_attention.cu` and two builds of the ragged kernel, chosen by
`ragged_route`: `csrc/ragged_paged_attention_tc.cu` (tensor cores, the
bf16 chunked prefill) and `csrc/ragged_paged_attention.cu` (per page, on
the CUDA cores: tq = 1, the verify entry, f32). The decode kernel and the
per-page ragged build each have a staged and a direct walk, chosen by
`paged_route` and sized by `paged_stage_plan`: the staged walk keeps a
ring of KV pages in shared memory, filled by asynchronous bulk copies
ahead of the page it works on; the direct walk reads each page from
device memory in turn. Both give the same bits. `paged_attention_dense`
runs the decode kernel on a dense [b, L, h, d] cache. The plain PyTorch
versions beside them serve CPU tensors and are the yardsticks the kernels
are held against on the card.

Decode layout (as in the reference):
  q          : [b, h, d]
  k/v_pages  : [n_pages, p, h_kv, d]   (GQA: q head i reads kv head
                                         i // (h // h_kv))
  page_table : [b, max_pages] int32
  seq_lens   : [b] int32   (keys at positions >= seq_lens[b] are masked)
  active     : optional [b] mask; inactive slots emit zeros
"""
import functools
import math

import torch

from ... import _build

NEG_INF = -1e30

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 256
MAX_REP_D = 2048   # rep * d the kernel's per-thread accumulators cover

# The staged walk's ring (`csrc/common.cuh` `ptt::PageRing`): a stage holds
# one page's K and V rows of one kv head, 2 * p * d * element bytes. A ring
# keeps RING_TARGET_BYTES in flight (so small pages get deeper rings),
# within RING_BUDGET_BYTES of shared memory (the rest of the block's shared
# memory, q and the logits, stays under the H100's 227 KB) and
# RING_MAX_STAGES stages.
RING_TARGET_BYTES = 96 * 1024
RING_BUDGET_BYTES = 144 * 1024
RING_MAX_STAGES = 16
_ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}


@functools.lru_cache(maxsize=None)
def paged_stage_plan(dtype, d, p):
    """(stages, bytes) of the staged walk's ring for pages of p tokens at
    head dim d: the fewest stages that hold RING_TARGET_BYTES, at least 2,
    at most what RING_BUDGET_BYTES and RING_MAX_STAGES allow; (0, 0) where
    two stages do not fit (the direct walk). bytes is the ring's K and V
    rows. A token row, d * element bytes, is one bulk copy and must be a
    multiple of 16 bytes."""
    if dtype not in _ELEM_BYTES:
        raise ValueError(f"paged_stage_plan: no kernel for {dtype}")
    row = d * _ELEM_BYTES[dtype]
    if d <= 0 or p <= 0 or row % 16:
        raise ValueError(f"paged_stage_plan: rows of d={d} {dtype} are not a "
                         f"multiple of 16 bytes (or p={p} is empty)")
    stage = 2 * p * row
    fit = min(RING_BUDGET_BYTES // stage, RING_MAX_STAGES)
    if fit < 2:
        return 0, 0
    stages = min(fit, max(2, -(-RING_TARGET_BYTES // stage)))
    return stages, stages * stage


def paged_route(dtype, d, p):
    """The walk a CUDA launch of the decode kernel or of the ragged kernel's
    per-page build takes, by dtype and shape alone: "staged" (pages staged
    in shared memory by bulk copies, `paged_stage_plan` stages ahead) where
    two stages fit the ring's budget, "direct" (each page read from device
    memory in turn) otherwise. Both walks run the same per-page step and
    give the same bits."""
    return "staged" if paged_stage_plan(dtype, d, p)[0] else "direct"


def _check_kernel_operands(name, q, k_pages, v_pages, max_rep_d=None):
    """What a CUDA launch of the decode kernel or the per-page ragged build
    takes, checked before any build or launch: bf16 or f32 q and pools of
    one dtype, d a multiple of 16 up to MAX_D (and rep * d <= max_rep_d),
    the pools on q's device and starting on 16 bytes (bulk copies and the
    tensor-core build move 16-byte pieces). Returns the pools contiguous."""
    d = q.shape[-1]
    if q.dtype not in _DTYPE_CODE or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise ValueError(
            f"{name} kernel takes bf16/f32 q and pages of the same dtype; "
            f"got q {q.dtype}, pages {k_pages.dtype}/{v_pages.dtype}")
    rep = q.shape[-2] // k_pages.shape[2]
    if d % 16 or d > MAX_D or (max_rep_d is not None and rep * d > max_rep_d):
        raise ValueError(
            f"{name} kernel takes d a multiple of 16 up to {MAX_D}"
            + (f" and rep*d <= {max_rep_d}" if max_rep_d else "")
            + f"; got d={d}, rep={rep}")
    for t in (k_pages, v_pages):
        if t.device != q.device:
            raise ValueError(f"{name}: operands on different devices")
    k_pages, v_pages = k_pages.contiguous(), v_pages.contiguous()
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError(f"{name}: the KV pools must start on 16 bytes")
    return k_pages, v_pages


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
    `csrc/paged_attention.cu` (bf16 or f32, d a multiple of 16 up to 256),
    on the walk `paged_route` names (counted in `.staged_launches` too when
    staged), or raises; there is no fallback."""
    b, h, d = q.shape
    n_pages, p, h_kv, dd = k_pages.shape
    if dd != d or h % h_kv or v_pages.shape != k_pages.shape \
            or page_table.dim() != 2 or page_table.shape[0] != b \
            or seq_lens.shape != (b,):
        raise ValueError(
            f"paged_attention shapes: q {tuple(q.shape)}, pages "
            f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}, table "
            f"{tuple(page_table.shape)}, lens {tuple(seq_lens.shape)}")
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, page_table,
                                         seq_lens, s, active)
    k_pages, v_pages = _check_kernel_operands("paged_attention", q, k_pages,
                                              v_pages, MAX_REP_D)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    stages = paged_stage_plan(q.dtype, d, p)[0]
    out = _paged_launch(q, k_pages, v_pages, page_table, seq_lens, s, active,
                        stages)
    if b:
        paged_attention.launches += 1
        paged_attention.staged_launches += stages > 0
    return out


def _paged_launch(q, k_pages, v_pages, page_table, seq_lens, s, active,
                  stages):
    """One launch of `csrc/paged_attention.cu` on checked operands: the
    staged walk with a ring of `stages` pages, or the direct walk at
    stages 0 (what `paged_route` picks; `chip_smoke.py` also launches the
    direct walk on staged shapes to hold the two walks' bits equal)."""
    b, h, d = q.shape
    n_pages, p, h_kv, _ = k_pages.shape
    dev = q.device
    q = q.contiguous()
    table = page_table.to(device=dev, dtype=torch.int32).contiguous()
    lens = seq_lens.to(device=dev, dtype=torch.int32).contiguous()
    act = None if active is None else \
        active.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    if b == 0:
        return out
    lib = _build.library()
    code = lib.ptt_paged_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), table.data_ptr(),
        lens.data_ptr(), None if act is None else act.data_ptr(), out.data_ptr(),
        b, h, h_kv, d, p, n_pages, table.shape[1], float(s),
        _DTYPE_CODE[q.dtype], stages, dev.index, _build.stream_ptr(dev))
    _build.check(code, "paged_attention")
    return out


paged_attention.launches = 0
paged_attention.staged_launches = 0


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
    `ragged_route` picks (and for the per-page build the walk `paged_route`
    picks) or a raise for a CUDA one. Returns (out, build), build "tc",
    "staged" or "direct", None for the plain version."""
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
    k_pages, v_pages = _check_kernel_operands("ragged_paged_attention", q,
                                              k_pages, v_pages)
    if q.device.type != "cuda":
        raise ValueError(
            f"ragged_paged_attention: unsupported device {q.device}")
    if ragged_route(entry, q.dtype, d, p, tq) == "tc":
        return _ragged_launch(q, k_pages, v_pages, page_table, ctx_lens,
                              q_starts, active, s, None), "tc"
    stages = paged_stage_plan(q.dtype, d, p)[0]
    return (_ragged_launch(q, k_pages, v_pages, page_table, ctx_lens, q_starts,
                           active, s, stages),
            "staged" if stages else "direct")


def _ragged_launch(q, k_pages, v_pages, page_table, ctx_lens, q_starts,
                   active, s, stages):
    """One launch of the ragged kernel on checked operands: the tensor-core
    build (`stages` None), or the per-page build's staged walk with a ring
    of `stages` pages, or its direct walk at stages 0 (`chip_smoke.py` also
    launches the direct walk on staged shapes to hold the two walks' bits
    equal)."""
    b, tq, h, d = q.shape
    n_pages, p, h_kv, _ = k_pages.shape
    dev = q.device
    q = q.contiguous()
    if stages is None:
        q = _build.aligned16(q)
    table = page_table.to(device=dev, dtype=torch.int32).contiguous()
    ctx = ctx_lens.to(device=dev, dtype=torch.int32).contiguous()
    starts = q_starts.to(device=dev, dtype=torch.int32).contiguous()
    act = None if active is None else \
        active.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    if b == 0:
        return out
    lib = _build.library()
    ptrs = [t.data_ptr() for t in (q, k_pages, v_pages, table, ctx, starts)]
    ptrs += [None if act is None else act.data_ptr(), out.data_ptr()]
    dims = (b, tq, h, h_kv, d, p, n_pages, table.shape[1], float(s))
    if stages is None:
        code = lib.ptt_ragged_paged_attention_tc(
            *ptrs, *dims, dev.index, _build.stream_ptr(dev))
    else:
        code = lib.ptt_ragged_paged_attention(
            *ptrs, *dims, _DTYPE_CODE[q.dtype], stages, dev.index,
            _build.stream_ptr(dev))
    _build.check(code, "ragged_paged_attention")
    return out


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
    to 256; on the walk `paged_route` names, counted in `.staged_launches`
    too when staged)."""
    out, build = _ragged("prefill", q, k_pages, v_pages, page_table,
                         ctx_lens, q_starts, active, scale)
    if build is not None and q.shape[0]:
        ragged_paged_attention.launches += 1
        ragged_paged_attention.tc_launches += build == "tc"
        ragged_paged_attention.staged_launches += build == "staged"
    return out


ragged_paged_attention.launches = 0
ragged_paged_attention.tc_launches = 0
ragged_paged_attention.staged_launches = 0


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
    `ragged_route("verify", ...)`, on the walk `paged_route` names) or
    raises; launches count as `spec_verify_attention.launches` (not the
    ragged wrapper's), and in `.staged_launches` too when staged."""
    T = q.shape[1]
    lens = lens.to(torch.int32)
    out, build = _ragged("verify", q, k_pages, v_pages, page_table, lens + T,
                         lens, active, scale)
    if build is not None and q.shape[0]:
        spec_verify_attention.launches += 1
        spec_verify_attention.staged_launches += build == "staged"
    return out


spec_verify_attention.launches = 0
spec_verify_attention.staged_launches = 0


def paged_attention_dense(q, k_cache, v_cache, seq_len, scale=None,
                          page_size=None):
    """Decode attention over a dense per-sequence cache in one launch (the
    reference's `paged_attention_dense`): the [b, L, h, d] caches are
    viewed as identity-tabled pages of `page_size` tokens (default 128,
    halved until it divides L) and run through `paged_attention`.

      q       : [b, h, d]
      caches  : [b, L, h, d]
      seq_len : scalar or [b] filled length (keys < seq_len attend)

    Returns [b, h, d]. Dispatch as `paged_attention`'s: a CPU tensor takes
    the plain version, a CUDA tensor the decode kernel or a raise."""
    b, L, h, d = k_cache.shape
    if tuple(v_cache.shape) != tuple(k_cache.shape):
        raise ValueError(f"paged_attention_dense: caches {tuple(k_cache.shape)}"
                         f" / {tuple(v_cache.shape)}")
    if page_size is None:
        page_size = 128
        while L % page_size:
            page_size //= 2
    p = page_size
    if p <= 0 or L % p:
        raise ValueError(f"paged_attention_dense: page_size {p} does not "
                         f"divide the cache length {L}")
    kp = k_cache.reshape(b * (L // p), p, h, d)
    vp = v_cache.reshape(b * (L // p), p, h, d)
    table = torch.arange(b * (L // p), dtype=torch.int32,
                         device=q.device).reshape(b, L // p)
    lens = torch.as_tensor(seq_len, dtype=torch.int32)
    lens = lens.to(q.device).expand(b).contiguous()
    return paged_attention(q, kp, vp, table, lens, scale=scale)
