"""Flash attention on [b, s, h, d]: forward, backward, and the
differentiable `FlashAttention` built from them.

Counterpart of `paddle_tpu/ops/pallas/flash_attention.py`. Its two Pallas
TPU kernels are replaced by hand-written CUDA, each in two builds: the
forward `_fwd_kernel` (via `_flash_fwd`), chosen by `flash_fwd_route`, by
`csrc/flash_attention_tc.cu` (bf16, wgmma with TMA-fed K/V tiles) and
`csrc/flash_attention.cu` (f32, CUDA cores); the fused backward
`_fused_bwd_kernel` (via `_flash_bwd`), chosen by `flash_bwd_route`, by
`csrc/flash_attention_bwd_tc.cu` (bf16, tensor cores, a dK/dV kernel and a
dQ kernel) and `csrc/flash_attention_bwd.cu` (f32, CUDA cores,
per-key-tile dQ partials).
The plain PyTorch versions beside them (`flash_attention_reference`, the
counterpart of `_xla_ref`, and `flash_attention_bwd_reference`) serve CPU
tensors and are the yardsticks the kernels are held against on the card.
`FlashAttention` is the counterpart of `make_flash_attention`'s custom
VJP (its plain, `.masked`, `.dropout` and `.masked_dropout` entries).

Causal or not (`causal`). Keys at positions >= s_true are masked (padding
inside a padded prompt). The forward returns o in the input dtype and
lse = logsumexp of each query row's scaled logits, [b, h, s] f32, the
residual the backward reads.

An additive `mask` (the reference's `.masked` entries) broadcasts to
[b, h, s, s]: each of its four dims is 1 or full, after `norm_mask` (a
bool mask becomes 0 / NEG_INF, and the rank is padded to 4). It is added
in f32 to the scaled logits before the s_true and causal tests, in the
reference's order: `logits * scale`, `+ mask`, `where(valid, ., NEG_INF)`.
A [b, 1, 1, s] key-padding mask applies to every query row (the reference
broadcasts the query and key axes first). No gradient flows to the mask
(the reference's cotangent is zero). In f32, -1e30 + logit is -1e30, so
a row a bool mask hides entirely is uniform over all s keys, with lse
about -1e30, in the plain versions and the kernels alike, and in the
reference wherever it pads nothing (its padding keys weigh in too).

Attention dropout (`dropout_p > 0` with an int32 `seed`) is the
reference's `.dropout` entry: the weights after the softmax denominator
are kept as p / (1 - dropout_p) or zeroed by the integer hash
`_dropout_keep` of (seed, batch * heads + head, global query row, global
key column), computed again in the backward instead of stored. lse stays
the logsumexp before dropout. `dropout_keep` is the plain version of the
hash (the kernels hash in `csrc/common.cuh`). A mask and dropout combine.
"""
import contextlib
import contextvars
import ctypes
import math

import torch

from ... import _build
from ...framework.random import _M32, mul32

NEG_INF = -1e30

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def dropout_threshold(dropout_p):
    """The keep threshold, as the reference computes it in Python:
    min(int(p * 2^32), 2^32 - 1)."""
    return min(int(float(dropout_p) * 4294967296.0), 4294967295)


def dropout_inv_keep(dropout_p):
    """1 / (1 - p) rounded to f32, the reference's
    `jnp.float32(1.0 / (1.0 - dropout_p))`."""
    return float(torch.tensor(1.0 / (1.0 - float(dropout_p)),
                              dtype=torch.float32))


def dropout_keep(seed, b, h, sq, sk, dropout_p, device=None):
    """Plain version of the kernels' keep mask: bool [b, h, sq, sk], True
    where the reference's `_dropout_keep` keeps the weight of (batch bi,
    head hh, query row, key column): the hash of (seed, bi * h + hh, row,
    column) in uint32 arithmetic, >= `dropout_threshold(dropout_p)`. The
    words are int64 tensors masked to 32 bits; the int32 seed is taken as
    its uint32 bits."""
    u = int(seed) & _M32
    sl = (torch.arange(b, dtype=torch.int64, device=device)[:, None] * h
          + torch.arange(h, dtype=torch.int64, device=device)[None, :])
    rows = torch.arange(sq, dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(sk, dtype=torch.int64, device=device)[None, :]
    hv = (((u * 2654435761) & _M32) + mul32(sl, 0x9E3779B9)) & _M32
    x = mul32(rows, 0x85EBCA6B) ^ mul32(cols, 0xC2B2AE35)   # [sq, sk]
    hv = hv[:, :, None, None] ^ x[None, None]
    hv = hv ^ (hv >> 15)
    hv = mul32(hv, 0x2C1B3C6D)
    hv = hv ^ (hv >> 12)
    hv = mul32(hv, 0x297A2D39)
    hv = hv ^ (hv >> 15)
    return hv >= dropout_threshold(dropout_p)


def _check_dropout(name, dropout_p, seed):
    p = float(dropout_p)
    if not 0.0 <= p < 1.0:
        raise ValueError(f"{name}: dropout_p must be in [0, 1); got {p}")
    if p > 0.0 and seed is None:
        raise ValueError(f"{name}: dropout_p > 0 needs an int32 seed")
    return p


def _check_qkv(name, q, k, v):
    if q.dim() != 4 or tuple(k.shape) != tuple(q.shape) \
            or tuple(v.shape) != tuple(q.shape):
        raise ValueError(
            f"{name} takes equal [b, s, h, d] q/k/v; got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}")


def norm_mask(m):
    """The reference's `_norm_mask`: a bool mask becomes additive f32, 0
    where True and NEG_INF where False; leading dims pad the rank to 4."""
    if m.dtype == torch.bool:
        m = torch.where(m, torch.zeros((), dtype=torch.float32, device=m.device),
                        torch.full((), NEG_INF, dtype=torch.float32,
                                   device=m.device))
    while m.dim() < 4:
        m = m[None]
    return m


def _check_mask(name, mask, b, h, s):
    """`norm_mask(mask)`, checked to broadcast to [b, h, s, s]: every dim
    1 or full (the reference's `_prep` broadcasts the query and key axes,
    then the batch and head axes)."""
    if mask is None:
        return None
    if mask.dim() > 4:
        raise ValueError(f"{name}: mask of rank {mask.dim()}; at most 4")
    m = norm_mask(mask)
    if not m.is_floating_point():
        raise ValueError(f"{name}: mask must be bool or floating; got "
                         f"{m.dtype}")
    if any(n not in (1, full) for n, full in zip(m.shape, (b, h, s, s))):
        raise ValueError(f"{name}: mask {tuple(mask.shape)} does not "
                         f"broadcast to [b, h, s, s] = {(b, h, s, s)}")
    return m


def flash_attention_reference(q, k, v, causal=True, scale=None, s_true=None,
                              dropout_p=0.0, seed=None, mask=None):
    """Plain version: dense scores in f32, scaled, plus the additive mask,
    masked by s_true and (when causal) by position, softmax (with
    dropout: each weight kept as p / (1 - dropout_p) or zeroed by
    `dropout_keep`), then P @ V. Returns (o, lse), lse before dropout."""
    dropout_p = _check_dropout("flash_attention_reference", dropout_p, seed)
    b, s, h, d = q.shape
    sk = k.shape[1]
    s_true = sk if s_true is None else int(s_true)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    mask = _check_mask("flash_attention_reference", mask, b, h, s)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = logits + mask.float()
    cols = torch.arange(sk, device=q.device)[None, :]
    valid = cols < s_true
    if causal:
        rows = torch.arange(s, device=q.device)[:, None]
        valid = valid & (rows >= cols)
    logits = torch.where(valid, logits, torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    if dropout_p > 0.0:
        keep = dropout_keep(seed, b, h, s, sk, dropout_p, q.device)
        p = torch.where(keep, p * dropout_inv_keep(dropout_p),
                        torch.zeros((), device=q.device))
        del keep
    o = torch.einsum("bhqk,bkhd->bqhd", p / l, v.float()).to(q.dtype)
    lse = (m + torch.log(l))[..., 0]
    return o, lse


def _check_kernel_inputs(name, q, k, v, d, others=()):
    if q.dtype not in _DTYPE_CODE or any(t.dtype != q.dtype
                                         for t in (k, v) + tuple(others)):
        raise ValueError(
            f"{name} kernel takes bf16/f32 operands of one dtype; got "
            f"{[str(t.dtype) for t in (q, k, v) + tuple(others)]}")
    if d not in (64, 128):
        raise ValueError(f"{name} kernel takes d 64 or 128; got {d}")


def _mask_args(mask, b, h, s, dev):
    """(pointer, four element strides) of the f32 mask as the kernels read
    it, `mask.float().expand(b, h, s, s)` (a broadcast dim has stride 0,
    so a [b, 1, 1, s] mask is never built at [b, h, s, s]), and the f32
    tensor itself, which the caller keeps alive over the launch."""
    if mask is None:
        return (ctypes.c_void_p(0), 0, 0, 0, 0), None
    if mask.device != dev:
        raise ValueError("flash attention: mask on another device than q")
    m = mask.float().expand(b, h, s, s)
    return (ctypes.c_void_p(m.data_ptr()), *m.stride()), m


def flash_attention_fwd(q, k, v, causal=True, scale=None, s_true=None,
                        dropout_p=0.0, seed=None, mask=None):
    """Flash-attention forward. q, k, v: [b, s, h, d] with k/v already at
    q's head count. Returns (o [b, s, h, d], lse [b, h, s]).
    `dropout_p > 0` drops attention weights by the hash of int32 `seed`;
    `mask` is additive (or bool), broadcast to [b, h, s, s].

    A CPU tensor takes the plain version. A CUDA tensor launches the
    build `flash_fwd_route` picks (causal or not, with or without a mask,
    d 64 or 128) or raises; there is no fallback: bf16
    `csrc/flash_attention_tc.cu`, f32 `csrc/flash_attention.cu`. A call
    counts once in `flash_attention_fwd.launches` (and in `.tc_launches`
    on the bf16 build), in `.dropout_launches` with dropout, in
    `.mask_launches` with a mask and in `.noncausal_launches` when not
    causal."""
    _check_qkv("flash_attention_fwd", q, k, v)
    dropout_p = _check_dropout("flash_attention_fwd", dropout_p, seed)
    b, s, h, d = q.shape
    s_true = s if s_true is None else int(s_true)
    if not 0 <= s_true <= s:
        raise ValueError(f"s_true={s_true} outside [0, {s}]")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    mask = _check_mask("flash_attention_fwd", mask, b, h, s)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, scale, s_true,
                                         dropout_p, seed, mask)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: unsupported device {q.device}")
    _check_kernel_inputs("flash_attention_fwd", q, k, v, d)
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError("flash_attention_fwd: operands on different devices")
    build = flash_fwd_route(q.dtype, b, s, h, d)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if build == "tc":
        q, k, v = (_build.aligned16(t) for t in (q, k, v))
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=dev)
    if b * h * s == 0:
        return o, lse
    margs, _keep = _mask_args(mask, b, h, s, dev)
    lib = _build.library()
    ptrs = (ctypes.c_void_p(t.data_ptr()) for t in (q, k, v, o, lse))
    tail = (b, s, h, d, s_true, int(bool(causal)), float(scale))
    if build == "tc":
        code = lib.ptt_flash_attention_fwd_tc(
            *ptrs, *margs, *tail, *_dropout_args(dropout_p, seed), dev.index,
            _build.stream_ptr(dev))
    else:
        code = lib.ptt_flash_attention_fwd(
            *ptrs, *margs, *tail, _DTYPE_CODE[q.dtype],
            *_dropout_args(dropout_p, seed), dev.index, _build.stream_ptr(dev))
    _build.check(code, "flash_attention_fwd")
    _count(flash_attention_fwd, causal, mask, dropout_p)
    flash_attention_fwd.tc_launches += build == "tc"
    return o, lse


def flash_fwd_route(dtype, b, s, h, d):
    """The build of a CUDA forward launch, by dtype and shape alone: bf16
    takes "tc" (`csrc/flash_attention_tc.cu`: wgmma for both products, K
    and V streamed by TMA into a ring of shared-memory stages); f32 takes
    "f32" (`csrc/flash_attention.cu` on the CUDA cores: the tensor cores
    would run it as TF32, outside the f32 parity gates)."""
    return "tc" if dtype == torch.bfloat16 else "f32"


def _count(fn, causal, mask, dropout_p):
    fn.launches += 1
    fn.dropout_launches += dropout_p > 0.0
    fn.mask_launches += mask is not None
    fn.noncausal_launches += not causal


def _reset(fn):
    fn.launches = fn.dropout_launches = 0
    fn.mask_launches = fn.noncausal_launches = 0


_reset(flash_attention_fwd)
flash_attention_fwd.tc_launches = 0


def _dropout_args(dropout_p, seed):
    """(on, seed as uint32, threshold, 1 / (1 - p) in f32) of a launch."""
    if dropout_p <= 0.0:
        return 0, 0, 0, 1.0
    return (1, int(seed) & _M32, dropout_threshold(dropout_p),
            dropout_inv_keep(dropout_p))


def flash_attention_bwd_reference(q, k, v, o, lse, do, causal=True,
                                  scale=None, s_true=None, dropout_p=0.0,
                                  seed=None, mask=None):
    """Plain version of the backward: dense f32 P = exp(logits - lse),
    the logits scaled, plus the mask, and NEG_INF where masked (the
    reference's `_block_p`), then dV = P^T dO, dS = P (dO V^T -
    rowsum(dO o)) * scale, dQ = dS K, dK = dS^T Q. With dropout, dV reads
    the dropped weights and dO V^T is dropped the same way
    (`dropout_keep`); dS takes the undropped P. Returns (dq, dk, dv) in
    the inputs' dtypes; the mask gets no gradient."""
    dropout_p = _check_dropout("flash_attention_bwd_reference", dropout_p,
                               seed)
    b, s, h, d = q.shape
    s_true = s if s_true is None else int(s_true)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    mask = _check_mask("flash_attention_bwd_reference", mask, b, h, s)
    q32, k32, v32, do32 = q.float(), k.float(), v.float(), do.float()
    logits = torch.einsum("bqhd,bkhd->bhqk", q32, k32) * scale
    if mask is not None:
        logits = logits + mask.float()
    cols = torch.arange(s, device=q.device)[None, :]
    valid = cols < s_true
    if causal:
        valid = valid & (torch.arange(s, device=q.device)[:, None] >= cols)
    p = torch.exp(torch.where(valid, logits,
                              torch.full((), NEG_INF, device=q.device))
                  - lse[..., None])
    del logits
    delta = (do32 * o.float()).sum(-1).transpose(1, 2)            # [b, h, s]
    dp = torch.einsum("bqhd,bkhd->bhqk", do32, v32)
    if dropout_p > 0.0:
        keep = dropout_keep(seed, b, h, s, s, dropout_p, q.device)
        inv = dropout_inv_keep(dropout_p)
        zero = torch.zeros((), device=q.device)
        dv = torch.einsum("bhqk,bqhd->bkhd", torch.where(keep, p * inv, zero),
                          do32)
        dp = torch.where(keep, dp * inv, zero)
        del keep
    else:
        dv = torch.einsum("bhqk,bqhd->bkhd", p, do32)
    ds = p * (dp - delta[..., None]) * scale
    del p, dp
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k32)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q32)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


BWD_TILE = 64   # key tile of csrc/flash_attention_bwd.cu: one dQ partial each


def flash_bwd_route(dtype, b, s, h, d):
    """(build, dQ partial shape) of a CUDA backward launch, by dtype and
    shape alone. bf16 takes "tc" (`csrc/flash_attention_bwd_tc.cu`: a
    dK/dV kernel and a dQ kernel on the tensor cores, each gradient
    written once, no partial buffer: shape None). f32 takes "f32"
    (`csrc/flash_attention_bwd.cu` on the CUDA cores: the tensor cores
    would run it as TF32), whose per-key-tile dQ partials, [ceil(s / 64),
    b, s, h, d] f32, the wrapper sums."""
    if dtype == torch.bfloat16:
        return "tc", None
    return "f32", (-(-s // BWD_TILE), b, s, h, d)


def flash_attention_bwd(q, k, v, o, lse, do, causal=True, scale=None,
                        s_true=None, mask=None, dropout_p=0.0, seed=None):
    """Gradients (dq, dk, dv) of the flash attention, from the forward's o
    and lse and the output cotangent do; all [b, s, h, d] except lse
    [b, h, s] f32. `causal`, `mask`, `dropout_p` and `seed` are the
    forward's; the mask gets no gradient.

    A CPU tensor takes the plain version. A CUDA tensor launches the
    build `flash_bwd_route` picks (causal or not, with or without a mask,
    d 64 or 128) or raises; there is no fallback: bf16 the two
    tensor-core kernels of `csrc/flash_attention_bwd_tc.cu`, f32
    `csrc/flash_attention_bwd.cu`, whose per-key-tile dQ partials are
    summed here. delta = rowsum(dO * o) and that sum are torch ops around
    the launch, as they are jnp around the `pallas_call` in the
    reference's `_flash_bwd`. A call counts once in `.launches` (and in
    `.tc_launches` on the bf16 build), and in `.dropout_launches`,
    `.mask_launches` and `.noncausal_launches` as the forward's does."""
    _check_qkv("flash_attention_bwd", q, k, v)
    dropout_p = _check_dropout("flash_attention_bwd", dropout_p, seed)
    if tuple(o.shape) != tuple(q.shape) or tuple(do.shape) != tuple(q.shape):
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} and do "
                         f"{tuple(do.shape)} must match q {tuple(q.shape)}")
    b, s, h, d = q.shape
    if tuple(lse.shape) != (b, h, s):
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} is "
                         f"not [b, h, s] = {(b, h, s)}")
    s_true = s if s_true is None else int(s_true)
    if not 0 <= s_true <= s:
        raise ValueError(f"s_true={s_true} outside [0, {s}]")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    mask = _check_mask("flash_attention_bwd", mask, b, h, s)
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, o, lse, do, causal,
                                             scale, s_true, dropout_p, seed,
                                             mask)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device {q.device}")
    _check_kernel_inputs("flash_attention_bwd", q, k, v, d, (o, do))
    dev = q.device
    if any(t.device != dev for t in (k, v, o, lse, do)):
        raise ValueError("flash_attention_bwd: operands on different devices")
    build, part_shape = flash_bwd_route(q.dtype, b, s, h, d)
    q, k, v, do = (t.contiguous() for t in (q, k, v, do))
    if build == "tc":
        q, k, v, do = (_build.aligned16(t) for t in (q, k, v, do))
    lse = lse.float().contiguous()
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if b * h * s == 0:
        return torch.zeros_like(q), dk, dv
    margs, _keep = _mask_args(mask, b, h, s, dev)
    lib = _build.library()
    tail = (b, s, h, d, s_true, int(bool(causal)), float(scale))
    if build == "tc":
        dq = torch.empty_like(q)
        code = lib.ptt_flash_attention_bwd_tc(
            *(ctypes.c_void_p(t.data_ptr())
              for t in (q, k, v, do, lse, delta, dq, dk, dv)), *margs, *tail,
            *_dropout_args(dropout_p, seed), dev.index, _build.stream_ptr(dev))
    else:
        dq_part = torch.empty(part_shape, dtype=torch.float32, device=dev)
        code = lib.ptt_flash_attention_bwd(
            *(ctypes.c_void_p(t.data_ptr())
              for t in (q, k, v, do, lse, delta, dq_part, dk, dv)), *margs,
            *tail, _DTYPE_CODE[q.dtype], *_dropout_args(dropout_p, seed),
            dev.index, _build.stream_ptr(dev))
    _build.check(code, "flash_attention_bwd")
    _count(flash_attention_bwd, causal, mask, dropout_p)
    flash_attention_bwd.tc_launches += build == "tc"
    if build == "tc":
        return dq, dk, dv
    dq = (dq_part[0] if part_shape[0] == 1 else dq_part.sum(0)).to(q.dtype)
    return dq, dk, dv


_reset(flash_attention_bwd)
flash_attention_bwd.tc_launches = 0


class AttnResidualStash:
    """The forward residuals (o, lse) of every `FlashAttention` call in one
    checkpointed region, kept from its first run for its recompute.

    This is the port's `checkpoint_name(..., "sdpa_res")` under
    `save_only_these_names("sdpa_res")` (the reference's
    `recompute_policy="save_attn"`): the first run of the region records
    each call's (o, lse); every later run of it (the recompute during
    backward) replays them in order instead of launching the forward
    kernel again. Use `with stash.region():` around each run."""

    def __init__(self):
        self._saved = []
        self._runs = 0
        self._replay = None

    @contextlib.contextmanager
    def region(self):
        self._replay = iter(list(self._saved)) if self._runs else None
        token = _STASH.set(self)
        try:
            yield self
        finally:
            _STASH.reset(token)
            self._runs += 1

    def residuals(self, compute):
        """(o, lse): replayed on a recompute, else `compute()` recorded."""
        if self._replay is not None:
            try:
                return next(self._replay)
            except StopIteration:
                raise RuntimeError(
                    "AttnResidualStash: the recompute ran more attention "
                    "calls than the first run recorded") from None
        o, lse = compute()
        self._saved.append((o.detach(), lse.detach()))
        return o, lse


_STASH = contextvars.ContextVar("paddle_tpu_torch_attn_stash", default=None)


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention (the counterpart of
    `make_flash_attention`'s custom VJP: its plain entry, `.masked` with a
    mask, `.dropout` when `dropout_p > 0`, `.masked_dropout` with both):
    forward `flash_attention_fwd`, backward `flash_attention_bwd` with the
    same mask and dropout seed, saving q, k, v, o and lse. The mask gets
    no gradient. Inside an `AttnResidualStash.region()` the forward's
    (o, lse) go through the stash, so a recompute does not launch the
    forward kernel again.

    `FlashAttention.apply(q, k, v, causal, scale, s_true, dropout_p,
    seed, mask)`; returns o."""

    @staticmethod
    def forward(ctx, q, k, v, causal=True, scale=None, s_true=None,
                dropout_p=0.0, seed=None, mask=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
        if mask is not None:
            mask = mask.detach()

        def compute():
            return flash_attention_fwd(q, k, v, causal, scale, s_true,
                                       dropout_p, seed, mask)

        stash = _STASH.get()
        o, lse = stash.residuals(compute) if stash is not None else compute()
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale, ctx.s_true = causal, scale, s_true
        ctx.dropout_p, ctx.seed, ctx.mask = dropout_p, seed, mask
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.causal,
                                         ctx.scale, ctx.s_true, ctx.mask,
                                         ctx.dropout_p, ctx.seed)
        return dq, dk, dv, None, None, None, None, None, None
