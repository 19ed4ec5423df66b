"""Whole-step decode megakernel: the decoder layers of one decode step (and,
in whole-step mode, the final norm, the lm_head and the greedy argmax) in
one kernel launch.

Counterpart of `paddle_tpu/ops/pallas/decode_megakernel.py`. The Pallas TPU
kernel `_mk_kernel` (seg "full", tq = 1, the greedy head) is replaced by
`csrc/decode_megakernel.cu`, a persistent cooperative CUDA kernel; the plain
PyTorch version `decode_megakernel_reference` beside it serves CPU tensors
and is the yardstick the kernel is held against on the card.

Nothing is repacked. The reference copies every weight into a zero-padded
tile grid (`pack_decode_layer` / `pack_lm_head`) because its BlockSpecs walk
fixed-size tiles, and its multi-layer mode stacks all layers' weights into
one [L, ...] array (`stack_packed`) because one pallas_call indexes one
array per operand. Both are artefacts of the BlockSpec: the CUDA kernel
masks ragged edges itself (k = 11008, V = 32000) and reads each weight where
the engine already holds it, through a pointer table (`MegakernelPack`): an
int64 tensor with one row per layer (the addresses of its two norms, its
seven projections and their scales, and its K/V pools) and one row for the
final norm and the lm_head. At 7B in bf16 the stacked copy would cost 13 GB;
the table costs 33 rows of 18 addresses.

Semantics (both versions): h [R, H] (R <= 8 slot rows, the current tokens'
embeddings) is updated in place; every layer writes the rope'd k row and
the v row of each active slot into its pool at the slot's flat row
table[r, lens // p] * p + lens % p before attending (inactive slots write
the pool's scratch row and attend nothing); attention covers lens + 1
positions. With head=True the call also returns the greedy token (argmax
over the logits cast to the compute dtype, the first maximum winning), its
logit as f32, and the [R, V] logits.

Not ported yet (ROADMAP B6): the tq > 1 speculative-verify schedule (with
speculation, A5(d)), the head_k > 1 sampled top-K fold (with
inference/sampling.py, A5(c)) and the tensor-parallel segments qkv / tail /
down (with inference/tp.py, A7.10).
"""
import ctypes
import math

import torch

from ... import _build
from .paged_attention import MAX_D, MAX_REP_D, paged_attention_reference
from .quantized_matmul import quantized_matmul_reference
from .rms_norm import rms_rows

MAX_ROWS = 8            # slot rows per launch (the kernel's register sums)
MAX_SMEM = 232448       # dynamic shared memory one H100 block may use
_AUX_SMEM = 10592       # the kernel's shared memory besides the [R, H] rows
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LAYER_KEYS = ("ln1", "ln2", "wq", "wk", "wv", "wo", "wg", "wu", "wd")
PTRS = 18               # addresses per row of the pointer table
P_KP, P_VP = 16, 17     # the K/V pool columns of a layer row


def megakernel_supported(nh, nh_kv, hd, hidden, ffn):
    """Geometry the CUDA kernel takes: GQA groups (nh a multiple of nh_kv),
    d a multiple of 16 up to 256 with rep * d <= 2048 (the paged-attention
    kernel's limits, whose per-page step it runs), nh * d == hidden, and
    8 bf16 rows of the hidden width in one block's shared memory."""
    if nh_kv <= 0 or nh % nh_kv or ffn <= 0:
        return False
    return (hd % 16 == 0 and hd <= MAX_D and (nh // nh_kv) * hd <= MAX_REP_D
            and nh * hd == hidden
            and MAX_ROWS * hidden * 2 + _AUX_SMEM <= MAX_SMEM)


def megakernel_weight_bytes(pack):
    """Weight bytes one decode step streams through the kernel: every
    projection's values and scales and both norms per layer, plus the final
    norm and the lm_head when the pack has them (whole-step mode)."""
    def size(w):
        ts = w if isinstance(w, tuple) else (w,)
        return sum(t.numel() * t.element_size() for t in ts)

    total = sum(size(ws[k]) for ws in pack.layers for k in _LAYER_KEYS)
    if pack.head is not None:
        total += size(pack.norm) + size(pack.head)
    return total


class MegakernelPack:
    """One engine's weights and KV pools as the megakernel reads them.

    layers: the engine's per-layer weight dicts (ln1, ln2, wq ... wd; a
    projection is a [k, n] tensor or an (int8 [k, n], f32 scales [n]) pair);
    k_flat / v_flat: per layer the flat [n_pages * page_size + 1, nh_kv, hd]
    pool buffers, whose last row is the scratch row masked writes land on;
    cos / sin: the rope tables [max_len, hd // 2] (f32); norm / head: the
    final norm and the lm_head, for whole-step mode (None otherwise).

    `ptrs` is the pointer table, [L + 1, 18] int64 on the pools' device
    (the layout `csrc/decode_megakernel.cu` reads). It holds addresses, so
    the engine builds a new pack whenever it reallocates its pools. On CUDA
    the constructor checks what the kernel assumes: contiguous tensors on
    one device, norms and dense weights in the pools' dtype, every
    projection either dense or int8. Per-bucket scratch (qkv, attn, act and
    the per-block argmax partials) is allocated once per row count."""

    def __init__(self, layers, k_flat, v_flat, cos, sin, *, nh, nh_kv, hd,
                 eps, page_size, norm=None, head=None):
        self.layers = list(layers)
        self.k_flat, self.v_flat = list(k_flat), list(v_flat)
        self.cos, self.sin = cos, sin
        self.norm, self.head = norm, head
        self.nh, self.nh_kv, self.hd = int(nh), int(nh_kv), int(hd)
        self.eps = float(eps)
        self.page_size = int(page_size)
        self.n_layers = len(self.layers)
        self.device = self.k_flat[0].device
        self.dtype = self.k_flat[0].dtype
        self.oob = self.k_flat[0].shape[0] - 1
        self.n_pages = self.oob // self.page_size
        self.max_len = cos.shape[0]
        self.H = self.layers[0]["ln1"].shape[0]
        wg = self.layers[0]["wg"]
        self.F = (wg[0] if isinstance(wg, tuple) else wg).shape[1]
        self.V = 0 if head is None else \
            (head[0] if isinstance(head, tuple) else head).shape[1]
        self.quant = isinstance(self.layers[0]["wq"], tuple)
        self.ptrs = self._pointer_table()
        self._scratch = {}

    def pages(self, li):
        """Layer li's K and V pools as [n_pages, p, nh_kv, hd] views."""
        shape = (self.n_pages, self.page_size, self.nh_kv, self.hd)
        return (self.k_flat[li][:self.oob].view(shape),
                self.v_flat[li][:self.oob].view(shape))

    def _pointer_table(self):
        strict = self.device.type == "cuda"

        def addr(t, dtype=None):
            if strict:
                if t.device != self.device or not t.is_contiguous():
                    raise ValueError(
                        "decode_megakernel: every weight and pool must be a "
                        f"contiguous tensor on {self.device}")
                if dtype is not None and t.dtype != dtype:
                    raise ValueError(
                        f"decode_megakernel: a {t.dtype} tensor where the "
                        f"kernel reads {dtype} (norms and dense weights in "
                        "the compute dtype: build the engine with "
                        "weight_dtype equal to it)")
            return t.data_ptr()

        def proj(w):
            if isinstance(w, tuple) != self.quant:
                raise ValueError("decode_megakernel: every projection must be "
                                 "dense, or every one int8")
            if isinstance(w, tuple):
                return [addr(w[0], torch.int8), addr(w[1], torch.float32)]
            return [addr(w, self.dtype), 0]

        rows = []
        for li, ws in enumerate(self.layers):
            row = [addr(ws["ln1"], self.dtype), addr(ws["ln2"], self.dtype)]
            for key in ("wq", "wk", "wv", "wo", "wg", "wu", "wd"):
                row += proj(ws[key])
            row += [addr(self.k_flat[li], self.dtype),
                    addr(self.v_flat[li], self.dtype)]
            rows.append(row)
        if self.head is not None:
            rows.append([addr(self.norm, self.dtype)] + proj(self.head)
                        + [0] * (PTRS - 3))
        else:
            rows.append([0] * PTRS)
        if strict:
            for t in (self.cos, self.sin):
                addr(t, torch.float32)
        return torch.tensor(rows, dtype=torch.int64, device=self.device)

    def scratch(self, R):
        """Per-row-count scratch, allocated once: qkv, attn, act, and the
        argmax partials of up to 8 blocks per SM."""
        s = self._scratch.get(R)
        if s is None:
            nq, nk = self.nh * self.hd, self.nh_kv * self.hd
            dev, dt = self.device, self.dtype
            g = self.max_grid
            s = dict(qkv=torch.empty((R, nq + 2 * nk), dtype=dt, device=dev),
                     attn=torch.empty((R, nq), dtype=dt, device=dev),
                     act=torch.empty((R, self.F), dtype=dt, device=dev),
                     part_v=torch.empty((g, R), dtype=torch.float32,
                                        device=dev),
                     part_i=torch.empty((g, R), dtype=torch.int32, device=dev))
            self._scratch[R] = s
        return s

    @property
    def max_grid(self):
        """Blocks a launch may use: 8 per SM (2048 threads / 256)."""
        return 8 * torch.cuda.get_device_properties(
            self.device).multi_processor_count


class _MkArgs(ctypes.Structure):
    """PttMkArgs of csrc/decode_megakernel.cu, field for field."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "ptrs", "h", "qkv", "attn", "act", "table", "lens", "active", "cos",
        "sin", "logits", "tok", "maxv", "part_v", "part_i")] + \
        [(n, ctypes.c_int) for n in (
            "layer0", "n_layers", "head_row", "R", "H", "nh", "nh_kv", "hd",
            "F", "V", "p", "n_pages", "max_pages", "oob", "max_len",
            "max_grid")] + \
        [("eps", ctypes.c_float), ("scale", ctypes.c_float)]


def _proj(x, w):
    """x [R, k] @ w: dense, or int8 with the 512-row k tiles of
    quantized_matmul_reference (the engine's `_mm` on the CPU)."""
    if isinstance(w, tuple):
        return quantized_matmul_reference(x, w[0], w[1], out_dtype=x.dtype)
    return x @ w.to(x.dtype)


def decode_megakernel_reference(h, pack, tables, lens, active, layer=None,
                                head=False):
    """Plain version: the engine's op chain (inference/serving.py
    `_layer_qkv` / `_layer_tail`, scheduler.py `_decode_math`) with the
    same cast points: norms in serving order, projections emitted in h's
    dtype, the half-split rope with each product rounded, the pool write,
    `paged_attention_reference`, SiLU in f32 then cast, argmax over the
    cast logits. Updates h and the pools in place."""
    R = h.shape[0]
    p = pack.page_size
    nh, nh_kv, hd = pack.nh, pack.nh_kv, pack.hd
    live = active.bool()
    pos = lens.long().clamp(0, pack.max_len - 1)
    rows = torch.arange(R, device=h.device)
    slots = tables.long()[rows, pos // p] * p + pos % p
    slots = torch.where(live, slots, pack.oob)
    ctx = torch.where(live, lens.long() + 1, 0)
    act = active.to(torch.int32)
    c = pack.cos[pos][:, None, :].to(h.dtype)
    s = pack.sin[pos][:, None, :].to(h.dtype)
    d2 = hd // 2

    def rope(x):
        x1, x2 = x[..., :d2], x[..., d2:]
        return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)

    x_h = h
    for li in (range(pack.n_layers) if layer is None else (layer,)):
        ws = pack.layers[li]
        x = rms_rows(x_h, ws["ln1"], pack.eps)
        q = rope(_proj(x, ws["wq"]).reshape(R, nh, hd))
        k = rope(_proj(x, ws["wk"]).reshape(R, nh_kv, hd))
        v = _proj(x, ws["wv"]).reshape(R, nh_kv, hd)
        pack.k_flat[li].index_copy_(0, slots, k.to(pack.dtype))
        pack.v_flat[li].index_copy_(0, slots, v.to(pack.dtype))
        kp, vp = pack.pages(li)
        attn = paged_attention_reference(q, kp, vp, tables, ctx, active=act)
        x_h = x_h + _proj(attn.reshape(R, -1), ws["wo"])
        x = rms_rows(x_h, ws["ln2"], pack.eps)
        g = _proj(x, ws["wg"])
        u = _proj(x, ws["wu"])
        a = torch.nn.functional.silu(g.float()).to(g.dtype) * u
        x_h = x_h + _proj(a, ws["wd"])
    h.copy_(x_h)
    if not head:
        return h
    logits = _proj(rms_rows(h, pack.norm, pack.eps), pack.head)
    tok = logits.argmax(-1).to(torch.int32)
    return h, tok, logits.max(-1).values.float(), logits


def decode_megakernel(h, pack, tables, lens, active, layer=None, head=False):
    """One decode step's layers through the megakernel. h [R, H] in the
    pack's dtype (updated in place); tables [R, max_pages], lens [R]
    (tokens cached before this step), active [R]. layer=None runs every
    layer in one launch, layer=i only layer i. head=True (whole-step mode,
    every layer) adds the final norm, the lm_head and the greedy argmax and
    returns (h, tok [R] int32, maxv [R] f32, logits [R, V]); else h.

    A CPU tensor takes the plain version. A CUDA tensor launches
    `csrc/decode_megakernel.cu` (cooperatively, one block per SM times the
    occupancy) or raises; there is no fallback."""
    R = h.shape[0] if h.dim() == 2 else -1
    if h.dim() != 2 or h.shape[1] != pack.H or tuple(lens.shape) != (R,) \
            or tuple(active.shape) != (R,) or tables.dim() != 2 \
            or tables.shape[0] != R:
        raise ValueError(
            f"decode_megakernel shapes: h {tuple(h.shape)} (hidden "
            f"{pack.H}), tables {tuple(tables.shape)}, lens "
            f"{tuple(lens.shape)}, active {tuple(active.shape)}")
    if head and (pack.head is None or layer is not None):
        raise ValueError("decode_megakernel: head=True needs a pack built "
                         "with the lm_head, and every layer (layer=None)")
    if layer is not None and not 0 <= layer < pack.n_layers:
        raise ValueError(f"decode_megakernel: no layer {layer}")
    if h.device.type == "cpu":
        return decode_megakernel_reference(h, pack, tables, lens, active,
                                           layer, head)
    if h.device.type != "cuda":
        raise ValueError(f"decode_megakernel: unsupported device {h.device}")
    if h.device != pack.device or h.dtype != pack.dtype \
            or h.dtype not in _DTYPE_CODE or not h.is_contiguous():
        raise ValueError(
            f"decode_megakernel kernel takes a contiguous h of the pack's "
            f"dtype and device ({pack.dtype}, {pack.device}); got "
            f"{h.dtype}, {h.device}")
    if not 1 <= R <= MAX_ROWS:
        raise ValueError(f"decode_megakernel kernel takes 1 to {MAX_ROWS} "
                         f"rows; got {R}")
    if not megakernel_supported(pack.nh, pack.nh_kv, pack.hd, pack.H, pack.F):
        raise ValueError(
            f"decode_megakernel kernel does not take this geometry (nh "
            f"{pack.nh}, nh_kv {pack.nh_kv}, hd {pack.hd}, hidden {pack.H}, "
            f"ffn {pack.F}); see megakernel_supported")
    dev = h.device
    i32 = torch.int32
    table = tables.to(device=dev, dtype=i32).contiguous()
    lens_i = lens.to(device=dev, dtype=i32).contiguous()
    act_i = active.to(device=dev, dtype=i32).contiguous()
    scr = pack.scratch(R)
    out = {}
    if head:
        out = dict(logits=torch.empty((R, pack.V), dtype=h.dtype, device=dev),
                   tok=torch.empty((R,), dtype=i32, device=dev),
                   maxv=torch.empty((R,), dtype=torch.float32, device=dev))
    args = _MkArgs(
        ptrs=pack.ptrs.data_ptr(), h=h.data_ptr(), table=table.data_ptr(),
        lens=lens_i.data_ptr(), active=act_i.data_ptr(),
        cos=pack.cos.data_ptr(), sin=pack.sin.data_ptr(),
        **{k: t.data_ptr() for k, t in scr.items()},
        **{k: t.data_ptr() for k, t in out.items()},
        layer0=0 if layer is None else int(layer),
        n_layers=pack.n_layers if layer is None else 1,
        head_row=pack.n_layers if head else -1, R=R, H=pack.H, nh=pack.nh,
        nh_kv=pack.nh_kv, hd=pack.hd, F=pack.F, V=pack.V, p=pack.page_size,
        n_pages=pack.n_pages, max_pages=table.shape[1], oob=pack.oob,
        max_len=pack.max_len, max_grid=pack.max_grid, eps=pack.eps,
        scale=1.0 / math.sqrt(pack.hd))
    grid = ctypes.c_int(0)
    lib = _build.library()
    code = lib.ptt_decode_megakernel(
        ctypes.byref(args), _DTYPE_CODE[h.dtype], int(pack.quant), dev.index,
        _build.stream_ptr(dev), ctypes.byref(grid))
    _build.check(code, "decode_megakernel")
    decode_megakernel.launches += 1
    decode_megakernel.grid = grid.value
    if not head:
        return h
    return h, out["tok"], out["maxv"], out["logits"]


decode_megakernel.launches = 0
decode_megakernel.grid = None     # blocks of the last launch
