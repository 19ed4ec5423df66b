"""Whole-step decode megakernel: the decoder layers of one decode step (and,
in whole-step mode, the final norm, the lm_head and the greedy argmax) in
one kernel launch.

Counterpart of `paddle_tpu/ops/pallas/decode_megakernel.py`. The Pallas TPU
kernel `_mk_kernel` (seg "full", tq = 1 and the tq > 1 speculative verify,
the greedy head and the top-K fold of `head_k > 1`) is replaced by
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

The kernel streams each weight's tiles (k rows x one 32-column slab) into
a ring of shared-memory stages by TMA tensor copies (`ptt::SlabRing`), so
it needs a tensor map per weight: `MegakernelPack` encodes them once, with
the pointer table (7 a layer, 1 for the lm_head), and a new pack (a pool
rebuild) encodes them anew. `slab_ring_plan` sizes the ring beside the
kernel's other shared memory; a geometry whose ring does not fit raises
MegakernelShapeError. `slab_route` picks, by shape alone, the ring or (for
rows that are not whole 16-byte pieces, which no tensor map takes) reading
the rows from device memory; both sum in the order of the int8 matmul's
GEMV, so both give the same bits.

Semantics (both versions): h [R, H] (R <= 8 slot rows, the current tokens'
embeddings) is updated in place; every layer writes the rope'd k row and
the v row of each active slot into its pool at the slot's flat row
table[r, lens // p] * p + lens % p before attending (inactive slots write
the pool's scratch row and attend nothing); attention covers lens + 1
positions. With head=True the call also returns the greedy token (argmax
over the logits cast to the compute dtype, the first maximum winning), its
logit as f32, and the [R, V] logits. With head_k = K > 1 (the sampling
fold) it returns instead the top K of each row of those cast logits as
(topv [R, K] f32, topi [R, K] int32), ordered value descending with ties
to the smaller vocab id (`lax.top_k`'s order, bit for bit: selection only,
no arithmetic), and no [R, V] logits buffer is allocated or written.

The speculative verify pass (tq = T > 1): h holds R = b * T slot-major feed
rows (slot s's pending token and its drafts at rows s * T + j), tables /
lens / active stay per slot [b]. Row (s, j) sits at position lens[s] + j
(clamped to max_len - 1 for the table and rope gathers), ropes at it, and
writes its k/v row there when wmask[s * T + j] (and the slot) is set; an
ungated row writes the scratch row, so later rows of its slot see the
pool's stale bytes at that position, as in the reference. Attention for
row (s, j) covers positions up to lens[s] + j (the ragged causal mask of
`spec_verify_attention`); the head runs on every row. The kernel's
register sums cover MAX_ROWS rows, so the wrapper runs a verify pass as
launches of floor(MAX_ROWS / T) whole slots (a slot's rows never straddle
two launches); every launch runs every layer (and the head) for its slots
and reads the weights again.

The tensor-parallel segments (seg = "qkv" | "tail" | "down", the
reference's SEG_PHASES) split one layer at the exact-mode gather
boundaries, so that a shard runs its share of a layer and the engine
gathers between the launches (inference/tp.py). A shard's pack holds its
column slices of wq / wk / wv / wg / wu, its pools over its local kv heads,
the replicated wo and wd and its vocab slice of the lm_head:
  qkv:  h in (not changed): norm1, the local Q / K / V, rope, the pool
        write and attention over the local heads; returns attn [R, nh_l hd];
  tail: h and the gathered attn_in [R, nh hd] in: O plus the residual (h
        updated in place), norm2, the local gate / up and SwiGLU; returns
        (h, act [R, F_l]);
  down: h and the gathered act_in [R, F] in: down plus the residual (h in
        place); returns h, or with head=True the head outputs over the
        local vocab (local ids; the engine combines the shards).
A segment runs one layer (layer=i). Each is its own build of the kernel
(`csrc/decode_megakernel_tp.cu`, bf16 activations with bf16 or int8
weights), so the seg "full" build keeps its instructions.
"""
import ctypes
import math

import torch

from ... import _build
from .paged_attention import (MAX_D, MAX_REP_D, paged_attention_reference,
                              spec_verify_attention)
from .quantized_matmul import quantized_matmul_reference
from .rms_norm import rms_rows

MAX_ROWS = 8            # slot rows per launch (the kernel's register sums)
MAX_HEAD_K = 128        # longest top-K list of the fold
MAX_SMEM = 232448       # dynamic shared memory one H100 block may use
_AUX_SMEM = 10592       # the kernel's shared memory besides the [R, H] rows
_FOLD_SMEM = 6 * MAX_ROWS * MAX_HEAD_K * 4   # the fold's lists (head_k > 1)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LAYER_KEYS = ("ln1", "ln2", "wq", "wk", "wv", "wo", "wg", "wu", "wd")
PTRS = 18               # addresses per row of the pointer table
P_KP, P_VP = 16, 17     # the K/V pool columns of a layer row
# the weight ring (csrc/decode_megakernel.cuh, "weight stream")
RING_MIN_STAGES = 4     # fewer stages: too few bytes in flight per SM
RING_MAX_STAGES = 6     # deeper rings stream no faster and slow every other
                        # load behind their copies (PERF.md §6)
RING_TILE_MAX_BYTES = 16384   # a tile: at most 256 k rows of one slab
RING_RESERVE = 1024     # shared memory left free (the kernel's static
                        # cursor; a timed copy's counters, tools/mk_phases.py)
SLAB_COLS = 32          # columns of a slab (ptt::kSlabCols)
MAPS_PER_ROW = 7        # tensor maps of a pointer-table row (the head: 1)
MAP_BYTES = 128         # sizeof(CUtensorMap)
_MAP_KEYS = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")   # slots M_Q .. M_D
_HEAD_BIT = 7           # ring_mask bit of the lm_head
_ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}
_ELEM_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


class MegakernelShapeError(ValueError):
    """A geometry whose weight ring does not fit one block's shared memory
    (`slab_ring_plan`): the kernel refuses it, there is no other build."""


def slab_route(wdtype, n):
    """How the kernel reads a [k, n] weight of `wdtype`: "ring" (tiles by
    TMA tensor copies, which need rows of a multiple of 16 bytes) or
    "direct" (rows from device memory, one thread's row at a time, the same
    sums). By shape alone."""
    return "ring" if (n * _ELEM_BYTES[wdtype]) % 16 == 0 else "direct"


def slab_ring_plan(dtype, wdtype, R, H, nh, nh_kv, hd, p, head_k=1,
                   head=False, rows=None):
    """The weight ring of one launch: (stages, rows, shared-memory bytes).

    The kernel's other regions come first (`_AUX_SMEM`, the [R, H] rows of
    `dtype` or the attention scratch, the fold's lists when head_k > 1),
    then 128 bytes to align the ring, then `stages` tiles of `rows` k rows
    x 32 columns of `wdtype` with two mbarriers each; RING_RESERVE bytes
    stay free. xs also holds the chunk of O's and down's x staged at a
    time (whole tiles: as many as fit R x H, at least one). `rows` (the
    tensor maps' box height, fixed per pack) is a multiple of the rows a
    thread's chains step by (128 / element bytes) and at most 256; None
    picks the tallest tile of at most
    RING_TILE_MAX_BYTES that leaves RING_MIN_STAGES stages. Stages: as many
    as fit, at most RING_MAX_STAGES. Raises MegakernelShapeError when
    RING_MIN_STAGES do not fit."""
    plan = _ring_plan(dtype, wdtype, R, H, nh, nh_kv, hd, p, head_k, head, rows)
    if plan is None:
        raise MegakernelShapeError(
            f"decode_megakernel: no weight ring of {RING_MIN_STAGES}+ stages "
            f"fits one block's shared memory (R {R}, hidden {H}, {dtype} "
            f"rows, {wdtype} weights, head_k {head_k}, tile rows {rows})")
    return plan


def _ring_plan(dtype, wdtype, R, H, nh, nh_kv, hd, p, head_k, head, rows):
    t, w = _ELEM_BYTES[dtype], _ELEM_BYTES[wdtype]
    rep = nh // nh_kv
    attn = 4 * (rep * hd + rep * p + 3 * rep)
    fold = 6 * MAX_ROWS * max(head_k, SLAB_COLS) * 4 if head and head_k > 1 \
        else 0
    step = 128 // w                      # ptt::SlabRing<WT>::kKRows
    cands = [rows] if rows is not None else [
        r for r in (256, 128, 64, 32)
        if r >= step and r * SLAB_COLS * w <= RING_TILE_MAX_BYTES]
    for r in cands:
        if r % step or not step <= r <= 256:
            break
        chunk = max(r, H // r * r)       # the kernel's x_chunk
        xs = -(-max(R * H * t, R * chunk * t, attn) // 16) * 16
        base = _AUX_SMEM + xs + fold
        stage = r * SLAB_COLS * w + 16
        stages = min(RING_MAX_STAGES,
                     (MAX_SMEM - RING_RESERVE - base - 128) // stage)
        if stages >= RING_MIN_STAGES:
            return stages, r, base + 128 + stages * stage
    return None


def megakernel_supported(nh, nh_kv, hd, hidden, ffn, tp=1):
    """Geometry the CUDA kernel takes, on a shard's local dims (nh, nh_kv,
    ffn; the global ones at tp = 1): GQA groups (nh a multiple of nh_kv), d
    a multiple of 16 up to 256 with rep * d <= 2048 (the paged-attention
    kernel's limits, whose per-page step it runs), the tp shards' heads
    covering the hidden width (nh * d * tp == hidden), and 8 bf16 rows of
    the hidden width in one block's shared memory beside the fold's lists
    and a weight ring of bf16 or int8 tiles (`slab_ring_plan`)."""
    if nh_kv <= 0 or nh % nh_kv or ffn <= 0:
        return False
    if not (hd % 16 == 0 and hd <= MAX_D and (nh // nh_kv) * hd <= MAX_REP_D
            and nh * hd * tp == hidden):
        return False
    return all(_ring_plan(torch.bfloat16, wdtype, MAX_ROWS, hidden, nh, nh_kv,
                          hd, 0, MAX_HEAD_K, True, None) is not None
               for wdtype in (torch.bfloat16, torch.int8))


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
    projection either dense or int8, weights on 16 bytes. Per-bucket
    scratch (qkv, attn, act and the per-block argmax partials) is allocated
    once per row count.

    The weight ring's tensor maps are built with the table: `map_spec`
    ([(L + 1) * 7, 3] int64, (address, k, n) of each ring-read projection
    in the table's row order: wq .. wd, the head in slot 0 of the last row;
    zeros for a weight read directly, `slab_route`), `ring_mask` (bits 0-6
    a layer's seven projections, set together when every one takes the
    ring, so each phase's jobs have one tile count; bit 7 the head),
    `ring_rows` (the tiles' k
    rows, the worst launch's plan: 8 rows and a fold of 128) and, on CUDA,
    `maps` (the encoded CUtensorMaps, 128 bytes each, on the device).

    A tensor-parallel shard's pack takes the shard's local head counts
    (nh, nh_kv), its column slices and pools, the replicated wo / wd and
    its vocab slice of the head: `O_in` (wo's rows) and `F_in` (wd's rows)
    are then the full widths the tail and down segments read."""

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
        wo, wd = self.layers[0]["wo"], self.layers[0]["wd"]
        self.O_in = (wo[0] if isinstance(wo, tuple) else wo).shape[0]
        self.F_in = (wd[0] if isinstance(wd, tuple) else wd).shape[0]
        self.V = 0 if head is None else \
            (head[0] if isinstance(head, tuple) else head).shape[1]
        self.quant = isinstance(self.layers[0]["wq"], tuple)
        self.wdtype = torch.int8 if self.quant else self.dtype
        self.ptrs = self._pointer_table()
        self.ring_mask, self.map_spec = self._map_spec()
        self.ring_rows = None
        self.maps = None
        if self.device.type == "cuda" and self.dtype in _DTYPE_CODE:
            self.ring_rows = slab_ring_plan(
                self.dtype, self.wdtype, MAX_ROWS, self.H, self.nh, self.nh_kv,
                self.hd, self.page_size, MAX_HEAD_K, head=True)[1]
            self.maps = self._encode_maps()
        self._scratch = {}
        self._memo = {}

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
            wt = w[0] if isinstance(w, tuple) else w
            if strict and wt.data_ptr() % 16:
                raise ValueError("decode_megakernel: every weight must start "
                                 "on 16 bytes (the ring's tensor copies)")
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

    def _map_spec(self):
        def w_of(w):
            return w[0] if isinstance(w, tuple) else w

        # a layer's seven projections take the ring together, or not at all
        mask, spec = 0, []
        if all(slab_route(self.wdtype, w_of(self.layers[0][key]).shape[1])
               == "ring" for key in _MAP_KEYS):
            mask = (1 << len(_MAP_KEYS)) - 1
        for ws in self.layers:
            for j, key in enumerate(_MAP_KEYS):
                w = w_of(ws[key])
                spec.append((w.data_ptr(), *w.shape) if mask >> j & 1
                            else (0, 0, 0))
        row = [(0, 0, 0)] * MAPS_PER_ROW
        if self.head is not None and slab_route(self.wdtype, self.V) == "ring":
            mask |= 1 << _HEAD_BIT
            w = w_of(self.head)
            row[0] = (w.data_ptr(), *w.shape)
        spec += row
        return mask, torch.tensor(spec, dtype=torch.int64).reshape(-1, 3)

    def _encode_maps(self):
        """The CUtensorMaps of `map_spec`, encoded by the library on the
        host and copied to a 64-byte-aligned device buffer."""
        n = self.map_spec.shape[0]
        host = torch.zeros(n * MAP_BYTES, dtype=torch.uint8)
        code = _build.library().ptt_decode_megakernel_maps(
            self.map_spec.data_ptr(), n, _ELEM_CODE[self.wdtype],
            self.ring_rows, host.data_ptr())
        _build.check(code, "decode_megakernel maps")
        maps = host.to(self.device)
        if maps.data_ptr() % 64:
            raise RuntimeError("decode_megakernel: the tensor maps' buffer is "
                               "not on 64 bytes")
        return maps

    def supported(self, tp):
        """`megakernel_supported` for this pack's geometry, remembered (the
        wrapper asks on every launch)."""
        ok = self._memo.get(("supported", tp))
        if ok is None:
            ok = self._memo[("supported", tp)] = megakernel_supported(
                self.nh, self.nh_kv, self.hd, self.H, self.F, tp)
        return ok

    def ring_stages(self, R, nh, nh_kv, head_k, head):
        """The weight ring's stages for a launch of R rows (`slab_ring_plan`
        at the pack's tile rows), remembered per launch shape."""
        key = (R, nh, nh_kv, head_k, bool(head))
        stages = self._memo.get(key)
        if stages is None:
            stages = self._memo[key] = slab_ring_plan(
                self.dtype, self.wdtype, R, self.H, nh, nh_kv, self.hd,
                self.page_size, head_k, head, rows=self.ring_rows)[0]
        return stages

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

    def fold_scratch(self, R, K):
        """The top-K fold's per-block lists ([max_grid, R, K] values and
        ids), allocated once per (R, K)."""
        s = self._scratch.get((R, K))
        if s is None:
            shape = (self.max_grid, R, K)
            s = dict(fold_v=torch.empty(shape, dtype=torch.float32,
                                        device=self.device),
                     fold_i=torch.empty(shape, dtype=torch.int32,
                                        device=self.device))
            self._scratch[(R, K)] = s
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
        "sin", "logits", "tok", "maxv", "part_v", "part_i", "topv", "topi",
        "fold_v", "fold_i", "wmask", "maps")] + \
        [(n, ctypes.c_int) for n in (
            "layer0", "n_layers", "head_row", "R", "H", "nh", "nh_kv", "hd",
            "F", "V", "p", "n_pages", "max_pages", "oob", "max_len",
            "max_grid", "head_k", "tq", "ring_stages", "ring_rows",
            "ring_mask")] + \
        [("eps", ctypes.c_float), ("scale", ctypes.c_float)]


def _proj(x, w):
    """x [R, k] @ w: dense, or int8 with the 512-row k tiles of
    quantized_matmul_reference (the engine's `_mm` on the CPU)."""
    if isinstance(w, tuple):
        return quantized_matmul_reference(x, w[0], w[1], out_dtype=x.dtype)
    return x @ w.to(x.dtype)


def head_outputs(R, V, head_k, dtype, device):
    """The output buffers a head launch writes: the greedy head's token,
    logit and [R, V] logits, or for head_k > 1 only the top-K values and
    ids (no logits buffer: the fold's point is that the row never
    exists)."""
    i32, f32 = torch.int32, torch.float32
    if head_k > 1:
        return dict(topv=torch.empty((R, head_k), dtype=f32, device=device),
                    topi=torch.empty((R, head_k), dtype=i32, device=device))
    return dict(logits=torch.empty((R, V), dtype=dtype, device=device),
                tok=torch.empty((R,), dtype=i32, device=device),
                maxv=torch.empty((R,), dtype=f32, device=device))


def decode_megakernel_reference(h, pack, tables=None, lens=None,
                                active=None, layer=None, head=False,
                                head_k=1, tq=1, wmask=None, seg="full",
                                attn_in=None, act_in=None):
    """Plain version: the engine's op chain (inference/serving.py
    `_layer_qkv` / `_layer_tail`, scheduler.py `_decode_math`, and at
    tq > 1 `_spec_verify_math`) with the same cast points: norms in
    serving order, projections emitted in h's dtype, the half-split rope
    with each product rounded, the pool write, `paged_attention_reference`
    (tq > 1: `spec_verify_attention`'s plain version), SiLU in f32 then
    cast, argmax over the cast logits (head_k > 1: a stable top-K of them,
    then f32). Updates h and the pools in place. A segment (seg "qkv",
    "tail", "down") runs its part of layer `layer` (module docstring)."""
    R = h.shape[0]
    T = int(tq)
    b = R // T
    p = pack.page_size
    nh, nh_kv, hd = pack.nh, pack.nh_kv, pack.hd
    if seg in ("full", "qkv"):
        live = active.bool()
        pos = (lens.long()[:, None] + torch.arange(T, device=h.device)
               ).clamp(0, pack.max_len - 1)
        slots = tables.long()[torch.arange(b, device=h.device)[:, None],
                              pos // p] * p + pos % p
        ok = live[:, None]
        if wmask is not None:
            ok = ok & wmask.bool().reshape(b, T)
        slots = torch.where(ok, slots, pack.oob).reshape(R)
        ctx = torch.where(live, lens.long() + 1, 0)
        act = active.to(torch.int32)
        pos = pos.reshape(R)
        c = pack.cos[pos][:, None, :].to(h.dtype)
        s = pack.sin[pos][:, None, :].to(h.dtype)
        d2 = hd // 2

        def rope(x):
            x1, x2 = x[..., :d2], x[..., d2:]
            return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)

    x_h = h
    for li in (range(pack.n_layers) if layer is None else (layer,)):
        ws = pack.layers[li]
        if seg in ("full", "qkv"):
            x = rms_rows(x_h, ws["ln1"], pack.eps)
            q = rope(_proj(x, ws["wq"]).reshape(R, nh, hd))
            k = rope(_proj(x, ws["wk"]).reshape(R, nh_kv, hd))
            v = _proj(x, ws["wv"]).reshape(R, nh_kv, hd)
            pack.k_flat[li].index_copy_(0, slots, k.to(pack.dtype))
            pack.v_flat[li].index_copy_(0, slots, v.to(pack.dtype))
            kp, vp = pack.pages(li)
            if T == 1:
                attn = paged_attention_reference(q, kp, vp, tables, ctx,
                                                 active=act)
            else:
                attn = spec_verify_attention(q.reshape(b, T, nh, hd), kp, vp,
                                             tables, lens, active=act)
            attn = attn.reshape(R, -1)
            if seg == "qkv":
                return attn
        else:
            attn = attn_in
        if seg in ("full", "tail"):
            x_h = x_h + _proj(attn, ws["wo"])
            x = rms_rows(x_h, ws["ln2"], pack.eps)
            g = _proj(x, ws["wg"])
            u = _proj(x, ws["wu"])
            a = torch.nn.functional.silu(g.float()).to(g.dtype) * u
            if seg == "tail":
                h.copy_(x_h)
                return h, a
        else:
            a = act_in
        x_h = x_h + _proj(a, ws["wd"])
    h.copy_(x_h)
    if not head:
        return h
    logits = _proj(rms_rows(h, pack.norm, pack.eps), pack.head)
    if head_k > 1:
        # imported here: the inference package imports this module
        from ...inference.sampling import top_k
        topv, topi = top_k(logits, head_k)
        return h, topv.float(), topi.to(torch.int32)
    tok = logits.argmax(-1).to(torch.int32)
    return h, tok, logits.max(-1).values.float(), logits


_SEG_CODE = {"qkv": 1, "tail": 2, "down": 3}


def _check_args(h, pack, tables, lens, active, layer, head, head_k, T,
                wmask, seg, attn_in, act_in, mlp_v):
    """The wrapper's shape and option rules (both versions)."""
    if seg not in ("full",) + tuple(_SEG_CODE):
        raise ValueError(f"unknown megakernel segment {seg!r}")
    R = h.shape[0] if h.dim() == 2 else -1
    b = R // T if T >= 1 else -1
    attends = seg in ("full", "qkv")
    if h.dim() != 2 or h.shape[1] != pack.H or T < 1 or R % T \
            or (wmask is not None and tuple(wmask.shape) != (R,)) \
            or (attends and (tables is None or lens is None
                             or active is None
                             or tuple(lens.shape) != (b,)
                             or tuple(active.shape) != (b,)
                             or tables.dim() != 2 or tables.shape[0] != b)):
        raise ValueError(
            f"decode_megakernel shapes: h {tuple(h.shape)} (hidden "
            f"{pack.H}, tq {T}), tables "
            f"{None if tables is None else tuple(tables.shape)}, lens "
            f"{None if lens is None else tuple(lens.shape)}, active "
            f"{None if active is None else tuple(active.shape)}, wmask "
            f"{None if wmask is None else tuple(wmask.shape)}")
    if seg != "full":
        if layer is None:
            raise ValueError(f"decode_megakernel: seg {seg!r} runs one "
                             "layer; pass layer=")
        need = dict(tail=("attn_in", attn_in, pack.O_in),
                    down=("act_in", act_in, pack.F_in)).get(seg)
        if need is not None and (need[1] is None or tuple(
                need[1].shape) != (R, need[2]) or need[1].dtype != h.dtype):
            raise ValueError(
                f"decode_megakernel seg {seg!r} takes {need[0]} [{R}, "
                f"{need[2]}] in {h.dtype}; got "
                f"{None if need[1] is None else tuple(need[1].shape)}")
        if mlp_v is not None and int(mlp_v) != pack.F:
            raise ValueError(
                f"decode_megakernel: mlp_v={mlp_v}, but this pack's local "
                f"ffn width is {pack.F} (the port never pads it)")
    if head and (pack.head is None or seg not in ("full", "down")
                 or (seg == "full" and layer is not None)):
        raise ValueError("decode_megakernel: head=True needs a pack built "
                         "with the lm_head, and every layer (layer=None), "
                         "or the down segment")
    if layer is not None and not 0 <= layer < pack.n_layers:
        raise ValueError(f"decode_megakernel: no layer {layer}")
    if head_k != 1 and not (head and 1 <= head_k <= min(MAX_HEAD_K,
                                                          pack.V)):
        raise ValueError(
            f"decode_megakernel: head_k must be in [1, min({MAX_HEAD_K}, "
            f"V={pack.V})] and needs head=True; got {head_k}")
    return R, b


def decode_megakernel(h, pack, tables=None, lens=None, active=None,
                      layer=None, head=False, head_k=1, tq=1, wmask=None,
                      seg="full", attn_in=None, act_in=None, mlp_v=None):
    """One decode step's layers through the megakernel. h [R, H] in the
    pack's dtype (updated in place), R = b * tq; tables [b, max_pages],
    lens [b] (tokens cached before this step), active [b]. layer=None runs
    every layer in one launch, layer=i only layer i. head=True (whole-step
    mode, every layer) adds the final norm, the lm_head and the greedy
    argmax and returns (h, tok [R] int32, maxv [R] f32, logits [R, V]);
    else h. head_k = K in [2, min(128, V)] replaces the argmax by the
    running top-K fold and returns (h, topv [R, K] f32, topi [R, K]
    int32). tq = T > 1 is the speculative verify pass over slot-major feed
    rows, wmask [R] gating each row's pool write (None: every row of an
    active slot writes).

    seg="qkv" | "tail" | "down" runs one tensor-parallel segment of layer
    `layer` (module docstring): qkv returns attn [R, nh hd] (the pack's
    local heads); tail takes attn_in [R, O_in] and returns (h, act [R,
    F]); down takes act_in [R, F_in] and returns h, or the head outputs
    (local vocab) with head=True. tail and down need no tables, lens or
    active. mlp_v, the reference's unpadded local ffn width, must be None
    or the pack's F.

    A CPU tensor takes the plain version. A CUDA tensor launches
    `csrc/decode_megakernel.cu` (seg "full") or
    `csrc/decode_megakernel_tp.cu` (the segments), cooperatively, one
    block per SM times the occupancy, or raises (MegakernelShapeError when
    the weight ring does not fit); there is no fallback. At tq > 1 a call
    is ceil(b / floor(MAX_ROWS / tq)) launches of whole slots."""
    T = int(tq)
    head_k = int(head_k)
    R, b = _check_args(h, pack, tables, lens, active, layer, head, head_k,
                       T, wmask, seg, attn_in, act_in, mlp_v)
    if h.device.type == "cpu":
        return decode_megakernel_reference(h, pack, tables, lens, active,
                                           layer, head, head_k, T, wmask,
                                           seg, attn_in, act_in)
    if h.device.type != "cuda":
        raise ValueError(f"decode_megakernel: unsupported device {h.device}")
    if h.device != pack.device or h.dtype != pack.dtype \
            or h.dtype not in _DTYPE_CODE or not h.is_contiguous():
        raise ValueError(
            f"decode_megakernel kernel takes a contiguous h of the pack's "
            f"dtype and device ({pack.dtype}, {pack.device}); got "
            f"{h.dtype}, {h.device}")
    if seg != "full" and h.dtype != torch.bfloat16:
        raise ValueError(
            f"decode_megakernel: the segments are built for bf16 "
            f"activations (the engine's compute dtype on CUDA); got "
            f"{h.dtype}")
    if T > MAX_ROWS or (T == 1 and not 1 <= R <= MAX_ROWS) or b < 1:
        raise ValueError(
            f"decode_megakernel kernel takes 1 to {MAX_ROWS} rows per "
            f"launch and tq <= {MAX_ROWS}; got {R} rows at tq {T}")
    tp = pack.O_in // (pack.nh * pack.hd) if seg != "full" else 1
    if not pack.supported(tp):
        raise ValueError(
            f"decode_megakernel kernel does not take this geometry (nh "
            f"{pack.nh}, nh_kv {pack.nh_kv}, hd {pack.hd}, hidden {pack.H}, "
            f"ffn {pack.F}, tp {tp}); see megakernel_supported")
    dev = h.device
    i32 = torch.int32
    attends = seg in ("full", "qkv")
    if attends:
        table = tables.to(device=dev, dtype=i32).contiguous()
        lens_i = lens.to(device=dev, dtype=i32).contiguous()
        act_i = active.to(device=dev, dtype=i32).contiguous()
    wm = None if wmask is None else \
        wmask.to(device=dev, dtype=i32).contiguous()
    out = head_outputs(R, pack.V, head_k, h.dtype, dev) if head else {}
    # a segment's output (qkv: attn, tail: act) and input (tail: attn_in,
    # down: act_in) take the places of the full launch's scratch
    seg_io = {}
    if seg == "qkv":
        res = torch.empty((R, pack.nh * pack.hd), dtype=h.dtype, device=dev)
        seg_io["attn"] = res
    elif seg == "tail":
        res = torch.empty((R, pack.F), dtype=h.dtype, device=dev)
        seg_io.update(attn=attn_in.contiguous(), act=res)
    elif seg == "down":
        seg_io["act"] = act_in.contiguous()
    # the widths each segment's phases read (csrc/decode_megakernel.cuh):
    # tail's O reads every head (the full head counts), down reads the
    # gathered ffn row (the full F)
    nh, nh_kv, F = pack.nh, pack.nh_kv, pack.F
    if seg == "tail":
        nh, nh_kv = nh * tp, nh_kv * tp
    elif seg == "down":
        F = pack.F_in
    per = MAX_ROWS // T                   # whole slots per launch
    lib = _build.library()
    for s0 in range(0, b, per):
        s1 = min(b, s0 + per)
        r0, r1 = s0 * T, s1 * T
        stages = pack.ring_stages(r1 - r0, nh, nh_kv, head_k, head)
        scr = dict(pack.scratch(r1 - r0))
        if head_k > 1:
            scr.update(pack.fold_scratch(r1 - r0, head_k))
        scr.update({k: t[r0:r1] for k, t in seg_io.items()})
        slot_args = dict(table=table[s0:s1].data_ptr(),
                         lens=lens_i[s0:s1].data_ptr(),
                         active=act_i[s0:s1].data_ptr()) if attends else {}
        args = _MkArgs(
            ptrs=pack.ptrs.data_ptr(), h=h[r0:r1].data_ptr(),
            cos=pack.cos.data_ptr(), sin=pack.sin.data_ptr(),
            wmask=None if wm is None else wm[r0:r1].data_ptr(),
            **slot_args,
            **{k: t.data_ptr() for k, t in scr.items()},
            **{k: t[r0:r1].data_ptr() for k, t in out.items()},
            layer0=0 if layer is None else int(layer),
            n_layers=pack.n_layers if layer is None else 1,
            head_row=pack.n_layers if head else -1, R=r1 - r0, H=pack.H,
            nh=nh, nh_kv=nh_kv, hd=pack.hd, F=F, V=pack.V,
            p=pack.page_size, n_pages=pack.n_pages,
            max_pages=table.shape[1] if attends else 0,
            oob=pack.oob, max_len=pack.max_len, max_grid=pack.max_grid,
            head_k=head_k, tq=T, maps=pack.maps.data_ptr(),
            ring_stages=stages, ring_rows=pack.ring_rows,
            ring_mask=pack.ring_mask, eps=pack.eps,
            scale=1.0 / math.sqrt(pack.hd))
        grid = ctypes.c_int(0)
        if seg == "full":
            code = lib.ptt_decode_megakernel(
                ctypes.byref(args), _DTYPE_CODE[h.dtype], int(pack.quant),
                dev.index, _build.stream_ptr(dev), ctypes.byref(grid))
        else:
            code = lib.ptt_decode_megakernel_seg(
                ctypes.byref(args), _SEG_CODE[seg], int(pack.quant),
                dev.index, _build.stream_ptr(dev), ctypes.byref(grid))
        _build.check(code, "decode_megakernel")
        decode_megakernel.launches += 1
        if seg != "full":
            decode_megakernel.seg_launches += 1
        if head_k > 1:
            decode_megakernel.fold_launches += 1
        if T > 1:
            decode_megakernel.verify_launches += 1
        decode_megakernel.grid = grid.value
    decode_megakernel.outputs = tuple(sorted(out))
    if seg == "qkv":
        return res
    if seg == "tail":
        return h, res
    if not head:
        return h
    if head_k > 1:
        return h, out["topv"], out["topi"]
    return h, out["tok"], out["maxv"], out["logits"]


decode_megakernel.launches = 0
decode_megakernel.seg_launches = 0    # tensor-parallel segment launches
decode_megakernel.fold_launches = 0   # launches with head_k > 1 (of .launches)
decode_megakernel.verify_launches = 0  # launches with tq > 1 (of .launches)
decode_megakernel.grid = None     # blocks of the last launch
decode_megakernel.outputs = ()    # output buffers the last launch allocated
