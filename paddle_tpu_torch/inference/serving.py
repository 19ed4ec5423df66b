"""LLM serving engine: paged KV cache + int8 weight-only decode.

Counterpart of `paddle_tpu/inference/serving.py` (the static engine):

  - PageAllocator: free-list over [n_pages, page_size, h_kv, d] K/V pools
  - LLMEngine(model, ...): snapshots LLaMA weights (optionally int8),
    prefills prompts (dense scores, or the flash kernel for long prompts)
    and scatters their KV into pages, then decodes one token per step:
    ragged per-sequence positions, rope at each sequence's own offset, KV
    written to its page slot, attention through the paged-attention
    kernel, projections through the int8 kernel when quant="int8"
  - generate(): the host loop, or device_loop=True (all steps queued on
    the device, one read-back at the end)

Kernels run for CUDA tensors; with device="cpu" the same code runs the
plain PyTorch versions (the tests hold that path against the JAX engine).

tp > 1 (inference/tp.py) splits the engine into shards over a list of
devices: every step runs per shard on the shard's local heads, pools and
column slices, with the reference's collectives between the shards. The
math is written over the list of shards; tp = 1 is one shard and no
collective, the same operations in the same order as before.
"""
import collections
import math
import uuid

import numpy as np
import torch

from .. import resolve_device
from ..failsafe import fault_point
from . import sampling
from .tp import TPContext
from ..models.generation import _sample
from ..models.llama import LlamaForCausalLM, _rope_cache
from ..ops.pallas.flash_attention import flash_attention_fwd
from ..ops.pallas.paged_attention import expand_kv_heads, paged_attention
from ..ops.pallas.quantized_matmul import quantize_weights, quantized_matmul
from ..ops.pallas.rms_norm import rms_rows as _rms
from ..ops.lora import lora_apply

LOOP_BUCKET = 32   # device-loop step counts round up to a multiple of this


class EngineFullError(RuntimeError):
    """A request cannot be served right now: the KV page pool (or the
    slot budget) is exhausted. A direct generate() call surfaces it with
    the sizes that collided."""


class PageAllocator:
    """Free-list page allocator with refcounts (the serving engine's KV
    memory manager).

    Refcounts exist for prefix caching: a page holding a shared prompt
    prefix is referenced by several sequences at once and returns to the
    free list only when the LAST reference drops. alloc() hands out a
    page at refcount 1; share() takes an extra reference; free() drops one
    reference per page and recycles at zero. Double-frees and shares of
    free pages raise instead of corrupting the free list.

    Cross-engine transfers (KV handoff) are ticketed: an export is either
    committed (source references dropped) or aborted (nothing changed),
    and a committed import burns its token so one exported page chain can
    never be imported twice.
    """

    def __init__(self, n_pages):
        self.n_pages = n_pages
        self._free = list(range(n_pages - 1, -1, -1))
        self._ref = [0] * n_pages
        self.total_allocs = 0
        self._exports = {}       # token -> tuple(pages) pending export
        self._imports = {}       # token -> list(pages) pending import
        # burned tokens (committed imports), bounded: only transfers whose
        # retry could still be in flight need the protection
        self._imported = collections.OrderedDict()
        self._imported_cap = 4096

    # -- cross-engine transfer ----------------------------------------------
    def export_begin(self, pages):
        """Open a transfer ticket for `pages` (all must be live). Returns
        the ticket token."""
        pages = tuple(int(p) for p in pages)
        for p in pages:
            if not (0 <= p < self.n_pages) or self._ref[p] <= 0:
                raise RuntimeError(
                    f"export_begin of page {p}: not a live page "
                    f"(refcount {self._ref[p] if 0 <= p < self.n_pages else 'n/a'})")
        token = uuid.uuid4().hex
        self._exports[token] = pages
        return token

    def export_pages(self, token):
        pages = self._exports.get(token)
        if pages is None:
            raise RuntimeError(
                f"export_pages of unknown/closed transfer {token!r}")
        return pages

    def is_exporting(self, page):
        """True while `page` sits under any pending export ticket."""
        return any(page in pages for pages in self._exports.values())

    def export_commit(self, token):
        """Close the ticket and drop this transfer's reference on each
        page."""
        pages = self._exports.pop(token, None)
        if pages is None:
            raise RuntimeError(
                f"export_commit of unknown/closed transfer {token!r}")
        self.free(pages)

    def export_abort(self, token):
        if self._exports.pop(token, None) is None:
            raise RuntimeError(
                f"export_abort of unknown/closed transfer {token!r}")

    def import_begin(self, token, n):
        """Claim `n` fresh pages to receive the transfer `token`. A token
        already imported (or mid-import) raises; nothing is claimed when
        the pool cannot cover `n`."""
        if token in self._imported or token in self._imports:
            raise RuntimeError(
                f"double import of transfer {token!r}: this page chain "
                "was already imported here (a retried handoff must "
                "abort the first import or target another engine)")
        if n > self.available:
            raise EngineFullError(
                f"import of {n} KV pages needs {n} free pages but only "
                f"{self.available} of {self.n_pages} are free")
        pages = []
        self._imports[token] = pages
        try:
            for _ in range(n):
                pages.append(self.alloc())
        except Exception:
            self.import_abort(token)
            raise
        return list(pages)

    def import_commit(self, token):
        if token not in self._imports:
            raise RuntimeError(
                f"import_commit of unknown transfer {token!r}")
        del self._imports[token]
        self._imported[token] = True
        while len(self._imported) > self._imported_cap:
            self._imported.popitem(last=False)

    def import_abort(self, token):
        """Return a failed import's pages; the token is not burned."""
        pages = self._imports.pop(token, None)
        if pages is None:
            raise RuntimeError(
                f"import_abort of unknown transfer {token!r}")
        if pages:
            self.free(pages)

    def alloc(self):
        fault_point("page.alloc")
        if not self._free:
            raise EngineFullError(
                f"KV page pool exhausted: 1 page needed, 0 of "
                f"{self.n_pages} available — all pages are in use "
                "(retire sequences or build the engine with a larger "
                "max_batch*max_len budget)")
        p = self._free.pop()
        self._ref[p] = 1
        self.total_allocs += 1
        return p

    def share(self, page):
        """Take an additional reference on an allocated page."""
        if self._ref[page] <= 0:
            raise RuntimeError(
                f"share() of free page {page} (refcount "
                f"{self._ref[page]}, never allocated or already "
                "recycled)")
        self._ref[page] += 1
        return page

    def refcount(self, page):
        return self._ref[page]

    def free(self, pages):
        """Drop one reference per listed page; pages reaching zero return
        to the free list."""
        for p in pages:
            if self._ref[p] <= 0:
                raise RuntimeError(
                    f"double free of page {p}: refcount is already "
                    f"{self._ref[p]} (every holder has released it)")
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free.append(p)

    @property
    def available(self):
        return len(self._free)


def _snapshot_llama(model, quant, weight_dtype, device, quant_scales=None):
    """Per-layer weights as plain tensors on `device`. quant='int8'
    replaces the seven projection weights of every layer and the lm_head
    with (int8, scales) pairs, quantized from the model's own values (not
    from a weight_dtype-rounded copy). quant_scales (a
    quantization.ptq.CalibrationResult) swaps the absmax scales for
    calibrated ones leaf by leaf: a leaf the calibration lacks keeps the
    absmax scales, and a scale vector of the wrong width raises
    CalibrationError before anything installs."""

    def take(param):
        w = param.detach().to(device)
        if weight_dtype is not None and w.is_floating_point():
            w = w.to(weight_dtype)
        return w

    def maybe_q(param, li=None, proj=None):
        if quant != "int8":
            return take(param)
        w = param.detach().to(device, torch.float32)
        sc = (quant_scales.weight_scale(li, proj)
              if quant_scales is not None else None)
        if sc is not None:
            from ..quantization.ptq import quantize_with_scales
            return quantize_with_scales(w, sc)
        return quantize_weights(w)

    layers = []
    for li, layer in enumerate(model.llama.layers):
        a = layer.self_attn
        layers.append(dict(
            ln1=take(layer.input_layernorm.weight),
            ln2=take(layer.post_attention_layernorm.weight),
            wq=maybe_q(a.q_proj.weight, li, "wq"),
            wk=maybe_q(a.k_proj.weight, li, "wk"),
            wv=maybe_q(a.v_proj.weight, li, "wv"),
            wo=maybe_q(a.o_proj.weight, li, "wo"),
            wg=maybe_q(layer.mlp.gate_proj.weight, li, "wg"),
            wu=maybe_q(layer.mlp.up_proj.weight, li, "wu"),
            wd=maybe_q(layer.mlp.down_proj.weight, li, "wd"),
        ))
    return dict(emb=take(model.llama.embed_tokens.weight),
                norm=take(model.llama.norm.weight),
                head=maybe_q(model.lm_head.weight, None, "head"),
                layers=layers, eps=model.config.rms_norm_eps)


def _product(x, w):
    """x [m, k] @ w for a dense weight or an (int8, scales) pair: the one
    place the serving math calls a product kernel."""
    if isinstance(w, tuple):
        wq, sc = w
        return quantized_matmul(x, wq, sc, out_dtype=x.dtype)
    return x @ w.to(x.dtype)


def _mm(x, w, rows=None):
    """x [..., k] @ w where w is either a dense tensor or an (int8, scales)
    pair. rows=R runs the product in pieces of exactly R rows (the last
    one padded with zero rows): a product kernel may pick its summation
    order by the row count (cuBLAS picks its kernel by it, the int8 matmul
    takes its GEMV at m <= 8), so a row's bits then do not depend on how
    many rows share the call."""
    flat = x.reshape(-1, x.shape[-1])
    m = flat.shape[0]
    if rows is None or m == rows:
        out = _product(flat, w)
    else:
        pad = -m % rows
        if pad:
            flat = torch.cat([flat, flat.new_zeros((pad, flat.shape[1]))])
        out = torch.cat([_product(p, w) for p in flat.split(rows)])[:m]
    return out.reshape(*x.shape[:-1], -1)


_WEIGHT_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                  "float16": torch.float16}


class LLMEngine:
    """Paged-KV decode engine for LlamaForCausalLM.

    max_batch sequences, each up to max_len tokens, share a pool of
    (max_batch * max_len / page_size) pages per layer. The engine runs on
    `device` (CUDA unless device="cpu"); the model may live anywhere.
    """

    def __init__(self, model, max_len=1024, page_size=128, max_batch=8,
                 quant=None, use_pallas=None, batch_buckets=None,
                 weight_dtype=None, flash_prefill_min=256, tp=1,
                 tp_mode="exact", tp_compress=None, quant_scales=None,
                 device=None):
        if not isinstance(model, LlamaForCausalLM):
            raise TypeError("LLMEngine serves the LLaMA family only")
        if quant not in (None, "int8"):
            raise ValueError(f"unsupported quant {quant!r}")
        if use_pallas is not None:
            raise ValueError(
                f"use_pallas={use_pallas!r}: the port has no kernel switch "
                "(a CUDA tensor launches the kernels, a CPU tensor runs the "
                "plain versions); leave it None")
        if quant_scales is not None and quant != "int8":
            raise ValueError(
                "quant_scales (PTQ calibration) only applies with "
                "quant='int8': the scales feed the int8 snapshot")
        if weight_dtype is not None:
            key = str(weight_dtype).replace("torch.", "")
            if key not in _WEIGHT_DTYPES:
                raise ValueError(
                    f"unsupported weight_dtype {weight_dtype!r}; expected "
                    f"bfloat16/float16/float32")
            weight_dtype = _WEIGHT_DTYPES[key]
        cfg = model.config
        self.cfg = cfg
        self.page_size = page_size
        self.max_len = max_len
        self.max_batch = max_batch
        self.max_pages_per_seq = -(-max_len // page_size)
        self.n_pages = max_batch * self.max_pages_per_seq
        self.nh = cfg.num_attention_heads
        self.hd = cfg.hidden_size // self.nh
        self.nh_kv = cfg.num_key_value_heads or self.nh
        if self.nh % self.nh_kv:
            raise ValueError(
                f"num_attention_heads ({self.nh}) must be a multiple of "
                f"num_key_value_heads ({self.nh_kv})")
        # tensor parallelism: tp > 1 splits heads, pools and the column-
        # parallel weights over a list of devices (inference/tp.py); the
        # math below runs per shard on the LOCAL head counts (nh_l, nh_kv_l,
        # the global ones at tp = 1)
        self.tp = int(tp or 1)
        if self.tp > 1:
            if self.nh % self.tp or self.nh_kv % self.tp:
                raise ValueError(
                    f"tp={self.tp} must divide both num_attention_heads "
                    f"({self.nh}) and num_key_value_heads ({self.nh_kv}) "
                    "— heads shard evenly, GQA groups never split")
            self._tpc = TPContext(self.tp, tp_mode, tp_compress,
                                  _shard_devices(device, self.tp))
            self.devices = self._tpc.devices
        else:
            self._tpc = None
            if isinstance(device, (list, tuple)):
                if len(device) != 1:
                    raise ValueError(
                        f"{len(device)} devices given for tp=1; pass one")
                device = device[0]
            self.devices = [resolve_device(device)]
        self.device = self.devices[0]
        self.tp_mode = tp_mode if self.tp > 1 else None
        self.tp_compress = tp_compress if self.tp > 1 else None
        self.nh_l = self.nh // self.tp
        self.nh_kv_l = self.nh_kv // self.tp
        # padded prompts at/above this length prefill through the flash
        # kernel instead of dense scores (see _attn_prefill)
        self.flash_prefill_min = int(flash_prefill_min)
        # wall seconds spent issuing device work and blocked on its
        # read-backs (host time included: a dispatch-side number, not
        # device busyness); the continuous-batching engine accrues it
        self.dispatch_seconds = 0.0
        self.quant_scales = quant_scales
        weights = _snapshot_llama(model, quant, weight_dtype, self.device,
                                  quant_scales)
        weights["cos"], weights["sin"] = _rope_cache(
            max_len, self.hd, cfg.rope_theta, device=self.device)
        # one weight dict per shard; `weights` is shard 0's (at tp = 1 the
        # whole snapshot)
        self._W = ([weights] if self._tpc is None
                   else self._tpc.split_weights(weights))
        self.weights = self._W[0]
        self.kv_dtype = (torch.bfloat16 if self.device.type == "cuda"
                         else torch.float32)
        self._reset_kv()
        self._batch_buckets = (tuple(sorted(set(
            min(int(x), max_batch) for x in batch_buckets)))
            if batch_buckets is not None else None)

    @property
    def device_seconds(self):
        """DEPRECATED alias of `dispatch_seconds` (renamed because the
        accrued value is dispatch wall-clock — host call machinery
        included — not device busyness; use probe_device_step_seconds /
        device_busy_frac for that)."""
        return self.dispatch_seconds

    # -- tensor parallelism (inference/tp.py) ---------------------------------
    def _rep(self, x):
        """x on every shard's device (a step's replicated inputs)."""
        return [x] if self._tpc is None else self._tpc.replicate(x)

    def _embed(self, ids):
        """Each shard's embedding rows of ids (the embedding is
        replicated), in the KV dtype."""
        return [W["emb"][i].to(self.kv_dtype)
                for W, i in zip(self._W, self._rep(ids))]

    def _tp_gather_heads(self, xs):
        """exact mode: every shard's full heads before o_proj (identity at
        tp = 1 and in psum mode, where wo is row-split instead)."""
        if self._tpc is None or self._tpc.mode != "exact":
            return xs
        return self._tpc.gather_heads(xs)

    def _tp_gather_cols(self, xs):
        """exact mode: every shard's full MLP activation row before
        down_proj (identity at tp = 1 and in psum mode)."""
        if self._tpc is None or self._tpc.mode != "exact":
            return xs
        return self._tpc.gather_cols(xs)

    def _tp_reduce(self, xs):
        """psum mode: the sum closing a row-parallel pair (identity at
        tp = 1 and in exact mode)."""
        if self._tpc is None or self._tpc.mode != "psum":
            return xs
        return self._tpc.reduce(xs)

    def _vocab_sharded(self):
        return self._tpc is not None and self._tpc.head_sharded

    def _gather_logits(self, locs):
        """The full-vocab logits from the shards' head outputs, on the
        engine's device: the gathered vocab-parallel slices, else shard 0's
        (a replicated head; at tp = 1 the one shard's)."""
        if self._vocab_sharded():
            return self._tpc.gather_cols(locs)[0]
        return locs[0]

    def _tp_greedy_token(self, locs):
        """Greedy next token from the shards' (possibly vocab-local)
        logits: the argmax at tp = 1 or with a replicated head, else the
        argmax-of-local-max combine (equal to the argmax of the gathered
        logits)."""
        if not self._vocab_sharded():
            return locs[0].argmax(-1)
        return self._tpc.argmax_of_local_max(
            [x.max(-1).values for x in locs], [x.argmax(-1) for x in locs],
            locs[0].shape[-1])

    def _tp_topk(self, locs, k):
        """Top-k (f32 values, ids) of the shards' (possibly vocab-local)
        logits in lax.top_k's order: each shard's top-k, combined by
        topk_of_local_topk under the vocab-parallel head (equal to the
        top-k of the gathered logits)."""
        pairs = [sampling.top_k(x, k) for x in locs]
        if not self._vocab_sharded():
            return pairs[0][0].float(), pairs[0][1]
        return self._tpc.topk_of_local_topk(
            [v.float() for v, _ in pairs], [i for _, i in pairs],
            locs[0].shape[-1], k)

    def _head_logits(self, hs, rows=None):
        """Each shard's final norm and lm_head of its rows hs [b, t, H]:
        the local logits [b, t, V_l]. rows: `_mm`'s product row count."""
        return [_mm(_rms(h, W["norm"], W["eps"]), W["head"], rows)
                for h, W in zip(hs, self._W)]

    # -- math ---------------------------------------------------------------
    def _attn_dense(self, q, k, v):
        """Prefill attention (causal, dense over the prompt). GQA kv is
        expanded here for the prompt only; the cache stays at nh_kv."""
        k = expand_kv_heads(k, q.shape[2])
        v = expand_kv_heads(v, q.shape[2])
        s = q.shape[1]
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(self.hd)
        tri = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        logits = torch.where(tri[None, None], logits,
                             torch.full_like(logits, -1e30))
        w = torch.softmax(logits.float(), dim=-1).to(q.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", w, v)

    def _attn_prefill(self, q, k, v, t_pad, t0):
        """Long prompts take the flash kernel (no [b, h, t, t] scores);
        short ones keep the dense path. The length and head-dim gates are
        the reference's; on CUDA the kernel itself takes d 64 or 128 and
        raises on other widths. Keys past the true length t0 are masked;
        rows past it are padding the caller never reads."""
        if t_pad >= self.flash_prefill_min and (
                self.hd == 64 or self.hd % 128 == 0):
            qh = q.shape[2]
            o, _ = flash_attention_fwd(q, expand_kv_heads(k, qh),
                                       expand_kv_heads(v, qh), True,
                                       1.0 / math.sqrt(self.hd), s_true=t0)
            return o
        return self._attn_dense(q, k, v)

    def _layer_qkv(self, W, wset, h, pos_ids, rows=None, ad=None):
        """One shard's q / k / v of a layer (roped). ad: the shard's LoRA
        selection for this layer (`ContinuousBatchingEngine._ad_sel`); its
        delta lands on the projection outputs before the reshape and rope,
        where-gated so adapter-free rows keep their bits."""
        cos, sin = W["cos"], W["sin"]
        b, t, _ = h.shape
        x = _rms(h, wset["ln1"], W["eps"])
        q = _mm(x, wset["wq"], rows)
        k = _mm(x, wset["wk"], rows)
        v = _mm(x, wset["wv"], rows)
        if ad is not None:
            q = lora_apply(q, x, "wq", ad)
            k = lora_apply(k, x, "wk", ad)
            v = lora_apply(v, x, "wv", ad)
        q = q.reshape(b, t, -1, self.hd)
        k = k.reshape(b, t, -1, self.hd)
        v = v.reshape(b, t, -1, self.hd)
        # GQA: k/v stay at nh_kv heads; the decode kernel maps q head i to
        # kv head i // rep itself
        c = cos[pos_ids][..., None, :].to(q.dtype)
        s = sin[pos_ids][..., None, :].to(q.dtype)
        d2 = self.hd // 2

        def rope(x_):
            x1, x2 = x_[..., :d2], x_[..., d2:]
            return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)

        return rope(q), rope(k), v

    def _layer_tail(self, li, hs, attns, rows=None, ad=None):
        """Layer li's tail on every shard: O (exact: on the gathered heads
        against the replicated wo; psum: the local rows, reduced), the
        residual, norm2, the local gate / up columns with SwiGLU, then down
        (exact: on the gathered activation row; psum: reduced). hs and
        attns [b, t, nh_l, hd] are per shard; returns the shards' h.
        rows: `_mm`'s product row count. ad: the shards' LoRA selections
        for this layer (deltas on gate / up at the local columns and on
        down after the exact-mode gather), or None."""
        b, t = attns[0].shape[:2]
        attns = self._tp_gather_heads(attns)
        os_ = self._tp_reduce([_mm(a.reshape(b, t, -1), W["layers"][li]["wo"],
                                   rows)
                               for a, W in zip(attns, self._W)])
        hs = [h + o for h, o in zip(hs, os_)]
        acts = []
        for s, (h, W) in enumerate(zip(hs, self._W)):
            wset = W["layers"][li]
            x = _rms(h, wset["ln2"], W["eps"])
            g = _mm(x, wset["wg"], rows)
            u = _mm(x, wset["wu"], rows)
            if ad is not None:
                g = lora_apply(g, x, "wg", ad[s])
                u = lora_apply(u, x, "wu", ad[s])
            acts.append(torch.nn.functional.silu(g.float()).to(g.dtype) * u)
        acts = self._tp_gather_cols(acts)
        ds = [_mm(a, W["layers"][li]["wd"], rows)
              for a, W in zip(acts, self._W)]
        if ad is not None:
            ds = [lora_apply(d, a, "wd", sel)
                  for d, a, sel in zip(ds, acts, ad)]
        ds = self._tp_reduce(ds)
        return [h + d for h, d in zip(hs, ds)]

    def _scatter_kv(self, s, li, slots, k, v):
        """Write k/v rows [n, h_kv_l, d] into shard s's layer-li pools at
        flat slot ids [n]. The pools are updated in place (index_copy_),
        where the reference donates its buffers to the compiled step and
        gets new ones back."""
        shape = (-1, self.nh_kv_l, self.hd)
        self._kp[s][li].view(shape).index_copy_(
            0, slots, k.reshape(shape).to(self.kv_dtype))
        self._vp[s][li].view(shape).index_copy_(
            0, slots, v.reshape(shape).to(self.kv_dtype))

    def _prefill(self, ids, tables, t0):
        """ids [b, t_pad] (padded to a page multiple); tables [b,
        max_pages] int32; t0 = true prompt length. Returns the logits of
        position t0 - 1, [b, V]. Padded positions write KV past t0 into
        the sequence's own pages: decode masks by length and overwrites
        each slot before it is read."""
        b, t_pad = ids.shape
        p = self.page_size
        hs = self._embed(ids)
        pos = torch.arange(t_pad, device=self.device)
        pos_ids = self._rep(pos[None, :].expand(b, t_pad))
        slots = self._rep((tables[:, pos // p] * p + pos % p).reshape(-1))
        for li in range(self.cfg.num_hidden_layers):
            attns, kvs = [], []
            for s, W in enumerate(self._W):
                q, k, v = self._layer_qkv(W, W["layers"][li], hs[s],
                                          pos_ids[s])
                attns.append(self._attn_prefill(q, k, v, t_pad, t0))
                kvs.append((k, v))
            hs = self._layer_tail(li, hs, attns)
            for s, (k, v) in enumerate(kvs):
                self._scatter_kv(s, li, slots[s], k, v)
        locs = self._head_logits([h[:, t0 - 1:t0] for h in hs])
        return self._gather_logits([x[:, 0] for x in locs])

    def _step(self, tok, tables, lens):
        """One decode step for every slot: tok [b] (the token at position
        lens[b]), lens [b] tokens already cached. Returns logits [b, V]."""
        p = self.page_size
        b = tok.shape[0]
        hs = self._embed(tok[:, None])
        pos_ids = self._rep(lens[:, None])
        slots = self._rep(tables[torch.arange(b, device=self.device),
                                 lens // p] * p + lens % p)
        lens_after = self._rep((lens + 1).to(torch.int32))
        tables_r = self._rep(tables)
        for li in range(self.cfg.num_hidden_layers):
            attns = []
            for s, W in enumerate(self._W):
                q, k, v = self._layer_qkv(W, W["layers"][li], hs[s],
                                          pos_ids[s])
                self._scatter_kv(s, li, slots[s], k[:, 0], v[:, 0])
                attns.append(paged_attention(
                    q[:, 0], self._kp[s][li], self._vp[s][li], tables_r[s],
                    lens_after[s])[:, None])
            hs = self._layer_tail(li, hs, attns)
        return self._gather_logits([x[:, 0] for x in self._head_logits(hs)])

    @staticmethod
    def _finish_eos(full, t0, eos_token_id):
        """Per-row EOS finishing: each row keeps its generated tokens up to
        and including its own first EOS; later columns are set to
        eos_token_id, and the array is trimmed to the longest surviving
        row. Shared by the host loop and the device loop."""
        if eos_token_id is None:
            return full
        gen = full[:, t0:]
        n = gen.shape[1]
        if n == 0:
            return full
        keep = []
        for row in gen:
            hit = np.flatnonzero(row == eos_token_id)
            keep.append(int(hit[0]) + 1 if hit.size else n)
        for i, k in enumerate(keep):
            gen[i, k:] = eos_token_id
        return full[:, :t0 + max(keep)]

    def _reset_kv(self):
        """Fresh zeroed pools (per shard, over its local kv heads) and
        allocator: a failed call may have left half-written pages, and
        every in-flight sequence's cache is gone. `k_pages` / `v_pages` are
        shard 0's per-layer pools."""
        L = self.cfg.num_hidden_layers
        shape = (self.n_pages, self.page_size, self.nh_kv_l, self.hd)
        self._kp, self._vp = ([[torch.zeros(shape, dtype=self.kv_dtype,
                                            device=d) for _ in range(L)]
                               for d in self.devices] for _ in range(2))
        self.k_pages, self.v_pages = self._kp[0], self._vp[0]
        self.allocator = PageAllocator(self.n_pages)

    # -- weight snapshots (the hot-swap substrate) ------------------------------
    # Derived entries are rebuilt at install, never serialized: the rope
    # tables and eps come from the config, "mk" is the reference's
    # megakernel repack (the port keeps its pack outside the dict)
    _DERIVED_WEIGHT_KEYS = ("cos", "sin", "eps", "mk")

    def export_weights(self):
        """The engine's serializable weight tree: the snapshot without its
        derived entries, in the reference's layout (`emb`, `head`, `layers`
        of per-layer dicts, `norm`; an int8 projection is an (int8, scales)
        pair). Under tp the shards join back into the full tensors. The
        tensors are the engine's own (no copy): install_weights rebinds,
        never writes them, so an export stays the old weights across a
        flip."""
        if self._tpc is not None:
            return self._tpc.join_weights(self._W, self._DERIVED_WEIGHT_KEYS)
        return {k: v for k, v in self.weights.items()
                if k not in self._DERIVED_WEIGHT_KEYS}

    def save_weights_snapshot(self, path, step=None):
        """Atomic CRC32-manifest save of the current weights (the artifact a
        later hot-swap loads and verifies)."""
        from ..distributed import checkpoint as ckpt
        ckpt.save_snapshot(self.export_weights(), path, step=step)
        return path

    def load_weights_snapshot(self, path):
        """Load + verify (CRC32, tree structure, per-leaf shapes) a snapshot
        against this engine's weight tree without installing it: fresh
        tensors of the engine's dtypes on its device. Raises
        CheckpointCorruptError before the engine is touched; the flip itself
        is install_weights."""
        from ..distributed import checkpoint as ckpt
        return ckpt.load_snapshot_for(self.export_weights(), path)

    def install_weights(self, new):
        """Flip the serving weights to `new` (an export_weights-shaped tree,
        e.g. from load_weights_snapshot). The engine's weight dicts are
        rebuilt around new's tensors (rebound, never copied into): engines
        built from one model share its parameter tensors, and an in-place
        write would flip all of them and the export a rollback returns to.
        The rope tables and eps stay; under tp the new tree is split over
        the shards again."""
        from ..distributed.checkpoint import tree_structure
        cur = {k: v for k, v in self.weights.items()
               if k not in self._DERIVED_WEIGHT_KEYS}  # shard 0's: the
        if tree_structure(cur) != tree_structure(new):  # same structure
            raise ValueError(
                "install_weights: snapshot tree structure does not match "
                "this engine's weights (different quant/layer layout?)")
        kept = {k: self.weights[k] for k in ("cos", "sin", "eps")}
        full = dict(new, **kept)
        if self._tpc is None:
            self._W = [full]
        else:
            # split_weights consumes its layer list: hand it a copy
            self._W = self._tpc.split_weights(
                dict(full, layers=list(full["layers"])))
        self.weights = self._W[0]
        return self

    # -- page claims ----------------------------------------------------------
    def _reclaim_pages(self, n):
        """Hook: free up to n idle pages (none here; the continuous-
        batching engine evicts prefix-cache pages)."""
        return 0

    def _claim_pages(self, b, need):
        """Claim `need` pages for each of b sequences, all or nothing.
        Returns (tables [b, max_pages] int32 numpy, per-sequence pages)."""
        if need * b > self.allocator.available:
            # idle cache-held pages (continuous-batching engines) are
            # reclaimable: try before declaring the pool full
            self._reclaim_pages(need * b - self.allocator.available)
        if need * b > self.allocator.available:
            raise EngineFullError(
                f"engine full: this call needs {need * b} KV pages "
                f"({b} sequences x {need} pages) but only "
                f"{self.allocator.available} of {self.allocator.n_pages} "
                "are free; finish or retire in-flight sequences first")
        tables = np.zeros((b, self.max_pages_per_seq), np.int32)
        seq_pages = []
        try:
            for i in range(b):
                pages = []
                seq_pages.append(pages)      # registered before filling, so
                for _ in range(need):        # a failing alloc frees the
                    pages.append(self.allocator.alloc())  # partial claim
                tables[i, :need] = pages
        except Exception:
            for pages in seq_pages:
                if pages:
                    self.allocator.free(pages)
            raise
        return tables, seq_pages

    def _pad_prompt(self, ids):
        t0 = ids.shape[1]
        t_pad = min(-(-t0 // self.page_size) * self.page_size, self.max_len)
        ids_pad = np.zeros((ids.shape[0], t_pad), np.int64)
        ids_pad[:, :t0] = ids
        return torch.as_tensor(ids_pad, device=self.device), t_pad

    # -- public -------------------------------------------------------------
    @torch.no_grad()
    def prefill_logits(self, input_ids):
        """Logits of the next token after each prompt, [b, V] float32 on
        the engine's device: one prefill into freshly claimed pages, which
        are released again. For checking the engine against a reference."""
        ids = _as_numpy(input_ids)
        b, t0 = ids.shape
        ids_t, t_pad = self._pad_prompt(ids)
        tables_np, seq_pages = self._claim_pages(b, t_pad // self.page_size)
        try:
            logits = self._prefill(
                ids_t, torch.as_tensor(tables_np, device=self.device), t0)
        finally:
            for pages in seq_pages:
                self.allocator.free(pages)
        return logits.float()

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens=32, eos_token_id=None,
                 do_sample=False, temperature=1.0, top_k=0, top_p=1.0,
                 seed=0, device_loop=False):
        """Decode with greedy or top-k/top-p sampling. input_ids: [b, t0]
        equal-length prompts. Returns [b, t0+n] int64 numpy.

        device_loop=True queues every decode step on the device with no
        host read-back until the end (the step count rounds up to a
        multiple of 32, so varying budgets share one loop shape, and pages
        are claimed through that length). All steps run; EOS trims the
        output afterwards. The host loop reads each token back and stops
        once every row has emitted EOS."""
        ids = _as_numpy(input_ids)
        b_real, t0 = ids.shape
        if b_real > self.max_batch:
            raise ValueError(
                f"batch of {b_real} prompts exceeds this engine's "
                f"max_batch={self.max_batch}; split the batch or build "
                "the engine with a larger max_batch")
        if t0 + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt length {t0} + max_new_tokens {max_new_tokens} "
                f"= {t0 + max_new_tokens} exceeds this engine's "
                f"max_len={self.max_len}")
        # pad the batch up to the nearest bucket; padded rows replay row 0
        # and are dropped before returning
        b = b_real
        if self._batch_buckets:
            b = next((x for x in self._batch_buckets if x >= b_real),
                     self.max_batch)
            if b != b_real:
                ids = np.concatenate(
                    [ids, np.repeat(ids[:1], b - b_real, axis=0)], axis=0)

        ids_t, t_pad = self._pad_prompt(ids)
        n_rest = max_new_tokens - 1
        n_loop = 0
        if device_loop and n_rest > 0:
            n_loop = min(-(-n_rest // LOOP_BUCKET) * LOOP_BUCKET,
                         self.max_len - t0 - 1)
        need = -(-max(t_pad, t0 + 1 + max(n_rest, n_loop))
                 // self.page_size)
        tables_np, seq_pages = self._claim_pages(b, need)
        # the reference's key flow: key(seed), then one split before every
        # token (the prefill token included); the device loop continues
        # the same chain
        key = sampling.key(seed, device=self.device)

        def draw(logits):
            nonlocal key
            if do_sample:
                key, sub = sampling.split(key)
            else:
                sub = None
            return _sample(logits, sub, do_sample, temperature, top_k, top_p)

        ok = False
        try:
            tables = torch.as_tensor(tables_np, device=self.device)
            logits = self._prefill(ids_t, tables, t0)
            tok = draw(logits)
            lens = torch.full((b,), t0, dtype=torch.int64,
                              device=self.device)
            if device_loop and n_rest > 0:
                toks = [tok]
                for _ in range(n_loop):
                    logits = self._step(tok, tables, lens)
                    tok = draw(logits)
                    lens = lens + 1
                    toks.append(tok)
                out = [torch.stack(toks, 1).cpu().numpy()[:, :1 + n_rest]]
            else:
                out = [tok.cpu().numpy()[:, None]]
                # per-row done mask: a row that hits its own EOS is done
                # even while other rows keep decoding
                done = np.zeros(b_real, bool)
                if eos_token_id is not None:
                    done |= out[-1][:b_real, 0] == eos_token_id
                for _ in range(n_rest):
                    if eos_token_id is not None and done.all():
                        break
                    logits = self._step(tok, tables, lens)
                    tok = draw(logits)
                    lens = lens + 1
                    out.append(tok.cpu().numpy()[:, None])
                    if eos_token_id is not None:
                        done |= out[-1][:b_real, 0] == eos_token_id
            ok = True
        finally:
            if ok:
                for pages in seq_pages:
                    self.allocator.free(pages)
            else:
                self._reset_kv()
        full = np.concatenate([ids] + out, axis=1)[:b_real]
        return self._finish_eos(full, t0, eos_token_id)


def _shard_devices(device, tp):
    """The engine's `device=` at tp > 1 as TPContext's devices: a list is
    taken as it is, None takes one CUDA card per shard, and the CPU runs
    every shard; a single CUDA device is refused (it would be one card per
    engine, not per shard: pass it tp times)."""
    if device is None or isinstance(device, (list, tuple)):
        return device
    if torch.device(device).type == "cpu":
        return [device] * tp
    raise ValueError(
        f"tp={tp} takes one device per shard: device=[{str(device)!r}] * "
        f"{tp} runs every shard on that card")


def _as_numpy(input_ids):
    if torch.is_tensor(input_ids):
        return input_ids.detach().cpu().numpy()
    return np.asarray(input_ids)
