"""Tensor-parallel serving: one engine over a list of devices, one shard
each.

Counterpart of `paddle_tpu/inference/tp.py`. The reference runs every
compiled serving dispatch under `shard_map` on a 1-D "mp" mesh; this port
is one process holding a list of `tp` torch devices (a device may repeat:
every shard on one card is the counterpart of the reference's mesh of
host devices), runs each shard's share of a step in turn, and plays the
collectives out as explicit functions over the list of per-shard tensors.

The split is the reference's:
  - attention heads and the paged-KV pools shard over heads: shard s holds
    q heads [s nh / tp, (s + 1) nh / tp) and the matching kv heads, and its
    own slice of every KV page. Page tables, lens and the allocator stay
    replicated host state;
  - wq / wk / wv and gate / up are column-parallel (output channels split,
    int8 per-channel scales along), wo and down are the row-parallel pair;
  - the lm_head is vocab-parallel when tp divides the vocab, else
    replicated.

Two tail modes:
  tp_mode="exact" (default): the row-parallel pair is reassembled, not
    reduced. Attention outputs are gathered over heads before a replicated
    o_proj, MLP activations over columns before a replicated down_proj, so
    every product runs at the unsharded shape on the unsharded values.
  tp_mode="psum": wo / wd rows are split, each shard computes a partial
    product and the partials are summed (`reduce`); tp_compress="int8"
    sums through `distributed.comm_compress.quantized_psum` (its residual
    is dropped: inference carries no state into a next step). The partial
    sums associate differently from the one-device product: the outputs are
    close, not identical.

Collectives over the shard list: a gather is a concatenation in shard
order, after a copy to each shard's device where the devices differ; a
reduce is a sum in shard order. Shards on one device share one gathered
tensor, and replicated weights on one device are one tensor (`.to` of a
tensor already there is the tensor itself).
"""
import torch

from .. import resolve_device
from ..distributed.comm_compress import quantized_psum
from .sampling import top_k

_COL = ("wq", "wk", "wv", "wg", "wu")    # column-parallel projections
_ROW = ("wo", "wd")                      # the row-parallel pair


def _width(w):
    return (w[0] if isinstance(w, tuple) else w).shape[1]


def _to(w, dev):
    """A replicated entry on `dev` (non-tensors pass through)."""
    if isinstance(w, tuple):
        return tuple(t.to(dev) for t in w)
    return w.to(dev) if torch.is_tensor(w) else w


class TPContext:
    """Devices, weight split and collectives of one tensor-parallel engine.

    tp: the shard count (the engine checks that it divides both head
      counts, so GQA groups never split).
    mode: "exact" | "psum" (module docstring).
    compress: None | "int8": quantize the psum-mode reduce (refused under
      "exact": there is no reduce to compress).
    devices: a list of at least tp torch devices (entries may repeat); the
      first tp are used. None takes cuda:0 ... cuda:tp-1 and raises when
      fewer CUDA devices are visible.
    """

    def __init__(self, tp, mode="exact", compress=None, devices=None):
        tp = int(tp)
        if tp < 2:
            raise ValueError(f"TPContext needs tp >= 2, got {tp}")
        if mode not in ("exact", "psum"):
            raise ValueError(
                f"tp_mode must be 'exact' or 'psum', got {mode!r}")
        if compress not in (None, "int8"):
            raise ValueError(
                f"tp_compress must be None or 'int8', got {compress!r}")
        if compress is not None and mode != "psum":
            raise ValueError(
                "tp_compress rides the per-token all-reduce, which only "
                "exists under tp_mode='psum' (the 'exact' mode gathers "
                "instead of reducing)")
        if devices is None:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            devs = [torch.device("cuda", i) for i in range(n)]
        else:
            devs = [resolve_device(d) for d in devices]
        if len(devs) < tp:
            raise ValueError(
                f"tp={tp} needs {tp} devices but only {len(devs)} are "
                f"given or visible; pass them explicitly: device=['cuda:0'] "
                f"* {tp} runs every shard on one card, device='cpu' runs "
                "the plain versions on the CPU")
        self.tp = tp
        self.mode = mode
        self.compress = compress
        self.devices = devs[:tp]
        # set by split_weights: the lm_head is vocab-parallel when tp
        # divides the vocab
        self.head_sharded = False

    # -- weights -------------------------------------------------------------
    def _cols(self, w, key, s, dev):
        """Shard s's output channels of a column-parallel weight [k, n] (an
        int8 pair slices its per-channel scales along), contiguous on dev."""
        n = _width(w)
        if n % self.tp:
            raise ValueError(
                f"tp={self.tp} must divide the output width {n} of the "
                f"column-parallel {key} (each shard holds an equal slice)")
        sl = slice(s * (n // self.tp), (s + 1) * (n // self.tp))
        if isinstance(w, tuple):
            return (w[0][:, sl].contiguous().to(dev),
                    w[1][sl].contiguous().to(dev))
        return w[:, sl].contiguous().to(dev)

    def _rows(self, w, s, dev):
        """Shard s's input rows of a row-parallel weight (psum mode); the
        per-output-channel scales of an int8 pair stay whole."""
        k = (w[0] if isinstance(w, tuple) else w).shape[0]
        sl = slice(s * (k // self.tp), (s + 1) * (k // self.tp))
        if isinstance(w, tuple):
            return (w[0][sl].to(dev), w[1].to(dev))
        return w[sl].to(dev)

    def split_weights(self, weights):
        """One weight dict per shard from an engine snapshot (`layers` of
        per-layer dicts, the head, norms, embedding, rope tables, eps):
        column slices of wq / wk / wv / wg / wu, the row pair replicated
        ("exact") or row-split ("psum"), the head vocab-parallel when tp
        divides the vocab, everything else replicated. Consumes the
        snapshot layer by layer (its unsplit layers are dropped as they
        are split), so the engine never holds the column weights twice."""
        self.head_sharded = _width(weights["head"]) % self.tp == 0
        shards = [{} for _ in self.devices]
        for key, val in weights.items():
            if key == "layers":
                continue
            for s, dev in enumerate(self.devices):
                shards[s][key] = (self._cols(val, key, s, dev)
                                  if key == "head" and self.head_sharded
                                  else _to(val, dev))
        layers = weights["layers"]
        for s in range(self.tp):
            shards[s]["layers"] = []
        for li in range(len(layers)):
            ws, layers[li] = layers[li], None
            for s, dev in enumerate(self.devices):
                shards[s]["layers"].append({
                    key: (self._cols(w, key, s, dev) if key in _COL else
                          self._rows(w, s, dev)
                          if key in _ROW and self.mode == "psum"
                          else _to(w, dev))
                    for key, w in ws.items()})
        return shards

    # -- collectives over the shard list ---------------------------------------
    def _per_device(self, make):
        """[make(dev) for each shard's device], made once per distinct
        device (shards on one device share the result)."""
        made = {}
        for d in self.devices:
            if str(d) not in made:
                made[str(d)] = make(d)
        return [made[str(d)] for d in self.devices]

    def replicate(self, x):
        """x on every shard's device."""
        return self._per_device(lambda d: x.to(d))

    def _gather(self, xs, dim):
        return self._per_device(
            lambda d: torch.cat([x.to(d) for x in xs], dim=dim))

    def gather_heads(self, xs):
        """[..., nh_l, hd] per shard -> [..., nh, hd] on every shard, heads
        in shard (= original head) order: data movement only."""
        return self._gather(xs, -2)

    def gather_cols(self, xs):
        """[..., cols_l] per shard -> [..., cols] on every shard (the
        exact-mode MLP activation reassembly, and the vocab-parallel
        logits)."""
        return self._gather(xs, -1)

    def reduce(self, xs):
        """The psum-mode sum of the shards' partial products, on every
        shard: a sum in shard order, or with compress="int8" the two-stage
        quantized all-reduce (residual dropped)."""
        if self.compress == "int8":
            ys, _ = quantized_psum(xs)
            return ys
        acc = xs[0]
        for x in xs[1:]:
            acc = acc + x.to(acc.device)
        return self.replicate(acc)

    def argmax_of_local_max(self, maxv, arg, v_local):
        """The global greedy token from per-shard (max logit, local argmax)
        pairs of the vocab-parallel head: the first shard holding the
        global max wins (argmax's first-max rule over the shard-ordered
        logits), plus its vocab base. On the first shard's device, int64;
        equal to argmax over the gathered logits bit for bit."""
        d = self.devices[0]
        ms = torch.stack([m.to(d) for m in maxv])
        ags = torch.stack([a.to(d).long() for a in arg])
        s = ms.argmax(0)
        return ags.gather(0, s[None])[0] + s * int(v_local)

    def topk_of_local_topk(self, topv, topi, v_local, k):
        """The global top-k (values descending, ties to the lower vocab id)
        from per-shard top-k lists of the vocab-parallel head: local ids
        offset by each shard's vocab base, then a stable top-k of the
        shard-major concatenation. Shards concatenate in vocab order and
        each list is already (value desc, id asc), so this is the top-k of
        the gathered logits bit for bit. On the first shard's device."""
        d = self.devices[0]
        vs = torch.cat([v.to(d) for v in topv], dim=-1)
        gids = torch.cat([i.to(d).long() + s * int(v_local)
                          for s, i in enumerate(topi)], dim=-1)
        gv, gpos = top_k(vs, k)
        return gv, gids.gather(-1, gpos)
