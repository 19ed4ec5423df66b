"""Multi-LoRA adapter serving: a paged adapter pool beside the KV pool.

Counterpart of `paddle_tpu/inference/adapters.py`. LoRA A/B factors live
in a page-granular pool with the KV pool's allocator discipline
(refcounted pages through `serving.PageAllocator`, LRU eviction of idle
adapters, typed `AdapterFullError` backpressure), and every prefill chunk,
decode step and verify pass that carries an adapter request applies

    y += where(aid > 0, (x . A[aid]) * (alpha / r) . B[aid], 0)

after the q/k/v/gate/up/down projections (`ops/lora.py`: the plain einsum
pair on the CPU, the hand-written `csrc/lora_bgmv.cu` on CUDA). The delta
of a row depends only on that row, its adapter and the factors, so a mixed
batch gives each adapter's requests the bits of a dedicated engine, and
the where-gate keeps an adapter-free row's bits (a `-0.0` included).

Adapters deploy as a registry write: `save_adapter` / `load_adapter_file`
keep the reference's directory format (one `leaf_<i>.npy` per factor in
the reference's leaf order, a `manifest.json` with their CRC32s, and the
`adapter.json` metadata), verified against the pool's geometry before
anything installs; files written by either package load in the other.

Tensor parallelism (tp_mode="exact" only): B of q/k/v/gate/up is
column-sharded like the projection it corrects; A (fed by the replicated
post-norm activations) and the down pair stay replicated (`specs()`), so
each shard's delta runs at its projection's own sharded width.
"""
import collections
import json
import os
import shutil
import uuid
import zlib

import numpy as np
import torch

# LoRA targets: the projections whose outputs take a low-rank delta (o_proj
# is deliberately absent, as in the reference)
ADAPTER_TARGETS = ("wq", "wk", "wv", "wg", "wu", "wd")
_COL = frozenset(("wq", "wk", "wv", "wg", "wu"))   # column-parallel targets


class AdapterError(RuntimeError):
    """Base of the adapter subsystem's typed errors."""


class AdapterFullError(AdapterError):
    """Backpressure: every installed adapter is referenced by live requests
    (or pinned), so nothing is LRU-evictable. Nothing was installed."""


class AdapterCorruptError(AdapterError):
    """An adapter file failed CRC / shape / metadata verification; it was
    rejected before anything touched the pool."""


class UnknownAdapterError(AdapterError, KeyError):
    """An adapter name this engine has never loaded (and that is not in its
    registry for a lazy hot-load)."""

    def __str__(self):              # KeyError repr-quotes its arg
        return self.args[0] if self.args else ""


def target_dims(hidden, ffn, nh, nh_kv, hd):
    """(in_dim, out_dim) per LoRA target of one transformer layer: the shape
    contract a pool verifies adapter files against."""
    return {"wq": (hidden, nh * hd), "wk": (hidden, nh_kv * hd),
            "wv": (hidden, nh_kv * hd), "wg": (hidden, ffn),
            "wu": (hidden, ffn), "wd": (ffn, hidden)}


def engine_target_dims(cfg):
    """target_dims from a LlamaConfig."""
    nh = cfg.num_attention_heads
    hd = cfg.hidden_size // nh
    nh_kv = getattr(cfg, "num_key_value_heads", nh) or nh
    return target_dims(cfg.hidden_size, cfg.intermediate_size, nh, nh_kv, hd)


def make_lora_adapter(cfg, rank=4, alpha=None, seed=0,
                      targets=ADAPTER_TARGETS, init_std=0.5):
    """A random LoRA adapter for `cfg` (both factors random, so the delta is
    nonzero), drawn from numpy's RandomState(seed) in the reference's order:
    the same seed gives the reference's factors. Returns {"meta": {...},
    "layers": [{target: {"a": [in, r], "b": [r, out]}}]} of f32 numpy
    arrays."""
    rng = np.random.RandomState(seed)
    dims = engine_target_dims(cfg)
    layers = []
    for _ in range(cfg.num_hidden_layers):
        lay = {}
        for t in targets:
            din, dout = dims[t]
            lay[t] = {
                "a": (rng.randn(din, rank) * init_std).astype(np.float32),
                "b": (rng.randn(rank, dout) * init_std).astype(np.float32),
            }
        layers.append(lay)
    meta = {"rank": int(rank),
            "alpha": float(alpha if alpha is not None else 2 * rank),
            "targets": list(targets),
            "layers": int(cfg.num_hidden_layers),
            "dims": {t: list(dims[t]) for t in targets}}
    return {"meta": meta, "layers": layers}


_META_FILE = "adapter.json"
_MANIFEST = "manifest.json"


def _leaves(layers):
    """The factor arrays in the reference's leaf order (its pytree flattening
    of {"layers": [...]}: layers in order, each layer's targets sorted by
    name, "a" before "b"), with the treedef string of that tree."""
    out, parts = [], []
    for lay in layers:
        keys = sorted(lay)
        parts.append("{" + ", ".join(f"'{t}': {{'a': *, 'b': *}}"
                                     for t in keys) + "}")
        for t in keys:
            out.append(lay[t]["a"])
            out.append(lay[t]["b"])
    return out, "PyTreeDef({'layers': [" + ", ".join(parts) + "]})"


def _crc(arr):
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def save_adapter(path, adapter, step=None):
    """Persist an adapter: every factor as `leaf_<i>.npy` plus a
    `manifest.json` with their CRC32s, written into a temporary sibling
    directory and committed by one rename (a crash leaves the previous
    directory or the new one, never a mix), then the `adapter.json`
    metadata inside the committed directory. The layout is the reference's
    `checkpoint.save_snapshot`, so either package loads the other's files."""
    leaves, treedef = _leaves(adapter["layers"])
    host = [np.asarray(x.detach().cpu() if torch.is_tensor(x) else x)
            for x in leaves]
    path = os.path.abspath(path)
    parent = os.path.dirname(path) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    os.makedirs(tmp)
    try:
        for i, arr in enumerate(host):
            np.save(os.path.join(tmp, f"leaf_{i}.npy"), arr)
        manifest = {"format": 1, "n_leaves": len(host), "step": step,
                    "treedef": treedef,
                    "checksums": [_crc(a) for a in host]}
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(path):
            old = f"{path}.old-{uuid.uuid4().hex[:8]}"
            os.rename(path, old)
            try:
                os.rename(tmp, path)
            except BaseException:
                os.rename(old, path)
                raise
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    with open(os.path.join(path, _META_FILE), "w") as f:
        json.dump(adapter["meta"], f)
    return path


def load_adapter_file(path, expect_dims=None, expect_layers=None):
    """Load and verify an adapter directory: the metadata first (layer count
    and per-target dims against `expect_layers` / `expect_dims`, so a
    wrong-model adapter fails naming its dims), then every factor against
    the manifest's CRC32 and the shape the metadata implies. Every failure
    raises AdapterCorruptError and touches nothing."""
    try:
        with open(os.path.join(path, _META_FILE)) as f:
            meta = json.load(f)
    except (OSError, ValueError) as e:
        raise AdapterCorruptError(
            f"adapter {path!r}: unreadable metadata "
            f"({type(e).__name__}: {e})") from e
    try:
        rank = int(meta["rank"])
        targets = list(meta["targets"])
        n_layers = int(meta["layers"])
        dims = {t: tuple(int(x) for x in meta["dims"][t]) for t in targets}
    except (KeyError, TypeError, ValueError) as e:
        raise AdapterCorruptError(
            f"adapter {path!r}: malformed metadata {meta!r}") from e
    if expect_layers is not None and n_layers != int(expect_layers):
        raise AdapterCorruptError(
            f"adapter {path!r} has {n_layers} layers, this engine serves "
            f"{expect_layers}")
    if expect_dims is not None:
        for t in targets:
            if t not in expect_dims or dims[t] != tuple(expect_dims[t]):
                raise AdapterCorruptError(
                    f"adapter {path!r} target {t!r} dims {dims.get(t)} do "
                    f"not match this engine's "
                    f"{tuple(expect_dims.get(t, ()))}")
    like = [{t: {"a": (dims[t][0], rank), "b": (rank, dims[t][1])}
             for t in targets} for _ in range(n_layers)]
    shapes, _ = _leaves(like)
    try:
        with open(os.path.join(path, _MANIFEST)) as f:
            manifest = json.load(f)
        n = int(manifest["n_leaves"])
        sums = manifest.get("checksums")
    except (OSError, ValueError, KeyError, TypeError) as e:
        raise AdapterCorruptError(
            f"adapter {path!r} failed snapshot verification: unreadable "
            f"manifest ({type(e).__name__}: {e})") from e
    if n != len(shapes):
        raise AdapterCorruptError(
            f"adapter {path!r} failed snapshot verification: checkpoint has "
            f"{n} leaves, target {len(shapes)}")
    arrs = []
    for i, shape in enumerate(shapes):
        try:
            a = np.load(os.path.join(path, f"leaf_{i}.npy"))
        except Exception as e:
            # a torn .npy header dies inside np.load before the CRC walk
            raise AdapterCorruptError(
                f"adapter {path!r} unreadable ({type(e).__name__}: "
                f"{e})") from e
        if sums is not None and _crc(a) != sums[i]:
            raise AdapterCorruptError(
                f"adapter {path!r} failed snapshot verification: leaf {i} "
                f"checksum mismatch (manifest {sums[i]:#010x}, file "
                f"{_crc(a):#010x})")
        if tuple(a.shape) != tuple(shape):
            raise AdapterCorruptError(
                f"adapter {path!r} failed snapshot verification: leaf {i} "
                f"shape {tuple(a.shape)} does not match {tuple(shape)}")
        arrs.append(a)
    it = iter(arrs)
    layers = []
    for _ in range(n_layers):
        lay = {}
        for t in sorted(targets):
            lay[t] = {"a": next(it), "b": next(it)}
        layers.append(lay)
    return {"meta": meta, "layers": layers}


class AdapterPool:
    """Page-granular device pool of LoRA factor stacks.

    Device layout (`device`, shard 0's; `shards`, one per tensor-parallel
    shard): {"a": [per-layer {target: [C+1, in, r] f32}], "b": [per-layer
    {target: [C+1, r, out] f32}], "scale": [C+1] f32}. Slot 0 is the zero
    adapter (aid 0 = no adapter; its rows are where-gated out anyway). C =
    pool_pages // pages_per_adapter, an adapter's page bill being its factor
    elements at `page_elems` per page, kept on a `serving.PageAllocator`.

    Lifecycle: `install` claims pages and a slot (LRU-evicting an idle,
    unpinned adapter when full; AdapterFullError changes nothing);
    `acquire` / `release` count live requests per adapter (an acquired
    adapter is never evicted); `evict` zeroes the slot and frees it.
    """

    def __init__(self, n_layers, dims, rank, pool_pages=None, max_adapters=4,
                 page_elems=8192, targets=ADAPTER_TARGETS, device="cpu"):
        from .serving import PageAllocator
        self.rank = int(rank)
        if self.rank < 1:
            raise ValueError(f"adapter rank must be >= 1, got {rank}")
        self.n_layers = int(n_layers)
        self.targets = tuple(targets)
        self.dims = {t: tuple(dims[t]) for t in self.targets}
        self.page_elems = int(page_elems)
        per_layer = sum(din * self.rank + self.rank * dout
                        for (din, dout) in self.dims.values())
        self.elems_per_adapter = per_layer * self.n_layers
        self.pages_per_adapter = max(
            1, -(-self.elems_per_adapter // self.page_elems))
        if pool_pages is None:
            pool_pages = int(max_adapters) * self.pages_per_adapter
        self.n_pages = int(pool_pages)
        self.capacity = self.n_pages // self.pages_per_adapter
        if self.capacity < 1:
            raise ValueError(
                f"adapter pool of {self.n_pages} pages cannot hold one "
                f"adapter ({self.pages_per_adapter} pages at rank "
                f"{self.rank}); raise pool_pages/page_elems")
        self.allocator = PageAllocator(self.n_pages)
        dev = torch.device(device)
        C1, r = self.capacity + 1, self.rank
        self.device = {
            "a": [{t: torch.zeros((C1, d[0], r), device=dev)
                   for t, d in self.dims.items()}
                  for _ in range(self.n_layers)],
            "b": [{t: torch.zeros((C1, r, d[1]), device=dev)
                   for t, d in self.dims.items()}
                  for _ in range(self.n_layers)],
            "scale": torch.zeros((C1,), device=dev),
        }
        self.shards = [self.device]
        self._tp = 1
        self._slots = {}                       # name -> slot (1..C)
        self._pages = {}                       # name -> [page ids]
        self._free_slots = list(range(self.capacity, 0, -1))
        self._active = collections.Counter()   # name -> live request refs
        self._lru = collections.OrderedDict()  # name -> None (LRU order)
        self._pinned = set()                   # names exempt from LRU
        self._alpha = {}                       # name -> alpha
        # lifetime counters (health()/telemetry surface)
        self.loads = 0
        self.evictions = 0
        self.load_errors = 0
        self.last_load_ms = 0.0

    # -- tensor-parallel placement ------------------------------------------
    def specs(self):
        """Which stacks shard, mirroring `device`: "cols" for the B stacks
        of the column-parallel targets (their out axis splits like the
        projection's), None (replicated) for the A stacks, the down pair
        and the scales. The reference's PartitionSpec tree, by name."""
        return {
            "a": [{t: None for t in self.dims} for _ in range(self.n_layers)],
            "b": [{t: ("cols" if t in _COL else None) for t in self.dims}
                  for _ in range(self.n_layers)],
            "scale": None,
        }

    def place(self, tpc):
        """One stack dict per shard of `tpc` (an inference.tp.TPContext, or
        None for one device): column slices of the sharded B stacks,
        replicated stacks shared by the shards of one device. Later
        installs write every shard."""
        if tpc is None:
            return self
        self._tp = tpc.tp
        master = self.device
        rep = {}

        def replicated(key, t, li, d):
            k = (key, t, li, str(d))
            if k not in rep:
                src = master["scale"] if key == "scale" else master[key][li][t]
                rep[k] = src.to(d)
            return rep[k]

        shards = []
        for s, d in enumerate(tpc.devices):
            sh = {"a": [], "b": [], "scale": replicated("scale", None, None, d)}
            for li in range(self.n_layers):
                sh["a"].append({t: replicated("a", t, li, d)
                                for t in self.dims})
                bl = {}
                for t in self.dims:
                    if t in _COL:
                        n = self.dims[t][1] // self._tp
                        bl[t] = master["b"][li][t][:, :, s * n:(s + 1) * n] \
                            .contiguous().to(d)
                    else:
                        bl[t] = replicated("b", t, li, d)
                sh["b"].append(bl)
            shards.append(sh)
        self.shards = shards
        self.device = shards[0]
        return self

    def _write(self, slot, layers, rank, scale):
        """Write one slot of every shard's stacks: `layers` (the adapter's
        per-layer factors, or None to zero the slot) and the scale. Stacks
        shared by several shards are written once."""
        done = set()

        def put(dst, src):
            if id(dst) in done:
                return
            done.add(id(dst))
            if src is None:
                dst[slot].zero_()
            else:
                dst[slot].zero_()
                dst[slot][tuple(slice(0, n) for n in src.shape)].copy_(
                    src.to(dst.device))

        for li in range(self.n_layers):
            lay = None if layers is None else layers[li]
            for t in self.dims:
                fac = None if lay is None else lay.get(t)
                a = b = None
                if fac is not None:
                    a = torch.as_tensor(np.asarray(fac["a"], np.float32))
                    b = torch.as_tensor(np.asarray(fac["b"], np.float32))
                for s, sh in enumerate(self.shards):
                    put(sh["a"][li][t], a)
                    bs = b
                    if b is not None and t in _COL and self._tp > 1:
                        n = self.dims[t][1] // self._tp
                        bs = b[:, s * n:(s + 1) * n]
                    put(sh["b"][li][t], bs)
        for sh in self.shards:
            if id(sh["scale"]) not in done:
                done.add(id(sh["scale"]))
                sh["scale"][slot] = scale

    # -- install / evict ----------------------------------------------------
    def has(self, name):
        return name in self._slots

    def names(self):
        return list(self._slots)

    def slot(self, name):
        """Pool slot id of a loaded adapter (LRU-touched: slot reads are the
        use signal eviction ranks by)."""
        s = self._slots.get(name)
        if s is None:
            raise UnknownAdapterError(
                f"adapter {name!r} is not loaded "
                f"(loaded: {sorted(self._slots)})")
        self._lru.move_to_end(name)
        return s

    def install(self, name, adapter):
        """Install a verified adapter dict under `name`; returns the pool
        slot. Shapes and rank are verified against the pool geometry first
        (AdapterCorruptError, nothing claimed); a full pool LRU-evicts one
        idle adapter, or raises AdapterFullError when every installed one is
        busy or pinned. Any failure after the claim returns the pages and
        the slot (zeroed), so the pool never loses capacity."""
        meta = adapter.get("meta") or {}
        rank = int(meta.get("rank", self.rank))
        if rank > self.rank:
            raise AdapterCorruptError(
                f"adapter {name!r} rank {rank} exceeds the pool's rank "
                f"{self.rank} (rebuild the engine with a larger adapters= "
                "rank)")
        layers = adapter["layers"]
        if len(layers) != self.n_layers:
            raise AdapterCorruptError(
                f"adapter {name!r} has {len(layers)} layers, pool serves "
                f"{self.n_layers}")
        for li, lay in enumerate(layers):
            for t, fac in lay.items():
                if t not in self.dims:
                    raise AdapterCorruptError(
                        f"adapter {name!r} layer {li} names unknown target "
                        f"{t!r} (pool targets: {self.targets})")
                din, dout = self.dims[t]
                a_shape = tuple(np.shape(fac["a"]))
                b_shape = tuple(np.shape(fac["b"]))
                if a_shape != (din, rank) or b_shape != (rank, dout):
                    raise AdapterCorruptError(
                        f"adapter {name!r} layer {li} target {t!r} shapes "
                        f"a{a_shape}/b{b_shape} do not match pool dims "
                        f"({din}, {rank})/({rank}, {dout})")
        if name in self._slots:
            if self._active[name]:
                raise AdapterError(
                    f"adapter {name!r} is already loaded with "
                    f"{self._active[name]} live request(s) — evict is only "
                    "safe once they retire (load under a new name to roll a "
                    "fine-tune forward)")
            self.evict(name)            # idle reinstall = registry update
        if not self._free_slots:
            victim = next((n for n in self._lru
                           if not self._active[n] and n not in self._pinned),
                          None)
            if victim is None:
                raise AdapterFullError(
                    f"adapter pool full: {len(self._slots)} adapters "
                    f"installed ({self.capacity} slots), every one has live "
                    "requests or is pinned — retry after retirements (or "
                    "unpin)")
            self.evict(victim)
        slot = self._free_slots.pop()
        pages = []
        try:
            for _ in range(self.pages_per_adapter):
                pages.append(self.allocator.alloc())
        except Exception:
            if pages:
                self.allocator.free(pages)
            self._free_slots.append(slot)
            raise
        alpha = float(meta.get("alpha", 2.0 * rank))
        try:
            self._write(slot, layers, rank, alpha / rank)
        except Exception:
            self.allocator.free(pages)
            try:
                # zero whatever landed before re-offering the slot: a later
                # lower-rank install would read this one's rank tail
                self._write(slot, None, rank, 0.0)
                self._free_slots.append(slot)
            except Exception:
                pass                    # cannot zero: burn the slot
            raise
        self._slots[name] = slot
        self._pages[name] = pages
        self._lru[name] = None
        self._alpha[name] = alpha
        self.loads += 1
        return slot

    def evict(self, name, force=False):
        """Free an adapter's slot and pages (the slot zeroed). Refuses
        (typed) while live requests hold it or it is pinned, unless
        force=True (engine teardown)."""
        slot = self._slots.get(name)
        if slot is None:
            raise UnknownAdapterError(f"adapter {name!r} is not loaded")
        if self._active[name] and not force:
            raise AdapterError(
                f"adapter {name!r} has {self._active[name]} live "
                "request(s); evict after they retire")
        if name in self._pinned and not force:
            raise AdapterError(
                f"adapter {name!r} is pinned (affinity placement); unpin "
                "before evicting")
        self._write(slot, None, self.rank, 0.0)
        self.allocator.free(self._pages.pop(name))
        del self._slots[name]
        self._lru.pop(name, None)
        self._alpha.pop(name, None)
        self._active.pop(name, None)
        self._pinned.discard(name)
        self._free_slots.append(slot)
        self.evictions += 1
        return slot

    def pin(self, name):
        """Exempt a loaded adapter from LRU eviction."""
        if name not in self._slots:
            raise UnknownAdapterError(
                f"adapter {name!r} is not loaded "
                f"(loaded: {sorted(self._slots)})")
        self._pinned.add(name)

    def unpin(self, name):
        self._pinned.discard(name)

    # -- request refcounts --------------------------------------------------
    def acquire(self, name):
        if name not in self._slots:
            raise UnknownAdapterError(
                f"adapter {name!r} is not loaded "
                f"(loaded: {sorted(self._slots)})")
        self._active[name] += 1
        self._lru.move_to_end(name)

    def release(self, name):
        if self._active.get(name, 0) > 0:
            self._active[name] -= 1

    def active(self, name):
        return self._active.get(name, 0)

    # -- observability ------------------------------------------------------
    def stats(self):
        return {
            "loaded": len(self._slots),
            "capacity": self.capacity,
            "rank": self.rank,
            "pages_total": self.n_pages,
            "pages_free": self.allocator.available,
            "pages_per_adapter": self.pages_per_adapter,
            "loads": self.loads,
            "evictions": self.evictions,
            "load_errors": self.load_errors,
            "pinned": sorted(self._pinned),
            "active": {n: c for n, c in self._active.items() if c},
        }
