"""Multi-LoRA adapter serving of paddle_tpu_torch against the JAX package.

Replays tests/test_adapters.py's engine-level cases (the pool's lifecycle,
the adapter files, the mixed-batch identity matrix, lifecycle under load,
preemption) against the port's ContinuousBatchingEngine(adapters=...,
device="cpu"), on the reference's micro geometry (1 layer, hidden 32, ffn
64, 4 heads over 2 kv heads: a whole GQA group per shard at tp = 2), f32,
identical weights carried over by name, adapters drawn by the port's
`make_lora_adapter` from the reference's seeds (the same numpy draws).

Exact (bits): every greedy id. A mixed batch (two adapters and a base
request) equals, per request, the port's dedicated single-adapter engine,
the port's engine with no pool at all, and the JAX engine's mixed batch on
the same weights and adapters; over decode_block 1 / 8, speculate 4,
tp 2, an int8 base, megakernel "layer" / "multi" (their adapter
dispatches fall back to the op chain, counted) and the crossed cells. The
JAX engine's ids are computed once per cell kind in a module fixture (the
reference pins them equal across its cells, so the crossed cells compare
with its plain run of the same base weights). Files: a directory written
by either package's `save_adapter` loads in the other with every factor
equal. Tolerance: `lora_delta`'s plain version against the reference's on
the same numpy inputs, f32, rtol 1e-5 / atol 1e-6 (two einsum
implementations sum in different orders).
"""
import glob
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import adapters as jad
from paddle_tpu.inference.scheduler import \
    ContinuousBatchingEngine as JaxEngine
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch import failsafe
from paddle_tpu_torch.convert import load_numpy_params
from paddle_tpu_torch.inference.adapters import (AdapterCorruptError,
                                                 AdapterError,
                                                 AdapterFullError,
                                                 AdapterPool,
                                                 UnknownAdapterError,
                                                 engine_target_dims,
                                                 load_adapter_file,
                                                 make_lora_adapter,
                                                 save_adapter)
from paddle_tpu_torch.inference.scheduler import ContinuousBatchingEngine
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops.lora import lora_delta

torch.set_num_threads(1)

ENGINE_KW = dict(max_len=64, page_size=8, max_batch=4, prefill_chunk=8)
POOL = {"rank": 4}
MICRO = dict(num_hidden_layers=1, hidden_size=32, intermediate_size=64,
             num_attention_heads=4, num_key_value_heads=2)
_PAIR = {}


@pytest.fixture(autouse=True)
def _clean_faults():
    failsafe.reset()
    yield
    failsafe.reset()


def _pair():
    """(JAX model, port model, port cfg) with identical weights."""
    if not _PAIR:
        paddle.seed(3)
        jm = JaxLlama(JaxConfig.tiny(**MICRO))
        tm = LlamaForCausalLM(LlamaConfig.tiny(**MICRO), device="cpu")
        load_numpy_params(tm, {n: np.asarray(p.data)
                               for n, p in jm.named_parameters()})
        _PAIR["m"] = (jm, tm, tm.config)
    return _PAIR["m"]


@pytest.fixture(scope="module")
def tiny():
    _, tm, cfg = _pair()
    return tm, cfg


@pytest.fixture(scope="module")
def adapters(tiny):
    _, cfg = tiny
    return (make_lora_adapter(cfg, rank=4, seed=1),
            make_lora_adapter(cfg, rank=4, seed=2))


def _stream(cfg, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab_size, (t,)).astype(np.int64)
            for t in (9, 5, 12)]


def _mk(model, **kw):
    return ContinuousBatchingEngine(model, device="cpu", **kw)


def _dedicated(model, ad, prompt, mnt=6, **over):
    e = _mk(model, adapters=POOL, **dict(ENGINE_KW, **over))
    e.load_adapter("only", ad)
    u = e.add_request(prompt, mnt, adapter="only")
    e.drain()
    return e.result(u)


def _mixed_run(eng, ad1, ad2, prompts):
    eng.load_adapter("a1", ad1)
    eng.load_adapter("a2", ad2)
    uids = [eng.add_request(prompts[0], 6, adapter="a1"),
            eng.add_request(prompts[1], 6, adapter="a2"),
            eng.add_request(prompts[2], 6)]
    eng.drain()
    return [eng.result(u) for u in uids]


def _mixed(model, ad1, ad2, prompts, **over):
    eng = _mk(model, adapters=POOL, **dict(ENGINE_KW, **over))
    return _mixed_run(eng, ad1, ad2, prompts), eng


JAX_CELLS = {"plain": {}, "k8": dict(decode_block=8),
             "spec4": dict(speculate=4), "tp2": dict(tp=2),
             "int8": dict(quant="int8"),
             "multi": dict(megakernel="multi", decode_block=8)}


@pytest.fixture(scope="module")
def jax_mixed(adapters):
    """The JAX engine's mixed-batch ids per cell kind (the reference's own
    adapters, drawn from the same seeds), and its no-pool stream."""
    jm, _, cfg = _pair()
    jads = (jad.make_lora_adapter(cfg, rank=4, seed=1),
            jad.make_lora_adapter(cfg, rank=4, seed=2))
    for a, b in zip(jads, adapters):
        np.testing.assert_array_equal(a["layers"][0]["wq"]["a"],
                                      b["layers"][0]["wq"]["a"])
    out = {}
    for name, over in JAX_CELLS.items():
        eng = JaxEngine(jm, adapters=POOL, **dict(ENGINE_KW, **over))
        out[name] = _mixed_run(eng, *jads, _stream(cfg))
    out["base"] = JaxEngine(jm, **ENGINE_KW).generate_many(
        _stream(cfg), max_new_tokens=6)
    return out


# -- the delta ------------------------------------------------------------------
def test_lora_delta_plain_matches_reference():
    """Tolerance (f32, rtol 1e-5, atol 1e-6): the port's plain grouped delta
    against the reference's `lora_delta` on the same numpy inputs, rows of
    three adapters and slot 0 mixed, t = 3 rows per slot."""
    rng = np.random.RandomState(4)
    x = rng.randn(5, 3, 32).astype(np.float32)
    a = rng.randn(4, 32, 8).astype(np.float32)
    b = rng.randn(4, 8, 48).astype(np.float32)
    aid = np.asarray([1, 0, 3, 2, 1], np.int32)
    scale = np.asarray([0.5, 0.0, 2.0, 1.0, 0.5], np.float32)
    want = np.asarray(jad.lora_delta(x, a, b, aid, scale))
    got = lora_delta(*(torch.from_numpy(v) for v in (x, a, b, aid, scale)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


# -- pool units -----------------------------------------------------------------
class TestPoolUnits:
    def test_install_pages_and_slots(self, tiny, adapters):
        _, cfg = tiny
        pool = AdapterPool(1, engine_target_dims(cfg), rank=4, max_adapters=2)
        free0 = pool.allocator.available
        s1 = pool.install("a", adapters[0])
        assert s1 >= 1                  # slot 0 is the zero adapter
        assert pool.allocator.available == free0 - pool.pages_per_adapter
        np.testing.assert_array_equal(
            pool.device["a"][0]["wq"][s1].numpy(),
            adapters[0]["layers"][0]["wq"]["a"])
        pool.evict("a")
        assert pool.allocator.available == free0
        assert not pool.device["a"][0]["wq"][s1].any()   # zeroed

    def test_lru_evicts_idle_full_pool_raises(self, tiny, adapters):
        _, cfg = tiny
        pool = AdapterPool(1, engine_target_dims(cfg), rank=4, max_adapters=2)
        pool.install("x0", adapters[0])
        pool.install("x1", adapters[1])
        pool.slot("x1")                 # touch: x0 becomes LRU
        pool.install("x2", adapters[0])
        assert not pool.has("x0") and pool.has("x1") and pool.has("x2")
        assert pool.evictions == 1
        pool.acquire("x1")
        pool.acquire("x2")
        with pytest.raises(AdapterFullError):
            pool.install("x3", adapters[1])
        pool.release("x1")
        pool.install("x3", adapters[1])     # x1 idle again -> evictable
        assert pool.has("x3")

    def test_busy_and_pinned_adapter_never_evicted(self, tiny, adapters):
        _, cfg = tiny
        pool = AdapterPool(1, engine_target_dims(cfg), rank=4)
        pool.install("a", adapters[0])
        pool.acquire("a")
        with pytest.raises(AdapterError):
            pool.evict("a")
        pool.release("a")
        pool.pin("a")
        with pytest.raises(AdapterError):
            pool.evict("a")
        pool.unpin("a")
        pool.evict("a")
        assert pool.stats()["loaded"] == 0

    def test_rank_and_shape_verified(self, tiny, adapters):
        _, cfg = tiny
        pool = AdapterPool(1, engine_target_dims(cfg), rank=2)
        with pytest.raises(AdapterCorruptError):
            pool.install("big", adapters[0])    # rank 4 > pool rank 2
        assert pool.allocator.available == pool.n_pages

    def test_unknown_adapter_typed(self, tiny):
        model, cfg = tiny
        e = _mk(model, adapters=POOL, **ENGINE_KW)
        with pytest.raises(UnknownAdapterError):
            e.add_request(_stream(cfg)[0], 4, adapter="nope")
        e2 = _mk(model, **ENGINE_KW)
        with pytest.raises(AdapterError):
            e2.add_request(_stream(cfg)[0], 4, adapter="nope")


# -- snapshot surface -----------------------------------------------------------
class TestAdapterFiles:
    def test_save_load_roundtrip(self, tiny, adapters, tmp_path):
        p = str(tmp_path / "a1")
        save_adapter(p, adapters[0])
        loaded = load_adapter_file(p)
        assert loaded["meta"]["rank"] == 4
        for t in ("wq", "wd"):
            for f in ("a", "b"):
                np.testing.assert_array_equal(
                    loaded["layers"][0][t][f], adapters[0]["layers"][0][t][f])

    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_files_load_across_packages(self, tiny, adapters, tmp_path,
                                        writer):
        """Exact: a directory the JAX package's save_adapter wrote loads in
        the port, and the reverse, every factor bit for bit."""
        _, cfg = tiny
        p = str(tmp_path / writer)
        (jad.save_adapter if writer == "jax" else save_adapter)(p, adapters[0])
        read = load_adapter_file if writer == "jax" else jad.load_adapter_file
        got = read(p, expect_dims=engine_target_dims(cfg), expect_layers=1)
        assert got["meta"] == adapters[0]["meta"]
        for t, fac in adapters[0]["layers"][0].items():
            for f in ("a", "b"):
                np.testing.assert_array_equal(
                    np.asarray(got["layers"][0][t][f]), fac[f])

    def test_corrupt_file_rejected_zero_pool_leak(self, tiny, adapters,
                                                  tmp_path):
        model, _ = tiny
        p = str(tmp_path / "bad")
        save_adapter(p, adapters[0])
        victim = [f for f in glob.glob(os.path.join(p, "*"))
                  if not f.endswith(".json")][0]
        with open(victim, "r+b") as f:
            f.seek(10)
            f.write(b"\xff\xff\xff")
        e = _mk(model, adapters=POOL, **ENGINE_KW)
        free0 = e._apool.allocator.available
        with pytest.raises(AdapterCorruptError):
            e.load_adapter("bad", p)
        assert e._apool.allocator.available == free0, "pool page leak"
        assert not e._apool.has("bad")
        assert e._apool.load_errors == 1

    def test_wrong_geometry_rejected(self, adapters, tmp_path):
        other = LlamaConfig.tiny(num_hidden_layers=1, hidden_size=16,
                                 intermediate_size=32, num_attention_heads=2)
        model = LlamaForCausalLM(other, device="cpu", seed=5)
        p = str(tmp_path / "wrong")
        save_adapter(p, adapters[0])        # a 32-hidden adapter
        e = _mk(model, adapters=POOL, max_len=64, page_size=8, max_batch=2,
                prefill_chunk=8)
        with pytest.raises(AdapterCorruptError):
            e.load_adapter("wrong", p)

    def test_load_fault_point_pre_install(self, tiny, adapters, tmp_path):
        """adapter.load fires before the install: typed raise, zero pool
        leak, and the engine keeps serving on base weights."""
        model, cfg = tiny
        p = str(tmp_path / "ok")
        save_adapter(p, adapters[0])
        e = _mk(model, adapters=POOL, **ENGINE_KW)
        free0 = e._apool.allocator.available
        with failsafe.inject("adapter.load", nth=1):
            with pytest.raises(failsafe.InjectedFault):
                e.load_adapter("a1", p)
        assert e._apool.allocator.available == free0
        assert e._apool.load_errors == 1
        out = e.generate_many(_stream(cfg)[:1], max_new_tokens=4)
        assert out[0].size > 0              # engine serves on
        e.load_adapter("a1", p)             # and the retry lands


# -- the identity matrix ----------------------------------------------------------
def _cell(tiny, adapters, jax_ids, **over):
    """Exact: the mixed batch equals the dedicated engines, the no-pool
    engine's base row and the JAX engine's mixed batch; the adapters change
    their rows."""
    model, cfg = tiny
    prompts = _stream(cfg)
    mixed, eng = _mixed(model, *adapters, prompts, **over)
    for i in (0, 1):
        np.testing.assert_array_equal(
            mixed[i], _dedicated(model, adapters[i], prompts[i], **over))
    ref = _mk(model, **dict(ENGINE_KW, **over)).generate_many(
        prompts, max_new_tokens=6)
    np.testing.assert_array_equal(mixed[2], ref[2])
    assert not np.array_equal(mixed[0], ref[0])
    for a, b in zip(mixed, jax_ids):
        np.testing.assert_array_equal(a, b)
    return eng


def test_no_adapter_engine_byte_identical(tiny, jax_mixed):
    """Exact: a pool with no adapter requests equals no pool at all, and the
    JAX engine."""
    model, cfg = tiny
    outs = _mk(model, adapters=POOL, **ENGINE_KW).generate_many(
        _stream(cfg), max_new_tokens=6)
    base = _mk(model, **ENGINE_KW).generate_many(_stream(cfg),
                                                 max_new_tokens=6)
    for a, b, c in zip(outs, base, jax_mixed["base"]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


CELLS = {"k1": ({}, "plain"), "k8": (dict(decode_block=8), "k8"),
         "spec4": (dict(speculate=4), "spec4"), "tp2": (dict(tp=2), "tp2"),
         "int8": (dict(quant="int8"), "int8"),
         "k8-spec4": (dict(decode_block=8, speculate=4), "plain"),
         "k8-tp2": (dict(decode_block=8, tp=2), "plain"),
         "spec4-tp2": (dict(speculate=4, tp=2), "plain"),
         "k8-spec4-tp2": (dict(decode_block=8, speculate=4, tp=2), "plain"),
         "k8-tp2-int8": (dict(decode_block=8, tp=2, quant="int8"), "int8")}


@pytest.mark.parametrize("cell", list(CELLS))
def test_mixed_batch(tiny, adapters, jax_mixed, cell):
    over, jax_cell = CELLS[cell]
    _cell(tiny, adapters, jax_mixed[jax_cell], **over)


@pytest.mark.parametrize("mk,over", [("layer", {}),
                                     ("multi", dict(decode_block=8))])
def test_megakernel_falls_back_per_dispatch(tiny, adapters, jax_mixed, mk,
                                            over):
    """Exact: with megakernel= on, adapter-carrying dispatches run the op
    chain (counted) and the cell's ids equal the op chain's and JAX's."""
    eng = _cell(tiny, adapters, jax_mixed["multi" if mk == "multi"
                                          else "plain"],
                megakernel=mk, **over)
    assert eng.adapter_mk_fallbacks > 0
    assert eng.health()["adapters"]["mk_fallbacks"] == eng.adapter_mk_fallbacks


def test_adapters_reject_psum_tp(tiny):
    model, _ = tiny
    with pytest.raises(ValueError, match="exact"):
        _mk(model, adapters=POOL, tp=2, tp_mode="psum", **ENGINE_KW)


def test_tp2_pool_shards_b_columns(tiny, adapters):
    """Under tp = 2 the column targets' B stacks split their out axis per
    shard; A and the down pair stay whole."""
    model, cfg = tiny
    e = _mk(model, adapters=POOL, tp=2, **ENGINE_KW)
    s = e.load_adapter("a1", adapters[0])
    sh = e._apool.shards
    full = adapters[0]["layers"][0]
    for t in ("wq", "wk", "wg"):
        n = full[t]["b"].shape[1] // 2
        for k in range(2):
            np.testing.assert_array_equal(
                sh[k]["b"][0][t][s].numpy(), full[t]["b"][:, k * n:(k + 1) * n])
    for k in range(2):
        np.testing.assert_array_equal(sh[k]["a"][0]["wq"][s].numpy(),
                                      full["wq"]["a"])
        np.testing.assert_array_equal(sh[k]["b"][0]["wd"][s].numpy(),
                                      full["wd"]["b"])


# -- lifecycle under load ---------------------------------------------------------
class TestLifecycle:
    def test_hot_load_evict_under_load(self, tiny, adapters):
        """Load a second adapter while the first decodes; evict the first
        only after its request retires (refcounts pin it). Exact."""
        model, cfg = tiny
        prompts = _stream(cfg)
        e = _mk(model, adapters=POOL, **ENGINE_KW)
        e.load_adapter("a1", adapters[0])
        u1 = e.add_request(prompts[0], 8, adapter="a1")
        for _ in range(3):
            e.step()
        e.load_adapter("a2", adapters[1])   # hot-load under load
        u2 = e.add_request(prompts[1], 6, adapter="a2")
        with pytest.raises(AdapterError):
            e.evict_adapter("a1")           # a live request pins it
        e.drain()
        np.testing.assert_array_equal(
            e.result(u1), _dedicated(model, adapters[0], prompts[0], mnt=8))
        e.evict_adapter("a1")
        assert not e._apool.has("a1")
        assert e.result(u2).size > 0

    def test_registry_lazy_hot_load(self, tiny, adapters, tmp_path):
        model, cfg = tiny
        p = str(tmp_path / "lazy")
        save_adapter(p, adapters[0])
        e = _mk(model, adapters=POOL, **ENGINE_KW)
        e.register_adapter("lazy", p)
        assert not e._apool.has("lazy")
        u = e.add_request(_stream(cfg)[0], 6, adapter="lazy")
        assert e._apool.has("lazy")         # loaded at the first request
        e.drain()
        np.testing.assert_array_equal(
            e.result(u), _dedicated(model, adapters[0], _stream(cfg)[0]))

    def test_counters_and_health(self, tiny, adapters):
        model, cfg = tiny
        _, eng = _mixed(model, *adapters, _stream(cfg))
        h = eng.health()["adapters"]
        assert h["loaded"] == 2
        assert h["requests"] == {"a1": 1, "a2": 1}
        assert h["tokens"] == {"a1": 6, "a2": 6}
        assert h["loads"] == 2 and h["active"] == {}

    def test_adapter_requests_skip_the_prefix_cache(self, tiny, adapters):
        """An adapter request neither shares nor publishes prefix pages."""
        model, cfg = tiny
        e = _mk(model, adapters=POOL, **ENGINE_KW)
        e.load_adapter("a1", adapters[0])
        p = np.arange(1, 20) % cfg.vocab_size
        e.add_request(p, 4, adapter="a1")
        e.drain()
        assert len(e._prefix) == 0
        e.add_request(p, 4)
        e.drain()
        assert len(e._prefix) == 2
        e.add_request(p, 4, adapter="a1")
        e.drain()
        assert e._prefix.hits == 0

    def test_preemption_keeps_adapter(self, tiny, adapters):
        """Exact: a preempted adapter request re-queues with its adapter and
        continues as its dedicated run does."""
        model, cfg = tiny
        prompts = _stream(cfg)
        e = _mk(model, adapters=POOL,
                tenants={"lo": {"priority": 0}, "hi": {"priority": 5}},
                **dict(ENGINE_KW, max_batch=1))
        e.load_adapter("a1", adapters[0])
        u1 = e.add_request(prompts[0], 8, adapter="a1", tenant="lo")
        for _ in range(4):
            e.step()
        e.add_request(prompts[2][:4], 2, tenant="hi")
        e.drain()
        assert e.preemptions >= 1
        np.testing.assert_array_equal(
            e.result(u1),
            _dedicated(model, adapters[0], prompts[0], mnt=8, max_batch=1))
        assert e._apool.active("a1") == 0
