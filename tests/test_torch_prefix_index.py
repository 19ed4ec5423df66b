"""Fleet prefix index and cache-aware routing of paddle_tpu_torch against
the JAX package.

Replays tests/test_prefix_index.py whole: the chain digests (every hex
string equals the reference's for the same tokens), PrefixIndex
(publish / lookup-longest / retract / drop_replica / expire / LRU cap and
the `index.publish` fault point, each call held against the reference
index fed the same calls), StorePrefixIndex over a torch.distributed
HashStore and a TCPStore on localhost, and EngineRouter(prefix_routing=
True) on the reference's micro LLaMA (1 layer, hidden 32, ffn 64, 2
heads; f32; weights carried over by name; the port's engines on the CPU).

Exact: digests, lookups, stats, the replica each request lands on, the
prefix-cache hits, the ship counters and every greedy id, against the JAX
router running the same stream.
"""
import socket
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

import paddle_tpu as paddle
from paddle_tpu import failsafe as jfs
from paddle_tpu.inference import prefix_index as jpx
from paddle_tpu.inference import router as jrouter
from paddle_tpu.inference import scheduler as jsched
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch import failsafe as tfs
from paddle_tpu_torch.convert import load_numpy_params
from paddle_tpu_torch.inference import router as trouter
from paddle_tpu_torch.inference import scheduler as tsched
from paddle_tpu_torch.inference.prefix_index import (EMPTY_DIGEST,
                                                     PrefixIndex,
                                                     StorePrefixIndex,
                                                     chain_digest,
                                                     chain_key_digest,
                                                     prompt_digests)
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

torch.set_num_threads(1)

MICRO = dict(num_hidden_layers=1, hidden_size=32, intermediate_size=64,
             num_attention_heads=2)
ENGINE_KW = dict(max_len=64, page_size=8, max_batch=2, prefill_chunk=8)
V = LlamaConfig.tiny(**MICRO).vocab_size
_MODELS = {}


@pytest.fixture(autouse=True)
def _clean_faults():
    jfs.reset()
    tfs.reset()
    yield
    jfs.reset()
    tfs.reset()


# -- digests --------------------------------------------------------------------------
class TestDigests:
    def test_content_addressed(self):
        a = chain_digest(EMPTY_DIGEST, [1, 2, 3])
        assert a == chain_digest(EMPTY_DIGEST, np.asarray([1, 2, 3]))
        assert a != chain_digest(EMPTY_DIGEST, [1, 2, 4])
        assert chain_digest(a, [7, 8]) != chain_digest(EMPTY_DIGEST, [7, 8])

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_hex_digests_equal_reference(self, seed):
        rng = np.random.RandomState(seed)
        ids = rng.randint(0, 32000, (int(rng.randint(1, 70)),))
        for page in (1, 8, 16):
            assert prompt_digests(ids, page) == jpx.prompt_digests(ids, page)
        assert chain_digest("ab", ids) == jpx.chain_digest("ab", ids)
        assert EMPTY_DIGEST == jpx.EMPTY_DIGEST

    def test_prompt_digests_full_pages_only(self):
        ids = np.arange(19, dtype=np.int64)
        digs = prompt_digests(ids, page_size=8)
        assert len(digs) == 2
        d = chain_digest(EMPTY_DIGEST, ids[:8])
        assert digs == [d, chain_digest(d, ids[8:16])]

    def test_chain_key_digest_matches_incremental(self):
        key = (((), tuple(range(8))), tuple(range(8, 16)))
        inc = chain_digest(chain_digest(EMPTY_DIGEST, list(range(8))),
                           list(range(8, 16)))
        assert chain_key_digest(key) == inc == jpx.chain_key_digest(key)


# -- the index ------------------------------------------------------------------------
def _both(*args, **kw):
    return PrefixIndex(*args, **kw), jpx.PrefixIndex(*args, **kw)


class TestPrefixIndex:
    def test_publish_lookup_longest(self):
        digs = prompt_digests(np.arange(32, dtype=np.int64), 8)
        other = np.arange(32, dtype=np.int64)
        other[9] += 1
        for ix in _both():
            ix.publish("r0", digs[1], 2)
            ix.publish("r1", digs[3], 4)
            assert ix.lookup(digs) == {"r1": 4, "r0": 2}
            assert ix.lookup(prompt_digests(other, 8)) == {}

    def test_retract_and_drop_replica(self):
        digs = prompt_digests(np.arange(16, dtype=np.int64), 8)
        seen = []
        for ix in _both():
            for rep in ("r0", "r1"):
                for j, d in enumerate(digs):
                    ix.publish(rep, d, j + 1)
            ix.retract("r0", digs[1])
            assert ix.lookup(digs) == {"r1": 2, "r0": 1}
            assert ix.drop_replica("r1") == 2
            assert ix.lookup(digs) == {"r0": 1}
            seen.append(ix.stats())
        assert seen[0] == seen[1]

    def test_expire_ages_out_stale_claims(self):
        digs = prompt_digests(np.arange(16, dtype=np.int64), 8)
        for ix in _both():
            ix.publish("dead", digs[0], 1)
            for _ in range(10):
                ix.publish("live", digs[1], 2)
            assert ix.expire(max_age=5) == 1
            assert ix.lookup(digs) == {"live": 2}
            assert ix.clock() == 11

    def test_entry_cap_is_lru(self):
        for ix in _both(max_entries=2):
            for i in range(4):
                ix.publish("r0", f"d{i}", 1)
            assert len(ix) == 2
            assert ix.lookup(["d3"]) == {"r0": 1}
            assert ix.lookup(["d0"]) == {}

    def test_publish_fault_point_fires(self):
        ix = PrefixIndex()
        with tfs.inject("index.publish", nth=1):
            with pytest.raises(tfs.InjectedFault, match="index.publish"):
                ix.publish("r0", "d", 1)
        assert len(ix) == 0


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def tcp_store():
    return dist.TCPStore("127.0.0.1", _free_port(), is_master=True,
                         wait_for_workers=False)


class TestStorePrefixIndex:
    @pytest.mark.parametrize("kind", ["hash", "tcp"])
    def test_store_backed_roundtrip(self, kind, tcp_store):
        store = dist.HashStore() if kind == "hash" else tcp_store
        ix = StorePrefixIndex(store, prefix=f"t1{kind}")
        digs = prompt_digests(np.arange(24, dtype=np.int64), 8)
        for j, d in enumerate(digs):
            ix.publish("r0", d, j + 1)
        ix.publish("r1", digs[0], 1)
        assert ix.lookup(digs) == {"r0": 3}
        assert ix.drop_replica("r0") == 3
        assert ix.lookup(digs) == {"r1": 1}
        ix.retract("r1", digs[0])
        assert ix.lookup(digs) == {}
        assert ix.stats() == {"entries": None, "stamp": 4, "publishes": 4,
                              "retractions": 4}

    def test_store_roster_trim_retracts_orphans(self):
        ix = StorePrefixIndex(dist.HashStore(), prefix="t2", max_roster=2)
        for i in range(4):
            ix.publish("r0", f"d{i}", 1)
        assert ix.lookup(["d0"]) == {} and ix.lookup(["d1"]) == {}
        assert ix.lookup(["d3"]) == {"r0": 1}
        assert ix.drop_replica("r0") == 2
        assert ix.lookup(["d2"]) == {} and ix.lookup(["d3"]) == {}

    def test_connect_opens_its_own_client(self, tcp_store):
        host, port, prefix = StorePrefixIndex(tcp_store, "t3").endpoint
        writer = StorePrefixIndex(tcp_store, prefix)
        writer.publish("w0", "dig", 2)
        reader = StorePrefixIndex.connect(host, port, prefix)
        assert reader.lookup(["dig"]) == {"w0": 1}   # covered: 1 digest

    def test_router_over_store_index(self):
        """The router takes a StorePrefixIndex (prefix_index=) and routes
        by it as by the in-process index."""
        s = side("port")
        ix = StorePrefixIndex(dist.HashStore(), prefix="rt")
        r = trouter.EngineRouter(s.factory(), replicas=2, prefix_index=ix)
        sys_prompt = np.random.RandomState(0).randint(0, V, (17,))
        r.add_request(sys_prompt, max_new_tokens=4)
        r.drain()
        home = next(rep.name for rep in r._replicas
                    if rep.engine.index_publishes)
        u = r.add_request(np.concatenate([sys_prompt, [1, 2]]),
                          max_new_tokens=4)
        assert r._reqs[u].replica == home
        r.drain()
        assert r.health()["prefix_index"]["publishes"] >= 2


# -- cache-aware routing ------------------------------------------------------------
def _models():
    if not _MODELS:
        paddle.seed(3)
        jm = JaxLlama(JaxConfig.tiny(**MICRO))
        tm = LlamaForCausalLM(LlamaConfig.tiny(**MICRO), device="cpu")
        load_numpy_params(tm, {n: np.asarray(p.data)
                               for n, p in jm.named_parameters()})
        _MODELS["m"] = (jm, tm)
    return _MODELS["m"]


def side(name):
    jm, tm = _models()
    if name == "jax":
        return types.SimpleNamespace(
            router=jrouter, fs=jfs,
            factory=lambda **over: (
                lambda: jsched.ContinuousBatchingEngine(
                    jm, **dict(ENGINE_KW, **over))))
    return types.SimpleNamespace(
        router=trouter, fs=tfs,
        factory=lambda **over: (
            lambda: tsched.ContinuousBatchingEngine(
                tm, device="cpu", **dict(ENGINE_KW, **over))))


def sc_lands(s):
    rng = np.random.RandomState(0)
    sys_prompt = rng.randint(0, V, (17,)).astype(np.int64)
    r = s.router.EngineRouter(s.factory(), replicas=3, prefix_routing=True)
    uids = [r.add_request(sys_prompt, max_new_tokens=4)]
    r.drain()
    home = next(rep.name for rep in r._replicas if rep.engine.index_publishes)
    placed = []
    for _ in range(3):
        tail = rng.randint(0, V, (3,)).astype(np.int64)
        uids.append(r.add_request(np.concatenate([sys_prompt, tail]),
                                  max_new_tokens=4))
        placed.append(r._reqs[uids[-1]].replica)
        r.drain()
    return {"home": home, "placed": placed,
            "hits": {rep.name: rep.engine._prefix.hits
                     for rep in r._replicas},
            "routed": r.prefix_routed, "ids": [r.result(u) for u in uids],
            "index": r.prefix_index.stats()}


def sc_ship(s):
    rng = np.random.RandomState(1)
    sys_prompt = rng.randint(0, V, (17,)).astype(np.int64)
    r = s.router.EngineRouter(s.factory(), replicas=2, prefix_routing=True)
    u0 = r.add_request(sys_prompt, max_new_tokens=4)
    r.drain()
    home = r._by_name[next(rep.name for rep in r._replicas
                           if rep.engine.index_publishes)]
    other = next(rep for rep in r._replicas if rep is not home)
    for _ in range(ENGINE_KW["max_batch"]):
        home.engine.add_request(rng.randint(0, V, (6,)).astype(np.int64),
                                max_new_tokens=30)
    while sum(1 for x in home.engine._slots if x is not None) \
            < ENGINE_KW["max_batch"]:
        home.engine.step()
    u1 = r.add_request(sys_prompt.copy(), max_new_tokens=4)
    out = {"placed": r._reqs[u1].replica, "other": other.name,
           "ships": r.prefix_ships, "ship_failures": r.prefix_ship_failures,
           "imports": other.engine.prefix_imports,
           "exports": home.engine.prefix_exports}
    r.drain()
    out["other_hits"] = other.engine._prefix.hits
    out["ids"] = [r.result(u0), r.result(u1)]
    home.engine.drain()
    out["router"] = r
    return out


def sc_index_failure(s):
    rng = np.random.RandomState(2)
    r = s.router.EngineRouter(s.factory(), replicas=2, prefix_routing=True)
    with s.fs.inject("index.publish", p=1.0, times=None):
        u = r.add_request(rng.randint(0, V, (17,)).astype(np.int64),
                          max_new_tokens=4)
        r.drain()
    return {"status": r.status(u), "ids": [r.result(u)],
            "errs": sum(rep.engine.index_publish_errors
                        for rep in r._replicas),
            "publishes": r.prefix_index.stats()["publishes"]}


def sc_death(s):
    rng = np.random.RandomState(4)
    sys_prompt = rng.randint(0, V, (17,)).astype(np.int64)
    r = s.router.EngineRouter(s.factory(), replicas=2,
                              quarantine_threshold=99, prefix_routing=True)
    r.add_request(sys_prompt, max_new_tokens=4)
    r.drain()
    sizes = [len(r.prefix_index)]
    home = next(rep for rep in r._replicas if rep.engine.index_publishes)
    r._on_replica_failure(home, RuntimeError("chaos kill"))
    sizes.append(len(r.prefix_index))
    u = r.add_request(sys_prompt.copy(), max_new_tokens=4)
    r.drain()
    sizes.append(len(r.prefix_index))
    return {"sizes": sizes, "status": r.status(u), "ids": [r.result(u)]}


def sc_ship_fallback(s):
    # the ship's device export fails once: it retries through the host
    with s.fs.inject("transport.device", nth=1):
        return sc_ship(s)


SCENARIOS = {"lands": sc_lands, "ship": sc_ship, "ship_fallback": sc_ship_fallback,
             "index_failure": sc_index_failure, "death": sc_death}


@pytest.fixture(scope="module")
def ref():
    out = {}
    for name, fn in SCENARIOS.items():
        jfs.reset()
        out[name] = fn(side("jax"))
    jfs.reset()
    return out


def _equal(want, got, keys):
    for k in keys:
        assert got[k] == want[k], (k, got[k], want[k])
    for i, (a, b) in enumerate(zip(want["ids"], got["ids"])):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a),
                                      err_msg=f"request {i}")


class TestCacheAwareRouting:
    def test_lands_on_longest_prefix_replica(self, ref):
        got = sc_lands(side("port"))
        assert got["placed"] == [got["home"]] * 3
        assert got["hits"][got["home"]] >= 6
        assert sum(v for k, v in got["hits"].items()
                   if k != got["home"]) == 0
        assert got["routed"] >= 3
        _equal(ref["lands"], got, ("home", "placed", "hits", "routed",
                                   "index"))

    def test_ships_pages_when_best_replica_is_loaded(self, ref):
        got = sc_ship(side("port"))
        assert got["placed"] == got["other"]
        assert (got["ships"], got["imports"], got["exports"]) == (1, 1, 1)
        assert got["ship_failures"] == 0
        assert got["other_hits"] >= 2
        np.testing.assert_array_equal(got["ids"][0], got["ids"][1])
        _equal(ref["ship"], got, ("placed", "other", "ships", "imports",
                                  "exports", "other_hits", "ship_failures"))
        for rep in got["router"]._replicas:
            eng = rep.engine
            assert eng.allocator.available == \
                eng.allocator.n_pages - len(eng._prefix)
            assert not eng.allocator._exports
        assert dict(got["router"].prefix_ship_transports) == {"device": 1}
        assert got["router"].prefix_ship_fallbacks == 0

    def test_device_ship_failure_falls_back_loudly(self, ref):
        """A failed device export retries through the host bounce, as the
        reference does, and says so: a RuntimeWarning, the router's
        prefix_ship_fallbacks counter (also in metrics()) and the transport
        the ship really took."""
        with pytest.warns(RuntimeWarning, match="falling back to the host"):
            got = sc_ship_fallback(side("port"))
        r = got["router"]
        assert (got["ships"], got["ship_failures"]) == (1, 0)
        assert r.prefix_ship_fallbacks == 1
        assert r.metrics()["router"]["prefix_ship_fallbacks"] == 1
        assert dict(r.prefix_ship_transports) == {"host": 1}
        _equal(ref["ship_fallback"], got, ("placed", "other", "ships", "imports",
                                           "exports", "other_hits", "ship_failures"))

    def test_ship_takes_the_device_transport(self):
        """Two in-process replicas negotiate "device": the shipped payload
        carries tensors, never host arrays, and the import verifies it."""
        s = side("port")
        r = trouter.EngineRouter(s.factory(), replicas=2,
                                 prefix_routing=True)
        src, dst = r._replicas
        prompt = np.random.RandomState(5).randint(0, V, (17,))
        u = src.engine.add_request(prompt, max_new_tokens=2)
        src.engine.drain()
        payload = src.export_prefix(prompt, device=True)
        assert payload["transport"] == "device"
        assert all(torch.is_tensor(b) for b in payload["k"] + payload["v"])
        assert dst.import_prefix(payload) == 2
        src.finish_prefix_export(payload["token"])
        assert src.engine.result(u).size == 19
        with pytest.raises(RuntimeError, match="double import"):
            dst.import_prefix(payload)

    def test_index_failure_never_fails_a_request(self, ref):
        got = sc_index_failure(side("port"))
        assert got["status"] == "done" and got["errs"] >= 2
        assert got["publishes"] == 0
        _equal(ref["index_failure"], got, ("status", "errs", "publishes"))

    def test_replica_death_drops_index_claims(self, ref):
        got = sc_death(side("port"))
        assert got["sizes"] == [2, 0, 2] and got["status"] == "done"
        _equal(ref["death"], got, ("sizes", "status"))

    def test_weight_flip_retracts_every_claim(self):
        s = side("port")
        r = trouter.EngineRouter(s.factory(), replicas=1,
                                 prefix_routing=True)
        r.add_request(np.random.RandomState(6).randint(0, V, (17,)),
                      max_new_tokens=2)
        r.drain()
        assert len(r.prefix_index) == 2
        rep = r._replicas[0]
        rep.install_weights(rep.export_weights())
        assert len(r.prefix_index) == 0 and len(rep.engine._prefix) == 0
