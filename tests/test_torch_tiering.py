"""KV tiering of paddle_tpu_torch against the JAX package.

Replays tests/test_kv_tiering.py's TestKVTierStore, TestEvictionSafety and
TestDemoteRestore against the port's KVTierStore, PrefixCache and
ContinuousBatchingEngine(kv_tier=..., device="cpu") on a micro LLaMA (1
layer, hidden 32, ffn 64, 4 heads over 2 kv heads; f32; weights carried
over by name).

Exact (bits): every greedy id of a demote / restore round trip (host and
disk tiers, decode_block 1 and 8), of an oversubscribed engine (admission
demotes, the sweep restores), of demote-on-idle, of a demoted adapter
request, equals the never-demoted run's and the JAX engine's; the tier's
entries hold the payload's bytes; a corrupt entry or an injected kv.restore
fault retires exactly one request with stage "restore", zero page leak.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.scheduler import \
    ContinuousBatchingEngine as JaxEngine
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch import failsafe
from paddle_tpu_torch.convert import load_numpy_params
from paddle_tpu_torch.inference.adapters import make_lora_adapter
from paddle_tpu_torch.inference.handoff import KVHandoffError, checksum_payload
from paddle_tpu_torch.inference.scheduler import (ContinuousBatchingEngine,
                                                  PrefixCache)
from paddle_tpu_torch.inference.serving import PageAllocator
from paddle_tpu_torch.inference.tiering import (KVTierError, KVTierStore,
                                                resolve_tier)
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

torch.set_num_threads(1)

ENGINE_KW = dict(max_len=64, page_size=8, max_batch=2, prefill_chunk=8)
MICRO = dict(num_hidden_layers=1, hidden_size=32, intermediate_size=64,
             num_attention_heads=4, num_key_value_heads=2)
V = LlamaConfig.tiny(**MICRO).vocab_size
_PAIR = {}


@pytest.fixture(autouse=True)
def _clean_faults():
    failsafe.reset()
    yield
    failsafe.reset()


def _pair():
    if not _PAIR:
        paddle.seed(3)
        jm = JaxLlama(JaxConfig.tiny(**MICRO))
        tm = LlamaForCausalLM(LlamaConfig.tiny(**MICRO), device="cpu")
        load_numpy_params(tm, {n: np.asarray(p.data)
                               for n, p in jm.named_parameters()})
        _PAIR["m"] = (jm, tm)
    return _PAIR["m"]


def _mk(**over):
    return ContinuousBatchingEngine(_pair()[1], device="cpu",
                                    **dict(ENGINE_KW, **over))


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, V, (t,)).astype(np.int64) for t in lens]


# the prompt sets of the engine cases: (seed, lengths, budgets)
SETS = {"roundtrip": (11, (12, 7), [20, 16]),
        "oversub": (23, (12, 9, 7, 10), [8, 6, 9, 7]),
        "idle": (31, (6, 20, 5), [8, 8, 8])}


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX engine's never-demoted ids of each prompt set (one engine,
    the sets in turn; idle at prefill_chunk 4)."""
    jm, _ = _pair()
    eng = JaxEngine(jm, **dict(ENGINE_KW, max_batch=4))
    out = {}
    for name in ("roundtrip", "oversub"):
        seed, lens, budgets = SETS[name]
        out[name] = eng.generate_many(_prompts(seed, lens),
                                      max_new_tokens=budgets)
    seed, lens, budgets = SETS["idle"]
    out["idle"] = JaxEngine(jm, **dict(ENGINE_KW, prefill_chunk=4)) \
        .generate_many(_prompts(seed, lens), max_new_tokens=budgets)
    return out


def assert_no_leak(eng):
    held = 0 if eng._prefix is None else len(eng._prefix)
    assert eng.allocator.available == eng.allocator.n_pages - held, (
        eng.allocator.available, eng.allocator.n_pages, held)
    assert eng.pages_demoted == 0
    assert not eng._demoted


def _fake_payload(token, lens=8):
    """A minimal checksum-stamped payload (one layer, one page)."""
    return checksum_payload({
        "token": token,
        "spec": {"state": "x", "prompt": np.arange(lens, dtype=np.int64)},
        "lens": lens,
        "geometry": {"page_size": 8, "nh_kv": 2, "hd": 16, "layers": 1,
                     "kv_dtype": "float32"},
        "k": [np.full((1, 8, 2, 16), 1.5, np.float32)],
        "v": [np.full((1, 8, 2, 16), 2.5, np.float32)],
    })


# -- tier store ---------------------------------------------------------------------
class TestKVTierStore:
    def test_host_roundtrip_and_delete(self):
        st = KVTierStore(kind="host")
        st.put("t0", _fake_payload("t0"))
        out = st.get("t0")
        assert out["lens"] == 8
        np.testing.assert_array_equal(out["k"][0], np.full((1, 8, 2, 16), 1.5))
        st.delete("t0")
        with pytest.raises(KVTierError, match="not found"):
            st.get("t0")

    def test_disk_spill_and_restore(self, tmp_path):
        st = KVTierStore(kind="disk", tier_dir=str(tmp_path),
                         host_cap_mb=0.004)     # ~4 KB: force spills
        for i in range(3):
            st.put(f"t{i}", _fake_payload(f"t{i}"))
        assert st.spills >= 2
        out = st.get("t0")                      # served from disk
        assert st.disk_reads == 1
        np.testing.assert_array_equal(out["v"][0], np.full((1, 8, 2, 16), 2.5))
        assert "t0" in st and len(st) == 3

    def test_corrupt_disk_blob_fails_crc(self, tmp_path):
        st = KVTierStore(kind="disk", tier_dir=str(tmp_path),
                         host_cap_mb=0.001)
        st.put("t0", _fake_payload("t0"))
        st.put("t1", _fake_payload("t1"))       # spills t0
        blob = tmp_path / "t0.blob"
        raw = bytearray(blob.read_bytes())
        raw[len(raw) // 2] ^= 0xFF
        blob.write_bytes(bytes(raw))
        with pytest.raises(KVHandoffError, match="CRC mismatch"):
            st.get("t0")

    def test_resolve_tier(self, tmp_path):
        assert resolve_tier(None) is None and resolve_tier(False) is None
        st = KVTierStore()
        assert resolve_tier(st) is st
        assert resolve_tier("disk", str(tmp_path), 1).kind == "disk"
        with pytest.raises(ValueError):
            resolve_tier("ssd")
        with pytest.raises(ValueError, match="tier_dir"):
            KVTierStore(kind="disk")


# -- eviction vs tickets --------------------------------------------------------------
class TestEvictionSafety:
    def test_evict_skips_pages_under_export_ticket(self):
        al = PageAllocator(4)
        cache = PrefixCache(page_size=2)
        pg = al.alloc()
        cache.insert((), (7, 9), pg, al)
        al.free([pg])                       # creator retires: refcount 1
        token = al.export_begin([pg])       # transfer in flight
        assert cache.evict(4, al) == 0      # must not free the page
        assert al.refcount(pg) == 1
        al.export_commit(token)
        assert al.available == 4
        assert len(cache) == 1

    def test_evict_frees_after_ticket_closes(self):
        al = PageAllocator(4)
        cache = PrefixCache(page_size=2)
        pg = al.alloc()
        cache.insert((), (7, 9), pg, al)
        al.free([pg])
        token = al.export_begin([pg])
        al.export_abort(token)
        assert cache.evict(4, al) == 1
        assert al.available == 4

    def test_demoted_shared_pages_survive_eviction_pressure(self):
        """A demoted request keeps its references on prefix-cache-shared
        pages: eviction pressure never frees them while the restore is
        pending, and the restore gives the never-demoted ids (exact)."""
        base = _prompts(5, (17,))[0]
        longer = np.concatenate([base, np.asarray([3], np.int64)])
        ref = _mk()
        want_a = ref.generate_many([base], max_new_tokens=6)[0]
        want_b = ref.generate_many([longer], max_new_tokens=6)[0]
        eng = _mk(kv_tier="host")
        ua = eng.add_request(base, max_new_tokens=6)
        eng.drain()
        np.testing.assert_array_equal(eng.result(ua), want_a)
        ub = eng.add_request(longer, max_new_tokens=6)
        while eng.status(ub) != "decode":
            eng.step()
        r = eng._requests[ub]
        shared = [r.pages[i] for i in sorted(r.shared_idx)]
        assert shared, "request never shared the cached prefix"
        eng.demote_request(ub)
        eng._prefix.evict(999, eng.allocator)
        for pg in shared:
            assert eng.allocator.refcount(pg) >= 1
        eng.drain()
        np.testing.assert_array_equal(eng.result(ub), want_b)
        assert eng.restores == 1
        assert_no_leak(eng)


# -- demote / restore ---------------------------------------------------------------
class TestDemoteRestore:
    @pytest.mark.parametrize("K,tier", [(1, "host"), (8, "host"),
                                        (1, "disk"), (8, "disk")])
    def test_roundtrip_byte_identity(self, jax_ref, tmp_path, K, tier):
        seed, lens, budgets = SETS["roundtrip"]
        prompts = _prompts(seed, lens)
        want = _mk(decode_block=K).generate_many(prompts,
                                                 max_new_tokens=budgets)
        eng = _mk(decode_block=K, kv_tier=tier, tier_dir=str(tmp_path),
                  tier_host_cap_mb=0.0001)      # disk: every entry spills
        uids = [eng.add_request(p, n) for p, n in zip(prompts, budgets)]
        for _ in range(8):
            if all(eng.status(u) == "decode" for u in uids):
                break
            eng.step()
        tokens = [eng.demote_request(u) for u in uids]
        assert all(eng.status(u) == "demoted" for u in uids)
        assert eng.pages_demoted > 0
        h = eng.health()
        assert h["demoted"] == 2 and h["pages_demoted"] == eng.pages_demoted
        assert eng.headroom()["demoted"] == 2
        if tier == "disk":              # the older entry spilled
            assert (tmp_path / f"{tokens[0]}.blob").exists()
        eng.drain()
        for u, w, j in zip(uids, want, jax_ref["roundtrip"]):
            np.testing.assert_array_equal(eng.result(u), w)
            np.testing.assert_array_equal(eng.result(u), j)
        assert eng.demotions == 2 and eng.restores == 2
        assert eng._tier.disk_reads == (1 if tier == "disk" else 0)
        assert len(eng._tier) == 0
        assert_no_leak(eng)

    def test_kill_at_restore_retires_exactly_one(self):
        pa, pb = _prompts(13, (9, 6))
        eng = _mk(kv_tier="host")
        ua = eng.add_request(pa, max_new_tokens=8)
        ub = eng.add_request(pb, max_new_tokens=8)
        while eng.status(ua) != "decode":
            eng.step()
        eng.demote_request(ua)
        with failsafe.inject("kv.restore", nth=1):
            eng.drain()
        assert eng.status(ua) == "failed"
        assert eng.failures()[ua].stage == "restore"
        assert eng.status(ub) == "done"
        assert eng.restore_failures == 1
        assert_no_leak(eng)

    def test_corrupt_tier_entry_fails_one_request(self):
        pa, pb = _prompts(17, (9, 6))
        eng = _mk(kv_tier="host")
        ua = eng.add_request(pa, max_new_tokens=8)
        ub = eng.add_request(pb, max_new_tokens=8)
        while eng.status(ua) != "decode":
            eng.step()
        token = eng.demote_request(ua)
        manifest, blob = eng._tier._host[token]
        flipped = bytearray(blob)
        flipped[len(flipped) // 2] ^= 0xFF
        eng._tier._host[token] = (manifest, bytes(flipped))
        eng.drain()
        assert eng.status(ua) == "failed"
        fl = eng.failures()[ua]
        assert fl.stage == "restore" and "CRC" in fl.message
        assert eng.status(ub) == "done"
        assert_no_leak(eng)

    def test_cancel_and_deadline_clean_up_demoted(self):
        pa, pb = _prompts(19, (9, 7))
        eng = _mk(kv_tier="host")
        ua = eng.add_request(pa, max_new_tokens=20)
        while eng.status(ua) != "decode":
            eng.step()
        token = eng.demote_request(ua)
        assert token in eng._tier
        assert eng.cancel(ua) is True
        assert token not in eng._tier
        assert_no_leak(eng)
        ub = eng.add_request(pb, max_new_tokens=20, ttl_steps=50)
        while eng.status(ub) != "decode":
            eng.step()
        eng.demote_request(ub)
        eng.steps += 100
        eng._expire_deadlines()
        assert eng.status(ub) == "failed"
        assert eng.failures()[ub].error == "DeadlineExceededError"
        assert_no_leak(eng)

    @pytest.mark.parametrize("K", [1, 8])
    def test_oversubscription_byte_identity(self, jax_ref, K):
        """4 live requests over a 2-slot engine: admission demotes, the
        sweep restores, everyone finishes with the uncontended run's ids
        (and the JAX engine's)."""
        seed, lens, budgets = SETS["oversub"]
        prompts = _prompts(seed, lens)
        eng = _mk(kv_tier="host", max_batch=2, decode_block=K)
        uids = [eng.add_request(p, n) for p, n in zip(prompts, budgets)]
        eng.drain()
        for u, j in zip(uids, jax_ref["oversub"]):
            np.testing.assert_array_equal(eng.result(u), j)
        assert eng.demotions > 0, "no demotion pressure ever built"
        assert eng.restores == eng.demotions
        assert_no_leak(eng)
        h = eng.health()
        assert h["kv_tier"] == "host" and h["demotions"] == eng.demotions
        assert h["tier"]["puts"] == eng.demotions

    def test_demote_on_idle_byte_identity(self, jax_ref):
        seed, lens, budgets = SETS["idle"]
        pa, pb, pc = _prompts(seed, lens)
        eng = _mk(kv_tier="host", oversubscribe=False, tier_idle_steps=1,
                  prefill_chunk=4)
        ua = eng.add_request(pa, max_new_tokens=8)
        for _ in range(4):
            eng.step()
        ub = eng.add_request(pb, max_new_tokens=8)
        uc = eng.add_request(pc, max_new_tokens=8)
        eng.drain()
        assert eng.idle_demotions >= 1, "idle demotion never fired"
        assert eng.restores == eng.demotions
        for u, w in zip((ua, ub, uc), jax_ref["idle"]):
            np.testing.assert_array_equal(eng.result(u), w)
        assert_no_leak(eng)

    def test_demote_on_idle_needs_tier_and_queue(self):
        with pytest.raises(ValueError):
            _mk(tier_idle_steps=2)
        pa, pb = _prompts(37, (6, 18))
        eng = _mk(kv_tier="host", oversubscribe=False, tier_idle_steps=1,
                  prefill_chunk=4)
        ua = eng.add_request(pa, max_new_tokens=6)
        for _ in range(3):
            eng.step()
        ub = eng.add_request(pb, max_new_tokens=6)
        eng.drain()
        assert eng.status(ua) == "done" and eng.status(ub) == "done"
        assert eng.idle_demotions == 0
        assert_no_leak(eng)

    def test_demote_fault_leaves_request_serving(self):
        pa = _prompts(29, (9,))[0]
        eng = _mk(kv_tier="host")
        ua = eng.add_request(pa, max_new_tokens=8)
        while eng.status(ua) != "decode":
            eng.step()
        with failsafe.inject("kv.demote", nth=1):
            with pytest.raises(failsafe.InjectedFault):
                eng.demote_request(ua)
        assert eng.status(ua) == "decode"
        eng.drain()
        assert eng.status(ua) == "done"
        assert_no_leak(eng)

    def test_demoted_adapter_request_keeps_its_adapter(self):
        """Exact: a demoted adapter request keeps its pool reference (the
        adapter cannot be evicted under it) and restores to the ids of its
        never-demoted run."""
        ad = make_lora_adapter(LlamaConfig.tiny(**MICRO), rank=4, seed=1)
        pa, pb = _prompts(41, (10, 6))
        ref = _mk(adapters={"rank": 4})
        ref.load_adapter("a1", ad)
        want = ref.add_request(pa, 9, adapter="a1")
        ref.drain()
        eng = _mk(adapters={"rank": 4}, kv_tier="host")
        eng.load_adapter("a1", ad)
        ua = eng.add_request(pa, 9, adapter="a1")
        eng.add_request(pb, 9)
        while eng.status(ua) != "decode":
            eng.step()
        eng.demote_request(ua)
        assert eng._apool.active("a1") == 1
        with pytest.raises(Exception):
            eng.evict_adapter("a1")
        eng.drain()
        np.testing.assert_array_equal(eng.result(ua), ref.result(want))
        assert eng._apool.active("a1") == 0
        assert_no_leak(eng)

    def test_demote_refusals(self):
        pa = _prompts(43, (9,))[0]
        eng = _mk()
        ua = eng.add_request(pa, max_new_tokens=8)
        with pytest.raises(ValueError, match="no KV tier"):
            eng.demote_request(ua)
        eng = _mk(kv_tier="host")
        ua = eng.add_request(pa, max_new_tokens=8)
        with pytest.raises(ValueError, match="decode-state"):
            eng.demote_request(ua)          # still queued
        while eng.status(ua) != "decode":
            eng.step()
        eng.export_kv_pages(ua)
        with pytest.raises(ValueError, match="handoff"):
            eng.demote_request(ua)
        eng.abort_handoff(ua)
        with pytest.raises(ValueError, match="not demoted"):
            eng.restore_request(ua)
        eng.drain()
        assert_no_leak(eng)


def test_telemetry_legs_of_demote_and_restore():
    """The tiering legs of the telemetry plane: "demote" then "restore" in
    the request's trace, restore_ms observed once."""
    from paddle_tpu_torch.inference.telemetry import Telemetry
    pa = _prompts(47, (9,))[0]
    eng = _mk(kv_tier="host", telemetry=Telemetry(capture_faults=False))
    ua = eng.add_request(pa, max_new_tokens=8)
    while eng.status(ua) != "decode":
        eng.step()
    eng.demote_request(ua)
    eng.drain()
    names = [n for _, n, _ in eng.telemetry.trace("engine", ua).events]
    assert names.index("demote") < names.index("restore")
    assert eng.telemetry.registry.hist["restore_ms"].count == 1
    assert_no_leak(eng)
