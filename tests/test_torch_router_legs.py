"""The router legs of other suites, paddle_tpu_torch against the JAX package.

Replays, with the same streams through the JAX EngineRouter and the port's
(micro LLaMA: 1 layer, hidden 32, ffn 64; f32; weights carried over by
name; the port's engines on the CPU):

  - tests/test_adapters.py::TestRouterDeploy (fleet adapter deploy,
    failover of an adapter request, partial deploy, rebuild replay)
  - tests/test_kv_handoff.py::TestTopologyRouting (disaggregated
    prefill / decode with a KV-page handoff at first token; a kill at each
    handoff fault point)
  - tests/test_kv_tiering.py::TestRouterTiering (a demoted-only replica
    keeps stepping; tier-aware routing weighs pages_demoted)
  - tests/test_telemetry.py::TestHealthSchema (the router's and its
    replicas' health() keys equal the reference's) and the router cases of
    TestLegs (fleet histogram counts over a handoff, the failover leg)
  - tests/test_sampling_v2.py::test_router_carries_sampling
  - examples/serve_llama.py's router modes through the port's CLI

Exact (no tolerance): every greedy and sampled id, the handoff and
failover counters, the transports the handoffs took, the health keys.
"""
import types

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import failsafe as jfs
from paddle_tpu.inference import adapters as jad
from paddle_tpu.inference import router as jrouter
from paddle_tpu.inference import sampling as jsampling
from paddle_tpu.inference import scheduler as jsched
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch import failsafe as tfs
from paddle_tpu_torch import serve_llama
from paddle_tpu_torch.convert import load_numpy_params
from paddle_tpu_torch.inference import adapters as tad
from paddle_tpu_torch.inference import router as trouter
from paddle_tpu_torch.inference import scheduler as tsched
from paddle_tpu_torch.inference.sampling import SamplingParams
from paddle_tpu_torch.inference.telemetry import chrome_trace
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

torch.set_num_threads(1)

MICRO = dict(num_hidden_layers=1, hidden_size=32, intermediate_size=64,
             num_attention_heads=2)
GQA = dict(MICRO, num_attention_heads=4, num_key_value_heads=2)
ENGINE_KW = dict(max_len=64, page_size=8, max_batch=2, prefill_chunk=8)
POOL = {"rank": 4}
_MODELS = {}


@pytest.fixture(autouse=True)
def _clean_faults():
    jfs.reset()
    tfs.reset()
    yield
    jfs.reset()
    tfs.reset()


def _models(cfg_kw=MICRO, layers=None):
    """(JAX model, port model, port cfg) with identical weights drawn in
    JAX at seed 3."""
    kw = dict(cfg_kw) if layers is None else {"num_hidden_layers": layers}
    key = tuple(sorted(kw.items()))
    if key not in _MODELS:
        paddle.seed(3)
        jm = JaxLlama(JaxConfig.tiny(**kw))
        tm = LlamaForCausalLM(LlamaConfig.tiny(**kw), device="cpu")
        load_numpy_params(tm, {n: np.asarray(p.data)
                               for n, p in jm.named_parameters()})
        _MODELS[key] = (jm, tm, tm.config)
    return _MODELS[key]


def side(name, cfg_kw=MICRO):
    jm, tm, _ = _models(cfg_kw)
    if name == "jax":
        return types.SimpleNamespace(
            router=jrouter, fs=jfs, ad=jad,
            factory=lambda **over: (
                lambda: jsched.ContinuousBatchingEngine(
                    jm, **dict(ENGINE_KW, **over))))
    return types.SimpleNamespace(
        router=trouter, fs=tfs, ad=tad,
        factory=lambda **over: (
            lambda: tsched.ContinuousBatchingEngine(
                tm, device="cpu", **dict(ENGINE_KW, **over))))


def stream(n=4, seed=0, lo=3, hi=8):
    V = LlamaConfig.tiny(**MICRO).vocab_size
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, V, (int(t),)).astype(np.int64)
               for t in rng.randint(4, 14, n)]
    budgets = [int(b) for b in rng.randint(lo, hi, n)]
    return prompts, budgets


def results(r, uids):
    return [np.asarray(r.result(u)) for u in uids]


def same_ids(ref, got, tag=""):
    assert len(ref) == len(got)
    for i, (a, b) in enumerate(zip(ref, got)):
        np.testing.assert_array_equal(b, a, err_msg=f"{tag} request {i}")


def router_no_leak(router):
    for rep in router._replicas:
        eng = rep.engine
        held = 0 if eng._prefix is None else len(eng._prefix)
        assert eng.allocator.available == eng.allocator.n_pages - held, (
            rep.name, eng.allocator.available, held)


# -- scenarios ----------------------------------------------------------------------
def _adapter_prompts():
    rng = np.random.RandomState(0)
    V = LlamaConfig.tiny(**GQA).vocab_size
    return [rng.randint(0, V, (t,)).astype(np.int64) for t in (9, 5, 12)]


def sc_adapter_failover(s, path):
    r = s.router.EngineRouter(s.factory(adapters=POOL), replicas=2)
    summary = r.load_adapter("a1", path)
    prompts = _adapter_prompts()
    u1 = r.add_request(prompts[0], 6, adapter="a1")
    u2 = r.add_request(prompts[1], 6)
    for _ in range(2):
        r.step()
    with s.fs.inject("replica.step", nth=1):
        r.step()
    r.drain()
    return {"summary": summary, "ids": results(r, [u1, u2]),
            "failovers": r.failovers}


def sc_disagg(s, topology):
    prompts, budgets = stream(lo=4, hi=9)
    r = s.router.EngineRouter(s.factory(), topology=topology)
    uids = [r.add_request(p, max_new_tokens=b)
            for p, b in zip(prompts, budgets)]
    r.drain()
    h = r.health()
    return {"ids": results(r, uids), "router": r,
            "h": {k: h[k] for k in ("kv_handoffs", "handoff_failures",
                                    "topology", "pending", "failovers")},
            "transports": dict(r.handoff_transports),
            "assigned": {n: e["assigned"] for n, e in h["replicas"].items()},
            "roles": {n: e["role"] for n, e in h["replicas"].items()}}


def sc_kill_handoff(s, fp):
    prompts, budgets = stream(lo=4, hi=9)
    r = s.router.EngineRouter(s.factory(),
                              topology={"prefill": 1, "decode": 2})
    with s.fs.inject(fp, nth=1):
        uids = [r.add_request(p, max_new_tokens=b)
                for p, b in zip(prompts, budgets)]
        r.drain()
    h = r.health()
    return {"ids": results(r, uids), "router": r,
            "h": {k: h[k] for k in ("kv_handoffs", "handoff_failures",
                                    "pending", "failovers", "requeued")},
            "transports": dict(r.handoff_transports)}


def sc_sampled(s, make):
    jm, tm, _ = _models(layers=2)
    if make is jsampling.SamplingParams:
        factory = lambda: jsched.ContinuousBatchingEngine(     # noqa: E731
            jm, megakernel=False, decode_block=1,
            **dict(ENGINE_KW, max_len=48))
    else:
        factory = lambda: tsched.ContinuousBatchingEngine(     # noqa: E731
            tm, device="cpu", megakernel=False, decode_block=1,
            **dict(ENGINE_KW, max_len=48))
    rng = np.random.RandomState(3)
    prompt = rng.randint(0, 128, 5).astype(np.int64)
    sp = make(do_sample=True, temperature=0.8, top_k=6, top_p=0.95,
              min_p=0.02, seed=100)
    router = s.router.EngineRouter(factory, replicas=1)
    u = router.add_request(prompt, 8, sampling=sp.to_spec())
    router.drain()
    eng = factory()
    v = eng.add_request(prompt, 8, sampling=sp)
    eng.drain()
    return np.asarray(router.result(u)), np.asarray(eng.result(v))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX router's runs of every scenario."""
    out = {}
    jm, _, jcfg = _models(GQA)
    path = str(tmp_path_factory.mktemp("ad") / "a1")
    jad.save_adapter(path, jad.make_lora_adapter(jm.config, rank=4, seed=1))
    out["adapter_path"] = path
    out["adapter"] = sc_adapter_failover(side("jax", GQA), path)
    out["disagg"] = sc_disagg(side("jax"), {"prefill": 1, "decode": 2})
    for fp in ("kv.export", "kv.import", "handoff.commit"):
        jfs.reset()
        out[fp] = sc_kill_handoff(side("jax"), fp)
    jfs.reset()
    out["sampled"] = sc_sampled(side("jax"), jsampling.SamplingParams)
    r = jrouter.EngineRouter(side("jax").factory(), replicas=1)
    out["health"] = r.health()
    out["engine_health"] = set(r._replicas[0].engine.health())
    return out


# -- adapters -----------------------------------------------------------------------
def _dedicated(prompt):
    _, tm, cfg = _models(GQA)
    e = tsched.ContinuousBatchingEngine(tm, device="cpu", adapters=POOL,
                                        **ENGINE_KW)
    e.load_adapter("only", tad.make_lora_adapter(cfg, rank=4, seed=1))
    u = e.add_request(prompt, 6, adapter="only")
    e.drain()
    return np.asarray(e.result(u))


class TestRouterDeploy:
    def test_fleet_registry_write_and_failover(self, ref):
        """One registry write loads the adapter (saved by the JAX package)
        on both replicas; an adapter request failing over mid-stream
        continues with the dedicated engine's ids and the JAX router's."""
        got = sc_adapter_failover(side("port", GQA), ref["adapter_path"])
        assert all(v == "loaded" for v in got["summary"].values())
        assert got["failovers"] == 1 == ref["adapter"]["failovers"]
        np.testing.assert_array_equal(got["ids"][0],
                                      _dedicated(_adapter_prompts()[0]))
        same_ids(ref["adapter"]["ids"], got["ids"], "adapter router")

    def test_partial_deploy_routes_around(self, ref):
        s = side("port", GQA)
        r = trouter.EngineRouter(s.factory(adapters=POOL), replicas=2)
        with tfs.inject("adapter.load", nth=1):
            summary = r.load_adapter("a1", ref["adapter_path"])
        vals = sorted(summary.values())
        assert vals[0].startswith("error: InjectedFault")
        assert vals[1] == "loaded"
        u = r.add_request(_adapter_prompts()[0], 6, adapter="a1")
        r.drain()
        np.testing.assert_array_equal(r.result(u),
                                      _dedicated(_adapter_prompts()[0]))
        assert all(rep.breaker.state == "closed" for rep in r._replicas)

    def test_rebuild_replays_registry(self, ref):
        s = side("port", GQA)
        r = trouter.EngineRouter(s.factory(adapters=POOL), replicas=1)
        r.load_adapter("a1", ref["adapter_path"])
        rep = r._replicas[0]
        rep.rebuild()
        assert rep.engine._apool.has("a1")
        u = r.add_request(_adapter_prompts()[0], 6, adapter="a1")
        r.drain()
        np.testing.assert_array_equal(r.result(u),
                                      _dedicated(_adapter_prompts()[0]))


# -- disaggregated prefill / decode ----------------------------------------------
class TestTopologyRouting:
    def test_disagg_byte_identity_and_migration(self, ref):
        got = sc_disagg(side("port"), {"prefill": 1, "decode": 2})
        want = ref["disagg"]
        same_ids(want["ids"], got["ids"], "disagg")
        assert got["h"]["kv_handoffs"] == len(got["ids"])
        assert got["h"]["topology"] == {"prefill": 1, "decode": 2}
        assert sorted(got["roles"].values()) == ["decode", "decode",
                                                 "prefill"]
        assert got["assigned"]["p0"] == 0
        assert got["transports"] == {"device": len(got["ids"])}
        for k in ("h", "transports", "assigned", "roles"):
            assert got[k] == want[k], k
        router_no_leak(got["router"])

    def test_topology_validation(self):
        with pytest.raises(ValueError, match="at least one"):
            trouter.EngineRouter(side("port").factory(),
                                 topology={"prefill": 2})

    @pytest.mark.parametrize("fp", ["kv.export", "kv.import",
                                    "handoff.commit"])
    def test_kill_mid_handoff_zero_loss(self, ref, fp):
        got = sc_kill_handoff(side("port"), fp)
        want = ref[fp]
        same_ids(want["ids"], got["ids"], fp)
        same_ids(ref["disagg"]["ids"], got["ids"], fp)
        assert got["h"]["handoff_failures"] >= 1
        assert got["h"]["pending"] == 0
        assert got["h"] == want["h"] and got["transports"] == \
            want["transports"]
        router_no_leak(got["router"])


# -- tiering --------------------------------------------------------------------------
class TestRouterTiering:
    def test_demoted_only_replica_still_drains(self):
        V = LlamaConfig.tiny(**MICRO).vocab_size
        rng = np.random.RandomState(41)
        router = trouter.EngineRouter(side("port").factory(kv_tier="host"),
                                      replicas=2)
        u = router.add_request(rng.randint(0, V, (9,)).astype(np.int64),
                               max_new_tokens=8)
        rr = router._reqs[u]
        rep = router._by_name[rr.replica]
        while rep.engine.status(rr.engine_uid) != "decode":
            router.step()
        rep.engine.demote_request(rr.engine_uid)
        assert not any(s is not None for s in rep.engine._slots)
        assert rep.has_work()
        router.drain()
        assert router.status(u) == "done"
        assert rep.engine.restores == 1
        eng = rep.engine
        assert eng.allocator.available == \
            eng.allocator.n_pages - len(eng._prefix)

    def test_tier_aware_routing_weighs_pages_demoted(self):
        V = LlamaConfig.tiny(**MICRO).vocab_size
        rng = np.random.RandomState(43)
        router = trouter.EngineRouter(
            side("port").factory(kv_tier="host", max_batch=4), replicas=2)
        victim_rep, other = router._replicas

        def run_to_decode(rep, prompt_len, mnt):
            uid = rep.engine.add_request(
                rng.randint(0, V, (prompt_len,)).astype(np.int64),
                max_new_tokens=mnt)
            while rep.engine.status(uid) != "decode":
                rep.engine.step()
            return uid

        run_to_decode(victim_rep, 9, 8)
        run_to_decode(other, 17, 40)
        parked = run_to_decode(victim_rep, 17, 40)
        victim_rep.engine.demote_request(parked)
        hv, ho = victim_rep.headroom(), other.headroom()
        assert hv["running"] == ho["running"] == 1
        assert hv["pages_demoted"] > 0 and ho["pages_demoted"] == 0
        assert hv["pages_free"] > ho["pages_free"]
        assert hv["pages_free"] - hv["pages_demoted"] < ho["pages_free"]
        need = router.tier_aware_pages * ENGINE_KW["page_size"]
        long_prompt = rng.randint(0, V, (need,)).astype(np.int64)
        reps = router._routable(page_need=router._page_need(
            {"prompt": long_prompt, "max_new_tokens": 1}))
        assert reps[0] is other
        assert router._routable(page_need=1)[0] is victim_rep


# -- telemetry ------------------------------------------------------------------------
class TestHealthSchema:
    def test_engine_health_keys_equal_reference(self, ref):
        eng = side("port").factory()()
        assert set(eng.health()) == ref["engine_health"]

    def test_router_health_keys_equal_reference(self, ref):
        r = trouter.EngineRouter(side("port").factory(), replicas=1)
        h = r.health()
        assert set(h) == set(ref["health"])
        assert set(h["replicas"]["r0"]) == set(ref["health"]["replicas"]["r0"])
        assert h["prefix_index"] is None and h["topology"] is None


class TestLegs:
    def test_disagg_handoff_fleet_counts_and_chains(self):
        router = trouter.EngineRouter(side("port").factory(),
                                      topology={"prefill": 1, "decode": 1},
                                      telemetry=True)
        prompts, budgets = stream(n=3, seed=11)
        uids = [router.add_request(p, max_new_tokens=b)
                for p, b in zip(prompts, budgets)]
        router.drain()
        assert router.kv_handoffs >= 1
        m = router.metrics()
        h = m["fleet"]["histograms"]
        assert h["ttft_ms"]["count"] == len(prompts)
        assert h["tpot_ms"]["count"] == len(prompts)
        assert h["queue_wait_ms"]["count"] == len(prompts)
        assert h["handoff_ms"]["count"] == router.kv_handoffs
        c = m["fleet"]["counters"]
        assert c["requests_done"] == len(prompts)
        assert c["requests_delivered"] == len(prompts)
        migrated = [t for t in router._replicas[0].telemetry.done_traces()
                    if t.state == "migrated"]
        assert migrated
        for tr in migrated:
            assert tr.complete_chain() and "kv_export" in tr.phases()
        for tr in router._replicas[1].telemetry.done_traces():
            if tr.state == "done":
                assert tr.imported() and tr.complete_chain()
        rt = router.telemetry.trace("router", uids[0])
        assert "handoff" in rt.phases() and rt.state == "delivered"

    def test_failover_requeue_leg(self, tmp_path):
        router = trouter.EngineRouter(side("port").factory(), replicas=2,
                                      quarantine_threshold=3, telemetry=True)
        prompts, budgets = stream(n=4, seed=13)
        uids = [router.add_request(p, max_new_tokens=b)
                for p, b in zip(prompts, budgets)]
        with tfs.inject("replica.step", nth=1):
            router.step()
        router.drain()
        assert router.failovers == 1
        assert all(router.status(u) == "done" for u in uids)
        assert [t for t in (router.telemetry.trace("router", u)
                            for u in uids) if "requeue" in t.phases()]
        assert any(e.get("ev") == "fault" and e.get("point") == "replica.step"
                   for e in router.telemetry.log)
        d = chrome_trace([router.telemetry]
                         + [r.telemetry for r in router._replicas])
        assert len({e["pid"] for e in d["traceEvents"]}) == 3
        assert "paddle_tpu_requests_delivered" in router.prometheus()
        router.export_chrome_trace(str(tmp_path / "fleet.json"))
        assert (tmp_path / "fleet.json").stat().st_size > 0

    def test_failover_after_first_token_keeps_counts(self):
        V = LlamaConfig.tiny(**MICRO).vocab_size
        router = trouter.EngineRouter(side("port").factory(), replicas=2,
                                      quarantine_threshold=3, telemetry=True)
        rng = np.random.RandomState(31)
        u = router.add_request(rng.randint(0, V, (6,)).astype(np.int64),
                               max_new_tokens=8)
        r = None
        for _ in range(30):
            router.step()
            rr = router._reqs[u]
            if rr.replica is not None:
                r = router._by_name[rr.replica].engine._requests.get(
                    rr.engine_uid)
                if r is not None and r.out:
                    break
        assert r is not None and r.out, "no token before the kill"
        with tfs.inject("replica.step", nth=1):
            router.step()
        router.drain()
        assert router.failovers == 1 and router.status(u) == "done"
        h = router.metrics()["fleet"]["histograms"]
        assert h["ttft_ms"]["count"] == 1 and h["tpot_ms"]["count"] == 1


# -- sampling -------------------------------------------------------------------------
def test_router_carries_sampling(ref):
    """A to_spec() dict rides add_request -> submit_resume: the router's
    sampled stream equals the direct engine's and the JAX router's."""
    got_router, got_engine = sc_sampled(side("port"), SamplingParams)
    want_router, want_engine = ref["sampled"]
    np.testing.assert_array_equal(got_router, got_engine)
    np.testing.assert_array_equal(got_router, want_router)
    np.testing.assert_array_equal(want_router, want_engine)


# -- serve_llama's router modes ----------------------------------------------------
@pytest.mark.parametrize("argv,check", [
    (["--replicas", "2", "--prefix-routing"],
     lambda r: r.prefix_routed >= 1 and r.prefix_index is not None),
    (["--disagg", "1:1"],
     lambda r: r.kv_handoffs == 4 and dict(r.handoff_transports) ==
     {"device": 4}),
    (["--replicas", "2", "--hot-swap", "{snap}"],
     lambda r: r.hot_swaps == 1 and all(rep.swaps == 1
                                        for rep in r._replicas)),
])
def test_serve_llama_router_modes(argv, check, tmp_path, capsys):
    argv = [a.format(snap=tmp_path / "snap") for a in argv]
    r = serve_llama.main(["--device", "cpu", "--max_new_tokens", "4"] + argv)
    assert check(r)
    h = r.health()
    assert h["done"] == 4 and h["failed"] == 0
    assert "router" in capsys.readouterr().out


@pytest.mark.parametrize("flag", [["--fleet", "2"], ["--fleet-worker"],
                                  ["--autoscale"]])
def test_serve_llama_fleet_modes_not_ported(flag, capsys):
    """The fleet flags are ported now (they raised NotImplementedError while
    ROADMAP A7.8 / A7.9 were open): `--fleet 2` serves the four requests over
    two worker processes with the tails of `--replicas 2`; `--fleet-worker`
    without `--fleet-store` and `--autoscale` without a router mode are
    usage errors."""
    argv = ["--device", "cpu", "--max_new_tokens", "4"]
    if flag[0] != "--fleet":
        with pytest.raises(SystemExit):
            serve_llama.main(argv + flag)
        return
    r = serve_llama.main(argv + flag)
    assert all(rr.state == "done" for rr in r._reqs.values())
    assert len(r._reqs) == 4
    fleet_out = capsys.readouterr().out
    serve_llama.main(argv + ["--replicas", "2"])
    local_out = capsys.readouterr().out

    def tails(out):
        return [line.split("tail")[1] for line in out.splitlines()
                if "request" in line and "tail" in line]

    assert "fleet 2 processes: 4 done / 0 failed" in fleet_out
    assert tails(fleet_out) == tails(local_out) and len(tails(fleet_out)) == 4
