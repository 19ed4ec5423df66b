"""Multi-replica serving of paddle_tpu_torch against the JAX package.

Replays tests/test_router.py (TestRouting, TestFailover, TestCircuitBreaker,
TestHotSwap, and a tier-1 cut of TestChaosSoak at 2 replicas) with the
same streams through the JAX EngineRouter and the port's, on the
reference's micro LLaMA (1 layer, hidden 32, ffn 64, 2 heads; f32;
weights carried over by name with `convert.load_numpy_params`; the port's
engines on the CPU). Each scenario runs once per package: the JAX side in
a module fixture, the port's side in the test.

Exact (no tolerance): every greedy id, every router counter (failovers,
requeued, duplicates dropped, probes, hot swaps, rollbacks), the replica
each request was routed to, the breaker states and backoffs, and the
hot-swap summaries. A weight snapshot the JAX engine saved is what the
port's fleet rolls in, so the post-swap ids also pin the snapshot format.
"""
import glob
import os
import shutil
import types

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import failsafe as jfs
from paddle_tpu.inference import router as jrouter
from paddle_tpu.inference import scheduler as jsched
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch import failsafe as tfs
from paddle_tpu_torch.convert import load_numpy_params
from paddle_tpu_torch.inference import router as trouter
from paddle_tpu_torch.inference import scheduler as tsched
from paddle_tpu_torch.inference.router import (CircuitBreaker, EngineRouter,
                                               HotSwapError)
from paddle_tpu_torch.inference.scheduler import (EngineBusyError,
                                                  RequestNotFinishedError,
                                                  UnknownRequestError)
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


def _models(seed):
    """(JAX model, port model) with identical weights drawn in JAX."""
    if seed not in _MODELS:
        paddle.seed(seed)
        jm = JaxLlama(JaxConfig.tiny(**MICRO))
        tm = LlamaForCausalLM(LlamaConfig.tiny(**MICRO), device="cpu")
        load_numpy_params(tm, {n: np.asarray(p.data)
                               for n, p in jm.named_parameters()})
        _MODELS[seed] = (jm, tm)
    return _MODELS[seed]


def side(name, seed=3):
    """One package's router, fault registry and engine factory."""
    jm, tm = _models(seed)
    if name == "jax":
        return types.SimpleNamespace(
            router=jrouter, fs=jfs, sched=jsched,
            factory=lambda **over: (
                lambda: jsched.ContinuousBatchingEngine(
                    jm, **dict(ENGINE_KW, **over))))
    return types.SimpleNamespace(
        router=trouter, fs=tfs, sched=tsched,
        factory=lambda **over: (
            lambda: tsched.ContinuousBatchingEngine(
                tm, device="cpu", **dict(ENGINE_KW, **over))))


def stream(n=4, seed=0):
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, V, (int(t),)).astype(np.int64)
               for t in rng.randint(4, 14, n)]
    budgets = [int(b) for b in rng.randint(3, 8, n)]
    return prompts, budgets


def counters(r):
    h = r.health()
    return {k: h[k] for k in ("failovers", "requeued", "duplicates_dropped",
                              "probes", "hot_swaps", "swap_rollbacks",
                              "done", "failed", "pending", "held")}


def results(r, uids):
    return [np.asarray(r.result(u)) for u in uids]


def assert_no_leak(router):
    for rep in router._replicas:
        eng = rep.engine
        held = 0 if eng._prefix is None else len(eng._prefix)
        assert eng.allocator.available == eng.allocator.n_pages - held, (
            rep.name, eng.allocator.available, eng.allocator.n_pages, held)


def same_ids(ref, got, tag=""):
    assert len(ref) == len(got)
    for i, (a, b) in enumerate(zip(ref, got)):
        np.testing.assert_array_equal(b, a, err_msg=f"{tag} request {i}")


# -- scenarios (each runs through one package) ----------------------------------
def sc_single(s):
    prompts, budgets = stream()
    eng = s.factory()()
    return {"ids": [np.asarray(x) for x in
                    eng.generate_many(prompts, max_new_tokens=budgets)]}


def sc_balanced(s):
    r = s.router.EngineRouter(s.factory(), replicas=3)
    prompts, budgets = stream(n=6, seed=1)
    uids = [r.add_request(p, max_new_tokens=b)
            for p, b in zip(prompts, budgets)]
    return {"placed": [r._reqs[u].replica for u in uids],
            "depths": sorted(len(r._assigned[rep.name])
                             for rep in r._replicas)}


def sc_three(s):
    prompts, budgets = stream()
    r = s.router.EngineRouter(s.factory(), replicas=3)
    uids = [r.add_request(p, max_new_tokens=b)
            for p, b in zip(prompts, budgets)]
    r.drain()
    return {"ids": results(r, uids), "c": counters(r), "router": r}


def sc_failover(s, decode_block, speculate):
    prompts, budgets = stream()
    r = s.router.EngineRouter(
        s.factory(decode_block=decode_block, speculate=speculate),
        replicas=2, quarantine_threshold=3)
    uids = [r.add_request(p, max_new_tokens=b)
            for p, b in zip(prompts, budgets)]
    for _ in range(2):
        r.step()
    with s.fs.inject("replica.step", nth=1):
        r.step()
    r.drain()
    return {"ids": results(r, uids), "c": counters(r), "router": r}


def sc_admit_fault(s):
    prompts, budgets = stream()
    r = s.router.EngineRouter(s.factory(), replicas=2,
                              quarantine_threshold=3)
    with s.fs.inject("replica.admit", nth=1):
        u = r.add_request(prompts[0], max_new_tokens=budgets[0])
    placed = r._reqs[u].replica
    r.drain()
    return {"ids": results(r, [u]), "placed": placed, "c": counters(r)}


def sc_busy_survivors(s):
    r = s.router.EngineRouter(s.factory(queue_limit=1, max_batch=1),
                              replicas=2, quarantine_threshold=3)
    prompts, budgets = stream(n=2, seed=3)
    u0 = r.add_request(prompts[0], max_new_tokens=budgets[0])
    u1 = r.add_request(prompts[1], max_new_tokens=budgets[1])
    rep0 = r._by_name[r._reqs[u0].replica]
    r._on_replica_failure(rep0, RuntimeError("dead"))
    held = r.health()["held"]
    r.drain()
    return {"held": held, "ids": results(r, [u0, u1]), "c": counters(r)}


def sc_breaker(s):
    r = s.router.EngineRouter(s.factory(), replicas=2,
                              quarantine_threshold=2, probe_backoff=2,
                              probe_retries=1, probe_sleep=lambda d: None)
    rep = r._replicas[0]
    prompts, budgets = stream(n=2, seed=5)
    uids = [r.add_request(p, max_new_tokens=b)
            for p, b in zip(prompts, budgets)]
    trail = []
    r._on_replica_failure(rep, RuntimeError("boom 1"))
    trail.append(rep.breaker.state)
    r._on_replica_failure(rep, RuntimeError("boom 2"))
    trail.append(rep.breaker.state)
    uids.append(r.add_request(prompts[0], max_new_tokens=3))
    placed = r._reqs[uids[-1]].replica
    first_window = rep.breaker.next_probe_step
    while r.steps < first_window - 1:
        r.step()
        trail.append(rep.breaker.state)
    with s.fs.inject("replica.heartbeat", p=1.0, times=None):
        r.step()
    trail.append((rep.breaker.state, rep.breaker.reopened,
                  rep.breaker.probe_backoff, r.probes))
    while rep.breaker.state == "open":
        r.step()
    trail.append(rep.breaker.state)
    r.step()
    trail.append((rep.breaker.state, rep.breaker.closed_after_probe))
    r.drain()
    return {"trail": trail, "placed": placed, "ids": results(r, uids),
            "c": counters(r)}


def sc_quarantined_fleet(s):
    r = s.router.EngineRouter(s.factory(), replicas=2,
                              quarantine_threshold=1, probe_backoff=1,
                              probe_sleep=lambda d: None)
    for rep in r._replicas:
        r._on_replica_failure(rep, RuntimeError("dead"))
    u = r.add_request(np.arange(1, 8), max_new_tokens=3)
    held = (r._reqs[u].replica, r.health()["held"])
    r.drain()
    return {"held": held, "ids": results(r, [u]), "c": counters(r)}


def sc_rebuild(s):
    r = s.router.EngineRouter(s.factory(), replicas=2,
                              quarantine_threshold=1, probe_backoff=1,
                              probe_sleep=lambda d: None)
    rep = r._replicas[0]
    r._on_replica_failure(rep, RuntimeError("dead"))
    rep.engine = None                  # wrecked: every call raises
    n_rebuild = n_close = None
    for i in range(64):
        r.step()
        if rep.engine is not None:
            n_rebuild = i
            break
    for i in range(64):
        if rep.breaker.state == "closed":
            n_close = i
            break
        r.step()
    return {"steps": (n_rebuild, n_close, r.steps),
            "final": (rep.breaker.state, rep.failed_probes, r.probes)}


def sc_chaos(s):
    """TestChaosSoak at 2 replicas: seeded kills at the three replica
    fault points while traffic arrives, then a clean drain."""
    prompts, budgets = stream(n=6, seed=42)
    r = s.router.EngineRouter(s.factory(), replicas=2,
                              quarantine_threshold=2, probe_backoff=2,
                              probe_retries=1, probe_jitter=0.5,
                              probe_sleep=lambda d: None)
    uids = []
    it = iter(zip(prompts, budgets))
    with s.fs.inject("replica.step", p=0.15, seed=7, times=None), \
            s.fs.inject("replica.heartbeat", p=0.05, seed=13, times=None), \
            s.fs.inject("replica.admit", p=0.1, seed=29, times=None):
        for _ in range(24):
            nxt = next(it, None)
            if nxt is not None:
                uids.append(r.add_request(nxt[0], max_new_tokens=nxt[1]))
            r.step()
    r.drain()
    return {"ids": results(r, uids), "c": counters(r), "router": r,
            "kills": [rep.kills for rep in r._replicas]}


SCENARIOS = {
    "single": sc_single, "balanced": sc_balanced, "three": sc_three,
    "fail_1_none": lambda s: sc_failover(s, 1, None),
    "fail_8_none": lambda s: sc_failover(s, 8, None),
    "fail_1_4": lambda s: sc_failover(s, 1, 4),
    "fail_8_4": lambda s: sc_failover(s, 8, 4),
    "admit_fault": sc_admit_fault, "busy": sc_busy_survivors,
    "breaker": sc_breaker, "quarantined": sc_quarantined_fleet,
    "rebuild": sc_rebuild, "chaos": sc_chaos,
}


@pytest.fixture(scope="module")
def ref():
    """Every scenario through the JAX router (faults armed in the JAX
    registry)."""
    out = {}
    for name, fn in SCENARIOS.items():
        jfs.reset()
        out[name] = fn(side("jax"))
    jfs.reset()
    return out


def _port(name):
    return SCENARIOS[name](side("port"))


# -- routing ------------------------------------------------------------------------
class TestRouting:
    def test_balanced_admission_by_health(self, ref):
        got = _port("balanced")
        assert got["depths"] == [2, 2, 2]
        assert got == ref["balanced"]

    def test_router_matches_single_engine(self, ref):
        got = _port("three")
        same_ids(ref["three"]["ids"], got["ids"], "router vs JAX router")
        same_ids(ref["single"]["ids"], got["ids"], "router vs JAX engine")
        assert got["c"] == ref["three"]["c"]
        assert got["c"]["failovers"] == 0
        assert_no_leak(got["router"])

    def test_tenant_identity_rides_through(self):
        s = side("port")
        tenants = {"a": {"share": 1.0}, "b": {"share": 2.0}}
        router = EngineRouter(s.factory(tenants=tenants), replicas=2)
        u = router.add_request(np.arange(1, 7), max_new_tokens=3,
                               tenant="b", priority=1)
        router.drain()
        rr = router._reqs[u]
        assert rr.tenant == "b" and rr.state == "done"
        assert any(rep.engine._tenant_tokens["b"] > 0
                   for rep in router._replicas)

    def test_typed_errors(self):
        router = EngineRouter(side("port").factory(), replicas=2)
        with pytest.raises(UnknownRequestError):
            router.result(999)
        u = router.add_request(np.arange(1, 9), max_new_tokens=4)
        with pytest.raises(RequestNotFinishedError):
            router.result(u)
        with pytest.raises(ValueError):
            router.add_request(np.arange(200), max_new_tokens=400)
        router.drain()
        assert router.result(u).size == 12

    def test_transport_endpoint_names_the_torch_device(self):
        router = EngineRouter(side("port").factory(), replicas=2)
        a, b = (rep.transport_endpoint() for rep in router._replicas)
        assert a == b and a["backend"] == "cpu" and a["store"] is None
        assert router._transport_kind(*router._replicas) == "device"


# -- failover -----------------------------------------------------------------------
class TestFailover:
    @pytest.mark.parametrize("decode_block,speculate",
                             [(1, None), (8, None), (1, 4), (8, 4)])
    def test_failover_byte_identity(self, ref, decode_block, speculate):
        """A replica killed mid-decode: its requests re-queue on the
        survivor; ids equal the fault-free single engine's and the JAX
        router's, counters equal the JAX router's."""
        key = f"fail_{decode_block}_{speculate or 'none'}"
        got = _port(key)
        same_ids(ref["single"]["ids"], got["ids"], key)
        same_ids(ref[key]["ids"], got["ids"], key)
        assert got["c"] == ref[key]["c"]
        assert got["c"]["failovers"] >= 1 and got["c"]["requeued"] >= 1
        assert got["c"]["failed"] == 0
        assert_no_leak(got["router"])

    def test_admit_fault_fails_over_to_next_replica(self, ref):
        got = _port("admit_fault")
        assert got["placed"] is not None
        assert got["c"]["failovers"] == 1
        same_ids(ref["single"]["ids"][:1], got["ids"])
        assert got["placed"] == ref["admit_fault"]["placed"]
        assert got["c"] == ref["admit_fault"]["c"]

    def test_failover_holds_when_survivors_are_busy(self, ref):
        got = _port("busy")
        assert got["held"] == 1
        assert got["c"]["failed"] == 0
        same_ids(ref["busy"]["ids"], got["ids"])
        assert got["c"] == ref["busy"]["c"]

    def test_exactly_once_under_duplicate_delivery(self, ref):
        prompts, budgets = stream()
        router = EngineRouter(side("port").factory(), replicas=2)
        u = router.add_request(prompts[0], max_new_tokens=budgets[0])
        router.drain()
        out = router.result(u)
        np.testing.assert_array_equal(out, ref["single"]["ids"][0])
        assert router._deliver(u, result=np.zeros(3, np.int64)) is False
        assert router._deliver(u, failure=object()) is False
        assert router.duplicates_dropped == 2
        np.testing.assert_array_equal(router.result(u), out)
        assert router.status(u) == "done"

    def test_collect_is_idempotent(self, ref):
        prompts, budgets = stream()
        router = EngineRouter(side("port").factory(), replicas=2)
        u = router.add_request(prompts[1], max_new_tokens=budgets[1])
        router.drain()
        for rep in router._replicas:
            router._collect(rep)
        assert router.duplicates_dropped == 0
        np.testing.assert_array_equal(router.result(u),
                                      ref["single"]["ids"][1])


# -- quarantine ---------------------------------------------------------------------
class TestCircuitBreaker:
    def test_transitions_open_half_open_closed(self, ref):
        got = _port("breaker")
        want = ref["breaker"]
        assert got["trail"][:2] == ["closed", "open"]
        assert got["trail"][-1] == ("closed", 1)
        assert got["trail"] == want["trail"]
        assert got["placed"] == want["placed"] == "r1"
        same_ids(want["ids"], got["ids"])
        assert got["c"] == want["c"] and got["c"]["failed"] == 0

    def test_half_open_failure_reopens(self):
        got, want = CircuitBreaker(2, 2), jrouter.CircuitBreaker(2, 2)
        for br in (got, want):
            br.record_failure(RuntimeError("a"), at_step=0)
            br.record_failure(RuntimeError("b"), at_step=0)
            assert br.state == "open" and br.next_probe_step == 2
            br.record_probe_success()
            br.record_failure(RuntimeError("c"), at_step=5)
            assert br.state == "open"
            assert br.probe_backoff == 4 and br.next_probe_step == 9
            br.record_probe_success()
            br.record_success()
        assert {k: getattr(got, k) for k in CircuitBreaker.__slots__} == \
            {k: getattr(want, k) for k in CircuitBreaker.__slots__}

    def test_quarantined_fleet_holds_requests(self, ref):
        got = _port("quarantined")
        assert got["held"] == (None, 1)
        assert got["ids"][0].size == 10
        same_ids(ref["quarantined"]["ids"], got["ids"])
        assert got["c"] == ref["quarantined"]["c"]

    def test_probe_rebuilds_wrecked_engine(self, ref):
        got = _port("rebuild")
        assert got["final"][:2] == ("closed", 0)
        assert got == ref["rebuild"]


# -- hot swap -----------------------------------------------------------------------
def sc_rolling_swap(s, path, prompts, budgets):
    r = s.router.EngineRouter(s.factory(), replicas=2)
    uids_a = [r.add_request(p, max_new_tokens=b)
              for p, b in zip(prompts, budgets)]
    for _ in range(2):
        r.step()
    summary = r.hot_swap(path)
    uids_b = [r.add_request(p, max_new_tokens=b)
              for p, b in zip(prompts, budgets)]
    r.drain()
    return {"summary": summary, "pre": results(r, uids_a),
            "post": results(r, uids_b), "c": counters(r), "router": r}


@pytest.fixture(scope="module")
def snap(tmp_path_factory):
    """A snapshot of the other model's weights, saved by the JAX engine,
    both packages' outputs on it (a fresh engine of each package), and the
    JAX router's rolling swap onto it."""
    jm, tm = _models(11)
    prompts, budgets = stream(n=4, seed=9)
    path = str(tmp_path_factory.mktemp("swap") / "snap")
    jeng = jsched.ContinuousBatchingEngine(jm, **ENGINE_KW)
    ref_new = jeng.generate_many(prompts, max_new_tokens=budgets)
    jeng.save_weights_snapshot(path, step=1)
    teng = tsched.ContinuousBatchingEngine(tm, device="cpu", **ENGINE_KW)
    same_ids(ref_new, teng.generate_many(prompts, max_new_tokens=budgets),
             "fresh engines on the new weights")
    want = sc_rolling_swap(side("jax"), path, prompts, budgets)
    return path, prompts, budgets, [np.asarray(x) for x in ref_new], want


class TestHotSwap:
    def test_rolling_swap_zero_rejects(self, snap):
        path, prompts, budgets, ref_new, want = snap
        got = sc_rolling_swap(side("port"), path, prompts, budgets)
        assert got["summary"] == {"r0": "swapped", "r1": "swapped"}
        assert got["c"]["failed"] == 0 and got["c"]["hot_swaps"] == 1
        same_ids(ref_new, got["post"], "post-swap")
        same_ids(want["pre"], got["pre"], "pre-swap requests")
        assert got["c"] == want["c"]
        assert_no_leak(got["router"])

    def test_corrupt_manifest_rolls_back_fleet(self, ref, snap, tmp_path):
        """A flipped byte in one leaf fails CRC32 mid-roll: every flipped
        replica returns to the old weights and later ids equal never having
        swapped; no temp directory is left."""
        prompts, budgets = stream()
        bad = str(tmp_path / "bad")
        shutil.copytree(snap[0], bad)
        leaf = sorted(glob.glob(os.path.join(bad, "leaf_*.npy")))[3]
        with open(leaf, "r+b") as f:
            f.seek(120)
            b = f.read(1)
            f.seek(120)
            f.write(bytes([b[0] ^ 0xFF]))
        router = EngineRouter(side("port").factory(), replicas=2)
        with pytest.raises(HotSwapError) as ei:
            router.hot_swap(bad)
        assert "CheckpointCorruptError" in str(ei.value)
        assert router.swap_rollbacks == 1 and router.hot_swaps == 0
        uids = [router.add_request(p, max_new_tokens=b)
                for p, b in zip(prompts, budgets)]
        router.drain()
        same_ids(ref["single"]["ids"], results(router, uids), "rolled back")
        assert all(r.state == "active" for r in router._replicas)
        assert not glob.glob(str(tmp_path / "*.tmp-*"))

    def test_hot_swap_skips_operator_drained(self, snap):
        router = EngineRouter(side("port").factory(), replicas=2)
        router.drain_replica("r0")
        summary = router.hot_swap(snap[0])
        assert summary == {"r0": "skipped-draining", "r1": "swapped"}
        assert router._by_name["r0"].state == "draining"
        router.activate("r0")
        assert router._by_name["r0"].state == "active"

    def test_flip_refuses_inflight_kv(self):
        eng = side("port").factory()()
        w = eng.export_weights()
        eng.add_request(np.arange(1, 10), max_new_tokens=8)
        for _ in range(3):
            eng.step()
        with pytest.raises(EngineBusyError):
            eng.install_weights(w)
        eng.drain()
        eng.install_weights(w)
        assert eng._prefix is None or len(eng._prefix) == 0


# -- chaos --------------------------------------------------------------------------
class TestChaosSoak:
    def test_seeded_replica_kills_zero_loss(self, ref):
        """Seeded kills at replica.step / replica.heartbeat / replica.admit
        while 6 requests arrive over 2 replicas: every request completes
        exactly once with the fault-free ids, zero page leak, and the same
        kills, failovers and re-queues as the JAX router under the same
        seeds."""
        got = _port("chaos")
        want = ref["chaos"]
        assert got["c"]["failovers"] > 0, "the seeds never killed a replica"
        assert got["c"]["failed"] == 0 and got["c"]["pending"] == 0
        prompts, budgets = stream(n=6, seed=42)
        single = tsched.ContinuousBatchingEngine(
            _models(3)[1], device="cpu", **ENGINE_KW).generate_many(
                prompts, max_new_tokens=budgets)
        same_ids(single, got["ids"], "chaos vs fault-free")
        same_ids(want["ids"], got["ids"], "chaos vs JAX router")
        assert got["c"] == want["c"] and got["kills"] == want["kills"]
        assert_no_leak(got["router"])
