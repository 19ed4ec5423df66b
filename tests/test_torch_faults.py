"""Per-request fault isolation of paddle_tpu_torch's serving engine against
the JAX engine under the same injected faults.

Replays tests/test_fault_injection.py (TestServingFaultIsolation,
TestDeadlinesAndBackpressure, TestAllocatorDiagnostics, TestChaosSoak),
tests/test_speculative.py::TestSpecFaults and
tests/test_tp_decode.py::TestTPSoak (tp = 2 on the one-process mesh). The
port places its fault points (paddle_tpu_torch.failsafe) at the
reference's sites with the reference's names: `page.alloc`, `cb.admit`,
`cb.prefill`, `cb.decode`, `cb.draft`, `cb.verify`.

The scenarios whose outcome depends on where a fault lands (a decode
fault at K 1 and 4, the chaos soak, the speculative faults, the tp soak)
run on both engines (the JAX one armed through paddle_tpu.failsafe, the
port through its own registry, the same specs): the requests that fail,
their stages and error types, the failure count and every survivor's
output are EXACTLY equal. The others hold the port to the outcome the
reference test fixes, with every survivor EXACTLY equal to the JAX
engine's fault-free output. The port's pool leaks no page. Engines run the reference tests' models (`LlamaConfig.tiny()`
seed 3; the GQA 2-layer seed-7 model of the speculative suite; the
1-layer micro model of the tp suite), weights carried across by name, f32
on the CPU.
"""
import contextlib

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import failsafe as jfs
from paddle_tpu.inference import scheduler as jsched
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch import failsafe as tfs
from paddle_tpu_torch.convert import load_numpy_params
from paddle_tpu_torch.inference import scheduler as tsched
from paddle_tpu_torch.inference.serving import (EngineFullError, LLMEngine,
                                                PageAllocator)
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

torch.set_num_threads(1)

GEOM = dict(max_len=64, page_size=8, max_batch=2, prefill_chunk=8)
_MODELS = {}


@pytest.fixture(autouse=True)
def _clean_faults():
    tfs.reset()
    jfs.reset()
    yield
    tfs.reset()
    jfs.reset()


def _pair(name):
    """(JAX model, port model) with the reference suites' weights."""
    if name not in _MODELS:
        seed, kw = {"tiny": (3, {}),
                    "gqa": (7, dict(num_key_value_heads=2,
                                    num_hidden_layers=2)),
                    "micro": (3, dict(num_hidden_layers=1, hidden_size=32,
                                      intermediate_size=64,
                                      num_attention_heads=4,
                                      num_key_value_heads=2))}[name]
        paddle.seed(seed)
        jm = JaxLlama(JaxConfig.tiny(**kw))
        tm = LlamaForCausalLM(LlamaConfig.tiny(**kw), device="cpu")
        load_numpy_params(tm, {n: np.asarray(p.data)
                               for n, p in jm.named_parameters()})
        _MODELS[name] = (jm, tm)
    return _MODELS[name]


def _prompts(seed, lens, vocab=128):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (int(t),)).astype(np.int64) for t in lens]


def assert_no_leak(eng):
    held = 0 if eng._prefix is None else len(eng._prefix)
    assert eng.allocator.available == eng.allocator.n_pages - held


def _outcome(eng, uids):
    """[(state, stage, error type, output or None)] per request."""
    fails = eng.failures()
    out = []
    for u in uids:
        st = eng.status(u)
        f = fails.get(u)
        out.append((st, None if f is None else f.stage,
                    None if f is None else f.error,
                    eng.result(u) if st == "done" else None))
    return out


def _same_outcome(ref, got, tag):
    assert len(ref) == len(got)
    for i, (a, b) in enumerate(zip(ref, got)):
        assert a[:3] == b[:3], f"{tag}: request {i}: {a[:3]} != {b[:3]}"
        if a[3] is not None:
            np.testing.assert_array_equal(b[3], a[3],
                                          err_msg=f"{tag}: request {i}")


def _drive(side, model, prompts, budgets, faults, geom, **kw):
    """Run one scenario on the JAX ("jax") or port ("port") engine with the
    faults [(point, inject kwargs)] armed in that package. Returns (engine,
    outcome)."""
    fs, cb = ((jfs, jsched.ContinuousBatchingEngine) if side == "jax" else
              (tfs, tsched.ContinuousBatchingEngine))
    if side == "port":
        kw["device"] = "cpu"
    eng = cb(model, **dict(geom, **kw))
    with contextlib.ExitStack() as st:
        for point, spec in faults:
            st.enter_context(fs.inject(point, **spec))
        uids = [eng.add_request(p, max_new_tokens=n)
                for p, n in zip(prompts, budgets)]
        eng.drain()
    return eng, _outcome(eng, uids)


# the scenarios run on both engines: (model, prompts, budgets, faults,
# geometry, engine kwargs)
DECODE = ("tiny", _prompts(0, (12, 5, 9)), [6] * 3,
          [("cb.decode", dict(nth=3))], GEOM)
_RNG = np.random.RandomState(11)
TP_SOAK = ("micro", [_RNG.randint(0, 128, (int(t),)).astype(np.int64)
                     for t in _RNG.randint(4, 16, 10)], [8] * 10,
           [("cb.decode", dict(nth=5))],
           dict(max_len=64, page_size=8, max_batch=4, prefill_chunk=8))
# the port-only scenarios' prompts and budgets, whose fault-free JAX
# outputs the module fixture computes
PORT_ONLY = {"prefill": (_prompts(1, (24, 5)), [4, 4]),
             "alloc": (_prompts(2, (8, 9)), [4, 4]),
             "admit": (_prompts(2, (8, 9, 6)), [4] * 3),
             "ttl": (_prompts(3, (8, 6))[1:], [4]),
             "cancel": (_prompts(4, (8, 7))[1:], [4])}


def _jax_run(scenario, **kw):
    model, prompts, budgets, faults, geom = scenario
    jeng, ref = _drive("jax", _pair(model)[0], prompts, budgets, faults,
                       geom, **kw)
    return ref, jeng.failure_count


@pytest.fixture(scope="module")
def jax_ref():
    """Every JAX run the module compares with, in the fixture's setup: the
    decode-fault scenario at K 1 and 4, the chaos soak, the speculative
    faults, the tp soak's unsharded run, and the fault-free outputs of the
    port-only scenarios (one engine)."""
    out = {f"decode{K}": _jax_run(DECODE, decode_block=K) for K in (1, 4)}
    out["tp_soak"] = _jax_run(TP_SOAK)
    out["soak"] = _soak("jax", _pair("tiny")[0], 1)[1]
    for point in ("cb.draft", "cb.verify"):
        out[point] = _spec_fault("jax", point)
    eng = jsched.ContinuousBatchingEngine(_pair("tiny")[0], **GEOM)
    for name, (prompts, budgets) in PORT_ONLY.items():
        out[name] = eng.generate_many(prompts, max_new_tokens=budgets)
    return out


def _both(ref, scenario, **kw):
    """The scenario on the port, held to the JAX run `ref` (outcome,
    failure count); returns (port engine, port outcome)."""
    model, prompts, budgets, faults, geom = scenario
    eng, got = _drive("port", _pair(model)[1], prompts, budgets, faults,
                      geom, **kw)
    _same_outcome(ref[0], got, model)
    assert eng.failure_count == ref[1]
    assert_no_leak(eng)
    return eng, got


def _port_only(refs, name, faults, expect, **kw):
    """The scenario on the port alone, where the reference test fixes the
    outcome: `expect` [(state, stage)] per request; every survivor equals
    the JAX engine's fault-free output. Returns the port engine."""
    prompts, budgets = PORT_ONLY[name]
    eng, got = _drive("port", _pair("tiny")[1], prompts, budgets, faults,
                      GEOM, **kw)
    assert [g[:2] for g in got] == expect
    for i, g in enumerate(got):
        if g[0] == "done":
            np.testing.assert_array_equal(g[3], refs[name][i],
                                          err_msg=f"request {i}")
    assert eng.failure_count == sum(e[0] == "failed" for e in expect)
    return eng


# ------------------------------------------------ per-request isolation
class TestServingFaultIsolation:
    @pytest.mark.parametrize("K", [1, 4])
    def test_decode_fault_retires_one_request(self, K, jax_ref):
        """Exact: the third cb.decode boundary retires one request with
        stage "decode" (per step at K = 1, per block at K = 4); the others
        equal the JAX engine's outputs."""
        _, got = _both(jax_ref[f"decode{K}"], DECODE, decode_block=K)
        states = [g[0] for g in got]
        assert states.count("failed") == 1 and states.count("done") == 2
        assert {g[1:3] for g in got if g[0] == "failed"} == \
            {("decode", "InjectedFault")}

    def test_prefill_fault_mid_chunks(self, jax_ref):
        """Exact: a long prompt dies at its second prefill chunk (stage
        "prefill", the reference test's outcome); the short request equals
        the JAX engine's output."""
        eng = _port_only(jax_ref, "prefill", [("cb.prefill", dict(nth=2))],
                         [("failed", "prefill"), ("done", None)])
        assert_no_leak(eng)

    def test_alloc_fault_at_admission(self, jax_ref):
        """Exact: an allocation failure mid-claim frees the partial claim
        and fails only that request (stage "admit")."""
        eng = _port_only(jax_ref, "alloc", [("page.alloc", dict(nth=2))],
                         [("failed", "admit"), ("done", None)],
                         prefix_cache=False)
        assert eng.allocator.available == eng.allocator.n_pages

    def test_admit_fault_point(self, jax_ref):
        """Exact: the cb.admit boundary retires the request it names."""
        eng = _port_only(jax_ref, "admit", [("cb.admit", dict(nth=2))],
                         [("done", None), ("failed", "admit"),
                          ("done", None)])
        assert_no_leak(eng)

    def test_engine_exception_still_aborts_pools(self):
        """A non-request-scoped failure (a custom exception class at a
        fault point) keeps the abort-everything contract: the pools
        rebuild and the in-flight request gets an "engine" record."""
        _, tm = _pair("tiny")
        eng = tsched.ContinuousBatchingEngine(tm, device="cpu", **GEOM)
        p = (np.arange(12) % 128).astype(np.int64)
        with tfs.inject("cb.decode", exc=MemoryError):
            u = eng.add_request(p, max_new_tokens=6)
            with pytest.raises(MemoryError):
                eng.drain()
        assert eng.status(u) == "failed"
        assert eng.failures()[u].stage == "engine"
        assert eng.allocator.available == eng.allocator.n_pages

    def test_fault_catalog_names_the_reference_sites(self):
        """Every serving fault site the port passes through carries the
        reference's name."""
        _, tm = _pair("tiny")
        eng = tsched.ContinuousBatchingEngine(tm, device="cpu", **GEOM)
        eng.generate_many(_prompts(3, (9, 4)), max_new_tokens=3)
        assert {"page.alloc", "cb.admit", "cb.prefill",
                "cb.decode"} <= set(tfs.fault_points())


# --------------------------------------- deadlines, backpressure, cancel
class TestDeadlinesAndBackpressure:
    def test_ttl_steps_expires_deterministically(self, jax_ref):
        """Exact: a 3-step TTL expires (stage "deadline"); the other
        request equals the JAX engine's output."""
        prompts = _prompts(3, (8, 6))
        eng = tsched.ContinuousBatchingEngine(_pair("tiny")[1], device="cpu",
                                              **GEOM)
        ua = eng.add_request(prompts[0], max_new_tokens=30, ttl_steps=3)
        ub = eng.add_request(prompts[1], max_new_tokens=4)
        eng.drain()
        got = _outcome(eng, [ua, ub])
        assert got[0][:3] == ("failed", "deadline", "DeadlineExceededError")
        assert eng.deadline_expiries == 1
        np.testing.assert_array_equal(got[1][3], jax_ref["ttl"][0])
        assert_no_leak(eng)

    def test_wallclock_deadline_sheds_queued(self):
        _, tm = _pair("tiny")
        eng = tsched.ContinuousBatchingEngine(tm, device="cpu", **GEOM)
        u = eng.add_request(np.arange(8), max_new_tokens=4, deadline_ms=0.0)
        eng.drain()
        assert eng.status(u) == "failed"
        assert eng.failures()[u].error == "DeadlineExceededError"

    def test_default_deadline_ms_applies(self):
        _, tm = _pair("tiny")
        eng = tsched.ContinuousBatchingEngine(
            tm, device="cpu", default_deadline_ms=0.0, **GEOM)
        u = eng.add_request(np.arange(8), max_new_tokens=4)
        eng.drain()
        assert eng.status(u) == "failed"

    def test_queue_limit_typed_backpressure(self):
        _, tm = _pair("tiny")
        eng = tsched.ContinuousBatchingEngine(tm, device="cpu",
                                              queue_limit=2, **GEOM)
        p = np.arange(6)
        eng.add_request(p, max_new_tokens=2)
        eng.add_request(p.copy(), max_new_tokens=2)
        with pytest.raises(tsched.EngineBusyError, match="queue_limit=2"):
            eng.add_request(p.copy(), max_new_tokens=2)
        eng.drain()
        assert eng.health()["done"] == 2

    def test_cancel_queued_and_inflight(self, jax_ref):
        """Exact: the request behind a cancelled in-flight one equals the
        JAX engine's output."""
        _, tm = _pair("tiny")
        pa, pb = _prompts(4, (8, 7))
        eng = tsched.ContinuousBatchingEngine(tm, device="cpu",
                                              **dict(GEOM, max_batch=1))
        ua = eng.add_request(pa, max_new_tokens=8)
        ub = eng.add_request(pb, max_new_tokens=4)
        while eng.status(ua) != "decode":
            eng.step()
        assert eng.cancel(ua) is True
        assert eng.status(ua) == "cancelled"
        with pytest.raises(tsched.RequestCancelledError):
            eng.result(ua)
        eng.drain()
        ref = jax_ref["cancel"][0]
        np.testing.assert_array_equal(eng.result(ub), ref)
        assert eng.cancel(ub) is False
        with pytest.raises(tsched.UnknownRequestError):
            eng.cancel(12345)
        assert_no_leak(eng)

    def test_pool_pressure_evicts_cache_before_rejecting(self):
        _, tm = _pair("tiny")
        eng = tsched.ContinuousBatchingEngine(tm, device="cpu", max_len=32,
                                              page_size=8, max_batch=1)
        pa = (np.arange(16) % 128).astype(np.int64)
        pb = ((np.arange(16) + 7) % 128).astype(np.int64)
        eng.generate_many([pa], max_new_tokens=16)
        assert len(eng._prefix) > 0
        assert eng.generate_many([pb], max_new_tokens=16)[0].size == 32


# ------------------------------------------------- allocator diagnostics
class TestAllocatorDiagnostics:
    def test_double_free_names_page_and_refcount(self):
        a = PageAllocator(4)
        pg = a.alloc()
        a.free([pg])
        with pytest.raises(RuntimeError,
                           match=rf"double free of page {pg}.*refcount"):
            a.free([pg])

    def test_share_free_page_names_refcount(self):
        with pytest.raises(RuntimeError,
                           match=r"share\(\) of free page 2 \(refcount 0"):
            PageAllocator(4).share(2)

    def test_exhaustion_reports_pool_size(self):
        a = PageAllocator(2)
        a.alloc(), a.alloc()
        with pytest.raises(EngineFullError, match=r"0 of 2 available"):
            a.alloc()

    def test_alloc_fault_point(self):
        """page.alloc sits in PageAllocator.alloc: an armed fault raises
        before any page leaves the free list."""
        a = PageAllocator(2)
        with tfs.inject("page.alloc", nth=2):
            a.alloc()
            with pytest.raises(tfs.InjectedFault, match="page.alloc"):
                a.alloc()
        assert a.available == 1

    def test_idle_engine_full_reports_need_vs_available(self):
        _, tm = _pair("tiny")
        eng = tsched.ContinuousBatchingEngine(
            tm, device="cpu", max_len=32, page_size=8, max_batch=1,
            prefix_cache=False)
        held = [eng.allocator.alloc() for _ in range(3)]
        eng.add_request((np.arange(16) % 128).astype(np.int64),
                        max_new_tokens=8)
        with pytest.raises(EngineFullError,
                           match=r"needs 3 KV pages.*1 of 4"):
            eng.step()
        eng.allocator.free(held)


# ------------------------------------------------------------ chaos soak
def _soak(side, model, K):
    """The reference soak: 20 ragged requests on Poisson arrivals under
    seeded probabilistic faults on decode, prefill and page allocation,
    every 7th request with a tight TTL."""
    fs, cb = ((jfs, jsched.ContinuousBatchingEngine) if side == "jax" else
              (tfs, tsched.ContinuousBatchingEngine))
    kw = {"device": "cpu"} if side == "port" else {}
    rng = np.random.RandomState(42)
    n_req = 20
    lens = rng.randint(3, 14, n_req)
    budgets = rng.randint(3, 9, n_req)
    arrivals = np.cumsum(rng.poisson(2, n_req))
    arrivals -= arrivals[0]
    prompts = [rng.randint(0, 128, (int(t),)).astype(np.int64)
               for t in lens]
    eng = cb(model, max_len=64, page_size=8, max_batch=4, prefill_chunk=8,
             decode_block=K, **kw)
    uids = {}
    with fs.inject("cb.decode", p=0.02, seed=5, times=None), \
            fs.inject("cb.prefill", p=0.02, seed=9, times=None), \
            fs.inject("page.alloc", p=0.01, seed=11, times=None):
        pending = list(range(n_req))
        tick = 0
        while pending or len(eng):
            while pending and arrivals[pending[0]] <= tick:
                i = pending.pop(0)
                uids[i] = eng.add_request(
                    prompts[i], int(budgets[i]),
                    ttl_steps=6 if i % 7 == 3 else None)
            if not eng.step() and pending:
                tick = int(arrivals[pending[0]])
            else:
                tick += 1
    return eng, _outcome(eng, [uids[i] for i in range(n_req)])


class TestChaosSoak:
    def test_twenty_requests_under_random_faults(self, jax_ref):
        """Exact: the same requests fail at the same stages on both
        engines, every survivor equals the JAX engine's output, the engine
        never dies and the pool leaks nothing."""
        ref = jax_ref["soak"]
        eng, got = _soak("port", _pair("tiny")[1], 1)
        _same_outcome(ref, got, "soak")
        n_done = sum(g[0] == "done" for g in got)
        n_failed = sum(g[0] == "failed" for g in got)
        assert n_done + n_failed == 20 and n_done > 0 and n_failed > 0
        assert {g[1] for g in got if g[1]} <= {"admit", "prefill", "decode",
                                               "deadline"}
        assert eng.health()["failures"] == n_failed
        assert_no_leak(eng)


# ------------------------------------------------------- speculative faults
SPEC_GEOM = dict(max_len=64, page_size=8, max_batch=4, prefill_chunk=8,
                 slot_buckets=(4,))


def _spec_fault(side, point):
    """The speculative suite's case: a lone request meets `point` at its
    first boundary, then a second request is served. Returns the outcome
    (and the engine, on the port)."""
    prompts = _prompts(5, (9, 5))
    jm, tm = _pair("gqa")
    fs, cb, model, kw = ((jfs, jsched.ContinuousBatchingEngine, jm, {})
                         if side == "jax" else
                         (tfs, tsched.ContinuousBatchingEngine, tm,
                          {"device": "cpu"}))
    eng = cb(model, speculate=4, **SPEC_GEOM, **kw)
    with fs.inject(point, nth=1):
        lone = eng.add_request(prompts[0], max_new_tokens=8)
        eng.drain()
    ok = eng.add_request(prompts[1], max_new_tokens=4)
    eng.drain()
    out = _outcome(eng, [lone, ok])
    return out if side == "jax" else (out, eng)


class TestSpecFaults:
    @pytest.mark.parametrize("point,stage", [("cb.draft", "draft"),
                                             ("cb.verify", "decode")])
    def test_spec_fault_retires_one_request(self, point, stage, jax_ref):
        """Exact: the first draft (verify) boundary retires the lone
        request with stage "draft" ("decode", the plain decode boundary's
        stage); the engine keeps serving, and the next request equals the
        JAX engine's output."""
        got, eng = _spec_fault("port", point)
        _same_outcome(jax_ref[point], got, point)
        assert [o[:2] for o in got] == [("failed", stage), ("done", None)]
        assert_no_leak(eng)


# --------------------------------------------------------------- tp soak
class TestTPSoak:
    def test_ragged_stream_with_failures_tp2(self, jax_ref):
        """Exact: a ragged 10-request stream with a mid-stream per-request
        decode fault at tp = 2 (both shards on the CPU) has the unsharded
        engine's outcome (the same survivors, byte-identical outputs), and
        both equal the JAX engine's at tp = 1."""
        _, one = _both(jax_ref["tp_soak"], TP_SOAK)
        tfs.reset()
        _, prompts, budgets, faults, geom = TP_SOAK
        eng, two = _drive("port", _pair("micro")[1], prompts, budgets,
                          faults, geom, tp=2)
        _same_outcome(one, two, "tp=2")
        assert sum(o[0] == "failed" for o in two) == 1
        assert_no_leak(eng)
