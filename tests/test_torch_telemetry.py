"""The serving telemetry plane of paddle_tpu_torch
(inference/telemetry.py and ContinuousBatchingEngine(telemetry=...))
against paddle_tpu's.

Replays tests/test_telemetry.py (TestHistogram, TestRegistry,
TestWindowedPercentiles, TestTracedRun, the spec-pass and fault-hook legs,
JSONL streaming, the engines' device-time probes at tp = 1 and 2 and
through the megakernel). The router, tiering, handoff and failover legs wait for
ROADMAP A7.4, A7.6 and A7.7, the jax.profiler session tests for A9.3.

Exact: histogram percentiles and snapshots on the same samples, the
Prometheus text, greedy ids with telemetry on and off (and equal to the
JAX engine's), and every request's event sequence (names and attributes;
timestamps are the host's own) equal to the JAX engine's on the same
stream. The engine runs the reference suite's micro model (1 layer,
hidden 32, seed 3, weights carried across by name, f32 on the CPU).
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import scheduler as jsched
from paddle_tpu.inference import telemetry as jtel
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch import failsafe
from paddle_tpu_torch.convert import load_numpy_params
from paddle_tpu_torch.inference.scheduler import ContinuousBatchingEngine
from paddle_tpu_torch.inference.telemetry import (Histogram, MetricsRegistry,
                                                  SlidingWindowHistogram,
                                                  Telemetry, chrome_trace,
                                                  serve_prometheus)
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

torch.set_num_threads(1)

MICRO = dict(num_hidden_layers=1, hidden_size=32, intermediate_size=64,
             num_attention_heads=2)
ENGINE_KW = dict(max_len=64, page_size=8, max_batch=2, prefill_chunk=8)
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


def mk(**kw):
    return ContinuousBatchingEngine(_pair()[1], device="cpu",
                                    **dict(ENGINE_KW, **kw))


def stream(n=20, seed=0):
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, 128, (int(t),)).astype(np.int64)
               for t in rng.randint(4, 14, n)]
    budgets = [int(b) for b in rng.randint(3, 8, n)]
    return prompts, budgets


def _events(tel, uid):
    return [(n, a) for _, n, a in tel.trace("engine", uid).events]


@pytest.fixture(scope="module")
def traced_run():
    """The acceptance run: 20 seeded ragged requests at decode_block 4,
    telemetry off then on, and the JAX engine's telemetry-on run of the
    same stream."""
    prompts, budgets = stream()
    kw = dict(max_batch=4, decode_block=4)
    ref = mk(**kw).generate_many(prompts, max_new_tokens=budgets)
    tel = Telemetry()
    eng = mk(telemetry=tel, **kw)
    outs = eng.generate_many(prompts, max_new_tokens=budgets)
    jt = jtel.Telemetry()
    jouts = jsched.ContinuousBatchingEngine(
        _pair()[0], telemetry=jt, **dict(ENGINE_KW, **kw)).generate_many(
            prompts, max_new_tokens=budgets)
    yield prompts, budgets, ref, outs, tel, eng, jouts, jt
    tel.close()
    jt.close()


# ------------------------------------------------------------------ units
_SAMPLES = (0.15, 0.15, 3.0, 3.0, 3.0, 300.0, 7.5, 0.02, 61000.0, 49.0)


class TestHistogram:
    def test_observe_and_percentiles(self):
        h = Histogram()
        for v in (0.15, 0.15, 3.0, 3.0, 3.0, 300.0):
            h.observe(v)
        assert h.count == 6
        assert h.vmin == 0.15 and h.vmax == 300.0
        assert 2.0 <= h.percentile(50) <= 5.0
        assert 200.0 <= h.percentile(99) <= 500.0
        assert h.percentile(0) <= h.percentile(100)

    @pytest.mark.parametrize("p", [0, 10, 25, 50, 75, 90, 95, 99, 100])
    def test_percentiles_equal_reference(self, p):
        """Exact: the same samples give the reference's percentile."""
        a, b = Histogram(), jtel.Histogram()
        for v in _SAMPLES:
            a.observe(v)
            b.observe(v)
        assert a.percentile(p) == b.percentile(p)
        assert a.snapshot() == b.snapshot()

    def test_overflow_bucket_reports_max(self):
        h = Histogram()
        h.observe(1e9)
        assert h.percentile(99) == 1e9

    def test_merge_adds(self):
        a, b = Histogram(), Histogram()
        a.observe(1.0)
        b.observe(100.0)
        b.observe(100.0)
        a.merge(b)
        assert a.count == 3
        assert a.vmax == 100.0 and a.vmin == 1.0
        with pytest.raises(ValueError):
            a.merge(Histogram(buckets=(1.0, 2.0)))

    def test_empty(self):
        h = Histogram()
        assert h.percentile(99) == 0.0
        assert h.snapshot() == {"count": 0}


class TestRegistry:
    def test_rates_from_counter_samples(self):
        reg = MetricsRegistry()
        assert reg.sample({"steps": 0, "name": "x"}) == {}
        rates = reg.sample({"steps": 50, "name": "x"})
        assert rates["steps_per_s"] > 0
        assert "name_per_s" not in rates

    def test_merged_fleet_view(self):
        a, b = MetricsRegistry(), MetricsRegistry()
        a.observe("ttft_ms", 10.0)
        a.count("requests_done")
        b.observe("ttft_ms", 20.0)
        b.count("requests_done", 2)
        fleet = MetricsRegistry.merged([a, b])
        assert fleet.hist["ttft_ms"].count == 2
        assert fleet.counters["requests_done"] == 3

    def test_prometheus_text_equals_reference(self):
        """Exact: the exposition text is the reference's."""
        regs = MetricsRegistry(), jtel.MetricsRegistry()
        for reg in regs:
            for v in _SAMPLES:
                reg.observe("ttft_ms", v)
            reg.count("requests_done", 7)
        text = regs[0].prometheus()
        assert text == regs[1].prometheus()
        assert "# TYPE paddle_tpu_ttft_ms histogram" in text
        assert f'paddle_tpu_ttft_ms_bucket{{le="+Inf"}} {len(_SAMPLES)}' \
            in text
        assert "paddle_tpu_requests_done 7" in text

    def test_serve_prometheus_endpoint(self):
        """/metrics answers with the registry's text on a local port."""
        import urllib.request
        reg = MetricsRegistry()
        reg.count("requests_done", 3)
        srv = serve_prometheus(reg)
        try:
            url = f"http://127.0.0.1:{srv.server_address[1]}/metrics"
            with urllib.request.urlopen(url, timeout=10) as r:
                assert r.read().decode() == reg.prometheus()
        finally:
            srv.shutdown()


class TestWindowedPercentiles:
    def test_window_reflects_recent_not_lifetime(self):
        reg = MetricsRegistry(window_s=10.0)
        reg.observe("ttft_ms", 100.0, now=0.0)
        reg.observe("ttft_ms", 100.0, now=3.0)
        reg.observe("ttft_ms", 500.0, now=20.0)
        assert reg.hist["ttft_ms"].count == 3
        w = reg.window_hist("ttft_ms", now=21.0)
        assert w.count == 1 and w.percentile(99) > 200.0
        assert reg.window_hist("ttft_ms", now=200.0).count == 0

    def test_window_snapshot_schema_pinned(self):
        reg = MetricsRegistry(window_s=10.0)
        reg.observe("queue_wait_ms", 5.0)
        assert frozenset(reg.window_snapshot()["queue_wait_ms"]) == \
            frozenset({"count", "sum_ms", "min_ms", "max_ms", "p50_ms",
                       "p90_ms", "p95_ms", "p99_ms", "window_s"})
        assert "windows" in reg.snapshot()
        empty = reg.window_snapshot(now=1e9)["queue_wait_ms"]
        assert empty == {"count": 0, "window_s": 10.0}

    def test_merge_aggregates_windows(self):
        a = MetricsRegistry(window_s=10.0)
        b = MetricsRegistry(window_s=10.0)
        a.observe("ttft_ms", 10.0, now=20.0)
        b.observe("ttft_ms", 30.0, now=20.5)
        b.merge(a)
        assert b.window_hist("ttft_ms", now=21.0).count == 2

    def test_state_ships_ages_not_timestamps(self):
        tel = Telemetry(name="w0", capture_faults=False)
        tel.registry.observe("tpot_ms", 7.0)
        state = tel.state()
        win = SlidingWindowHistogram.install(state["win"]["tpot_ms"])
        assert win.window().count == 1
        assert all(age >= 0 for age, _ in state["win"]["tpot_ms"]["slices"])


# ------------------------------------------------------ the acceptance run
class TestTracedRun:
    def test_outputs_byte_identical_on_vs_off(self, traced_run):
        """Exact: telemetry on equals off, and the JAX engine's ids."""
        _, _, ref, outs, _, _, jouts, _ = traced_run
        for i, (a, b, c) in enumerate(zip(ref, outs, jouts)):
            np.testing.assert_array_equal(b, a, err_msg=f"request {i}")
            np.testing.assert_array_equal(b, c, err_msg=f"request {i}")

    def test_event_sequences_equal_reference(self, traced_run):
        """Exact: every request's events (names and attributes) are the
        JAX engine's, so each fires at the reference's site."""
        prompts, _, _, _, tel, _, _, jt = traced_run
        for u in range(len(prompts)):
            assert _events(tel, u) == _events(jt, u), u

    def test_every_retired_request_has_complete_chain(self, traced_run):
        prompts, _, _, _, tel, _, _, _ = traced_run
        done = tel.done_traces()
        assert len(done) == len(prompts)
        for tr in done:
            assert tr.state == "done" and tr.complete_chain(), tr.phases()
            assert tr.t_submit <= tr.t_seat <= tr.t_first <= tr.t_done

    def test_histogram_counts_equal_retired_requests(self, traced_run):
        prompts, _, _, _, tel, _, _, jt = traced_run
        reg, n = tel.registry, len(prompts)
        for name in ("ttft_ms", "tpot_ms", "queue_wait_ms", "e2e_ms"):
            assert reg.hist[name].count == n
        assert reg.counters["requests_done"] == n
        assert reg.hist["block_ms"].count == reg.counters["blocks"] > 0
        assert reg.counters == jt.registry.counters

    def test_chrome_trace_perfetto_loadable(self, traced_run, tmp_path):
        prompts, _, _, _, tel, _, _, _ = traced_run
        with open(tel.export_chrome_trace(str(tmp_path / "t.json"))) as f:
            evs = json.load(f)["traceEvents"]
        assert evs and all({"ph", "name", "pid", "tid"} <= set(e)
                           for e in evs)
        for uid in range(len(prompts)):
            names = {e["name"] for e in evs
                     if e["tid"] == uid and e["ph"] == "X"}
            assert {"queue", "prefill", "decode"} <= names, (uid, names)
            assert any(e["name"] == "retire" for e in evs
                       if e["tid"] == uid)
        assert chrome_trace([tel])["traceEvents"]

    def test_tpot_is_not_e2e(self, traced_run):
        reg = traced_run[4].registry
        assert reg.hist["tpot_ms"].percentile(50) < \
            reg.hist["e2e_ms"].percentile(50)

    def test_jsonl_export(self, traced_run, tmp_path):
        tel = traced_run[4]
        with open(tel.export_jsonl(str(tmp_path / "e.jsonl"))) as f:
            lines = [json.loads(ln) for ln in f]
        assert lines and all("t" in e and "ev" in e for e in lines)
        assert any(e["ev"] == "retire" for e in lines)


# ---------------------------------------------------------- lifecycle legs
class TestLegs:
    def test_spec_pass_events_carry_accept_counts(self):
        eng = mk(speculate=4, drafter="ngram", telemetry=True)
        motif = np.random.RandomState(5).randint(0, 128, (4,)).astype(
            np.int64)
        u = eng.add_request(np.tile(motif, 4), max_new_tokens=8)
        eng.drain()
        tr = eng.telemetry.trace("engine", u)
        passes = [a for _, n, a in tr.events if n == "spec_pass"]
        assert passes, tr.phases()
        assert all({"offered", "accepted", "emitted"} <= set(a)
                   for a in passes)
        # the first token comes from prefill, every later one from a pass
        assert sum(a["emitted"] for a in passes) == tr.n_tokens - 1
        assert eng.telemetry.registry.hist["draft_ms"].count > 0
        eng.telemetry.close()

    def test_preempt_event_carries_folded(self):
        """A preempted request's trace shows "preempt" with the tokens it
        folded into its prompt, then a second seat, and stays whole."""
        tel = Telemetry()
        eng = mk(max_batch=1, telemetry=tel,
                 tenants={"gold": {"priority": 5}})
        rng = np.random.RandomState(9)
        a = eng.add_request(rng.randint(0, 128, (8,)), max_new_tokens=12)
        for _ in range(4):
            eng.step()
        eng.add_request(rng.randint(0, 128, (9,)), max_new_tokens=3,
                        tenant="gold")
        eng.drain()
        tr = tel.trace("engine", a)
        pre = [at for _, n, at in tr.events if n == "preempt"]
        assert len(pre) == 1 and pre[0]["folded"] > 0
        assert tr.phases().count("seat") == 2 and tr.complete_chain()
        assert tr.n_tokens == 12 - pre[0]["folded"]
        tel.close()

    def test_fault_hook_records_engine_faults(self):
        tel = Telemetry()
        eng = mk(telemetry=tel)
        u = eng.add_request(np.random.RandomState(17).randint(0, 128, (6,)),
                            max_new_tokens=4)
        with failsafe.inject("cb.decode", nth=1):
            eng.drain()
        faults = [e for e in tel.log if e.get("ev") == "fault"]
        assert faults and faults[0]["point"] == "cb.decode"
        assert faults[0]["detail"] == f"uid={u}"
        tr = tel.trace("engine", u)
        assert tr.state == "failed" and tr.stage == "decode"
        tel.close()

    def test_per_step_prefill_chunks_observed(self):
        """decode_block 1: each prefill chunk lands in prefill_chunk_ms
        and in the request's trace."""
        tel = Telemetry()
        eng = mk(telemetry=tel)
        u = eng.add_request(np.arange(20) % 128, max_new_tokens=3)
        eng.drain()
        chunks = [a for _, n, a in tel.trace("engine", u).events
                  if n == "prefill_chunk"]
        assert [c["filled"] for c in chunks] == [8, 16, 20]
        assert tel.registry.hist["prefill_chunk_ms"].count == 3
        tel.close()

    @pytest.mark.parametrize("tp,mk_mode", [(1, False), (2, False),
                                            (1, "multi")])
    def test_dispatch_seconds_and_probe(self, tp, mk_mode):
        """The reference's probe assertions (test_telemetry.py
        test_dispatch_seconds_and_probe) on the port's engine, at tp = 1
        and tp = 2 and through the megakernel: the alias, a positive probe
        on an idle engine, a busy share in [0, 1], the refusal while busy;
        the probe drops the prefix cache and leaks no page."""
        eng = mk(tp=tp, megakernel=mk_mode)
        rng = np.random.RandomState(23)
        p = rng.randint(0, 128, (6,)).astype(np.int64)
        want = eng.generate_many([p], max_new_tokens=3)[0]
        assert eng.dispatch_seconds > 0
        assert eng.device_seconds == eng.dispatch_seconds  # alias
        t = eng.probe_device_step_seconds(iters=3)
        assert t > 0
        assert 0.0 <= eng.device_busy_frac(1.0, 10, t) <= 1.0
        h = eng.health()
        assert h["prefix_pages"] == 0
        assert h["pages_free"] == h["pages_total"]
        # busy engines refuse: the probe clobbers page-0 KV slots
        eng.add_request(p, max_new_tokens=3)
        with pytest.raises(RuntimeError, match="idle"):
            eng.probe_device_step_seconds()
        eng.drain()
        # the probe's garbage KV reaches no later request
        np.testing.assert_array_equal(
            eng.generate_many([p], max_new_tokens=3)[0], want)

    def test_jsonl_streaming(self, tmp_path):
        path = str(tmp_path / "stream.jsonl")
        tel = Telemetry(jsonl_path=path, flush_every=4)
        eng = mk(telemetry=tel)
        eng.generate_many([np.random.RandomState(29).randint(0, 128, (6,))],
                          max_new_tokens=3)
        tel.flush()
        with open(path) as f:
            lines = [json.loads(ln) for ln in f]
        assert any(e["ev"] == "submit" for e in lines)
        assert any(e["ev"] == "retire" for e in lines)
        tel.close()

    def test_detach(self):
        eng = mk(telemetry=True)
        eng.attach_telemetry(None)
        assert eng.telemetry is None
        eng.generate_many([np.arange(5)], max_new_tokens=2)
