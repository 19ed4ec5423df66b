"""The process fleet of paddle_tpu_torch against the JAX package's.

Replays tests/test_fleet.py on the reference's micro LLaMA (1 layer,
hidden 32, ffn 64, 2 heads; f32; page 8, 2 slots; weights carried over
with `convert.load_numpy_params`; the port's engines on the CPU). Most
scenarios ride IN-THREAD `EngineHost` workers (the full wire path:
sockets, framing, pickle, store rendezvous, ledger; no process spawn) and
run once per package: the JAX fleet (on its native TCPStore) in a module
fixture, the port's (on `torch.distributed.TCPStore`) in the tests.

Exact (no tolerance): every greedy id; the merged fleet metrics' keys and
counts; the failover, delivery and handoff counters and the transports
the handoffs took. One real 2-process fleet (`spawn_fleet`, spawned once
for the module) is killed -9 mid-stream and respawned; its ids equal the
port's in-process router on the same spec. Every RPC answer is a host
value: none holds a torch.Tensor.
"""
import os
import signal
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import failsafe as jfs
from paddle_tpu.distributed.store import TCPStore as JaxStore
from paddle_tpu.inference import fleet as jfleet
from paddle_tpu.inference import router as jrouter
from paddle_tpu.inference import scheduler as jsched
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch import failsafe as tfs
from paddle_tpu_torch import serve_llama
from paddle_tpu_torch.convert import load_numpy_params
from paddle_tpu_torch.distributed import rpc as trpc
from paddle_tpu_torch.distributed.store import TCPStore
from paddle_tpu_torch.inference import adapters as tad
from paddle_tpu_torch.inference import fleet as tfleet
from paddle_tpu_torch.inference import router as trouter
from paddle_tpu_torch.inference import scheduler as tsched
from paddle_tpu_torch.inference.handoff import negotiate
from paddle_tpu_torch.inference.scheduler import (EngineBusyError,
                                                  RequestNotFinishedError,
                                                  UnknownRequestError)
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MICRO = dict(num_hidden_layers=1, hidden_size=32, intermediate_size=64,
             num_attention_heads=2)
ENGINE_KW = dict(max_len=64, page_size=8, max_batch=2, prefill_chunk=8)
# the spec REAL worker processes build from: the port's own draw (seed 3),
# the in-process router of the process-fleet test builds from it too
SPEC = {"model": {"preset": "tiny", "seed": 3, **MICRO},
        "engine": dict(ENGINE_KW, device="cpu")}
_MODELS = {}


@pytest.fixture(autouse=True)
def _clean_faults():
    jfs.reset()
    tfs.reset()
    yield
    jfs.reset()
    tfs.reset()


def _models():
    """(JAX model, port model) with identical weights drawn in JAX."""
    if not _MODELS:
        paddle.seed(3)
        jm = JaxLlama(JaxConfig.tiny(**MICRO))
        tm = LlamaForCausalLM(LlamaConfig.tiny(**MICRO), device="cpu")
        load_numpy_params(tm, {n: np.asarray(p.data)
                               for n, p in jm.named_parameters()})
        _MODELS["m"] = (jm, tm)
    return _MODELS["m"]


_STORES = {}


def side(name):
    """One package's fleet module, router, fault registry, engine factory
    and (one per package, shared) master store."""
    jm, tm = _models()
    if name not in _STORES:
        _STORES[name] = (JaxStore if name == "jax" else TCPStore)(
            "127.0.0.1", 0, is_master=True, world_size=1)
    if name == "jax":
        return types.SimpleNamespace(
            name=name, fleet=jfleet, router=jrouter, fs=jfs,
            store=_STORES[name],
            factory=lambda **over: (
                lambda: jsched.ContinuousBatchingEngine(
                    jm, **dict(ENGINE_KW, **over))))
    return types.SimpleNamespace(
        name=name, fleet=tfleet, router=trouter, fs=tfs,
        store=_STORES[name],
        factory=lambda **over: (
            lambda: tsched.ContinuousBatchingEngine(
                tm, device="cpu", **dict(ENGINE_KW, **over))))


def stream(n=4, seed=0):
    cfg = LlamaConfig.tiny(**MICRO)
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab_size, (int(t),)).astype(np.int64)
               for t in rng.randint(4, 14, n)]
    budgets = [int(b) for b in rng.randint(3, 8, n)]
    return prompts, budgets


def worker(s, name, **over):
    """In-thread EngineHost + its ProcessReplica. ledger_every=1: the
    ledger-salvage checks need the store fresh at the step a worker dies."""
    host = s.fleet.EngineHost(s.factory(**over)(), name, s.store,
                              ledger_every=1).start()
    return host, s.fleet.ProcessReplica(name, s.store, call_timeout=60)


def results(r, uids):
    return [np.asarray(r.result(u)) for u in uids]


def no_leak(rep):
    st = rep._call("alloc_stats")
    return st["available"] == st["n_pages"] - st["prefix_pages"]


def counters(r):
    h = r.health()
    return {k: h[k] for k in ("failovers", "requeued", "duplicates_dropped",
                              "done", "failed", "pending", "kv_handoffs",
                              "handoff_failures")}


# -- scenarios (each runs through one package) ----------------------------------
def sc_single(s):
    prompts, budgets = stream()
    return {"ids": [np.asarray(x) for x in s.factory()().generate_many(
        prompts, max_new_tokens=budgets)]}


def sc_routing(s):
    """Two in-thread workers behind one router with telemetry: ids, the
    merged metrics' keys and counts, the fleet-mode health entry."""
    hosts, reps = zip(*(worker(s, f"p{i}") for i in range(2)))
    try:
        prompts, budgets = stream()
        router = s.router.EngineRouter(backends=list(reps), telemetry=True)
        uids = [router.add_request(p, max_new_tokens=b)
                for p, b in zip(prompts, budgets)]
        router.drain()
        m = router.metrics()
        return {"ids": results(router, uids), "c": counters(router),
                "top": sorted(m), "router": sorted(m["router"]),
                "replicas": sorted(m["replicas"]),
                "hist": sorted(m["fleet"]["histograms"]),
                "counts": {n: h["count"] for n, h in
                           m["fleet"]["histograms"].items()},
                "done": m["fleet"]["counters"]["requests_done"],
                "ttft_by_rep": sum(st["histograms"].get("ttft_ms", {}).get(
                    "count", 0) for st in m["replicas"].values()),
                "worker_keys": sorted(router.health()["replicas"]["p0"][
                    "worker"]),
                "prom": [k in router.prometheus() for k in (
                    "paddle_tpu_ttft_ms_bucket", "paddle_tpu_requests_done")],
                "no_leak": [no_leak(r) for r in reps]}
    finally:
        for h in hosts:
            h.stop()


def sc_kill(s):
    """An in-thread worker goes dark mid-stream (sockets closed, no
    replies): its requests salvage from the STORE LEDGER."""
    (h0, r0), (h1, r1) = worker(s, "kl0"), worker(s, "kl1")
    try:
        prompts, budgets = stream()
        router = s.router.EngineRouter(backends=[r0, r1],
                                       probe_backoff=10_000)
        uids = [router.add_request(p, max_new_tokens=b)
                for p, b in zip(prompts, budgets)]
        for _ in range(5):
            router.step()
        live = [u for u in router._assigned["kl0"]
                if router._reqs[u].state in ("queued", "prefill", "decode")]
        h0.kill_connections()
        h0.stop()
        led = None
        if live:
            led = r0.export_resume(router._reqs[live[0]].engine_uid)
            led = {k: led[k] for k in ("max_new_tokens", "generated")}
        router.drain()
        return {"ids": results(router, uids), "c": counters(router),
                "live": len(live), "led": led, "no_leak": no_leak(r1),
                "requeues": [router._reqs[u].requeues for u in uids]}
    finally:
        h1.stop()


def sc_store_disagg(s):
    (h0, r0), (h1, r1) = worker(s, "sx0"), worker(s, "sx1")
    try:
        prompts, budgets = stream()
        router = s.router.EngineRouter(backends=[r0, r1],
                                       topology={"prefill": 1, "decode": 1})
        uids = [router.add_request(p, max_new_tokens=b)
                for p, b in zip(prompts, budgets)]
        router.drain()
        return {"ids": results(router, uids), "c": counters(router),
                "transports": dict(router.handoff_transports),
                "no_leak": [no_leak(r0), no_leak(r1)]}
    finally:
        h0.stop()
        h1.stop()


def sc_device_fault(s):
    prompts, budgets = stream()
    router = s.router.EngineRouter(s.factory(),
                                   topology={"prefill": 1, "decode": 1})
    uids = [router.add_request(p, max_new_tokens=b)
            for p, b in zip(prompts, budgets)]
    with s.fs.inject("transport.device", p=1.0, seed=0):
        router.drain()
    return {"ids": results(router, uids), "c": counters(router),
            "transports": dict(router.handoff_transports)}


def sc_mirror(s):
    """ReplicaTelemetryMirror across a respawn: histograms of the dead
    incarnation fold into the mirror's base; the windows are the live
    incarnation's."""
    host, rep = worker(s, "tm0")
    holder = [host]

    def respawn():
        holder.append(s.fleet.EngineHost(s.factory()(), "tm0",
                                         s.store).start())
    rep.respawn = respawn
    try:
        prompts, budgets = stream()
        router = s.router.EngineRouter(backends=[rep], telemetry=True)
        uids = [router.add_request(p, max_new_tokens=b)
                for p, b in zip(prompts[:2], budgets[:2])]
        router.drain()
        before = router.metrics()["fleet"]["histograms"]["ttft_ms"]["count"]
        host.kill_connections()
        host.stop()
        rep.rebuild()
        uids += [router.add_request(p, max_new_tokens=b)
                 for p, b in zip(prompts[2:], budgets[2:])]
        router.drain()
        m = router.metrics()["fleet"]
        return {"ids": results(router, uids), "before": before,
                "ttft": m["histograms"]["ttft_ms"]["count"],
                "win_ttft": m["windows"]["ttft_ms"]["count"],
                "done": m["counters"]["requests_done"],
                "respawns": rep.respawns}
    finally:
        for h in holder:
            h.stop()


def sc_adapters(s, path):
    """The adapter registry write over RPC: every worker hot-loads the
    adapter from one path; adapter and base requests through the fleet."""
    hosts, reps = zip(*(worker(s, f"ad{i}", adapters={"rank": 4})
                        for i in range(2)))
    try:
        router = s.router.EngineRouter(backends=list(reps))
        summary = router.load_adapter("a1", path)
        prompts, budgets = stream()
        names = ["a1", None, "a1", None]
        uids = [router.add_request(p, max_new_tokens=b, adapter=n)
                for p, b, n in zip(prompts, budgets, names)]
        router.drain()
        return {"ids": results(router, uids), "summary": summary,
                "registry": [dict(r.adapters) for r in reps]}
    finally:
        for h in hosts:
            h.stop()


SCENARIOS = {"single": sc_single, "routing": sc_routing, "kill": sc_kill,
             "store": sc_store_disagg, "device_fault": sc_device_fault,
             "mirror": sc_mirror}


@pytest.fixture(scope="module")
def adapter_path(tmp_path_factory):
    _, tm = _models()
    path = str(tmp_path_factory.mktemp("fleet_adapters") / "a1")
    tad.save_adapter(path, tad.make_lora_adapter(tm.config, rank=4, seed=1,
                                                 init_std=0.5))
    return path


@pytest.fixture(scope="module")
def ref(adapter_path):
    """Every scenario through the JAX fleet (in-thread JAX workers on the
    JAX TCPStore)."""
    out = {}
    for name, fn in SCENARIOS.items():
        jfs.reset()
        out[name] = fn(side("jax"))
    out["adapters"] = sc_adapters(side("jax"), adapter_path)
    jfs.reset()
    return out


def _port(name):
    return SCENARIOS[name](side("port"))


def same_ids(a, b, tag=""):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(y, x, err_msg=f"{tag} request {i}")


class TestWire:
    def test_typed_errors_survive_the_wire(self):
        s = side("port")
        host, rep = worker(s, "wire0", queue_limit=1)
        try:
            with pytest.raises(UnknownRequestError):
                rep.result(999)
            with pytest.raises(UnknownRequestError) as ei:
                rep.status(999)
            assert ei.value.__cause__ is not None   # the worker traceback
            prompts, _ = stream(n=3, seed=5)
            spec = {"prompt": prompts[0], "max_new_tokens": 4,
                    "eos_token_id": None, "tenant": "default",
                    "priority": None, "ttl_steps": None, "deadline": None}
            uid = rep.submit(spec)
            with pytest.raises(RequestNotFinishedError):
                rep.result(uid)
            rep.step()
            rep.submit(dict(spec, prompt=prompts[1]))
            with pytest.raises(EngineBusyError):
                rep.submit(dict(spec, prompt=prompts[2]))
            while rep.has_work():
                rep.step()
            assert rep.status(uid) == "done"
            assert rep.result(uid).size == prompts[0].size + 4
        finally:
            host.stop()

    def test_deadline_ships_relative_and_rebases(self):
        s = side("port")
        host, rep = worker(s, "dl0")
        try:
            prompts, _ = stream(n=1, seed=6)
            deadline = time.monotonic() + 5.0
            uid = rep.submit({"prompt": prompts[0], "max_new_tokens": 8,
                              "eos_token_id": None, "tenant": "default",
                              "priority": None, "ttl_steps": None,
                              "deadline": deadline})
            wire = rep._call("export_resume", uid)
            assert wire["deadline"] is None
            assert 3500 < wire["deadline_remaining_ms"] <= 5000
            rem = rep.export_resume(uid)["deadline"] - time.monotonic()
            assert 3.0 < rem <= 5.0
            led = rep._ledger()
            assert led[uid]["deadline"] is None
            assert led[uid]["deadline_remaining_ms"] <= 5000
            # the same wire forms as the reference's helpers
            spec = {"deadline": time.monotonic() + 2.0, "x": 1}
            a, b = tfleet._ship_spec(spec), jfleet._ship_spec(spec)
            assert a.keys() == b.keys() and a["deadline"] is None
            assert abs(a["deadline_remaining_ms"]
                       - b["deadline_remaining_ms"]) < 50
        finally:
            host.stop()

    def test_transport_negotiation_units(self):
        s = side("port")
        a = trouter.EngineRouter(s.factory(), replicas=2)
        e0, e1 = (r.transport_endpoint() for r in a._replicas[:2])
        assert negotiate(e0, e1) == "device"
        hosts, reps = zip(*(worker(s, f"ng{i}") for i in range(2)))
        try:
            w0, w1 = (r.transport_endpoint() for r in reps)
            assert w0["proc"] != w1["proc"] and w0["backend"] == "cpu"
            assert w0["proc"].startswith("host:")
            assert negotiate(w0, w1) == "store"
            assert negotiate(e0, w0) == "host"
            assert negotiate(None, w0) == "host"
        finally:
            for h in hosts:
                h.stop()

    def test_rpc_fault_point_is_injectable(self):
        s = side("port")
        host, rep = worker(s, "ft0")
        try:
            with tfs.inject("rpc.call", nth=1):
                with pytest.raises(tfs.InjectedFault) as ei:
                    rep.headroom()
            assert ei.value.point == "rpc.call"
            with tfs.inject("fleet.heartbeat", nth=1):
                with pytest.raises(tfs.InjectedFault):
                    rep.step()
            assert "rpc.call" in tfs.fault_points()
        finally:
            host.stop()

    def test_no_rpc_response_holds_a_tensor(self, monkeypatch):
        """Every reply a worker sends is host data: the routing, handoff,
        prefix-ship, telemetry, weight and launch-count RPCs of a fleet."""
        replies = []
        orig = tfleet.send_msg

        def recording(sock, payload):
            replies.append(payload)
            return orig(sock, payload)

        monkeypatch.setattr(tfleet, "send_msg", recording)
        s = side("port")
        (h0, r0), (h1, r1) = worker(s, "nt0"), worker(s, "nt1")
        try:
            prompts, budgets = stream()
            router = trouter.EngineRouter(
                backends=[r0, r1], topology={"prefill": 1, "decode": 1},
                telemetry=True)
            uids = [router.add_request(p, max_new_tokens=b)
                    for p, b in zip(prompts, budgets)]
            router.drain()
            for r in (r0, r1):
                r.sync_telemetry()      # the full trace plane
            assert router.kv_handoffs >= 1
            w = r0.export_weights()
            r1.install_weights(w)
            assert r0.kernel_launches()["paged_attention"] == 0
            r0.health()
            euid = r0.submit({"prompt": prompts[0], "max_new_tokens": 3,
                              "eos_token_id": None, "tenant": "default",
                              "priority": None, "ttl_steps": None,
                              "deadline": None})
            r0.export_resume(euid)
            r0.evict(euid)
            payload = r0.export_prefix(prompts[0])
            if payload is not None:
                r0.abort_prefix_export(payload["token"])
        finally:
            h0.stop()
            h1.stop()

        def tensors(x, path="reply"):
            if torch.is_tensor(x):
                yield path
            elif isinstance(x, dict):
                for k, v in x.items():
                    yield from tensors(v, f"{path}[{k!r}]")
            elif isinstance(x, (list, tuple)):
                for i, v in enumerate(x):
                    yield from tensors(v, f"{path}[{i}]")
            elif hasattr(x, "__dict__") and not isinstance(x, type):
                yield from tensors(vars(x), f"{path}.")

        assert len(replies) > 50
        found = [p for rep in replies for p in tensors(rep)]
        assert not found, found[:5]
        # the weight tree crossed as numpy: bf16 would travel as '<V2'
        assert all(isinstance(a, np.ndarray) for a in
                   (w["emb"], w["norm"], w["layers"][0]["wq"]))

    def test_cost_model_forms_refuse_typed(self):
        """The cost model's forms, refused until the planner was ported,
        now work as the reference's: an `EngineSpec` builds and resolves to
        the engine its spec dict builds (the same ids), and
        `traffic_target` sizes a real fleet through `size_fleet`, with the
        JAX package's sizing record (exact floats) on `handle.plan`. With
        neither n nor a traffic target, or a traffic target over a
        callable factory, spawn_fleet raises ValueError."""
        from paddle_tpu.cost_model import Calibration as JaxCalibration
        from paddle_tpu.cost_model import size_fleet as jax_size_fleet
        from paddle_tpu_torch.cost_model import Calibration, EngineSpec
        spec = EngineSpec(model=dict(SPEC["model"]), max_len=64, page_size=8,
                          max_batch=2, engine_extra={"prefill_chunk": 8,
                                                     "device": "cpu"})
        prompt = np.arange(1, 10, dtype=np.int64)

        def ids(eng):
            return eng.generate_many([prompt], max_new_tokens=4)[0]

        want = ids(tfleet.build_engine_from_spec(SPEC))
        np.testing.assert_array_equal(
            ids(tfleet.build_engine_from_spec(spec)), want)
        np.testing.assert_array_equal(ids(tfleet.resolve_factory(spec)()),
                                      want)
        target = {"qps": 5.0, "prompt_len": 16, "gen_tokens": 8}
        _, record = jax_size_fleet(
            {"model": dict(SPEC["model"]), "engine": dict(ENGINE_KW)},
            calib=JaxCalibration(backend="cpu"), **target)
        handle = tfleet.spawn_fleet(
            SPEC, traffic_target=dict(target,
                                      calib=Calibration(backend="cpu")))
        try:
            assert handle.plan == record and record["replicas"] == 1
            assert len(handle.replicas) == 1 and handle.replicas[0].health()
        finally:
            handle.shutdown()
        with pytest.raises(ValueError, match="spec-dict"):
            tfleet.spawn_fleet(lambda: None, traffic_target=target)
        with pytest.raises(ValueError):
            tfleet.spawn_fleet(SPEC)

    def test_store_round_trips_large_values(self):
        store = side("port").store
        n0 = store.num_keys()
        rng = np.random.RandomState(0)
        big = rng.bytes((9 << 20) + 5)
        store.set("big/v", big)
        assert store.get("big/v") == big
        assert store.get("big/missing", wait=False) is None
        n = store.num_keys()
        big2 = rng.bytes(5 << 20)           # another long value: the old
        store.set("big/v", big2)            # chunks go
        assert store.get("big/v") == big2 and store.num_keys() < n
        store.set("big/v", b"small")        # a short value: the same
        assert store.get("big/v") == b"small"
        assert store.num_keys() == n0 + 1
        store.set("big/w", big)
        assert store.delete_key("big/v") and store.delete_key("big/w")
        assert store.num_keys() == n0 and not store.check(["big/v"])
        assert store.add("big/n", 2) == 2 and store.add("big/n") == 3
        with pytest.raises(TimeoutError):
            store.wait(["big/never"], timeout_ms=50)

    def test_framing_matches_the_reference(self):
        from paddle_tpu.distributed.rpc import rpc as jrpc
        import socket
        a, b = socket.socketpair()
        try:
            msg = ("step", (1, [2, 3]), {"k": np.arange(3)})
            trpc.send_msg(a, msg)
            got = jrpc.recv_msg(b)
            assert got[0] == "step" and got[1] == (1, [2, 3])
            jrpc.send_msg(b, {"ok": True})
            assert trpc.recv_msg(a) == {"ok": True}
        finally:
            a.close()
            b.close()


class TestFleetRouting:
    def test_ids_equal_the_jax_fleet(self, ref):
        got = _port("routing")
        same_ids(ref["single"]["ids"], got["ids"], "fleet vs JAX engine")
        same_ids(ref["routing"]["ids"], got["ids"], "fleet vs JAX fleet")
        assert all(got["no_leak"]) and got["c"]["failed"] == 0

    def test_metrics_keys_and_counts_equal_the_jax_fleet(self, ref):
        got, want = _port("routing"), ref["routing"]
        assert got["top"] == ["fleet", "replicas", "router"]
        for k in ("top", "replicas", "hist", "counts", "done",
                  "ttft_by_rep", "worker_keys", "prom", "c"):
            assert got[k] == want[k], k
        # the router block: the reference's keys and the port router's
        # own prefix-ship fallback counter
        assert got["router"] == sorted(want["router"]
                                       + ["prefix_ship_fallbacks"])
        assert got["done"] == 4 and all(got["prom"])


class TestFailure:
    def test_kill_worker_midstream_ledger_salvage(self, ref):
        got, want = _port("kill"), ref["kill"]
        same_ids(ref["single"]["ids"], got["ids"], "kill vs engine")
        assert got["c"]["failovers"] >= 1 and got["c"]["failed"] == 0
        assert got["live"] >= 1 and got["led"]["max_new_tokens"] >= 1
        assert got["no_leak"]
        for k in ("c", "live", "led", "requeues"):
            assert got[k] == want[k], k

    def test_probe_rebuild_respawns_worker(self):
        s = side("port")
        h0, r0 = worker(s, "rb0")
        holder = [h0]

        def respawn():
            holder.append(tfleet.EngineHost(s.factory()(), "rb0",
                                            s.store).start())
        r0.respawn = respawn
        try:
            old = r0._resolve()["incarnation"]
            h0.kill_connections()
            h0.stop()
            with pytest.raises(tfleet.FleetRPCError):
                r0.headroom()
            r0.rebuild()
            assert r0._resolve()["incarnation"] != old
            assert r0.extra_health()["worker"]["respawns"] == 1
            prompts, _ = stream(n=1, seed=9)
            uid = r0.submit({"prompt": prompts[0], "max_new_tokens": 3,
                             "eos_token_id": None, "tenant": "default",
                             "priority": None, "ttl_steps": None,
                             "deadline": None})
            while r0.has_work():
                r0.step()
            assert r0.result(uid).size == prompts[0].size + 3
            r0.note_recovery()
            assert r0.governor.attempts == 0
        finally:
            for h in holder:
                h.stop()

    def test_telemetry_mirror_folds_a_respawn(self, ref):
        got, want = _port("mirror"), ref["mirror"]
        assert got["respawns"] == 1
        assert got["before"] == 2 and got["ttft"] == 4 and got["done"] == 4
        assert got["win_ttft"] == 2     # the live incarnation's window
        for k in ("before", "ttft", "win_ttft", "done"):
            assert got[k] == want[k], k
        same_ids(want["ids"], got["ids"])


class TestTransports:
    def test_store_transport_across_workers(self, ref):
        got, want = _port("store"), ref["store"]
        same_ids(ref["single"]["ids"], got["ids"])
        assert got["c"]["kv_handoffs"] >= 1
        assert got["transports"] == {"store": got["c"]["kv_handoffs"]}
        assert all(got["no_leak"])
        assert got["c"] == want["c"]
        assert got["transports"] == {k: v for k, v in
                                     want["transports"].items() if v}

    def test_device_fault_falls_back_to_host(self, ref):
        got, want = _port("device_fault"), ref["device_fault"]
        same_ids(ref["single"]["ids"], got["ids"])
        assert got["c"]["kv_handoffs"] >= 1
        assert got["transports"].get("host") == got["c"]["kv_handoffs"]
        assert got["transports"].get("device", 0) == 0
        assert got["c"]["handoff_failures"] >= 1
        assert got["c"] == want["c"]
        assert {k: v for k, v in got["transports"].items() if v} == \
            {k: v for k, v in want["transports"].items() if v}

    def test_adapter_rpc_fan_out(self, ref, adapter_path):
        got = sc_adapters(side("port"), adapter_path)
        want = ref["adapters"]
        assert got["summary"] == want["summary"] == {"ad0": "loaded",
                                                     "ad1": "loaded"}
        assert got["registry"] == [{"a1": adapter_path}] * 2
        same_ids(want["ids"], got["ids"], "adapter fleet vs JAX")
        assert not np.array_equal(got["ids"][0], ref["single"]["ids"][0])
        same_ids([ref["single"]["ids"][1]], [got["ids"][1]], "base row")


# -- one real 2-process fleet for the module -----------------------------------
@pytest.fixture(scope="module")
def proc_fleet():
    handle = tfleet.spawn_fleet(SPEC, 2)
    yield handle
    handle.shutdown()


@pytest.fixture(scope="module")
def local_ids():
    """The port's in-process router on the same spec."""
    prompts, budgets = stream()
    router = trouter.EngineRouter(
        lambda: tfleet.build_engine_from_spec(SPEC), replicas=2)
    uids = [router.add_request(p, max_new_tokens=b)
            for p, b in zip(prompts, budgets)]
    router.drain()
    return results(router, uids)


class TestProcessFleet:
    def test_two_process_fleet_kill9(self, proc_fleet, local_ids):
        handle = proc_fleet
        prompts, budgets = stream()
        router = trouter.EngineRouter(backends=handle.replicas,
                                      prefix_index=handle.prefix_index,
                                      probe_backoff=10_000)
        uids = [router.add_request(p, max_new_tokens=b)
                for p, b in zip(prompts, budgets)]
        for _ in range(4):
            router.step()
        victim = handle.procs[0]
        os.kill(victim.pid, signal.SIGKILL)
        victim.join()
        router.drain()
        same_ids(local_ids, results(router, uids), "2-process fleet")
        h = router.health()
        assert h["failed"] == 0 and router.failovers >= 1
        assert router.duplicates_dropped == 0
        assert no_leak(handle.replicas[1])
        assert handle.replicas[1]._resolve()["backend"] == "cpu"

    def test_respawned_worker_serves(self, proc_fleet, local_ids):
        """rebuild() of the killed worker spawns a new process (a new
        incarnation); it serves with the same ids and answers the
        launch-count RPC (all zero on the CPU: the plain versions)."""
        rep = proc_fleet.replicas[0]
        old = rep._resolve()["incarnation"]
        if rep.shutdown():              # alive: the kill test did not run
            proc_fleet.procs[0].join(timeout=10)
        rep.rebuild()
        assert rep._resolve()["incarnation"] != old
        assert rep._resolve()["pid"] == proc_fleet.procs[-1].pid
        prompts, budgets = stream()
        uid = rep.submit({"prompt": prompts[2], "max_new_tokens": budgets[2],
                          "eos_token_id": None, "tenant": "default",
                          "priority": None, "ttl_steps": None,
                          "deadline": None})
        while rep.has_work():
            rep.step()
        np.testing.assert_array_equal(rep.result(uid), local_ids[2])
        counts = rep.kernel_launches()
        assert counts and set(counts.values()) == {0}


def test_worker_that_dies_before_registering_fails_fast():
    """A worker whose engine build raises (here: its factory cannot be
    imported) exits before it registers: spawn_fleet raises FleetRPCError
    at once and reaps it, instead of waiting out connect_timeout_ms."""
    t = time.monotonic()
    with pytest.raises(tfleet.FleetRPCError, match="exited with code"):
        tfleet.spawn_fleet("ptt_no_such_module:factory", 1,
                           connect_timeout_ms=120000)
    assert time.monotonic() - t < 60


# -- the CLI ------------------------------------------------------------------
def _tails(out):
    return [line.split("tail")[1] for line in out.splitlines()
            if "request" in line and "tail" in line]


def test_serve_llama_fleet_autoscale(capsys):
    """--fleet 1 --autoscale: the controller buys a second worker process
    mid-stream; the tails equal the in-process --replicas 2 run's."""
    argv = ["--device", "cpu", "--max_new_tokens", "24"]
    serve_llama.main(argv + ["--fleet", "1", "--autoscale",
                             "--slo-queue-wait-ms", "0.001",
                             "--max-replicas", "2"])
    out = capsys.readouterr().out
    assert "fleet 1 processes: 4 done / 0 failed" in out
    assert "+1/-0 replicas (2 final)" in out
    serve_llama.main(argv + ["--replicas", "2"])
    assert _tails(out) == _tails(capsys.readouterr().out)


def test_standalone_workers_serve_a_router():
    """Two workers started as their own commands (`serve_llama
    --fleet-worker` and `python -m paddle_tpu_torch.inference.fleet
    --worker`) on one master store: a router over them serves the tiny
    model's ids (both build `LlamaConfig.tiny()` at seed 0)."""
    store = TCPStore("127.0.0.1", 0, is_master=True)
    env = dict(os.environ, PYTHONPATH=ROOT)
    addr = f"127.0.0.1:{store.port}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.serve_llama",
         "--fleet-worker", "--fleet-store", addr, "--fleet-name", "sa0",
         "--device", "cpu"], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
        subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.inference.fleet",
         "--worker", "--name", "sa1", "--store", addr, "--device", "cpu"],
        cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)]
    try:
        reps = [tfleet.ProcessReplica(n, store, call_timeout=60,
                                      connect_timeout_ms=60000)
                for n in ("sa0", "sa1")]
        for r in reps:
            r._resolve()
        router = trouter.EngineRouter(backends=reps)
        rng = np.random.RandomState(0)
        prompts = [rng.randint(0, 128, (t,)).astype(np.int64)
                   for t in (9, 5, 12)]
        uids = [router.add_request(p, 6) for p in prompts]
        placed = {router._reqs[u].replica for u in uids}
        router.drain()
        eng = tsched.ContinuousBatchingEngine(
            LlamaForCausalLM(LlamaConfig.tiny(), device="cpu", seed=0),
            max_len=64, page_size=16, max_batch=2, device="cpu")
        same_ids(eng.generate_many(prompts, max_new_tokens=6),
                 results(router, uids), "standalone workers")
        assert placed == {"sa0", "sa1"}
        for r in reps:
            r.shutdown()
        for p in procs:
            assert p.wait(timeout=30) == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
