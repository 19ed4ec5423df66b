"""The SLO autoscaler of paddle_tpu_torch against the JAX package's.

Replays tests/test_autoscale.py: every controller unit (TestSLOTarget,
TestControllerUnits, TestRespawnGovernor) runs the same script through the
JAX FleetController and the port's, each over its own stub router (the
exact surface the controller reads and acts on, no engine), and the
decision logs must be equal entry for entry (the wall-clock
`decision_ms` aside). TestElasticRouter runs the router's elastic seams
with real engines on the reference's micro LLaMA (1 layer, hidden 32, ffn
64, 2 heads; f32; page 8, 2 slots; weights carried over with
`convert.load_numpy_params`; the port's engines on the CPU): greedy ids
equal the JAX router's exactly.

The port's `EngineRouter.shift_queued` reads the backlogs once before it
moves anything (the reference re-reads them and moves a request it just
placed on the new replica straight back): the scale-out case pins that the
backlog lands on the new replica, and its ids against the JAX router's.
"""
import types

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import failsafe as jfs
from paddle_tpu.inference import autoscale as jauto
from paddle_tpu.inference import fleet as jfleet
from paddle_tpu.inference import router as jrouter
from paddle_tpu.inference import scheduler as jsched
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch import failsafe as tfs
from paddle_tpu_torch.convert import load_numpy_params
from paddle_tpu_torch.inference import adapters as tad
from paddle_tpu_torch.inference import autoscale as tauto
from paddle_tpu_torch.inference import fleet as tfleet
from paddle_tpu_torch.inference import router as trouter
from paddle_tpu_torch.inference import scheduler as tsched
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

torch.set_num_threads(1)

MICRO = dict(num_hidden_layers=1, hidden_size=32, intermediate_size=64,
             num_attention_heads=2)
ENGINE_KW = dict(max_len=64, page_size=8, max_batch=2, prefill_chunk=8)
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


PACKAGES = {
    "jax": types.SimpleNamespace(auto=jauto, fleet=jfleet, fs=jfs,
                                 router=jrouter, sched=jsched),
    "port": types.SimpleNamespace(auto=tauto, fleet=tfleet, fs=tfs,
                                  router=trouter, sched=tsched),
}


def stream(n=6, seed=0):
    cfg = LlamaConfig.tiny(**MICRO)
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab_size, (int(t),)).astype(np.int64)
               for t in rng.randint(4, 14, n)]
    budgets = [int(b) for b in rng.randint(3, 8, n)]
    return prompts, budgets


# -- stub router: controller units without a single engine build --------------
class FakeRep:
    def __init__(self, name, role="any"):
        self.name = name
        self.state = "active"
        self.role = role
        self.breaker = types.SimpleNamespace(state="closed")


class StubRouter:
    """The exact surface FleetController reads/acts on, scripted (the
    reference test's stub)."""

    def __init__(self, roles=("any",), topology=None):
        self._replicas = [FakeRep(f"r{i}", role)
                          for i, role in enumerate(roles)]
        self._by_name = {r.name: r for r in self._replicas}
        self._assigned = {r.name: [] for r in self._replicas}
        self._topology = dict(topology) if topology else None
        self.steps = 0
        self.shedding = False
        self.windows = {}
        self.held = 0
        self.loads = {}
        self.retired = []
        self.role_flips = []
        self.shifts = 0

    def metrics(self):
        return {"router": {}, "fleet": {"windows": self.windows}}

    def health(self):
        reps = {}
        for r in self._replicas:
            q, run = self.loads.get(r.name, (0, 0))
            reps[r.name] = {"role": r.role, "breaker": r.breaker.state,
                            "queued": q, "running": run}
        return {"held": self.held, "pending": 0, "replicas": reps}

    def add_replica(self, backend=None, name=None, role="any"):
        rep = backend or FakeRep(name or f"r{len(self._replicas)}", role)
        rep.role = role
        self._replicas.append(rep)
        self._by_name[rep.name] = rep
        self._assigned[rep.name] = []
        if self._topology is not None and role in self._topology:
            self._topology[role] += 1
        return rep

    def retire_replica(self, name):
        rep = self._by_name.pop(name)
        self._replicas.remove(rep)
        self._assigned.pop(name)
        if self._topology is not None and rep.role in self._topology:
            self._topology[rep.role] -= 1
        self.retired.append(name)
        return rep

    def set_replica_role(self, name, role):
        rep = self._by_name[name]
        old = rep.role
        rep.role = role
        self._topology[old] -= 1
        self._topology[role] = self._topology.get(role, 0) + 1
        self.role_flips.append((name, old, role))
        return rep

    def shift_queued(self, max_moves=8):
        self.shifts += 1
        return 0

    def adapter_affinity(self):
        return {}


BAD = {"ttft_ms": {"count": 10, "p99_ms": 500.0}}
GOOD = {"ttft_ms": {"count": 10, "p99_ms": 10.0}}
SLO = dict(ttft_p99_ms=100.0)


def _ctl(pkg, r, **kw):
    base = dict(breach_ticks=2, slack_ticks=2, cooldown_ticks=2,
                shed_after_ticks=2, min_window_count=1, max_replicas=4)
    base.update(kw)
    return pkg.auto.FleetController(r, pkg.auto.SLOTarget(**SLO), **base)


def _log(ctl):
    return [{k: v for k, v in d.items() if k != "decision_ms"}
            for d in ctl.decisions]


# each unit script takes one package's namespace and returns what it
# observed: the decision log plus the stub's state
def sc_hysteresis(pkg):
    r = StubRouter()
    ctl = _ctl(pkg, r)
    r.windows = BAD
    acts = [ctl.tick()["action"], ctl.tick()["action"]]
    return dict(acts=acts, n=len(r._replicas), shifts=r.shifts, log=_log(ctl))


def sc_cooldown(pkg):
    r = StubRouter()
    ctl = _ctl(pkg, r, breach_ticks=1)
    r.windows = BAD
    acts = [ctl.tick()["action"] for _ in range(4)]
    return dict(acts=acts, n=len(r._replicas), log=_log(ctl))


def sc_small_windows(pkg):
    r = StubRouter()
    ctl = _ctl(pkg, r, breach_ticks=1, min_window_count=50)
    r.windows = BAD
    return dict(act=ctl.tick()["action"], n=len(r._replicas), log=_log(ctl))


def sc_held(pkg):
    r = StubRouter()
    ctl = pkg.auto.FleetController(r, pkg.auto.SLOTarget(
        queue_wait_p99_ms=100.0), breach_ticks=1, min_window_count=1)
    r.held = 3
    return dict(act=ctl.tick()["action"], log=_log(ctl))


def sc_slack(pkg):
    r = StubRouter(roles=("any", "any", "any"))
    ctl = _ctl(pkg, r, slack_ticks=2, cooldown_ticks=0, min_replicas=2)
    r.windows = GOOD
    acts = [ctl.tick()["action"] for _ in range(4)]
    return dict(acts=acts, retired=r.retired, n=len(r._replicas),
                log=_log(ctl))


def sc_price(pkg):
    r = StubRouter()
    ctl = _ctl(pkg, r, breach_ticks=1, price=lambda n: {"fits": False})
    r.windows = BAD
    acts = [ctl.tick()["action"], ctl.tick()["action"]]
    return dict(acts=acts, n=len(r._replicas), shedding=r.shedding,
                sheds=ctl.sheds, log=_log(ctl))


def sc_priced(pkg):
    """The cost model's price gate (`price_from_spec`) on a tiny spec under
    the CPU nominal calibration; a replica budget of 3 on top of its "fits"
    (one replica's footprint does not grow with the fleet) turns the third
    scale-out into a refusal."""
    from paddle_tpu.cost_model import Calibration as JaxCalibration
    from paddle_tpu_torch.cost_model import Calibration
    cal = (JaxCalibration if pkg is PACKAGES["jax"] else Calibration)(
        backend="cpu")
    spec = {"model": {"preset": "tiny", "seed": 0},
            "engine": {"max_len": 64, "page_size": 16, "max_batch": 2}}
    price = pkg.auto.price_from_spec(spec, prompt_len=16, gen_tokens=8,
                                     calib=cal)

    def capped(n):
        out = dict(price(n))
        out["fits"] = out["fits"] and n <= 3
        return out
    r = StubRouter()
    ctl = _ctl(pkg, r, breach_ticks=1, cooldown_ticks=0, price=capped)
    r.windows = BAD
    acts = [ctl.tick()["action"] for _ in range(3)]
    return dict(acts=acts, n=len(r._replicas), log=_log(ctl))


def sc_shed_clears(pkg):
    r = StubRouter()
    ctl = _ctl(pkg, r, breach_ticks=1, max_replicas=1)
    r.windows = BAD
    ctl.tick(), ctl.tick()
    shed = r.shedding
    r.windows = GOOD
    d = ctl.tick()
    return dict(shed=shed, cleared=d.get("shed_cleared"),
                shedding=r.shedding, log=_log(ctl))


def sc_rebalance(pkg):
    r = StubRouter(roles=("prefill", "decode", "decode"),
                   topology={"prefill": 1, "decode": 2})
    ctl = _ctl(pkg, r, slack_ticks=99, min_replicas=3)
    r.windows = GOOD
    r.loads = {"r0": (6, 2), "r1": (0, 1), "r2": (0, 0)}
    first = ctl.tick()["action"]
    flips, topo = list(r.role_flips), dict(r._topology)
    r.loads = {"r0": (6, 2), "r2": (6, 2), "r1": (0, 0)}
    for _ in range(ctl.cooldown_ticks + 1):
        ctl.tick()
    return dict(first=first, flips=flips, topo=topo,
                decode_after=r._topology["decode"], log=_log(ctl))


def sc_faults(pkg):
    r = StubRouter(roles=("any", "any"))
    ctl = _ctl(pkg, r, breach_ticks=1, slack_ticks=1, cooldown_ticks=0)
    r.windows = BAD
    with pkg.fs.inject("scale.spawn"):
        d1 = ctl.tick()
    r.windows = GOOD
    with pkg.fs.inject("scale.retire"):
        d2 = ctl.tick()
    rt = StubRouter(roles=("prefill", "decode", "decode"),
                    topology={"prefill": 1, "decode": 2})
    ctl2 = _ctl(pkg, rt, slack_ticks=99, min_replicas=3)
    rt.windows = GOOD
    rt.loads = {"r0": (6, 2)}
    with pkg.fs.inject("scale.rebalance"):
        d3 = ctl2.tick()
    return dict(acts=[d1["action"], d2["action"], d3["action"]],
                errors=[d1["error"], d2["error"], d3["error"]],
                n=len(r._replicas), spawn_failures=ctl.spawn_failures,
                retired=r.retired, flips=rt.role_flips,
                log=_log(ctl) + _log(ctl2))


def sc_bounded_log(pkg):
    r = StubRouter()
    ctl = _ctl(pkg, r, decision_log=4)
    for _ in range(9):
        ctl.tick()
    st = ctl.stats()
    st["last_decision"] = {k: v for k, v in st["last_decision"].items()
                           if k != "decision_ms"}
    return dict(n_log=len(ctl.decisions), stats=st, log=_log(ctl),
                ms_ok=all(d["decision_ms"] >= 0.0 for d in ctl.decisions))


def sc_maybe_tick(pkg):
    r = StubRouter()
    ctl = _ctl(pkg, r)
    out = [ctl.maybe_tick(every_steps=8) is None]
    for steps in (8, 15, 16):
        r.steps = steps
        out.append(ctl.maybe_tick(every_steps=8) is None)
    return dict(none=out, log=_log(ctl))


def both(script):
    """(JAX's observation, the port's) of one unit script."""
    return script(PACKAGES["jax"]), script(PACKAGES["port"])


class TestSLOTarget:
    @pytest.mark.parametrize("name", ["jax", "port"])
    def test_needs_a_target(self, name):
        with pytest.raises(ValueError):
            PACKAGES[name].auto.SLOTarget()

    def test_watched_maps_histogram_names(self):
        got, want = (PACKAGES[n].auto.SLOTarget(
            ttft_p99_ms=1.0, queue_wait_p99_ms=2.0) for n in ("port", "jax"))
        assert dict(got.watched()) == {"ttft_ms": 1.0, "queue_wait_ms": 2.0}
        assert got.watched() == want.watched() and repr(got) == repr(want)


class TestControllerUnits:
    def test_hysteresis_one_bad_scrape_buys_nothing(self):
        want, got = both(sc_hysteresis)
        assert got["acts"] == ["none", "scale_out"]
        assert got["n"] == 2 and got["shifts"] == 1
        assert got == want

    def test_cooldown_blocks_back_to_back_actions(self):
        want, got = both(sc_cooldown)
        assert got["acts"] == ["scale_out", "cooldown", "cooldown",
                               "scale_out"] and got["n"] == 3
        assert got == want

    def test_small_windows_do_not_vote(self):
        want, got = both(sc_small_windows)
        assert got["act"] == "none" and got["n"] == 1
        assert got == want

    def test_held_queue_is_a_breach_even_without_latency_data(self):
        want, got = both(sc_held)
        assert got["act"] == "scale_out"
        assert got == want

    def test_slack_scales_in_down_to_the_floor(self):
        want, got = both(sc_slack)
        assert got["acts"][:2] == ["none", "scale_in"]
        assert got["retired"] and got["n"] == 2
        assert got == want

    def test_price_gate_refuses_unfit_spawn_then_sheds(self):
        want, got = both(sc_price)
        assert got["acts"] == ["capped", "shed"] and got["n"] == 1
        assert got["shedding"] and got["sheds"] == 1
        assert got == want

    def test_shed_clears_with_the_breach(self):
        want, got = both(sc_shed_clears)
        assert got["shed"] and got["cleared"] and not got["shedding"]
        assert got == want

    def test_rebalance_flips_the_idlest_decode_to_prefill(self):
        want, got = both(sc_rebalance)
        assert got["first"] == "rebalance"
        assert got["flips"] == [("r2", "decode", "prefill")]
        assert got["topo"] == {"prefill": 2, "decode": 1}
        assert got["decode_after"] == 1
        assert got == want

    def test_fault_points_abort_cleanly(self):
        want, got = both(sc_faults)
        assert got["acts"] == ["spawn_failed", "retire_failed",
                               "rebalance_failed"]
        assert all("InjectedFault" in e for e in got["errors"])
        assert got["n"] == 2 and got["spawn_failures"] == 1
        assert not got["retired"] and not got["flips"]
        assert got == want

    def test_decisions_logged_with_latency(self):
        want, got = both(sc_bounded_log)
        assert got["n_log"] == 4 and got["ms_ok"]
        assert got["stats"]["ticks"] == 9
        assert got == want

    def test_maybe_tick_keys_on_router_steps(self):
        want, got = both(sc_maybe_tick)
        assert got["none"] == [True, False, True, False]
        assert got == want

    def test_price_from_spec_waits_for_the_cost_model(self):
        """The price gate is ported (it refused until the cost model was):
        a controller priced by `price_from_spec` under the CPU nominal
        calibration takes the JAX controller's decisions, "priced" records
        (exact floats) included, scaling out while the priced spec fits and
        capping once the next replica would not."""
        want, got = both(sc_priced)
        assert got["acts"] == ["scale_out", "scale_out", "capped"]
        assert got["n"] == 3
        assert got["log"][0]["priced"]["fits"] is True
        assert got["log"][2]["priced"]["fits"] is False
        assert got == want


class TestRespawnGovernor:
    def _schedule(self, pkg, cap, base, jitter, seed, times):
        t = [0.0]
        g = pkg.fleet.RespawnGovernor(cap=cap, base_delay=base,
                                      jitter=jitter, seed=seed,
                                      time_fn=lambda: t[0])
        out = []
        for now in times:
            t[0] = now
            try:
                g.admit("w")
                out.append(("admit", g.attempts, g.not_before))
            except Exception as e:
                out.append((type(e).__name__, g.attempts, g.not_before))
        return out

    def test_backoff_schedule_and_refusal_window(self):
        times = [0.0, 0.0, 1.5, 1.5, 4.0]
        got = self._schedule(PACKAGES["port"], 5, 1.0, 0.0, None, times)
        assert [k for k, *_ in got] == ["admit", "FleetRPCError", "admit",
                                        "FleetRPCError", "admit"]
        assert got[-1][1] == 3
        assert got == self._schedule(PACKAGES["jax"], 5, 1.0, 0.0, None,
                                     times)

    def test_jittered_schedule_equals_the_reference(self):
        times = [0.0, 2.0, 9.0, 30.0, 80.0, 200.0, 400.0]
        got = self._schedule(PACKAGES["port"], 6, 0.5, 0.5, 7, times)
        assert got == self._schedule(PACKAGES["jax"], 6, 0.5, 0.5, 7, times)

    def test_cap_raises_typed_crash_loop(self):
        t = [0.0]
        g = tfleet.RespawnGovernor(cap=2, base_delay=0.0, jitter=0.0,
                                   time_fn=lambda: t[0])
        g.admit("w")
        g.admit("w")
        with pytest.raises(tfleet.ReplicaCrashLoopError):
            g.admit("w")

    def test_clean_probe_resets_the_breaker(self):
        t = [0.0]
        g = tfleet.RespawnGovernor(cap=2, base_delay=0.0, jitter=0.0,
                                   time_fn=lambda: t[0])
        g.admit("w")
        g.admit("w")
        g.recovered()
        g.admit("w")
        assert g.attempts == 1


# -- real engines: the elastic seams ------------------------------------------
def factory_for(name, **over):
    jm, tm = _models()
    if name == "jax":
        return lambda: jsched.ContinuousBatchingEngine(
            jm, **dict(ENGINE_KW, **over))
    return lambda: tsched.ContinuousBatchingEngine(
        tm, device="cpu", **dict(ENGINE_KW, **over))


def results(r, uids):
    return [np.asarray(r.result(u)) for u in uids]


def sc_controller_off(name):
    pkg = PACKAGES[name]
    prompts, budgets = stream()
    router = pkg.router.EngineRouter(factory_for(name), replicas=2)
    uids = [router.add_request(p, max_new_tokens=b)
            for p, b in zip(prompts, budgets)]
    router.drain()
    h = router.health()
    return dict(ids=results(router, uids),
                h={k: h[k] for k in ("crash_loops", "shed_rejections",
                                     "shedding", "adapter_affinity",
                                     "done", "failed")})


def sc_scale_out(name):
    pkg = PACKAGES[name]
    prompts, budgets = stream()
    router = pkg.router.EngineRouter(factory_for(name), replicas=1,
                                     telemetry=True)
    ctl = pkg.auto.FleetController(
        router, pkg.auto.SLOTarget(queue_wait_p99_ms=1e-3),
        breach_ticks=1, cooldown_ticks=0, max_replicas=2,
        min_window_count=1)
    uids = [router.add_request(p, max_new_tokens=b)
            for p, b in zip(prompts, budgets)]
    for _ in range(3):
        router.step()
    d = ctl.tick()
    new = router._replicas[-1].name
    on_new = len(router._assigned[new])
    router.drain()
    return dict(ids=results(router, uids), action=d["action"],
                shifted=d["shifted"], on_new=on_new,
                n=len(router._replicas), failed=router.health()["failed"],
                dups=router.duplicates_dropped)


def sc_retire(name):
    pkg = PACKAGES[name]
    prompts, budgets = stream()
    router = pkg.router.EngineRouter(factory_for(name), replicas=2,
                                     telemetry=True)
    uids = [router.add_request(p, max_new_tokens=b)
            for p, b in zip(prompts, budgets)]
    for _ in range(2):
        router.step()
    victim = max(router._replicas,
                 key=lambda r: len(router._assigned[r.name]))
    rep = router.retire_replica(victim.name)
    state = rep.state
    router.drain()
    fleet = router.metrics()["fleet"]
    return dict(ids=results(router, uids), state=state, victim=victim.name,
                n=len(router._replicas), failed=router.health()["failed"],
                dups=router.duplicates_dropped, requeued=router.requeued,
                ttft=fleet["histograms"]["ttft_ms"]["count"])


def sc_role_flip(name):
    pkg = PACKAGES[name]
    prompts, budgets = stream()
    router = pkg.router.EngineRouter(factory_for(name),
                                     topology={"prefill": 1, "decode": 2})
    uids = [router.add_request(p, max_new_tokens=b)
            for p, b in zip(prompts, budgets)]
    for _ in range(3):
        router.step()
    router.set_replica_role("d2", "prefill")
    topo = dict(router._topology)
    with pytest.raises(ValueError):
        router.set_replica_role("d1", "prefill")
    router.drain()
    return dict(ids=results(router, uids), topo=topo,
                failed=router.health()["failed"],
                dups=router.duplicates_dropped,
                handoffs=router.kv_handoffs)


def sc_idle_scale_in(name):
    pkg = PACKAGES[name]
    router = pkg.router.EngineRouter(factory_for(name), replicas=2,
                                     telemetry=True)
    reaped = []
    ctl = pkg.auto.FleetController(router, pkg.auto.SLOTarget(
        ttft_p99_ms=1e9), retirer=reaped.append, slack_ticks=2,
        cooldown_ticks=0, min_replicas=1)
    acts = [ctl.tick()["action"], ctl.tick()["action"]]
    for _ in range(4):
        ctl.tick()
    return dict(acts=acts, reaped=reaped, n=len(router._replicas),
                log=_log(ctl))


@pytest.fixture(scope="module")
def ref():
    """The elastic scenarios through the JAX router, once."""
    return {name: fn("jax") for name, fn in (
        ("off", sc_controller_off), ("scale_out", sc_scale_out),
        ("retire", sc_retire), ("flip", sc_role_flip),
        ("idle", sc_idle_scale_in))}


def same_ids(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(y, x, err_msg=f"request {i}")


class TestElasticRouter:
    def test_controller_off_byte_identity(self, ref):
        got = sc_controller_off("port")
        same_ids(ref["off"]["ids"], got["ids"])
        assert got["h"] == ref["off"]["h"]
        assert got["h"]["crash_loops"] == 0 and not got["h"]["shedding"]

    def test_scale_out_relieves_backlog(self, ref):
        """Breach -> scale out -> shift_queued: the backlog moves onto the
        fresh replica and stays there; ids equal the JAX router's."""
        got = sc_scale_out("port")
        same_ids(ref["scale_out"]["ids"], got["ids"])
        assert got["action"] == ref["scale_out"]["action"] == "scale_out"
        assert got["n"] == 2 and got["failed"] == 0 and got["dups"] == 0
        assert got["shifted"] >= 1 and got["on_new"] == got["shifted"]

    def test_drain_then_retire_loses_nothing(self, ref):
        got = sc_retire("port")
        want = ref["retire"]
        same_ids(want["ids"], got["ids"])
        assert got["state"] == "draining" and got["n"] == 1
        assert got["failed"] == 0 and got["dups"] == 0
        assert got["ttft"] >= len(got["ids"])
        assert {k: got[k] for k in ("victim", "requeued", "ttft")} == \
            {k: want[k] for k in ("victim", "requeued", "ttft")}

    def test_retire_refuses_to_empty_the_fleet(self):
        router = trouter.EngineRouter(factory_for("port"), replicas=1)
        with pytest.raises(ValueError):
            router.retire_replica(router._replicas[0].name)
        with pytest.raises(ValueError):
            router.retire_replica("nope")

    def test_controller_scales_in_idle_fleet(self, ref):
        got = sc_idle_scale_in("port")
        assert got["acts"] == ["none", "scale_in"] and got["n"] == 1
        assert got["reaped"] == [got["log"][1]["replica"]]
        assert got == ref["idle"]

    def test_live_role_flip_byte_identity(self, ref):
        got = sc_role_flip("port")
        same_ids(ref["flip"]["ids"], got["ids"])
        assert got["topo"] == {"prefill": 2, "decode": 1}
        assert got["failed"] == 0 and got["dups"] == 0
        assert got["handoffs"] == ref["flip"]["handoffs"]

    def test_adapter_affinity_prefers_then_falls_back(self, tmp_path):
        _, tm = _models()
        ad = tad.make_lora_adapter(tm.config, rank=4, seed=1)
        path = str(tmp_path / "hot")
        tad.save_adapter(path, ad)
        router = trouter.EngineRouter(
            factory_for("port", adapters={"rank": 4}), replicas=2)
        router.load_adapter("hot", path)
        router.set_adapter_affinity("hot", ["r1"])
        assert router.health()["adapter_affinity"] == {"hot": ["r1"]}
        prompts, budgets = stream(n=3, seed=5)
        uids = [router.add_request(p, max_new_tokens=b, adapter="hot")
                for p, b in zip(prompts, budgets)]
        assert all(u in router._assigned["r1"] for u in uids)
        assert not router._assigned["r0"]
        router.drain()
        assert all(router.result(u).size > 0 for u in uids)
        router._by_name["r1"].breaker.state = "open"
        u = router.add_request(prompts[0], max_new_tokens=2, adapter="hot")
        assert u in router._assigned["r0"]
        router._by_name["r1"].breaker.state = "closed"
        router.drain()
        assert router.result(u).size > 0
        router.retire_replica("r1")
        assert router.health()["adapter_affinity"] == {"hot": []}
        with pytest.raises(ValueError):
            router.set_adapter_affinity("hot", ["ghost"])

    def test_pinned_adapter_survives_pool_pressure(self):
        _, tm = _models()
        e = factory_for("port", adapters={"rank": 4, "max_adapters": 2})()
        e.load_adapter("hot", tad.make_lora_adapter(tm.config, rank=4,
                                                    seed=1))
        e.pin_adapter("hot")
        e.load_adapter("b", tad.make_lora_adapter(tm.config, rank=4, seed=2))
        e.load_adapter("c", tad.make_lora_adapter(tm.config, rank=4, seed=3))
        st = e.health()["adapters"]
        assert st["pinned"] == ["hot"]
        assert "hot" in e._apool._slots and "b" not in e._apool._slots
        e.pin_adapter("hot", pinned=False)
        assert e.health()["adapters"]["pinned"] == []

    def test_shed_gate_refuses_typed(self):
        router = trouter.EngineRouter(factory_for("port"), replicas=1)
        router.shedding = True
        with pytest.raises(trouter.NoReplicaAvailableError):
            router.add_request(np.array([1, 2, 3]), max_new_tokens=2)
        assert router.shed_rejections == 1
        assert router.health()["shed_rejections"] == 1
        router.shedding = False
        u = router.add_request(np.array([1, 2, 3]), max_new_tokens=2)
        router.drain()
        assert router.result(u).size > 0
