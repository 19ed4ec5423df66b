"""Tenants and preemption of paddle_tpu_torch's ContinuousBatchingEngine
against the JAX engine.

Replays tests/test_speculative.py::TestTenants (priority preemption with
the victim's output intact, equal priorities never preempt, fair-share
admission order, the tenants block of health()) and adds the admission
policy's second preemption point (page pressure with a free slot), the
fused and speculative paths, and the policy's validation.

Engines run the reference suite's GQA model (`LlamaConfig.tiny(
num_key_value_heads=2, num_hidden_layers=2)`, seed-7 weights carried
across by name; f32 on the CPU) on its geometry (max_len 64, page 8,
slot_buckets (4,)). Exact everywhere: every output (the preempted
victim's included) equals the JAX engine's and the uninterrupted run's,
the admission order is the reference's, and the counters and health()
tenants block equal the JAX engine's.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import scheduler as jsched
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch import failsafe
from paddle_tpu_torch.convert import load_numpy_params
from paddle_tpu_torch.inference import scheduler as tsched
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

torch.set_num_threads(1)

GEOM = dict(max_len=64, page_size=8, max_batch=4, prefill_chunk=8,
            slot_buckets=(4,))
_PAIR = {}


@pytest.fixture(autouse=True)
def _clean_faults():
    failsafe.reset()
    yield
    failsafe.reset()


def _pair():
    if not _PAIR:
        paddle.seed(7)
        kw = dict(num_key_value_heads=2, num_hidden_layers=2)
        jm = JaxLlama(JaxConfig.tiny(**kw))
        tm = LlamaForCausalLM(LlamaConfig.tiny(**kw), device="cpu")
        load_numpy_params(tm, {n: np.asarray(p.data)
                               for n, p in jm.named_parameters()})
        _PAIR["m"] = (jm, tm)
    return _PAIR["m"]


def mk(side, **kw):
    jm, tm = _pair()
    if side == "jax":
        return jsched.ContinuousBatchingEngine(jm, **dict(GEOM, **kw))
    return tsched.ContinuousBatchingEngine(tm, device="cpu",
                                           **dict(GEOM, **kw))


def assert_no_leak(eng):
    held = 0 if eng._prefix is None else len(eng._prefix)
    assert eng.allocator.available == eng.allocator.n_pages - held


def _prompt(rng, n):
    return rng.randint(0, 128, (n,)).astype(np.int64)


def _preempt_run(side, **kw):
    """One slot: a bulk request decodes for 4 steps, then a gold request
    (priority 5) arrives and preempts it. Returns (engine, victim output,
    gold output, the uninterrupted victim output)."""
    rng = np.random.RandomState(9)
    p1, p2 = _prompt(rng, 8), _prompt(rng, 9)
    ref = mk(side, max_batch=1, **kw).generate_many([p1],
                                                    max_new_tokens=24)[0]
    eng = mk(side, max_batch=1, tenants={"gold": {"priority": 5},
                                         "bulk": {"share": 1.0}}, **kw)
    a = eng.add_request(p1, max_new_tokens=24, tenant="bulk")
    for _ in range(4):
        eng.step()
    b = eng.add_request(p2, max_new_tokens=4, tenant="gold")
    eng.drain()
    assert eng.status(a) == "done" and eng.status(b) == "done"
    return eng, eng.result(a), eng.result(b), ref


PATHS = {"per_step": dict(), "fused": dict(decode_block=4),
         "speculative": dict(speculate=4, decode_block=2)}


@pytest.fixture(scope="module")
def jax_ref():
    """Every JAX run the module compares with, in the fixture's setup."""
    out = {}
    for name, kw in PATHS.items():
        eng, va, gb, ref = _preempt_run("jax", **kw)
        out[name] = (va, gb, ref, eng.preemptions, eng.health()["tenants"])
    out["fair"] = _fair_order("jax")
    jeng, jva, jgb = _pressure_run("jax")
    out["pressure"] = (jeng.preemptions, jva, jgb)
    out["health"] = _health_run("jax")
    return out


@pytest.mark.parametrize("path", list(PATHS))
def test_priority_preempts_and_victim_output_intact(path, jax_ref):
    """Exact: the gold request preempts the bulk one once; the victim's
    folded-and-resumed output equals its uninterrupted run and the JAX
    engine's, and so does the gold output."""
    va_j, gb_j, ref_j, n_j, ten_j = jax_ref[path]
    eng, va, gb, ref = _preempt_run("port", **PATHS[path])
    assert eng.preemptions == n_j == 1
    np.testing.assert_array_equal(va, ref)
    np.testing.assert_array_equal(ref, ref_j)
    np.testing.assert_array_equal(va, va_j)
    np.testing.assert_array_equal(gb, gb_j)
    assert eng.health()["tenants"] == ten_j
    assert_no_leak(eng)


def test_equal_priority_never_preempts():
    rng = np.random.RandomState(10)
    eng = mk("port", max_batch=1)
    a = eng.add_request(_prompt(rng, 6), max_new_tokens=6)
    eng.step()
    eng.add_request(_prompt(rng, 6), max_new_tokens=4)
    eng.drain()
    assert eng.preemptions == 0
    assert eng.status(a) == "done"


def _fair_order(side):
    rng = np.random.RandomState(11)
    eng = mk(side, max_batch=1, tenants={"a": {"share": 1.0},
                                         "b": {"share": 2.0}})
    uids = {}
    for name, tenant in (("a1", "a"), ("a2", "a"), ("b1", "b"), ("b2", "b")):
        uids[name] = eng.add_request(_prompt(rng, 5), max_new_tokens=6,
                                     tenant=tenant)
    order, seen = [], set()
    while eng.step():
        for name, u in uids.items():
            if name not in seen and eng.status(u) != "queued":
                order.append(name)
                seen.add(name)
    return order, [eng.result(u) for u in uids.values()]


def test_fair_share_orders_admission(jax_ref):
    """Exact: one slot, equal priorities: stride scheduling by virtual
    time admits a1, b1, b2, a2 (the reference's order), with the JAX
    engine's outputs."""
    order, outs = _fair_order("port")
    assert order == ["a1", "b1", "b2", "a2"], order
    assert order == jax_ref["fair"][0]
    for a, b in zip(jax_ref["fair"][1], outs):
        np.testing.assert_array_equal(b, a)


def _health_run(side):
    rng = np.random.RandomState(12)
    eng = mk(side, tenants={"gold": {"share": 2.0, "priority": 1}})
    eng.generate_many([_prompt(rng, 5)], max_new_tokens=4)
    return eng.health()


def test_health_reports_tenants(jax_ref):
    """Exact: the tenants block of health() (tokens, virtual time, share,
    queued, running) equals the JAX engine's after the same stream."""
    h = _health_run("port")
    assert "default" in h["tenants"]
    assert h["tenants"]["default"]["tokens"] == 4
    assert h["tenants"]["gold"]["share"] == 2.0
    assert h["preemptions"] == 0
    assert h["tenants"] == jax_ref["health"]["tenants"]


def _pressure_run(side):
    """Two slots, pages short: 5 of the 16 pages are pinned outside the
    engine, a bulk request holds 8, so a gold request (priority 3) that
    needs 4 pages finds a free slot but only 3 free pages, and preempts
    under page pressure (the second preemption point of _admit)."""
    rng = np.random.RandomState(13)
    eng = mk(side, max_batch=2, slot_buckets=(2,), prefix_cache=False,
             tenants={"gold": {"priority": 3}})
    pinned = [eng.allocator.alloc() for _ in range(5)]
    a = eng.add_request(_prompt(rng, 30), max_new_tokens=30)
    for _ in range(6):
        eng.step()
    assert eng.allocator.available == 3
    b = eng.add_request(_prompt(rng, 20), max_new_tokens=8, tenant="gold")
    eng.drain()
    eng.allocator.free(pinned)
    return eng, eng.result(a), eng.result(b)


def test_page_pressure_preempts(jax_ref):
    """Exact: a free slot but too few pages preempts the lower-priority
    request; both outputs equal the JAX engine's and the victim's its
    uninterrupted run."""
    eng, va, gb = _pressure_run("port")
    assert eng.preemptions == 1
    n, jva, jgb = jax_ref["pressure"]
    assert n == 1
    np.testing.assert_array_equal(va, jva)
    np.testing.assert_array_equal(gb, jgb)
    solo = mk("port", max_batch=2, slot_buckets=(2,), prefix_cache=False)
    np.testing.assert_array_equal(
        va, solo.generate_many([va[:30]], max_new_tokens=30)[0])
    assert_no_leak(eng)


def test_infeasible_victim_is_not_preempted():
    """The feasibility rule: a candidate whose page need cannot fit even
    after evicting every lower-priority request's exclusive pages waits
    instead of destroying their work."""
    rng = np.random.RandomState(14)
    eng = mk("port", max_batch=1, prefix_cache=False,
             tenants={"gold": {"priority": 9}})
    pinned = [eng.allocator.alloc() for _ in range(2)]
    a = eng.add_request(_prompt(rng, 10), max_new_tokens=4)
    eng.step()
    gold = tsched.Request(99, _prompt(rng, 40), 24, None, priority=9)
    assert eng._preemption_victim(gold) is None
    eng.allocator.free(pinned)
    eng.drain()
    assert eng.status(a) == "done" and eng.preemptions == 0


def test_tenant_validation():
    with pytest.raises(ValueError, match="share must be > 0"):
        mk("port", tenants={"x": {"share": 0}})
    eng = mk("port", tenants={"gold": {"priority": 4}})
    u = eng.add_request(np.arange(5), 2, tenant="gold")
    v = eng.add_request(np.arange(5), 2, tenant="gold", priority=1)
    w = eng.add_request(np.arange(5), 2)
    assert [eng._requests[x].priority for x in (u, v, w)] == [4, 1, 0]
    assert eng._requests[w].tenant == "default"
    assert eng.queue_head_uid() == u
    eng.drain()
    assert eng.health()["tenants"]["gold"]["tokens"] == 4
