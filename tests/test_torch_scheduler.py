"""Continuous batching: paddle_tpu_torch's ContinuousBatchingEngine against
the JAX ContinuousBatchingEngine.

Greedy token ids must be EXACTLY equal to the reference engine's on the
same weights (tiny config, 2 layers, f32, CPU: the port runs its plain
PyTorch versions, the reference its Pallas kernels in interpret mode) at
decode_block 1 (per-step) and 4 (fused blocks): a ragged stream through
two slots, EOS mid-block, int8, GQA, the ragged kernel forced on both
sides, a shared-prefix stream with copy-on-write, and a geometry whose
padded prefill chunk reaches past max_len. The seeds (weights 3, streams
0-9) are pinned: exact equality rests on them, because a near-tie between
the top two logits could flip an argmax between the two engines'
roundings.

Within the port: K=4 equals K=1 equals one-at-a-time LLMEngine.generate.
Engine behaviour (cancel, TTL, backpressure, typed errors, page leaks)
and PrefixCache cases mirror tests/test_continuous_batching.py.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import scheduler as jsched
from paddle_tpu.inference.serving import PageAllocator as JaxAllocator
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.convert import load_numpy_params
from paddle_tpu_torch.inference import scheduler as tsched
from paddle_tpu_torch.inference.serving import LLMEngine, PageAllocator
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

torch.set_num_threads(1)

GEOM = dict(max_len=48, page_size=8, max_batch=2, prefill_chunk=8)
_PAIRS = {}


def _pair(kv=None):
    """(JAX model, port model) with identical weights (seeded in JAX)."""
    if kv not in _PAIRS:
        paddle.seed(3)
        jm = JaxLlama(JaxConfig.tiny(num_hidden_layers=2,
                                     num_key_value_heads=kv))
        tm = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=2,
                                               num_key_value_heads=kv),
                              device="cpu")
        load_numpy_params(tm, {n: np.asarray(p.data)
                               for n, p in jm.named_parameters()})
        _PAIRS[kv] = (jm, tm)
    return _PAIRS[kv]


def _stream(n, seed, max_budget=9, lo=3, hi=18):
    rng = np.random.RandomState(seed)
    lens = rng.randint(lo, hi, n)
    prompts = [rng.randint(0, 128, (int(t),)).astype(np.int64)
               for t in lens]
    budgets = [int(b) for b in rng.randint(3, max_budget, n)]
    return prompts, budgets


def _assert_no_leak(eng):
    h = eng.health()
    assert h["pages_free"] + h["prefix_pages"] == h["pages_total"], h


def _run_both(K, prompts, budgets, kv=None, eos=None, **kw):
    jm, tm = _pair(kv)
    geom = dict(GEOM, **kw)
    jeng = jsched.ContinuousBatchingEngine(jm, decode_block=K, **geom)
    teng = tsched.ContinuousBatchingEngine(tm, decode_block=K,
                                           device="cpu", **geom)
    ref = jeng.generate_many(prompts, max_new_tokens=budgets,
                             eos_token_id=eos)
    got = teng.generate_many(prompts, max_new_tokens=budgets,
                             eos_token_id=eos)
    for i, (a, b) in enumerate(zip(ref, got)):
        np.testing.assert_array_equal(b, a, err_msg=f"request {i}, K={K}")
    _assert_no_leak(teng)
    return jeng, teng, got


# ------------------------------------------------------ against the JAX engine
@pytest.mark.parametrize("K", [1, 4])
def test_ragged_stream_equals_jax(K):
    prompts, budgets = _stream(5, seed=0)
    jeng, teng, _ = _run_both(K, prompts, budgets)
    assert teng.admissions == 5 and teng.slot_reuses >= 3
    for key in ("steps", "prefill_steps", "decode_steps", "fused_blocks",
                "chained_blocks"):
        assert teng.health()[key] == jeng.health()[key], key
    if K > 1:
        assert teng.fused_blocks > 0


def test_eos_mid_block_equals_jax():
    jm, tm = _pair()
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, 128, (t,)).astype(np.int64) for t in (9, 6)]
    free = tsched.ContinuousBatchingEngine(
        tm, device="cpu", **GEOM).generate_many(prompts, max_new_tokens=12)
    eos = int(free[0][prompts[0].size + 2])   # request 0's third token
    _, _, got = _run_both(4, prompts, [12, 12], eos=eos)
    # EOS fired early for request 0 (at or before its third token)
    assert got[0].size <= prompts[0].size + 3 and int(got[0][-1]) == eos


@pytest.mark.parametrize("K", [1, 4])
def test_int8_equals_jax(K):
    # one slot bucket: half the reference's compiled variants (test time)
    prompts, budgets = _stream(4, seed=2)
    _run_both(K, prompts, budgets, quant="int8", slot_buckets=[2])


@pytest.mark.parametrize("K", [1, 4])
def test_gqa_equals_jax(K):
    prompts, budgets = _stream(4, seed=3)
    _run_both(K, prompts, budgets, kv=2)


def test_ragged_kernel_forced_equals_jax():
    """ragged_kernel=True on both sides: the interpret Pallas kernel in
    the reference, the plain ragged version in the port."""
    prompts, budgets = _stream(4, seed=4)
    _run_both(4, prompts, budgets, ragged_kernel=True)


@pytest.mark.parametrize("K", [1, 4])
def test_shared_prefix_cow_equals_jax(K):
    """An identical prompt shares every page and copies the last one on
    write; a prompt ending mid-page shares through the partial index; the
    counters match the reference's."""
    jm, tm = _pair()
    base = np.random.RandomState(1).randint(0, 128, (16,)).astype(np.int64)
    other = np.concatenate([base[:8], base[8:12] + 1])
    geom = dict(GEOM, page_size=4)
    jeng = jsched.ContinuousBatchingEngine(jm, decode_block=K, **geom)
    teng = tsched.ContinuousBatchingEngine(tm, decode_block=K,
                                           device="cpu", **geom)
    for prompts in ([base], [base.copy(), base[:10]], [other, base[:6]]):
        ref = jeng.generate_many(prompts, max_new_tokens=5)
        got = teng.generate_many(prompts, max_new_tokens=5)
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(b, a)
    assert teng.cow_copies == jeng.cow_copies >= 1
    assert teng._prefix.hits == jeng._prefix.hits > 0
    _assert_no_leak(teng)


@pytest.mark.parametrize("K", [1, 4])
def test_chunk_past_max_len_equals_jax(K):
    """max_len 48 is not a multiple of prefill_chunk 32: the last chunk of
    a 40-token prompt covers positions 32..63, past the rope table and the
    page table. Those positions are clamped for the gathers and write
    nothing."""
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, 128, (t,)).astype(np.int64) for t in (40, 37)]
    _run_both(K, prompts, [8, 11], prefill_chunk=32)


# ------------------------------------------------------------ within the port
def test_k4_equals_k1_equals_generate():
    _, tm = _pair()
    prompts, budgets = _stream(5, seed=6, max_budget=14)
    outs = {K: tsched.ContinuousBatchingEngine(
        tm, decode_block=K, device="cpu", **GEOM).generate_many(
            prompts, max_new_tokens=budgets) for K in (1, 4)}
    eng = LLMEngine(tm, max_len=48, page_size=8, max_batch=1, device="cpu")
    for i, (p, n) in enumerate(zip(prompts, budgets)):
        one = eng.generate(p[None], max_new_tokens=n)[0]
        np.testing.assert_array_equal(outs[1][i], one)
        np.testing.assert_array_equal(outs[4][i], one)


def test_chained_blocks_same_ids():
    """Steady-state decode queues block N+1 before block N is read; the
    ids still equal the per-step engine's."""
    _, tm = _pair()
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, 128, (t,)).astype(np.int64) for t in (9, 5)]
    o1 = tsched.ContinuousBatchingEngine(
        tm, device="cpu", **GEOM).generate_many(prompts, max_new_tokens=24)
    eng = tsched.ContinuousBatchingEngine(tm, decode_block=4, device="cpu",
                                          **GEOM)
    o4 = eng.generate_many(prompts, max_new_tokens=24)
    for a, b in zip(o1, o4):
        np.testing.assert_array_equal(a, b)
    assert eng.chained_blocks > 0
    _assert_no_leak(eng)


@pytest.mark.parametrize("K", [1, 4])
def test_full_width_decode_same_ids(K, monkeypatch):
    """On CUDA the op chain pads every decode step to R = 4 x max_batch
    slots, the extra rows inactive (cuBLAS picks its product kernel by the
    row count, so a row's bits must not depend on how many slots share its
    step, nor on whether it was decoded or verified: R is a verify pass's
    row count at T = 4). Forced on the CPU with max_batch 4 and two
    requests, so that every step is narrower than the slots: the padded
    steps (16 rows) give the bucketed engine's ids and leak no page."""
    _, tm = _pair()
    prompts, budgets = _stream(2, seed=6, max_budget=14)
    geom = dict(GEOM, max_batch=4)
    ref = tsched.ContinuousBatchingEngine(
        tm, decode_block=K, device="cpu", **geom).generate_many(
            prompts, max_new_tokens=budgets)
    widths = []
    math = tsched.ContinuousBatchingEngine._decode_math

    def spy(self, tok, *a, **k):
        widths.append(tok.shape[0])
        return math(self, tok, *a, **k)

    monkeypatch.setattr(tsched.ContinuousBatchingEngine,
                        "_at_full_width", lambda self: True)
    monkeypatch.setattr(tsched.ContinuousBatchingEngine, "_decode_math", spy)
    eng = tsched.ContinuousBatchingEngine(tm, decode_block=K, device="cpu",
                                          **geom)
    got = eng.generate_many(prompts, max_new_tokens=budgets)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(b, a)
    assert min(widths) < 4 and 16 in widths and 4 not in widths
    _assert_no_leak(eng)


@pytest.mark.parametrize("K", [1, 4])
def test_full_width_prefill_same_ids(K, monkeypatch):
    """On CUDA a fused block's prefill also runs at the full slot width
    (max_batch x chunk rows, the extra slots inactive); the per-step path
    (K = 1) prefills one request at a time, a width the schedule never
    changes, and is not padded. Forced on the CPU with max_batch 4 and two
    requests of several chunks: the padded engine gives the bucketed
    engine's ids and leaks no page."""
    _, tm = _pair()
    prompts, budgets = _stream(2, seed=6, max_budget=14, lo=12, hi=30)
    geom = dict(GEOM, max_batch=4)
    ref = tsched.ContinuousBatchingEngine(
        tm, decode_block=K, device="cpu", **geom).generate_many(
            prompts, max_new_tokens=budgets)
    widths = []
    phase = tsched.ContinuousBatchingEngine._prefill_phase

    def spy(self, ids, *a, **k):
        widths.append(ids.shape[0])
        return phase(self, ids, *a, **k)

    monkeypatch.setattr(tsched.ContinuousBatchingEngine,
                        "_at_full_width", lambda self: True)
    monkeypatch.setattr(tsched.ContinuousBatchingEngine, "_prefill_phase",
                        spy)
    eng = tsched.ContinuousBatchingEngine(tm, decode_block=K, device="cpu",
                                          **geom)
    got = eng.generate_many(prompts, max_new_tokens=budgets)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(b, a)
    if K == 1:
        assert set(widths) == {1}
    else:   # every narrow call is followed by its padded one
        assert min(widths) < 4 and widths.count(4) >= sum(w < 4 for w in widths)
    _assert_no_leak(eng)


# -------------------------------------------------------- engine behaviour
def _tiny_engine(**kw):
    _, tm = _pair()
    return tsched.ContinuousBatchingEngine(tm, device="cpu",
                                           **dict(GEOM, **kw))


@pytest.mark.parametrize("K", [1, 4])
def test_cancel_mid_flight(K):
    eng = _tiny_engine(decode_block=K)
    prompts, _ = _stream(3, seed=8)
    uids = [eng.add_request(p, 10) for p in prompts]
    while eng.status(uids[0]) != "decode":
        eng.step()
    assert eng.cancel(uids[0]) is True
    assert eng.cancel(uids[2]) in (True, False)
    eng.drain()
    assert eng.status(uids[0]) == "cancelled"
    with pytest.raises(tsched.RequestCancelledError) as ei:
        eng.result(uids[0])
    assert ei.value.failure.stage == "cancel"
    assert eng.result(uids[1]).size == prompts[1].size + 10
    assert eng.cancel(uids[1]) is False
    assert eng.health()["cancelled"] >= 1
    _assert_no_leak(eng)


@pytest.mark.parametrize("K", [1, 4])
def test_ttl_expiry(K):
    eng = _tiny_engine(decode_block=K)
    prompts, _ = _stream(2, seed=9)
    doomed = eng.add_request(prompts[0], 20, ttl_steps=5)
    ok = eng.add_request(prompts[1], 4)
    eng.drain()
    with pytest.raises(tsched.RequestFailedError) as ei:
        eng.result(doomed)
    assert ei.value.failure.stage == "deadline"
    assert ei.value.failure.error == "DeadlineExceededError"
    assert eng.result(ok).size == prompts[1].size + 4
    assert eng.health()["deadline_expiries"] == 1
    assert set(eng.failures()) == {doomed}
    _assert_no_leak(eng)


def test_queue_limit_backpressure_and_typed_errors():
    eng = _tiny_engine(queue_limit=2)
    p = np.arange(5, dtype=np.int64)
    a, b = eng.add_request(p, 3), eng.add_request(p, 3)
    with pytest.raises(tsched.EngineBusyError, match="queue_limit=2"):
        eng.add_request(p, 3)
    assert len(eng) == 2 and eng.pending() == [a, b]
    assert eng.queue_head_uid() == a
    with pytest.raises(tsched.RequestNotFinishedError):
        eng.result(a)
    with pytest.raises(tsched.UnknownRequestError):
        eng.result(99)
    with pytest.raises(KeyError):
        eng.status(99)
    assert eng.drain().keys() == {a, b}
    assert eng.drain() == {}
    assert len(eng) == 0 and eng.health()["done"] == 2
    with pytest.raises(ValueError, match="max_len=48"):
        eng.add_request(np.zeros(45, np.int64), max_new_tokens=8)
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.add_request(p, max_new_tokens=0)
    with pytest.raises(ValueError, match="empty"):
        eng.add_request(np.zeros(0, np.int64))
    _assert_no_leak(eng)


def test_health_keys_and_unported_options():
    eng = _tiny_engine()
    assert set(eng.health()) == {
        "queued", "running", "slots_total", "queue_limit", "pages_free",
        "pages_total", "prefix_pages", "prefix_hits", "done", "failed",
        "cancelled", "steps", "prefill_steps", "decode_steps", "admissions",
        "failures", "deadline_expiries", "cow_copies", "decode_block",
        "fused_blocks", "chained_blocks", "megakernel",
        "megakernel_whole_step", "sampled_requests", "sample_k",
        "sample_fold", "speculate", "drafter", "spec_passes", "spec_emitted",
        "spec_accept_rate", "spec_tokens_per_pass", "draft_errors",
        "spec_sampled_accept_rate", "tp", "tp_mode", "tp_compress",
        "preemptions", "tenants", "handoffs_out", "handoffs_in", "kv_tier",
        "demoted", "pages_demoted", "demotions", "restores",
        "restore_failures", "demote_errors", "tier", "adapters"}
    assert (eng.health()["tp"], eng.health()["tp_mode"]) == (1, None)
    _, tm = _pair()
    # speculation is ported (A5(d)), and so are tenants (A5(e)), telemetry
    # (A7.3), adapters (A7.2), KV tiering (A7.4) and the request export
    # (A7.6); the fleet prefix index (A7.5) is refused
    assert tsched.ContinuousBatchingEngine(
        tm, device="cpu", speculate=4).health()["speculate"] == 4
    assert tsched.ContinuousBatchingEngine(
        tm, device="cpu", tenants={"a": {}}).health()["tenants"]["a"][
            "share"] == 1.0
    assert tsched.ContinuousBatchingEngine(
        tm, device="cpu", telemetry=True).telemetry is not None
    for kw, key, want in ((dict(kv_tier="host"), "kv_tier", "host"),
                          (dict(tier_dir="kv_tier"), "kv_tier", None),
                          (dict(tier_host_cap_mb=64), "kv_tier", None)):
        assert tsched.ContinuousBatchingEngine(
            tm, device="cpu", **kw).health()[key] == want
    assert tsched.ContinuousBatchingEngine(
        tm, device="cpu", adapters=True).health()["adapters"]["rank"] == 4
    with pytest.raises(NotImplementedError, match="A7.5"):
        eng.attach_prefix_index(None, "r0")
    # tensor parallelism is ported (A7.10): the reference's refusals stay
    with pytest.raises(ValueError, match="tp_mode"):
        tsched.ContinuousBatchingEngine(tm, device="cpu", tp=2,
                                        tp_mode="gather?")
    assert tsched.ContinuousBatchingEngine(
        tm, device="cpu", tp=2, tp_mode="psum").health()["tp_mode"] == "psum"
    # sampling is ported (A5(c)): a spec dict is taken and counted
    u = eng.add_request(np.arange(4), 2, sampling={"do_sample": True})
    assert eng.health()["sampled_requests"] == 1
    spec = eng.export_request(u)
    assert spec["sampling"]["do_sample"] and spec["state"] == "queued"


def test_static_generate_reclaims_prefix_pages():
    """generate() on a CB engine whose pool is held by the prefix cache
    evicts idle cached pages instead of raising EngineFullError."""
    eng = _tiny_engine(max_batch=1, max_len=32)
    p = (np.arange(16) % 128).astype(np.int64)
    o1 = eng.generate_many([p], max_new_tokens=16)[0]
    assert eng.health()["prefix_pages"] == 2
    o2 = eng.generate(p[None], max_new_tokens=16)[0]
    np.testing.assert_array_equal(o1, o2)
    _assert_no_leak(eng)


# ------------------------------------------------------------- PrefixCache
def _cache3(Cache, Alloc):
    a = Alloc(8)
    c = Cache(4)
    pages = {}
    for name, toks in (("A", (1, 2, 3, 4)), ("B", (5, 6, 7, 8)),
                       ("C", (9, 10, 11, 12))):
        pg = a.alloc()
        c.insert((), toks, pg, a)       # the cache takes its own reference
        a.free([pg])                    # creator retires: cache-only
        pages[name] = pg
    return a, c, pages


def _oldest_unused(Cache, Alloc):
    a, c, pages = _cache3(Cache, Alloc)
    hit, covered = c.match(np.asarray([1, 2, 3, 4], np.int64))
    obs = [hit == [pages["A"]], covered, c.evict(1, a)]
    return obs + [a.refcount(pages[n]) for n in "ABC"]


def _in_use_bumped(Cache, Alloc):
    a, c, pages = _cache3(Cache, Alloc)
    a.share(pages["A"])                 # a running request holds A
    obs = [c.evict(2, a), a.refcount(pages["A"]), len(c)]
    a.free([pages["A"]])
    return obs + [c.evict(1, a), a.available]


def _protect(Cache, Alloc):
    a, c, pages = _cache3(Cache, Alloc)
    return [c.evict(3, a, protect={pages["B"]}), a.refcount(pages["B"]),
            len(c)]


def _chains_and_partial(Cache, Alloc):
    a = Alloc(8)
    c = Cache(4)
    k1 = c.insert((), (1, 2, 3, 4), a.alloc(), a)
    c.insert(k1, (5, 6, 7, 8), a.alloc(), a)
    obs = [c.match(np.asarray([1, 2, 3, 4, 5, 6], np.int64)),
           c.match(np.asarray([9, 2, 3, 4], np.int64)),
           c.chain_key((), [1, 2, 3, 4]) == k1,
           c.continuation(np.asarray([1, 2, 3, 4, 5]), 6).tolist(),
           len(c)]
    c.clear(a)
    return obs + [len(c), a.available]


@pytest.mark.parametrize("scenario", [_oldest_unused, _in_use_bumped,
                                      _protect, _chains_and_partial],
                         ids=lambda f: f.__name__.strip("_"))
def test_prefix_cache_matches_reference(scenario):
    ref = scenario(jsched.PrefixCache, JaxAllocator)
    got = scenario(tsched.PrefixCache, PageAllocator)
    assert got == ref


def test_serve_llama_scheduler_demo(capsys):
    """`serve_llama --scheduler` on the CPU: three requests, one prefix
    hit and one copy-on-write, every page back."""
    from paddle_tpu_torch import serve_llama
    serve_llama.main(["--scheduler", "--decode-block", "4", "--device", "cpu",
                      "--max_new_tokens", "6"])
    out = capsys.readouterr().out
    assert "3 ragged requests" in out and "chained)" in out
    assert "1 prefix-page hits, 1 copy-on-writes" in out
    assert "3 done / 0 failed, 7/8 pages free, 1 held" in out
