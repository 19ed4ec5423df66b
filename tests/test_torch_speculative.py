"""Speculative decoding: paddle_tpu_torch's drafters, verify entry, the
megakernel's tq > 1 schedule and ContinuousBatchingEngine(speculate=T)
against the JAX package. The cases replay tests/test_speculative.py
(TestDrafters, TestSpecByteIdentity, TestVerifyKernel, TestAdaptiveK) and
tests/test_sampling_v2.py (TestSpecSampled, the rejection_sample pin).
TestSpecFaults waits for the port of failsafe.py (ROADMAP A7.0) and
TestTenants for tenants and preemption (A5(e)).

Engines run the reference tests' model (`LlamaConfig.tiny(
num_key_value_heads=2, num_hidden_layers=2)`, seed-7 weights carried
across by name; f32 on the CPU: the port runs its plain versions, the
JAX engine its Pallas kernels in interpret mode) on the reference's
geometry (max_len 64, page 8, 4 slots) and `spec_prompts` mix. One JAX
engine run unspeculated and one at speculate=4 are shared by the module.

Each test says whether it pins exact values or a tolerance. Greedy and
sampled ids are exact: spec streams equal the port's unspeculated stream
and the JAX engine's speculate=4 stream token for token. Kernel-level
floats (f32, other summation orders) are held within 1e-5.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.inference import sampling as jsampling
from paddle_tpu.inference import scheduler as jsched
from paddle_tpu.inference import speculative as jspec
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu.ops.pallas.decode_megakernel import (
    decode_megakernel as jax_megakernel, pack_decode_layer, pack_lm_head,
    stack_packed)
from paddle_tpu_torch.convert import load_numpy_params
from paddle_tpu_torch.inference import sampling as S
from paddle_tpu_torch.inference.scheduler import (ContinuousBatchingEngine,
                                                  PrefixCache)
from paddle_tpu_torch.inference.speculative import (Drafter, ModelDrafter,
                                                    NGramDrafter,
                                                    PrefixCacheDrafter,
                                                    rejection_sample,
                                                    resolve_drafter)
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops.pallas import paged_attention as tpa
from paddle_tpu_torch.ops.pallas.decode_megakernel import (
    MAX_ROWS, MegakernelPack, decode_megakernel)

torch.set_num_threads(1)

GEOM = dict(max_len=64, page_size=8, max_batch=4, prefill_chunk=8,
            slot_buckets=(4,))
NEW = 14
_PAIR = {}


def _pair():
    """(JAX model, port model) with the reference tests' seed-7 weights."""
    if not _PAIR:
        paddle.seed(7)
        jm = JaxLlama(JaxConfig.tiny(num_key_value_heads=2,
                                     num_hidden_layers=2))
        tm = LlamaForCausalLM(LlamaConfig.tiny(num_key_value_heads=2,
                                               num_hidden_layers=2),
                              device="cpu")
        load_numpy_params(tm, {n: np.asarray(p.data)
                               for n, p in jm.named_parameters()})
        _PAIR["m"] = (jm, tm)
    return _PAIR["m"]


def spec_prompts(seed=0):
    """The reference's mix: a repetitive suffix (n-gram draftable), a short
    random prompt, and a prompt sharing the first one's motif."""
    V = 128
    rng = np.random.RandomState(seed)
    motif = rng.randint(0, V, (4,))
    return [np.tile(motif, 5).astype(np.int64)[:18],
            rng.randint(0, V, (7,)).astype(np.int64),
            np.tile(motif, 4).astype(np.int64)[:13]]


def mk(**kw):
    return ContinuousBatchingEngine(_pair()[1], device="cpu",
                                    **dict(GEOM, **kw))


def assert_no_leak(eng):
    held = 0 if eng._prefix is None else len(eng._prefix)
    assert eng.allocator.available == eng.allocator.n_pages - held


def _same(ref, got, tag):
    for i, (a, b) in enumerate(zip(ref, got)):
        np.testing.assert_array_equal(b, a, err_msg=f"{tag}: request {i}")


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX engine unspeculated and at speculate=4 (greedy, one run
    each), and the port's unspeculated stream, which equals both."""
    jm, _ = _pair()
    ref = jsched.ContinuousBatchingEngine(jm, **GEOM).generate_many(
        spec_prompts(), max_new_tokens=NEW)
    jeng = jsched.ContinuousBatchingEngine(jm, speculate=4, **GEOM)
    spec = jeng.generate_many(spec_prompts(), max_new_tokens=NEW)
    port = mk().generate_many(spec_prompts(), max_new_tokens=NEW)
    _same(ref, spec, "JAX spec")
    _same(ref, port, "port unspeculated")
    return dict(ref=ref, spec=spec, health=jeng.health())


# ------------------------------------------------------------ TestDrafters
def test_ngram_repetition():
    """Exact: the continuation of the most recent earlier occurrence."""
    d = NGramDrafter(n=3)
    ctx = np.array([5, 6, 7, 8, 5, 6, 7, 8, 5, 6], np.int64)
    np.testing.assert_array_equal(d.propose(ctx, 3), [7, 8, 5])
    assert d.propose(np.array([1, 2, 3, 4], np.int64), 3).size == 0
    assert d.propose(np.array([9], np.int64), 3).size == 0
    # the longest pattern wins: [2, 3] (then 4) over [3] alone (then 9)
    ctx = np.array([2, 3, 4, 3, 9, 2, 3], np.int64)
    np.testing.assert_array_equal(d.propose(ctx, 1), [4])
    for ctx, k in ((np.arange(30) % 7, 5), (np.arange(12) % 3, 4)):
        np.testing.assert_array_equal(
            d.propose(ctx, k), jspec.NGramDrafter(n=3).propose(ctx, k))


def test_prefix_cache_continuation():
    """Exact: the drafter walks the port's PrefixCache chains."""
    cache = PrefixCache(page_size=4)

    class _Alloc:
        def share(self, p):
            return p

    seq = np.arange(100, 112, dtype=np.int64)       # 3 full pages
    key = ()
    for j, page in enumerate((0, 1, 2)):
        key = cache.insert(key, seq[j * 4:(j + 1) * 4], page, _Alloc())
    np.testing.assert_array_equal(cache.continuation(seq[:6], 4), seq[6:10])
    np.testing.assert_array_equal(cache.continuation(seq[:4], 8), seq[4:12])
    assert cache.continuation(np.array([1, 2, 3, 4, 5], np.int64),
                              4).size == 0
    d = PrefixCacheDrafter(cache)
    np.testing.assert_array_equal(d.propose(seq[:6], 2), seq[6:8])
    fb = PrefixCacheDrafter(cache, fallback=NGramDrafter())
    ctx = np.array([5, 6, 7, 5, 6], np.int64)
    np.testing.assert_array_equal(fb.propose(ctx, 1), [7])


def test_model_drafter_matches_greedy():
    """Exact: the port's ModelDrafter proposes the model's greedy tokens,
    the JAX ModelDrafter's proposals on the same weights."""
    jm, tm = _pair()
    ctx = np.random.RandomState(3).randint(0, 128, (9,)).astype(np.int64)
    prop = ModelDrafter(tm, bucket=16).propose(ctx, 2)
    assert prop.shape == (2,)
    pad = np.zeros((1, 16), np.int64)
    pad[0, :ctx.size] = ctx
    with torch.no_grad():
        logits = tm(torch.tensor(pad))[0, ctx.size - 1]
    assert int(prop[0]) == int(logits.argmax())
    np.testing.assert_array_equal(
        prop, jspec.ModelDrafter(jm, bucket=16).propose(ctx, 2))


def test_resolve_drafter_and_timing():
    """Exact: the knob's values and the self-accounting of timed_propose."""
    assert isinstance(resolve_drafter("ngram", None), NGramDrafter)
    assert isinstance(resolve_drafter(None, None), NGramDrafter)
    d = NGramDrafter()
    assert resolve_drafter(d, None) is d
    pre = resolve_drafter("prefix", PrefixCache(4))
    assert isinstance(pre, PrefixCacheDrafter)
    assert isinstance(pre.fallback, NGramDrafter)
    with pytest.raises(ValueError, match="prefix_cache"):
        resolve_drafter("prefix", None)
    with pytest.raises(ValueError, match="drafter"):
        resolve_drafter("turbo", None)
    with pytest.raises(ValueError, match="min_n"):
        NGramDrafter(n=1, min_n=2)
    d.timed_propose(np.arange(8) % 3, 2)
    d.timed_propose(np.arange(8) % 3, 2)
    assert d.proposals == 2 and d.propose_seconds >= 0


def test_rejection_sample_equals_jax():
    """Exact: accepted flags and tokens equal the JAX rejection_sample's on
    the same keys (a delta proposal and a spread one)."""
    p = np.array([0.05, 0.1, 0.4, 0.15, 0.2, 0.1], np.float32)
    q_spread = np.array([0.3, 0.1, 0.1, 0.2, 0.2, 0.1], np.float32)
    q_delta = np.zeros(6, np.float32)
    q_delta[2] = 1.0
    seeds = np.arange(40, dtype=np.uint32) * 7919
    pos = np.arange(40, dtype=np.int32)
    jkeys = jsampling.fold_keys(jnp.asarray(seeds), jnp.asarray(pos))
    tkeys = S.fold_keys(torch.tensor(seeds.astype(np.int64)),
                        torch.tensor(pos))
    for q, d in ((q_delta, 2), (q_spread, 0)):
        j_acc, j_tok = jax.vmap(
            lambda k: jspec.rejection_sample(p, q, d, k))(jkeys)
        got = [rejection_sample(p, q, d, tkeys[i]) for i in range(40)]
        assert [bool(a) for a, _ in got] == np.asarray(j_acc).tolist()
        assert [int(t) for _, t in got] == np.asarray(j_tok).tolist()
    assert any(not bool(a) for a, _ in got) and any(bool(a) for a, _ in got)


# --------------------------------------------------------- the verify entry
def test_verify_entry_matches_jax_and_sequential_steps():
    """Tolerance 1e-5 (f32): `spec_verify_attention`'s plain version
    against the JAX verify entry (interpret mode) and row j against the
    j-th of K sequential `paged_attention` steps (the plain versions sum
    in other orders; on the card the kernels are held bit for bit, in
    chip_smoke.py). Exact: the ragged causal mask equals the JAX one."""
    rng = np.random.RandomState(0)
    b, h, hkv, d, p, npg, mp, K = 3, 4, 2, 16, 8, 12, 4, 4
    kp = rng.randn(npg, p, hkv, d).astype(np.float32)
    vp = rng.randn(npg, p, hkv, d).astype(np.float32)
    table = rng.permutation(npg)[:b * mp].reshape(b, mp).astype(np.int32)
    lens = np.array([5, 9, 13], np.int32)
    q = rng.randn(b, K, h, d).astype(np.float32)
    act = np.array([1, 1, 1], np.int32)
    ref = np.asarray(jpa.spec_verify_attention(
        *(jnp.asarray(a) for a in (q, kp, vp, table, lens)),
        active=jnp.asarray(act), interpret=True))
    t = [torch.from_numpy(a) for a in (q, kp, vp, table, lens)]
    got = tpa.spec_verify_attention(*t, active=torch.from_numpy(act))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
    seq = torch.stack([tpa.paged_attention(t[0][:, j], t[1], t[2], t[3],
                                           t[4] + j + 1)
                       for j in range(K)], 1)
    np.testing.assert_allclose(got.numpy(), seq.numpy(), atol=1e-5, rtol=0)
    # an inactive slot emits zeros
    act0 = torch.tensor([1, 0, 1], dtype=torch.int32)
    assert (tpa.spec_verify_attention(*t, active=act0)[1] == 0).all()
    for q_start, ctx in ((5, 9), (0, 3)):
        m_j = np.asarray(jpa.ragged_causal_mask((8, 16), 4, q_start, 8, ctx))
        m_t = tpa.ragged_causal_mask((8, 16), 4, q_start, 8, ctx).numpy()
        np.testing.assert_array_equal(m_t, m_j)


# ----------------------------------------------- the megakernel at tq > 1
B, T_MK, NH, NH_KV, HD, H, F, V_MK, P, MP, N_PAGES = (
    2, 4, 4, 2, 8, 32, 48, 50, 8, 4, 8)
LENS = np.array([5, 11], np.int64)
WMASK = np.array([1, 1, 1, 1, 1, 1, 0, 0], np.int32)   # slot 1: 1 draft
EPS = 1e-5
_PROJ = (("wq", NH * HD), ("wk", NH_KV * HD), ("wv", NH_KV * HD),
         ("wo", H), ("wg", F), ("wu", F), ("wd", H))
_KIN = {"wo": NH * HD, "wd": F}


def _mk_state(seed=1):
    rng = np.random.RandomState(seed)
    layers = []
    for _ in range(2):
        ws = {n: (rng.randn(_KIN.get(n, H), m) * 0.1).astype(np.float32)
              for n, m in _PROJ}
        ws["ln1"] = (rng.rand(H) + 0.5).astype(np.float32)
        ws["ln2"] = (rng.rand(H) + 0.5).astype(np.float32)
        layers.append(ws)
    R = B * T_MK
    return dict(
        layers=layers, head=(rng.randn(H, V_MK) * 0.1).astype(np.float32),
        norm=(rng.rand(H) + 0.5).astype(np.float32),
        kpg=rng.randn(2, N_PAGES, P, NH_KV, HD).astype(np.float32),
        vpg=rng.randn(2, N_PAGES, P, NH_KV, HD).astype(np.float32),
        tbl=rng.choice(N_PAGES, (B, MP), replace=False).astype(np.int32),
        h=rng.randn(R, H).astype(np.float32),
        cos=rng.randn(R, HD // 2).astype(np.float32),
        sin=rng.randn(R, HD // 2).astype(np.float32))


def _positions():
    return (LENS[:, None] + np.arange(T_MK)[None, :]).reshape(-1)


def test_megakernel_verify_matches_jax():
    """decode_megakernel's plain version at tq = 4 (2 slots, a write mask
    leaving slot 1's last two rows ungated) against the JAX kernel at
    tq = 4 in interpret mode, 2 layers and the head. Tolerance 1e-5 (f32):
    h, the logits and the written k/v rows. Exact: the greedy tokens, the
    ungated positions keeping their pool bytes, every other pool row
    untouched."""
    st = _mk_state()
    act = np.array([1, 1], np.int32)
    jw = [pack_decode_layer({k: jnp.asarray(v) for k, v in ws.items()})
          for ws in st["layers"]]
    ho, kn, vn, tok_j, _, logits_j = [np.asarray(o) for o in jax_megakernel(
        jnp.asarray(st["h"]), stack_packed(jw), jnp.asarray(st["kpg"]),
        jnp.asarray(st["vpg"]), jnp.asarray(st["tbl"]),
        jnp.asarray(LENS.astype(np.int32)), jnp.asarray(act),
        jnp.asarray(st["cos"]), jnp.asarray(st["sin"]), nh=NH, nh_kv=NH_KV,
        hd=HD, eps=EPS, interpret=True, tq=T_MK, wmask=jnp.asarray(WMASK),
        head=pack_lm_head(jnp.asarray(st["head"]), jnp.asarray(st["norm"])),
        head_v=V_MK)]
    rows = N_PAGES * P
    flat = {key: [torch.cat([torch.tensor(st[key][li]).reshape(rows, NH_KV,
                                                                HD),
                             torch.zeros(1, NH_KV, HD)])
                  for li in range(2)] for key in ("kpg", "vpg")}
    cos = torch.zeros((MP * P, HD // 2))
    sin = torch.zeros((MP * P, HD // 2))
    cos[_positions()] = torch.tensor(st["cos"])
    sin[_positions()] = torch.tensor(st["sin"])
    pack = MegakernelPack(
        [{k: torch.tensor(v) for k, v in ws.items()} for ws in st["layers"]],
        flat["kpg"], flat["vpg"], cos, sin, nh=NH, nh_kv=NH_KV, hd=HD,
        eps=EPS, page_size=P, norm=torch.tensor(st["norm"]),
        head=torch.tensor(st["head"]))
    h, tok, _, logits = decode_megakernel(
        torch.tensor(st["h"]), pack, torch.tensor(st["tbl"]),
        torch.tensor(LENS), torch.tensor(act), head=True, tq=T_MK,
        wmask=torch.tensor(WMASK))
    np.testing.assert_allclose(h.numpy(), ho, atol=1e-5, rtol=0)
    np.testing.assert_allclose(logits.numpy(), logits_j, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tok.numpy(), tok_j)
    pos = _positions()
    slot_of = np.repeat(np.arange(B), T_MK)
    flat_rows = st["tbl"][slot_of, pos // P].astype(np.int64) * P + pos % P
    for li in range(2):
        for key, new, f in (("kpg", kn[li], pack.k_flat[li]),
                            ("vpg", vn[li], pack.v_flat[li])):
            orig = st[key][li].reshape(rows, NH_KV, HD)
            got = f[:rows].numpy()
            gated = flat_rows[WMASK > 0]
            np.testing.assert_allclose(
                got[gated].reshape(len(gated), -1), new[WMASK > 0],
                atol=1e-5, rtol=0)
            rest = np.setdiff1d(np.arange(rows), gated)
            assert np.array_equal(got[rest], orig[rest]), (key, li)


def test_megakernel_verify_bitwise_op_chain():
    """Exact: one verify pass's logits, tokens and every pool byte through
    the megakernel's plain version ("layer" and "multi") equal the op
    chain's `_spec_verify_math` (int8, a mixed write mask)."""
    got = {}
    for mode in (False, "layer", "multi"):
        eng = mk(speculate=4, megakernel=mode, quant="int8")
        for p in spec_prompts()[:2]:
            eng.add_request(p, 6)
        while any(r is None or r.state != "decode" for r in eng._slots[:2]):
            eng.step()
        feed = torch.tensor([[int(eng._tok_np[0]), 3, 9, 27],
                             [int(eng._tok_np[1]), 5, 7, 0],
                             [0] * 4, [0] * 4])
        args = (feed, torch.tensor(eng._tables_np), torch.tensor(eng._lens_np),
                torch.tensor([True, True, False, False]),
                torch.tensor([6, 2, 0, 0]), torch.tensor([3, 2, 0, 0]))
        with torch.no_grad():
            logits, greedy = eng._spec_verify_math(*args)
        got[mode] = (logits, greedy, eng._k_flat[1][:-1].clone(),
                     eng._v_flat[1][:-1].clone())
    for mode in ("layer", "multi"):
        for a, b in zip(got[False], got[mode]):
            assert torch.equal(a, b), mode


# ------------------------------------------------------------ the engine
@pytest.mark.parametrize("db,mode", [(1, False), (4, False), (1, "layer"),
                                     (4, "layer"), (1, "multi"),
                                     (4, "multi")])
def test_greedy_spec_ids_equal_unspeculated_and_jax(jax_runs, db, mode):
    """Exact: speculate=4 ids equal the port's unspeculated stream and the
    JAX engine's speculate=4 stream, at decode_block 1 and 4, on the op
    chain and the megakernel's plain version in both modes; the verify
    counters equal the JAX engine's at decode_block 1."""
    eng = mk(speculate=4, decode_block=db, megakernel=mode)
    outs = eng.generate_many(spec_prompts(), max_new_tokens=NEW)
    _same(jax_runs["ref"], outs, f"db={db} mk={mode}")
    _same(jax_runs["spec"], outs, f"db={db} mk={mode} vs JAX spec")
    h = eng.health()
    assert h["speculate"] == 4 and h["drafter"] == "ngram"
    assert h["spec_passes"] > 0 and h["spec_emitted"] >= h["spec_passes"]
    if db == 1:
        jh = jax_runs["health"]
        for key in ("spec_passes", "spec_emitted", "spec_accept_rate",
                    "spec_tokens_per_pass"):
            assert h[key] == jh[key], key
    assert_no_leak(eng)


def test_greedy_spec_int8_equals_unspeculated_and_jax():
    """Exact: the int8 snapshot at speculate=4, decode_block 1 and 4 (one
    short request, as the reference's int8 case), equals the unspeculated
    int8 stream and the JAX engine's int8 speculate=4 stream."""
    jm, _ = _pair()
    prompts = spec_prompts(seed=1)[:1]
    ref = mk(quant="int8").generate_many(prompts, max_new_tokens=8)
    jax_spec = jsched.ContinuousBatchingEngine(
        jm, quant="int8", speculate=4, **GEOM).generate_many(
        prompts, max_new_tokens=8)
    _same(ref, jax_spec, "JAX int8 spec")
    for db in (1, 4):
        eng = mk(quant="int8", speculate=4, decode_block=db)
        _same(ref, eng.generate_many(prompts, max_new_tokens=8),
              f"int8 db={db}")
        assert eng.health()["spec_accept_rate"] > 0
        assert_no_leak(eng)


@pytest.mark.parametrize("db", [1, 4])
def test_full_width_verify_same_ids(db, monkeypatch):
    """On CUDA the op chain's verify pass runs at max_batch x T rows, the
    extra slots inactive (cuBLAS picks its product kernel by the row
    count). Forced on the CPU with slot buckets below max_batch and two
    requests: the padded passes give the bucketed engine's ids and leak no
    page."""
    geom = dict(slot_buckets=(1, 2))
    prompts = spec_prompts()[:2]
    ref = mk(speculate=4, decode_block=db, **geom).generate_many(
        prompts, max_new_tokens=NEW)
    widths = []
    verify = ContinuousBatchingEngine._spec_verify_math

    def spy(self, feed, *a, **k):
        widths.append(feed.shape[0])
        return verify(self, feed, *a, **k)

    monkeypatch.setattr(ContinuousBatchingEngine, "_at_full_width",
                        lambda self: True)
    monkeypatch.setattr(ContinuousBatchingEngine, "_spec_verify_math", spy)
    eng = mk(speculate=4, decode_block=db, **geom)
    _same(ref, eng.generate_many(prompts, max_new_tokens=NEW),
          f"full width db={db}")
    assert min(widths) < 4 and 4 in widths
    assert_no_leak(eng)


def test_eos_mid_pass_matches(jax_runs):
    """Exact: an EOS met inside a verify pass retires the request where
    the unspeculated engine does (decode_block 1 and 4)."""
    eos = int(jax_runs["ref"][0][spec_prompts()[0].size + 3])
    ref = mk().generate_many(spec_prompts(), max_new_tokens=NEW,
                             eos_token_id=eos)
    assert ref[0].size < spec_prompts()[0].size + NEW
    for db in (1, 4):
        eng = mk(speculate=4, decode_block=db)
        _same(ref, eng.generate_many(spec_prompts(), max_new_tokens=NEW,
                                     eos_token_id=eos), f"eos db={db}")
        assert_no_leak(eng)


def test_emits_more_than_one_token_per_pass():
    """Exact counters: on a repetitive suffix the n-gram drafter's
    acceptances push tokens per pass above 1."""
    motif = np.random.RandomState(11).randint(0, 128, (4,))
    eng = mk(speculate=4)
    eng.generate_many([np.tile(motif, 6).astype(np.int64)[:22]],
                      max_new_tokens=24)
    h = eng.health()
    assert h["spec_tokens_per_pass"] > 1.0, h
    assert h["spec_emitted"] == 23        # the first token is prefill's


class _OracleDrafter(Drafter):
    """Proposes the known continuation of any context that is a prefix of
    a reference row."""

    name = "oracle"

    def __init__(self, rows):
        self.rows = [np.asarray(r) for r in rows]

    def propose(self, ctx, k):
        ctx = np.asarray(ctx)
        for row in self.rows:
            if row.size > ctx.size and (row[:ctx.size] == ctx).all():
                return row[ctx.size:ctx.size + k]
        return np.empty((0,), np.int64)


class _WrongDrafter(Drafter):
    name = "wrong"

    def __init__(self, token):
        self.token = int(token)

    def propose(self, ctx, k):
        return np.full(k, self.token, np.int64)


def test_adaptive_k_oracle_full_acceptance(jax_runs):
    """Exact: an oracle drafter is accepted every time and keeps every
    request at the longest draft (T - 1 = 3)."""
    eng = mk(speculate=4, drafter=_OracleDrafter(jax_runs["ref"]))
    _same(jax_runs["ref"], eng.generate_many(spec_prompts(),
                                             max_new_tokens=NEW), "oracle")
    h = eng.health()
    assert h["spec_accept_rate"] == 1.0 and h["drafter"] == "oracle", h
    assert all(r.draft_k == 3 for r in eng._requests.values())


def test_adaptive_k_wrong_drafter_shrinks(jax_runs):
    """Exact: a drafter that is always wrong (speculate=8) still gives the
    unspeculated ids; every pass accepts nothing and draft_k halves to 1."""
    emitted = set(np.concatenate(jax_runs["ref"]).tolist())
    bad = next(t for t in range(128) if t not in emitted)
    eng = mk(speculate=8, drafter=_WrongDrafter(bad))
    _same(jax_runs["ref"], eng.generate_many(spec_prompts(),
                                             max_new_tokens=NEW), "wrong")
    assert eng.health()["spec_accept_rate"] == 0.0
    assert all(r.draft_k == 1 for r in eng._requests.values())


def test_adaptive_k_short_drafts_stay_aligned(jax_runs):
    """Exact: decode_block 4 with draft_k 2 < T - 1: the per-pass slices
    stride draft_k + 1, so a perfect drafter is accepted in every pass."""
    eng = mk(speculate=8, decode_block=4, spec_adaptive=False,
             drafter=_OracleDrafter(jax_runs["ref"]))
    uids = [eng.add_request(p, max_new_tokens=NEW) for p in spec_prompts()]
    for u in uids:
        eng._requests[u].draft_k = 2
    eng.drain()
    _same(jax_runs["ref"], [eng.result(u) for u in uids], "short drafts")
    assert eng.health()["spec_accept_rate"] == 1.0


def test_adaptive_k_broken_drafter_degrades(jax_runs):
    """Exact: a drafter that raises costs its drafts, never a request."""
    class _Boom(Drafter):
        name = "boom"

        def propose(self, ctx, k):
            raise RuntimeError("drafter crashed")

    eng = mk(speculate=4, drafter=_Boom())
    _same(jax_runs["ref"], eng.generate_many(spec_prompts(),
                                             max_new_tokens=NEW), "boom")
    h = eng.health()
    assert eng.draft_errors > 0 and h["draft_errors"] == eng.draft_errors
    assert h["spec_accept_rate"] == 0.0 and h["failed"] == 0


# ------------------------------------------------------ sampled speculation
def _sp(i, make):
    return make(do_sample=True, temperature=0.8, top_k=6, top_p=0.95,
                min_p=0.02, seed=100 + i)


def _sampled_run(eng, make):
    uids = [eng.add_request(p, NEW, sampling=_sp(i, make))
            for i, p in enumerate(spec_prompts())]
    eng.drain()
    return [np.asarray(eng.result(u)) for u in uids]


def test_sampled_spec_equals_unspeculated_and_jax():
    """Exact: sample-and-match on the position keys: the port's sampled
    speculate=4 streams (op chain at decode_block 1, "multi" through the
    top-K fold at decode_block 4, "layer" with the materialized arm) equal
    its unspeculated sampled stream and the JAX engine's speculate=4
    sampled stream."""
    jm, _ = _pair()
    ref = _sampled_run(jsched.ContinuousBatchingEngine(jm, speculate=4,
                                                       **GEOM),
                       jsampling.SamplingParams)
    _same(ref, _sampled_run(mk(), S.SamplingParams), "unspeculated")
    for kw in (dict(), dict(decode_block=4, megakernel="multi"),
               dict(megakernel="layer", sample_fold=False)):
        eng = mk(speculate=4, **kw)
        _same(ref, _sampled_run(eng, S.SamplingParams), str(kw))
        h = eng.health()
        assert h["sampled_requests"] == 3 and h["spec_passes"] > 0
        assert 0.0 <= h["spec_sampled_accept_rate"] <= 1.0
        assert_no_leak(eng)


# ------------------------------------------------------------- refusals
def test_typed_refusals(monkeypatch):
    """Exact (no numerics): the reference's checks on speculate= (True, a
    negative width, a width past max_len; 1 turns it off), processors
    under speculate, drafter values, and a width past the megakernel's
    rows refused at construction on CUDA."""
    with pytest.raises(ValueError, match="not True"):
        mk(speculate=True)
    with pytest.raises(ValueError, match=">= 2"):
        mk(speculate=-2)
    with pytest.raises(ValueError, match="max_len"):
        mk(speculate=65)
    assert mk(speculate=1).health()["speculate"] == 0
    assert mk().health()["drafter"] is None
    with pytest.raises(ValueError, match="prefix_cache"):
        mk(speculate=4, drafter="prefix", prefix_cache=False)
    assert mk(speculate=4, drafter="prefix").health()["drafter"] == "prefix"
    eng = mk(speculate=4)
    with pytest.raises(ValueError, match="speculate"):
        eng.add_request(spec_prompts()[0], 4, sampling=S.SamplingParams(
            do_sample=True, repetition_penalty=1.2))
    # the kernel's register sums cover MAX_ROWS rows: on CUDA a forced
    # megakernel with T > MAX_ROWS is refused where the mode resolves
    eng = mk(speculate=MAX_ROWS + 1)
    monkeypatch.setattr(eng, "device", torch.device("cuda"))
    with pytest.raises(ValueError, match="speculate=9"):
        eng._resolve_megakernel("multi")
    assert eng._resolve_megakernel(None) is False
    eng = mk(speculate=MAX_ROWS)
    monkeypatch.setattr(eng, "device", torch.device("cuda"))
    assert eng._resolve_megakernel("multi") == "multi"


def test_serve_llama_speculate_demo(capsys):
    """Exact: `serve_llama --scheduler --speculate 4` serves the
    unspeculated tails with both drafters, every page back."""
    from paddle_tpu_torch import serve_llama
    args = ["--scheduler", "--decode-block", "4", "--device", "cpu",
            "--max_new_tokens", "6", "--megakernel", "multi"]
    tails = {}
    for extra in ([], ["--speculate", "4", "--drafter", "ngram"],
                  ["--speculate", "4", "--drafter", "prefix"]):
        serve_llama.main(args + extra)
        out = capsys.readouterr().out
        assert "3 done / 0 failed, 7/8 pages free, 1 held" in out
        if extra:
            assert f"speculate=4/{extra[-1]}" in out
        tails[" ".join(extra)] = [ln for ln in out.splitlines()
                                  if "tail" in ln]
    assert len(set(map(tuple, tails.values()))) == 1
