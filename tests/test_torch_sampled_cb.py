"""Sampled continuous batching: paddle_tpu_torch's ContinuousBatchingEngine
with per-request SamplingParams against the JAX ContinuousBatchingEngine.

Exact ids throughout: on the same weights (`LlamaConfig.tiny()` with 2
layers, f32, CPU: the port runs its plain versions, the reference its
Pallas kernels in interpret mode) a sampled stream depends only on (seed,
position), so the port's streams must equal the JAX engine's canonical
ones (decode_block 1, megakernel off) token for token on the op chain and
in "layer" and "multi" megakernel modes at decode_block 1 and 8, with the
in-kernel fold and the materialized arm, dense and int8, for mixed
greedy / sampled batches, solo against batched, penalties, a stop
sequence mid-block and a JSON-schema grammar. The cases replay
tests/test_sampling_v2.py. The seeds (weights 3, prompts 3, request seeds
100 + i) are pinned: exact equality rests on them, because the two
engines' logits differ in the last bits (other summation orders) and a
candidate pair within that rounding could flip a draw.
"""
import re
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import sampling as jsampling
from paddle_tpu.inference import scheduler as jsched
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.convert import load_numpy_params
from paddle_tpu_torch.inference import scheduler as tsched
from paddle_tpu_torch.inference.sampling import (SamplingParams,
                                                 TokenMaskAutomaton,
                                                 json_schema_pattern)
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

torch.set_num_threads(1)

GEOM = dict(max_len=48, page_size=8, max_batch=2, prefill_chunk=8)
NEW = 8
V = 128
_PAIR = {}


def _pair():
    """(JAX model, port model) with identical weights (seeded in JAX)."""
    if not _PAIR:
        paddle.seed(3)
        jm = JaxLlama(JaxConfig.tiny(num_hidden_layers=2))
        tm = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=2),
                              device="cpu")
        load_numpy_params(tm, {n: np.asarray(p.data)
                               for n, p in jm.named_parameters()})
        _PAIR["m"] = (jm, tm)
    return _PAIR["m"]


def _prompts():
    rng = np.random.RandomState(3)
    return [rng.randint(0, V, n).astype(np.int64) for n in (5, 9, 12)]


def _kw(i, **over):
    kw = dict(do_sample=True, temperature=0.8, top_k=6, top_p=0.95,
              min_p=0.02, seed=100 + i)
    kw.update(over)
    return kw


def _run(side, specs, prompts=None, budget=NEW, eos=None, **kw):
    """Submit one request per spec (a SamplingParams kwargs dict or None)
    and drain; returns (outputs, engine)."""
    jm, tm = _pair()
    prompts = _prompts() if prompts is None else prompts
    if side == "jax":
        eng = jsched.ContinuousBatchingEngine(jm, **GEOM, **kw)
        make = jsampling.SamplingParams
    else:
        eng = tsched.ContinuousBatchingEngine(tm, device="cpu", **GEOM, **kw)
        make = SamplingParams
    uids = [eng.add_request(p, budget, eos_token_id=eos,
                            sampling=None if s is None else make(**s))
            for p, s in zip(prompts, specs)]
    eng.drain()
    return [np.asarray(eng.result(u)) for u in uids], eng


def _same(ref, got, tag):
    for i, (a, b) in enumerate(zip(ref, got)):
        np.testing.assert_array_equal(b, a, err_msg=f"{tag}: request {i}")


@pytest.fixture(scope="module")
def ref():
    """The JAX engine's canonical streams (decode_block 1, op chain):
    sampled, greedy, penalized, and sampled int8."""
    out = {}
    out["sampled"], _ = _run("jax", [_kw(i) for i in range(3)])
    out["greedy"], _ = _run("jax", [None] * 3)
    pen = _kw(0, temperature=0.9, seed=21, repetition_penalty=1.3,
              presence_penalty=0.2, frequency_penalty=0.1)
    out["proc"], _ = _run("jax", [pen, pen], prompts=_prompts()[:2])
    out["int8"], _ = _run("jax", [_kw(i) for i in range(3)], quant="int8")
    # the streams really sample: no sampled request repeats its greedy ids
    for s, g in zip(out["sampled"], out["greedy"]):
        assert not np.array_equal(s, g)
    return out


# ------------------------------------------------------ against the JAX engine
@pytest.mark.parametrize("K", [1, 8])
@pytest.mark.parametrize("mk", [False, "layer", "multi"])
def test_sampled_streams_equal_jax(ref, mk, K):
    """Exact: three sampled requests (two slots, one reuse) on the op chain
    and in both megakernel modes at decode_block 1 and 8."""
    got, eng = _run("port", [_kw(i) for i in range(3)], megakernel=mk,
                    decode_block=K)
    _same(ref["sampled"], got, f"mk={mk} K={K}")
    h = eng.health()
    assert h["sampled_requests"] == 3
    assert h["sample_k"] == 8 and h["sample_fold"] is True
    assert h["pages_free"] + h["prefix_pages"] == h["pages_total"]


def test_materialized_arm_equals_fold(ref):
    """Exact: sample_fold=False selects from materialized logits in
    "multi" mode: the same candidates, the same tokens."""
    got, _ = _run("port", [_kw(i) for i in range(3)], megakernel="multi",
                  decode_block=8, sample_fold=False)
    _same(ref["sampled"], got, "materialized")


def test_int8_sampled_equals_jax(ref):
    """Exact: int8 weights, the fold in "multi" mode at decode_block 8."""
    got, _ = _run("port", [_kw(i) for i in range(3)], megakernel="multi",
                  decode_block=8, quant="int8")
    _same(ref["int8"], got, "int8")


def test_mixed_greedy_sampled_batch(ref):
    """Exact: greedy rows in a sampled batch reproduce the all-greedy
    engine, the sampled row the all-sampled reference."""
    got, _ = _run("port", [None, _kw(1), None], megakernel="multi",
                  decode_block=8)
    np.testing.assert_array_equal(got[0], ref["greedy"][0])
    np.testing.assert_array_equal(got[2], ref["greedy"][2])
    np.testing.assert_array_equal(got[1], ref["sampled"][1])


def test_solo_equals_batched(ref):
    """Exact: a request alone draws the stream it drew among others."""
    got, _ = _run("port", [_kw(2)], prompts=_prompts()[2:],
                  megakernel="multi", decode_block=8)
    np.testing.assert_array_equal(got[0], ref["sampled"][2])


@pytest.mark.parametrize("K", [1, 8])
def test_penalties_equal_jax(ref, K):
    """Exact: repetition / presence / frequency penalties ("proc" mode:
    materialized logits, host-advanced counts) at decode_block 1 and 8."""
    pen = _kw(0, temperature=0.9, seed=21, repetition_penalty=1.3,
              presence_penalty=0.2, frequency_penalty=0.1)
    got, eng = _run("port", [pen, pen], prompts=_prompts()[:2],
                    megakernel=False, decode_block=K)
    _same(ref["proc"], got, f"proc K={K}")
    assert eng.chained_blocks == 0       # proc blocks never chain


def test_stop_sequence_truncates_mid_block(ref):
    """Exact: a stop bigram of the greedy stream retires the request with
    it; tokens the block computed past it are dropped (decode_block 4),
    as in the JAX engine."""
    p0 = _prompts()[0]
    g = ref["greedy"][0][p0.size:]
    pair = (int(g[2]), int(g[3]))
    j = next(i for i in range(1, len(g))
             if (int(g[i - 1]), int(g[i])) == pair)
    spec = dict(stop=(pair,))
    got, _ = _run("port", [spec], prompts=[p0], decode_block=4)
    want, _ = _run("jax", [spec], prompts=[p0], decode_block=4)
    np.testing.assert_array_equal(got[0], np.concatenate([p0, g[:j + 1]]))
    np.testing.assert_array_equal(got[0], want[0])


def test_json_schema_grammar_walk():
    """Exact: a character-token vocabulary under {"type": "integer"}; the
    port's stream equals the JAX engine's, every token is allowed from the
    automaton state the host tracks, and EOS arrives only in an accepting
    state."""
    toks = [""] * V
    for i in range(10):
        toks[i] = str(i)
    toks[10] = "-"
    eos = 11
    auto = TokenMaskAutomaton.from_json_schema({"type": "integer"}, toks,
                                               eos_id=eos)
    jauto = jsampling.TokenMaskAutomaton.from_json_schema(
        {"type": "integer"}, toks, eos_id=eos)
    p0 = _prompts()[:1]
    spec = dict(do_sample=True, temperature=1.0, seed=5)
    jm, tm = _pair()
    outs = []
    for side, a, K in (("jax", jauto, 1), ("port", auto, 1),
                       ("port", auto, 8)):
        eng = (jsched.ContinuousBatchingEngine(jm, **GEOM) if side == "jax"
               else tsched.ContinuousBatchingEngine(tm, device="cpu",
                                                    decode_block=K, **GEOM))
        make = (jsampling.SamplingParams if side == "jax"
                else SamplingParams)
        u = eng.add_request(p0[0], 12, eos_token_id=eos,
                            sampling=make(grammar=a, **spec))
        eng.drain()
        outs.append(np.asarray(eng.result(u)))
    np.testing.assert_array_equal(outs[1], outs[0])
    np.testing.assert_array_equal(outs[2], outs[0])
    gen = outs[1][p0[0].size:]
    state = 0
    for t in gen:
        assert auto.mask[state, int(t)], (int(t), state)
        if int(t) == eos:
            assert state in auto.accept_states
            break
        state = auto.advance(state, int(t))
    if eos in gen:
        text = "".join(toks[int(t)] for t in gen if int(t) != eos)
        assert re.fullmatch(r"-?[0-9]+", text), text


def test_default_sampling_folds_uid_and_deprecates():
    """Exact: the deprecated engine-level do_sample warns and becomes each
    request's default, its seed folded with the uid as the JAX engine
    folds it; the streams equal the JAX engine's."""
    jm, tm = _pair()
    kw = dict(do_sample=True, temperature=0.8, top_k=5, seed=11)
    with pytest.warns(DeprecationWarning):
        teng = tsched.ContinuousBatchingEngine(tm, device="cpu", **GEOM, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jeng = jsched.ContinuousBatchingEngine(jm, **GEOM, **kw)
    ref = jeng.generate_many(_prompts()[:2], max_new_tokens=6)
    got = teng.generate_many(_prompts()[:2], max_new_tokens=6)
    _same(ref, got, "default sampling")
    assert teng.health()["sampled_requests"] == 2


def test_rejections():
    """Exact (no numerics): the typed refusals of the reference; an
    engine at speculate=4 takes sampled requests (speculation is
    ported), and a queued sampled request's export spec carries its
    sampling parameters (the export is ported)."""
    _, tm = _pair()
    eng = tsched.ContinuousBatchingEngine(tm, device="cpu", **GEOM)
    p = _prompts()[0]
    with pytest.raises(ValueError, match="sample_k"):
        eng.add_request(p, 4, sampling=SamplingParams(**_kw(0, top_k=16)))
    wrong = TokenMaskAutomaton.from_pattern(
        json_schema_pattern({"type": "boolean"}), ["true", "false", ""],
        eos_id=2)
    with pytest.raises(ValueError, match="vocab"):
        eng.add_request(p, 4, sampling=SamplingParams(do_sample=True,
                                                      grammar=wrong))
    for bad in (0, 129):
        with pytest.raises(ValueError, match="sample_k"):
            tsched.ContinuousBatchingEngine(tm, device="cpu", sample_k=bad,
                                            **GEOM)
    with pytest.raises(ValueError, match="sample_k"):
        tsched.ContinuousBatchingEngine(tm, device="cpu", top_k=9, **GEOM)
    spec = tsched.ContinuousBatchingEngine(tm, device="cpu", speculate=4,
                                           **GEOM)
    assert spec.health()["speculate"] == 4
    us = spec.add_request(p, 3, sampling=SamplingParams(**_kw(0)))
    assert spec.health()["sampled_requests"] == 1
    assert spec.export_request(us)["sampling"] == \
        SamplingParams(**_kw(0)).to_spec()
    # a to_spec() dict is accepted in place of SamplingParams
    u = eng.add_request(p, 3, sampling=SamplingParams(**_kw(0)).to_spec())
    eng.drain()
    assert eng.result(u).size == p.size + 3


def test_serve_llama_sampled_demo(capsys):
    """Exact: `serve_llama --scheduler --temperature ...` serves the same
    sampled tails on the op chain and through the "multi" fold, every
    page back; --sample-rotate samples every other request."""
    from paddle_tpu_torch import serve_llama
    args = ["--scheduler", "--decode-block", "4", "--device", "cpu",
            "--max_new_tokens", "6", "--temperature", "0.8", "--top-k", "6",
            "--top-p", "0.95", "--seed", "42", "--megakernel"]
    tails = {}
    for mk in ("off", "multi"):
        serve_llama.main(args + [mk])
        out = capsys.readouterr().out
        assert "3 sampled" in out and "3 done / 0 failed" in out
        tails[mk] = [ln for ln in out.splitlines() if "tail" in ln]
    assert tails["off"] == tails["multi"] and len(tails["off"]) == 3
    serve_llama.main(args + ["multi", "--sample-rotate"])
    assert "2 sampled" in capsys.readouterr().out
