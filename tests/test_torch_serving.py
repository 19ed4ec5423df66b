"""Serving engine: paddle_tpu_torch's LLMEngine against the JAX LLMEngine.

Greedy token ids must be EXACTLY equal to the reference engine's on the
same weights (tiny config, f32, CPU: the port runs its plain PyTorch
versions, the reference its Pallas kernels in interpret mode) across
{fp, int8} x {MHA, GQA} x {host loop, device loop}, for the flash-prefill
path, and with EOS trimming. The seeds (weights 3 and 5, prompts 0 and 1)
are pinned: exact equality rests on them, because a near-tie between the
top two logits could flip an argmax between the two engines' roundings.

The page allocator runs the same scenarios as the reference's and must
give the same observations.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import serving as jserving
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.convert import load_numpy_params
from paddle_tpu_torch.inference import serving as tserving
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

torch.set_num_threads(1)


# ------------------------------------------------------------- allocator
def _cycle(A, Full):
    a = A(4)
    pages = [a.alloc() for _ in range(4)]
    obs = [sorted(pages)]
    try:
        a.alloc()
    except RuntimeError as e:
        obs.append(type(e).__name__)
    a.free(pages[:2])
    return obs + [a.available]


def _refcounts(A, Full):
    a = A(4)
    p = a.alloc()
    a.share(p)
    obs = [a.refcount(p)]
    a.free([p])
    obs += [a.refcount(p), a.available]
    a.free([p])
    obs += [a.available]
    for bad in (lambda: a.free([p]), lambda: a.share(p)):
        try:
            bad()
        except RuntimeError as e:
            obs.append(str(e).split(":")[0])
    return obs + [a.total_allocs]


def _export(A, Full):
    a = A(8)
    pages = [a.alloc() for _ in range(3)]
    tok = a.export_begin(pages)
    obs = [a.available, a.is_exporting(pages[0]), list(a.export_pages(tok))]
    a.export_commit(tok)
    obs.append(a.available)
    try:
        a.export_commit(tok)
    except RuntimeError as e:
        obs.append("closed" in str(e))
    keep = [a.alloc() for _ in range(2)]
    tok = a.export_begin(keep)
    a.export_abort(tok)
    obs.append(a.available)
    a.free([keep[0]])
    try:
        a.export_begin([keep[0]])
    except RuntimeError as e:
        obs.append("not a live page" in str(e))
    return obs


def _import(A, Full):
    src, dst = A(8), A(8)
    tok = src.export_begin([src.alloc(), src.alloc()])
    got = dst.import_begin(tok, 3)
    obs = [len(got), dst.available]
    dst.import_commit(tok)
    try:
        dst.import_begin(tok, 3)
    except RuntimeError as e:
        obs.append("double import" in str(e))
    dst.import_begin("retry", 4)
    obs.append(dst.available)
    dst.import_abort("retry")
    obs.append(dst.available)
    try:
        dst.import_begin("big", 9)
    except Full:
        obs.append(("full", dst.available))
    dst.import_begin("big", 1)
    dst.import_commit("big")
    return obs + [dst.available]


@pytest.mark.parametrize("scenario", [_cycle, _refcounts, _export, _import],
                         ids=lambda f: f.__name__.strip("_"))
def test_page_allocator_matches_reference(scenario):
    ref = scenario(jserving.PageAllocator, jserving.EngineFullError)
    got = scenario(tserving.PageAllocator, tserving.EngineFullError)
    assert got == ref


# ---------------------------------------------------------------- engine
_PAIRS = {}
_JAX_ENGINES = {}


def _pair(kv, hd64=False):
    """(JAX model, port model) with identical weights (seeded in JAX)."""
    key = (kv, hd64)
    if key not in _PAIRS:
        if hd64:
            paddle.seed(5)
            kw = dict(vocab_size=128, hidden_size=128, intermediate_size=256,
                      num_hidden_layers=2, num_attention_heads=2,
                      max_position_embeddings=128)
            jm, cfg = JaxLlama(JaxConfig(**kw)), LlamaConfig(**kw)
        else:
            paddle.seed(3)
            jm = JaxLlama(JaxConfig.tiny(num_hidden_layers=2,
                                         num_key_value_heads=kv))
            cfg = LlamaConfig.tiny(num_hidden_layers=2, num_key_value_heads=kv)
        tm = LlamaForCausalLM(cfg, device="cpu")
        load_numpy_params(tm, {n: np.asarray(p.data)
                               for n, p in jm.named_parameters()})
        _PAIRS[key] = (jm, tm)
    return _PAIRS[key]


def _engines(quant, kv, **kw):
    jm, tm = _pair(kv)
    key = (quant, kv)
    if key not in _JAX_ENGINES:
        _JAX_ENGINES[key] = jserving.LLMEngine(
            jm, max_len=64, page_size=16, max_batch=2, quant=quant, **kw)
    teng = tserving.LLMEngine(tm, max_len=64, page_size=16, max_batch=2,
                              quant=quant, device="cpu", **kw)
    return _JAX_ENGINES[key], teng


def _prompts(seed=0, t=12):
    return np.random.RandomState(seed).randint(0, 128, (2, t)).astype(
        np.int64)


@pytest.mark.parametrize("device_loop", [False, True],
                         ids=["host", "device_loop"])
@pytest.mark.parametrize("kv", [None, 2], ids=["mha", "gqa2"])
@pytest.mark.parametrize("quant", [None, "int8"], ids=["fp", "int8"])
def test_greedy_ids_equal_jax(quant, kv, device_loop):
    jeng, teng = _engines(quant, kv)
    ids = _prompts()
    ref = jeng.generate(ids, max_new_tokens=8, device_loop=device_loop)
    got = teng.generate(ids, max_new_tokens=8, device_loop=device_loop)
    assert got.dtype == np.int64 and got.shape == (2, 20)
    np.testing.assert_array_equal(got, ref)
    assert teng.allocator.available == teng.n_pages   # pages returned


def test_flash_prefill_equals_jax(monkeypatch):
    """head_dim 64 with flash_prefill_min=1: every prefill takes the flash
    path in both engines (as tests/test_flash_prefill.py does for JAX)."""
    jm, tm = _pair(None, hd64=True)
    calls = []
    real = tserving.flash_attention_fwd

    def spy(*a, **k):
        calls.append(k.get("s_true"))
        return real(*a, **k)

    monkeypatch.setattr(tserving, "flash_attention_fwd", spy)
    ids = _prompts(seed=1, t=20)
    kw = dict(max_len=64, page_size=16, max_batch=2, flash_prefill_min=1)
    ref = jserving.LLMEngine(jm, **kw).generate(ids, max_new_tokens=6)
    teng = tserving.LLMEngine(tm, device="cpu", **kw)
    assert teng.hd == 64
    got = teng.generate(ids, max_new_tokens=6)
    np.testing.assert_array_equal(got, ref)
    assert calls == [20, 20]          # one per layer, true length masked
    dense = tserving.LLMEngine(tm, device="cpu", max_len=64, page_size=16,
                               max_batch=2, flash_prefill_min=10 ** 9)
    np.testing.assert_array_equal(dense.generate(ids, max_new_tokens=6), got)


@pytest.mark.parametrize("device_loop", [False, True],
                         ids=["host", "device_loop"])
def test_eos_trimming_equals_jax(device_loop):
    jeng, teng = _engines(None, None)
    ids = _prompts()
    free = jeng.generate(ids, max_new_tokens=8)
    eos = int(free[0, 12 + 2])         # row 0 emits it at its third token
    ref = jeng.generate(ids, max_new_tokens=8, eos_token_id=eos)
    got = teng.generate(ids, max_new_tokens=8, eos_token_id=eos,
                        device_loop=device_loop)
    np.testing.assert_array_equal(got, ref)
    assert got.shape[1] < free.shape[1] or (got[:, 12:] == eos).any()


def test_engine_full_error_claims_nothing():
    _, tm = _pair(None)
    eng = tserving.LLMEngine(tm, max_len=32, page_size=16, max_batch=2,
                             device="cpu")
    held = [eng.allocator.alloc() for _ in range(3)]
    before = eng.allocator.available
    with pytest.raises(tserving.EngineFullError, match="engine full"):
        eng.generate(_prompts()[:1], max_new_tokens=8)   # 2 pages
    assert eng.allocator.available == before
    eng.allocator.free(held)
    with pytest.raises(ValueError, match="max_batch"):
        eng.generate(np.zeros((3, 4), np.int64), max_new_tokens=2)
    with pytest.raises(ValueError, match="max_len"):
        eng.generate(np.zeros((1, 30), np.int64), max_new_tokens=4)


def test_sampling_is_seeded_and_in_range():
    _, tm = _pair(2)
    eng = tserving.LLMEngine(tm, max_len=64, page_size=16, max_batch=2,
                             device="cpu", batch_buckets=[2])
    ids = _prompts()[:1]
    kw = dict(max_new_tokens=6, do_sample=True, temperature=0.8, top_k=20,
              top_p=0.9, seed=4)
    a = eng.generate(ids, **kw)
    b = eng.generate(ids, device_loop=True, **kw)
    assert a.shape == (1, 18) and ((a >= 0) & (a < 128)).all()
    np.testing.assert_array_equal(a, b)   # one generator stream either way
    np.testing.assert_array_equal(a, eng.generate(ids, **kw))


@pytest.mark.parametrize("device_loop", [False, True],
                         ids=["host", "device_loop"])
@pytest.mark.parametrize("kw", [
    dict(temperature=0.8, top_k=20, top_p=0.9, seed=4),
    dict(temperature=1.3, seed=(1 << 33) + 17),
    dict(temperature=0.7, top_p=0.8, seed=-5)], ids=["k20p09", "big_seed",
                                                      "neg_seed"])
def test_sampled_ids_equal_jax(kw, device_loop):
    """Exact ids: sampled generate() draws the reference's key chain
    (key(seed), one split before every token) and its Gumbel bits, so the
    ids equal the JAX engine's for the same seed, in the host loop and the
    device loop; a seed above 2^32 keeps both words (JAX under x64)."""
    from paddle_tpu.jax_compat import enable_x64
    jeng, teng = _engines(None, 2)
    ids = _prompts(seed=1)
    with enable_x64(True):
        ref = jeng.generate(ids, max_new_tokens=7, do_sample=True,
                            device_loop=device_loop, **kw)
    got = teng.generate(ids, max_new_tokens=7, do_sample=True,
                        device_loop=device_loop, **kw)
    np.testing.assert_array_equal(got, ref)


def test_unported_options_raise():
    """tp is ported (inference/tp.py): the reference's refusals stay —
    tp must divide the heads, and compression rides psum only; a single
    CUDA device for tp shards is refused (pass one per shard). PTQ scales
    are ported (quantization/ptq.py): without quant="int8" they are
    refused, as in the reference."""
    _, tm = _pair(None)
    with pytest.raises(ValueError, match="must divide"):
        tserving.LLMEngine(tm, tp=3, device="cpu")
    with pytest.raises(ValueError, match="psum"):
        tserving.LLMEngine(tm, tp=2, tp_compress="int8", device="cpu")
    with pytest.raises(ValueError, match="one device per shard"):
        tserving.LLMEngine(tm, tp=2, device="cuda:0")
    eng = tserving.LLMEngine(tm, tp=2, device="cpu")
    assert eng.tp == 2 and eng.nh_l == eng.nh // 2
    with pytest.raises(ValueError, match="quant_scales"):
        tserving.LLMEngine(tm, quant_scales=object(), device="cpu")
