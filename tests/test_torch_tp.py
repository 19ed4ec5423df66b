"""Tensor-parallel serving: paddle_tpu_torch's tp engines (one process, a
list of CPU shards) against the JAX package's (`shard_map` over the host
device mesh of tests/conftest.py) and against the port's own tp = 1.

Exact (greedy ids equal three ways: port tp, JAX tp, port tp = 1): the
reference's byte-identity matrix of tests/test_tp_decode.py on its micro
configs (1 layer, hidden 32, ffn 64, 4 heads over 2 kv heads, 4 for tp = 4),
op chain, at tp 2 and 4 x int8 x decode_block 1 / 8 x speculate 4, and the
static LLMEngine's generate with and without device_loop. The JAX engines'
outputs are cached per module, as test_tp_decode.py's _REF_CACHE does.

Tolerance: tp_mode="psum" prefill logits within 1e-5 of the JAX psum
engine's (f32; the shards' partial products associate as the reference's,
the products themselves sum in other orders); tp_compress="int8" within
2e-3 of the JAX engine's (both quantize the same partials; a value on a
rounding boundary may land one int8 step apart); the port's
`quantized_psum` against the JAX function inside `shard_map` on the same
per-shard inputs: y and the residual bit for bit. The collectives'
combines (argmax of local max, top-k of local top-k) equal the argmax and
the stable top-k of the gathered row exactly, ties included. The
reference's refusals keep their types and messages.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as paddle
from jax.sharding import Mesh, PartitionSpec as P
from paddle_tpu.distributed import comm_compress as jcc
from paddle_tpu.inference.scheduler import \
    ContinuousBatchingEngine as JaxEngine
from paddle_tpu.inference.serving import LLMEngine as JaxLLMEngine
from paddle_tpu.jax_compat import shard_map
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.convert import load_numpy_params
from paddle_tpu_torch.distributed.comm_compress import (
    dequantize_int8, quantize_int8, quantized_psum)
from paddle_tpu_torch.inference.sampling import top_k
from paddle_tpu_torch.inference.scheduler import ContinuousBatchingEngine
from paddle_tpu_torch.inference.serving import LLMEngine
from paddle_tpu_torch.inference.tp import TPContext
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

torch.set_num_threads(1)

ENGINE_KW = dict(max_len=64, page_size=8, max_batch=4, prefill_chunk=8)
_PAIRS = {}
_JAX = {}


def _pair(nh_kv):
    """(JAX model, port model, cfg) of the reference's micro config with
    identical weights (seeded in JAX)."""
    if nh_kv not in _PAIRS:
        kw = dict(num_hidden_layers=1, hidden_size=32, intermediate_size=64,
                  num_attention_heads=4, num_key_value_heads=nh_kv)
        paddle.seed(3)
        jm = JaxLlama(JaxConfig.tiny(**kw))
        tm = LlamaForCausalLM(LlamaConfig.tiny(**kw), device="cpu")
        load_numpy_params(tm, {n: np.asarray(p.data)
                               for n, p in jm.named_parameters()})
        _PAIRS[nh_kv] = (jm, tm, tm.config)
    return _PAIRS[nh_kv]


def _stream(cfg, n=4, seed=0):
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab_size, (int(t),)).astype(np.int64)
               for t in rng.randint(4, 14, n)]
    budgets = [int(b) for b in rng.randint(4, 10, n)]
    return prompts, budgets


def _jax_run(nh_kv, tp, **over):
    """The JAX engine's outputs for (tp, knobs), computed once a module."""
    key = (nh_kv, tp) + tuple(sorted(over.items()))
    if key not in _JAX:
        jm, _, cfg = _pair(nh_kv)
        eng = JaxEngine(jm, tp=tp, **ENGINE_KW, **over)
        prompts, budgets = _stream(cfg)
        _JAX[key] = eng.generate_many(prompts, max_new_tokens=budgets)
    return _JAX[key]


def _port_run(nh_kv, tp, **over):
    _, tm, cfg = _pair(nh_kv)
    eng = ContinuousBatchingEngine(tm, tp=tp, device="cpu", **ENGINE_KW,
                                   **over)
    prompts, budgets = _stream(cfg)
    return eng.generate_many(prompts, max_new_tokens=budgets), eng


def _assert_equal(ref, outs, tag):
    for i, (a, b) in enumerate(zip(ref, outs)):
        assert np.array_equal(np.asarray(a), b), f"{tag} request {i}"


@pytest.mark.parametrize("tp,quant,block,spec", [
    (2, None, 1, None), (4, None, 1, None), (2, "int8", 1, None),
    (2, None, 8, None), (2, None, 1, 4),
    (4, "int8", 1, None), (2, "int8", 8, None), (4, None, 8, None),
    (2, "int8", 1, 4), (4, None, 1, 4)])
def test_greedy_ids_equal_three_ways(tp, quant, block, spec):
    """Exact: port tp == JAX tp == port tp = 1, op chain; no page leaks;
    health reports the mode."""
    nh_kv = 2 if tp < 4 else 4
    over = dict(quant=quant, decode_block=block, speculate=spec,
                megakernel=False)
    tag = f"tp={tp} quant={quant} block={block} spec={spec}"
    out, eng = _port_run(nh_kv, tp, **over)
    _assert_equal(_jax_run(nh_kv, tp, **over), out, tag + " vs JAX tp")
    one, _ = _port_run(nh_kv, 1, **over)
    _assert_equal(one, out, tag + " vs port tp=1")
    h = eng.health()
    assert (h["tp"], h["tp_mode"], h["tp_compress"]) == (tp, "exact", None)
    assert h["pages_free"] + h["prefix_pages"] == h["pages_total"]
    assert len(eng._kf) == tp and eng._kf[0][0].shape[1] == eng.nh_kv // tp


@pytest.mark.parametrize("dl", [False, True], ids=["host", "device_loop"])
def test_static_generate_equals_jax(dl):
    """Exact: LLMEngine(tp=2).generate, host loop and device loop, greedy
    and sampled (the reference's key flow over the gathered logits), equals
    the JAX tp = 2 engine's and the port's tp = 1."""
    jm, tm, _ = _pair(2)
    ids = np.stack([np.arange(1, 9), np.arange(2, 10)])
    kw = dict(max_len=64, page_size=8, max_batch=2)
    jeng = JaxLLMEngine(jm, tp=2, **kw)
    teng = LLMEngine(tm, tp=2, device="cpu", **kw)
    one = LLMEngine(tm, device="cpu", **kw)
    ref = np.asarray(jeng.generate(ids, max_new_tokens=10, device_loop=dl))
    got = teng.generate(ids, max_new_tokens=10, device_loop=dl)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        got, one.generate(ids, max_new_tokens=10, device_loop=dl))
    sk = dict(max_new_tokens=7, do_sample=True, temperature=0.8, top_k=20,
              top_p=0.9, seed=5, device_loop=dl)
    got = teng.generate(ids, **sk)
    np.testing.assert_array_equal(got, np.asarray(jeng.generate(ids, **sk)))
    np.testing.assert_array_equal(got, one.generate(ids, **sk))
    assert teng.allocator.available == teng.allocator.n_pages


def _jax_prefill_logits(eng, ids):
    """The JAX engine's prefill logits (its compiled prefill, called as
    generate calls it, on fresh pages)."""
    b, t0 = ids.shape
    t_pad = -(-t0 // eng.page_size) * eng.page_size
    tables = np.zeros((b, eng.max_pages_per_seq), np.int32)
    tables[:, :t_pad // eng.page_size] = np.arange(
        b * (t_pad // eng.page_size)).reshape(b, -1)
    ids_pad = np.zeros((b, t_pad), np.int64)
    ids_pad[:, :t0] = ids
    logits, _, _ = eng._build_prefill(t_pad)(
        eng.weights, jnp.asarray(ids_pad), eng.k_pages, eng.v_pages,
        jnp.asarray(tables), t0)
    return np.asarray(logits)


@pytest.mark.parametrize("compress,tol", [(None, 1e-5), ("int8", 2e-3)],
                         ids=["psum", "psum_int8"])
def test_psum_logits_close_to_jax(compress, tol):
    """Tolerance (module docstring): prefill logits of tp_mode="psum" (and
    with tp_compress="int8") against the JAX engine's in the same mode;
    the generated ids of the stream agree with the port's tp = 1 at the
    reference's 90% bar (psum is close, not exact), and with compression
    are in the vocabulary (the reference's bar: a wire trade, not an
    exactness one)."""
    jm, tm, cfg = _pair(2)
    ids = np.stack([np.arange(3, 14), np.arange(20, 31)]) % cfg.vocab_size
    kw = dict(max_len=64, page_size=8, max_batch=2, tp=2, tp_mode="psum",
              tp_compress=compress)
    ref = _jax_prefill_logits(JaxLLMEngine(jm, **kw), ids)
    teng = LLMEngine(tm, device="cpu", **kw)
    got = teng.prefill_logits(ids).numpy()
    np.testing.assert_allclose(got, ref, atol=tol, rtol=0)
    one = LLMEngine(tm, device="cpu", max_len=64, page_size=8, max_batch=2)
    np.testing.assert_allclose(got, one.prefill_logits(ids).numpy(),
                               atol=1e-5 if compress is None else 5e-2,
                               rtol=0)
    out, eng = _port_run(2, 2, tp_mode="psum", tp_compress=compress,
                         megakernel=False)
    one_out, _ = _port_run(2, 1, megakernel=False)
    assert eng.health()["tp_compress"] == compress
    for a, b in zip(one_out, out):
        assert a.shape == b.shape
        assert np.mean(a == b) >= 0.9 if compress is None else \
            ((b >= 0) & (b < cfg.vocab_size)).all()


@pytest.mark.parametrize("tp", [2, 4])
def test_quantized_psum_equals_jax(tp):
    """Bits: y and the residual of every rank, against the JAX function
    inside shard_map over tp host devices, on the same per-rank inputs
    (a ragged size: padding and a partial chunk)."""
    rng = np.random.RandomState(tp)
    xs = (rng.randn(tp, 3, 211) * np.exp(rng.randn(tp, 3, 1))).astype(
        np.float32)
    mesh = Mesh(np.array(jax.devices()[:tp]), ("mp",))
    fn = shard_map(lambda x: jcc.quantized_psum(x[0], "mp", axis_size=tp),
                   mesh=mesh, in_specs=(P("mp"),),
                   out_specs=(P("mp"), P("mp")), check_vma=False)
    jy, jerr = (np.asarray(a).reshape(tp, 3, 211) for a in fn(xs))
    ys, errs = quantized_psum([torch.tensor(x) for x in xs])
    for r in range(tp):
        np.testing.assert_array_equal(ys[r].numpy(), jy[r])
        np.testing.assert_array_equal(errs[r].numpy(), jerr[r])
    # the residual identity: sum(xs) == y + sum(errs) up to f32 rounding
    np.testing.assert_allclose(ys[0].numpy() + sum(e.numpy() for e in errs),
                               xs.sum(0), atol=1e-5)


def test_quantize_int8_equals_jax():
    """Bits: the chunked int8 values, scales and their dequantization
    against the JAX functions (a ragged size, an all-zero chunk)."""
    rng = np.random.RandomState(5)
    x = (rng.randn(3, 301) * 3).astype(np.float32)
    x[0, :256] = 0.0
    q, s, n = quantize_int8(torch.tensor(x))
    jq, js, jn = jcc.quantize_int8(jnp.asarray(x))
    assert n == jn == x.size
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        dequantize_int8(q, s, n, x.shape).numpy(),
        np.asarray(jcc.dequantize_int8(jq, js, jn, x.shape)))


def test_combines_equal_the_gathered_row():
    """Exact: argmax_of_local_max and topk_of_local_topk over 4 vocab
    shards equal argmax and the stable top-k of the whole row, with ties
    inside a shard and across shards (the lower vocab id wins)."""
    tpc = TPContext(4, devices=["cpu"] * 4)
    rng = np.random.RandomState(0)
    row = torch.tensor(rng.randint(0, 6, (5, 40)).astype(np.float32))
    locs = list(row.chunk(4, dim=-1))
    tok = tpc.argmax_of_local_max([x.max(-1).values for x in locs],
                                  [x.argmax(-1) for x in locs], 10)
    assert torch.equal(tok, row.argmax(-1))
    pairs = [top_k(x, 7) for x in locs]
    v, i = tpc.topk_of_local_topk([p[0] for p in pairs],
                                  [p[1] for p in pairs], 10, 7)
    rv, ri = top_k(row, 7)
    assert torch.equal(v, rv) and torch.equal(i, ri)
    # the exact-mode gathers are data movement in shard order
    xs = [torch.randn(2, 3, 1, 4) for _ in range(4)]
    full = tpc.gather_heads(xs)
    assert all(f is full[0] for f in full)        # one device: one tensor
    assert torch.equal(full[0], torch.cat(xs, dim=-2))


def test_split_weights_shares_replicated_and_drops_unsplit():
    """The column weights split in shard order, the row pair replicated
    (exact) as the very same tensor on one device, row-split (psum), the
    head vocab-parallel when tp divides the vocab."""
    _, tm, cfg = _pair(2)
    for mode in ("exact", "psum"):
        eng = LLMEngine(tm, tp=2, tp_mode=mode, device="cpu",
                        max_len=64, page_size=8, max_batch=2)
        one = LLMEngine(tm, device="cpu", max_len=64, page_size=8,
                        max_batch=2)
        w0, w1 = (W["layers"][0] for W in eng._W)
        ref = one.weights["layers"][0]
        assert torch.equal(torch.cat([w0["wq"], w1["wq"]], 1), ref["wq"])
        assert torch.equal(torch.cat([w0["wg"], w1["wg"]], 1), ref["wg"])
        if mode == "exact":
            assert w0["wo"] is w1["wo"] and w0["wd"] is w1["wd"]
        else:
            assert torch.equal(torch.cat([w0["wd"], w1["wd"]], 0), ref["wd"])
        assert eng._W[0]["emb"] is eng._W[1]["emb"]
        assert eng._tpc.head_sharded and \
            eng._W[0]["head"].shape[1] == cfg.vocab_size // 2


def test_refusals_match_the_reference():
    """The reference's refusals, types and messages: tp must divide the
    heads; compression needs psum; a bad mode; the megakernel needs the
    exact mode and an ffn tp divides; fewer devices than shards."""
    _, tm, _ = _pair(2)
    with pytest.raises(ValueError, match="must divide"):
        ContinuousBatchingEngine(tm, tp=3, device="cpu", **ENGINE_KW)
    with pytest.raises(ValueError, match="psum"):
        ContinuousBatchingEngine(tm, tp=2, tp_compress="int8", device="cpu",
                                 **ENGINE_KW)
    with pytest.raises(ValueError, match="tp_mode"):
        ContinuousBatchingEngine(tm, tp=2, tp_mode="gather?", device="cpu",
                                 **ENGINE_KW)
    with pytest.raises(ValueError, match="exact"):
        ContinuousBatchingEngine(tm, tp=2, tp_mode="psum", megakernel="layer",
                                 device="cpu", **ENGINE_KW)
    odd = LlamaForCausalLM(LlamaConfig.tiny(
        num_hidden_layers=1, hidden_size=32, intermediate_size=49,
        num_attention_heads=4, num_key_value_heads=2), device="cpu")
    with pytest.raises(ValueError, match="divide"):
        ContinuousBatchingEngine(odd, tp=2, megakernel="layer", device="cpu",
                                 **ENGINE_KW)
    with pytest.raises(ValueError, match="needs 2 devices"):
        TPContext(2, devices=["cpu"])
    if not torch.cuda.is_available():
        # devices=None takes one CUDA card per shard: never the CPU
        with pytest.raises(ValueError, match="needs 2 devices"):
            LLMEngine(tm, tp=2, max_len=64, page_size=8, max_batch=2)
    with pytest.raises(ValueError, match="tp >= 2"):
        TPContext(1)
