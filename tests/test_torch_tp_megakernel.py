"""The decode megakernel's tensor-parallel segments (seg "qkv" / "tail" /
"down") and the tp engines' megakernel modes, against the JAX package.

Kernel level (tolerance): each segment's plain version (what a CPU tensor
runs) on one tp = 2 shard's pack against the JAX `decode_megakernel(...,
seg=..., interpret=True)` on the same shard's weights, pools and inputs,
in the geometry of tests/test_torch_megakernel.py (GQA 4/2 heads, d 8,
hidden 32, ffn 48, vocab 50, page 8), dense and int8: attn, the written
pool rows, h, act and the local logits within 1e-5 (f32, other summation
orders); the local greedy token and the fold's ids exactly equal to JAX's.
The two shards' segments assembled (head gather, column gather, the
argmax-of-local-max / top-k-of-local-top-k combine) against the tp = 1
seg "full" plain version: h, pools and logits within 1e-5, the token and
the top-k ids exact.

Engine level (exact): greedy ids of ContinuousBatchingEngine(tp=2) with
megakernel "multi" (K 8) and "layer" (K 1, and speculate=4) equal the
port's op chain at tp = 1 and the JAX engine's (megakernel off, tp = 1),
on tests/test_megakernel_v2.py's `tiny` model and ENGINE_KW; the sampled
fold at tp = 2 ("multi", K 8, tests/test_sampling_v2.py:140's case)
equals the canonical sampled stream of both packages.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.inference.sampling import SamplingParams as JaxSP
from paddle_tpu.inference.scheduler import \
    ContinuousBatchingEngine as JaxEngine
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.ops.pallas.decode_megakernel import (
    decode_megakernel as jax_megakernel, pack_decode_layer, pack_lm_head)
from paddle_tpu_torch.convert import load_numpy_params
from paddle_tpu_torch.inference.sampling import SamplingParams, top_k
from paddle_tpu_torch.inference.scheduler import ContinuousBatchingEngine
from paddle_tpu_torch.inference.tp import TPContext
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops.pallas.decode_megakernel import (
    MegakernelPack, decode_megakernel)
from paddle_tpu_torch.ops.pallas.quantized_matmul import quantize_weights

torch.set_num_threads(1)

TOL = 1e-5
TP = 2
B, NH, NH_KV, HD, H, F, V, P, MP, N_PAGES = 2, 4, 2, 8, 32, 48, 50, 8, 4, 8
LENS = np.array([5, 11], np.int64)
ACT = np.array([1, 1], np.int32)
EPS = 1e-5
MAX_LEN = MP * P
# (name, input rows, output columns, split): column-parallel or whole
_PROJ = (("wq", H, NH * HD, True), ("wk", H, NH_KV * HD, True),
         ("wv", H, NH_KV * HD, True), ("wo", NH * HD, H, False),
         ("wg", H, F, True), ("wu", H, F, True), ("wd", F, H, False))


def _state(quant, seed=0):
    """Numpy weights (projections as (int8, scales) pairs when quant),
    pools and inputs of one layer and the head, in full (tp = 1)."""
    rng = np.random.RandomState(seed)
    ws = {n: (rng.randn(k, c) * 0.1).astype(np.float32)
          for n, k, c, _ in _PROJ}
    ws["ln1"] = (rng.rand(H) + 0.5).astype(np.float32)
    ws["ln2"] = (rng.rand(H) + 0.5).astype(np.float32)
    head = (rng.randn(H, V) * 0.1).astype(np.float32)
    if quant:
        def q(w):
            a, s = quantize_weights(torch.tensor(w))
            return a.numpy(), s.numpy()
        ws = {n: (q(w) if n.startswith("w") else w) for n, w in ws.items()}
        head = q(head)
    return dict(
        ws=ws, head=head, norm=(rng.rand(H) + 0.5).astype(np.float32),
        kpg=rng.randn(N_PAGES, P, NH_KV, HD).astype(np.float32),
        vpg=rng.randn(N_PAGES, P, NH_KV, HD).astype(np.float32),
        tbl=rng.choice(N_PAGES, (B, MP), replace=False).astype(np.int32),
        h=rng.randn(B, H).astype(np.float32),
        cos=rng.randn(B, HD // 2).astype(np.float32),
        sin=rng.randn(B, HD // 2).astype(np.float32))


def _cols(w, s, n):
    """Shard s's n output columns of a weight or an (int8, scales) pair."""
    sl = slice(s * n, (s + 1) * n)
    if isinstance(w, tuple):
        return (np.ascontiguousarray(w[0][:, sl]), w[1][sl].copy())
    return np.ascontiguousarray(w[:, sl])


def _shard(st, s):
    """Shard s of the state (tp = 2): its column slices, kv head and vocab
    slice; the row pair whole."""
    ws = {n: (_cols(w, s, c // TP) if split else w)
          for (n, _, c, split), w in ((p, st["ws"][p[0]]) for p in _PROJ)}
    ws.update(ln1=st["ws"]["ln1"], ln2=st["ws"]["ln2"])
    kv = slice(s * NH_KV // TP, (s + 1) * NH_KV // TP)
    return dict(st, ws=ws, head=_cols(st["head"], s, V // TP),
                kpg=st["kpg"][:, :, kv].copy(), vpg=st["vpg"][:, :, kv].copy())


def _t(w):
    return tuple(torch.tensor(x) for x in w) if isinstance(w, tuple) \
        else torch.tensor(w)


def _j(w):
    return tuple(jnp.asarray(x) for x in w) if isinstance(w, tuple) \
        else jnp.asarray(w)


def _port_pack(st, nh, nh_kv):
    rows = N_PAGES * P
    flats = []
    for src in (st["kpg"], st["vpg"]):
        f = torch.zeros((rows + 1, nh_kv, HD))
        f[:rows] = torch.tensor(src).reshape(rows, nh_kv, HD)
        flats.append(f)
    cos = torch.zeros((MAX_LEN, HD // 2))
    sin = torch.zeros((MAX_LEN, HD // 2))
    cos[LENS] = torch.tensor(st["cos"])
    sin[LENS] = torch.tensor(st["sin"])
    return MegakernelPack(
        [{k: _t(v) for k, v in st["ws"].items()}], [flats[0]], [flats[1]],
        cos, sin, nh=nh, nh_kv=nh_kv, hd=HD, eps=EPS, page_size=P,
        norm=torch.tensor(st["norm"]), head=_t(st["head"]))


def _slots(st):
    s = st["tbl"][np.arange(B), LENS // P].astype(np.int64) * P + LENS % P
    return np.where(ACT > 0, s, N_PAGES * P)


def _jax_kw(nh, nh_kv):
    return dict(nh=nh, nh_kv=nh_kv, hd=HD, eps=EPS, interpret=True)


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("shard", [0, 1])
def test_segments_match_jax(quant, shard):
    """Tolerance 1e-5 (f32): each segment's plain version on one shard's
    pack against the JAX segment; local tokens and fold ids exact."""
    full = _state(quant)
    st = _shard(full, shard)
    nh, nh_kv = NH // TP, NH_KV // TP
    jmk = pack_decode_layer({k: _j(v) for k, v in st["ws"].items()})
    jkw = _jax_kw(nh, nh_kv)
    tbl, lens, act = (jnp.asarray(st["tbl"]), jnp.asarray(LENS, jnp.int32),
                      jnp.asarray(ACT))
    # qkv: attn over the local heads, the k/v rows written to the pools
    ja, jk, jv = jax_megakernel(
        jnp.asarray(st["h"]), jmk, jnp.asarray(st["kpg"]),
        jnp.asarray(st["vpg"]), tbl, lens, act, jnp.asarray(st["cos"]),
        jnp.asarray(st["sin"]), seg="qkv", **jkw)
    pack = _port_pack(st, nh, nh_kv)
    h = torch.tensor(st["h"])
    ta = decode_megakernel(h, pack, torch.tensor(st["tbl"]),
                           torch.tensor(LENS), torch.tensor(ACT), layer=0,
                           seg="qkv")
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=TOL, rtol=0)
    slots = _slots(st)
    np.testing.assert_allclose(pack.k_flat[0][slots].reshape(B, -1).numpy(),
                               np.asarray(jk), atol=TOL, rtol=0)
    np.testing.assert_allclose(pack.v_flat[0][slots].reshape(B, -1).numpy(),
                               np.asarray(jv), atol=TOL, rtol=0)
    assert torch.equal(h, torch.tensor(st["h"]))       # qkv leaves h
    # tail: O on a gathered attn row (the same input both sides)
    rng = np.random.RandomState(7 + shard)
    attn_in = rng.randn(B, NH * HD).astype(np.float32)
    jh, jact = jax_megakernel(jnp.asarray(st["h"]), jmk, seg="tail",
                              attn_in=jnp.asarray(attn_in), mlp_v=F // TP,
                              **jkw)
    th, tact = decode_megakernel(h, pack, layer=0, seg="tail",
                                 attn_in=torch.tensor(attn_in), mlp_v=F // TP)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=TOL, rtol=0)
    np.testing.assert_allclose(tact.numpy(), np.asarray(jact), atol=TOL,
                               rtol=0)
    # down with the local head: greedy, then the top-K fold
    act_in = rng.randn(B, F).astype(np.float32) * 0.5
    jhead = pack_lm_head(_j(st["head"]), jnp.asarray(st["norm"]))
    h0 = th.clone()
    jh2, jtok, jmax, jlog = jax_megakernel(
        jnp.asarray(h0.numpy()), jmk, seg="down",
        act_in=jnp.asarray(act_in), head=jhead, head_v=V // TP, **jkw)
    th2, ttok, tmax, tlog = decode_megakernel(
        h0.clone(), pack, layer=0, seg="down", act_in=torch.tensor(act_in),
        head=True)
    np.testing.assert_allclose(th2.numpy(), np.asarray(jh2), atol=TOL, rtol=0)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=TOL,
                               rtol=0)
    assert np.array_equal(ttok.numpy(), np.asarray(jtok))
    assert torch.equal(ttok, tlog.argmax(-1).to(torch.int32))
    _, jtk, _ = jax_megakernel(
        jnp.asarray(h0.numpy()), jmk, seg="down",
        act_in=jnp.asarray(act_in), head=jhead, head_v=V // TP, head_k=8,
        **jkw)
    _, topv, topi = decode_megakernel(
        h0.clone(), pack, layer=0, seg="down", act_in=torch.tensor(act_in),
        head=True, head_k=8)
    assert np.array_equal(topi.numpy(), np.asarray(jtk))
    rv, ri = top_k(tlog, 8)
    assert torch.equal(topv, rv.float()) and torch.equal(topi.long(), ri)


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
def test_assembled_shards_equal_full(quant):
    """The two shards' segments, gathered and combined as the engine does,
    against the tp = 1 seg "full" plain version: h, every pool row and the
    logits within 1e-5 (the column slices' products sum in the full
    product's order on the CPU, but the matmul library gives no such
    promise); the greedy token and the top-8 ids exact."""
    full = _state(quant, seed=1)
    ref = _port_pack(full, NH, NH_KV)
    args = (torch.tensor(full["tbl"]), torch.tensor(LENS), torch.tensor(ACT))
    h_ref, tok_ref, _, log_ref = decode_megakernel(
        torch.tensor(full["h"]), ref, *args, head=True)
    _, _, topi_ref = decode_megakernel(
        torch.tensor(full["h"]), _port_pack(full, NH, NH_KV), *args,
        head=True, head_k=8)
    tpc = TPContext(TP, devices=["cpu"] * TP)
    packs = [_port_pack(_shard(full, s), NH // TP, NH_KV // TP)
             for s in range(TP)]
    hs = [torch.tensor(full["h"]) for _ in range(TP)]
    attn = tpc.gather_cols([decode_megakernel(h, pk, *args, layer=0,
                                              seg="qkv")
                            for h, pk in zip(hs, packs)])
    acts = tpc.gather_cols([decode_megakernel(h, pk, layer=0, seg="tail",
                                              attn_in=a)[1]
                            for h, pk, a in zip(hs, packs, attn)])
    hs0 = [h.clone() for h in hs]
    outs = [decode_megakernel(h, pk, layer=0, seg="down", act_in=a,
                              head=True)
            for h, pk, a in zip(hs, packs, acts)]
    for h in hs:
        np.testing.assert_allclose(h.numpy(), h_ref.numpy(), atol=TOL, rtol=0)
    logits = tpc.gather_cols([o[3] for o in outs])[0]
    np.testing.assert_allclose(logits.numpy(), log_ref.numpy(), atol=TOL,
                               rtol=0)
    tok = tpc.argmax_of_local_max([o[2] for o in outs],
                                  [o[1] for o in outs], V // TP)
    assert torch.equal(tok, tok_ref.long())
    folds = [decode_megakernel(h, pk, layer=0, seg="down", act_in=a,
                               head=True, head_k=8)
             for h, pk, a in zip(hs0, packs, acts)]
    _, topi = tpc.topk_of_local_topk([f[1] for f in folds],
                                     [f[2] for f in folds], V // TP, 8)
    assert torch.equal(topi, topi_ref.long())
    for s, pk in enumerate(packs):
        for which in ("k_flat", "v_flat"):
            local = getattr(pk, which)[0]
            whole = getattr(ref, which)[0][:, s * NH_KV // TP:
                                           (s + 1) * NH_KV // TP]
            np.testing.assert_allclose(local.numpy(), whole.numpy(),
                                       atol=TOL, rtol=0)


# -- engine level ----------------------------------------------------------
ENGINE_KW = dict(max_len=48, page_size=8, max_batch=2, quant="int8",
                 slot_buckets=(2,))
NEW_TOKENS = 10
_MODELS = {}


def _models(vocab):
    """(JAX, port) LLaMA of tests/test_megakernel_v2.py's `tiny` geometry
    (test_sampling_v2.py's at vocab 50), seed 7, identical weights."""
    if vocab not in _MODELS:
        kw = dict(vocab_size=vocab, hidden_size=32, intermediate_size=48,
                  num_hidden_layers=1, num_attention_heads=4,
                  num_key_value_heads=2, max_position_embeddings=64)
        paddle.seed(7)
        jm = JaxLlama(JaxConfig(**kw))
        tm = LlamaForCausalLM(LlamaConfig(**kw), device="cpu")
        load_numpy_params(tm, {n: np.asarray(p.data)
                               for n, p in jm.named_parameters()})
        _MODELS[vocab] = (jm, tm)
    return _MODELS[vocab]


def _prompts(vocab):
    rng = np.random.RandomState(3)
    return [rng.randint(0, vocab, n).astype(np.int64) for n in (5, 9, 12)]


@pytest.fixture(scope="module")
def greedy_refs():
    """The JAX engine's and the port's op-chain greedy streams (tp = 1)."""
    jm, tm = _models(64)
    prompts = _prompts(64)
    jref = JaxEngine(jm, megakernel=False, **ENGINE_KW).generate_many(
        prompts, max_new_tokens=NEW_TOKENS)
    tref = ContinuousBatchingEngine(tm, megakernel=False, device="cpu",
                                    **ENGINE_KW).generate_many(
        prompts, max_new_tokens=NEW_TOKENS)
    return [np.asarray(o) for o in jref], tref


@pytest.mark.parametrize("mode,K,spec", [("multi", 8, None),
                                         ("layer", 1, None),
                                         ("layer", 1, 4)],
                         ids=["multi-K8", "layer-K1", "layer-spec4"])
def test_tp2_megakernel_ids_equal(greedy_refs, mode, K, spec):
    """Exact: tp = 2 through the segments equals the op chain (tp = 1) and
    the JAX engine; one pack per shard over the shard's own pools."""
    _, tm = _models(64)
    eng = ContinuousBatchingEngine(tm, tp=2, megakernel=mode, decode_block=K,
                                   speculate=spec, device="cpu", **ENGINE_KW)
    assert eng.health()["megakernel_whole_step"] == (mode == "multi")
    assert all(p.k_flat[0] is f[0] for p, f in zip(eng._mk_packs, eng._kf))
    outs = eng.generate_many(_prompts(64), max_new_tokens=NEW_TOKENS)
    jref, tref = greedy_refs
    for i, (a, b, c) in enumerate(zip(jref, tref, outs)):
        assert np.array_equal(a, c) and np.array_equal(b, c), \
            f"{mode} K={K} spec={spec} request {i}"
    if spec:
        assert eng.spec_passes > 0


def test_tp2_sampled_fold_equals_canonical_stream():
    """Exact: the sampled fold at tp = 2 ("multi", K 8: each shard's local
    top-K, combined) equals the canonical sampled stream (K 1, op chain,
    tp = 1) of the port and of the JAX engine."""
    jm, tm = _models(50)
    prompts = _prompts(50)

    def sp(cls, i):
        return cls(do_sample=True, temperature=0.8, top_k=6, top_p=0.95,
                   seed=100 + i)

    def run(engine, **kw):
        uids = [engine.add_request(p, max_new_tokens=8, sampling=sp(
            JaxSP if isinstance(engine, JaxEngine) else SamplingParams, i))
            for i, p in enumerate(prompts)]
        engine.drain()
        return [np.asarray(engine.result(u)) for u in uids]

    jref = run(JaxEngine(jm, megakernel=False, decode_block=1, **ENGINE_KW))
    tref = run(ContinuousBatchingEngine(tm, megakernel=False, device="cpu",
                                        **ENGINE_KW))
    eng = ContinuousBatchingEngine(tm, tp=2, megakernel="multi",
                                   decode_block=8, device="cpu", **ENGINE_KW)
    outs = run(eng)
    assert eng._mk_head and eng._mk_packs[0].V == 25
    for i, (a, b, c) in enumerate(zip(jref, tref, outs)):
        assert np.array_equal(a, c) and np.array_equal(b, c), f"request {i}"
