"""The decode megakernel: paddle_tpu_torch's `decode_megakernel` and the
ContinuousBatchingEngine megakernel modes against the JAX package.

Kernel level (tolerance): the port's plain `decode_megakernel` (what a CPU
tensor runs) against the JAX `decode_megakernel(..., interpret=True)` on
the reference tests' geometry (tests/test_megakernel_v2.py `kstate`: GQA
4/2 heads, d 8, hidden 32, ffn 48, vocab 50, page 8), dense and int8 (the
same int8 values and scales on both sides), one layer and a 2-layer whole
step with the head: h, the k/v rows and the logits within 1e-5 in f32 (the
two sum in other orders), the greedy token exactly equal. The first-max-
wins tie rule is pinned on a constructed tie (exact: identical columns give
identical logits). The top-K fold (head_k = 8): ids exactly equal to the
JAX kernel's, values within 1e-5 of them, and both bit for bit a stable
top-K of the port's own logits; constructed ties come out id-ascending;
no logits buffer is part of a fold launch's outputs.

Engine level (exact): greedy ids of the port's engine with megakernel
"layer" and "multi" at decode_block 1 and 8 equal the JAX engine's with
megakernel=False and the port's own op chain, on the reference tests'
`tiny` model and ENGINE_KW (int8, GQA); the logits of one decode step are
equal bit for bit with the megakernel on and off (the plain version runs
the op chain's functions in the op chain's order). Knob resolution,
health(), the typed refusals and the pointer table surviving `_reset_kv`
are pinned too. Weights cross from JAX by name (`load_numpy_params`);
inputs are numpy draws from fixed seeds.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.inference.scheduler import \
    ContinuousBatchingEngine as JaxEngine
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.ops.pallas.decode_megakernel import (
    decode_megakernel as jax_megakernel, pack_decode_layer, pack_lm_head,
    stack_packed)
from paddle_tpu_torch.convert import load_numpy_params
from paddle_tpu_torch.inference.scheduler import ContinuousBatchingEngine
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops.pallas.decode_megakernel import (
    P_KP, P_VP, PTRS, MegakernelPack, decode_megakernel,
    megakernel_supported, megakernel_weight_bytes)
from paddle_tpu_torch.ops.pallas.quantized_matmul import quantize_weights
from paddle_tpu_torch.ops.pallas.rms_norm import rms_rows

torch.set_num_threads(1)

TOL = 1e-5
B, NH, NH_KV, HD, H, F, V, P, MP, N_PAGES = 2, 4, 2, 8, 32, 48, 50, 8, 4, 8
LENS = np.array([5, 11], np.int64)
EPS = 1e-5
MAX_LEN = MP * P
_PROJ = (("wq", NH * HD), ("wk", NH_KV * HD), ("wv", NH_KV * HD),
         ("wo", H), ("wg", F), ("wu", F), ("wd", H))
_KIN = {"wo": NH * HD, "wd": F}


def _layer_np(rng):
    ws = {name: (rng.randn(_KIN.get(name, H), n) * 0.1).astype(np.float32)
          for name, n in _PROJ}
    ws["ln1"] = (rng.rand(H) + 0.5).astype(np.float32)
    ws["ln2"] = (rng.rand(H) + 0.5).astype(np.float32)
    return ws


def _quant(w):
    wq, sc = quantize_weights(torch.tensor(w))
    return wq.numpy(), sc.numpy()


def _kstate(n_layers, quant, seed=0):
    """Numpy weights, pools and inputs in the reference test's geometry;
    projections as (int8, scales) pairs when quant."""
    rng = np.random.RandomState(seed)
    layers = [_layer_np(rng) for _ in range(n_layers)]
    head = (rng.randn(H, V) * 0.1).astype(np.float32)
    norm = (rng.rand(H) + 0.5).astype(np.float32)
    if quant:
        for ws in layers:
            for name, _ in _PROJ:
                ws[name] = _quant(ws[name])
        head = _quant(head)
    kpg = rng.randn(n_layers, N_PAGES, P, NH_KV, HD).astype(np.float32)
    vpg = rng.randn(n_layers, N_PAGES, P, NH_KV, HD).astype(np.float32)
    tbl = rng.choice(N_PAGES, (B, MP), replace=False).astype(np.int32)
    h = rng.randn(B, H).astype(np.float32)
    cos = rng.randn(B, HD // 2).astype(np.float32)
    sin = rng.randn(B, HD // 2).astype(np.float32)
    return dict(layers=layers, head=head, norm=norm, kpg=kpg, vpg=vpg,
                tbl=tbl, h=h, cos=cos, sin=sin)


def _jax_w(w):
    if isinstance(w, tuple):
        return (jnp.asarray(w[0]), jnp.asarray(w[1]))
    return jnp.asarray(w)


def _run_jax(st, act, head, head_k=None):
    L = len(st["layers"])
    packs = [pack_decode_layer({k: _jax_w(v) for k, v in ws.items()})
             for ws in st["layers"]]
    mk = packs[0] if L == 1 else stack_packed(packs)
    kpg = st["kpg"][0] if L == 1 else st["kpg"]
    vpg = st["vpg"][0] if L == 1 else st["vpg"]
    kw = dict(nh=NH, nh_kv=NH_KV, hd=HD, eps=EPS, interpret=True)
    if head:
        kw.update(head=pack_lm_head(_jax_w(st["head"]),
                                    jnp.asarray(st["norm"])), head_v=V,
                  head_k=head_k)
    out = jax_megakernel(jnp.asarray(st["h"]), mk, jnp.asarray(kpg),
                         jnp.asarray(vpg), jnp.asarray(st["tbl"]),
                         jnp.asarray(LENS.astype(np.int32)),
                         jnp.asarray(act.astype(np.int32)),
                         jnp.asarray(st["cos"]), jnp.asarray(st["sin"]), **kw)
    return [np.asarray(o) for o in out]


def _torch_w(w):
    if isinstance(w, tuple):
        return (torch.tensor(w[0]), torch.tensor(w[1]))
    return torch.tensor(w)


def _port_pack(st, head):
    """The port's pack over the same weights; flat pools with the scratch
    row; rope tables whose rows at each slot's position hold its rows."""
    L = len(st["layers"])
    layers = [{k: _torch_w(v) for k, v in ws.items()} for ws in st["layers"]]
    rows = N_PAGES * P
    k_flat, v_flat = [], []
    for li in range(L):
        for src, dst in ((st["kpg"], k_flat), (st["vpg"], v_flat)):
            f = torch.zeros((rows + 1, NH_KV, HD))
            f[:rows] = torch.tensor(src[li]).reshape(rows, NH_KV, HD)
            dst.append(f)
    cos = torch.zeros((MAX_LEN, HD // 2))
    sin = torch.zeros((MAX_LEN, HD // 2))
    cos[LENS] = torch.tensor(st["cos"])
    sin[LENS] = torch.tensor(st["sin"])
    return MegakernelPack(
        layers, k_flat, v_flat, cos, sin, nh=NH, nh_kv=NH_KV, hd=HD, eps=EPS,
        page_size=P, norm=torch.tensor(st["norm"]) if head else None,
        head=_torch_w(st["head"]) if head else None)


def _slots(st, act):
    pos = LENS
    s = st["tbl"][np.arange(B), pos // P].astype(np.int64) * P + pos % P
    return np.where(act > 0, s, N_PAGES * P)


def _run_port(st, act, head, layer=None, head_k=1):
    pack = _port_pack(st, head)
    h = torch.tensor(st["h"])
    args = (h, pack, torch.tensor(st["tbl"]), torch.tensor(LENS),
            torch.tensor(act))
    out = decode_megakernel(*args, head=True, head_k=head_k) if head else \
        decode_megakernel(*args, layer=layer)
    return pack, out


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("act", [[1, 1], [0, 1]], ids=["both", "inactive0"])
def test_one_layer_matches_jax(quant, act):
    """Tolerance 1e-5 (f32, other summation orders): h and the k/v rows of
    one layer; the written pool rows hold the new k/v, every other pool row
    is untouched (exact)."""
    act = np.asarray(act)
    st = _kstate(1, quant)
    ho, kn, vn = _run_jax(st, act, head=False)
    pack, h = _run_port(st, act, head=False)
    np.testing.assert_allclose(h.numpy(), ho, atol=TOL, rtol=0)
    slots = _slots(st, act)
    kf, vf = pack.k_flat[0], pack.v_flat[0]
    np.testing.assert_allclose(kf[slots].reshape(B, -1).numpy(), kn,
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(vf[slots].reshape(B, -1).numpy(), vn,
                               atol=TOL, rtol=0)
    untouched = np.setdiff1d(np.arange(N_PAGES * P), slots)
    orig_k = st["kpg"][0].reshape(-1, NH_KV, HD)
    assert np.array_equal(kf[untouched].numpy(), orig_k[untouched])


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
def test_whole_step_matches_jax(quant):
    """Two layers and the head in one call: h, every layer's k/v rows and
    the logits within 1e-5 (f32); the greedy token and its logit exact
    against the port's own logits, the token equal to JAX's."""
    act = np.array([1, 1])
    st = _kstate(2, quant, seed=1)
    ho, kn, vn, tok_j, maxv_j, logits_j = _run_jax(st, act, head=True)
    pack, (h, tok, maxv, logits) = _run_port(st, act, head=True)
    np.testing.assert_allclose(h.numpy(), ho, atol=TOL, rtol=0)
    np.testing.assert_allclose(logits.numpy(), logits_j, atol=TOL, rtol=0)
    slots = _slots(st, act)
    for li in range(2):
        np.testing.assert_allclose(
            pack.k_flat[li][slots].reshape(B, -1).numpy(), kn[li],
            atol=TOL, rtol=0)
        np.testing.assert_allclose(
            pack.v_flat[li][slots].reshape(B, -1).numpy(), vn[li],
            atol=TOL, rtol=0)
    assert tok.dtype == torch.int32
    np.testing.assert_array_equal(tok.numpy(), tok_j)
    np.testing.assert_array_equal(tok.numpy(), logits.argmax(-1).numpy())
    np.testing.assert_array_equal(maxv.numpy(), logits.max(-1).values.numpy())
    np.testing.assert_allclose(maxv.numpy(), maxv_j, atol=TOL, rtol=0)


def test_head_argmax_tie_rule():
    """Exact: three identical head columns (3, 9 in one 32-column slab, 40
    in the next), made the largest logit of every row; the smallest id
    wins, as jnp.argmax and the JAX kernel's running argmax keep it."""
    act = np.array([1, 1])
    st = _kstate(1, quant=False, seed=2)
    _, (h, _, _, _) = _run_port(st, act, head=True)
    xn = rms_rows(h, torch.tensor(st["norm"]), EPS).numpy()
    st = _kstate(1, quant=False, seed=2)     # the same weights and inputs
    st["head"] *= 0.01
    for c in (3, 9, 40):     # x_i . (x_0 + x_1) ~ |x|^2 beats every column
        st["head"][:, c] = xn[0] + xn[1]
    _, (_, tok, maxv, logits) = _run_port(st, act, head=True)
    assert torch.equal(logits[:, 3], logits[:, 9])
    assert torch.equal(logits[:, 3], logits[:, 40])
    assert (logits.argmax(-1) == 3).all(), "the tie is not the row maximum"
    assert tok.tolist() == [3, 3]
    tok_j = _run_jax(st, act, head=True)[3]
    assert tok_j.tolist() == [3, 3]


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
def test_topk_fold_matches_jax(quant):
    """head_k = 8 on a 2-layer whole step. Exact: the ids equal the JAX
    kernel's (head_k=8, interpret mode); (topv, topi) equal bit for bit a
    stable top-8 of the port's own head_k=1 logits, column 0 its greedy
    pair. Tolerance 1e-5 (f32, other summation orders): the values against
    JAX's."""
    act = np.array([1, 1])
    st = _kstate(2, quant, seed=1)
    _, _, _, ids_j, vals_j = _run_jax(st, act, head=True, head_k=8)
    _, (h, topv, topi) = _run_port(st, act, head=True, head_k=8)
    _, (h1, tok, maxv, logits) = _run_port(st, act, head=True)
    assert topv.dtype == torch.float32 and topi.dtype == torch.int32
    assert tuple(topv.shape) == (B, 8) and tuple(topi.shape) == (B, 8)
    np.testing.assert_array_equal(topi.numpy(), ids_j)
    np.testing.assert_allclose(topv.numpy(), vals_j, atol=TOL, rtol=0)
    assert torch.equal(h, h1)
    sv, si = torch.sort(logits, dim=-1, descending=True, stable=True)
    assert torch.equal(topv, sv[:, :8].float())
    assert torch.equal(topi, si[:, :8].int())
    assert torch.equal(topi[:, 0], tok) and torch.equal(topv[:, 0], maxv)


def test_topk_fold_ties_and_no_logits_buffer():
    """Exact: five identical head columns (3, 9 in one slab, 33, 40 and 49
    in the next) made each row's largest logit come out id-ascending at
    the front of the top-8, as in the JAX kernel; a fold launch's outputs
    hold only topv and topi (no [R, V] logits), and head_k outside
    [1, min(128, V)] raises."""
    from paddle_tpu_torch.ops.pallas.decode_megakernel import head_outputs
    act = np.array([1, 1])
    st = _kstate(1, quant=False, seed=2)
    _, (h, _, _, _) = _run_port(st, act, head=True)
    xn = rms_rows(h, torch.tensor(st["norm"]), EPS).numpy()
    st = _kstate(1, quant=False, seed=2)
    st["head"] *= 0.01
    ties = (3, 9, 33, 40, 49)
    for c in ties:
        st["head"][:, c] = xn[0] + xn[1]
    _, (_, topv, topi) = _run_port(st, act, head=True, head_k=8)
    assert topi[:, :5].tolist() == [list(ties)] * 2
    assert (topv[:, :5] == topv[:, :1]).all()
    ids_j = _run_jax(st, act, head=True, head_k=8)[3]
    np.testing.assert_array_equal(topi.numpy(), ids_j)
    outs = head_outputs(2, V, 8, torch.float32, "cpu")
    assert sorted(outs) == ["topi", "topv"]
    assert sorted(head_outputs(2, V, 1, torch.float32, "cpu")) == \
        ["logits", "maxv", "tok"]
    for bad in (0, 129, V + 1):
        with pytest.raises(ValueError, match="head_k"):
            _run_port(st, act, head=True, head_k=bad)


# ---------------------------------------------------------------- engine
ENGINE_KW = dict(max_len=48, page_size=8, max_batch=2, quant="int8",
                 slot_buckets=(2,))
NEW_TOKENS = 10
_MODELS = {}


def _tiny():
    """(JAX model, port model) of tests/test_megakernel_v2.py `tiny`: the
    reference's seed-7 weights, carried across by name."""
    if not _MODELS:
        cfg = dict(vocab_size=64, hidden_size=32, intermediate_size=48,
                   num_hidden_layers=1, num_attention_heads=4,
                   num_key_value_heads=2, max_position_embeddings=64)
        paddle.seed(7)
        jm = JaxLlama(JaxConfig(**cfg))
        tm = LlamaForCausalLM(LlamaConfig(**cfg), device="cpu")
        load_numpy_params(tm, {n: np.asarray(p.data)
                               for n, p in jm.named_parameters()})
        _MODELS["pair"] = (jm, tm)
    return _MODELS["pair"]


def _prompts():
    rng = np.random.RandomState(3)
    return [rng.randint(0, 64, n).astype(np.int64) for n in (5, 9, 12)]


@pytest.fixture(scope="module")
def ref_outputs():
    """The JAX engine with the megakernel off, and the port's op chain."""
    jm, tm = _tiny()
    ref = JaxEngine(jm, megakernel=False, **ENGINE_KW).generate_many(
        _prompts(), max_new_tokens=NEW_TOKENS)
    port = ContinuousBatchingEngine(tm, megakernel=False, device="cpu",
                                    **ENGINE_KW).generate_many(
        _prompts(), max_new_tokens=NEW_TOKENS)
    for a, b in zip(ref, port):
        np.testing.assert_array_equal(b, a)
    return ref


@pytest.mark.parametrize("K", [1, 8])
@pytest.mark.parametrize("mode", ["layer", "multi"])
def test_engine_ids_equal_jax(ref_outputs, mode, K):
    """Exact: greedy ids with the megakernel on equal the JAX engine's
    (megakernel off) and the port's op chain's."""
    _, tm = _tiny()
    eng = ContinuousBatchingEngine(tm, megakernel=mode, decode_block=K,
                                   device="cpu", **ENGINE_KW)
    outs = eng.generate_many(_prompts(), max_new_tokens=NEW_TOKENS)
    for i, (a, b) in enumerate(zip(ref_outputs, outs)):
        np.testing.assert_array_equal(b, a, err_msg=f"request {i}")
    h = eng.health()
    assert h["megakernel"] == mode
    assert h["megakernel_whole_step"] is (mode == "multi")
    assert h["pages_free"] + h["prefix_pages"] == h["pages_total"]
    assert (h["fused_blocks"] > 0) == (K > 1)


def _one_step(eng):
    """Admit two requests, run to a decode step, and return its inputs."""
    for p in _prompts()[:2]:
        eng.add_request(p, 6)
    while any(r is None or r.state != "decode" for r in eng._slots):
        eng.step()
    return (torch.tensor(eng._tok_np[:2]), torch.tensor(eng._tables_np[:2]),
            torch.tensor(eng._lens_np[:2]), torch.tensor([True, False]))


@pytest.mark.parametrize("quant", [None, "int8"])
def test_logits_and_pools_bitwise_on_off(quant):
    """Exact: one decode step's logits, greedy tokens and every pool byte
    with the megakernel on ("layer", "multi") equal the op chain's (one
    slot inactive)."""
    _, tm = _tiny()
    kw = dict(ENGINE_KW, quant=quant)
    got = {}
    for mode in (False, "layer", "multi"):
        eng = ContinuousBatchingEngine(tm, megakernel=mode, device="cpu",
                                       **kw)
        inputs = _one_step(eng)
        with torch.no_grad():
            logits, greedy = eng._decode_math(*inputs)
        got[mode] = (logits, greedy, eng._k_flat[0][:-1].clone(),
                     eng._v_flat[0][:-1].clone())
    for mode in ("layer", "multi"):
        for a, b in zip(got[False], got[mode]):
            assert torch.equal(a, b), mode


def test_knob_resolution_health_and_refusals():
    """Exact (no numerics): the knob's values, the health() keys, the typed
    refusals of features the port does not have, the kernel's geometry
    gate."""
    _, tm = _tiny()
    auto = ContinuousBatchingEngine(tm, device="cpu", **ENGINE_KW)
    assert auto.megakernel is False and auto._mk_pack is None
    assert auto.health()["megakernel"] == "off"
    assert auto.health()["megakernel_whole_step"] is False
    for val, mode in ((True, "layer"), ("layer", "layer"), ("multi", "multi"),
                      (False, False)):
        eng = ContinuousBatchingEngine(tm, device="cpu", megakernel=val,
                                       **ENGINE_KW)
        assert eng.megakernel == mode
        assert (eng._mk_pack is not None) == bool(mode)
    with pytest.raises(ValueError, match="megakernel must be"):
        ContinuousBatchingEngine(tm, device="cpu", megakernel="whole",
                                 **ENGINE_KW)
    # the features a forced megakernel would compose with: sampling and
    # speculation are ported (the engine-level sampling knob is
    # deprecated), adapters are not
    eng = ContinuousBatchingEngine(tm, device="cpu", megakernel="multi",
                                   speculate=4, **ENGINE_KW)
    assert eng.megakernel == "multi" and eng.health()["speculate"] == 4
    with pytest.raises(NotImplementedError, match="A7.2"):
        ContinuousBatchingEngine(tm, device="cpu", megakernel="multi",
                                 adapters=True, **ENGINE_KW)
    with pytest.warns(DeprecationWarning):
        eng = ContinuousBatchingEngine(tm, device="cpu", megakernel="multi",
                                       do_sample=True, **ENGINE_KW)
    assert eng.megakernel == "multi" and eng.sample_k == 8
    # tensor parallelism composes in exact mode (the per-shard segments);
    # psum mode is refused, as in the reference
    eng = ContinuousBatchingEngine(tm, device="cpu", megakernel="multi",
                                   tp=2, **ENGINE_KW)
    assert eng.health()["megakernel"] == "multi" and len(eng._mk_packs) == 2
    with pytest.raises(ValueError, match="exact"):
        ContinuousBatchingEngine(tm, device="cpu", megakernel="multi", tp=2,
                                 tp_mode="psum", **ENGINE_KW)
    # the kernel's own geometry gate (the CPU plain version has none)
    assert megakernel_supported(32, 32, 128, 4096, 11008)
    assert megakernel_supported(32, 8, 128, 4096, 14336)
    assert not megakernel_supported(4, 2, 8, 32, 48)      # d % 16
    assert not megakernel_supported(32, 1, 128, 4096, 11008)  # rep * d
    assert not megakernel_supported(32, 32, 128, 2048, 11008)  # nh d != H
    # a shard's local dims: 16 of 32 heads, half the ffn, at tp 2
    assert megakernel_supported(16, 16, 128, 4096, 5504, tp=2)
    assert not megakernel_supported(16, 16, 128, 4096, 5504)


def test_pointer_table_survives_reset_kv():
    """Exact: the table holds the pools' addresses; a pool rebuild (an
    engine failure, _reset_kv) builds a new one, and the engine serves the
    same ids as before on the new pools."""
    _, tm = _tiny()
    eng = ContinuousBatchingEngine(tm, megakernel="multi", device="cpu",
                                   **ENGINE_KW)
    pack = eng._mk_pack
    L = tm.config.num_hidden_layers
    assert tuple(pack.ptrs.shape) == (L + 1, PTRS)
    for li in range(L):
        assert int(pack.ptrs[li, P_KP]) == eng._k_flat[li].data_ptr()
        assert int(pack.ptrs[li, P_VP]) == eng._v_flat[li].data_ptr()
        assert int(pack.ptrs[li, 2]) == eng.weights["layers"][li]["wq"][0] \
            .data_ptr()
    assert int(pack.ptrs[L, 1]) == eng.weights["head"][0].data_ptr()
    first = eng.generate_many(_prompts(), max_new_tokens=NEW_TOKENS)
    eng.add_request(_prompts()[0], 4)
    eng.step()
    eng._abort_in_flight()          # what an exception inside a step does
    assert eng._mk_pack is not pack
    for li in range(L):
        assert int(eng._mk_pack.ptrs[li, P_KP]) == \
            eng._k_flat[li].data_ptr()
        assert eng._mk_pack.k_flat[li] is eng._k_flat[li]
    again = eng.generate_many(_prompts(), max_new_tokens=NEW_TOKENS)
    for a, b in zip(first, again):
        np.testing.assert_array_equal(b, a)
    # bytes the step streams: 7 projections (int8 + f32 scales) and two
    # norms per layer, plus the final norm and the int8 lm_head
    per_layer = sum(k * n + 4 * n for k, n in (
        (H, NH * HD), (H, NH_KV * HD), (H, NH_KV * HD), (NH * HD, H),
        (H, F), (H, F), (F, H))) + 2 * 4 * H
    assert megakernel_weight_bytes(eng._mk_pack) == \
        L * per_layer + 4 * H + H * 64 + 4 * 64


def test_serve_llama_scheduler_megakernel_demo(capsys):
    """Exact: `serve_llama --scheduler --megakernel multi` on the CPU
    serves the op chain's three requests with the same tails, every page
    back."""
    from paddle_tpu_torch import serve_llama
    tails = {}
    for mk in ("off", "multi"):
        serve_llama.main(["--scheduler", "--decode-block", "4", "--device",
                          "cpu", "--max_new_tokens", "6", "--megakernel", mk])
        out = capsys.readouterr().out
        assert f"megakernel {mk}" in out
        assert "3 done / 0 failed, 7/8 pages free, 1 held" in out
        tails[mk] = [ln for ln in out.splitlines() if "tail" in ln]
    assert tails["off"] == tails["multi"] and len(tails["off"]) == 3
