"""Single-device training step: paddle_tpu_torch's `SpmdTrainer` against
the JAX `SpmdTrainer` on a 1x1x1x1 CPU mesh, and its options inside the
port.

Both trainers start from one state (the JAX trainer's, carried over by
`convert.trainer_state_from_numpy`) and take 5 AdamW steps on one seeded
batch of `LlamaConfig.tiny()` with some ignored labels, recompute on with
policy save_attn on both sides. Tolerances, with their reasons:
- f32: losses within rtol 1e-5 and params within atol 1e-4 (the same f32
  math in another summation order, amplified a little by AdamW's
  m / sqrt(v) on near-zero gradients; measured ~1e-7 and ~1e-5);
- bf16 params and moments: losses within rtol 1e-3 and params within
  atol 1.6e-2, two bf16 ulps at magnitude 1 (products round to bf16 at
  other places in the two frameworks; measured ~1e-4 and ~4e-3).
Inside the port: recompute save_attn, full and off give identical bits;
the fused and unfused heads, and grad_accum 2 and 1, agree within f32
summation order: losses within rtol 1e-5, params within atol 1e-4, a
tenth of one step's lr (AdamW's m / sqrt(v) turns a rounding-level change
of a near-zero gradient into a visible change of its update; measured
2e-5 on one element of 8192).
"""
import numpy as np
import pytest
import torch
import jax

import paddle_tpu as paddle
from paddle_tpu.distributed.mesh import build_mesh, set_global_mesh
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.train_step import SpmdTrainer as JaxTrainer
from paddle_tpu_torch.convert import trainer_state_from_numpy
from paddle_tpu_torch.models import SpmdTrainer
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops.pallas import flash_attention as tfa
from paddle_tpu_torch.ops.pallas import rms_norm as trms

torch.set_num_threads(1)

N_STEPS = 5


def _batch(vocab, b=4, s=32, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (b, s)).astype(np.int64)
    labels = np.roll(ids, -1, axis=1)
    labels[0, :5] = -100
    labels[2, -3:] = -100
    return ids, labels


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("dtype,tol", [
    ("float32", dict(loss_rtol=1e-5, param_atol=1e-4)),
    ("bfloat16", dict(loss_rtol=1e-3, param_atol=1.6e-2)),
], ids=["f32", "bf16"])
def test_matches_jax_trainer(dtype, tol):
    mesh = build_mesh({"data": 1, "pipe": 1, "sharding": 1, "model": 1})
    set_global_mesh(mesh)
    paddle.seed(3)
    kw = dict(lr=1e-3, param_dtype=dtype, moment_dtype=dtype, recompute=True,
              recompute_policy="save_attn")
    jt = JaxTrainer(JaxLlama(JaxConfig.tiny()), mesh, **kw)
    js = jt.init_state()
    tt = SpmdTrainer(LlamaForCausalLM(LlamaConfig.tiny(), device="cpu"), **kw)
    ts = trainer_state_from_numpy(tt, _np(jt.gather_params(js)),
                                  _np(js["opt"]), int(js["step"]))
    ids, labels = _batch(128)
    j_loss, t_loss = [], []
    for _ in range(N_STEPS):
        js, lj = jt.step(js, ids, labels)
        ts, lt = tt.step(ts, ids, labels)
        j_loss.append(float(lj))
        t_loss.append(float(lt))
    assert t_loss[-1] < t_loss[0]
    np.testing.assert_allclose(t_loss, j_loss, rtol=tol["loss_rtol"])
    assert ts["step"] == int(js["step"]) == N_STEPS
    jp, tp = _np(jt.gather_params(js)), tt.gather_params(ts)
    for a, b in zip(jp["outer"] + jp["stacked"], tp["outer"] + tp["stacked"]):
        assert b.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(b.float().numpy(), a.astype(np.float32),
                                   rtol=0, atol=tol["param_atol"])


def _run(seed=0, n_steps=3, layers=2, **kw):
    cfg = LlamaConfig.tiny(num_hidden_layers=layers)
    tr = SpmdTrainer(LlamaForCausalLM(cfg, device="cpu", seed=seed), **kw)
    st = tr.init_state()
    ids, labels = _batch(cfg.vocab_size)
    losses = []
    for _ in range(n_steps):
        st, loss = tr.step(st, ids, labels)
        losses.append(loss)
    return torch.stack(losses), st["params"]


def test_recompute_policies_are_bit_identical():
    ref_l, ref_p = _run(recompute=False)
    for policy in ("save_attn", "full"):
        loss, params = _run(recompute=True, recompute_policy=policy)
        assert torch.equal(loss, ref_l), policy
        assert all(torch.equal(params[n], ref_p[n]) for n in ref_p), policy


@pytest.mark.parametrize("other", [dict(fuse_head_ce=False),
                                   dict(grad_accum=2)],
                         ids=["unfused_tail", "grad_accum2"])
def test_variant_matches_default(other):
    ref_l, ref_p = _run(ce_chunk=48)
    loss, params = _run(ce_chunk=48, **other)
    torch.testing.assert_close(loss, ref_l, rtol=1e-5, atol=0)
    for n in ref_p:
        torch.testing.assert_close(params[n], ref_p[n], rtol=0, atol=1e-4)


@pytest.mark.parametrize("policy,flash_per_layer", [
    (None, 1), ("save_attn", 1), ("full", 2)])
def test_recompute_runs_each_forward_as_the_policy_says(monkeypatch, policy,
                                                        flash_per_layer):
    """Per step on L layers: the attention forward runs once per layer
    under save_attn (the recompute replays its o and lse) and twice under
    full; the norm forward runs 2 L + 1 times, plus 2 L in any recompute."""
    calls = {"flash": 0, "rms": 0}

    def counting(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tfa, "flash_attention_fwd",
                        counting("flash", tfa.flash_attention_fwd))
    monkeypatch.setattr(trms, "rms_norm_fwd", counting("rms", trms.rms_norm_fwd))
    L = 3
    kw = dict(recompute=policy is not None,
              recompute_policy=policy or "save_attn")
    _run(n_steps=2, layers=L, **kw)
    assert calls["flash"] == 2 * flash_per_layer * L
    assert calls["rms"] == 2 * ((2 * L + 1) + (2 * L if policy else 0))


def test_state_layout_and_sync_to_model():
    cfg = LlamaConfig.tiny(num_hidden_layers=2)
    model = LlamaForCausalLM(cfg, device="cpu", seed=1)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    tr = SpmdTrainer(model, param_dtype="bfloat16", moment_dtype="bfloat16")
    st = tr.init_state()
    assert all(p.dtype == torch.bfloat16 for p in st["params"].values())
    assert all(m["v"].dtype == torch.bfloat16 for m in st["opt"].values())
    ids, labels = _batch(cfg.vocab_size)
    st, loss = tr.step(st, ids, labels)
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    # the model keeps its own f32 weights until sync_to_model
    assert all(torch.equal(p, before[n]) for n, p in model.named_parameters())
    g = tr.gather_params(st)
    assert [tuple(a.shape) for a in g["outer"]] == [(128, 64), (64,), (64, 128)]
    assert tuple(g["stacked"][0].shape) == (2, 64)          # input_layernorm
    tr.sync_to_model(st)
    for n, p in model.named_parameters():
        assert torch.equal(p, st["params"][n])


@pytest.mark.parametrize("kw", [
    dict(mesh={"data": 2, "model": 1}), dict(pp_schedule="1f1b"),
    dict(grad_compress="int8"), dict(plan={"grad_compress": "int8"})],
    ids=["mesh", "pipeline", "grad_compress", "plan"])
def test_unported_options_raise(kw):
    """`plan=` is taken (cost_model.Plan or its JSON dict); a plan whose
    knobs need the training and distributed stack raises as they do."""
    model = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1),
                             device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        SpmdTrainer(model, **kw)


def test_sequence_parallel_raises():
    model = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1,
                                              sequence_parallel=True),
                             device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        SpmdTrainer(model)


# ---------------------------------------------------------------- GPT
# GPT cases against the reference trainer, 3 steps of GPTConfig.tiny(
# num_hidden_layers=2) from one carried-over state, step i keyed by
# key(100 + i) on both sides. With dropout the reference runs its Pallas
# sdpa (`force_backend("pallas")`, interpret flash builds patched in),
# whose keep bits the port's plain flash reproduces. Tolerances as the
# LLaMA test's, with one exception stated where it applies: the gradient
# of attn.k_proj.bias is zero in exact arithmetic (a row's softmax does
# not change when the same q . b is added to all its logits), so AdamW
# moves it by rounding noise, up to about lr a step in each framework, in
# directions of their own; it is held to 3 x steps x lr.
GPT_STEPS = 3
GPT_LR = 1e-3
GPT_CASES = {
    # id: (param and moment dtype, dropout, recompute policy, grad_accum)
    "f32_dropout_save_attn": ("float32", True, "save_attn", 1),
    "bf16_dropout_save_attn": ("bfloat16", True, "save_attn", 1),
    "f32_dropout_full_accum2": ("float32", True, "full", 2),
    "f32_nodropout_full": ("float32", False, "full", 1),
    "bf16_nodropout_save_attn": ("bfloat16", False, "save_attn", 1),
}
GPT_TOL = {"float32": dict(loss_rtol=1e-5, param_atol=1e-4),
           "bfloat16": dict(loss_rtol=1e-3, param_atol=1.6e-2)}


def _gpt_batch():
    rng = np.random.RandomState(7)
    ids = rng.randint(0, 128, (4, 32)).astype(np.int64)
    labels = np.roll(ids, -1, axis=1)
    labels[0, :5] = -100
    labels[3, -2:] = -100
    return ids, labels


def _gpt_cfg(mod, dropout):
    kw = {} if dropout else dict(hidden_dropout_prob=0.0,
                                 attention_probs_dropout_prob=0.0)
    return mod.tiny(num_hidden_layers=2, **kw)


def _gpt_kw(case):
    dtype, _, policy, accum = GPT_CASES[case]
    return dict(lr=GPT_LR, param_dtype=dtype, moment_dtype=dtype,
                recompute=True, recompute_policy=policy, grad_accum=accum)


def _recording(mp, mod, scope_of):
    """Wrap mod.next_key; returns the list of the scope counter after each
    draw."""
    draws, orig = [], mod.next_key

    def next_key():
        k = orig()
        box = scope_of()
        draws.append(box[1] if box is not None else None)
        return k

    mp.setattr(mod, "next_key", next_key)
    return draws


@pytest.fixture(scope="module", params=list(GPT_CASES))
def gpt_reference(request):
    """The reference trainer's run of one case: its initial state, losses,
    final params (numpy) and the draw counters of its traced step."""
    from paddle_tpu.framework import random as jrnd
    from paddle_tpu.models.gpt import GPTConfig as JC
    from paddle_tpu.models.gpt import GPTForCausalLM as JG
    from paddle_tpu.ops import force_backend
    from paddle_tpu.ops.pallas import flash_attention as jfa
    case = request.param
    mesh = build_mesh({"data": 1, "pipe": 1, "sharding": 1, "model": 1})
    set_global_mesh(mesh)
    paddle.seed(3)
    jt = JaxTrainer(JG(_gpt_cfg(JC, GPT_CASES[case][1])), mesh,
                    **_gpt_kw(case))
    js = jt.init_state()
    init = (_np(jt.gather_params(js)), _np(js["opt"]), int(js["step"]))
    ids, labels = _gpt_batch()
    losses = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jfa._dropout_flash_cache, 0.1, jfa.make_flash_attention(
            bq=32, bk=32, interpret=True, dropout_p=0.1))
        mp.setattr(jfa, "_default_flash",
                   jfa.make_flash_attention(bq=32, bk=32, interpret=True))
        draws = _recording(mp, jrnd, lambda: jrnd._key_stack[-1]
                           if jrnd._key_stack else None)
        with force_backend("pallas"):
            for i in range(GPT_STEPS):
                js, loss = jt.step(js, ids, labels, key=jax.random.key(100 + i))
                losses.append(float(loss))
    return dict(case=case, init=init, losses=losses, draws=list(draws),
                params=_np(jt.gather_params(js)), step=int(js["step"]))


def _gpt_port_run(ref, mp=None):
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    case = ref["case"]
    tt = SpmdTrainer(GPTForCausalLM(_gpt_cfg(GPTConfig, GPT_CASES[case][1]),
                                    device="cpu"), **_gpt_kw(case))
    ts = trainer_state_from_numpy(tt, *ref["init"])
    ids, labels = _gpt_batch()
    losses = []
    for i in range(GPT_STEPS):
        kd = np.asarray(jax.random.key_data(jax.random.key(100 + i)))
        ts, loss = tt.step(ts, ids, labels, key=kd)
        losses.append(float(loss))
    return tt, ts, losses


def test_gpt_matches_jax_trainer(gpt_reference):
    ref = gpt_reference
    dtype = GPT_CASES[ref["case"]][0]
    tol = GPT_TOL[dtype]
    tt, ts, losses = _gpt_port_run(ref)
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(losses, ref["losses"], rtol=tol["loss_rtol"])
    assert ts["step"] == ref["step"] == GPT_STEPS
    names = tt.outer_names + tt.layer_param_names
    tp = tt.gather_params(ts)
    for name, a, b in zip(names, ref["params"]["outer"] + ref["params"]["stacked"],
                          tp["outer"] + tp["stacked"]):
        assert b.dtype == getattr(torch, dtype)
        atol = (3 * GPT_STEPS * GPT_LR if name == "attn.k_proj.bias"
                else tol["param_atol"])
        np.testing.assert_allclose(b.float().numpy(), a.astype(np.float32),
                                   rtol=0, atol=atol, err_msg=name)


def test_gpt_draw_counters_equal_reference(gpt_reference):
    """Exact: the reference traces its layer body once, so a step draws
    counters 1 (embedding dropout), 2 (the attention seed) and 3 (hidden
    dropout) per micro-batch, for every layer; the port's layers and
    recomputes draw exactly those counters, layer after layer."""
    from paddle_tpu_torch.framework import random as R
    ref = gpt_reference
    _, dropout, policy, accum = GPT_CASES[ref["case"]]
    with pytest.MonkeyPatch.context() as mp:
        draws = _recording(mp, R, R.current_scope)
        _gpt_port_run(ref)
    if not dropout:
        assert ref["draws"] == [] and draws == []
        return
    assert ref["draws"] == [1, 2, 3]
    L = 2
    # per micro-batch: the forward's layers, then the recompute's
    per_micro = [1] + [2, 3] * L + [2, 3] * L
    assert draws == per_micro * accum * GPT_STEPS


def test_gpt_recompute_policies_are_bit_identical_with_dropout():
    from paddle_tpu_torch.framework import random as R
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    ids, labels = _gpt_batch()
    results = []
    for kw in (dict(recompute=False), dict(recompute=True,
                                           recompute_policy="save_attn"),
               dict(recompute=True, recompute_policy="full")):
        tr = SpmdTrainer(GPTForCausalLM(GPTConfig.tiny(num_hidden_layers=2),
                                        device="cpu", seed=2), **kw)
        st = tr.init_state()
        losses = []
        for i in range(2):
            st, loss = tr.step(st, ids, labels, key=R.key(40 + i))
            losses.append(loss)
        results.append((torch.stack(losses), st["params"]))
    ref_l, ref_p = results[0]
    for loss, params in results[1:]:
        assert torch.equal(loss, ref_l)
        assert all(torch.equal(params[n], ref_p[n]) for n in ref_p)


def test_gpt_unfused_tail_matches_fused():
    """The GPT criterion's unfused path (lm_head, then the token mean of
    `ce`) against the fused chunked head + CE, dropout on, one key: f32
    sums in another order (losses rtol 1e-5, params atol 1e-4 but
    k_proj.bias, whose gradient is rounding noise: 3 x steps x lr)."""
    from paddle_tpu_torch.framework import random as R
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    ids, labels = _gpt_batch()
    runs = []
    for fuse in (True, False):
        tr = SpmdTrainer(GPTForCausalLM(GPTConfig.tiny(num_hidden_layers=2),
                                        device="cpu", seed=4),
                         fuse_head_ce=fuse, ce_chunk=48)
        st = tr.init_state()
        losses = []
        for i in range(2):
            st, loss = tr.step(st, ids, labels, key=R.key(60 + i))
            losses.append(loss)
        runs.append((torch.stack(losses), st["params"]))
    (fl, fp), (ul, up) = runs
    torch.testing.assert_close(ul, fl, rtol=1e-5, atol=0)
    for n in fp:
        atol = 3 * 2 * 1e-3 if n.endswith("k_proj.bias") else 1e-4
        torch.testing.assert_close(up[n], fp[n], rtol=0, atol=atol)


def test_gpt_step_keys_and_layout():
    """key=None takes the global generator's next key; another key gives
    another loss; the state's names and the reference's outer order."""
    from paddle_tpu_torch.framework import random as R
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    ids, labels = _gpt_batch()
    model = GPTForCausalLM(GPTConfig.tiny(num_hidden_layers=2), device="cpu")
    tr = SpmdTrainer(model)
    assert tr.outer_names == [
        "gpt.embeddings.word_embeddings.weight",
        "gpt.embeddings.position_embeddings.weight", "gpt.ln_f.weight",
        "gpt.ln_f.bias", "lm_head.weight"]
    assert tr.layer_name(1, "attn.q_proj.bias") == "gpt.h.1.attn.q_proj.bias"
    g = tr.gather_params(tr.init_state())
    assert tuple(g["stacked"][0].shape) == (2, 64)            # ln_1.weight
    R.seed(11)
    _, a = tr.step(tr.init_state(), ids, labels)
    R.seed(11)
    _, b = tr.step(tr.init_state(), ids, labels, key=R.next_key())
    _, c = tr.step(tr.init_state(), ids, labels, key=R.key(5))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(NotImplementedError, match="A8.6"):
        SpmdTrainer(model, mesh={"sep": 2})
