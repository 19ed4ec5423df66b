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
    dict(grad_compress="int8"), dict(plan={"mesh": {}})],
    ids=["mesh", "pipeline", "grad_compress", "plan"])
def test_unported_options_raise(kw):
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
