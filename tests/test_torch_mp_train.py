"""Tensor-parallel training in the port: `SpmdTrainer(mesh={"model": 2})`
over two ranks against the reference's trainer on `{"model": 2}` and
`{"model": 1}` and against the reference's dense gradients.

The world "train2" (this file run as `python tests/test_torch_mp_train.py
train2 <spec> <out dir>`: two ranks on gloo, the CPU) is
`train_llama.tp_rank` on three runs, each from
`convert.shard_numpy_params` of the reference model's parameters, 3 AdamW
steps in f32 (lr 1e-5), step i keyed by key(100 + i), on one seeded batch
with some ignored labels: a tiny LLaMA (2 layers, H 64, 4 heads, 2 kv
heads, vocab 256), a tiny GPT at dropout 0, the same GPT at dropout 0.1
(hidden and attention), and the LLaMA again under `recompute=True,
recompute_policy="save_attn"`. Each rank prints one `RESULT {json}` line a run,
its data the run's report, and saves its shards, its step-0 gradients and
its moments; rank 0 saves the gathered canonical state.

Gates, with their tolerances:
  - each rank's step-0 gradient shards against the reference's dense
    gradients (`jax.grad` of its functional loss over the whole model),
    parameter by
    parameter: relative L2 <= 1e-5 (a gradient summed once too often over
    the model-parallel group gives 1.0); GPT's attention key biases, whose
    gradient is zero in exact arithmetic, by max |g| <= 1e-7 instead;
  - the gathered parameters (`SpmdTrainer.gather_params`, and
    `convert.gather_shards` of the ranks' shards) against the reference
    trainer's on `{"model": 2}` and on `{"model": 1}`: atol 1e-5 (the lr
    keeps Adam's amplification of rounding in near-zero gradients, lr x
    |dg| / eps, under it, while a skipped or wrong update moves a
    parameter by about lr a step); the key biases 3 x steps x lr;
  - losses: rtol 1e-5 against both reference runs;
  - the canonical moments against the reference's dense ones after the
    same steps (`tests/test_grad_convention.py:49` replayed: rtol 2e-3,
    atol 1e-7);
  - the replicated parameters (norms, the row-parallel biases, GPT's
    position table) equal bit for bit across the ranks
    (`gather_shards` raises otherwise);
  - the recomputed LLaMA: the same gradient and parameter gates, against
    the reference trainer's recompute run on `{"model": 2}`;
  - GPT with dropout against the reference's `{"model": 2}` run keyed
    alike (its Pallas flash in interpret mode, whose keep bits the port's
    plain flash reproduces): losses rtol 1e-5, parameters atol 1e-5;
  - the ranks' `dist_attr`s equal the reference Parameters', exactly.
"""
import contextlib
import json
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from test_torch_collective import (free_ports, join_world,  # noqa: E402
                                   results_by_check, spawn_world)

STEPS, LR, SEQ = 3, 1e-5, 32
KEYS = [100 + i for i in range(STEPS)]
LLAMA = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
             max_position_embeddings=128)
GPT = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=4, max_position_embeddings=64)
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
RUNS = {"llama": ("llama", LLAMA), "gpt": ("gpt", dict(GPT, **NO_DROPOUT)),
        "gpt_dropout": ("gpt", GPT), "llama_recompute": ("llama", LLAMA)}
# trainer options of a run beyond lr and param_dtype, given to both
# trainers: under save_attn the backward re-runs each layer but its
# attention, o_proj's `_mp_allreduce` included
TRAINER_KW = {"llama_recompute": dict(recompute=True,
                                      recompute_policy="save_attn")}


def _batch(vocab):
    rng = np.random.RandomState(7)
    ids = rng.randint(0, vocab, (4, SEQ)).astype(np.int64)
    labels = np.roll(ids, -1, axis=1)
    labels[0, :5] = -100
    labels[3, -2:] = -100
    return ids, labels


def _worker(spec_path, out_dir):
    from paddle_tpu_torch.train_llama import tp_rank
    with open(spec_path) as f:
        spec = json.load(f)
    tp_rank(spec, out_dir)
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    for run in spec["runs"]:
        with open(os.path.join(out_dir, f"{run['name']}_rank{rank}.json")) as f:
            rep = json.load(f)
        ok = (rep["backend"] == "gloo" and rep["mode"] == "tensor_parallel"
              and len(rep["losses"]) == STEPS
              and all(np.isfinite(rep["losses"])))
        print("RESULT " + json.dumps(dict(check=run["name"], ok=ok, err="",
                                          data=rep)), flush=True)


if __name__ == "__main__":
    torch.set_num_threads(1)
    _worker(sys.argv[2], sys.argv[3])
    sys.exit(0)


# -- the tests ----------------------------------------------------------------
import jax  # noqa: E402
import pytest  # noqa: E402


def _reference_model(family, cfg):
    import paddle_tpu as paddle
    from paddle_tpu.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu.models.gpt import GPTConfig, GPTForCausalLM
    paddle.seed(11)
    if family == "llama":
        return LlamaForCausalLM(LlamaConfig(**cfg))
    return GPTForCausalLM(GPTConfig(**cfg))


def _dense_grads(jm, ids, labels):
    """The reference's dense gradients: `jax.grad` of its functional loss
    (`meta_parallel/spmd.py` `functional_loss_fn`) over the whole model,
    the token mean CE on the whole batch (the trainer's loss)."""
    from paddle_tpu.distributed.fleet.meta_parallel.spmd import \
        functional_loss_fn
    fn, names, tensors, _ = functional_loss_fn(
        jm, lambda layer, i, lab: layer(i, lab))
    grads = jax.jit(jax.grad(fn))([p.data for p in tensors],
                                  jax.random.key(0), ids, labels)
    return {n: np.asarray(g) for n, g in zip(names, grads)}


def _reference_run(jm, mp, ids, labels, dropout, **trainer_kw):
    """The reference trainer on {"model": mp}: losses, gathered params,
    canonical state."""
    from paddle_tpu.distributed.mesh import build_mesh, set_global_mesh
    from paddle_tpu.models.train_step import SpmdTrainer as JaxTrainer
    from paddle_tpu.ops import force_backend
    from paddle_tpu.ops.pallas import flash_attention as jfa
    mesh = build_mesh({"data": 1, "pipe": 1, "sharding": 1, "model": mp})
    set_global_mesh(mesh)
    jt = JaxTrainer(jm, mesh, lr=LR, param_dtype="float32", **trainer_kw)
    js = jt.init_state()
    losses = []
    with pytest.MonkeyPatch.context() as mpatch:
        if dropout:
            mpatch.setitem(jfa._dropout_flash_cache, 0.1,
                           jfa.make_flash_attention(bq=32, bk=32,
                                                    interpret=True,
                                                    dropout_p=0.1))
            mpatch.setattr(jfa, "_default_flash", jfa.make_flash_attention(
                bq=32, bk=32, interpret=True))
        with force_backend("pallas") if dropout else contextlib.nullcontext():
            for k in KEYS:
                js, loss = jt.step(js, ids, labels, key=jax.random.key(k))
                losses.append(float(loss))
    canon = jax.tree_util.tree_map(np.asarray, jt.canonical_state(js))
    return dict(losses=losses, canon=canon,
                names=jt.outer_names, layer_names=jt.layer_param_names)


@pytest.fixture(scope="module")
def train2(tmp_path_factory):
    """The two-rank world, started first; the reference's runs meanwhile."""
    tmp = tmp_path_factory.mktemp("mp_train")
    models, runs = {}, []
    for name, (family, cfg) in RUNS.items():
        jm = models[name] = _reference_model(family, cfg)
        np.savez(tmp / f"{name}_w.npz", **{n: np.asarray(p.data)
                                          for n, p in jm.named_parameters()})
        ids, labels = _batch(cfg["vocab_size"])
        np.savez(tmp / f"{name}_data.npz", ids=ids, labels=labels)
        runs.append(dict(name=name, family=family, model=cfg, seed=0,
                         weights=str(tmp / f"{name}_w.npz"),
                         data=str(tmp / f"{name}_data.npz"), keys=KEYS,
                         trainer=dict(lr=LR, param_dtype="float32",
                                      **TRAINER_KW.get(name, {})),
                         save=True, save_moments=True, canonical=True))
    spec = tmp / "spec.json"
    spec.write_text(json.dumps(dict(mp=2, device="cpu", runs=runs)))
    held = []
    port = free_ports(2, held)
    for s in held:
        s.close()
    procs = spawn_world(os.path.abspath(__file__), "train2", 2, port,
                        (str(spec), str(tmp)))
    ref = {}
    for name, (family, cfg) in RUNS.items():
        ids, labels = _batch(cfg["vocab_size"])
        jm = models[name]
        dropout = name == "gpt_dropout"
        kw = TRAINER_KW.get(name, {})
        # each trainer takes a model of its own: the step donates the
        # state, whose first arrays are the model's; the recomputed LLaMA
        # has the LLaMA's weights and batch, so its dense gradients
        ref[name] = dict(
            attrs={n: tuple(p.dist_attr) for n, p in jm.named_parameters()
                   if getattr(p, "dist_attr", None) is not None},
            grads=(None if dropout else ref["llama"]["grads"] if kw
                   else _dense_grads(jm, ids, labels)),
            m2=_reference_run(_reference_model(family, cfg), 2, ids, labels,
                              dropout, **kw),
            m1=None if dropout or kw else _reference_run(
                _reference_model(family, cfg), 1, ids, labels, False))
    return dict(tmp=tmp, ref=ref, runs=join_world(procs, timeout=150))


def _ranks(train2, name):
    runs = train2["runs"]
    logs = "\n".join(f"-- rank {r} rc {rc}\n{o[-3000:]}"
                     for r, (rc, o) in enumerate(runs))
    got = results_by_check(runs).get(name, {})
    assert sorted(got) == [0, 1], f"{name}: ranks {sorted(got)}\n{logs}"
    assert all(ok for ok, _ in got.values()), logs
    return [torch.load(train2["tmp"] / f"{name}_rank{r}.pt") for r in (0, 1)]


def _reps(train2, name):
    return [json.loads((train2["tmp"] / f"{name}_rank{r}.json").read_text())
            for r in (0, 1)]


def _gathered(shards, key, attrs):
    from paddle_tpu_torch.convert import gather_shards
    return gather_shards([{n: t.numpy() for n, t in s[key].items()}
                          for s in shards], attrs)


@pytest.mark.parametrize("name", list(RUNS))
def test_dist_attrs_equal_reference(train2, name):
    """Exact."""
    for s in _ranks(train2, name):
        assert s["dist_attrs"] == train2["ref"][name]["attrs"]


@pytest.mark.parametrize("name", ["llama", "gpt", "llama_recompute"])
def test_step0_gradient_shards_match_dense(train2, name):
    from paddle_tpu_torch.convert import shard_numpy_params
    ref = train2["ref"][name]
    for rank, s in enumerate(_ranks(train2, name)):
        want = shard_numpy_params(ref["grads"], rank, 2, ref["attrs"])
        assert sorted(s["grads0"]) == sorted(want)
        for n, g in s["grads0"].items():
            g, w = g.double().numpy(), want[n].astype(np.float64)
            if n.endswith("k_proj.bias"):
                assert np.abs(g).max() <= 1e-7, (rank, n)
                continue
            rel = np.linalg.norm(g - w) / np.linalg.norm(w)
            assert rel <= 1e-5, (rank, n, rel)


def _param_atol(name):
    return 3 * STEPS * LR if name.endswith("k_proj.bias") else 1e-5


@pytest.mark.parametrize("name,mesh", [("llama", "m2"), ("llama", "m1"),
                                       ("gpt", "m2"), ("gpt", "m1"),
                                       ("gpt_dropout", "m2"),
                                       ("llama_recompute", "m2")])
def test_params_and_losses_match_reference_trainer(train2, name, mesh):
    """Gathered parameters (the trainer's gather and the ranks' shards
    joined, the replicated ones bit-equal across ranks) within atol 1e-5
    of the reference trainer's, losses within rtol 1e-5."""
    ref = train2["ref"][name][mesh]
    shards = _ranks(train2, name)
    canon = np.load(train2["tmp"] / f"{name}_canonical.npz")
    joined = _gathered(shards, "params", train2["ref"][name]["attrs"])
    layout = ([("outer", i, n) for i, n in enumerate(_port_outer(name))]
              + [("stacked", i, n) for i, n in enumerate(ref["layer_names"])])
    for kind, i, pname in layout:
        want = np.asarray(ref["canon"]["params"][kind][i], np.float32)
        got = canon[f"params.{kind}.{i}"]
        np.testing.assert_allclose(got, want, rtol=0, atol=_param_atol(pname),
                                   err_msg=f"{kind} {i} {pname}")
        if kind == "outer":
            np.testing.assert_array_equal(joined[pname], got)
        else:
            np.testing.assert_array_equal(
                np.stack([joined[f"{_prefix(name)}.{li}.{pname}"]
                          for li in range(got.shape[0])]), got)
    for rep in _reps(train2, name):
        np.testing.assert_allclose(rep["losses"], ref["losses"], rtol=1e-5)


def _prefix(name):
    return "llama.layers" if name.startswith("llama") else "gpt.h"


def _port_outer(name):
    if name.startswith("llama"):
        return ["llama.embed_tokens.weight", "llama.norm.weight",
                "lm_head.weight"]
    return ["gpt.embeddings.word_embeddings.weight",
            "gpt.embeddings.position_embeddings.weight", "gpt.ln_f.weight",
            "gpt.ln_f.bias", "lm_head.weight"]


@pytest.mark.parametrize("name", ["llama", "gpt"])
def test_canonical_moments_match_dense(train2, name):
    """`test_grad_convention.py:49` replayed across processes: the
    tensor-parallel run's canonical Adam moments equal the reference's
    dense run's (rtol 2e-3, atol 1e-7); a gradient scaled by the mp
    degree shows as a clean x2 (x4 in v)."""
    ref = train2["ref"][name]["m1"]["canon"]
    canon = np.load(train2["tmp"] / f"{name}_canonical.npz")
    for kind in ("outer", "stacked"):
        for i, ent in enumerate(ref["opt"][kind]):
            for k in ("m", "v"):
                np.testing.assert_allclose(
                    canon[f"opt.{kind}.{i}.{k}"].astype(np.float64),
                    np.asarray(ent[k], np.float64), rtol=2e-3, atol=1e-7,
                    err_msg=f"opt.{kind}[{i}].{k}")


@pytest.mark.parametrize("name", list(RUNS))
def test_replicated_parameters_bit_equal_across_ranks(train2, name):
    attrs = train2["ref"][name]["attrs"]
    s0, s1 = _ranks(train2, name)
    repl = [n for n in s0["params"] if "model" not in (attrs.get(n) or ())]
    assert repl
    for n in repl:
        assert torch.equal(s0["params"][n], s1["params"][n]), n
        for k in ("m", "v"):
            assert torch.equal(s0["opt"][n][k], s1["opt"][n][k]), (n, k)


def test_model_parallel_collectives_counted(train2):
    """Exact: a LLaMA step runs 7 forward collectives (the embedding's
    completion, o and down per layer, the CE's max and sum) and 11 in the
    backward (q, k, v, gate and up inputs per layer, the head's input);
    both ranks count the same calls and bytes."""
    reps = _reps(train2, "llama")
    assert reps[0]["comm_calls_per_step"] == reps[1]["comm_calls_per_step"] \
        == 7 + 11
    assert reps[0]["comm_bytes_per_step"] == reps[1]["comm_bytes_per_step"]


def test_workers_exit_cleanly(train2):
    for rank, (rc, out) in enumerate(train2["runs"]):
        assert rc == 0, f"rank {rank}:\n{out[-3000:]}"
