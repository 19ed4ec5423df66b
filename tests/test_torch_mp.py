"""Tensor parallelism in the port: the meta_parallel layers, ops and RNG
tracker, `TensorParallel` / `HybridParallelOptimizer` under `fleet`, the
shard layout of `convert`, against the reference (`paddle_tpu`).

In processes (this file run as `python tests/test_torch_mp.py <mode>`,
gloo on the CPU, `fleet.init(mp_degree=n, device="cpu")`; each check
prints one `RESULT {json}` line, its data the values the reference is
held to here):
  - "layers4" (4 ranks, the reference's mp 4):
    `tests/test_distributed.py::TestTensorParallel` replayed (:163-291),
    each rank holding its shard of the test's weights: Column -> Row
    forward, the vocab-parallel embedding and the parallel CE, each
    within rtol 1e-5 of the reference's output on the same inputs; the
    Column -> Row backward against the dense math in float64 (rtol 1e-5,
    atol 1e-6; the reference's own backward test is red, ROADMAP A8.5),
    and the parallel CE's gradients (the head's weight shard and the
    input) against the dense softmax CE's (same tolerance); `_c_split`
    then `_c_concat` is the identity, forward and backward, exactly;
    `split()` for a column, a row (rtol 1e-5 against x @ W) and an
    embedding (exactly W[ids]); the RNG tracker's "global_seed" draws
    equal on every rank, its "local_seed" draws and the mp dropout's
    masks differ;
  - "fleet2" (2 ranks): the journey `fleet.init(mp 2)` ->
    `distributed_model` (a `TensorParallel`) -> `distributed_optimizer`
    (a `HybridParallelOptimizer`) on a tiny LLaMA: rank 1 starts from
    other replicated weights (and other ids) until the wrapper's
    broadcasts, after which the replicated weights, the ids, the losses
    and, after two AdamW steps, the replicated weights again are equal
    bit for bit on both ranks; GQA with num_key_value_heads % mp != 0
    raises ValueError;
  - "tpdp4" (4 ranks, dp 2 x mp 2 through the same journey, each data
    replica on its own rows): after two steps every rank's parameters
    equal its data-parallel peer's bit for bit (`HybridParallelOptimizer`
    averages the gradients over the data-parallel group).

In-process: `convert.shard_numpy_params` / `gather_shards` round trip
exactly for every parameter of the reference's LLaMA and GPT at mp 2 and
4 (the split dim from each reference Parameter's `dist_attr`); the RNG
tracker's determinism (`test_distributed.py:281`) with its keys equal to
the reference's bit for bit; the typed refusals; and, in a world of 1
(even after `fleet.init(mp_degree=2)`), every layer equal to its dense
module exactly, forward and backward.
"""
import json
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from test_torch_collective import (free_ports, join_world,  # noqa: E402
                                   results_by_check, spawn_world)


def _report(check, ok, err="", data=None):
    print("RESULT " + json.dumps(dict(check=check, ok=bool(ok), err=err,
                                      data=data)), flush=True)


def _strategy(fleet, dp=1, mp=1, pp=1, sharding=1):
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "mp_degree": mp, "pp_degree": pp,
                        "sharding_degree": sharding}
    return s


def _run(fn):
    """Run one check; it returns (ok, data) or raises."""
    try:
        ok, data = fn()
        _report(fn.__name__, ok, "" if ok else f"data {data}", data)
    except Exception as e:           # reported, and the rank goes on
        _report(fn.__name__, False, f"{type(e).__name__}: {e}")


def _close(got, want, rtol=1e-5, atol=1e-6):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    return bool(np.allclose(got, want, rtol=rtol, atol=atol))


def _gathered(dist, t):
    out = []
    dist.all_gather(out, t.detach().contiguous())
    return out


# -- the reference's inputs (tests/test_distributed.py:163-291) ------------
def _col_row_inputs(seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 8).astype(np.float32)
    w1 = rng.randn(8, 16).astype(np.float32)
    w2 = rng.randn(16, 8).astype(np.float32)
    return x, w1, w2


def _emb_inputs():
    rng = np.random.RandomState(2)
    return rng.randn(16, 6).astype(np.float32), np.asarray([[0, 5, 15],
                                                            [7, 3, 9]])


def _ce_inputs():
    rng = np.random.RandomState(3)
    rng.randn(4, 16)                 # the reference's unused logits
    labels = np.asarray([0, 5, 11, 15], np.int64)
    w = rng.randn(8, 16).astype(np.float32)
    x = rng.randn(4, 8).astype(np.float32)
    return x, w, labels


def _dense_ce_grads(x, w, labels):
    """float64 dense softmax CE (mean over rows): (dW, dx)."""
    x, w = x.astype(np.float64), w.astype(np.float64)
    lg = x @ w
    p = np.exp(lg - lg.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    p[np.arange(len(labels)), labels] -= 1.0
    p /= len(labels)
    return x.T @ p, p @ w.T


# -- the workers -----------------------------------------------------------
def _layers4_worker():
    from torch import nn
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import meta_parallel as mpu
    from paddle_tpu_torch.distributed.fleet.meta_parallel import mp_ops
    from paddle_tpu_torch.framework import random as frnd
    from paddle_tpu_torch.nn.initializer import xavier_normal, xavier_uniform
    fleet.init(is_collective=True, strategy=_strategy(fleet, mp=4),
               device="cpu")
    hcg = fleet.get_hybrid_communicate_group()
    r = hcg.get_model_parallel_rank()
    mp = hcg.get_model_parallel_world_size()

    def cols(a):
        n = a.shape[1] // mp
        return torch.from_numpy(np.ascontiguousarray(a[:, r * n:(r + 1) * n]))

    def rows(a):
        n = a.shape[0] // mp
        return torch.from_numpy(np.ascontiguousarray(a[r * n:(r + 1) * n]))

    def block(w1, w2):
        col = mpu.ColumnParallelLinear(8, 16, gather_output=False,
                                       has_bias=False, device="cpu")
        row = mpu.RowParallelLinear(16, 8, input_is_parallel=True,
                                    has_bias=False, device="cpu")
        with torch.no_grad():
            col.weight.copy_(cols(w1))
            row.weight.copy_(rows(w2))
        return col, row, fleet.distributed_model(nn.Sequential(col, row))

    def column_row_forward():
        x, w1, w2 = _col_row_inputs(0)
        _, _, model = block(w1, w2)
        out = model(torch.from_numpy(x))
        return (isinstance(model, mpu.TensorParallel),
                out.detach().numpy().tolist())

    def column_row_backward():
        x, w1, w2 = _col_row_inputs(1)
        col, row, model = block(w1, w2)
        model(torch.from_numpy(x)).sum().backward()
        x64, w1d, w2d = (a.astype(np.float64) for a in (x, w1, w2))
        gout = np.ones((2, 8))
        g_w2 = (x64 @ w1d).T @ gout
        g_w1 = x64.T @ (gout @ w2d.T)
        n = 16 // mp
        return (_close(row.weight.grad, g_w2[r * n:(r + 1) * n])
                and _close(col.weight.grad, g_w1[:, r * n:(r + 1) * n]),
                None)

    def vocab_parallel_embedding():
        w, ids = _emb_inputs()
        emb = mpu.VocabParallelEmbedding(16, 6, device="cpu")
        with torch.no_grad():
            emb.weight.copy_(rows(w))
        model = fleet.distributed_model(nn.Sequential(emb))
        out = model(torch.from_numpy(ids))
        return True, out.detach().numpy().tolist()

    def parallel_cross_entropy():
        x, w, labels = _ce_inputs()
        head = mpu.ColumnParallelLinear(8, 16, gather_output=False,
                                        has_bias=False, device="cpu")
        ce = mpu.ParallelCrossEntropy()
        with torch.no_grad():
            head.weight.copy_(cols(w))
        xt = torch.from_numpy(x).requires_grad_()
        model = fleet.distributed_model(head)
        loss = ce(model(xt), torch.from_numpy(labels)).mean()
        loss.backward()
        dw, dx = _dense_ce_grads(x, w, labels)
        n = 16 // mp
        ok = (tuple(ce(head(xt), torch.from_numpy(labels)).shape) == (4, 1)
              and _close(head.weight.grad, dw[:, r * n:(r + 1) * n])
              and _close(xt.grad, dx))
        return ok, float(loss)

    def concat_split_round_trip():
        g = torch.Generator().manual_seed(4)
        x = torch.randn(2, 3, 8, generator=g).requires_grad_()
        c = torch.randn(2, 3, 8, generator=g)
        y = mp_ops._c_concat(mp_ops._c_split(x))
        (y * c).sum().backward()
        local = mp_ops._c_split(x.detach())
        return (torch.equal(y, x) and torch.equal(x.grad, c)
                and torch.equal(local, x.detach()[..., 2 * r:2 * r + 2])), None

    def split_api():
        torch.manual_seed(11)
        x = torch.randn(4, 8)
        ids = torch.tensor([[0, 5, 15], [7, 3, 9]])
        ok = True
        for kind, axis, make, expect in (
                ("linear", 1, lambda: xavier_uniform((8, 16), None, "cpu"),
                 lambda w: x @ w),
                ("linear", 0, lambda: xavier_uniform((8, 16), None, "cpu"),
                 lambda w: x @ w),
                ("embedding", 0, lambda: xavier_normal((16, 6), None, "cpu"),
                 lambda w: w[ids])):
            state = torch.get_rng_state()
            inp = x if kind == "linear" else ids
            size = (8, 16) if kind == "linear" else (16, 6)
            out = mpu.mp_ops.split(inp, size, kind, axis=axis)
            torch.set_rng_state(state)
            want = expect(make())
            ok &= (torch.equal(out, want) if kind == "embedding"
                   else _close(out, want.double().numpy()))
        return ok, None

    def rng_tracker_across_ranks():
        tracker = mpu.get_rng_state_tracker()
        mpu.model_parallel_random_seed(1234)
        with tracker.rng_state("global_seed"):
            a = frnd.uniform(frnd.next_key(), (8,))
        with tracker.rng_state("local_seed"):
            b = frnd.uniform(frnd.next_key(), (8,))
        from paddle_tpu_torch.distributed.fleet.meta_parallel.parallel_layers \
            import random as mprandom
        mprandom.model_parallel_random_seed(1234)
        m = mprandom.dropout(torch.ones(64), p=0.5, rng_name="local_seed")
        ga, gb, gm = (_gathered(dist, t) for t in (a, b, m))
        return (all(torch.equal(ga[0], t) for t in ga)
                and len({tuple(t.tolist()) for t in gb}) == mp
                and len({tuple(t.tolist()) for t in gm}) == mp), None

    for fn in (column_row_forward, column_row_backward,
               vocab_parallel_embedding, parallel_cross_entropy,
               concat_split_round_trip, split_api, rng_tracker_across_ranks):
        _run(fn)
    dist.barrier()
    dist.destroy_process_group()


def _fleet2_worker():
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import meta_parallel as mpu
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import \
        HybridParallelOptimizer
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    fleet.init(is_collective=True, strategy=_strategy(fleet, mp=2),
               device="cpu")
    rank = dist.get_rank()
    cfg = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, max_position_embeddings=64)
    model = LlamaForCausalLM(LlamaConfig(**cfg), device="cpu", seed=rank)
    repl = [p for p in model.parameters()
            if not getattr(p, "is_distributed", False)]
    with torch.no_grad():
        for p in repl:
            p.add_(0.25 * rank)

    def same(ts):
        return all(torch.equal(*_gathered(dist, t)) for t in ts)

    def replicated_differ_before():
        return not any(same([p]) for p in repl), None

    _run(replicated_differ_before)
    wrapped = fleet.distributed_model(model)

    def replicated_equal_after_broadcast():
        return (isinstance(wrapped, mpu.TensorParallel) and same(repl)
                and fleet.get_hybrid_communicate_group().get_parallel_mode()
                == "tensor_parallel"), None

    opt = fleet.distributed_optimizer(
        AdamW(1e-3, parameters=wrapped.named_parameters()))
    ids = torch.from_numpy(np.random.RandomState(rank).randint(
        0, 256, (2, 16)).astype(np.int64))
    losses = []

    def train_two_steps():
        for _ in range(2):
            loss = wrapped(ids, torch.roll(ids, -1, 1))
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(loss.detach())
        want0 = np.random.RandomState(0).randint(0, 256, (2, 16))
        return (isinstance(opt, HybridParallelOptimizer)
                and np.array_equal(ids.numpy(), want0)
                and same(losses) and same(repl)
                and bool(losses[1] < losses[0])), [float(x) for x in losses]

    def gqa_heads_must_divide():
        try:
            LlamaForCausalLM(LlamaConfig(**dict(cfg, num_key_value_heads=1)),
                             device="cpu")
        except ValueError as e:
            return "whole heads" in str(e), None
        return False, "no ValueError"

    for fn in (replicated_equal_after_broadcast, train_two_steps,
               gqa_heads_must_divide):
        _run(fn)
    dist.barrier()
    dist.destroy_process_group()


def _tpdp4_worker():
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    fleet.init(is_collective=True, strategy=_strategy(fleet, dp=2, mp=2),
               device="cpu")
    rank = dist.get_rank()
    hcg = fleet.get_hybrid_communicate_group()
    cfg = LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                      num_hidden_layers=1, num_attention_heads=4,
                      max_position_embeddings=64)
    model = fleet.distributed_model(
        LlamaForCausalLM(cfg, device="cpu", seed=rank))
    opt = fleet.distributed_optimizer(
        AdamW(1e-3, parameters=model.named_parameters()))
    dp_rank = hcg.get_data_parallel_rank()
    ids = torch.from_numpy(np.random.RandomState(dp_rank).randint(
        0, 256, (2, 16)).astype(np.int64))
    for _ in range(2):
        model(ids, torch.roll(ids, -1, 1)).backward()
        opt.step()
        opt.clear_grad()
    dp_group = hcg.get_data_parallel_group()

    def dp_replicas_equal():
        """Each rank's parameters equal its data-parallel peer's (the
        same mp rank of the other replica, which trained on other rows)
        bit for bit: the optimizer averaged the gradients over dp."""
        ok = hcg.get_parallel_mode() == "tensor_parallel"
        for p in model.parameters():
            peers = []
            dist.all_gather(peers, p.detach().contiguous(), group=dp_group)
            ok &= torch.equal(peers[0], peers[1])
        return ok, None

    _run(dp_replicas_equal)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    torch.set_num_threads(1)
    {"layers4": _layers4_worker, "fleet2": _fleet2_worker,
     "tpdp4": _tpdp4_worker}[sys.argv[1]]()
    sys.exit(0)


# -- the tests ----------------------------------------------------------------
import jax  # noqa: E402
import pytest  # noqa: E402

LAYERS4 = ["column_row_forward", "column_row_backward",
           "vocab_parallel_embedding", "parallel_cross_entropy",
           "concat_split_round_trip", "split_api", "rng_tracker_across_ranks"]
FLEET2 = ["replicated_differ_before", "replicated_equal_after_broadcast",
          "train_two_steps", "gqa_heads_must_divide"]


def _reference_outputs():
    """The reference's TestTensorParallel forwards at mp 4, as its tests
    run them (`fleet.init` then `fleet.distributed_model`)."""
    import paddle_tpu as paddle
    from paddle_tpu import nn
    from paddle_tpu.distributed import fleet
    from paddle_tpu.distributed.fleet import meta_parallel as mpu

    def init(mp):
        s = fleet.DistributedStrategy()
        s.hybrid_configs = {"dp_degree": 1, "mp_degree": mp, "pp_degree": 1,
                            "sharding_degree": 1}
        fleet.init(is_collective=True, strategy=s)

    class Wrap(nn.Layer):
        def __init__(self, **layers):
            super().__init__()
            self.names = list(layers)
            for k, v in layers.items():
                setattr(self, k, v)

        def forward(self, *t):
            h = t[0]
            for k in self.names:
                h = getattr(self, k)(h)
            return h

    init(4)
    try:
        out = {}
        x, w1, w2 = _col_row_inputs(0)
        col = mpu.ColumnParallelLinear(8, 16, gather_output=False,
                                       has_bias=False)
        row = mpu.RowParallelLinear(16, 8, input_is_parallel=True,
                                    has_bias=False)
        col.weight.set_value(paddle.to_tensor(w1))
        row.weight.set_value(paddle.to_tensor(w2))
        out["column_row_forward"] = fleet.distributed_model(
            Wrap(col=col, row=row))(paddle.to_tensor(x)).numpy()
        w, ids = _emb_inputs()
        emb = mpu.VocabParallelEmbedding(16, 6)
        emb.weight.set_value(paddle.to_tensor(w))
        out["vocab_parallel_embedding"] = fleet.distributed_model(
            Wrap(emb=emb))(paddle.to_tensor(ids)).numpy()
        x, w, labels = _ce_inputs()

        class CE(nn.Layer):
            def __init__(self):
                super().__init__()
                self.head = mpu.ColumnParallelLinear(8, 16,
                                                     gather_output=False,
                                                     has_bias=False)
                self.ce = mpu.ParallelCrossEntropy()

            def forward(self, t, lab):
                return paddle.mean(self.ce(self.head(t), lab))

        m = CE()
        m.head.weight.set_value(paddle.to_tensor(w))
        out["parallel_cross_entropy"] = fleet.distributed_model(m)(
            paddle.to_tensor(x), paddle.to_tensor(labels)).numpy()
        return out
    finally:
        init(1)


@pytest.fixture(scope="module")
def worlds():
    """Both worlds, spawned at once; the reference's outputs meanwhile."""
    me = os.path.abspath(__file__)
    held = []
    ports = [free_ports(2, held) for _ in range(3)]
    for s in held:
        s.close()
    started = {"layers4": spawn_world(me, "layers4", 4, ports[0]),
               "fleet2": spawn_world(me, "fleet2", 2, ports[1]),
               "tpdp4": spawn_world(me, "tpdp4", 4, ports[2])}
    ref = _reference_outputs()
    return dict(ref=ref, runs={m: join_world(p) for m, p in started.items()})


def _results(worlds, mode, check, n):
    runs = worlds["runs"][mode]
    logs = "\n".join(f"-- rank {r} rc {rc}\n{o[-3000:]}"
                     for r, (rc, o) in enumerate(runs))
    got = results_by_check(runs).get(check, {})
    assert sorted(got) == list(range(n)), f"{check}: ranks {sorted(got)}\n{logs}"
    bad = {r: e for r, (ok, e) in got.items() if not ok}
    assert not bad, f"{check}: {bad}"
    data = {}
    for rank, (_, out) in enumerate(runs):
        for line in out.splitlines():
            if line.startswith("RESULT "):
                r = json.loads(line[len("RESULT "):])
                if r["check"] == check:
                    data[rank] = r["data"]
    return data


@pytest.mark.parametrize("check", LAYERS4)
def test_layers4(worlds, check):
    """The worker's own gates (tolerances in the module docstring); the
    forwards also within rtol 1e-5 of the reference's output, on every
    rank."""
    data = _results(worlds, "layers4", check, 4)
    if check in worlds["ref"]:
        for rank, got in data.items():
            np.testing.assert_allclose(np.asarray(got, np.float32).reshape(
                np.shape(worlds["ref"][check])), worlds["ref"][check],
                rtol=1e-5, atol=1e-6, err_msg=f"rank {rank}")


@pytest.mark.parametrize("check", FLEET2)
def test_fleet2(worlds, check):
    _results(worlds, "fleet2", check, 2)


def test_tensor_by_data_parallel_under_fleet(worlds):
    """dp 2 x mp 2 in 4 ranks through fleet: exact (see the worker)."""
    _results(worlds, "tpdp4", "dp_replicas_equal", 4)


def test_workers_exit_cleanly(worlds):
    for mode, runs in worlds["runs"].items():
        for rank, (rc, out) in enumerate(runs):
            assert rc == 0, f"{mode} rank {rank}:\n{out[-3000:]}"


# -- in-process -----------------------------------------------------------------
def _reference_model(family, layers=2):
    import paddle_tpu as paddle
    from paddle_tpu.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu.models.gpt import GPTConfig, GPTForCausalLM
    paddle.seed(7)
    if family == "llama":
        return LlamaForCausalLM(LlamaConfig.tiny(
            num_hidden_layers=layers, vocab_size=256, num_key_value_heads=4))
    return GPTForCausalLM(GPTConfig.tiny(num_hidden_layers=layers))


@pytest.mark.parametrize("family", ["llama", "gpt"])
@pytest.mark.parametrize("mp", [2, 4])
def test_shard_gather_round_trip(family, mp):
    """Exact: each rank's shard is its contiguous 1 / mp of the dim the
    reference's `dist_attr` names "model" (the others whole), and the
    shards join back to the reference's full arrays bit for bit."""
    from paddle_tpu_torch.convert import gather_shards, shard_numpy_params
    jm = _reference_model(family)
    full = {n: np.asarray(p.data) for n, p in jm.named_parameters()}
    attrs = {n: p.dist_attr for n, p in jm.named_parameters()
             if getattr(p, "dist_attr", None) is not None}
    shards = [shard_numpy_params(full, r, mp, attrs) for r in range(mp)]
    for name, a in full.items():
        da = attrs.get(name) or ()
        if "model" in da:
            dim = list(da).index("model")
            assert shards[1][name].shape[dim] * mp == a.shape[dim], name
            n = a.shape[dim] // mp
            np.testing.assert_array_equal(
                np.take(a, range(n, 2 * n), axis=dim), shards[1][name])
        else:
            assert shards[1][name] is not None and np.array_equal(
                shards[1][name], a), name
    back = gather_shards(shards, attrs)
    assert list(back) == list(full)
    for name in full:
        np.testing.assert_array_equal(back[name], full[name], err_msg=name)
    bad = [dict(s) for s in shards]
    bad[1] = dict(bad[1])
    name = next(n for n in full if "model" not in (attrs.get(n) or ()))
    bad[1][name] = bad[1][name] + 1
    with pytest.raises(ValueError, match="replicated"):
        gather_shards(bad, attrs)


def test_rng_tracker_determinism_matches_reference():
    """`test_distributed.py:281` replayed, exactly: a reseeded tracker
    draws the same again, and the key the "global_seed" state binds is the
    reference's bit for bit (so are the draws from it)."""
    from paddle_tpu.distributed.fleet import meta_parallel as jmpu
    from paddle_tpu.framework import random as jrnd
    from paddle_tpu_torch.distributed.fleet import meta_parallel as mpu
    from paddle_tpu_torch.framework import random as frnd

    def port():
        tracker = mpu.get_rng_state_tracker()
        tracker.reset()
        mpu.model_parallel_random_seed(1234)
        with tracker.rng_state("global_seed"):
            k = frnd.next_key()
            return k, frnd.uniform(k, (4,))

    def reference():
        tracker = jmpu.get_rng_state_tracker()
        tracker.reset()
        jmpu.model_parallel_random_seed(1234)
        with tracker.rng_state("global_seed"):
            k = jrnd.next_key()
            return (np.asarray(jax.random.key_data(k)),
                    np.asarray(jax.random.uniform(k, (4,), dtype=np.float32)))

    (ka, a), (kb, b) = port(), port()
    assert torch.equal(ka, kb) and torch.equal(a, b)
    kr, ar = reference()
    np.testing.assert_array_equal(ka.numpy(), kr.astype(np.int64))
    np.testing.assert_array_equal(a.numpy(), ar)


@pytest.fixture
def clean_env():
    from paddle_tpu_torch import distributed as dist
    dist.destroy_process_group()
    yield
    dist.destroy_process_group()


def test_refusals(clean_env):
    """Typed errors naming their ROADMAP items: the trainer's other mesh
    axes and sequence parallelism, a model axis that does not match the
    model, the hybrid clip, the pipeline and sharding names, a mesh-axis
    name for the vocab-parallel CE."""
    from paddle_tpu_torch.distributed.fleet import meta_parallel as mpu
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import \
        HybridParallelClipGrad
    from paddle_tpu_torch.models import SpmdTrainer
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops.fused_ce import fused_linear_ce
    model = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1),
                             device="cpu")
    for axis, item in (("data", "A8.5"), ("pipe", "A8.7"),
                       ("sharding", "A8.8"), ("sep", "A8.6")):
        with pytest.raises(NotImplementedError, match=item):
            SpmdTrainer(model, mesh={axis: 2})
    with pytest.raises(ValueError, match="mp_degree"):
        SpmdTrainer(model, mesh={"model": 2})
    sp = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1,
                                           sequence_parallel=True),
                          device="cpu")
    with pytest.raises(NotImplementedError, match="A8.6"):
        SpmdTrainer(sp)
    with pytest.raises(NotImplementedError, match="A9.1"):
        HybridParallelClipGrad(1.0, None)
    for name, item in (("PipelineLayer", "A8.7"), ("LayerDesc", "A8.7"),
                       ("PipelineParallel", "A8.7"),
                       ("ShardingParallel", "A8.8"),
                       ("GroupShardedStage3", "A8.8")):
        with pytest.raises(mpu.MetaParallelError, match=item):
            getattr(mpu, name)()
    with pytest.raises(NotImplementedError, match="A8.10"):
        fused_linear_ce(torch.zeros(2, 4), torch.zeros(4, 3),
                        torch.zeros(2, dtype=torch.long), axis="model")


def _world_one_pairs():
    from paddle_tpu_torch.distributed.fleet import meta_parallel as mpu
    from paddle_tpu_torch.nn import Embedding, Linear

    def gen():
        return torch.Generator().manual_seed(3)

    x = torch.randn(3, 5, 8, generator=torch.Generator().manual_seed(1))
    ids = torch.randint(0, 16, (3, 5), generator=torch.Generator().manual_seed(2))
    return {
        "column": (lambda: mpu.ColumnParallelLinear(8, 12, gen=gen(), device="cpu"),
                   lambda: Linear(8, 12, gen(), "cpu"), x),
        "column_nobias": (lambda: mpu.ColumnParallelLinear(
            8, 12, has_bias=False, gather_output=False, gen=gen(), device="cpu"),
            lambda: Linear(8, 12, gen(), "cpu", bias=False), x),
        "row": (lambda: mpu.RowParallelLinear(8, 12, gen=gen(), device="cpu"),
                lambda: Linear(8, 12, gen(), "cpu"), x),
        "embedding": (lambda: mpu.VocabParallelEmbedding(16, 8, gen=gen(),
                                                         device="cpu"),
                      lambda: Embedding(16, 8, gen(), "cpu"), ids),
    }


@pytest.mark.parametrize("mp_degree", [1, 2])
@pytest.mark.parametrize("layer", ["column", "column_nobias", "row", "embedding"])
def test_world_one_layer_equals_dense(clean_env, layer, mp_degree):
    """Exact: in a world of 1 (after fleet.init with mp_degree 1 or 2) a
    model-parallel layer holds the whole weight, drawn as the dense
    module's, and its forward and gradients are the dense module's bits."""
    from paddle_tpu_torch.distributed import fleet
    fleet.init(is_collective=True,
               strategy=_strategy(fleet, mp=mp_degree), device="cpu")
    make_mp, make_dense, inp = _world_one_pairs()[layer]
    a, b = make_mp(), make_dense()
    assert [n for n, _ in a.named_parameters()] == \
        [n for n, _ in b.named_parameters()]
    for (_, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q)
    ya, yb = a(inp), b(inp)
    assert torch.equal(ya, yb)
    c = torch.randn(ya.shape, generator=torch.Generator().manual_seed(9))
    (ya * c).sum().backward()
    (yb * c).sum().backward()
    for (_, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p.grad, q.grad)


def test_world_one_models_and_ce_equal_dense(clean_env):
    """Exact: at world 1 under fleet.init(mp_degree=2) the models keep
    their plain modules and bits, and the parallel CE is the dense CE."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import meta_parallel as mpu
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.nn import Linear
    from paddle_tpu_torch.ops.fused_ce import vocab_parallel_ce_rows
    plain = [LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1),
                              device="cpu"),
             GPTForCausalLM(GPTConfig.tiny(num_hidden_layers=1), device="cpu")]
    fleet.init(is_collective=True, strategy=_strategy(fleet, mp=2),
               device="cpu")
    built = [LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1),
                              device="cpu"),
             GPTForCausalLM(GPTConfig.tiny(num_hidden_layers=1), device="cpu")]
    for a, b in zip(built, plain):
        assert a.mp_degree == 1 and isinstance(a.lm_head, Linear)
        sa, sb = a.state_dict(), b.state_dict()
        assert list(sa) == list(sb)
        assert all(torch.equal(sa[n], sb[n]) for n in sa)
    g = torch.Generator().manual_seed(5)
    logits = torch.randn(4, 7, 16, generator=g, requires_grad=True)
    labels = torch.randint(0, 16, (4, 7), generator=g)
    labels[0, 0] = -100
    got = mpu.ParallelCrossEntropy()(logits, labels)
    want, _, _ = vocab_parallel_ce_rows(logits.float(), labels)
    assert got.shape == (4, 7, 1) and torch.equal(got[..., 0], want)


MP_SIGNATURES = [
    "parallel_layers.mp_ops:_c_identity", "parallel_layers.mp_ops:_mp_allreduce",
    "parallel_layers.mp_ops:_c_concat", "parallel_layers.mp_ops:_c_split",
    "parallel_layers.mp_ops:_c_softmax_with_cross_entropy",
    "parallel_layers.mp_ops:split",
    "parallel_layers.mp_layers:VocabParallelEmbedding.__init__",
    "parallel_layers.mp_layers:ColumnParallelLinear.__init__",
    "parallel_layers.mp_layers:RowParallelLinear.__init__",
    "parallel_layers.mp_layers:ParallelCrossEntropy.__init__",
    "parallel_layers.mp_layers:ParallelCrossEntropy.forward",
    "parallel_layers.random:RNGStatesTracker.add",
    "parallel_layers.random:RNGStatesTracker.rng_state",
    "parallel_layers.random:model_parallel_random_seed",
    "parallel_layers.random:dropout",
    "meta_parallel_base:MetaParallelBase.__init__",
    "tensor_parallel:TensorParallel.forward",
    "../meta_optimizers.hybrid_parallel_optimizer:"
    "HybridParallelOptimizer.__init__",
    "../utils.hybrid_parallel_util:broadcast_input_data",
    "../utils.hybrid_parallel_util:broadcast_mp_parameters"]


@pytest.mark.parametrize("name", MP_SIGNATURES)
def test_reference_parameters_lead_in_order(name):
    """The reference's parameters come first in the port's signature, in
    its order, kinds and defaults; the port adds keyword-usable ones after
    them (`gen`, `device`). Exact."""
    import importlib
    import inspect
    mod, attrs = name.split(":")
    base = "distributed.fleet." + (mod[3:] if mod.startswith("../")
                                   else "meta_parallel." + mod)
    objs = []
    for pkg in ("paddle_tpu.", "paddle_tpu_torch."):
        obj = importlib.import_module(pkg + base)
        for a in attrs.split("."):
            obj = getattr(obj, a)
        objs.append(obj)
    ref, port = ([(p.name, p.kind, p.default)
                  for p in inspect.signature(f).parameters.values()]
                 for f in objs)
    assert port[:len(ref)] == ref, (name, ref, port)
    for pname, kind, _ in port[len(ref):]:
        assert kind in (inspect.Parameter.POSITIONAL_OR_KEYWORD,
                        inspect.Parameter.KEYWORD_ONLY), (name, pname)
