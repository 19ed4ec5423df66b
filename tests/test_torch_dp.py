"""Data parallelism in the port: `EagerReducer`, `DataParallel`, `fleet`
and the topology, against the reference (`paddle_tpu`).

In-process:
  - the reducer's mechanics, `tests/test_eager_reducer.py` and
    `test_eager_multiprocess.py::TestEagerReducerMechanics` replayed:
    buckets in reverse creation order under the cap (the reference's
    buckets, by position, for the same layers), a parameter never split,
    `requires_grad=False` left out, one all_reduce a bucket even with an
    extra `sync()`, `no_sync`, the int8 flush with error feedback (the
    gather patched to hand back two copies: flushed grad + residual equal
    the exact grad; the flushed grad and the residual equal the
    reference reducer's bit for bit), a stale residual dropped when the
    members change, int8 at world 1 exact, sparse gradients refused;
  - the topology (`CommunicateTopology`, `HybridCommunicateGroup`) equal
    to the reference's for several hybrid configurations, exactly;
  - `fleet`: the pipeline and sharding modes refused with their ROADMAP
    items (tensor parallel taken: `TensorParallel`,
    `HybridParallelOptimizer`), `mesh`, the parameter server;
  - BERT config 2 (`test_config2_bert_dp`: dp 8 in one process, so
    `DataParallel` passes through) through both packages' `fleet`, dropout
    on, drawn alike: losses within rtol 1e-5.

In processes (this file run as `python tests/test_torch_dp.py <mode>
...`, two ranks on gloo each):
  - "mlp": `tests/dp_worker.py` replayed: its MLP with the weights of the
    reference's `build_model()`, `paddle_tpu_torch.DataParallel`, SGD 0.1,
    5 steps on each rank's half of the batch; the final parameters within
    rtol 1e-5 / atol 1e-6 of the reference's one-process full-batch run;
    then `no_sync` (local gradients, no flush), the synced backward after
    it (the sum of both ranks' accumulations, exactly), an int8
    `grad_compress` wrapper (the ranks agree bit for bit; the int8 average
    plus the mean of the ranks' residuals is the exact average);
  - "bert": the slice on the CPU: `BertConfig.tiny()` with dropout 0 under
    `fleet.init(dp 2)` / `distributed_model` / `distributed_optimizer(
    AdamW)`, rank 1 starting from other weights until
    `broadcast_dp_parameters`; 3 steps on 4 rows each against the
    reference's one-process AdamW run on all 8 rows: the ranks' parameters
    equal bit for bit, each within atol 1e-5 of the reference's (the
    attention key biases within steps x lr: their gradient is zero in
    exact arithmetic, so Adam moves them by noise), the mean of the ranks'
    losses within rtol 1e-5 of the reference's.
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

MLP_STEPS, MLP_LR = 5, 0.1
BERT_STEPS, BERT_LR = 3, 1e-3


def _report(check, ok, err="", data=None):
    print("RESULT " + json.dumps(dict(check=check, ok=bool(ok), err=err,
                                      data=data)), flush=True)


def _mlp(device="cpu"):
    from paddle_tpu_torch.nn import Linear
    gen = torch.Generator().manual_seed(0)
    return torch.nn.Sequential(Linear(8, 16, gen, device), torch.nn.ReLU(),
                               Linear(16, 4, gen, device))


def _mlp_batch():
    rng = np.random.RandomState(7)
    X = rng.randn(8, 8).astype(np.float32)
    Y = rng.randn(8, 4).astype(np.float32)
    return X, Y


def _gathered(dist, t):
    out = []
    dist.all_gather(out, t.detach().contiguous())
    return out


def _mlp_worker(weights, out_path):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.convert import load_numpy_params
    from paddle_tpu_torch.optimizer import SGD
    env = dist.init_parallel_env(device="cpu")
    rank, world = env.rank, env.world_size
    arrays = dict(np.load(weights))
    model = paddle.DataParallel(load_numpy_params(_mlp(), arrays))
    _report("state_dict_names", list(model.state_dict()) == list(arrays)
            and [n for n, _ in model.named_parameters()] == list(arrays),
            str(list(model.state_dict())))
    opt = SGD(learning_rate=MLP_LR, parameters=model.parameters())
    X, Y = _mlp_batch()
    half = X.shape[0] // world
    xs = torch.from_numpy(X[rank * half:(rank + 1) * half])
    ys = torch.from_numpy(Y[rank * half:(rank + 1) * half])

    def loss_fn():
        return ((model(xs) - ys) ** 2).mean()

    for _ in range(MLP_STEPS):
        loss_fn().backward()
        opt.step()
        opt.clear_grad()
    red = model._reducer
    _report("flush_count", red.flushes == len(red.buckets) * MLP_STEPS,
            f"{red.flushes} flushes, {len(red.buckets)} buckets")
    if rank == 0:
        np.savez(out_path, **{k: v.detach().numpy()
                              for k, v in model.state_dict().items()})
    # no_sync: local gradients, nothing flushed
    flushes = red.flushes
    with model.no_sync():
        loss_fn().backward()
    local = [p.grad.clone() for p in model.parameters()]
    both = [_gathered(dist, g) for g in local]
    _report("no_sync_is_local", red.flushes == flushes and all(
        not torch.equal(a, b) for a, b in both), f"{red.flushes - flushes}")
    # the next synced backward averages the accumulated 2 g_r: g_0 + g_1
    loss_fn().backward()
    model.sync_gradients()          # nothing left: the hooks flushed all
    ok = red.flushes == flushes + len(red.buckets) and all(
        torch.equal(p.grad, a + b) for p, (a, b) in zip(model.parameters(),
                                                        both))
    _report("synced_after_no_sync", ok, f"{red.flushes - flushes}")
    opt.clear_grad()
    # int8 flushes: one answer on both ranks
    qmodel = paddle.DataParallel(load_numpy_params(_mlp(), arrays),
                                 grad_compress="int8", compress_chunk=16)
    exact = paddle.DataParallel(load_numpy_params(_mlp(), arrays))
    for m in (qmodel, exact):
        ((m(xs) - ys) ** 2).mean().backward()
    # error feedback's books: the exact average is the int8 average plus
    # the mean of the ranks' residuals (one bucket, its members in order)
    qred = qmodel._reducer
    assert len(qred.buckets) == 1
    res = sum(_gathered(dist, qred._ef_residual[0])) / 2
    ok, err, off = True, "", 0
    by_id = {id(p): n for n, p in qmodel.named_parameters()}
    exact_of = dict(zip(by_id.values(), exact.parameters()))
    for q in qred.buckets[0]:
        n, e = by_id[id(q)], exact_of[by_id[id(q)]]
        a, b = _gathered(dist, q.grad)
        part = res[off:off + q.numel()].view(q.shape)
        off += q.numel()
        if not torch.equal(a, b) or not torch.allclose(
                q.grad + part, e.grad, rtol=1e-5, atol=1e-6) or torch.equal(
                q.grad, e.grad):
            ok, err = False, n
    _report("int8_grad_compress", ok, err)
    dist.barrier()
    dist.destroy_process_group()


def _bert_cfg():
    from paddle_tpu_torch.models.bert import BertConfig
    return BertConfig.tiny(hidden_dropout_prob=0.0,
                           attention_probs_dropout_prob=0.0)


def _bert_batch():
    rng = np.random.RandomState(0)
    b, s, vocab = 8, 16, 256
    ids = rng.randint(0, vocab, (b, s)).astype(np.int64)
    labels = rng.randint(0, vocab, (b, s)).astype(np.int64)
    labels[:, ::2] = -100        # every row scores 8 tokens: equal halves
    am = np.ones((b, s), np.int64)
    am[1, 10:] = 0
    am[6, 5:] = 0
    return ids, am, labels


def _bert_worker(weights, out_dir):
    from paddle_tpu_torch.convert import load_numpy_params
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.utils import hybrid_parallel_util
    from paddle_tpu_torch.models.bert import BertForMaskedLM
    from paddle_tpu_torch.optimizer import AdamW
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 2, "mp_degree": 1,
                               "pp_degree": 1, "sharding_degree": 1}
    fleet.init(is_collective=True, strategy=strategy, device="cpu")
    hcg = fleet.get_hybrid_communicate_group()
    rank = hcg.get_data_parallel_rank()
    model = BertForMaskedLM(_bert_cfg(), device="cpu", seed=1 + rank)
    if rank == 0:
        load_numpy_params(model, dict(np.load(weights)))
    hybrid_parallel_util.broadcast_dp_parameters(model, hcg)
    model = fleet.distributed_model(model)
    opt = AdamW(BERT_LR, parameters=model.named_parameters())
    _report("distributed_optimizer_unchanged",
            fleet.distributed_optimizer(opt) is opt
            and hcg.get_parallel_mode() == "data_parallel")
    ids, am, labels = (torch.from_numpy(a[rank * 4:(rank + 1) * 4])
                       for a in _bert_batch())
    losses = []
    for _ in range(BERT_STEPS):
        loss = model(ids, attention_mask=am, labels=labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    red = model._reducer
    _report("bert_flush_count", red.flushes == len(red.buckets) * BERT_STEPS,
            f"{red.flushes} flushes, {len(red.buckets)} buckets",
            data=losses)
    torch.save({n: p.detach() for n, p in model.named_parameters()},
               os.path.join(out_dir, f"bert_rank{rank}.pt"))
    from paddle_tpu_torch import distributed as dist
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    torch.set_num_threads(1)
    {"mlp": _mlp_worker, "bert": _bert_worker}[sys.argv[1]](*sys.argv[2:])
    sys.exit(0)


# -- the tests ----------------------------------------------------------------
import pytest  # noqa: E402

import paddle_tpu as jpaddle  # noqa: E402


def _named(jm):
    for n, p in jm.named_parameters():
        p.name = n
    return jm


def _jax_bert():
    from paddle_tpu.models.bert import BertConfig as JaxConfig
    from paddle_tpu.models.bert import BertForMaskedLM as JaxMLM
    jpaddle.seed(5)
    return _named(JaxMLM(JaxConfig.tiny(hidden_dropout_prob=0.0,
                                        attention_probs_dropout_prob=0.0)))


def _mlp_reference():
    """`tests/dp_worker.py`'s one-process run over the full batch."""
    from paddle_tpu import optimizer as jopt
    import paddle_tpu.nn.functional as JF
    from dp_worker import build_model
    model = build_model()
    start = {k: np.asarray(v.data) for k, v in model.state_dict().items()}
    opt = jopt.SGD(learning_rate=MLP_LR, parameters=model.parameters())
    X, Y = _mlp_batch()
    xs, ys = jpaddle.to_tensor(X), jpaddle.to_tensor(Y)
    for _ in range(MLP_STEPS):
        JF.mse_loss(model(xs), ys).backward()
        opt.step()
        opt.clear_grad()
    return start, {k: np.asarray(v.data) for k, v in model.state_dict().items()}


def _bert_reference(jm):
    """The reference's one-process AdamW run over all 8 rows."""
    from paddle_tpu import optimizer as jopt
    opt = jopt.AdamW(BERT_LR, parameters=jm.parameters())
    ids, am, labels = _bert_batch()
    losses = []
    for _ in range(BERT_STEPS):
        loss = jm(jpaddle.to_tensor(ids), attention_mask=jpaddle.to_tensor(am),
                  labels=jpaddle.to_tensor(labels))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses, {n: np.asarray(p.data) for n, p in jm.named_parameters()}


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """Both 2-rank worlds, started together, while the reference runs its
    one-process versions here."""
    tmp = tmp_path_factory.mktemp("dp")
    mlp_start, _ = _mlp_reference()
    np.savez(tmp / "mlp_w.npz", **mlp_start)
    jm = _jax_bert()
    np.savez(tmp / "bert_w.npz", **{n: np.asarray(p.data)
                                    for n, p in jm.named_parameters()})
    held = []
    ports = [free_ports(2, held) for _ in range(2)]
    for s in held:
        s.close()
    me = os.path.abspath(__file__)
    worlds = {
        "mlp": spawn_world(me, "mlp", 2, ports[0],
                           (str(tmp / "mlp_w.npz"), str(tmp / "mlp_out.npz"))),
        "bert": spawn_world(me, "bert", 2, ports[1],
                            (str(tmp / "bert_w.npz"), str(tmp)))}
    _, mlp_ref = _mlp_reference()
    bert_ref = _bert_reference(jm)
    runs = {mode: join_world(p, timeout=150) for mode, p in worlds.items()}
    return dict(tmp=tmp, runs=runs, mlp_ref=mlp_ref, bert_ref=bert_ref)


def _checks(dp_runs, mode):
    runs = dp_runs["runs"][mode]
    logs = "\n".join(f"-- rank {r} rc {rc}\n{o[-3000:]}"
                     for r, (rc, o) in enumerate(runs))
    assert all(rc == 0 for rc, _ in runs), logs
    return results_by_check(runs), logs


def _rank_data(dp_runs, mode, check):
    out = {}
    for rank, (_, o) in enumerate(dp_runs["runs"][mode]):
        for line in o.splitlines():
            if line.startswith("RESULT "):
                r = json.loads(line[len("RESULT "):])
                if r["check"] == check:
                    out[rank] = r["data"]
    return out


@pytest.mark.parametrize("mode,check", [
    ("mlp", "state_dict_names"), ("mlp", "flush_count"),
    ("mlp", "no_sync_is_local"), ("mlp", "synced_after_no_sync"),
    ("mlp", "int8_grad_compress"), ("bert", "distributed_optimizer_unchanged"),
    ("bert", "bert_flush_count")])
def test_worker_checks(dp_runs, mode, check):
    got, logs = _checks(dp_runs, mode)
    assert sorted(got.get(check, {})) == [0, 1], f"{check}\n{logs}"
    bad = {r: e for r, (ok, e) in got[check].items() if not ok}
    assert not bad, f"{check}: {bad}"


def test_dp_worker_replay_matches_reference(dp_runs):
    """`test_eager_multiprocess.py::test_dp_matches_single_process` on
    the port: 2 processes against the reference's one-process run."""
    _checks(dp_runs, "mlp")
    got = np.load(dp_runs["tmp"] / "mlp_out.npz")
    want = dp_runs["mlp_ref"]
    assert sorted(got.files) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_bert_dp_ranks_equal_bit_for_bit(dp_runs):
    _checks(dp_runs, "bert")
    p0 = torch.load(dp_runs["tmp"] / "bert_rank0.pt")
    p1 = torch.load(dp_runs["tmp"] / "bert_rank1.pt")
    assert list(p0) == list(p1)
    for n in p0:
        assert torch.equal(p0[n], p1[n]), n


def test_bert_dp_matches_one_process_reference(dp_runs):
    _checks(dp_runs, "bert")
    ref_losses, ref_params = dp_runs["bert_ref"]
    params = torch.load(dp_runs["tmp"] / "bert_rank0.pt")
    assert list(params) == list(ref_params)
    for name, p in params.items():
        atol = BERT_STEPS * BERT_LR if name.endswith("k_proj.bias") else 1e-5
        np.testing.assert_allclose(p.numpy(), ref_params[name], rtol=0,
                                   atol=atol, err_msg=name)
    losses = _rank_data(dp_runs, "bert", "bert_flush_count")
    mean = (np.asarray(losses[0]) + np.asarray(losses[1])) / 2
    np.testing.assert_allclose(mean, ref_losses, rtol=1e-5)
    assert ref_losses[-1] < ref_losses[0]


# -- the reducer, in one process ------------------------------------------------
def _linears(sizes, pkg="torch"):
    """One bias-free Linear per size, creation order = list order."""
    if pkg == "torch":
        from paddle_tpu_torch.nn import Linear
        gen = torch.Generator().manual_seed(0)
        return [Linear(s, s, gen, "cpu", bias=False) for s in sizes]
    from paddle_tpu import nn as jnn
    jpaddle.seed(0)
    return [jnn.Linear(s, s, bias_attr=False) for s in sizes]


def _group(gid, ranks):
    from paddle_tpu_torch.distributed.collective import Group
    return Group(ranks.index(0), gid, ranks)


def _reducer(params, **kw):
    from paddle_tpu_torch.distributed.reducer import EagerReducer
    return EagerReducer(params, **kw)


@pytest.mark.parametrize("sizes,cap", [((4, 8, 4, 8), 320), ((16, 2), 64),
                                       ((4, 4, 4), 128), ((3, 5, 7, 2), 100),
                                       ((8,), 1 << 20)])
def test_buckets_equal_the_reference(sizes, cap):
    from paddle_tpu.distributed.collective import Group as JGroup
    from paddle_tpu.distributed.reducer import EagerReducer as JReducer
    tl = _linears(sizes)
    jl = _linears(sizes, "jax")
    red = _reducer([l.weight for l in tl], bucket_bytes=cap,
                   group=_group(90, [0]))
    jred = JReducer([l.weight for l in jl], bucket_bytes=cap,
                    group=JGroup(0, 90, [0]))
    tpos = {id(l.weight): i for i, l in enumerate(tl)}
    jpos = {id(l.weight): i for i, l in enumerate(jl)}
    assert [[tpos[id(p)] for p in b] for b in red.buckets] == \
        [[jpos[id(p)] for p in b] for b in jred.buckets]
    red.remove()
    jred._remove_cb()


def test_reverse_creation_order_and_size_cap():
    params = [l.weight for l in _linears([4, 8, 4, 8])]
    red = _reducer(params, bucket_bytes=320, group=_group(90, [0]))
    assert [[id(p) for p in b] for b in red.buckets] == \
        [[id(params[3]), id(params[2])], [id(params[1]), id(params[0])]]
    red.remove()


def test_cap_is_not_split_mid_param():
    params = [l.weight for l in _linears([16, 2])]
    red = _reducer(params, bucket_bytes=64, group=_group(91, [0]))
    assert [[id(p) for p in b] for b in red.buckets] == \
        [[id(params[1])], [id(params[0])]]
    red.remove()


def test_frozen_params_excluded():
    layers = _linears([4, 4])
    layers[0].weight.requires_grad_(False)
    red = _reducer([l.weight for l in layers], bucket_bytes=1 << 20,
                   group=_group(92, [0]))
    assert sum(len(b) for b in red.buckets) == 1
    red.remove()


def test_single_allreduce_per_bucket_even_with_extra_sync(monkeypatch):
    import paddle_tpu_torch.distributed.reducer as red_mod
    calls = []
    real = red_mod.all_reduce

    def counting(t, *a, **kw):
        calls.append(tuple(t.shape))
        return real(t, *a, **kw)

    monkeypatch.setattr(red_mod, "all_reduce", counting)
    layers = _linears([4, 4, 4])
    model = torch.nn.Sequential(*layers)
    red = _reducer([l.weight for l in layers], bucket_bytes=128,
                   group=_group(93, [0]))
    assert len(red.buckets) > 1
    x = torch.randn(2, 4, generator=torch.Generator().manual_seed(1))
    (model(x) ** 2).sum().backward()      # hooks flush every bucket
    red.sync()                             # extra: a no-op
    assert len(calls) == len(red.buckets) == red.flushes
    # a second backward flushes each bucket once more
    (model(x) ** 2).sum().backward()
    assert len(calls) == 2 * len(red.buckets)
    red.remove()


def test_grads_round_trip_a_group_of_one():
    layers = _linears([8, 8])
    model = torch.nn.Sequential(layers[0], torch.nn.ReLU(), layers[1])
    red = _reducer(list(model.parameters()), bucket_bytes=128,
                   group=_group(99, [0]))
    assert len(red.buckets) > 1
    x = torch.randn(4, 8, generator=torch.Generator().manual_seed(2))
    red.enabled = False
    (model(x) ** 2).sum().backward()
    ref = [p.grad.clone() for p in model.parameters()]
    model.zero_grad(set_to_none=True)
    red.enabled = True
    (model(x) ** 2).sum().backward()
    assert all(red._flushed) or not any(red._ready)
    for p, r in zip(model.parameters(), ref):
        assert torch.equal(p.grad, r)
    red.remove()


def test_no_sync_suppresses_flush():
    layers = _linears([4])
    red = _reducer([layers[0].weight], bucket_bytes=1 << 20,
                   group=_group(98, [0]))
    red.enabled = False
    layers[0](torch.randn(2, 4)).sum().backward()
    assert not any(red._flushed) and red.flushes == 0
    red.remove()


def _patch_two_copies(monkeypatch):
    import paddle_tpu_torch.distributed.collective as coll
    monkeypatch.setattr(coll, "_require_initialized_multiproc",
                        lambda verb: None)
    monkeypatch.setattr(coll, "_process_gather",
                        lambda t, group: torch.stack([t, t]))


def test_int8_flush_with_error_feedback_recovers_exactly(monkeypatch):
    from paddle_tpu_torch.distributed.comm_compress import quantize_int8
    _patch_two_copies(monkeypatch)
    layers = _linears([8])
    red = _reducer([layers[0].weight], bucket_bytes=1 << 20,
                   group=_group(94, [0, 1]), compress="int8",
                   compress_chunk=16)
    x = torch.randn(2, 8, generator=torch.Generator().manual_seed(3))
    red.enabled = False
    (layers[0](x) ** 2).sum().backward()
    ref = layers[0].weight.grad.clone()
    layers[0].weight.grad = None
    red.enabled = True
    (layers[0](x) ** 2).sum().backward()
    got = layers[0].weight.grad
    err = red._ef_residual[0].reshape(got.shape)
    assert bool((err != 0).any())
    np.testing.assert_allclose((got + err).numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-6)
    _, s, _ = quantize_int8(ref.reshape(-1), chunk=16)
    bound = np.repeat(s.numpy() * 0.5 + 1e-6, 16)[:ref.numel()]
    assert np.all(np.abs((got - ref).numpy()).reshape(-1) <= bound)
    red.remove()


def test_int8_flush_bit_equal_to_the_reference(monkeypatch):
    """The same gradient through both reducers' compressed flush (two
    flushes, the second with the first's residual): grad and residual bit
    for bit."""
    import paddle_tpu.distributed.collective as jcoll
    from paddle_tpu.distributed.collective import Group as JGroup
    from paddle_tpu.distributed.reducer import EagerReducer as JReducer
    from paddle_tpu.tensor.tensor import Tensor as JTensor
    _patch_two_copies(monkeypatch)
    monkeypatch.setattr(jcoll, "_require_initialized_multiproc",
                        lambda verb: None)
    monkeypatch.setattr(jcoll, "_process_gather",
                        lambda arr, group: np.stack([arr, arr]))
    tl, jl = _linears([6, 5]), _linears([6, 5], "jax")
    red = _reducer([l.weight for l in tl], bucket_bytes=1 << 20,
                   group=_group(95, [0, 1]), compress="int8",
                   compress_chunk=8)
    jred = JReducer([l.weight for l in jl], bucket_bytes=1 << 20,
                    group=JGroup(0, 95, [0, 1]), compress="int8",
                    compress_chunk=8)
    rng = np.random.RandomState(4)
    for _ in range(2):
        grads = [rng.randn(6, 6).astype(np.float32) * 3,
                 rng.randn(5, 5).astype(np.float32) * 1e-3]
        for layers, wrap in ((tl, torch.from_numpy),
                             (jl, lambda a: JTensor(a, stop_gradient=True))):
            for l, g in zip(layers, grads):
                l.weight.grad = wrap(g.copy())
        red._flushed[0] = False
        red._flush_bucket(0)
        jred._flushed[0] = False
        jred._flush_bucket(0)
        for t, j in zip(tl, jl):
            assert t.weight.grad.numpy().view(np.uint32).tolist() == \
                np.asarray(j.weight.grad.numpy()).view(np.uint32).tolist()
        assert red._ef_residual[0].numpy().view(np.uint32).tolist() == \
            np.asarray(jred._ef_residual[0]).view(np.uint32).tolist()
    red.remove()
    jred._remove_cb()


def test_stale_residual_not_applied_across_member_changes(monkeypatch):
    _patch_two_copies(monkeypatch)
    layers = _linears([4, 4])
    red = _reducer([l.weight for l in layers], bucket_bytes=1 << 20,
                   group=_group(96, [0, 1]), compress="int8",
                   compress_chunk=8)
    assert len(red.buckets) == 1 and len(red.buckets[0]) == 2
    rng = np.random.RandomState(1)
    g1 = rng.randn(4, 4).astype(np.float32)
    g2 = rng.randn(4, 4).astype(np.float32)
    red.buckets[0][0].grad = torch.from_numpy(g1.copy())
    red.buckets[0][1].grad = None
    red._flush_bucket(0)
    assert bool((red._ef_residual[0] != 0).any())
    red.buckets[0][0].grad = None
    red.buckets[0][1].grad = torch.from_numpy(g2.copy())
    red._flushed[0] = False
    red._flush_bucket(0)
    got = red.buckets[0][1].grad
    err = red._ef_residual[0].reshape(got.shape)
    np.testing.assert_allclose((got + err).numpy(), g2, rtol=1e-5, atol=1e-6)
    red.remove()


def test_world_one_compress_is_exact_noop():
    layers = _linears([4])
    red = _reducer([layers[0].weight], bucket_bytes=1 << 20,
                   group=_group(97, [0]), compress="int8")
    x = torch.randn(2, 4, generator=torch.Generator().manual_seed(5))
    red.enabled = False
    (layers[0](x) ** 2).sum().backward()
    ref = layers[0].weight.grad.clone()
    layers[0].weight.grad = None
    red.enabled = True
    (layers[0](x) ** 2).sum().backward()
    assert torch.equal(layers[0].weight.grad, ref)
    assert not red._ef_residual
    red.remove()


def test_bad_compress_and_sparse_gradients_refused():
    from paddle_tpu_torch.distributed.reducer import SparseGradientError
    with pytest.raises(ValueError, match="compress"):
        _reducer([], compress="fp8")
    emb = torch.nn.Embedding(10, 4, sparse=True)
    red = _reducer([emb.weight], group=_group(89, [0]))
    with pytest.raises(SparseGradientError, match="A9.1"):
        emb(torch.tensor([1, 2])).sum().backward()
    red.remove()
    from paddle_tpu_torch.distributed import DataParallel
    with pytest.raises(ValueError, match="grad_compress"):
        DataParallel(torch.nn.Linear(2, 2), grad_compress="fp16")


def test_data_parallel_passes_through_at_world_one():
    from paddle_tpu_torch import DataParallel
    from paddle_tpu_torch.convert import load_numpy_params
    m = _mlp()
    dp = DataParallel(m)
    assert dp._reducer is None
    assert [n for n, _ in dp.named_parameters()] == \
        [n for n, _ in m.named_parameters()]
    assert list(dp.state_dict()) == list(m.state_dict())
    assert all(a is b for a, b in zip(dp.parameters(), m.parameters()))
    arrays = {n: np.full(p.shape, 0.5, np.float32)
              for n, p in m.named_parameters()}
    load_numpy_params(dp, arrays)
    assert torch.equal(m[0].weight, torch.full((8, 16), 0.5))
    x = torch.randn(3, 8)
    assert torch.equal(dp(x), m(x))
    with dp.no_sync():
        dp(x).sum().backward()
    dp.sync_gradients()
    dp.apply_collective_grads()
    assert dp.scale_loss(x) is x


# -- topology and fleet --------------------------------------------------------
HYBRID = [(1, 1, 1, 1), (8, 1, 1, 1), (2, 2, 1, 2), (1, 2, 2, 2),
          (2, 1, 4, 1), (1, 1, 1, 8), (2, 2, 2, 1), (3, 1, 2, 1)]


@pytest.mark.parametrize("dims", HYBRID)
def test_topology_equals_the_reference(dims):
    from paddle_tpu.distributed.topology import CommunicateTopology as JTopo
    from paddle_tpu_torch.distributed.topology import CommunicateTopology
    names = ("data", "pipe", "sharding", "model")
    t, j = CommunicateTopology(names, dims), JTopo(names, dims)
    assert t.world_size() == j.world_size()
    for n in names:
        assert t.get_dim(n) == j.get_dim(n)
        assert t.get_comm_list(n) == j.get_comm_list(n)
        for i in range(t.get_dim(n)):
            assert t.get_axis_list(n, i) == j.get_axis_list(n, i)
    for r in range(t.world_size()):
        assert tuple(t.get_coord(r)) == tuple(j.get_coord(r))
        assert t.get_rank(**t.get_coord(r)._asdict()) == r
        for s in range(t.get_dim("pipe")):
            assert t.get_rank_from_stage(r, pipe=s) == \
                j.get_rank_from_stage(r, pipe=s)


@pytest.mark.parametrize("dims", HYBRID + [(2, 1, 1, 1, 2)])
def test_hybrid_communicate_group_equals_the_reference(dims):
    from paddle_tpu.distributed.topology import (
        CommunicateTopology as JTopo, HybridCommunicateGroup as JHCG)
    from paddle_tpu_torch.distributed.topology import (
        CommunicateTopology, HybridCommunicateGroup)
    names = ("data", "pipe", "sharding", "model", "sep")[:len(dims)]
    h = HybridCommunicateGroup(CommunicateTopology(names, dims))
    j = JHCG(JTopo(names, dims))
    for get in ("get_parallel_mode", "get_global_rank",
                "get_data_parallel_rank", "get_data_parallel_world_size",
                "get_data_parallel_group_src_rank", "get_model_parallel_rank",
                "get_model_parallel_world_size",
                "get_model_parallel_group_src_rank", "get_stage_id",
                "get_pipe_parallel_world_size", "is_first_stage",
                "is_last_stage", "get_sharding_parallel_rank",
                "get_sharding_parallel_world_size",
                "get_sharding_parallel_group_src_rank",
                "get_sep_parallel_rank", "get_sep_parallel_world_size"):
        assert getattr(h, get)() == getattr(j, get)(), get
    for get in ("get_data_parallel_group", "get_model_parallel_group",
                "get_pipe_parallel_group", "get_sharding_parallel_group",
                "get_check_parallel_group"):
        assert getattr(h, get)().ranks == getattr(j, get)().ranks, get
    assert (h.prev_rank, h.next_rank) == (j.prev_rank, j.next_rank)
    assert h.get_rank_from_stage(0) == j.get_rank_from_stage(0)


@pytest.fixture
def clean_env():
    from paddle_tpu_torch import distributed as dist
    dist.destroy_process_group()
    yield
    dist.destroy_process_group()


def _strategy(fleet, dp=1, mp=1, pp=1, sharding=1):
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "mp_degree": mp, "pp_degree": pp,
                        "sharding_degree": sharding}
    return s


@pytest.mark.parametrize("degrees,item", [(dict(mp=2), "A8.5"),
                                          (dict(pp=2), "A8.7"),
                                          (dict(sharding=2), "A8.8")])
def test_fleet_refuses_unported_modes(clean_env, degrees, item):
    """The pipeline (A8.7) and sharding (A8.8) modes are refused. The
    tensor-parallel mode (A8.5) is ported: its case now checks that
    `distributed_model` gives `TensorParallel` and `distributed_optimizer`
    `HybridParallelOptimizer`. Every case refuses `fleet.mesh` (A8.10)."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import meta_optimizers
    from paddle_tpu_torch.distributed.fleet import meta_parallel
    fleet.init(is_collective=True, strategy=_strategy(fleet, **degrees),
               device="cpu")
    if item == "A8.5":
        assert isinstance(fleet.distributed_model(_mlp()),
                          meta_parallel.TensorParallel)
        assert isinstance(fleet.distributed_optimizer(object()),
                          meta_optimizers.HybridParallelOptimizer)
    else:
        with pytest.raises(fleet.FleetModeError, match=item):
            fleet.distributed_model(_mlp())
        with pytest.raises(fleet.FleetModeError, match=item):
            fleet.distributed_optimizer(object())
    with pytest.raises(fleet.FleetModeError, match="A8.10"):
        fleet.fleet_instance.mesh


def test_fleet_data_parallel_and_refusals(clean_env):
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.utils import hybrid_parallel_util
    with pytest.raises(fleet.FleetModeError, match="A8.12"):
        fleet.init(is_collective=False)
    fleet.init(is_collective=True, strategy=_strategy(fleet), device="cpu")
    assert fleet.fleet_instance.mesh is None
    assert fleet.worker_num() == 1 and fleet.worker_index() == 0
    assert fleet.is_first_worker() and dist.get_backend() is None
    hcg = fleet.get_hybrid_communicate_group()
    assert hcg.get_parallel_mode() == "data_parallel"
    dp = fleet.distributed_model(_mlp())
    assert isinstance(dp, dist.DataParallel) and dp._reducer is None
    opt = object()
    assert fleet.distributed_optimizer(opt) is opt
    with pytest.raises(fleet.FleetModeError, match="A8.12"):
        fleet.fleet_instance.init_server()
    # the other axes' glue: nothing to do at degree 1, refused above
    hybrid_parallel_util.broadcast_mp_parameters(dp, hcg)
    hybrid_parallel_util.broadcast_dp_parameters(dp, hcg)
    hybrid_parallel_util.fused_allreduce_gradients(list(dp.parameters()), hcg)
    # in a world of 1 the model-parallel group has one member whatever
    # mp_degree says: the mp broadcasts pass through; sharding above 1
    # stays refused (A8.8)
    fleet.init(is_collective=True, strategy=_strategy(fleet, mp=2),
               device="cpu")
    hcg = fleet.get_hybrid_communicate_group()
    hybrid_parallel_util.broadcast_mp_parameters(dp, hcg)
    assert hybrid_parallel_util.broadcast_input_data(hcg, 1, 2) == (1, 2)
    fleet.init(is_collective=True, strategy=_strategy(fleet, sharding=2),
               device="cpu")
    with pytest.raises(hybrid_parallel_util.HybridAxisError, match="A8.8"):
        hybrid_parallel_util.broadcast_sharding_parameters(
            dp, fleet.get_hybrid_communicate_group())


def _pallas_interpret(mp):
    from paddle_tpu.ops.pallas import flash_attention as jfa
    mp.setitem(jfa._dropout_flash_cache, 0.1, jfa.make_flash_attention(
        bq=16, bk=16, interpret=True, dropout_p=0.1))
    mp.setattr(jfa, "_default_flash",
               jfa.make_flash_attention(bq=16, bk=16, interpret=True))


def _config2_batch():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 256, (4, 16))
    labels = rng.randint(0, 256, (4, 16))
    labels[:, ::2] = -100
    return ids, labels


@pytest.fixture(scope="module")
def config2_reference():
    """`test_acceptance_configs.py::test_config2_bert_dp` on the
    reference's fleet (dp 8, one process): 3 AdamW(1e-3) steps, dropout on
    (Pallas sdpa, interpret builds) after paddle.seed(3); its global
    generator restored."""
    from paddle_tpu import optimizer as jopt
    from paddle_tpu.distributed import fleet as jfleet
    from paddle_tpu.framework import random as jrnd
    from paddle_tpu.models.bert import BertConfig as JaxConfig
    from paddle_tpu.models.bert import BertForMaskedLM as JaxMLM
    from paddle_tpu.ops import force_backend
    ids, labels = _config2_batch()
    jfleet.init(is_collective=True, strategy=_strategy(jfleet, dp=8))
    jpaddle.seed(1)
    jm = _named(JaxMLM(JaxConfig.tiny()))
    arrays = {n: np.asarray(p.data) for n, p in jm.named_parameters()}
    jmodel = jfleet.distributed_model(jm)
    jo = jfleet.distributed_optimizer(jopt.AdamW(
        1e-3, parameters=jmodel.parameters()))
    ref = []
    saved = jrnd.get_rng_state()
    try:
        with pytest.MonkeyPatch.context() as mp:
            _pallas_interpret(mp)
            jpaddle.seed(3)
            with force_backend("pallas"):
                for _ in range(3):
                    loss = jmodel(jpaddle.to_tensor(ids),
                                  labels=jpaddle.to_tensor(labels))
                    loss.backward()
                    jmodel.sync_gradients()
                    jo.step()
                    jo.clear_grad()
                    ref.append(float(loss))
    finally:
        jrnd.set_rng_state(saved)
    return arrays, ref


def test_config2_through_fleet_matches_reference(clean_env,
                                                 config2_reference):
    """Config 2 through the port's fleet (dp 8, one process: DataParallel
    passes through), the global generator seeded as the reference's: the
    losses within rtol 1e-5 of the reference's."""
    from paddle_tpu_torch.convert import load_numpy_params
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.framework import random as R
    from paddle_tpu_torch.models.bert import BertConfig, BertForMaskedLM
    from paddle_tpu_torch.optimizer import AdamW
    arrays, ref = config2_reference
    ids, labels = _config2_batch()
    fleet.init(is_collective=True, strategy=_strategy(fleet, dp=8),
               device="cpu")
    tm = load_numpy_params(BertForMaskedLM(BertConfig.tiny(), device="cpu"),
                           arrays)
    model = fleet.distributed_model(tm)
    assert model._reducer is None
    opt = fleet.distributed_optimizer(AdamW(
        1e-3, parameters=model.named_parameters()))
    R.seed(3)
    losses = []
    for _ in range(3):
        loss = model(torch.from_numpy(ids), labels=torch.from_numpy(labels))
        loss.backward()
        model.sync_gradients()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    np.testing.assert_allclose(losses, ref, rtol=1e-5)
    assert losses[-1] < losses[0]
