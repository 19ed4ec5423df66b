"""The port's eager collective stack (`paddle_tpu_torch.distributed`) on
gloo, in real processes on the CPU.

The workers are this file run as `python tests/test_torch_collective.py
<mode>` (PADDLE_TRAINER_ID / PADDLE_TRAINERS_NUM / MASTER_ADDR /
MASTER_PORT in their environment, `init_parallel_env(device="cpu")`): each
runs named checks and prints one `RESULT {json}` line a check, and the
module fixtures spawn every world at once and join them with a timeout.

  - "verbs2" (2 ranks): the replay of `tests/collective_worker.py` with
    its exact expected values (reduce_scatter, alltoall,
    all_to_all_single, broadcast, scatter, send / recv,
    batch_isend_irecv, the object collectives), then the port's own:
    every ReduceOp on f32 and int64 (exact), all_gather and
    all_gather_into_tensor, the int8 all-reduce (equal to the dequantized
    rows summed in rank order), sync_op=False handles, the stream
    namespace, isend / irecv, barrier, the gloo store tier
    (`gloo_init_parallel_env` / `gloo_barrier`); rank 0 arms
    `dist.store_init` once before init, and the connect retries;
  - "sub3" (3 ranks): the replay of `tests/subgroup_worker.py`: the
    subgroup {0, 2} (all_reduce, all_gather, broadcast from rank 2, an
    object collective), the non-member's "not a member" error, a
    heterogeneous all_to_all_single over the world, a world object
    collective after the subgroup traffic;
  - "badinit" (2 ranks): the backend rule patched to NCCL, which this
    CPU-only torch lacks: init_parallel_env raises the NCCL failure, and
    nothing is left initialised (no second backend is tried);
  - "badinit_slow" (2 ranks): the same, with rank 1's store reads delayed
    by a second, so rank 0 fails its init while rank 1 still reads its
    rendezvous keys: rank 0 must keep the store up until rank 1 has
    posted its own failure, and both raise the NCCL error.

In-process: the backend rule, the uninitialised raise, the mesh-axis
refusal, `split`, the int8 all-reduce bit for bit against the reference's
on the same rank payloads, `wire_bytes`, and the signatures of the
distributed API (the reference's parameters lead, in its order).
"""
import json
import os
import random
import socket
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


_PORTS = random.Random(os.getpid())


def free_ports(n, held):
    """A port p with p .. p + n - 1 all free; their bound sockets go into
    `held` (close them just before the ranks start), so worlds started
    together never share a port. p is drawn below the kernel's ephemeral
    range, which other processes' `bind(0)` sockets come from: a port
    closed here is not handed to a neighbour before a rank binds it."""
    while True:
        p = _PORTS.randrange(20000, 32000 - n)
        socks = []
        try:
            for k in range(n):
                t = socket.socket()
                socks.append(t)
                t.bind(("127.0.0.1", p + k))
        except OSError:
            for t in socks:
                t.close()
            continue
        held.extend(socks)
        return p


def spawn_world(script, mode, world, port, extra=()):
    """Start `world` ranks of `python script mode *extra` with MASTER_PORT
    `port` (the store on port + 1); returns the Popen list (join with
    `join_world`)."""
    procs = []
    for rank in range(world):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("PADDLE_", "FLAGS_"))}
        env.update(PADDLE_TRAINERS_NUM=str(world), PADDLE_TRAINER_ID=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   PYTHONPATH=ROOT + os.pathsep + env.get("PYTHONPATH", ""),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, script, mode, *extra], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def join_world(procs, timeout=120):
    """Wait for every rank (killing them all past `timeout`); returns
    [(returncode, output)] in rank order."""
    out = []
    for p in procs:
        try:
            o, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            o, _ = p.communicate()
        out.append((p.returncode, o))
    return out


def results_by_check(runs):
    """{check: {rank: (ok, err)}} from the ranks' RESULT lines."""
    got = {}
    for rank, (_, out) in enumerate(runs):
        for line in out.splitlines():
            if line.startswith("RESULT "):
                r = json.loads(line[len("RESULT "):])
                got.setdefault(r["check"], {})[rank] = (r["ok"], r["err"])
    return got


# -- the workers ----------------------------------------------------------------
def _t(x, dtype=torch.float32):
    return torch.tensor(x, dtype=dtype)


def _eq(a, b):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _verbs2_checks(dist, rank):
    from paddle_tpu_torch.distributed import communication, comm_compress
    other = 1 - rank
    checks = []

    def check(fn):
        checks.append(fn)
        return fn

    @check
    def backend_and_world():
        assert dist.get_backend() == "gloo", dist.get_backend()
        assert dist.get_world_size() == 2 and dist.get_rank() == rank
        assert dist.is_initialized() and dist.get_store() is not None

    # -- collective_worker.py, the reference's expected values --------------
    @check
    def reduce_scatter():
        out = torch.zeros(2)
        dist.reduce_scatter(out, torch.full((4,), float(rank + 1)))
        _eq(out, [3.0, 3.0])

    @check
    def alltoall():
        outs = []
        dist.alltoall(outs, [_t([rank * 10 + j]) for j in range(2)])
        _eq([float(t[0]) for t in outs], [0 * 10 + rank, 1 * 10 + rank])

    @check
    def all_to_all_single():
        out = torch.zeros(2)
        dist.all_to_all_single(out, _t([rank * 10, rank * 10 + 1]))
        _eq(out, [rank, 10 + rank])

    @check
    def broadcast():
        t = torch.full((3,), float(rank))
        dist.broadcast(t, src=1)
        _eq(t, [1.0, 1.0, 1.0])

    @check
    def scatter():
        tgt = torch.zeros(2)
        if rank == 0:
            dist.scatter(tgt, [_t([5.0, 5.0]), _t([7.0, 7.0])], src=0)
            _eq(tgt, [5.0, 5.0])
        else:
            dist.scatter(tgt, src=0)
            _eq(tgt, [7.0, 7.0])

    @check
    def send_recv():
        if rank == 0:
            dist.send(_t([42.0]), dst=1)
        else:
            buf = torch.zeros(1)
            dist.recv(buf, src=0)
            _eq(buf, [42.0])

    @check
    def batch_isend_irecv():
        sbuf, rbuf = _t([float(rank)]), torch.zeros(1)
        tasks = dist.batch_isend_irecv([dist.P2POp(dist.isend, sbuf, other),
                                        dist.P2POp(dist.irecv, rbuf, other)])
        _eq(rbuf, [other])
        assert len(tasks) == 1 and tasks[0].wait()

    @check
    def all_gather_object():
        objs = []
        dist.all_gather_object(objs, {"rank": rank, "tag": "x" * (rank + 1)})
        assert objs == [{"rank": 0, "tag": "x"}, {"rank": 1, "tag": "xx"}], objs

    @check
    def broadcast_object_list():
        lst = [{"seed": 123, "rank": rank}] if rank == 0 else [None]
        dist.broadcast_object_list(lst, src=0)
        assert lst == [{"seed": 123, "rank": 0}], lst

    @check
    def scatter_object_list():
        outl = []
        dist.scatter_object_list(
            outl, [f"part{j}" for j in range(2)] if rank == 0 else None, src=0)
        assert outl == [f"part{rank}"], outl

    # -- the port's own ------------------------------------------------------
    @check
    def all_reduce_float_ops():
        x = [_t([1.0, -2.0, 3.5]), _t([4.0, 5.0, -0.25])]
        want = {dist.ReduceOp.SUM: [5.0, 3.0, 3.25],
                dist.ReduceOp.MAX: [4.0, 5.0, 3.5],
                dist.ReduceOp.MIN: [1.0, -2.0, -0.25],
                dist.ReduceOp.PROD: [4.0, -10.0, -0.875],
                dist.ReduceOp.AVG: [2.5, 1.5, 1.625]}
        for op, w in want.items():
            t = x[rank].clone()
            assert dist.all_reduce(t, op=op) is t
            _eq(t, np.asarray(w, np.float32))

    @check
    def all_reduce_int64_exact():
        big = 2 ** 40
        t = torch.tensor([big + 3 * rank, 7 + rank, -7 - 2 * rank])
        s = t.clone()
        dist.all_reduce(s)
        _eq(s, [2 * big + 3, 15, -16])
        a = t.clone()
        dist.all_reduce(a, op=dist.ReduceOp.AVG)      # truncated toward 0
        _eq(a, [big + 1, 7, -8])
        assert a.dtype == torch.int64

    @check
    def reduce_is_all_reduce():
        t = _t([float(rank + 1)])
        dist.reduce(t, dst=0)
        _eq(t, [3.0])

    @check
    def reduce_scatter_avg_list():
        out = torch.zeros(1)
        dist.reduce_scatter(out, [_t([rank + 1.0]), _t([rank + 3.0])],
                            op=dist.ReduceOp.AVG)
        _eq(out, [1.5 if rank == 0 else 3.5])

    @check
    def all_gather_and_into_tensor():
        lst = []
        dist.all_gather(lst, _t([[rank * 100.0, rank + 0.5]]))
        _eq(torch.cat(lst), [[0.0, 0.5], [100.0, 1.5]])
        cat = dist.all_gather_into_tensor(_t([[rank, rank]]), concat_axis=1)
        _eq(cat, [[0.0, 0.0, 1.0, 1.0]])

    @check
    def alltoall_int64():
        outs = []
        dist.alltoall(outs, [torch.tensor([2 ** 50 + rank * 10 + j])
                             for j in range(2)])
        _eq(torch.cat(outs), [2 ** 50 + rank, 2 ** 50 + 10 + rank])

    @check
    def all_reduce_int8():
        rows = [np.random.RandomState(10 + r).randn(700).astype(np.float32)
                for r in range(2)]
        t = torch.from_numpy(rows[rank].copy())
        dist.all_reduce(t, compress="int8", compress_chunk=64)
        want = sum(comm_compress.dequantize_int8(
            *comm_compress.quantize_int8(torch.from_numpy(x), 64))
            for x in rows)
        _eq(t, want.numpy())
        a = torch.from_numpy(rows[rank].copy())
        dist.all_reduce(a, op=dist.ReduceOp.AVG, compress="int8",
                        compress_chunk=64)
        _eq(a, (want / torch.full((), 2.0)).numpy())

    @check
    def async_handles():
        t = _t([float(rank)])
        work = dist.all_reduce(t, sync_op=False)
        assert work.wait()
        _eq(t, [1.0])
        a = _t([float(rank) + 2.0])
        task = dist.all_reduce(a, op=dist.ReduceOp.AVG, sync_op=False)
        task.wait()
        _eq(a, [2.5])
        b = _t([float(rank)])
        dist.broadcast(b, src=0, sync_op=False).wait()
        _eq(b, [0.0])

    @check
    def stream_namespace():
        t = _t([rank + 1.0])
        communication.stream.all_reduce(t, use_calc_stream=True)
        _eq(t, [3.0])
        w = communication.stream.all_reduce(_t([1.0]), sync_op=False,
                                            use_calc_stream=False)
        assert w.wait()
        assert communication.all_reduce is dist.all_reduce

    @check
    def isend_irecv():
        if rank == 0:
            dist.isend(_t([[1.0, 2.0]]), dst=1).wait()
        else:
            buf = torch.zeros(1, 2)
            dist.irecv(buf, src=0).wait()
            _eq(buf, [[1.0, 2.0]])

    @check
    def world_group_is_the_default_group():
        g = dist.new_group([0, 1])
        assert g.pg is None and g.rank == rank and g.nranks == 2
        t = _t([float(rank)])
        dist.all_reduce(t, group=g)
        _eq(t, [1.0])
        one = dist.new_group([rank])
        u = _t([5.0])
        dist.all_reduce(u, group=one)      # a group of one: untouched
        _eq(u, [5.0])

    @check
    def gloo_store_tier():
        from paddle_tpu_torch.distributed import parallel_with_gloo as pg
        ep = f"127.0.0.1:{int(os.environ['MASTER_PORT']) + 3}"
        dist.gloo_init_parallel_env(rank, 2, ep)
        dist.gloo_init_parallel_env(rank, 2, ep)      # a second call: no-op
        dist.gloo_barrier()
        dist.gloo_barrier()
        assert pg._gloo["seq"] == 2 and pg._gloo["world"] == 2
        dist.gloo_release()
        assert pg._gloo["store"] is None

    @check
    def barrier_and_objects_after():
        dist.barrier()
        objs = []
        dist.all_gather_object(objs, rank)
        assert objs == [0, 1], objs

    return checks


def _sub3_checks(dist, rank):
    checks = []

    def check(fn):
        checks.append(fn)
        return fn

    state = {}

    @check
    def new_group_members():
        sub = state["sub"] = dist.new_group([0, 2])
        assert sub.ranks == [0, 2]
        assert sub.rank == {0: 0, 1: -1, 2: 1}[rank]
        assert (sub.pg is not None) == (rank != 1)

    @check
    def subgroup_verbs():
        sub = state["sub"]
        if rank in (0, 2):
            t = torch.full((3,), float(rank + 1))
            dist.all_reduce(t, group=sub)
            _eq(t, [4.0, 4.0, 4.0])
            lst = []
            dist.all_gather(lst, _t([rank * 100.0]), group=sub)
            _eq([float(x[0]) for x in lst], [0.0, 200.0])
            b = torch.full((2,), float(rank))
            dist.broadcast(b, src=2, group=sub)
            _eq(b, [2.0, 2.0])
            objs = []
            dist.all_gather_object(objs, {"r": rank}, group=sub)
            assert objs == [{"r": 0}, {"r": 2}], objs
        else:
            try:
                dist.all_reduce(torch.zeros(1), group=sub)
            except ValueError as e:
                assert "not a member" in str(e)
            else:
                raise AssertionError("non-member subgroup call did not raise")

    @check
    def heterogeneous_all_to_all_single():
        per = rank + 1
        buf = np.concatenate([np.full(per, rank * 10 + d, np.float32)
                              for d in range(3)])
        expect = np.concatenate([np.full(s + 1, s * 10 + rank, np.float32)
                                 for s in range(3)])
        out = torch.zeros(6)
        dist.all_to_all_single(out, torch.from_numpy(buf),
                               in_split_sizes=[per, per, per])
        _eq(out, expect)

    @check
    def world_objects_after_subgroup():
        objs = []
        dist.all_gather_object(objs, rank)
        assert objs == [0, 1, 2], objs

    return checks


def _run_checks(checks, rank):
    for fn in checks:
        try:
            fn()
            ok, err = True, ""
        except Exception as e:      # reported, and the rank goes on
            ok, err = False, f"{type(e).__name__}: {e}"
        print("RESULT " + json.dumps(dict(check=fn.__name__, ok=ok, err=err)),
              flush=True)


def _worker(mode):
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import failsafe
    from paddle_tpu_torch.distributed import parallel_env
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    if mode in ("badinit", "badinit_slow"):
        parallel_env.choose_backend = lambda devices: "nccl"
        if mode == "badinit_slow" and rank == 1:
            from paddle_tpu_torch.distributed.store import TCPStore
            get = TCPStore.get

            def slow_get(self, *a, **kw):
                time.sleep(1.0)
                return get(self, *a, **kw)

            TCPStore.get = slow_get
        try:
            dist.init_parallel_env(device="cpu")
        except RuntimeError as e:   # the failure is the expected outcome
            ok = ("NCCL" in str(e) and not dist.is_initialized()
                  and not torch.distributed.is_initialized())
            err = "" if ok else f"{e} (initialised: {dist.is_initialized()})"
            print("RESULT " + json.dumps(dict(
                check="init_failure_raises", ok=ok,
                err=err or type(e).__name__)), flush=True)
        else:
            print("RESULT " + json.dumps(dict(
                check="init_failure_raises", ok=False,
                err="init_process_group('nccl') did not raise")), flush=True)
        return
    if mode == "verbs2" and rank == 0:
        with failsafe.inject("dist.store_init", nth=1) as spec:
            dist.init_parallel_env(device="cpu")
        print("RESULT " + json.dumps(dict(
            check="store_init_retried", ok=spec.fired == 1,
            err=f"fired {spec.fired}")), flush=True)
    else:
        dist.init_parallel_env(device="cpu")
        if mode == "verbs2":
            print("RESULT " + json.dumps(dict(check="store_init_retried",
                                              ok=True, err="")), flush=True)
    checks = {"verbs2": _verbs2_checks, "sub3": _sub3_checks}[mode]
    _run_checks(checks(dist, rank), rank)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    torch.set_num_threads(1)
    _worker(sys.argv[1])
    sys.exit(0)


# -- the tests ----------------------------------------------------------------
import pytest  # noqa: E402

VERBS2 = ["store_init_retried", "backend_and_world", "reduce_scatter",
          "alltoall", "all_to_all_single", "broadcast", "scatter", "send_recv",
          "batch_isend_irecv", "all_gather_object", "broadcast_object_list",
          "scatter_object_list", "all_reduce_float_ops",
          "all_reduce_int64_exact", "reduce_is_all_reduce",
          "reduce_scatter_avg_list", "all_gather_and_into_tensor",
          "alltoall_int64", "all_reduce_int8", "async_handles",
          "stream_namespace", "isend_irecv",
          "world_group_is_the_default_group", "gloo_store_tier",
          "barrier_and_objects_after"]
SUB3 = ["new_group_members", "subgroup_verbs",
        "heterogeneous_all_to_all_single", "world_objects_after_subgroup"]


@pytest.fixture(scope="module")
def worlds():
    """Every world of this file, spawned at once and joined."""
    me = os.path.abspath(__file__)
    held = []
    worlds = (("verbs2", 2), ("sub3", 3), ("badinit", 2),
              ("badinit_slow", 2))
    # MASTER_PORT, the store on +1, the gloo store tier on +3
    ports = [free_ports(4, held) for _ in worlds]
    for s in held:
        s.close()
    started = {mode: spawn_world(me, mode, n, port)
               for (mode, n), port in zip(worlds, ports)}
    return {mode: join_world(procs) for mode, procs in started.items()}


def _held(worlds, mode, check, n):
    runs = worlds[mode]
    got = results_by_check(runs).get(check, {})
    logs = "\n".join(f"-- rank {r} rc {rc}\n{o[-3000:]}"
                     for r, (rc, o) in enumerate(runs))
    assert sorted(got) == list(range(n)), f"{check}: ranks {sorted(got)}\n{logs}"
    bad = {r: e for r, (ok, e) in got.items() if not ok}
    assert not bad, f"{check}: {bad}"


@pytest.mark.parametrize("check", VERBS2)
def test_two_rank_verbs(worlds, check):
    _held(worlds, "verbs2", check, 2)


@pytest.mark.parametrize("check", SUB3)
def test_three_rank_subgroup(worlds, check):
    _held(worlds, "sub3", check, 3)


def test_workers_exit_cleanly(worlds):
    for mode in ("verbs2", "sub3"):
        for rank, (rc, out) in enumerate(worlds[mode]):
            assert rc == 0, f"{mode} rank {rank}:\n{out[-3000:]}"


def test_failed_init_raises_without_fallback(worlds):
    _held(worlds, "badinit", "init_failure_raises", 2)


def test_failed_init_raises_on_a_delayed_rank(worlds):
    """The race of a failed init under load, made certain: rank 1 is still
    reading the store when rank 0's init fails."""
    _held(worlds, "badinit_slow", "init_failure_raises", 2)


def test_backend_rule():
    from paddle_tpu_torch.distributed.parallel_env import choose_backend
    assert choose_backend(["h/cpu", "h/cpu"]) == "gloo"
    assert choose_backend(["cpu"]) == "gloo"
    assert choose_backend(["h/cuda:0", "h/cuda:1"]) == "nccl"
    assert choose_backend(["a/cuda:0", "b/cuda:0"]) == "nccl"
    assert choose_backend(["h/cuda:0", "h/cuda:0"]) == "gloo"
    assert choose_backend(["h/cuda:0", "h/cuda:1", "h/cuda:1"]) == "gloo"
    assert choose_backend(["h/cuda:0", "h/cpu"]) == "gloo"


def test_entry_points_refuse_the_cpu_unless_asked(monkeypatch):
    from paddle_tpu_torch import distributed as dist
    dist.destroy_process_group()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dist.init_parallel_env()
    assert not dist.is_initialized()


def test_uninitialized_verbs_raise(monkeypatch):
    import paddle_tpu_torch.distributed.collective as coll
    monkeypatch.setattr(coll, "_group_size", lambda g: 2)
    for verb, args in ((coll.all_reduce, ()), (coll.broadcast, ()),
                       (coll.all_gather, None)):
        t = torch.ones(3)
        with pytest.raises(RuntimeError, match="init_parallel_env"):
            verb([], t) if args is None else verb(t)


def test_world_one_verbs_pass_through():
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import collective as coll
    assert dist.get_world_size() == 1
    t = _t([1.0, 2.0])
    assert dist.all_reduce(t, op=dist.ReduceOp.AVG) is t
    _eq(t, [1.0, 2.0])
    lst = []
    dist.all_gather(lst, t)
    assert lst[0] is t
    assert dist.all_reduce(t, sync_op=False).wait()
    objs = []
    dist.all_gather_object(objs, {"a": 1})
    assert objs == [{"a": 1}]
    assert isinstance(coll.new_group([0, 1, 2]), coll.Group)


def test_mesh_axis_group_refused():
    from paddle_tpu_torch.distributed import collective as coll
    with pytest.raises(coll.MeshAxisError, match="A8.10"):
        coll.new_group([0], axis_name="data")
    with pytest.raises(NotImplementedError, match="A8.10"):
        coll.Group(0, 7, [0], axis_name="model")


def test_split_matches_the_reference():
    import paddle_tpu as paddle
    from paddle_tpu.distributed import collective as jcoll
    from paddle_tpu_torch.distributed import collective as coll
    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    for args in ((3, 0), ([2, -1, 1], 0), (2, 1), ([1, 3], 1)):
        got = coll.split(torch.from_numpy(x), *args)
        want = jcoll.split(paddle.to_tensor(x), *args)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _eq(g, np.asarray(w.numpy()))


@pytest.mark.parametrize("n,chunk,size", [(2, 16, 100), (3, 64, 700),
                                          (2, 256, 4096)])
def test_eager_quantized_allreduce_bit_exact(monkeypatch, n, chunk, size):
    """Both packages' eager int8 all-reduce on the same rank payloads (the
    gathers patched to hand back the same stack): the sum and this rank's
    residual equal the reference's bit for bit."""
    import jax.numpy as jnp
    import paddle_tpu.distributed.collective as jcoll
    import paddle_tpu.distributed.comm_compress as jcc
    import paddle_tpu_torch.distributed.collective as tcoll
    import paddle_tpu_torch.distributed.comm_compress as tcc
    rng = np.random.RandomState(size)
    xs = [(rng.randn(size) * 10 ** rng.uniform(-3, 2)).astype(np.float32)
          for _ in range(n)]
    xs[0][:chunk] = 0.0                  # a chunk of zeros (scale 1)

    def payload(x):
        q, s, _ = jcc.quantize_int8(jnp.asarray(x), chunk=chunk)
        return np.concatenate([np.asarray(q).reshape(-1).view(np.uint8),
                               np.asarray(s, np.float32).view(np.uint8)])

    stack = np.stack([payload(x) for x in xs])
    monkeypatch.setattr(jcoll, "_process_gather", lambda arr, group: stack)
    monkeypatch.setattr(tcoll, "_process_gather",
                        lambda t, group: torch.from_numpy(stack.copy()))
    for r in range(n):
        # the port packs rank r's payload as the reference does
        q, s, _ = tcc.quantize_int8(torch.from_numpy(xs[r]), chunk)
        _eq(torch.cat([q.reshape(-1).view(torch.uint8), s.view(torch.uint8)]),
            stack[r])
        jtot, jerr = jcc.eager_quantized_allreduce(xs[r], None, chunk=chunk)
        ttot, terr = tcc.eager_quantized_allreduce(torch.from_numpy(xs[r]),
                                                   None, chunk=chunk)
        assert ttot.numpy().view(np.uint32).tolist() == \
            np.asarray(jtot).view(np.uint32).tolist()
        assert terr.numpy().view(np.uint32).tolist() == \
            np.asarray(jerr).view(np.uint32).tolist()


@pytest.mark.parametrize("kw", [dict(), dict(compressed=True),
                                dict(compressed=True, chunk=64),
                                dict(scatter_only=True), dict(dtype_bytes=2)])
def test_wire_bytes_matches_the_reference(kw):
    from paddle_tpu.distributed import comm_compress as jcc
    from paddle_tpu_torch.distributed import comm_compress as tcc
    for size, n in ((1, 1), (1000, 2), (12345, 3), (1 << 20, 8)):
        assert tcc.wire_bytes(size, n, **kw) == jcc.wire_bytes(size, n, **kw)
    assert tcc.resolve_chunk(None) == jcc.resolve_chunk(None)
    with pytest.raises(ValueError):
        tcc.resolve_chunk(0)


def _leading(fn):
    import inspect
    return [(p.name, p.kind, p.default)
            for p in inspect.signature(fn).parameters.values()]


SIGNATURES = [
    "parallel_env:init_parallel_env", "parallel_env:get_rank",
    "parallel_env:get_world_size", "parallel_env:get_store",
    "collective:new_group", "collective:get_group",
    "collective:destroy_process_group", "collective:Group.__init__",
    "collective:all_reduce", "collective:all_gather",
    "collective:all_gather_into_tensor", "collective:reduce_scatter",
    "collective:alltoall", "collective:all_to_all_single",
    "collective:broadcast", "collective:reduce", "collective:scatter",
    "collective:send", "collective:recv", "collective:isend",
    "collective:irecv", "collective:P2POp.__init__",
    "collective:batch_isend_irecv", "collective:barrier", "collective:wait",
    "collective:split", "collective:all_gather_object",
    "collective:broadcast_object_list", "collective:scatter_object_list",
    "parallel_with_gloo:gloo_init_parallel_env",
    "comm_compress:eager_quantized_allreduce", "comm_compress:wire_bytes",
    "comm_compress:resolve_chunk", "reducer:EagerReducer.__init__",
    "reducer:EagerReducer.sync", "parallel:DataParallel.__init__",
    "parallel:DataParallel.no_sync", "parallel:DataParallel.sync_gradients",
    "topology:CommunicateTopology.__init__",
    "topology:CommunicateTopology.get_comm_list",
    "topology:HybridCommunicateGroup.__init__",
    "fleet.fleet_base:Fleet.init",
    "fleet.fleet_base:Fleet.distributed_model",
    "fleet.fleet_base:Fleet.distributed_optimizer",
    "fleet.utils.hybrid_parallel_util:broadcast_dp_parameters",
    "fleet.utils.hybrid_parallel_util:fused_allreduce_gradients",
    "rpc:init_rpc", "rpc:rpc_sync", "rpc:rpc_async", "rpc:shutdown",
    "rpc:get_worker_info"]


@pytest.mark.parametrize("name", SIGNATURES)
def test_reference_parameters_lead_in_order(name):
    """The reference's parameters come first in the port's signature, in
    its order, kinds and defaults (a positional call binds alike); the
    port may add keyword-usable ones after them (`device`, `pg`)."""
    import importlib
    import inspect
    mod, attrs = name.split(":")
    objs = []
    for pkg in ("paddle_tpu.distributed.", "paddle_tpu_torch.distributed."):
        obj = importlib.import_module(pkg + mod)
        for a in attrs.split("."):
            obj = getattr(obj, a)
        objs.append(obj)
    ref, port = (_leading(f) for f in objs)
    assert port[:len(ref)] == ref, (name, ref, port)
    for pname, kind, _ in port[len(ref):]:
        assert kind in (inspect.Parameter.POSITIONAL_OR_KEYWORD,
                        inspect.Parameter.KEYWORD_ONLY), (name, pname)
