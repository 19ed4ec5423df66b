"""The port's RPC agent (`paddle_tpu_torch.distributed.rpc`) and its
TCPStore, against `tests/test_rpc.py` and `tests/test_tcp_store.py`.

  - one worker: a self call, a Future, a remote exception, the worker
    infos (the reference's `TestRpcSingleWorker`);
  - two processes: this file run as `python tests/test_torch_rpc.py
    worker1 <endpoint> <stop file>` registers as "worker1" (rank 1);
    worker0 (the test, rank 0, hosting the store) calls it sync and async,
    it calls worker0 back once, and both see both infos (the reference's
    `test_rpc_cross_process`, slow there, about 3 s here);
  - the wire framing: a message framed by either package reads back in
    the other;
  - the store: `TestTCPStore` replayed on the port's (its `get(wait=False)`
    of a missing key returns None where the reference raises KeyError:
    the port's documented difference).
"""
import operator
import os
import socket
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _child(ep, stop):
    from paddle_tpu_torch.distributed import rpc
    rpc.init_rpc("worker1", rank=1, world_size=2, master_endpoint=ep)
    print("CALLBACK", rpc.rpc_sync("worker0", operator.add, args=(40, 2)),
          flush=True)
    deadline = time.time() + 60
    while not os.path.exists(stop) and time.time() < deadline:
        time.sleep(0.05)
    rpc.shutdown()


if __name__ == "__main__":
    _child(sys.argv[2], sys.argv[3])
    sys.exit(0)


import threading  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from paddle_tpu_torch.distributed import rpc  # noqa: E402
from paddle_tpu_torch.distributed.store import TCPStore  # noqa: E402

sys.path.insert(0, HERE)
from test_torch_collective import free_ports  # noqa: E402


def _double(x):
    return 2 * x


class TestRpcSingleWorker:
    def setup_method(self, m):
        rpc.init_rpc("worker0", rank=0, world_size=1)

    def teardown_method(self, m):
        rpc.shutdown()

    def test_sync_self_call(self):
        assert rpc.rpc_sync("worker0", operator.add, args=(2, 3)) == 5

    def test_async_future(self):
        fut = rpc.rpc_async("worker0", _double, args=(21,))
        assert fut.wait() == 42

    def test_remote_exception_propagates(self):
        with pytest.raises(RuntimeError, match="rpc to 'worker0' raised"):
            rpc.rpc_sync("worker0", operator.truediv, args=(1, 0))

    def test_worker_infos(self):
        info = rpc.get_current_worker_info()
        assert info.name == "worker0" and info.rank == 0
        assert rpc.get_worker_info("worker0") == info
        assert rpc.get_all_worker_infos() == [info]

    def test_double_init_and_unknown_worker_raise(self):
        with pytest.raises(RuntimeError, match="already initialized"):
            rpc.init_rpc("again", rank=0, world_size=1)
        with pytest.raises(ValueError, match="unknown rpc worker"):
            rpc.get_worker_info("nobody")


def test_calls_before_init_raise():
    with pytest.raises(RuntimeError, match="init_rpc"):
        rpc.rpc_sync("worker0", operator.add, args=(1, 2))
    with pytest.raises(ValueError, match="master_endpoint"):
        rpc.init_rpc("w", rank=0, world_size=2)


def test_rpc_cross_process(tmp_path):
    held = []
    ep = f"127.0.0.1:{free_ports(1, held)}"
    for s in held:
        s.close()
    stop = tmp_path / "stop"
    env = {**os.environ,
           "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    child = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "worker1", ep, str(stop)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        # init blocks until worker1 has registered in the store
        rpc.init_rpc("worker0", rank=0, world_size=2, master_endpoint=ep)
        # fn must be importable on the callee (pickled by reference)
        assert rpc.rpc_sync("worker1", operator.mul, args=(8, 2)) == 16
        fut = rpc.rpc_async("worker1", operator.add, args=(1, 2))
        assert fut.wait() == 3
        names = sorted(i.name for i in rpc.get_all_worker_infos())
        assert names == ["worker0", "worker1"]
        assert rpc.get_worker_info("worker1").rank == 1
    finally:
        stop.write_text("1")
        try:
            out, _ = child.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            child.kill()
            out, _ = child.communicate()
        rpc.shutdown()
    assert child.returncode == 0, out
    assert "CALLBACK 42" in out, out


def test_framing_round_trips_both_ways():
    from paddle_tpu.distributed.rpc import rpc as jrpc
    a, b = socket.socketpair()
    try:
        msg = (operator.add, (1, [2, 3]), {"k": np.arange(3)})
        rpc.send_msg(a, msg)
        got = jrpc._recv_msg(b)
        assert got[0] is operator.add and got[1] == (1, [2, 3])
        jrpc._send_msg(b, (True, "x" * 100000))
        assert rpc.recv_msg(a) == (True, "x" * 100000)
    finally:
        a.close()
        b.close()


@pytest.fixture(scope="module")
def store_pair():
    master = TCPStore(is_master=True)
    client = TCPStore(host="127.0.0.1", port=master.port, is_master=False)
    yield master, client


class TestTCPStore:
    def test_set_get(self, store_pair):
        master, client = store_pair
        master.set("k1", b"hello")
        assert client.get("k1") == b"hello"

    def test_get_missing_returns_none(self, store_pair):
        _, client = store_pair
        assert client.get("nope", wait=False) is None

    def test_add_counter(self, store_pair):
        master, client = store_pair
        assert master.add("cnt", 5) == 5
        assert client.add("cnt", 3) == 8

    def test_wait_blocks_until_set(self, store_pair):
        master, client = store_pair

        def setter():
            time.sleep(0.2)
            master.set("late_key", b"v")

        t = threading.Thread(target=setter)
        t.start()
        assert client.get("late_key", wait=True, timeout_ms=5000) == b"v"
        t.join()

    def test_wait_timeout(self, store_pair):
        _, client = store_pair
        with pytest.raises(TimeoutError):
            client.wait("never_set", timeout_ms=200)

    def test_delete_and_numkeys(self, store_pair):
        master, _ = store_pair
        master.set("del_me", b"x")
        assert master.delete_key("del_me")
        assert not master.delete_key("del_me")
        assert master.num_keys() >= 1

    def test_barrier(self, store_pair):
        master, client = store_pair
        results = []

        def worker(st):
            st.barrier("b1", 2, timeout_ms=5000)
            results.append(1)

        t1 = threading.Thread(target=worker, args=(master,))
        t2 = threading.Thread(target=worker, args=(client,))
        t1.start()
        t2.start()
        t1.join(6)
        t2.join(6)
        assert results == [1, 1]

    def test_barrier_times_out_short_of_the_world(self, store_pair):
        master, _ = store_pair
        with pytest.raises(TimeoutError):
            master.barrier("b_alone", 2, timeout_ms=200)

    def test_concurrent_adds(self, store_pair):
        master, client = store_pair

        def bump(st, n):
            for _ in range(n):
                st.add("race", 1)

        ts = [threading.Thread(target=bump, args=(st, 50))
              for st in (master, client) for _ in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert master.add("race", 0) == 200
