"""The RPC agent and its wire framing.

Counterpart of `paddle_tpu/distributed/rpc/rpc.py` (ref:
python/paddle/distributed/rpc/rpc.py:52-259): `init_rpc`, `rpc_sync`,
`rpc_async` (a Future with `.wait`), `shutdown` and the worker-info
queries over a threaded socket agent. Wire: a 4-byte big-endian length,
then a pickle; a request is (fn, args, kwargs), a reply (ok, result or
traceback). `fn` is pickled by reference, so it must be importable on the
callee. Discovery: rank -> pickled WorkerInfo under "rpc/<rank>" in the
port's TCPStore (`distributed/store.py`), hosted by rank 0 at
`master_endpoint`.

The process fleet (`inference/fleet.py`) speaks its EngineReplica RPCs in
the same framing (`send_msg` / `recv_msg`). Nothing on a CUDA device
should ride this wire: pickling a CUDA tensor copies it through the host
and rebuilds it on the receiver's card; answer with host values.
"""
import os
import pickle
import socket
import struct
import threading
import traceback
from collections import namedtuple
from concurrent.futures import Future, ThreadPoolExecutor

WorkerInfo = namedtuple("WorkerInfo", ["name", "rank", "ip", "port"])

_DEFAULT_RPC_TIMEOUT = -1

_agent = [None]


def _send_msg(sock, payload):
    data = pickle.dumps(payload)
    sock.sendall(struct.pack(">I", len(data)) + data)


def _recv_msg(sock):
    hdr = b""
    while len(hdr) < 4:
        chunk = sock.recv(4 - len(hdr))
        if not chunk:
            raise ConnectionError("rpc peer closed")
        hdr += chunk
    (n,) = struct.unpack(">I", hdr)
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise ConnectionError("rpc peer closed mid-message")
        buf += chunk
    return pickle.loads(bytes(buf))


# the public framing surface the serving fleet uses
send_msg = _send_msg
recv_msg = _recv_msg


class _RpcAgent:
    """One per process: socket server thread + client connections."""

    def __init__(self, name, rank, world_size, store):
        self.name = name
        self.rank = rank
        self.world_size = world_size
        self.store = store
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        # a world of 1 stays on loopback (the protocol is pickle: trusting
        # by design, like the reference's brpc agent, so never exposed
        # wider than the job needs); a larger world binds
        # PADDLE_RPC_BIND_IP (default all interfaces) and advertises a
        # routable address
        multi_host = world_size > 1
        bind_ip = os.getenv("PADDLE_RPC_BIND_IP",
                            "0.0.0.0" if multi_host else "127.0.0.1")
        self._server.bind((bind_ip, 0))
        self._server.listen(128)
        _, self.port = self._server.getsockname()
        self.ip = os.getenv("PADDLE_LOCAL_IP")
        if not self.ip:
            if multi_host:
                try:
                    self.ip = socket.gethostbyname(socket.gethostname())
                except OSError:
                    self.ip = "127.0.0.1"
            else:
                self.ip = "127.0.0.1"
        self._stop = threading.Event()
        # outgoing async calls only; each server connection gets a thread
        # of its own (a handler loops for the connection's lifetime)
        self._client_pool = ThreadPoolExecutor(max_workers=8,
                                               thread_name_prefix="rpc_client")
        self._thread = threading.Thread(target=self._serve_loop, daemon=True)
        self._thread.start()
        self._infos = {}
        self._conns = {}          # peer name -> (socket, lock)
        self._conns_lock = threading.Lock()
        self._register()

    # -- discovery ---------------------------------------------------------
    def _register(self):
        me = WorkerInfo(self.name, self.rank, self.ip, self.port)
        if self.store is not None:
            self.store.set(f"rpc/{self.rank}", pickle.dumps(me))
            for r in range(self.world_size):
                raw = self.store.get(f"rpc/{r}", wait=True)
                self._infos[r] = pickle.loads(bytes(raw))
        else:
            self._infos[self.rank] = me

    # -- server ------------------------------------------------------------
    def _serve_loop(self):
        try:
            self._server.settimeout(0.2)
        except OSError:
            return      # stopped before the loop began
        while not self._stop.is_set():
            try:
                conn, _ = self._server.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()

    def _handle(self, conn):
        # one connection serves many requests (clients keep theirs open)
        try:
            with conn:
                while not self._stop.is_set():
                    try:
                        fn, args, kwargs = _recv_msg(conn)
                        result = fn(*args, **kwargs)
                        _send_msg(conn, (True, result))
                    except (ConnectionError, OSError):
                        raise
                    except Exception:
                        _send_msg(conn, (False, traceback.format_exc()))
        except (ConnectionError, OSError):
            pass

    # -- client ------------------------------------------------------------
    def _peer_conn(self, to):
        with self._conns_lock:
            if to not in self._conns:
                info = self.worker_info_by_name(to)
                sock = socket.create_connection((info.ip, info.port))
                self._conns[to] = (sock, threading.Lock())
            return self._conns[to]

    def invoke(self, to, fn, args, kwargs, timeout):
        sock, lock = self._peer_conn(to)
        try:
            with lock:  # one in-flight request per cached connection
                sock.settimeout(None if timeout in (-1, None) else timeout)
                _send_msg(sock, (fn, args or (), kwargs or {}))
                ok, result = _recv_msg(sock)
        except (ConnectionError, OSError):
            with self._conns_lock:
                stale = self._conns.pop(to, None)
            if stale is not None:
                try:
                    stale[0].close()
                except OSError:
                    pass
            raise
        if not ok:
            raise RuntimeError(f"rpc to {to!r} raised:\n{result}")
        return result

    def worker_info_by_name(self, name):
        for info in self._infos.values():
            if info.name == name:
                return info
        raise ValueError(f"unknown rpc worker {name!r}")

    def stop(self):
        self._stop.set()
        try:
            self._server.close()
        except OSError:
            pass
        with self._conns_lock:
            for sock, _ in self._conns.values():
                try:
                    sock.close()
                except OSError:
                    pass
            self._conns.clear()
        self._thread.join(timeout=2)
        self._client_pool.shutdown(wait=False)


def init_rpc(name, rank=None, world_size=None, master_endpoint=None):
    """ref: rpc.py:73. Starts this process's agent and exchanges
    WorkerInfos through the TCPStore at `master_endpoint` (rank 0 hosts;
    the PADDLE_MASTER env var when not given)."""
    if _agent[0] is not None:
        raise RuntimeError("rpc is already initialized; call "
                           "paddle.distributed.rpc.shutdown() first")
    rank = int(os.getenv("PADDLE_TRAINER_ID", "0")) if rank is None else rank
    world_size = (int(os.getenv("PADDLE_TRAINERS_NUM", "1"))
                  if world_size is None else world_size)
    store = None
    if world_size > 1:
        from ..store import TCPStore
        master_endpoint = master_endpoint or os.getenv("PADDLE_MASTER")
        if not master_endpoint:
            raise ValueError(
                "init_rpc with world_size > 1 needs master_endpoint "
                "(or the PADDLE_MASTER env var), e.g. 'host:port'")
        host, port = master_endpoint.split(":")
        store = TCPStore(host, int(port), is_master=(rank == 0),
                         world_size=world_size)
    _agent[0] = _RpcAgent(name, rank, world_size, store)
    return _agent[0]


def _require_agent():
    if _agent[0] is None:
        raise RuntimeError("call paddle.distributed.rpc.init_rpc first")
    return _agent[0]


def rpc_sync(to, fn, args=None, kwargs=None, timeout=_DEFAULT_RPC_TIMEOUT):
    """ref: rpc.py:141 — blocking remote call, returns the result."""
    return _require_agent().invoke(to, fn, args, kwargs, timeout)


def rpc_async(to, fn, args=None, kwargs=None, timeout=_DEFAULT_RPC_TIMEOUT):
    """ref: rpc.py:179 — returns a Future with .wait()."""
    agent = _require_agent()
    fut = Future()

    def run():
        try:
            fut.set_result(agent.invoke(to, fn, args, kwargs, timeout))
        except BaseException as e:  # noqa: BLE001 — forwarded to waiter
            fut.set_exception(e)

    agent._client_pool.submit(run)
    fut.wait = lambda t=None: fut.result(t)
    return fut


def shutdown():
    """ref: rpc.py:270 — barrier-free local teardown."""
    if _agent[0] is not None:
        _agent[0].stop()
        _agent[0] = None


def get_worker_info(name):
    """ref: rpc.py:299."""
    return _require_agent().worker_info_by_name(name)


def get_all_worker_infos():
    """ref: rpc.py:328."""
    agent = _require_agent()
    return [agent._infos[r] for r in sorted(agent._infos)]


def get_current_worker_info():
    """ref: rpc.py:354."""
    agent = _require_agent()
    return WorkerInfo(agent.name, agent.rank, agent.ip, agent.port)
