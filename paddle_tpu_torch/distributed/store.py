"""TCPStore: the rendezvous key-value store of the process fleet.

Counterpart of `paddle_tpu/distributed/store.py`, with the reference's API
(`TCPStore(host, port, is_master, world_size, timeout)`, `.host`, `.port`,
`set`, `get(key, wait=True, timeout_ms=-1)`, `add`, `wait`, `delete_key`,
`num_keys`, `barrier`) over `torch.distributed.TCPStore` instead of the
reference's native server (`csrc/tcp_store.cc`): nothing native is built.

Three differences of the torch store are hidden here:

  - its `get` blocks on a missing key until the store's timeout, so
    `get(key, wait=False)` asks `check` first and returns None for a key
    that is not there;
  - its `set` does not wait for the server (the client sends the value
    and returns), so a value another client reads right after this `set`
    returned may not be there yet; `set` here ends with a `check` on the
    same connection, which the server answers only after it applied the
    set, so `set` returns once the value is stored, as the reference's
    does;
  - its server refuses a value over a few MiB (the libuv backend's payload
    cap), so a value longer than `CHUNK_BYTES` is written as chunks under
    `{key}/__chunk/{token}/{i}` with a small header at `key` (and at the
    marker `{key}/__chunked`); `get` reassembles it, and `delete_key` or a
    later `set` of the key removes the chunks. A fleet
    worker's resume ledger and a 100+ MB KV payload round-trip whole.

`check(keys)` and `set_timeout(td)` pass through to the torch store (the
KV transport and the fleet prefix index call them).
"""
import datetime
import json
import threading
import uuid

CHUNK_BYTES = 4 << 20
_MAGIC = b"\x00ptt-chunked\x00"


def _ms(timeout_ms):
    return datetime.timedelta(milliseconds=int(timeout_ms))


class TCPStore:
    """API mirrors the reference's TCPStore: rank 0 hosts, all ranks
    connect.

    TCPStore(host, port, is_master, world_size, timeout_s)
    """

    def __init__(self, host="127.0.0.1", port=0, is_master=False,
                 world_size=1, timeout=120):
        import torch.distributed as dist
        self.host = host
        self.world_size = int(world_size)
        self._timeout = datetime.timedelta(seconds=float(timeout))
        try:
            self._store = dist.TCPStore(host, int(port), None, bool(is_master),
                                        self._timeout, wait_for_workers=False)
        except Exception as e:
            raise RuntimeError(
                f"TCPStore: cannot {'bind' if is_master else 'connect'} "
                f"{host}:{port}: {e}") from e
        self.port = int(self._store.port)
        self._lock = threading.Lock()

    # -- values ----------------------------------------------------------------
    def set(self, key, value):
        if isinstance(value, str):
            value = value.encode()
        value = bytes(value)
        marker = f"{key}/__chunked"
        if len(value) <= CHUNK_BYTES:
            with self._lock:
                self._store.set(key, value)
                # one round trip: the server applied the set, and it says
                # whether chunks of an earlier long value are left
                stale = self._store.check([marker])
            if stale:
                self._drop_chunks(key, self._take_marker(key))
            return
        token = uuid.uuid4().hex[:12]
        n = -(-len(value) // CHUNK_BYTES)
        head = json.dumps({"token": token, "n": n,
                           "nbytes": len(value)}).encode()
        with self._lock:
            for i in range(n):
                self._store.set(f"{key}/__chunk/{token}/{i}",
                                value[i * CHUNK_BYTES:(i + 1) * CHUNK_BYTES])
            stale = self._store.check([marker])
        old = self._take_marker(key) if stale else None
        with self._lock:
            self._store.set(marker, head)
            # the header goes last: a reader never sees a torn value
            self._store.set(key, _MAGIC + head)
            self._store.check([key])
        if old is not None:
            self._drop_chunks(key, old)

    def get(self, key, wait=True, timeout_ms=-1):
        if wait:
            self.wait([key], timeout_ms)
        elif not self.check([key]):
            return None
        with self._lock:
            raw = bytes(self._store.get(key))
        if not raw.startswith(_MAGIC):
            return raw
        head = json.loads(raw[len(_MAGIC):].decode())
        with self._lock:
            parts = [bytes(self._store.get(
                f"{key}/__chunk/{head['token']}/{i}"))
                for i in range(head["n"])]
        value = b"".join(parts)
        if len(value) != head["nbytes"]:
            raise RuntimeError(
                f"TCPStore.get({key!r}): chunked value torn ({len(value)} "
                f"of {head['nbytes']} bytes)")
        return value

    def _take_marker(self, key):
        """Read and delete the marker of the long value under `key`; its
        header names the chunks."""
        marker = f"{key}/__chunked"
        with self._lock:
            head = json.loads(bytes(self._store.get(marker)).decode())
            self._store.delete_key(marker)
        return head

    def _drop_chunks(self, key, head):
        with self._lock:
            for i in range(head["n"]):
                self._store.delete_key(f"{key}/__chunk/{head['token']}/{i}")

    # -- counters, waits, keys -----------------------------------------------
    def add(self, key, amount=1):
        with self._lock:
            return int(self._store.add(key, int(amount)))

    def check(self, keys):
        if isinstance(keys, str):
            keys = [keys]
        with self._lock:
            return bool(self._store.check(list(keys)))

    def wait(self, keys, timeout_ms=-1):
        if isinstance(keys, str):
            keys = [keys]
        td = self._timeout if timeout_ms is None or timeout_ms < 0 \
            else _ms(timeout_ms)
        try:
            self._store.wait(list(keys), td)
        except Exception as e:
            raise TimeoutError(f"TCPStore.wait({keys!r}) timed out") from e

    def delete_key(self, key):
        marker = f"{key}/__chunked"
        with self._lock:
            gone = bool(self._store.delete_key(key))
            stale = self._store.check([marker])
        if stale:
            self._drop_chunks(key, self._take_marker(key))
        return gone

    def num_keys(self):
        with self._lock:
            return int(self._store.num_keys())

    def set_timeout(self, timeout):
        """The default wait of `get` / `wait` (a datetime.timedelta)."""
        self._timeout = timeout
        with self._lock:
            self._store.set_timeout(timeout)

    def barrier(self, name, world_size, timeout_ms=60000):
        """Counter barrier (the reference's bootstrap barrier pattern)."""
        n = self.add(f"__barrier/{name}", 1)
        if n == world_size:
            self.set(f"__barrier/{name}/done", b"1")
        self.wait([f"__barrier/{name}/done"], timeout_ms)


_retired = []


def retire(store):
    """Drop a store from its owner's use but keep its server up until the
    process exits, as the reference's native server thread does: a rank
    that leaves first (gloo_release, destroy_process_group) must not take
    the store from under the peers still reading their last keys."""
    if store is not None:
        _retired.append(store)
