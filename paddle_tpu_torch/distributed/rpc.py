"""The RPC wire framing: a 4-byte big-endian length, then a pickle.

Counterpart of the framing of `paddle_tpu/distributed/rpc/rpc.py`
(`_send_msg` / `_recv_msg`): the process fleet (`inference/fleet.py`)
speaks its EngineReplica RPCs in exactly this format, so one framing
definition serves both. The RPC agent itself (`init_rpc`, `rpc_sync`, ...)
is ROADMAP A8.1.

Nothing on a CUDA device should ride this wire: pickling a CUDA tensor
copies it through the host and rebuilds it on the receiver's card. The
fleet's methods answer with host values (numpy arrays, Python scalars).
"""
import pickle
import struct


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
