"""KV-page handoff: move a prefilled request between engines, no recompute.

Counterpart of `paddle_tpu/inference/handoff.py`: the integrity layer and
the transports behind `ContinuousBatchingEngine.export_kv_pages` /
`import_kv_pages` (and the tier demotion, `inference/tiering.py`, which
stores the same payload).

  - payload checksums: CRC32s over the resume metadata and every layer's K
    / V page blob, stamped at export and verified at import
    (`checksum_payload` / `verify_payload`, KVHandoffError on a mismatch).
    A device-transport payload stamps and verifies the metadata only: its
    blobs never leave the card.
  - DeviceTransport: the pages stay CUDA tensors end to end (`gather` is
    the pool's row gather, `place` a device-to-device copy).
  - StoreKVTransport: the payload as chunked binary values plus a JSON
    manifest on any key-value store with `set` / `get` (a
    torch.distributed Store: HashStore in one process, TCPStore across
    processes).
  - `negotiate(src_ep, dst_ep)`: "device" for one runtime, "store" for one
    fleet store, else "host".

The payload's keys, the store manifest's JSON and the CRCs are the
reference's byte for byte. numpy has no bfloat16: a bf16 page blob travels
as the uint16 view of its bytes (`to_host`), and its manifest entry keeps
the reference's dtype name "bfloat16", so the same page bytes give the
same CRCs and the same packed blob in both packages.
"""
import json
import zlib

import numpy as np
import torch


class KVHandoffError(RuntimeError):
    """A KV-page handoff failed integrity or protocol checks (CRC mismatch,
    geometry mismatch, torn transport manifest)."""


# metadata fields covered by the meta CRC (order matters: it is the
# serialization order)
_META_FIELDS = ("uid", "state", "generated", "max_new_tokens",
                "eos_token_id", "tenant", "priority", "ttl_steps",
                "deadline", "deadline_remaining_ms")

_BF16 = "bfloat16"


def to_host(t):
    """A page blob tensor as a host numpy array: bf16 as the uint16 view of
    its bytes (numpy has no bfloat16), other dtypes as themselves."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def from_host(a, dtype):
    """A host page blob as a tensor of `dtype` (a uint16 blob read back as
    the bf16 it views)."""
    a = np.ascontiguousarray(a)
    if dtype == torch.bfloat16 and a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy()).to(dtype)


def _meta_crc(payload):
    spec = payload["spec"]
    meta = [spec.get(k) for k in _META_FIELDS]
    meta.append(int(payload["lens"]))
    blob = json.dumps(meta, default=str).encode()
    crc = zlib.crc32(blob)
    crc = zlib.crc32(np.ascontiguousarray(
        np.asarray(spec["prompt"], np.int64)).tobytes(), crc)
    return crc & 0xFFFFFFFF


def _page_crc(arr):
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def _nbytes(a):
    if torch.is_tensor(a):
        return a.numel() * a.element_size()
    return int(np.asarray(a).nbytes)


def payload_bytes(payload):
    """Raw KV bytes a page-image payload carries (every layer's K and V
    blobs; metadata excluded)."""
    return (sum(_nbytes(a) for a in payload["k"])
            + sum(_nbytes(a) for a in payload["v"]))


def checksum_payload(payload):
    """Stamp CRC32s over the resume metadata and every layer's K / V page
    blob; returns the payload (mutated in place). A `transport: "device"`
    payload stamps the metadata only (its blobs are CUDA tensors that never
    cross a host boundary)."""
    if payload.get("transport") == "device":
        payload["crc"] = {"meta": _meta_crc(payload), "k": None, "v": None}
        return payload
    payload["crc"] = {
        "meta": _meta_crc(payload),
        "k": [_page_crc(a) for a in payload["k"]],
        "v": [_page_crc(a) for a in payload["v"]],
    }
    return payload


def verify_payload(payload):
    """Raise KVHandoffError unless every CRC matches what was stamped at
    export (device payloads: the metadata only)."""
    crc = payload.get("crc")
    if not isinstance(crc, dict):
        raise KVHandoffError("handoff payload carries no checksums")
    if crc["meta"] != _meta_crc(payload):
        raise KVHandoffError(
            "handoff metadata CRC mismatch (resume spec corrupted in "
            "transit)")
    if payload.get("transport") == "device":
        return payload
    for name in ("k", "v"):
        blobs, sums = payload[name], crc[name]
        if len(blobs) != len(sums):
            raise KVHandoffError(
                f"handoff {name}-page layer count mismatch: {len(blobs)} "
                f"blobs, {len(sums)} checksums")
        for li, (a, want) in enumerate(zip(blobs, sums)):
            got = _page_crc(a)
            if got != want:
                raise KVHandoffError(
                    f"handoff {name}-page CRC mismatch at layer {li}: "
                    f"{got:#010x} != {want:#010x} (KV bytes corrupted in "
                    "transit)")
    return payload


def negotiate(src_ep, dst_ep):
    """The cheapest transport two replica endpoints (`transport_endpoint()`
    dicts) share: "device" with the same `proc` token and `backend`,
    "store" with the same fleet `store`, else "host"."""
    if not isinstance(src_ep, dict) or not isinstance(dst_ep, dict):
        return "host"
    if (src_ep.get("proc") and src_ep.get("proc") == dst_ep.get("proc")
            and src_ep.get("backend") == dst_ep.get("backend")):
        return "device"
    if src_ep.get("store") and \
            tuple(src_ep["store"]) == tuple(dst_ep.get("store") or ()):
        return "store"
    return "host"


class DeviceTransport:
    """The device-domain page mover of a handoff negotiated "device": the
    blobs stay CUDA tensors (no host copy, no page CRC walk; the metadata
    CRC still verifies)."""

    @staticmethod
    def gather(pool, idx):
        """The pool rows of pages idx, on the pool's device."""
        return pool[idx]

    @staticmethod
    def place(arr, target=None):
        """arr on the target device (None: where it is)."""
        if target is None:
            return arr
        return arr.to(target)


class StoreKVTransport:
    """KV handoff over a key-value store (the cross-process transport).
    Arrays ship as chunked binary values under a manifest key; the CRC layer
    catches torn or reordered writes.

    store: anything with set(key, bytes) and get(key) -> bytes, where get
      waits for the key (torch.distributed.HashStore / TCPStore; their wait
      is the store's own timeout, `recv`'s timeout_ms sets it where the
      store has `set_timeout`). delete_key removes a key where supported.
    prefix: key namespace (several transports can share one store).
    chunk_bytes: store value chunk size.
    """

    def __init__(self, store, prefix="kvxfer", chunk_bytes=1 << 19):
        self.store = store
        self.prefix = prefix
        self.chunk_bytes = int(chunk_bytes)

    # -- wire format --------------------------------------------------------
    @staticmethod
    def _pack(payload):
        """payload -> (manifest_json_bytes, binary_blob). Arrays are
        concatenated in manifest order; the manifest records shapes, dtypes
        (a bf16 page's uint16 view as "bfloat16") and offsets."""
        if payload.get("transport") == "device":
            raise KVHandoffError(
                "a device-transport payload cannot ride the store transport: "
                "its page blobs carry no CRCs (re-export with the host path)")
        spec = dict(payload["spec"])
        prompt = np.ascontiguousarray(np.asarray(spec.pop("prompt"),
                                                 np.int64))
        bf16 = (payload.get("geometry") or {}).get("kv_dtype") == _BF16
        arrays = [("prompt", prompt, str(prompt.dtype))]
        for name in ("k", "v"):
            for li, a in enumerate(payload[name]):
                a = np.ascontiguousarray(np.asarray(a))
                dt = _BF16 if bf16 and a.dtype == np.uint16 else str(a.dtype)
                arrays.append((f"{name}{li}", a, dt))
        blob = bytearray()
        index = []
        for name, a, dt in arrays:
            index.append({"name": name, "shape": list(a.shape),
                          "dtype": dt, "off": len(blob),
                          "nbytes": a.nbytes})
            blob += a.tobytes()
        manifest = {
            "spec": spec, "lens": int(payload["lens"]),
            "layers": len(payload["k"]),
            "geometry": payload["geometry"],
            "token": payload["token"],
            "crc": payload["crc"],
            "transport": payload.get("transport", "host"),
            "index": index, "blob_bytes": len(blob),
        }
        return json.dumps(manifest).encode(), bytes(blob)

    @staticmethod
    def _unpack(manifest_bytes, blob):
        m = json.loads(manifest_bytes.decode())
        if len(blob) != m["blob_bytes"]:
            raise KVHandoffError(
                f"handoff blob truncated: {len(blob)} of {m['blob_bytes']} "
                "bytes arrived")
        arrays = {}
        for ent in m["index"]:
            dt = np.uint16 if ent["dtype"] == _BF16 else np.dtype(ent["dtype"])
            a = np.frombuffer(blob, dtype=dt, count=int(np.prod(
                ent["shape"], dtype=np.int64)), offset=ent["off"])
            arrays[ent["name"]] = a.reshape(ent["shape"]).copy()
        spec = dict(m["spec"])
        spec["prompt"] = arrays["prompt"]
        L = m["layers"]
        return {
            "spec": spec, "lens": m["lens"], "token": m["token"],
            "geometry": m["geometry"], "crc": m["crc"],
            "transport": m.get("transport", "host"),
            "k": [arrays[f"k{li}"] for li in range(L)],
            "v": [arrays[f"v{li}"] for li in range(L)],
        }

    # -- transport ----------------------------------------------------------
    def _get(self, key, timeout_ms):
        if timeout_ms is not None and hasattr(self.store, "set_timeout"):
            import datetime
            self.store.set_timeout(datetime.timedelta(milliseconds=timeout_ms))
        return bytes(self.store.get(key))

    def send(self, payload):
        """Publish a handoff payload; returns the key the receiver passes to
        recv(). The manifest is written last, so a reader never observes a
        torn transfer."""
        manifest, blob = self._pack(payload)
        key = f"{self.prefix}/{payload['token']}"
        n_chunks = max(1, -(-len(blob) // self.chunk_bytes))
        for i in range(n_chunks):
            lo = i * self.chunk_bytes
            self.store.set(f"{key}/c{i}", blob[lo:lo + self.chunk_bytes])
        self.store.set(f"{key}/manifest",
                       json.dumps({"chunks": n_chunks}).encode()
                       + b"\n" + manifest)
        return key

    def recv(self, key, timeout_ms=30000):
        """Fetch, reassemble and CRC-verify a payload by key."""
        raw = self._get(f"{key}/manifest", timeout_ms)
        head, manifest = raw.split(b"\n", 1)
        n_chunks = json.loads(head.decode())["chunks"]
        blob = b"".join(self._get(f"{key}/c{i}", timeout_ms)
                        for i in range(n_chunks))
        return verify_payload(self._unpack(manifest, blob))

    def delete(self, key):
        """Best-effort cleanup of a consumed transfer."""
        mkey = f"{key}/manifest"
        n = 0
        try:
            if not hasattr(self.store, "check") or self.store.check([mkey]):
                head, _ = self._get(mkey, None).split(b"\n", 1)
                n = json.loads(head.decode())["chunks"]
        except Exception:
            n = 0
        for i in range(n):
            self.store.delete_key(f"{key}/c{i}")
        self.store.delete_key(mkey)
