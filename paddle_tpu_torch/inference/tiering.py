"""KV tiering: demoted request pages in host RAM, spilled to disk.

Counterpart of `paddle_tpu/inference/tiering.py`. The scheduler's demote
path (`ContinuousBatchingEngine.demote_request`) moves a cold request's
device pages into this store in the CRC-stamped page-export format of the
handoff (`inference/handoff.py`: one integrity layer for transfers and
tiers), and `restore_request` claims fresh device pages and writes the
bytes back. Admission can then oversubscribe the device pool: the overflow
lives here.

Tier order is device -> host RAM -> disk: puts land in the host dict; when
the host tier's byte budget overflows, the oldest entries spill to disk
(temp write and rename, one manifest and one blob file per entry, in the
StoreKVTransport wire format, so the CRCs stamped at demote ride into the
files). `get` reads host or disk and re-verifies every CRC: a corrupt or
torn entry raises KVHandoffError, which the scheduler turns into a typed
restore failure of that one request.
"""
import collections
import os
import time

from .handoff import StoreKVTransport, verify_payload


class KVTierError(RuntimeError):
    """A tier operation failed at the store layer (missing entry, disk IO).
    Integrity failures raise KVHandoffError instead."""


def resolve_tier(kv_tier, tier_dir=None, host_cap_mb=None):
    """Engine-knob resolution: None/False -> None, a KVTierStore passes
    through, "host"/"disk" builds one."""
    if kv_tier in (None, False):
        return None
    if isinstance(kv_tier, KVTierStore):
        return kv_tier
    if kv_tier not in ("host", "disk"):
        raise ValueError(
            f"kv_tier must be None, 'host', 'disk' or a KVTierStore, got "
            f"{kv_tier!r}")
    return KVTierStore(kind=kv_tier, tier_dir=tier_dir,
                       host_cap_mb=host_cap_mb)


class KVTierStore:
    """Two-level store of demoted KV page images.

    kind="host": host RAM only (host_cap_mb ignored).
    kind="disk": host RAM in front, with a byte budget (host_cap_mb,
      default 64); the overflow spills oldest first to `tier_dir`
      (required) as <token>.manifest + <token>.blob, each written to a
      temporary name and renamed into place.

    Entries are keyed by the allocator transfer token minted at demote; the
    token is burned at restore (PageAllocator.import_begin), so one entry
    seats at most one continuation.
    """

    def __init__(self, kind="host", tier_dir=None, host_cap_mb=None):
        if kind not in ("host", "disk"):
            raise ValueError(f"kind must be 'host' or 'disk', got {kind!r}")
        if kind == "disk" and not tier_dir:
            raise ValueError("kind='disk' needs tier_dir=")
        self.kind = kind
        self.dir = tier_dir
        if tier_dir:
            os.makedirs(tier_dir, exist_ok=True)
        self.host_cap = int((host_cap_mb if host_cap_mb is not None
                             else 64) * 1e6)
        self._host = collections.OrderedDict()   # token -> (manifest, blob)
        self.host_bytes = 0
        self.spills = 0          # host -> disk demotions
        self.disk_reads = 0      # restores served from disk
        self.puts = 0
        self.gets = 0
        # the store's own share of demote -> restore (packing, verifying,
        # spilling)
        self.put_seconds = 0.0
        self.get_seconds = 0.0

    def __contains__(self, token):
        return token in self._host or (
            self.dir is not None
            and os.path.exists(self._path(token, "manifest")))

    def __len__(self):
        n = len(self._host)
        if self.dir is not None:
            n += sum(1 for f in os.listdir(self.dir)
                     if f.endswith(".manifest")
                     and f[:-len(".manifest")] not in self._host)
        return n

    def _path(self, token, ext):
        return os.path.join(self.dir, f"{token}.{ext}")

    # -- tier surface -------------------------------------------------------
    def put(self, token, payload):
        """Store a checksum_payload-stamped page image under `token`,
        packed at once into one blob (the tier never aliases live pool
        memory)."""
        t0 = time.perf_counter()
        manifest, blob = StoreKVTransport._pack(payload)
        self._host[token] = (manifest, blob)
        self.host_bytes += len(blob)
        self.puts += 1
        if self.kind == "disk":
            while self.host_bytes > self.host_cap and len(self._host) > 1:
                self._spill_oldest()
        self.put_seconds += time.perf_counter() - t0

    def _spill_oldest(self):
        token, (manifest, blob) = self._host.popitem(last=False)
        self.host_bytes -= len(blob)
        for ext, data in (("blob", blob), ("manifest", manifest)):
            tmp = self._path(token, ext) + ".tmp"
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._path(token, ext))
        self.spills += 1

    def get(self, token):
        """Unpack and CRC-verify the entry; KVHandoffError on corruption,
        KVTierError when the entry does not exist."""
        t0 = time.perf_counter()
        ent = self._host.get(token)
        if ent is None and self.dir is not None:
            try:
                with open(self._path(token, "manifest"), "rb") as f:
                    manifest = f.read()
                with open(self._path(token, "blob"), "rb") as f:
                    blob = f.read()
            except OSError as e:
                raise KVTierError(
                    f"tier entry {token!r} unreadable: {e}") from e
            ent = (manifest, blob)
            self.disk_reads += 1
        if ent is None:
            raise KVTierError(
                f"tier entry {token!r} not found (already restored, or the "
                "tier lost it)")
        self.gets += 1
        out = verify_payload(StoreKVTransport._unpack(*ent))
        self.get_seconds += time.perf_counter() - t0
        return out

    def delete(self, token):
        """Best-effort removal (restore committed, or the request died)."""
        ent = self._host.pop(token, None)
        if ent is not None:
            self.host_bytes -= len(ent[1])
        if self.dir is not None:
            for ext in ("manifest", "blob"):
                try:
                    os.unlink(self._path(token, ext))
                except OSError:
                    pass

    def stats(self):
        return {"kind": self.kind, "entries": len(self),
                "host_entries": len(self._host),
                "host_bytes": self.host_bytes,
                "spills": self.spills, "disk_reads": self.disk_reads,
                "puts": self.puts, "gets": self.gets,
                "put_ms": round(self.put_seconds * 1e3, 3),
                "get_ms": round(self.get_seconds * 1e3, 3)}
