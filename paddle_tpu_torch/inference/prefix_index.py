"""Fleet-wide content-addressed prefix index (cache-aware routing).

Counterpart of `paddle_tpu/inference/prefix_index.py` (it imports no JAX;
the port keeps its own copy). The per-engine `PrefixCache` content-
addresses full prompt pages by a chain key — nested (parent_key,
page_tokens) tuples, so a page matches only when its whole prompt prefix
matches. This module publishes those chain keys fleet-wide as digests, so
the router can send a request to the replica that already holds its
prefix:

  - `chain_digest(parent_digest, page_tokens)`: one sha1 step per page
    over the parent's hex digest and the page's int64 token bytes, so
    digest_j names the exact token content of the first j pages. The hex
    strings equal the reference's byte for byte.
  - `PrefixIndex`: the in-process backend — {digest: {replica: (n_pages,
    stamp)}} with a monotonic stamp for expiry and an LRU entry cap.
    Engines publish on prefill / import and retract on cache eviction; the
    router reads `lookup()` at admission.
  - `StorePrefixIndex`: the same surface over a `torch.distributed` store
    (`HashStore` / `TCPStore`) for fleets of processes — last-writer-wins
    JSON per digest key, a store counter (`add`) as the shared stamp
    clock, and a per-replica digest roster for `drop_replica`.

The index is advisory and eventually consistent: a publish that fails
(the `index.publish` fault point) is counted by the engine and never fails
a request, and a stale claim costs one re-prefill, never correctness.
"""
import collections
import hashlib
import json

import numpy as np

from ..failsafe import fault_point

EMPTY_DIGEST = ""


def chain_digest(parent_digest, page_tokens):
    """Digest of a page chain extended by one page: sha1 over the parent's
    hex digest + this page's token content (int64 bytes). Two chains share
    a digest iff they share the whole token prefix."""
    h = hashlib.sha1(parent_digest.encode())
    h.update(np.ascontiguousarray(
        np.asarray(page_tokens, np.int64)).tobytes())
    return h.hexdigest()


def prompt_digests(ids, page_size):
    """Digests of every full-page prefix of a prompt, shortest first:
    digests[j-1] names pages 0..j-1. The partial tail page is excluded —
    only full pages are ever published."""
    ids = np.asarray(ids, np.int64).ravel()
    out = []
    d = EMPTY_DIGEST
    for j in range(ids.size // page_size):
        d = chain_digest(d, ids[j * page_size:(j + 1) * page_size])
        out.append(d)
    return out


def chain_key_digest(chain_key):
    """Digest of a PrefixCache chain key (nested (parent, tokens) tuples) —
    what an engine retracts when its cache evicts that entry."""
    chunks = []
    key = chain_key
    while key != ():
        key, toks = key
        chunks.append(toks)
    d = EMPTY_DIGEST
    for toks in reversed(chunks):
        d = chain_digest(d, toks)
    return d


class PrefixIndex:
    """In-process fleet prefix index: {digest: {replica: (n_pages,
    stamp)}}. `publish` carries the `index.publish` fault point (callers
    treat publish as advisory and swallow the raise)."""

    def __init__(self, max_entries=65536):
        self.max_entries = int(max_entries)
        self._entries = collections.OrderedDict()
        self._stamp = 0
        self.publishes = 0
        self.retractions = 0

    def __len__(self):
        return len(self._entries)

    def clock(self):
        """Monotonic publish stamp (for expire())."""
        return self._stamp

    def publish(self, replica, digest, n_pages):
        """Record that `replica` holds the `n_pages`-page chain named by
        `digest`. Re-publishing refreshes the stamp."""
        fault_point("index.publish", detail=f"{replica}:{n_pages}")
        self._stamp += 1
        ent = self._entries.get(digest)
        if ent is None:
            ent = self._entries[digest] = {}
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
        else:
            self._entries.move_to_end(digest)
        ent[replica] = (int(n_pages), self._stamp)
        self.publishes += 1

    def retract(self, replica, digest):
        """Remove one replica's claim on a digest (cache eviction)."""
        ent = self._entries.get(digest)
        if ent is None:
            return
        if ent.pop(replica, None) is not None:
            self.retractions += 1
        if not ent:
            del self._entries[digest]

    def drop_replica(self, replica):
        """Remove every claim by a replica (declared dead, rebuilt, or
        weight-flipped). Returns the number of claims dropped."""
        dropped = 0
        for digest in list(self._entries):
            ent = self._entries[digest]
            if ent.pop(replica, None) is not None:
                dropped += 1
            if not ent:
                del self._entries[digest]
        self.retractions += dropped
        return dropped

    def expire(self, max_age):
        """Drop claims whose stamp is older than `max_age` publishes ago
        (publishers that died without retracting). Returns the number of
        claims dropped."""
        floor = self._stamp - int(max_age)
        dropped = 0
        for digest in list(self._entries):
            ent = self._entries[digest]
            for rep in [r for r, (_, s) in ent.items() if s < floor]:
                del ent[rep]
                dropped += 1
            if not ent:
                del self._entries[digest]
        self.retractions += dropped
        return dropped

    def lookup(self, digests):
        """{replica: covered_pages} — each replica's longest published
        chain among `digests` (shortest-first, as prompt_digests returns
        them). Empty dict on a cold fleet."""
        out = {}
        for j in range(len(digests), 0, -1):
            ent = self._entries.get(digests[j - 1])
            if not ent:
                continue
            for rep in ent:
                if rep not in out:
                    out[rep] = j
        return out

    def stats(self):
        return {"entries": len(self._entries), "stamp": self._stamp,
                "publishes": self.publishes,
                "retractions": self.retractions}


class StorePrefixIndex:
    """The PrefixIndex surface over a `torch.distributed` Store.

    Layout: `{prefix}/e/{digest}` holds a JSON {replica: [n_pages, stamp]}
    map (read-modify-write, last-writer-wins — tolerable for a routing
    hint); `{prefix}/r/{replica}` is that replica's published digest
    roster (what drop_replica walks); `{prefix}/clock` is the shared stamp
    counter (store.add)."""

    def __init__(self, store, prefix="pfxidx", max_roster=4096,
                 max_probe=32):
        self.store = store
        self.prefix = prefix
        self.max_roster = int(max_roster)
        # lookup() round-trip bound: probe at most this many digests
        # (longest first) per admission
        self.max_probe = int(max_probe)
        self.publishes = 0
        self.retractions = 0

    @property
    def endpoint(self):
        """(host, port, prefix) of a TCPStore-backed index — what another
        process needs to open its own client (StorePrefixIndex.connect)."""
        return (self.store.host, self.store.port, self.prefix)

    @classmethod
    def connect(cls, host, port, prefix="pfxidx", **kw):
        """An index client on a fresh TCPStore connection."""
        import torch.distributed as dist
        return cls(dist.TCPStore(host, int(port), is_master=False),
                   prefix=prefix, **kw)

    # -- store helpers ------------------------------------------------------
    def _get_json(self, key, default):
        # a torch Store's get() blocks on a missing key; check() is the
        # non-blocking existence probe
        try:
            if not self.store.check([key]):
                return default
            return json.loads(bytes(self.store.get(key)).decode())
        except (KeyError, ValueError):
            return default

    def _set_json(self, key, obj):
        self.store.set(key, json.dumps(obj).encode())

    def clock(self):
        return self._get_json(f"{self.prefix}/clock_v", 0)

    # -- index surface ------------------------------------------------------
    def publish(self, replica, digest, n_pages):
        fault_point("index.publish", detail=f"{replica}:{n_pages}")
        stamp = int(self.store.add(f"{self.prefix}/clock", 1))
        self._set_json(f"{self.prefix}/clock_v", stamp)
        ekey = f"{self.prefix}/e/{digest}"
        ent = self._get_json(ekey, {})
        ent[replica] = [int(n_pages), stamp]
        self._set_json(ekey, ent)
        rkey = f"{self.prefix}/r/{replica}"
        roster = self._get_json(rkey, [])
        if digest not in roster:
            roster.append(digest)
            dropped = roster[:-self.max_roster]
            roster = roster[-self.max_roster:]
            self._set_json(rkey, roster)
            # claims trimmed off the roster leave the store too:
            # drop_replica only walks the roster
            for old in dropped:
                self.retract(replica, old)
        self.publishes += 1

    def retract(self, replica, digest):
        ekey = f"{self.prefix}/e/{digest}"
        ent = self._get_json(ekey, {})
        if ent.pop(replica, None) is None:
            return
        self.retractions += 1
        if ent:
            self._set_json(ekey, ent)
        else:
            self.store.delete_key(ekey)

    def drop_replica(self, replica):
        rkey = f"{self.prefix}/r/{replica}"
        roster = self._get_json(rkey, [])
        for digest in roster:
            self.retract(replica, digest)
        self.store.delete_key(rkey)
        return len(roster)

    def expire(self, max_age):
        """The store has no key enumeration: operators run drop_replica on
        dead workers instead. Walks no keys, returns 0."""
        return 0

    def lookup(self, digests):
        """Longest-chain claims, bounded: probes at most `max_probe`
        digests longest-first and stops at the first hit (replicas holding
        only shorter prefixes are omitted — a hint degradation)."""
        out = {}
        floor = max(0, len(digests) - self.max_probe)
        for j in range(len(digests), floor, -1):
            ent = self._get_json(f"{self.prefix}/e/{digests[j - 1]}", {})
            if ent:
                for rep in ent:
                    out[rep] = j
                break
        return out

    def stats(self):
        return {"entries": None, "stamp": self.clock(),
                "publishes": self.publishes,
                "retractions": self.retractions}
