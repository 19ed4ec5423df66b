"""Continuous-batching scheduler over the paged-KV serving engine.

Counterpart of `paddle_tpu/inference/scheduler.py` (`ContinuousBatchingEngine`,
greedy decoding):

  ContinuousBatchingEngine(model, ...).add_request(ids, ...) -> uid
  .step()          one engine iteration (admit / prefill chunk / decode)
  .drain()         run until idle, return {uid: output}
  .generate_many() submit-and-drain (greedy outputs equal one-at-a-time
                   LLMEngine.generate())

Scheduling model (as in the reference):
  - max_batch slots. A request is admitted into the lowest free slot once
    its KV pages fit, prefills its prompt in chunks of `prefill_chunk`
    tokens, then joins the decode batch. Each sequence retires at its own
    EOS or budget and its slot and pages free at once for the queue.
  - a decode step runs at the smallest slot bucket covering the highest
    live slot, with an `active` mask for retired slots.
  - prefix cache: full prompt pages are content-addressed by a chain key;
    a request sharing a cached prefix takes refcounted read-only
    references, and a shared page covering its divergence point is
    copied on the first write (copy-on-write). Cache-only pages evict LRU.
  - decode_block=K > 1: one block is a ragged prefill phase (every
    prefilling slot advances one chunk at its own offset, attention through
    `ragged_paged_attention`) plus K decode steps whose carries (token,
    length, active flag, remaining budget) stay on the device, with EOS and
    budget retirement computed there. The host reads a block's tokens once;
    in a pure-decode steady state block N+1 is queued before block N is read.
  - megakernel="layer" | "multi": each decode step runs its layers through
    `decode_megakernel`, one launch per layer ("layer", the final norm and
    the lm_head stay the op chain) or one launch per step ("multi", the
    final norm, the lm_head and the greedy argmax inside). The kernel reads
    the engine's own weights and pools through a pointer table
    (`MegakernelPack`), rebuilt whenever the pools are.

Where the reference compiles a program per shape and donates the KV pools
to it, this port runs the same math eagerly and updates the pools in place
(`index_copy_` into a flat view of each layer's pool). The reference drops
masked KV writes (`.at[slots].set(..., mode="drop")` with out-of-range
slots); torch has no drop mode, so masked rows are redirected to one
scratch row past the end of the pool, which no page table can name.

Not ported yet (each raises, naming its ROADMAP item): sampling,
speculation, tenants and preemption, KV tiering, adapters, telemetry,
tensor parallelism, PTQ scales, the fleet prefix index, and KV
export/import. The reference's fault points wait for the port of
`failsafe.py`.
"""
import collections
import math
import time

import numpy as np
import torch

from .serving import EngineFullError, LLMEngine, PageAllocator, _as_numpy, \
    _mm, _rms
from ..ops.pallas.decode_megakernel import (MAX_ROWS, MegakernelPack,
                                            decode_megakernel,
                                            megakernel_supported)
from ..ops.pallas.paged_attention import (expand_kv_heads, paged_attention,
                                          ragged_paged_attention)

QUEUED, PREFILL, DECODE, DONE, FAILED, CANCELLED = \
    "queued", "prefill", "decode", "done", "failed", "cancelled"


class SchedulerError(RuntimeError):
    """Base of the scheduler's typed errors."""


class EngineBusyError(SchedulerError):
    """Backpressure: the admission queue is at queue_limit. The caller
    should shed load or retry later — nothing was enqueued."""


class UnknownRequestError(SchedulerError, KeyError):
    """A uid this engine has never issued (or one already forgotten)."""

    def __str__(self):              # KeyError repr-quotes its arg
        return self.args[0] if self.args else ""


class RequestNotFinishedError(SchedulerError):
    """result() on a request that is still queued/prefilling/decoding."""


class RequestFailedError(SchedulerError):
    """result() on a request that was retired with an error; carries the
    RequestFailure record as .failure."""

    def __init__(self, failure):
        self.failure = failure
        super().__init__(str(failure))


class RequestCancelledError(RequestFailedError):
    """result() on a request retired by cancel()."""


class DeadlineExceededError(SchedulerError):
    """Recorded error for a request whose deadline/TTL expired before it
    finished."""


class RequestFailure:
    """Typed per-request error record: which request died, at what stage,
    with what error — while the engine kept stepping."""

    __slots__ = ("uid", "stage", "error", "message", "step",
                 "tokens_generated")

    def __init__(self, uid, stage, exc, step, tokens_generated=0):
        self.uid = uid
        self.stage = stage              # admit | prefill | decode |
        #                                 deadline | cancel | engine
        self.error = type(exc).__name__
        self.message = str(exc)
        self.step = step                # engine step count at failure
        self.tokens_generated = tokens_generated

    def __repr__(self):
        return (f"RequestFailure(uid={self.uid}, stage={self.stage!r}, "
                f"error={self.error}, step={self.step})")

    def __str__(self):
        return (f"request {self.uid} failed at stage {self.stage!r} "
                f"(engine step {self.step}): {self.error}: {self.message}")


class Request:
    """One in-flight generation request (host-side bookkeeping only)."""

    __slots__ = ("uid", "ids", "t0", "max_new_tokens", "eos_token_id",
                 "state", "slot", "pages", "shared_idx", "cow_reserve",
                 "filled", "tok", "out", "result", "pages_shared",
                 "deadline", "ttl_steps", "born_step", "error")

    def __init__(self, uid, ids, max_new_tokens, eos_token_id,
                 deadline=None, ttl_steps=None, born_step=0):
        self.uid = uid
        self.ids = ids                  # np.int64 [t0]
        self.t0 = int(ids.size)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = eos_token_id
        self.state = QUEUED
        self.slot = None
        self.pages = []                 # page ids, one per table index
        self.shared_idx = set()         # table indices that are read-only
        self.cow_reserve = None         # page reserved for the one
        #                                 possible copy-on-write
        self.filled = 0                 # prompt tokens already in cache
        self.tok = None                 # next token id to feed
        self.out = []                   # generated token ids
        self.result = None              # np.int64 [t0 + n_generated]
        self.pages_shared = 0
        self.deadline = deadline        # absolute time.monotonic() cutoff
        self.ttl_steps = ttl_steps      # engine-step budget (deterministic)
        self.born_step = born_step      # engine step count at submission
        self.error = None               # RequestFailure when retired bad


class PrefixCache:
    """Content-addressed read-only KV pages, LRU-evicted under pressure.

    Full prompt pages are keyed by a chain key — nested tuples
    (parent_key, page_tokens) — so a page only matches when its entire
    prompt prefix matches. A secondary index of each node's children lets
    a request whose prompt diverges mid-page share that page read-only
    (the engine copies it on the first divergent write). The cache holds
    its own allocator reference per page, so cached pages survive their
    creator's retirement and free only on eviction.
    """

    def __init__(self, page_size):
        self.p = page_size
        self._entries = collections.OrderedDict()   # chain_key -> page
        self._children = {}      # chain_key -> {page: tokens tuple}
        self._by_page = {}       # page -> chain_key
        self.hits = 0            # pages served from cache (counted by
        self.misses = 0          # the scheduler at admission)

    def __len__(self):
        return len(self._entries)

    def match(self, ids):
        """Longest cached cover of a prefix of `ids` (1-D np array).
        Returns (pages, covered): `pages` to install at table indices
        0..len-1, `covered` counted in tokens. The last page may cover
        tokens through the end of the prompt even when the prompt ends
        mid-page (partial-index hit) — the scheduler re-runs the final
        token and copies that page before any write."""
        p = self.p
        key = ()
        pages = []
        j = 0
        while (j + 1) * p <= ids.size:
            k2 = (key, tuple(int(t) for t in ids[j * p:(j + 1) * p]))
            page = self._entries.get(k2)
            if page is None:
                break
            self._entries.move_to_end(k2)
            pages.append(page)
            key = k2
            j += 1
        covered = j * p
        rem = tuple(int(t) for t in ids[j * p:])
        if rem and len(rem) < p:
            # mid-page divergence: a cached child page whose tokens start
            # with the remaining prompt can be shared (and copied on write)
            for page, tokens in self._children.get(key, {}).items():
                if tokens[:len(rem)] == rem:
                    owner = self._by_page.get(page)
                    if owner is not None:
                        self._entries.move_to_end(owner)
                    pages.append(page)
                    covered = ids.size
                    break
        return pages, covered

    def insert(self, parent_key, tokens, page, allocator):
        """Register `page` as the cached KV for `tokens` under
        `parent_key`; the cache takes its own allocator reference.
        Returns the page's chain key (parent for the next page). No-op
        (returning the key) when an entry already exists."""
        toks = tuple(int(t) for t in tokens)
        key = (parent_key, toks)
        if key in self._entries:
            self._entries.move_to_end(key)
            return key
        allocator.share(page)
        self._entries[key] = page
        self._children.setdefault(parent_key, {})[page] = toks
        self._by_page[page] = key
        return key

    def chain_key(self, parent_key, tokens):
        return (parent_key, tuple(int(t) for t in tokens))

    def continuation(self, ids, k):
        """Up to `k` tokens following `ids` along the cached page chains
        (the prefix-cache drafter's walk). Every full page of `ids` must
        be cached; the partial tail then selects a cached child page that
        extends it, and full-page children keep the walk descending.
        Returns an int64 array, possibly empty."""
        p = self.p
        ids = np.asarray(ids)
        key = ()
        for j in range(ids.size // p):
            key = (key, tuple(int(t) for t in ids[j * p:(j + 1) * p]))
            if key not in self._entries:
                return np.empty((0,), np.int64)
        rem = tuple(int(t) for t in ids[(ids.size // p) * p:])
        out = []
        while len(out) < k:
            nxt = None
            for tokens in self._children.get(key, {}).values():
                if len(tokens) > len(rem) and tokens[:len(rem)] == rem:
                    nxt = tokens
                    break
            if nxt is None:
                break
            out.extend(nxt[len(rem):])
            key = (key, nxt)
            rem = ()
        return np.asarray(out[:k], np.int64)

    def evict(self, n_pages, allocator, protect=()):
        """Free up to `n_pages` cache-only pages (refcount 1), oldest
        first, skipping `protect`. Returns the number freed. An entry that
        cannot be evicted now (protected, still read by a running request,
        or under a pending export ticket) is in use, so it moves to the
        MRU end instead of being rescanned; each entry is examined at most
        once per call."""
        freed = 0
        scanned = 0
        limit = len(self._entries)
        while freed < n_pages and scanned < limit and self._entries:
            key = next(iter(self._entries))
            page = self._entries[key]
            scanned += 1
            if page in protect or allocator.refcount(page) != 1 or \
                    allocator.is_exporting(page):
                self._entries.move_to_end(key)
                continue
            self._drop(key, page)
            allocator.free([page])
            freed += 1
        return freed

    def clear(self, allocator=None):
        if allocator is not None:
            for key, page in list(self._entries.items()):
                if allocator.refcount(page) > 0:
                    allocator.free([page])
        self._entries.clear()
        self._children.clear()
        self._by_page.clear()

    def _drop(self, key, page):
        del self._entries[key]
        self._by_page.pop(page, None)
        kids = self._children.get(key[0])
        if kids is not None:
            kids.pop(page, None)
            if not kids:
                del self._children[key[0]]


class _FusedBlock:
    """One in-flight fused block (decode_block > 1): which requests rode
    it, plus the device tensors the host has not read yet. The carries
    (tok/lens/act/rem) stay on the device, so the next block can start
    from them without a host round trip."""

    __slots__ = ("w", "K", "pf_items", "dec_items", "tables", "eos_dev",
                 "first", "toks", "emitted", "tok_fin", "lens_fin",
                 "act_fin", "rem_fin", "has_prefill", "has_decode")

    def __init__(self, w, K):
        self.w = w
        self.K = K
        self.pf_items = []          # [(Request, chunk-end position)]
        self.dec_items = []         # [Request]
        self.tables = None          # device [w, mp] (reused by chains)
        self.eos_dev = None         # device [w] eos ids (-1 = none)
        self.first = None           # device [w] first tokens (prefill)
        self.toks = None            # device [K, w] tokens
        self.emitted = None         # device [K, w] bool: token is real
        self.tok_fin = self.lens_fin = self.act_fin = self.rem_fin = None
        self.has_prefill = False
        self.has_decode = False


def _not_ported(name, item):
    return NotImplementedError(
        f"{name} is not ported to paddle_tpu_torch yet (ROADMAP {item})")


class ContinuousBatchingEngine(LLMEngine):
    """Request-at-a-time greedy serving over the paged-KV engine.

    Knobs on top of LLMEngine's:
      prefill_chunk: prompt tokens per prefill step (default page_size).
      slot_buckets: decode widths (default powers of two up to max_batch).
      prefix_cache: content-addressed prompt-page sharing.
      queue_limit: add_request past this queue depth raises
        EngineBusyError. None = unbounded.
      default_deadline_ms: deadline for requests submitted without one.
      decode_block: K > 1 runs fused blocks (a ragged prefill phase plus K
        decode steps, carries on the device); deadlines and TTLs are
        checked at block boundaries (rounded up).
      ragged_kernel: attention of the fused prefill phase. None (default)
        = the ragged kernel on CUDA and the dense gathered form on the
        CPU (the form that keeps K > 1 equal to K = 1 there); True forces
        `ragged_paged_attention` (its plain version on the CPU), False the
        dense gathered form.
      megakernel: the decode step's layers through `decode_megakernel`.
        None (default) = "layer" on CUDA where the kernel takes the
        geometry and the weights, off on the CPU; False = the op chain;
        True / "layer" = one launch per layer; "multi" = one launch per
        step with the final norm, the lm_head and the greedy argmax inside.
        On the CPU a forced mode runs the kernel's plain version.

    Failure posture: a request that fails at a per-request boundary
    (admission, deadline, cancel) retires alone with a RequestFailure
    record, its pages and prefix references reclaimed. An exception inside
    a step rebuilds the pools (every in-flight request fails with stage
    "engine"); queued requests survive.
    """

    def __init__(self, model, max_len=1024, page_size=128, max_batch=8,
                 prefill_chunk=None, slot_buckets=None, prefix_cache=True,
                 queue_limit=None, default_deadline_ms=None,
                 decode_block=1, ragged_kernel=None, do_sample=False,
                 megakernel=None, speculate=None, tenants=None,
                 kv_tier=None, oversubscribe=None, tier_idle_steps=None,
                 telemetry=None, adapters=None, **kw):
        if do_sample:
            raise _not_ported("sampling (do_sample=True)",
                              "A5(c), inference/sampling.py")
        if speculate not in (None, False, 0, 1):
            raise _not_ported(f"speculate={speculate!r}",
                              "A5(d), speculation")
        if tenants:
            raise _not_ported("tenants (priority admission, preemption)",
                              "A5(e), tenants and preemption")
        if kv_tier is not None or oversubscribe or \
                tier_idle_steps is not None:
            raise _not_ported("KV tiering (kv_tier, oversubscribe, "
                              "tier_idle_steps)", "A7.4, tiering.py")
        if adapters not in (None, False):
            raise _not_ported("adapters", "A7.2, adapters.py")
        if telemetry not in (None, False):
            raise _not_ported("telemetry", "A7.3, telemetry.py")
        super().__init__(model, max_len=max_len, page_size=page_size,
                         max_batch=max_batch, **kw)
        self.prefill_chunk = int(prefill_chunk or page_size)
        self.decode_block = max(1, int(decode_block))
        self.ragged_kernel = ragged_kernel
        if slot_buckets is None:
            slot_buckets = []
            w = 1
            while w < max_batch:
                slot_buckets.append(w)
                w *= 2
        self._slot_buckets = tuple(sorted(
            {min(int(w), max_batch) for w in slot_buckets} | {max_batch}))
        self._prefix = PrefixCache(page_size) if prefix_cache else None
        self.queue_limit = (None if queue_limit is None
                            else int(queue_limit))
        self.default_deadline_ms = default_deadline_ms
        self._queue = collections.deque()
        self._requests = {}
        self._slots = [None] * max_batch
        self._tables_np = np.zeros((max_batch, self.max_pages_per_seq),
                                   np.int64)
        self._lens_np = np.zeros(max_batch, np.int64)
        self._tok_np = np.zeros(max_batch, np.int64)
        self._slot_used = [False] * max_batch
        self._next_uid = 0
        self._prefer_decode = False
        self._pending = None            # in-flight fused block (not read)
        self._arange = {}               # cached device aranges by length

        # observability (tests and chip_smoke.py assert on these)
        self.steps = 0
        self.decode_steps = 0
        self.prefill_steps = 0
        self.admissions = 0
        self.slot_reuses = 0
        self.cow_copies = 0
        self.failure_count = 0
        self.deadline_expiries = 0
        self.fused_blocks = 0
        self.chained_blocks = 0         # blocks queued before the previous
        #                                 block's read-back
        self._mk_pack = None
        self.megakernel = self._resolve_megakernel(megakernel)
        if self.megakernel:
            self._build_mk_pack()

    # -- public ------------------------------------------------------------
    def add_request(self, ids, max_new_tokens=32, eos_token_id=None,
                    deadline_ms=None, ttl_steps=None, sampling=None,
                    tenant=None, priority=None, adapter=None):
        """Queue one prompt (1-D int sequence). Returns a request uid.

        deadline_ms: wall-clock budget from now; a request still
          unfinished when it expires retires with a DeadlineExceededError
          record (queued requests are shed without ever running).
        ttl_steps: the same contract counted in engine steps.
        Raises EngineBusyError (nothing enqueued) when the admission queue
        is at queue_limit."""
        if sampling is not None:
            raise _not_ported("per-request sampling (SamplingParams)",
                              "A5(c), inference/sampling.py")
        if tenant is not None or priority is not None:
            raise _not_ported("tenant/priority admission",
                              "A5(e), tenants and preemption")
        if adapter is not None:
            raise _not_ported("adapters", "A7.2, adapters.py")
        ids = np.asarray(_as_numpy(ids), np.int64).ravel()
        if ids.size == 0:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if ids.size + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt length {ids.size} + max_new_tokens "
                f"{max_new_tokens} = {ids.size + max_new_tokens} exceeds "
                f"this engine's max_len={self.max_len}")
        if self.queue_limit is not None and \
                len(self._queue) >= self.queue_limit:
            raise EngineBusyError(
                f"admission queue full: {len(self._queue)} queued "
                f"requests at queue_limit={self.queue_limit} "
                f"({sum(1 for s in self._slots if s)} running); retry "
                "later or raise queue_limit")
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        deadline = (time.monotonic() + deadline_ms / 1e3
                    if deadline_ms is not None else None)
        r = Request(self._next_uid, ids, max_new_tokens, eos_token_id,
                    deadline=deadline,
                    ttl_steps=None if ttl_steps is None else int(ttl_steps),
                    born_step=self.steps)
        self._next_uid += 1
        self._requests[r.uid] = r
        self._queue.append(r)
        return r.uid

    def cancel(self, uid):
        """Cancel a request. Queued: shed before it ever runs. In flight:
        retired now, slot/pages/prefix references reclaimed. Returns True
        if this call cancelled it, False if it had already finished (or
        failed). Unknown uids raise UnknownRequestError."""
        r = self._requests.get(uid)
        if r is None:
            raise UnknownRequestError(f"unknown request uid {uid}")
        if r.state in (DONE, FAILED, CANCELLED):
            return False
        if r.state == QUEUED:
            self._queue.remove(r)
        self._fail_request(
            r, "cancel", SchedulerError(f"request {uid} cancelled"),
            state=CANCELLED)
        return True

    def step(self):
        """One engine iteration. Returns False when there is nothing to
        do.

        decode_block == 1: shed expired deadlines, admit what fits, then
        run one prefill chunk or one decode step (alternating when both
        have work, so long prompts don't stall live decodes).

        decode_block == K > 1: one block — a ragged prefill phase plus K
        decode steps, read back once (see _fused_step)."""
        if self.decode_block > 1:
            return self._fused_step()
        self._expire_deadlines()
        self._admit()
        prefills = [r for r in self._slots if r and r.state == PREFILL]
        decodes = [r for r in self._slots if r and r.state == DECODE]
        if not prefills and not decodes:
            return self._idle_or_raise()
        self.steps += 1
        try:
            if prefills and (not decodes or not self._prefer_decode):
                self._prefill_step(prefills[0])
                self.prefill_steps += 1
                self._prefer_decode = True
            else:
                self._decode_step(decodes)
                self.decode_steps += 1
                self._prefer_decode = False
        except Exception:
            self._abort_in_flight()
            raise
        return True

    def drain(self):
        """Run until every queued/in-flight request retires. Returns
        {uid: output} for requests completed by this call. Requests that
        retired with an error are not in the dict; read them through
        failures()/result()."""
        before = {u for u, r in self._requests.items() if r.state == DONE}
        while self.step():
            pass
        return {uid: r.result for uid, r in self._requests.items()
                if r.state == DONE and uid not in before}

    def result(self, uid):
        """Output array for a finished request: [prompt + generated],
        trimmed at the request's own EOS (inclusive). Typed errors:
        UnknownRequestError, RequestNotFinishedError, RequestCancelledError
        and RequestFailedError (carrying the RequestFailure record)."""
        r = self._requests.get(uid)
        if r is None:
            raise UnknownRequestError(f"unknown request uid {uid}")
        if r.state == CANCELLED:
            raise RequestCancelledError(r.error)
        if r.state == FAILED:
            raise RequestFailedError(r.error)
        if r.state != DONE:
            raise RequestNotFinishedError(
                f"request {uid} is {r.state}, not done")
        return r.result

    def status(self, uid):
        """State string for a uid: queued/prefill/decode/done/failed/
        cancelled."""
        r = self._requests.get(uid)
        if r is None:
            raise UnknownRequestError(f"unknown request uid {uid}")
        return r.state

    def failures(self):
        """{uid: RequestFailure} for every request retired with an error
        (cancellations included)."""
        return {u: r.error for u, r in self._requests.items()
                if r.error is not None}

    def pending(self):
        """uids still queued or in flight, in submission order."""
        return [u for u, r in self._requests.items()
                if r.state in (QUEUED, PREFILL, DECODE)]

    def __len__(self):
        """Number of requests still queued or in flight."""
        return sum(1 for r in self._requests.values()
                   if r.state in (QUEUED, PREFILL, DECODE))

    def queue_head_uid(self):
        """The uid next to be admitted (None with an empty queue)."""
        return self._pick_next().uid if self._queue else None

    def headroom(self):
        """O(1) routing snapshot: the subset of health() a router polls
        per request."""
        return {"queued": len(self._queue),
                "running": sum(1 for s in self._slots if s is not None),
                "slots_total": self.max_batch,
                "pages_free": self.allocator.available,
                "pages_total": self.allocator.n_pages}

    def health(self):
        """One serving-health snapshot: queue and slot occupancy, page-pool
        headroom, prefix-cache state and the lifetime counters. The keys
        are the reference's, for the features ported here."""
        states = collections.Counter(
            r.state for r in self._requests.values())
        return {
            "queued": len(self._queue),
            "running": sum(1 for s in self._slots if s is not None),
            "slots_total": self.max_batch,
            "queue_limit": self.queue_limit,
            "pages_free": self.allocator.available,
            "pages_total": self.allocator.n_pages,
            "prefix_pages": 0 if self._prefix is None else len(self._prefix),
            "prefix_hits": 0 if self._prefix is None else self._prefix.hits,
            "done": states[DONE],
            "failed": states[FAILED],
            "cancelled": states[CANCELLED],
            "steps": self.steps,
            "prefill_steps": self.prefill_steps,
            "decode_steps": self.decode_steps,
            "admissions": self.admissions,
            "failures": self.failure_count,
            "deadline_expiries": self.deadline_expiries,
            "cow_copies": self.cow_copies,
            "decode_block": self.decode_block,
            "fused_blocks": self.fused_blocks,
            "chained_blocks": self.chained_blocks,
            "megakernel": self.megakernel or "off",
            "megakernel_whole_step": self.megakernel == "multi",
        }

    def generate_many(self, prompts, max_new_tokens=32, eos_token_id=None):
        """Submit a list of (ragged) prompts and drain. Returns a list of
        1-D arrays in submission order."""
        if not isinstance(max_new_tokens, (list, tuple)):
            max_new_tokens = [max_new_tokens] * len(prompts)
        if len(max_new_tokens) != len(prompts):
            raise ValueError(
                f"max_new_tokens list has {len(max_new_tokens)} entries "
                f"for {len(prompts)} prompts")
        uids = [self.add_request(p, n, eos_token_id)
                for p, n in zip(prompts, max_new_tokens)]
        self.drain()
        return [self.result(u) for u in uids]

    def export_request(self, uid):
        raise _not_ported("export_request", "A7.6, handoff.py")

    def export_kv_pages(self, uid):
        raise _not_ported("export_kv_pages", "A7.6, handoff.py")

    def import_kv_pages(self, payload):
        raise _not_ported("import_kv_pages", "A7.6, handoff.py")

    def attach_prefix_index(self, index, replica):
        raise _not_ported("the fleet prefix index",
                          "A7.5, prefix_index.py")

    # -- admission ---------------------------------------------------------
    def _pages_needed(self, t0, max_new_tokens):
        # cache high-water: positions 0..t0+mnt-2 written, attention at
        # the last step reads lens+1 = t0+mnt-1 positions
        return -(-max(t0, t0 + max_new_tokens - 1) // self.page_size)

    def _pick_next(self):
        """Admission queue head: FIFO (the reference's order when no
        tenants or priorities are configured)."""
        return self._queue[0]

    def _release_slot(self, r):
        """Reclaim a request's slot, pages and CoW reserve (shared pages
        drop only this request's reference)."""
        if r.slot is not None:
            self._slots[r.slot] = None
            r.slot = None
        if r.pages:
            self.allocator.free(r.pages)
            r.pages = []
        if r.cow_reserve is not None:
            self.allocator.free([r.cow_reserve])
            r.cow_reserve = None
        r.shared_idx = set()

    def _price_admission(self, r):
        """(shared, resume, need, cow, fresh): the cached chain, the first
        position prefill must process, the raw page need, whether a CoW
        reserve is needed (the divergence point falls inside a shared
        page), and the pages a seat actually claims."""
        shared, covered = ([], 0) if self._prefix is None else \
            self._prefix.match(r.ids)
        resume = min(covered, r.t0 - 1)
        need = self._pages_needed(r.t0, r.max_new_tokens)
        n_shared = len(shared)
        cow = 1 if n_shared and resume // self.page_size < n_shared else 0
        return shared, resume, need, cow, need - n_shared + cow

    def _admit(self):
        while self._queue:
            r = self._pick_next()
            slot = next((i for i, s in enumerate(self._slots) if s is None),
                        None)
            if slot is None:
                return
            shared, resume, need, cow, fresh = self._price_admission(r)
            n_shared = len(shared)
            if fresh > self.allocator.available and self._prefix:
                self._prefix.evict(fresh - self.allocator.available,
                                   self.allocator, protect=set(shared))
            if fresh > self.allocator.available and shared:
                # sharing can cost more than a cold prefill in a tight
                # pool (the CoW reserve, plus matched pages protected from
                # eviction): fall back to an unshared admission
                shared, resume, cow = [], 0, 0
                n_shared = 0
                fresh = need
                if fresh > self.allocator.available and self._prefix:
                    self._prefix.evict(fresh - self.allocator.available,
                                       self.allocator)
            if fresh > self.allocator.available:
                return              # wait for retirements (FIFO order)
            self._queue.popleft()
            pages = []
            try:
                for pg in shared:
                    pages.append(self.allocator.share(pg))
                for _ in range(need - n_shared):
                    pages.append(self.allocator.alloc())
                r.cow_reserve = self.allocator.alloc() if cow else None
            except Exception as e:
                if pages:
                    self.allocator.free(pages)
                self._fail_request(r, "admit", e)
                continue
            if self._prefix is not None:
                if shared:
                    self._prefix.hits += len(shared)
                else:
                    self._prefix.misses += 1
            r.pages = pages
            r.shared_idx = set(range(n_shared))
            r.pages_shared = n_shared
            r.slot = slot
            r.filled = resume
            r.state = PREFILL
            self._slots[slot] = r
            self._tables_np[slot] = 0
            self._tables_np[slot, :len(pages)] = pages
            self._lens_np[slot] = 0
            self.admissions += 1
            if self._slot_used[slot]:
                self.slot_reuses += 1
            self._slot_used[slot] = True

    def _reclaim_pages(self, n):
        """generate()'s pool-pressure hook: idle prefix-cache pages are
        reclaimable."""
        if self._prefix is None:
            return 0
        return self._prefix.evict(n, self.allocator)

    # -- KV pools ----------------------------------------------------------
    def _reset_kv(self):
        """Fresh pools. Each layer's pool is the view of the first
        n_pages * page_size rows of a flat [n_pages * page_size + 1, h_kv,
        d] buffer; the last row is the scratch row masked writes land on.
        A rebuild invalidates every in-flight sequence's KV and the prefix
        cache (the fresh allocator re-issues cached page ids)."""
        for i, r in enumerate(getattr(self, "_slots", [])):
            if r is not None:
                r.state = FAILED
                if r.error is None:
                    r.error = RequestFailure(
                        r.uid, "engine",
                        SchedulerError("KV pools rebuilt mid-flight"),
                        getattr(self, "steps", 0),
                        tokens_generated=len(r.out))
                self.failure_count += 1
                r.pages = []          # the pool is rebuilt: page ids are
                r.cow_reserve = None  # meaningless, nothing to free
                r.shared_idx = set()
                r.slot = None
                self._slots[i] = None
        self._pending = None
        prefix = getattr(self, "_prefix", None)
        if prefix is not None:
            prefix.clear()                   # the allocator is reset below
        L = self.cfg.num_hidden_layers
        rows = self.n_pages * self.page_size
        shape = (rows + 1, self.nh_kv, self.hd)
        self._k_flat = [torch.zeros(shape, dtype=self.kv_dtype,
                                    device=self.device) for _ in range(L)]
        self._v_flat = [torch.zeros(shape, dtype=self.kv_dtype,
                                    device=self.device) for _ in range(L)]
        pool = (self.n_pages, self.page_size, self.nh_kv, self.hd)
        self.k_pages = [f[:rows].view(pool) for f in self._k_flat]
        self.v_pages = [f[:rows].view(pool) for f in self._v_flat]
        self._oob = rows                 # the scratch row's flat index
        self.allocator = PageAllocator(self.n_pages)
        if getattr(self, "_mk_pack", None) is not None:
            self._build_mk_pack()        # its table held the old pools

    def _write_kv(self, li, slots, k, v):
        """Write k/v rows into layer li's pool at flat slot ids; rows the
        reference drops carry slot id self._oob and land on the scratch
        row (in place of `mode="drop"`)."""
        shape = (-1, self.nh_kv, self.hd)
        self._k_flat[li].index_copy_(0, slots,
                                     k.reshape(shape).to(self.kv_dtype))
        self._v_flat[li].index_copy_(0, slots,
                                     v.reshape(shape).to(self.kv_dtype))

    def _ar(self, n):
        t = self._arange.get(n)
        if t is None:
            t = torch.arange(n, device=self.device)
            self._arange[n] = t
        return t

    # -- copy-on-write -----------------------------------------------------
    def _cow(self, r, idx):
        """First divergent write into a shared page: copy its KV (every
        layer) into the request's reserved page and swap the table entry;
        the shared original stays read-only for its other holders."""
        old = int(self._tables_np[r.slot, idx])
        new = r.cow_reserve
        assert new is not None, "copy-on-write without a reserved page"
        r.cow_reserve = None
        for kp, vp in zip(self.k_pages, self.v_pages):
            kp[new].copy_(kp[old])
            vp[new].copy_(vp[old])
        self._tables_np[r.slot, idx] = new
        r.pages[idx] = new
        r.shared_idx.discard(idx)
        self.allocator.free([old])           # drop r's reference only
        self.cow_copies += 1

    def _make_writable(self, r, lo_pos, hi_pos):
        """Copy-on-write every shared page overlapping write positions
        [lo_pos, hi_pos)."""
        p = self.page_size
        for idx in range(lo_pos // p, (hi_pos - 1) // p + 1):
            if idx in r.shared_idx:
                self._cow(r, idx)

    # -- math --------------------------------------------------------------
    def _clamp_pos(self, pos):
        """Positions for the rope-table and page-table gathers, clamped to
        [0, max_len) as the reference's gathers clamp: a padded chunk tail
        can pass max_len when it is not a multiple of prefill_chunk. Those
        rows write nothing and are never read."""
        return pos.clamp(0, self.max_len - 1)

    def _gathered_attention(self, q, li, tables, pos):
        """Dense attention of q [w, t, h, d] at positions pos [w, t] over
        each slot's whole gathered context [mp * p] with causal masking:
        the reference's dense form of chunk prefill."""
        w, mp, p = tables.shape[0], self.max_pages_per_seq, self.page_size
        ck = self.k_pages[li][tables].reshape(w, mp * p, self.nh_kv, self.hd)
        cv = self.v_pages[li][tables].reshape(w, mp * p, self.nh_kv, self.hd)
        ck = expand_kv_heads(ck, self.nh)
        cv = expand_kv_heads(cv, self.nh)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, ck) / math.sqrt(self.hd)
        kpos = self._ar(mp * p)[None, None, None, :]
        qpos = pos[:, None, :, None]
        logits = torch.where(kpos <= qpos, logits,
                             torch.full_like(logits, -1e30))
        wts = torch.softmax(logits.float(), dim=-1).to(q.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", wts, cv)

    def _decode_math(self, tok, tables, lens, active):
        """One decode step at slot width w = tok.shape[0]: tok [w] is the
        token at position lens [w]; inactive slots write nothing and
        attend nothing (the paged kernel's active mask). Returns (logits
        [w, V], the greedy token [w]): the argmax of the logits, or in
        "multi" mode the kernel's own."""
        if self.megakernel:
            return self._decode_math_mk(tok, tables, lens, active)
        W = self.weights
        p = self.page_size
        w = tok.shape[0]
        h = W["emb"][tok[:, None]].to(self.kv_dtype)
        pos = self._clamp_pos(lens)
        slots = tables[self._ar(w), pos // p] * p + pos % p
        slots = torch.where(active, slots, self._oob)
        ctx = torch.where(active, lens + 1, 0)
        act = active.to(torch.int32)
        for li, wset in enumerate(W["layers"]):
            q, k, v = self._layer_qkv(W, wset, h, pos[:, None])
            self._write_kv(li, slots, k[:, 0], v[:, 0])
            attn = paged_attention(q[:, 0], self.k_pages[li],
                                   self.v_pages[li], tables, ctx,
                                   active=act)
            h = self._layer_tail(W, wset, h, attn[:, None])
        h = _rms(h, W["norm"], W["eps"])
        logits = _mm(h, W["head"])[:, 0]
        return logits, logits.argmax(-1)

    # -- megakernel ----------------------------------------------------------
    def _resolve_megakernel(self, val):
        """megakernel= knob -> False / "layer" / "multi". Auto (None) turns
        the per-layer kernel on only on CUDA, where the kernel takes the
        geometry (megakernel_supported, at most MAX_ROWS slots) and the
        weights (norms and dense weights in the compute dtype); the CPU
        keeps the op chain, as the reference does in interpret mode. A
        forced mode on CUDA with a geometry the kernel does not take
        raises here, with the reason."""
        cfg = self.cfg
        ok = (megakernel_supported(self.nh, self.nh_kv, self.hd,
                                   cfg.hidden_size, cfg.intermediate_size)
              and self.max_batch <= MAX_ROWS)
        if val is None:
            if self.device.type != "cuda" or not ok:
                return False
            W = self.weights
            dense = [W["norm"]] + [w for ws in W["layers"]
                                   for w in ws.values()
                                   if not isinstance(w, tuple)]
            return "layer" if all(w.dtype == self.kv_dtype
                                  for w in dense) else False
        if val is False:
            return False
        if val in (True, "layer"):
            mode = "layer"
        elif val == "multi":
            mode = "multi"
        else:
            raise ValueError(
                f"megakernel must be None, False, True, 'layer' or 'multi', "
                f"got {val!r}")
        if self.device.type == "cuda" and not ok:
            raise ValueError(
                f"megakernel={mode!r} forced on CUDA but the kernel does not "
                f"take this geometry (nh={self.nh}, nh_kv={self.nh_kv}, "
                f"hd={self.hd}, hidden={cfg.hidden_size}, "
                f"ffn={cfg.intermediate_size}, max_batch={self.max_batch}); "
                f"see megakernel_supported and MAX_ROWS={MAX_ROWS}")
        return mode

    def _build_mk_pack(self):
        """The pointer table over this engine's weights and pools (built at
        construction and again by every _reset_kv). "multi" also points at
        the final norm and the lm_head."""
        W = self.weights
        whole = self.megakernel == "multi"
        self._mk_pack = MegakernelPack(
            W["layers"], self._k_flat, self._v_flat, W["cos"], W["sin"],
            nh=self.nh, nh_kv=self.nh_kv, hd=self.hd, eps=W["eps"],
            page_size=self.page_size, norm=W["norm"] if whole else None,
            head=W["head"] if whole else None)

    def _mk_walk(self, h, tables, lens, act):
        """The layers of one decode step through the megakernel: one launch
        ("multi", with the head) or one per layer ("layer"). Returns (h,
        greedy token or None, logits or None)."""
        pack = self._mk_pack
        if self.megakernel == "multi":
            h, tok, _, logits = decode_megakernel(h, pack, tables, lens, act,
                                                  head=True)
            return h, tok, logits
        for li in range(pack.n_layers):
            h = decode_megakernel(h, pack, tables, lens, act, layer=li)
        return h, None, None

    def _decode_math_mk(self, tok, tables, lens, active):
        """_decode_math through the megakernel: the same math and the same
        pool writes. In "layer" mode the final norm and the lm_head stay
        the op chain, as in the reference."""
        W = self.weights
        h = W["emb"][tok].to(self.kv_dtype)
        i32 = torch.int32
        h, greedy, logits = self._mk_walk(h, tables.to(i32), lens.to(i32),
                                          active.to(i32))
        if greedy is None:
            logits = _mm(_rms(h[:, None], W["norm"], W["eps"]),
                         W["head"])[:, 0]
            greedy = logits.argmax(-1)
        return logits, greedy

    def _prefill_phase(self, ids, tables, starts, ends, pf_act, dense=False):
        """Prefill: every active slot advances one chunk at its own offset
        (ids [w, chunk], starts [w], ends [w] = the prompt's end, pf_act [w]
        bool); positions >= the end write nothing. Returns each slot's
        logits of its chunk's last real position, [w, V]. The per-step
        path runs it at width 1 with dense=True (the reference's chunk
        prefill); a fused block attends through the ragged kernel unless
        ragged_kernel (or the CPU default) picks the dense form."""
        W = self.weights
        p = self.page_size
        w, chunk = ids.shape
        h = W["emb"][ids].to(self.kv_dtype)
        pos = starts[:, None] + self._ar(chunk)[None, :]
        pos_c = self._clamp_pos(pos)
        ctx = torch.minimum(starts + chunk, ends)
        slots = tables.gather(1, pos_c // p) * p + pos_c % p
        ok_w = (pos < ends[:, None]) & pf_act[:, None]
        slots = torch.where(ok_w, slots, self._oob).reshape(-1)
        use_kernel = not dense and (self.ragged_kernel is True or (
            self.ragged_kernel is None and self.device.type == "cuda"))
        act = pf_act.to(torch.int32)
        for li, wset in enumerate(W["layers"]):
            q, k, v = self._layer_qkv(W, wset, h, pos_c)
            self._write_kv(li, slots, k, v)
            if use_kernel:
                attn = ragged_paged_attention(
                    q, self.k_pages[li], self.v_pages[li], tables, ctx,
                    starts, active=act)
            else:
                attn = self._gathered_attention(q, li, tables, pos)
            h = self._layer_tail(W, wset, h, attn)
        last = (ends - 1 - starts).clamp(0, chunk - 1)
        h_last = h.gather(1, last[:, None, None].expand(-1, 1, h.shape[-1]))
        h_last = _rms(h_last, W["norm"], W["eps"])
        return _mm(h_last, W["head"])[:, 0]

    def _decode_scan(self, tables, tok, lens, act, rem, eos):
        """K decode steps with every carry on the device (the reference's
        lax.scan as a loop with no host read): a slot retires on the
        device at its own EOS or budget and stops writing and attending
        for the rest of the block. Returns (toks [K, w], emitted [K, w],
        tok, lens, act, rem)."""
        toks, emitted = [], []
        for _ in range(self.decode_block):
            _, greedy = self._decode_math(tok, tables, lens, act)
            nxt = torch.where(act, greedy, tok)
            emitted.append(act)
            rem = torch.where(act, rem - 1, rem)
            lens = torch.where(act, lens + 1, lens)
            act = act & (rem > 0) & (nxt != eos)
            tok = nxt
            toks.append(nxt)
        return torch.stack(toks), torch.stack(emitted), tok, lens, act, rem

    def _to_dev(self, a):
        return torch.as_tensor(a, device=self.device)

    # -- per-step path (decode_block == 1) ---------------------------------
    @torch.no_grad()
    def _prefill_step(self, r):
        chunk = self.prefill_chunk
        start = r.filled
        end = min(start + chunk, r.t0)
        self._make_writable(r, start, end)
        ids_chunk = np.zeros((1, chunk), np.int64)
        ids_chunk[0, :end - start] = r.ids[start:end]
        t_dev = time.perf_counter()
        logits = self._prefill_phase(
            self._to_dev(ids_chunk),
            self._to_dev(self._tables_np[r.slot:r.slot + 1]),
            self._to_dev(np.asarray([start])), self._to_dev(np.asarray([r.t0])),
            self._to_dev(np.ones(1, bool)), dense=True)
        self.dispatch_seconds += time.perf_counter() - t_dev
        r.filled = end
        if end < r.t0:
            return
        # prompt complete: publish full prompt pages to the prefix cache
        # (before the first decode write), then take the first token
        self._publish_prefix(r)
        t_dev = time.perf_counter()
        tok = int(logits.argmax(-1)[0])
        self.dispatch_seconds += time.perf_counter() - t_dev
        self._lens_np[r.slot] = r.t0
        r.state = DECODE
        self._push_token(r, tok)

    def _publish_prefix(self, r):
        """Make a completed prompt's full pages shareable (the partial tail
        page stays private: decode writes land there)."""
        if self._prefix is None:
            return
        key = ()
        p = self.page_size
        for j in range(r.t0 // p):
            key = self._prefix.insert(key, r.ids[j * p:(j + 1) * p],
                                      r.pages[j], self.allocator)

    def _bucket(self, top):
        return next(b for b in self._slot_buckets if b > top)

    @torch.no_grad()
    def _decode_step(self, decodes):
        for r in decodes:
            # the token fed this step writes KV at position lens
            pos = int(self._lens_np[r.slot])
            self._make_writable(r, pos, pos + 1)
            self._tok_np[r.slot] = r.tok
        w = self._bucket(max(r.slot for r in decodes))
        active = np.zeros(w, bool)
        for r in decodes:
            active[r.slot] = True
        t_dev = time.perf_counter()
        _, greedy = self._decode_math(
            self._to_dev(self._tok_np[:w]), self._to_dev(self._tables_np[:w]),
            self._to_dev(self._lens_np[:w]), self._to_dev(active))
        toks = greedy.cpu().numpy()
        self.dispatch_seconds += time.perf_counter() - t_dev
        for r in decodes:
            self._lens_np[r.slot] += 1
            self._push_token(r, toks[r.slot])

    def _idle_or_raise(self):
        """Nothing running and nothing admitted: either truly idle (False)
        or the queue head cannot fit an idle engine — a capacity bug, not
        back-pressure."""
        if self._queue:
            head = self._pick_next()
            need = self._pages_needed(head.t0, head.max_new_tokens)
            raise EngineFullError(
                f"request {head.uid} cannot be admitted into an idle "
                f"engine: needs {need} KV pages but only "
                f"{self.allocator.available} of "
                f"{self.allocator.n_pages} are free (page pool pinned?)")
        return False

    # -- fused blocks (decode_block > 1) -----------------------------------
    def _fused_step(self):
        """One block-granular iteration: process the previous block if one
        is still in flight, else dispatch one. In a pure-decode steady
        state the next block is queued from this block's device carries
        before this block's tokens are read, so host bookkeeping overlaps
        device work."""
        try:
            if self._pending is not None:
                blk = self._pending
                self._pending = None
            else:
                blk = self._dispatch_block()
                if blk is None:
                    return False
            if self._can_chain(blk):
                self._pending = self._chain_block(blk)
            self._process_block(blk)
        except Exception:
            self._pending = None
            self._abort_in_flight()
            raise
        return True

    @torch.no_grad()
    def _dispatch_block(self):
        """Host sync point: shed deadlines, admit, then queue one block.
        Returns a _FusedBlock, or None when idle."""
        self._expire_deadlines()
        self._admit()
        prefills = [r for r in self._slots if r and r.state == PREFILL]
        decodes = [r for r in self._slots if r and r.state == DECODE]
        if not prefills and not decodes:
            self._idle_or_raise()      # raises on a stuck queue head
            return None
        K = self.decode_block
        chunk = self.prefill_chunk
        w = self._bucket(max(r.slot for r in prefills + decodes))
        blk = _FusedBlock(w, K)
        pf_ids = np.zeros((w, chunk), np.int64)
        pf_act = np.zeros(w, bool)
        pf_start = np.zeros(w, np.int64)
        pf_end = np.zeros(w, np.int64)
        for r in prefills:
            start = r.filled
            end = min(start + chunk, r.t0)
            self._make_writable(r, start, end)
            pf_ids[r.slot, :end - start] = r.ids[start:end]
            pf_act[r.slot] = True
            pf_start[r.slot] = start
            pf_end[r.slot] = r.t0        # the prompt's end, not the chunk's
            blk.pf_items.append((r, end))
        act = np.zeros(w, bool)
        rem = np.zeros(w, np.int64)
        eos = np.full(w, -1, np.int64)
        for r in decodes:
            pos = int(self._lens_np[r.slot])
            # the block writes KV at positions [pos, pos + K) while the
            # slot stays active: copy every shared page it can touch now
            hi = min(pos + K, r.t0 + r.max_new_tokens - 1)
            self._make_writable(r, pos, max(hi, pos + 1))
            self._tok_np[r.slot] = r.tok
            act[r.slot] = True
            rem[r.slot] = r.max_new_tokens - len(r.out)
            if r.eos_token_id is not None:
                eos[r.slot] = r.eos_token_id
            blk.dec_items.append(r)
        blk.has_prefill = bool(prefills)
        blk.has_decode = bool(decodes)
        blk.tables = self._to_dev(self._tables_np[:w])
        blk.eos_dev = self._to_dev(eos)
        t_dev = time.perf_counter()
        if blk.has_prefill:
            logits = self._prefill_phase(
                self._to_dev(pf_ids), blk.tables, self._to_dev(pf_start),
                self._to_dev(pf_end), self._to_dev(pf_act))
            blk.first = logits.argmax(-1)
        if blk.has_decode:
            (blk.toks, blk.emitted, blk.tok_fin, blk.lens_fin, blk.act_fin,
             blk.rem_fin) = self._decode_scan(
                blk.tables, self._to_dev(self._tok_np[:w]),
                self._to_dev(self._lens_np[:w]), self._to_dev(act),
                self._to_dev(rem), blk.eos_dev)
        self.dispatch_seconds += time.perf_counter() - t_dev
        self.fused_blocks += 1
        # steps advance by the block's device micro-steps, so TTLs stay
        # comparable with the per-step engine (expiry is checked only at
        # block boundaries, rounded up)
        self.steps += len(prefills) + (K if blk.has_decode else 0)
        self.prefill_steps += len(prefills)
        self.decode_steps += K if blk.has_decode else 0
        return blk

    def _can_chain(self, blk):
        """Chain only in the pure-decode steady state, where the next
        block's inputs cannot depend on this block's tokens: no prefill,
        nothing queued, no deadline/TTL holder (their expiry is promised
        at single block boundaries), no copy-on-write pending, and at
        least one request that outlives this block."""
        if blk.K <= 1 or not blk.has_decode or blk.has_prefill:
            return False
        if self._queue or self._pending is not None:
            return False
        if any(s is not None and s.state == PREFILL for s in self._slots):
            return False
        ok = False
        for r in blk.dec_items:
            if r.state != DECODE:
                continue
            if r.deadline is not None or r.ttl_steps is not None:
                return False
            if r.shared_idx:
                return False
            if r.max_new_tokens - len(r.out) > blk.K:
                ok = True
        return ok

    @torch.no_grad()
    def _chain_block(self, blk):
        """Queue block N+1 straight from block N's device carries, before
        N's tokens are read. No host state crosses: tables, eos ids and
        tok/lens/act/rem all stay on the device."""
        nxt = _FusedBlock(blk.w, blk.K)
        nxt.dec_items = blk.dec_items
        nxt.tables = blk.tables
        nxt.eos_dev = blk.eos_dev
        nxt.has_decode = True
        t_dev = time.perf_counter()
        (nxt.toks, nxt.emitted, nxt.tok_fin, nxt.lens_fin, nxt.act_fin,
         nxt.rem_fin) = self._decode_scan(
            blk.tables, blk.tok_fin, blk.lens_fin, blk.act_fin, blk.rem_fin,
            blk.eos_dev)
        self.dispatch_seconds += time.perf_counter() - t_dev
        self.fused_blocks += 1
        self.chained_blocks += 1
        self.steps += blk.K
        self.decode_steps += blk.K
        return nxt

    def _process_block(self, blk):
        """Read a block's tokens (the only blocking read) and replay them
        through the same retirement bookkeeping as the per-step path: host
        and device agree on EOS/budget by construction."""
        t_dev = time.perf_counter()
        first = blk.first.cpu().numpy() if blk.has_prefill else None
        if blk.has_decode:
            toks = blk.toks.cpu().numpy()
            emitted = blk.emitted.cpu().numpy()
        self.dispatch_seconds += time.perf_counter() - t_dev
        for r, end in blk.pf_items:
            if r.state != PREFILL or r.slot is None:
                continue               # cancelled while in flight
            r.filled = end
            if end >= r.t0:
                # prompt complete: publish pages, then its first token
                self._publish_prefix(r)
                self._lens_np[r.slot] = r.t0
                r.state = DECODE
                self._push_token(r, int(first[r.slot]))
        if blk.has_decode:
            for k in range(blk.K):
                for r in blk.dec_items:
                    if r.state != DECODE or r.slot is None:
                        continue       # retired at an earlier k, or
                        #                cancelled while in flight
                    if not emitted[k, r.slot]:
                        continue
                    self._lens_np[r.slot] += 1
                    self._push_token(r, int(toks[k, r.slot]))

    def _push_token(self, r, tok):
        tok = int(tok)
        r.out.append(tok)
        r.tok = tok
        if (r.eos_token_id is not None and tok == r.eos_token_id) or \
                len(r.out) >= r.max_new_tokens:
            self._retire(r)

    # -- retirement / failure ----------------------------------------------
    def _expire_deadlines(self):
        """Shed every live request whose wall-clock deadline or step TTL
        has passed: queued ones before they run, in-flight ones with their
        slot and pages reclaimed."""
        now = None
        live = list(self._queue) + [s for s in self._slots if s is not None]
        for r in live:
            expired = False
            if r.ttl_steps is not None and \
                    self.steps - r.born_step >= r.ttl_steps:
                expired = True
                why = (f"ttl of {r.ttl_steps} engine steps exhausted "
                       f"(submitted at step {r.born_step}, now "
                       f"{self.steps})")
            elif r.deadline is not None:
                if now is None:
                    now = time.monotonic()
                if now >= r.deadline:
                    expired = True
                    why = f"wall-clock deadline passed at step {self.steps}"
            if not expired:
                continue
            if r.state == QUEUED:
                self._queue.remove(r)
            self._fail_request(r, "deadline", DeadlineExceededError(why))
            self.deadline_expiries += 1

    def _fail_request(self, r, stage, exc, state=FAILED):
        """Retire one request with a typed error record and reclaim its
        slot, pages, CoW reserve and prefix-cache references."""
        r.error = RequestFailure(r.uid, stage, exc, self.steps,
                                 tokens_generated=len(r.out))
        r.state = state
        self._release_slot(r)
        self.failure_count += 1

    def _retire(self, r):
        r.result = np.concatenate([r.ids, np.asarray(r.out, np.int64)])
        r.state = DONE
        self._release_slot(r)

    def _abort_in_flight(self):
        """A step died mid-flight: the pools may hold half-written pages.
        Rebuild them empty; queued requests survive."""
        self._pending = None
        self._reset_kv()
