"""Continuous-batching scheduler over the paged-KV serving engine.

Counterpart of `paddle_tpu/inference/scheduler.py` (`ContinuousBatchingEngine`,
greedy and sampled decoding):

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
  - sampling (inference/sampling.py): per-request SamplingParams; the token
    entering position pos is drawn with fold_in(key(seed), pos), so a
    stream depends only on (seed, position). A dispatch runs in one of three
    modes (`_block_mode`): "greedy" (no randomness), "sampled" (selection
    from the top `sample_k` (value, id) pairs: in "multi" megakernel mode
    the kernel's in-kernel top-K fold, so the [w, V] logits never exist;
    otherwise `top_k` of the materialized logits, the same bits) and "proc"
    (penalties and grammar masks over materialized logits; penalty counts
    and the grammar state are advanced by the host at block boundaries).
    Stop sequences retire on the host.
  - speculate=T: every decode micro-step of a block becomes a verify pass
    over T feed tokens per slot (the pending token and up to T - 1 drafts a
    host drafter proposed at the block boundary), scored in one multi-token
    pass (`spec_verify_attention` on the op chain, the megakernel's tq > 1
    schedule otherwise); the longest draft prefix the target agrees with,
    plus the target's own next token, is accepted on the device. Greedy
    and sampled streams equal the unspeculated ones token for token
    (sample-and-match on the same position keys).
  - megakernel="layer" | "multi": each decode step runs its layers through
    `decode_megakernel`, one launch per layer ("layer", the final norm and
    the lm_head stay the op chain) or one launch per step ("multi", the
    final norm, the lm_head and the greedy argmax inside). The kernel reads
    the engine's own weights and pools through a pointer table
    (`MegakernelPack`), rebuilt whenever the pools are.
  - tp > 1 (inference/tp.py, exact or psum mode): the pools, the prefix
    cache's page copies and every step run per shard on its local heads;
    page tables, lens and the allocator stay replicated host state. With
    the megakernel (exact mode only) each layer is three segment launches
    per shard (qkv, tail, down) with the head gather and the column gather
    between them, the head riding the last layer's down launch in "multi".
  - tenants={name: {"share", "priority"}}: admission orders the queue by
    (priority desc, fair-share virtual time asc, arrival); a strictly
    higher-priority head that cannot be seated preempts the lowest-priority
    running request whose pages can make room (its generated tokens fold
    into its prompt and it re-queues; it resumes through a re-prefill).
  - faults (failsafe.py): the reference's fault points (`cb.admit`,
    `cb.prefill`, `cb.decode`, `cb.draft`, `cb.verify`, `page.alloc` in the
    allocator) retire the one request they name with a RequestFailure of
    the reference's stage; the engine keeps stepping the others.
  - telemetry= (inference/telemetry.py): request lifecycle events and
    latency histograms at host points the engine already visits; no
    device sync, outputs unchanged.
  - on CUDA the op chain runs every product of a decode step and of a
    verify pass at one row count R = 4 * max_batch (`_product_rows`), so
    a row's bits do not depend on whether it was decoded or verified, nor
    on the schedule.

Where the reference compiles a program per shape and donates the KV pools
to it, this port runs the same math eagerly and updates the pools in place
(`index_copy_` into a flat view of each layer's pool). The reference drops
masked KV writes (`.at[slots].set(..., mode="drop")` with out-of-range
slots); torch has no drop mode, so masked rows are redirected to one
scratch row past the end of the pool, which no page table can name.

Not ported yet (each raises, naming its ROADMAP item): KV tiering and the
demote/restore it carries, adapters, the fleet prefix index, and KV and
request export/import (with the sampling state they carry).
"""
import collections
import math
import time
import warnings

import numpy as np
import torch

from ..failsafe import InjectedFault, fault_point
from .serving import EngineFullError, LLMEngine, PageAllocator, _as_numpy, \
    _rms
from ..ops.pallas.decode_megakernel import (MAX_ROWS, MegakernelPack,
                                            decode_megakernel,
                                            megakernel_supported)
from ..ops.pallas.paged_attention import (expand_kv_heads, paged_attention,
                                          ragged_paged_attention,
                                          spec_verify_attention)
from .sampling import (GREEDY, NEG, SamplingParams, TokenMaskAutomaton,
                       apply_penalties, fold_keys, gumbel, select_from_topk,
                       stop_hit, top_k)
from .speculative import resolve_drafter

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
                 "deadline", "ttl_steps", "born_step", "error", "sampling",
                 "counts", "gstate", "draft_k", "spec_drafted",
                 "spec_accepted", "tenant", "priority")

    def __init__(self, uid, ids, max_new_tokens, eos_token_id,
                 deadline=None, ttl_steps=None, born_step=0, sampling=None,
                 draft_k=0, tenant="default", priority=0):
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
        self.sampling = sampling or GREEDY
        self.counts = {}                # token -> occurrences among the
        #                                 generated tokens (penalties)
        self.gstate = 0                 # grammar automaton state (host-
        #                                 authoritative)
        self.draft_k = int(draft_k)     # drafts per verify pass (adaptive)
        self.spec_drafted = 0           # drafts offered to verification
        self.spec_accepted = 0          # drafts the target accepted
        self.tenant = tenant            # admission-policy tenant name
        self.priority = int(priority)   # higher admits (and preempts)
        #                                 first; strict across tenants


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
                 "act_fin", "rem_fin", "has_prefill", "has_decode", "mode",
                 "extras", "dlens")

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
        self.mode = "greedy"        # _block_mode of the participants
        self.extras = None          # device sampling inputs (_row_params)
        self.dlens = None           # np [K, w] drafts offered per pass
        #                             (speculative blocks; toks / emitted
        #                             are then [K, w, T])


def _not_ported(name, item):
    return NotImplementedError(
        f"{name} is not ported to paddle_tpu_torch yet (ROADMAP {item})")


def _pad_slots(n, *xs):
    """Each per-slot tensor with n zero slots appended (inactive slots of
    the op chain's full-width phases)."""
    return [torch.cat([x, x.new_zeros((n,) + tuple(x.shape[1:]))])
            for x in xs]


class ContinuousBatchingEngine(LLMEngine):
    """Request-at-a-time serving over the paged-KV engine, greedy or
    sampled per request.

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
        step with the final norm, the lm_head and the greedy argmax (or the
        sampling path's top-K fold) inside. On the CPU a forced mode runs
        the kernel's plain version.
      do_sample / temperature / top_k / top_p / seed: deprecated engine-
        level sampling, now only the default SamplingParams of requests
        submitted without one (its seed folded with the request uid).
      sample_k: size of the top-K candidate set every sampled selection
        draws from (1..128, default 8); a request's top_k must be <= it.
      sample_fold: False selects sampled tokens from materialized logits
        even in "multi" mode (the same tokens; the fold is selection only).
      speculate: T >= 2 turns on speculative decoding: each decode
        micro-step is a verify pass over the pending token and up to T - 1
        drafts (rejected drafts cost nothing: writes are gated and `lens`
        does not advance over them). Runs through the fused path at every
        decode_block. Greedy and sampled outputs equal the unspeculated
        engine's. With the megakernel on CUDA, T <= MAX_ROWS.
      drafter: "ngram" (default; prompt lookup), "prefix" (prefix-cache
        chains), or a speculative.Drafter instance (e.g. ModelDrafter).
      spec_adaptive: per-request draft length halves on a pass that
        accepts nothing and doubles on a clean sweep, within [1, T - 1].
      tenants: {name: {"share": s, "priority": p}} admission policy:
        priority strict-orders admission and lets a queued request preempt
        a running request of strictly lower priority (the victim's work
        re-queues, never lost); share weighs fair-share virtual time (1 /
        share per emitted token) among equal priorities.
      telemetry: a telemetry.Telemetry (or True to build one) fed at every
        lifecycle transition: per-request traces, latency histograms,
        chrome-trace, Prometheus and JSONL exports. None (default) costs
        one branch per site.

    Failure posture: a request that fails at a per-request boundary
    (admission, a prefill chunk, its slice of a decode step or verify
    pass, a draft, a deadline, cancel) retires alone with a RequestFailure
    record, its pages and prefix references reclaimed; the engine keeps
    stepping everyone else. Any other exception inside a step rebuilds the
    pools (every in-flight request fails with stage "engine"); queued
    requests survive.
    """

    def __init__(self, model, max_len=1024, page_size=128, max_batch=8,
                 prefill_chunk=None, slot_buckets=None, prefix_cache=True,
                 queue_limit=None, default_deadline_ms=None,
                 do_sample=False, temperature=1.0, top_k=0, top_p=1.0,
                 seed=0, sample_k=8, sample_fold=True, decode_block=1,
                 ragged_kernel=None, megakernel=None, speculate=None,
                 drafter="ngram", spec_adaptive=True, tenants=None,
                 kv_tier=None, tier_dir=None, tier_host_cap_mb=None,
                 oversubscribe=None, tier_idle_steps=None, telemetry=None,
                 adapters=None, **kw):
        if speculate is True:
            # int(True) == 1 would silently degenerate to plain decode
            raise ValueError(
                "speculate takes the verify width (an int >= 2: the pending "
                "token + up to width-1 drafts per pass), not True")
        self._spec = 0 if speculate in (None, False) else int(speculate)
        if self._spec == 1:
            self._spec = 0              # T = 1 degenerates to plain decode
        if self._spec < 0:
            raise ValueError(f"speculate must be >= 2, got {speculate}")
        if self._spec > max_len:
            raise ValueError(
                f"speculate={self._spec} exceeds max_len={max_len}")
        self.spec_adaptive = bool(spec_adaptive)
        if kv_tier is not None or oversubscribe or \
                tier_idle_steps is not None or tier_dir is not None or \
                tier_host_cap_mb is not None:
            raise _not_ported("KV tiering (kv_tier, tier_dir, "
                              "tier_host_cap_mb, oversubscribe, "
                              "tier_idle_steps)", "A7.4, tiering.py")
        if adapters not in (None, False):
            raise _not_ported("adapters", "A7.2, adapters.py")
        super().__init__(model, max_len=max_len, page_size=page_size,
                         max_batch=max_batch, **kw)
        # telemetry=: request lifecycle traces and latency histograms fed
        # at host points the engine already visits (no device sync); None
        # keeps one branch per site
        self._tel = None
        self._tel_src = "engine"
        self.telemetry = None
        if telemetry is True:
            from .telemetry import Telemetry
            telemetry = Telemetry()
        if telemetry is not None and telemetry is not False:
            self.attach_telemetry(telemetry)
        self.prefill_chunk = int(prefill_chunk or page_size)
        self.decode_block = max(1, int(decode_block))
        # deprecated engine-level sampling: only the source of the default
        # SamplingParams (_default_sampling)
        self._sampling = (bool(do_sample), float(temperature), int(top_k),
                          float(top_p))
        self._engine_seed = int(seed) & 0xFFFFFFFF
        self.sample_k = int(sample_k)
        if not 1 <= self.sample_k <= 128:
            raise ValueError(
                f"sample_k must be in [1, 128] (the megakernel's top-K fold "
                f"keeps at most 128 pairs per row), got {sample_k}")
        self.sample_fold = bool(sample_fold)
        if do_sample:
            warnings.warn(
                "engine-level do_sample/temperature/top_k/top_p are "
                "deprecated: pass add_request(sampling=SamplingParams("
                "...)) per request. The engine-level values now form a "
                "per-request default whose seed folds in the request uid.",
                DeprecationWarning, stacklevel=2)
        if int(top_k) and int(top_k) > self.sample_k:
            raise ValueError(
                f"engine default top_k={top_k} exceeds sample_k="
                f"{self.sample_k}: the sampled path selects from the "
                "top-sample_k candidate set")
        self._trivial_gram = None
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
        self._drafter = (resolve_drafter(drafter, self._prefix)
                         if self._spec else None)
        # multi-tenant admission: the queue orders by (priority desc,
        # fair-share virtual time asc, arrival); virtual time charges 1 /
        # share per emitted token, so speculation's variable yield is
        # charged like plain decode
        self._tenant_cfg = {}
        for name, cfg in (tenants or {}).items():
            share = float(cfg.get("share", 1.0))
            if share <= 0:
                raise ValueError(
                    f"tenant {name!r} share must be > 0, got {share}")
            self._tenant_cfg[name] = {
                "share": share, "priority": int(cfg.get("priority", 0))}
        self._tenant_vt = {}            # tenant -> tokens / share (a
        #                                 tenant first seen starts at the
        #                                 minimum recorded vt)
        self._tenant_tokens = collections.Counter()
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
        self.preemptions = 0            # decode-slot preemptions (work
        #                                 re-queued, not failed)
        self.fused_blocks = 0
        self.chained_blocks = 0         # blocks queued before the previous
        #                                 block's read-back
        self.sampled_requests = 0       # admitted with do_sample=True
        self.spec_passes = 0            # verify passes that emitted
        self.spec_emitted = 0           # decode tokens emitted by them
        self.spec_drafted_total = 0     # drafts offered
        self.spec_accepted_total = 0    # drafts accepted
        self.draft_errors = 0           # drafter exceptions (degraded to
        #                                 no drafts, never a failure)
        self._spec_sampled_offered = 0  # the same two for sampled requests
        self._spec_sampled_accepted = 0
        self._mk_pack = None
        self.megakernel = self._resolve_megakernel(megakernel)
        if self.megakernel:
            self._build_mk_pack()

    # -- public ------------------------------------------------------------
    def add_request(self, ids, max_new_tokens=32, eos_token_id=None,
                    deadline_ms=None, ttl_steps=None, tenant=None,
                    priority=None, adapter=None, sampling=None):
        """Queue one prompt (1-D int sequence). Returns a request uid.

        deadline_ms: wall-clock budget from now; a request still
          unfinished when it expires retires with a DeadlineExceededError
          record (queued requests are shed without ever running).
        ttl_steps: the same contract counted in engine steps.
        sampling: a SamplingParams (or its to_spec() dict) for this request:
          do_sample / temperature / top_k / top_p / min_p under the
          (seed, position) key stream, repetition / presence / frequency
          penalties, stop sequences and a grammar (TokenMaskAutomaton).
          None takes the engine default (greedy unless the deprecated
          engine-level do_sample was set). Penalties and grammars need the
          materialized processor path and do not compose with speculate=
          (a typed ValueError).
        tenant: admission-policy tenant name (fair-share virtual time is
          tracked per tenant; unregistered tenants get share 1.0).
        priority: admission priority (higher first, strict); defaults to
          the tenant's registered priority, else 0. A queued request of
          strictly higher priority may preempt a running lower-priority one
          when the engine is full: the victim re-queues with its generated
          tokens folded into its prompt, nothing is lost.
        adapter: not ported (raises, naming its ROADMAP item).
        Raises EngineBusyError (nothing enqueued) when the admission queue
        is at queue_limit."""
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
        sp = (SamplingParams.from_spec(sampling) if sampling is not None
              else self._default_sampling(self._next_uid))
        if sp.do_sample and sp.top_k > self.sample_k:
            raise ValueError(
                f"sampling.top_k={sp.top_k} exceeds this engine's "
                f"sample_k={self.sample_k}: the sampled path selects from "
                "the top-sample_k candidate set (raise sample_k= at engine "
                "build)")
        if self._spec and sp.needs_processors:
            raise ValueError(
                "logit processors (penalties / grammar) do not compose with "
                "speculate=: the verify pass scores positions whose "
                "processor state depends on in-pass emissions; run this "
                "request on a non-speculative engine")
        if sp.grammar is not None and \
                sp.grammar.vocab != self.cfg.vocab_size:
            raise ValueError(
                f"grammar automaton vocab {sp.grammar.vocab} != model "
                f"vocab {self.cfg.vocab_size}")
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        deadline = (time.monotonic() + deadline_ms / 1e3
                    if deadline_ms is not None else None)
        tenant = tenant or "default"
        if priority is None:
            priority = self._tenant_cfg.get(tenant, {}).get("priority", 0)
        r = Request(self._next_uid, ids, max_new_tokens, eos_token_id,
                    deadline=deadline,
                    ttl_steps=None if ttl_steps is None else int(ttl_steps),
                    born_step=self.steps, sampling=sp,
                    draft_k=max(1, self._spec - 1) if self._spec else 0,
                    tenant=tenant, priority=priority)
        if sp.do_sample:
            self.sampled_requests += 1
        self._next_uid += 1
        self._requests[r.uid] = r
        self._queue.append(r)
        if self._tel is not None:
            self._tel.req_start(self._tel_src, r.uid, prompt_len=r.t0,
                                max_new=r.max_new_tokens)
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
        """One engine iteration (see _step_impl). With telemetry attached
        the iteration's wall time lands in the `block_ms` histogram: two
        monotonic reads, and one branch on the telemetry=None path."""
        if self._tel is None:
            return self._step_impl()
        t0 = time.monotonic()
        moved = self._step_impl()
        if moved:
            self._tel.block((time.monotonic() - t0) * 1e3)
        return moved

    def _step_impl(self):
        """One engine iteration. Returns False when there is nothing to
        do.

        decode_block == 1: shed expired deadlines, admit what fits, then
        run one prefill chunk or one decode step (alternating when both
        have work, so long prompts don't stall live decodes).

        decode_block == K > 1: one block — a ragged prefill phase plus K
        decode steps, read back once (see _fused_step). speculate=T takes
        the fused path at every decode_block (a block of K verify
        passes).

        A fault raised at a request boundary (its prefill chunk, its slice
        of the decode step) retires that request with a RequestFailure and
        the step carries on; in fused mode the boundaries are checked once
        per request per block."""
        if self.decode_block > 1 or self._spec:
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
                r = prefills[0]
                try:
                    fault_point("cb.prefill", detail=f"uid={r.uid}")
                    self._prefill_step(r)
                except InjectedFault as e:
                    self._fail_request(r, "prefill", e)
                self.prefill_steps += 1
                self._prefer_decode = True
            else:
                live = []
                for r in decodes:
                    try:
                        fault_point("cb.decode", detail=f"uid={r.uid}")
                        live.append(r)
                    except InjectedFault as e:
                        self._fail_request(r, "decode", e)
                if live:
                    self._decode_step(live)
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
            "tp": self.tp,
            "tp_mode": self.tp_mode,
            "tp_compress": self.tp_compress,
            "megakernel_whole_step": self.megakernel == "multi",
            "sampled_requests": self.sampled_requests,
            "sample_k": self.sample_k,
            "sample_fold": self.sample_fold,
            "speculate": self._spec,
            "drafter": (self._drafter.name if self._drafter is not None
                        else None),
            "spec_passes": self.spec_passes,
            "spec_emitted": self.spec_emitted,
            "spec_accept_rate": (
                self.spec_accepted_total / self.spec_drafted_total
                if self.spec_drafted_total else 0.0),
            "spec_tokens_per_pass": (
                self.spec_emitted / self.spec_passes
                if self.spec_passes else 0.0),
            "draft_errors": self.draft_errors,
            "spec_sampled_accept_rate": (
                self._spec_sampled_accepted / self._spec_sampled_offered
                if self._spec_sampled_offered else 0.0),
            # multi-tenant admission: preemptions and per-tenant service
            "preemptions": self.preemptions,
            "tenants": {
                t: {"tokens": self._tenant_tokens[t],
                    "vt": round(self._tenant_vt.get(t, 0.0), 3),
                    "share": self._tenant_cfg.get(t, {}).get("share", 1.0),
                    "queued": sum(1 for q in self._queue if q.tenant == t),
                    "running": sum(1 for s in self._slots
                                   if s is not None and s.tenant == t)}
                for t in sorted(set(self._tenant_tokens)
                                | set(self._tenant_cfg)
                                | {q.tenant for q in self._queue}
                                | {s.tenant for s in self._slots
                                   if s is not None})},
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

    def attach_telemetry(self, tel, src=None):
        """Wire this engine into a Telemetry object under source name `src`
        (default: the telemetry's own name). Request traces are keyed (src,
        uid); attaching drops the live traces under `src` (an engine
        rebuilt under the same name restarts its uid space). Detach with
        attach_telemetry(None)."""
        if tel is None:
            self._tel = None
            self.telemetry = None
            return self
        self._tel = tel
        self.telemetry = tel
        self._tel_src = src or getattr(tel, "name", None) or "engine"
        tel.reset_live(self._tel_src)
        return self

    # -- admission ---------------------------------------------------------
    def _pages_needed(self, t0, max_new_tokens):
        # cache high-water: positions 0..t0+mnt-2 written, attention at
        # the last step reads lens+1 = t0+mnt-1 positions
        return -(-max(t0, t0 + max_new_tokens - 1) // self.page_size)

    def _vt(self, tenant):
        """Fair-share virtual time of a tenant; a tenant first seen now
        starts at the minimum recorded vt (the stride-scheduling entry
        rule), so a newcomer competes from the current service floor."""
        vt = self._tenant_vt.get(tenant)
        if vt is None:
            vt = min(self._tenant_vt.values(), default=0.0)
            self._tenant_vt[tenant] = vt
        return vt

    def _pick_next(self):
        """Admission queue head: priority (desc, strict), then fair-share
        virtual time (asc), then arrival. FIFO when no tenants or
        priorities are configured (every key ties)."""
        return min(self._queue,
                   key=lambda r: (-r.priority, self._vt(r.tenant), r.uid))

    def _preemption_victim(self, cand):
        """A running request the candidate may evict: strictly lower
        priority only (the victim re-queues at its own priority and can
        never preempt back, so there are no cycles), and only when evicting
        lower-priority work could seat the candidate: its page need plus
        the worst-case CoW reserve must fit in the free pages plus the
        victims' exclusively held pages (a refcount-shared page does not
        return to the free list when one holder releases it). Among the
        victims, the most-served tenant's newest request loses the least
        work."""
        lower = [s for s in self._slots
                 if s is not None and s.priority < cand.priority]
        if not lower:
            return None
        need = self._pages_needed(cand.t0, cand.max_new_tokens) + 1
        reclaimable = self.allocator.available + sum(
            sum(1 for p in s.pages if self.allocator.refcount(p) == 1)
            + (1 if s.cow_reserve is not None else 0)
            for s in lower)
        if need > reclaimable:
            return None
        return min(lower,
                   key=lambda r: (r.priority, -self._vt(r.tenant), -r.uid))

    def _preempt(self, r):
        """Decode-slot preemption: reclaim the victim's slot, pages and CoW
        reserve, fold its generated tokens into its prompt and re-queue it.
        On re-admission it re-prefills the folded context (usually through
        its own published prefix pages) and continues; `result()` still
        returns [original prompt + every generated token]."""
        if self._tel is not None:
            self._tel.req_event(self._tel_src, r.uid, "preempt",
                                folded=len(r.out))
        self._release_slot(r)
        if r.out:
            r.ids = np.concatenate([r.ids, np.asarray(r.out, np.int64)])
            r.t0 = r.ids.size
            r.max_new_tokens -= len(r.out)
            r.out = []
        r.tok = None
        r.filled = 0
        r.state = QUEUED
        self._queue.append(r)
        self.preemptions += 1

    def _release_slot(self, r):
        """Reclaim a request's slot, pages and CoW reserve: the one release
        sequence of retirement, failure and preemption (shared pages drop
        only this request's reference)."""
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
                victim = self._preemption_victim(r)
                if victim is not None:
                    self._preempt(victim)
                    continue           # re-evaluate with the freed slot
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
                # page pressure: a strictly higher-priority candidate may
                # preempt a lower-priority running request to free its
                # pages, one victim per attempt, then re-evaluate
                victim = self._preemption_victim(r)
                if victim is not None:
                    self._preempt(victim)
                    continue
                return              # wait for retirements (policy order)
            self._queue.remove(r)
            # claim pages under a guard: an allocation failure (an injected
            # page.alloc fault, or a real one) releases every page this
            # request claimed and retires only this request
            pages = []
            try:
                fault_point("cb.admit", detail=f"uid={r.uid}")
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
            if self._tel is not None:
                self._tel.req_event(self._tel_src, r.uid, "seat",
                                    slot=slot, shared_pages=n_shared)
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
        tel = getattr(self, "_tel", None)
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
                if tel is not None:
                    tel.req_done(self._tel_src, r.uid, FAILED,
                                 n_tokens=len(r.out), stage="engine")
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
        shape = (rows + 1, self.nh_kv_l, self.hd)
        pool = (self.n_pages, self.page_size, self.nh_kv_l, self.hd)
        # per shard, per layer (the shard's local kv heads); the unsuffixed
        # names are shard 0's
        self._kf, self._vf = ([[torch.zeros(shape, dtype=self.kv_dtype,
                                            device=d) for _ in range(L)]
                               for d in self.devices] for _ in range(2))
        self._kp = [[f[:rows].view(pool) for f in fl] for fl in self._kf]
        self._vp = [[f[:rows].view(pool) for f in fl] for fl in self._vf]
        self._k_flat, self._v_flat = self._kf[0], self._vf[0]
        self.k_pages, self.v_pages = self._kp[0], self._vp[0]
        self._oob = rows                 # the scratch row's flat index
        self.allocator = PageAllocator(self.n_pages)
        if getattr(self, "_mk_pack", None) is not None:
            self._build_mk_pack()        # its table held the old pools

    def _write_kv(self, s, li, slots, k, v):
        """Write k/v rows into shard s's layer-li pool at flat slot ids;
        rows the reference drops carry slot id self._oob and land on the
        scratch row (in place of `mode="drop"`)."""
        shape = (-1, self.nh_kv_l, self.hd)
        self._kf[s][li].index_copy_(0, slots,
                                    k.reshape(shape).to(self.kv_dtype))
        self._vf[s][li].index_copy_(0, slots,
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
        the shared original stays read-only for its other holders. Every
        shard copies its own slice of the page."""
        old = int(self._tables_np[r.slot, idx])
        new = r.cow_reserve
        assert new is not None, "copy-on-write without a reserved page"
        r.cow_reserve = None
        for kps, vps in zip(self._kp, self._vp):
            for kp, vp in zip(kps, vps):
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

    # -- sampling ------------------------------------------------------------
    def _default_sampling(self, uid):
        """The SamplingParams of a request submitted without one: the
        deprecated engine-level knobs, with the engine seed folded with the
        request uid (Knuth multiplicative hash), so even defaulted sampled
        requests draw their own key streams."""
        dos, temp, tk, tp_ = self._sampling
        if not dos:
            return GREEDY
        return SamplingParams(
            do_sample=True, temperature=temp, top_k=tk, top_p=tp_,
            seed=(self._engine_seed ^ ((uid * 2654435761) & 0xFFFFFFFF)))

    @staticmethod
    def _block_mode(requests):
        """The math a dispatch needs for these participants: "proc" when
        any request needs the materialized processor chain, "sampled" when
        any samples, else "greedy" (no randomness, no extra inputs)."""
        mode = "greedy"
        for r in requests:
            sp = r.sampling
            if sp.needs_processors:
                return "proc"
            if sp.do_sample:
                mode = "sampled"
        return mode

    def _row_params(self, rows, mode):
        """Per-row sampling inputs of a "sampled" / "proc" dispatch as
        device tensors, assembled fresh from the participants (rows: one
        Request or None per batch row; empty rows keep neutral values and
        never emit). Returns a dict: seeds, dos, temp, topk, topp, minp;
        "proc" adds rep, pres, frq, counts [w, V], gid, gstate and the
        stacked automaton table / mask [G, S, V] (grammar 0 = allow all)."""
        n = len(rows)
        seeds = np.zeros(n, np.int64)
        dos = np.zeros(n, bool)
        temp = np.ones(n, np.float32)
        tkk = np.zeros(n, np.int64)
        tpp = np.ones(n, np.float32)
        minp = np.zeros(n, np.float32)
        for i, r in enumerate(rows):
            if r is None:
                continue
            sp = r.sampling
            seeds[i] = sp.seed
            dos[i] = sp.do_sample
            temp[i] = sp.temperature
            tkk[i] = sp.top_k
            tpp[i] = sp.top_p
            minp[i] = sp.min_p
        ex = dict(seeds=seeds, dos=dos, temp=temp, topk=tkk, topp=tpp,
                  minp=minp)
        if mode == "proc":
            V = self.cfg.vocab_size
            rep = np.ones(n, np.float32)
            pres = np.zeros(n, np.float32)
            frq = np.zeros(n, np.float32)
            counts = np.zeros((n, V), np.int32)
            gid = np.zeros(n, np.int64)
            gstate = np.zeros(n, np.int64)
            if self._trivial_gram is None or \
                    self._trivial_gram.vocab != V:
                self._trivial_gram = TokenMaskAutomaton.trivial(V)
            grams = [self._trivial_gram]
            for i, r in enumerate(rows):
                if r is None:
                    continue
                sp = r.sampling
                rep[i] = sp.repetition_penalty
                pres[i] = sp.presence_penalty
                frq[i] = sp.frequency_penalty
                for t, c in r.counts.items():
                    counts[i, t] = c
                if sp.grammar is not None:
                    gid[i] = len(grams)
                    grams.append(sp.grammar)
                    gstate[i] = r.gstate
            S = max(g.n_states for g in grams)
            gtab = np.zeros((len(grams), S, V), np.int64)
            gmask = np.zeros((len(grams), S, V), bool)
            gmask[0] = True                # trivial: everything allowed
            for i, g in enumerate(grams):
                gtab[i, :g.n_states] = g.table
                gmask[i, :g.n_states] = g.mask
            ex.update(rep=rep, pres=pres, frq=frq, counts=counts, gid=gid,
                      gstate=gstate, gtab=gtab, gmask=gmask)
        return {k: self._to_dev(v) for k, v in ex.items()}

    def _block_extras(self, blk):
        """The device sampling inputs of a fused block (None for greedy)."""
        if blk.mode == "greedy":
            return None
        rows = [None] * blk.w
        for r, _end in blk.pf_items:
            rows[r.slot] = r
        for r in blk.dec_items:
            rows[r.slot] = r
        return self._row_params(rows, blk.mode)

    def _topk(self, logits):
        """The top-sample_k (f32 values, ids) of materialized logits, in
        lax.top_k's order: the same bits as the megakernel's fold."""
        v, i = top_k(logits, self.sample_k)
        return v.float(), i

    def _sample_rows(self, ex, positions, mode, logits=None, topv=None,
                     topi=None, counts=None, gstate=None, noise=None):
        """The sampled / proc selection of one dispatch: the processor
        chain over materialized logits ("proc": penalties, then the
        grammar mask), the top-sample_k candidates, then select_from_topk
        with each row's key fold_keys(seed, position). counts / gstate
        default to the dispatch's own (the fused scan passes its carries,
        and the rows' Gumbel noise drawn for the whole block). Returns [w]
        int64 tokens on the device."""
        if logits is not None:
            if mode == "proc":
                counts = ex["counts"] if counts is None else counts
                gstate = ex["gstate"] if gstate is None else gstate
                logits = apply_penalties(logits.float(), counts, ex["rep"],
                                         ex["pres"], ex["frq"])
                logits = torch.where(ex["gmask"][ex["gid"], gstate], logits,
                                     torch.full_like(logits, NEG))
            topv, topi = self._topk(logits)
        keys = None if noise is not None else fold_keys(ex["seeds"],
                                                         positions)
        return select_from_topk(topv, topi.long(), keys, ex["dos"],
                                ex["temp"], ex["topk"], ex["topp"],
                                ex["minp"], noise=noise)

    def _select_tokens(self, rows, positions, mode, logits=None, topv=None,
                       topi=None, greedy=None):
        """Token selection of the per-step (decode_block=1) and chunked-
        prefill paths: the same math as the fused scan, applied to one
        dispatch's rows. positions [w] are the absolute positions the new
        tokens occupy (their key counters). Greedy dispatches take the
        decode math's own token (or the argmax of the logits). Returns a
        numpy array."""
        if mode == "greedy":
            tok = greedy if greedy is not None else logits.argmax(-1)
            return tok.cpu().numpy()
        ex = self._row_params(rows, mode)
        toks = self._sample_rows(ex, self._to_dev(np.asarray(positions)),
                                 mode, logits=logits, topv=topv, topi=topi)
        return toks.cpu().numpy()

    # -- math --------------------------------------------------------------
    def _clamp_pos(self, pos):
        """Positions for the rope-table and page-table gathers, clamped to
        [0, max_len) as the reference's gathers clamp: a padded chunk tail
        can pass max_len when it is not a multiple of prefill_chunk. Those
        rows write nothing and are never read."""
        return pos.clamp(0, self.max_len - 1)

    def _gathered_attention(self, q, s, li, tables, pos):
        """Dense attention of q [w, t, h, d] at positions pos [w, t] over
        each slot's whole gathered context [mp * p] in shard s's layer-li
        pools with causal masking: the reference's dense form of chunk
        prefill."""
        w, mp, p = tables.shape[0], self.max_pages_per_seq, self.page_size
        ck = self._kp[s][li][tables].reshape(w, mp * p, self.nh_kv_l,
                                             self.hd)
        cv = self._vp[s][li][tables].reshape(w, mp * p, self.nh_kv_l,
                                             self.hd)
        ck = expand_kv_heads(ck, self.nh_l)
        cv = expand_kv_heads(cv, self.nh_l)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, ck) / math.sqrt(self.hd)
        kpos = self._ar(mp * p)[None, None, None, :].to(q.device)
        qpos = pos[:, None, :, None]
        logits = torch.where(kpos <= qpos, logits,
                             torch.full_like(logits, -1e30))
        wts = torch.softmax(logits.float(), dim=-1).to(q.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", wts, cv)

    def _select_head(self, locs, topk):
        """(logits, greedy token), or with topk=K the top-K (values, ids),
        from the shards' local head outputs."""
        if topk is not None:
            return self._tp_topk(locs, topk)
        return self._gather_logits(locs), self._tp_greedy_token(locs)

    def _at_full_width(self):
        """Whether the op chain runs at schedule-independent widths (on
        CUDA): a fused block's prefill at max_batch x chunk rows, and every
        product of a decode step and of a verify pass at `_product_rows`
        rows (see _decode_math)."""
        return self.device.type == "cuda"

    def _product_rows(self):
        """R, the one row count of every product of an op-chain decode
        step and verify pass under `_at_full_width` (else None: the
        natural widths). A function of max_batch alone, never of
        speculate=, so two engines that differ only in speculation give a
        row the same bits: R = 4 * max_batch rows, the verify pass's at
        T = 4. The decode step pads its slots to R; the verify pass runs
        its max_batch x T rows in pieces of R (`_mm`)."""
        return 4 * self.max_batch if self._at_full_width() else None

    def _decode_math(self, tok, tables, lens, active, topk=None):
        """One decode step at slot width w = tok.shape[0]: tok [w] is the
        token at position lens [w]; inactive slots write nothing and
        attend nothing (the paged kernel's active mask). Returns (logits
        [w, V], the greedy token [w]): the argmax of the logits, or in
        "multi" mode the kernel's own. topk=K (the sampling fold) returns
        instead (topv [w, K] f32, topi [w, K]) in lax.top_k's order: in
        "multi" mode from the kernel's in-kernel fold (no logits), else
        the top K of the materialized logits (the same bits). Under tp
        every shard runs its share of each layer (`_layer_tail` gathers or
        reduces between them). On CUDA the op chain pads the step to R =
        `_product_rows()` slots, the extra ones inactive, so every product
        (and every norm) of the step runs at R rows, as those of a verify
        pass do: cuBLAS picks its product kernel by the row count and the
        int8 matmul takes its GEMV at m <= 8, so a row's bits would
        otherwise depend on how many slots share its step and on whether
        it was decoded or verified, and a greedy near-tie would decode
        differently when the schedule or speculate= changes. A fused
        block's prefill pads to max_batch x chunk rows. The megakernel
        sums each row in an order that does not depend on its row
        count."""
        if self.megakernel:
            return self._decode_math_mk(tok, tables, lens, active, topk)
        w = tok.shape[0]
        R = self._product_rows()
        if R is not None and w < R:
            out = self._decode_math(
                *_pad_slots(R - w, tok, tables, lens, active), topk)
            return tuple(x[:w] for x in out)
        p = self.page_size
        hs = self._embed(tok[:, None])
        pos = self._clamp_pos(lens)
        slots = tables[self._ar(w), pos // p] * p + pos % p
        slots = torch.where(active, slots, self._oob)
        ctx = torch.where(active, lens + 1, 0)
        act = active.to(torch.int32)
        pos, slots, tables, ctx, act = (self._rep(x) for x in (
            pos, slots, tables, ctx, act))
        for li in range(self.cfg.num_hidden_layers):
            attns = []
            for s, W in enumerate(self._W):
                q, k, v = self._layer_qkv(W, W["layers"][li], hs[s],
                                          pos[s][:, None], R)
                self._write_kv(s, li, slots[s], k[:, 0], v[:, 0])
                attns.append(paged_attention(
                    q[:, 0], self._kp[s][li], self._vp[s][li], tables[s],
                    ctx[s], active=act[s])[:, None])
            hs = self._layer_tail(li, hs, attns, R)
        return self._select_head(
            [x[:, 0] for x in self._head_logits(hs, R)], topk)

    # -- megakernel ----------------------------------------------------------
    def _resolve_megakernel(self, val):
        """megakernel= knob -> False / "layer" / "multi". Auto (None) turns
        the per-layer kernel on only on CUDA, where the kernel takes the
        geometry (megakernel_supported on a shard's local dims, at most
        MAX_ROWS slots) and the weights (norms and dense weights in the
        compute dtype), and under tp only in exact mode with an ffn tp
        divides; the CPU keeps the op chain, as the reference does in
        interpret mode. A forced mode with tp_mode="psum" or an ffn tp
        does not divide raises, and so does a forced mode on CUDA with a
        geometry the kernel does not take, with the reason."""
        cfg = self.cfg
        ffn = cfg.intermediate_size
        ffn_l = ffn // self.tp if ffn % self.tp == 0 else ffn
        ok = (megakernel_supported(self.nh_l, self.nh_kv_l, self.hd,
                                   cfg.hidden_size, ffn_l, self.tp)
              and self.max_batch <= MAX_ROWS and self._spec <= MAX_ROWS)
        tp_ok = self.tp == 1 or (self.tp_mode == "exact"
                                 and ffn % self.tp == 0)
        if val is None:
            if self.device.type != "cuda" or not ok or not tp_ok:
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
        if self.tp > 1 and self.tp_mode != "exact":
            raise ValueError(
                "megakernel with tp > 1 requires tp_mode='exact': the psum "
                "tail's row-parallel reduce has no place between the "
                "kernel's segments (the exact mode's gathers run between "
                "the segment launches)")
        if ffn % self.tp:
            raise ValueError(
                f"megakernel with tp={self.tp} needs the ffn dim ({ffn}) "
                "divisible by tp (the gate / up columns split per shard)")
        if self.device.type == "cuda" and not ok:
            raise ValueError(
                f"megakernel={mode!r} forced on CUDA but the kernel does not "
                f"take this geometry (nh={self.nh}, nh_kv={self.nh_kv}, "
                f"hd={self.hd}, hidden={cfg.hidden_size}, "
                f"ffn={cfg.intermediate_size}, tp={self.tp}, max_batch="
                f"{self.max_batch}, speculate={self._spec}); see "
                f"megakernel_supported and MAX_ROWS={MAX_ROWS} (a verify "
                f"pass of T rows per slot needs T <= MAX_ROWS)")
        return mode

    def _build_mk_pack(self):
        """The pointer tables over this engine's weights and pools, one per
        shard (built at construction and again by every _reset_kv).
        "multi" also points at the final norm and the lm_head (under tp:
        the shard's vocab slice, when tp divides the vocab; else the head
        stays the op chain). `_mk_pack` is shard 0's."""
        self._mk_head = self.megakernel == "multi" and (
            self.tp == 1 or self._vocab_sharded())
        self._mk_packs = [MegakernelPack(
            W["layers"], kf, vf, W["cos"], W["sin"], nh=self.nh_l,
            nh_kv=self.nh_kv_l, hd=self.hd, eps=W["eps"],
            page_size=self.page_size,
            norm=W["norm"] if self._mk_head else None,
            head=W["head"] if self._mk_head else None)
            for W, kf, vf in zip(self._W, self._kf, self._vf)]
        self._mk_pack = self._mk_packs[0]

    def _mk_walk(self, hs, tables, lens, act, topk=None, tq=1, wmask=None):
        """The layers of one decode step (tq = T > 1: one verify pass of
        T feed rows per slot, `wmask` gating their pool writes) through
        the megakernel: one launch ("multi", with the head) or one per
        layer ("layer"), each split into launches of whole slots at
        tq > 1. hs: the shards' rows. Returns (hs, greedy token or None,
        logits or None), or with topk=K in "multi" mode (hs, topv, topi)
        from the kernel's top-K fold. Under tp: `_mk_walk_tp`."""
        if self.tp > 1:
            return self._mk_walk_tp(hs, tables, lens, act, topk, tq, wmask)
        pack = self._mk_pack
        h = hs[0]
        kw = dict(tq=tq, wmask=wmask)
        if self.megakernel == "multi":
            if topk is not None and topk > 1:
                _, topv, topi = decode_megakernel(h, pack, tables, lens, act,
                                                  head=True, head_k=topk, **kw)
                return [h], topv, topi
            h, tok, maxv, logits = decode_megakernel(h, pack, tables, lens,
                                                     act, head=True, **kw)
            if topk is not None:       # the top 1: the greedy pair
                return [h], maxv[:, None], tok[:, None]
            return [h], tok, logits
        for li in range(pack.n_layers):
            h = decode_megakernel(h, pack, tables, lens, act, layer=li,
                                  **kw)
        return [h], None, None

    def _mk_walk_tp(self, hs, tables, lens, act, topk, tq, wmask):
        """_mk_walk at tp > 1 (the reference's scheduler.py:2240-2295): per
        layer, every shard's qkv segment, the head gather, every shard's
        tail segment, the column gather, every shard's down segment; the
        head rides the last layer's down launches in "multi" (vocab-
        parallel), and the shards' local (max, argmax) pairs or top-K lists
        are combined gather-free."""
        tpc, packs = self._tpc, self._mk_packs
        tables, lens, act = (tpc.replicate(x) for x in (tables, lens, act))
        wms = [None] * self.tp if wmask is None else tpc.replicate(wmask)
        L = packs[0].n_layers
        fold = topk is not None and topk > 1
        outs = None
        for li in range(L):
            attn = tpc.gather_cols([decode_megakernel(
                h, pk, t, ln, a, layer=li, seg="qkv", tq=tq, wmask=wm)
                for h, pk, t, ln, a, wm in zip(hs, packs, tables, lens, act,
                                               wms)])
            acts = tpc.gather_cols([decode_megakernel(
                h, pk, layer=li, seg="tail", attn_in=at, tq=tq)[1]
                for h, pk, at in zip(hs, packs, attn)])
            head = li == L - 1 and self._mk_head
            outs = [decode_megakernel(
                h, pk, layer=li, seg="down", act_in=ac, tq=tq, head=head,
                head_k=topk if head and fold else 1)
                for h, pk, ac in zip(hs, packs, acts)]
        if not self._mk_head:
            return hs, None, None
        v_l = packs[0].V
        if fold:
            topv, topi = tpc.topk_of_local_topk(
                [o[1] for o in outs], [o[2] for o in outs], v_l, topk)
            return hs, topv, topi
        tok = tpc.argmax_of_local_max([o[2] for o in outs],
                                      [o[1] for o in outs], v_l)
        if topk is not None:           # the top 1: the greedy pair
            maxv = torch.stack([o[2].to(tok.device) for o in outs]).amax(0)
            return hs, maxv[:, None], tok[:, None]
        return hs, tok, tpc.gather_cols([o[3] for o in outs])[0]

    def _decode_math_mk(self, tok, tables, lens, active, topk=None):
        """_decode_math through the megakernel: the same math and the same
        pool writes. In "layer" mode the final norm and the lm_head stay
        the op chain, as in the reference."""
        i32 = torch.int32
        hs, a, b = self._mk_walk(self._embed(tok), tables.to(i32),
                                 lens.to(i32), active.to(i32), topk=topk)
        if a is not None and topk is not None:
            return a, b                 # the kernel's (topv, topi)
        if a is not None:
            return b, a                 # (logits, the kernel's token)
        return self._select_head(
            [x[:, 0] for x in self._head_logits([h[:, None] for h in hs],
                                                self._product_rows())],
            topk)

    # -- speculative verify ----------------------------------------------
    def _write_ok(self, T, active, rem, dlen):
        """[w, T] gate of a verify pass's pool writes: feed position j
        writes when its slot is active, j is inside the budget (j <
        min(T, rem)) and j is the pending token or a real draft (j <=
        dlen)."""
        j = self._ar(T)[None, :]
        cap = torch.clamp(rem, max=T)[:, None]
        return active[:, None] & (j < cap) & (j <= dlen[:, None])

    def _spec_verify_math(self, feed, tables, lens, active, rem, dlen,
                          topk=None):
        """One speculative verify pass at slot width w: slot b feeds T
        tokens (feed [w, T]: its pending token and up to T - 1 drafts) at
        positions lens[b] + [0, T), writes their KV gated by `_write_ok`
        (other rows go to the scratch row; a rejected draft's row stays in
        the pool, and `lens` never advances over it), and scores every
        position through `spec_verify_attention` (row j causal up to
        lens + j). Positions are clamped for the table and rope gathers.
        Returns (logits [w, T, V], greedy tokens [w, T]); topk=K returns
        (topv [w, T, K] f32, topi [w, T, K]) per feed position. With the
        megakernel on, the pass runs its tq > 1 schedule
        (_spec_verify_math_mk). On CUDA the op chain pads the pass to
        max_batch slots and runs its products in pieces of R =
        `_product_rows()` rows, the decode step's row count
        (_decode_math)."""
        if self.megakernel:
            return self._spec_verify_math_mk(feed, tables, lens, active, rem,
                                             dlen, topk)
        w, T = feed.shape
        R = self._product_rows()
        if R is not None and w < self.max_batch:
            # max_batch x T rows, the extra slots inactive
            out = self._spec_verify_math(
                *_pad_slots(self.max_batch - w, feed, tables, lens, active,
                            rem, dlen), topk)
            return tuple(x[:w] for x in out)
        p = self.page_size
        hs = self._embed(feed)
        pos = self._clamp_pos(lens[:, None] + self._ar(T)[None, :])
        slots = tables.gather(1, pos // p) * p + pos % p
        slots = torch.where(self._write_ok(T, active, rem, dlen), slots,
                            self._oob).reshape(-1)
        act = active.to(torch.int32)
        pos, slots, tables, lens, act = (self._rep(x) for x in (
            pos, slots, tables, lens, act))
        for li in range(self.cfg.num_hidden_layers):
            attns = []
            for s, W in enumerate(self._W):
                q, k, v = self._layer_qkv(W, W["layers"][li], hs[s], pos[s],
                                          R)
                self._write_kv(s, li, slots[s], k, v)
                attns.append(spec_verify_attention(
                    q, self._kp[s][li], self._vp[s][li], tables[s], lens[s],
                    active=act[s]))
            hs = self._layer_tail(li, hs, attns, R)
        return self._select_head(self._head_logits(hs, R), topk)

    def _spec_verify_math_mk(self, feed, tables, lens, active, rem, dlen,
                             topk=None):
        """The verify pass on the megakernel's tq > 1 schedule: the feed
        rows flatten slot-major into R = w * T kernel rows, `_write_ok`
        rides in as the row mask, and the kernel writes the gated rows'
        k/v in place before attending (the same pool bytes as the op
        chain, rejected drafts' rows included). "multi" runs the final
        norm, the lm_head and the greedy argmax (or the top-K fold) on
        every row; "layer" leaves the head to the op chain."""
        w, T = feed.shape
        i32 = torch.int32
        wm = self._write_ok(T, active, rem, dlen).reshape(-1).to(i32)
        hs, a, b = self._mk_walk(self._embed(feed.reshape(-1)),
                                 tables.to(i32), lens.to(i32),
                                 active.to(i32), topk=topk, tq=T, wmask=wm)
        if a is not None and topk is not None:
            return a.reshape(w, T, -1), b.reshape(w, T, -1)
        if a is not None:
            return b.reshape(w, T, -1), a.reshape(w, T).long()
        return self._select_head(
            [x[:, 0].reshape(w, T, -1)
             for x in self._head_logits([h[:, None] for h in hs],
                                        self._product_rows())], topk)

    def _spec_scan(self, tables, tok, lens, act, rem, eos, drafts, dlen,
                   mode="greedy", ex=None):
        """K verify passes (K = drafts.shape[0]) with every carry on the
        device: pass s feeds [tok, drafts[s]], takes the target's token at
        every feed position, and commits the longest draft prefix the
        target agrees with plus the target's own next token. lens and rem
        advance by the emitted count (capped by the budget, stopping at
        the first EOS, inclusive); a slot retires on budget or EOS. dlen
        [K, w] counts each pass's real drafts (padding is never offered).

        Sampled verify is sample-and-match: the target's token at feed
        position j is drawn with fold_keys(seed, lens + 1 + j), the key the
        unspeculated stream uses at that position, and a draft is accepted
        iff it equals it; so the stream equals the unspeculated one. The
        keys and noise are drawn per pass (lens after a pass depends on
        what was accepted). Returns (toks [K, w, T], emitted [K, w, T],
        tok, lens, act, rem)."""
        T = self._spec
        w = tok.shape[0]
        iT = self._ar(T)[None, :]
        fold = mode == "sampled" and self.sample_fold
        if mode != "greedy":
            def bt(a):                 # [w] -> [w * T], slot-major
                return a[:, None].expand(w, T).reshape(-1)
        toks, emitted = [], []
        for s in range(drafts.shape[0]):
            d_s, n_s = drafts[s], dlen[s]
            feed = torch.cat([tok[:, None], d_s], dim=1)
            if mode == "greedy":
                _, g = self._spec_verify_math(feed, tables, lens, act, rem,
                                              n_s)
            else:
                if fold:
                    topv, topi = self._spec_verify_math(
                        feed, tables, lens, act, rem, n_s,
                        topk=self.sample_k)
                else:
                    logits, _ = self._spec_verify_math(feed, tables, lens,
                                                       act, rem, n_s)
                    topv, topi = self._topk(logits)
                keys = fold_keys(bt(ex["seeds"]),
                                 (lens[:, None] + 1 + iT).reshape(-1))
                g = select_from_topk(
                    topv.reshape(w * T, -1), topi.reshape(w * T, -1).long(),
                    keys, bt(ex["dos"]), bt(ex["temp"]), bt(ex["topk"]),
                    bt(ex["topp"]), bt(ex["minp"])).reshape(w, T)
            g = g.to(tok.dtype)
            # accepted prefix: draft i equals the target's token at its
            # position and every earlier draft was accepted
            match = (d_s == g[:, :T - 1]) & (iT[:, :T - 1] < n_s[:, None])
            n_acc = torch.cumprod(match.to(torch.int64), dim=1).sum(1)
            n_emit = torch.minimum(n_acc + 1, torch.clamp(rem, max=T))
            is_eos = g == eos[:, None]
            eos_i = is_eos.to(torch.int64)
            eos_before = torch.cumsum(eos_i, dim=1) - eos_i
            emit = (iT < n_emit[:, None]) & (eos_before == 0) & act[:, None]
            n_fin = emit.sum(1)
            last = torch.clamp(n_fin - 1, min=0)
            nxt = torch.where(act, g.gather(1, last[:, None])[:, 0], tok)
            lens = torch.where(act, lens + n_fin, lens)
            rem = torch.where(act, rem - n_fin, rem)
            act = act & (rem > 0) & ~(emit & is_eos).any(1)
            tok = nxt
            toks.append(g)
            emitted.append(emit)
        return torch.stack(toks), torch.stack(emitted), tok, lens, act, rem

    def _prefill_phase(self, ids, tables, starts, ends, pf_act, dense=False):
        """Prefill: every active slot advances one chunk at its own offset
        (ids [w, chunk], starts [w], ends [w] = the prompt's end, pf_act [w]
        bool); positions >= the end write nothing. Returns each slot's
        logits of its chunk's last real position, [w, V]. The per-step
        path runs it at width 1 with dense=True (the reference's chunk
        prefill); a fused block attends through the ragged kernel unless
        ragged_kernel (or the CPU default) picks the dense form. On CUDA a
        fused block's prefill runs at max_batch x chunk rows, the extra
        slots inactive (_decode_math): its width w is the schedule's. The
        per-step path always prefills one request, a fixed width."""
        w, chunk = ids.shape
        if self._at_full_width() and w < self.max_batch and not dense:
            return self._prefill_phase(*_pad_slots(
                self.max_batch - w, ids, tables, starts, ends, pf_act))[:w]
        p = self.page_size
        hs = self._embed(ids)
        pos = starts[:, None] + self._ar(chunk)[None, :]
        pos_c = self._clamp_pos(pos)
        ctx = torch.minimum(starts + chunk, ends)
        slots = tables.gather(1, pos_c // p) * p + pos_c % p
        ok_w = (pos < ends[:, None]) & pf_act[:, None]
        slots = torch.where(ok_w, slots, self._oob).reshape(-1)
        use_kernel = not dense and (self.ragged_kernel is True or (
            self.ragged_kernel is None and self.device.type == "cuda"))
        act = pf_act.to(torch.int32)
        last = (ends - 1 - starts).clamp(0, chunk - 1)
        pos, pos_c, slots, tables, ctx, starts, act, last = (
            self._rep(x) for x in (pos, pos_c, slots, tables, ctx, starts,
                                   act, last))
        for li in range(self.cfg.num_hidden_layers):
            attns = []
            for s, W in enumerate(self._W):
                q, k, v = self._layer_qkv(W, W["layers"][li], hs[s],
                                          pos_c[s])
                self._write_kv(s, li, slots[s], k, v)
                if use_kernel:
                    attns.append(ragged_paged_attention(
                        q, self._kp[s][li], self._vp[s][li], tables[s],
                        ctx[s], starts[s], active=act[s]))
                else:
                    attns.append(self._gathered_attention(q, s, li,
                                                          tables[s], pos[s]))
            hs = self._layer_tail(li, hs, attns)
        h_last = [h.gather(1, x[:, None, None].expand(-1, 1, h.shape[-1]))
                  for h, x in zip(hs, last)]
        return self._gather_logits(
            [x[:, 0] for x in self._head_logits(h_last)])

    def _decode_scan(self, tables, tok, lens, act, rem, eos, mode="greedy",
                     ex=None):
        """K decode steps with every carry on the device (the reference's
        lax.scan as a loop with no host read): a slot retires on the
        device at its own EOS or budget and stops writing and attending
        for the rest of the block. mode "sampled" / "proc" draws every
        token with fold_keys(seed, lens + 1) from the dispatch's sampling
        inputs `ex`; "proc" carries the penalty counts and grammar states
        (the host recomputes both in _push_token). Returns (toks [K, w],
        emitted [K, w], tok, lens, act, rem)."""
        toks, emitted = [], []
        K = self.decode_block
        fold = mode == "sampled" and self.sample_fold
        counts = gstate = noise = None
        if mode != "greedy":
            # every micro-step's key and Gumbel noise in one draw: the row
            # fed at lens + k (while active) emits at position lens + 1 + k;
            # a row's noise after it retires is never used
            ks = self._ar(K)[:, None]
            keys = fold_keys(ex["seeds"].expand(K, -1), lens[None] + 1 + ks)
            noise = gumbel(keys, (self.sample_k,))
        if mode == "proc":
            counts, gstate = ex["counts"].clone(), ex["gstate"].clone()
            rows = self._ar(tok.shape[0])
        for k in range(K):
            if mode == "greedy":
                _, nxt = self._decode_math(tok, tables, lens, act)
            elif fold:
                topv, topi = self._decode_math(tok, tables, lens, act,
                                               topk=self.sample_k)
                nxt = self._sample_rows(ex, None, mode, topv=topv, topi=topi,
                                        noise=noise[k])
            else:
                logits, _ = self._decode_math(tok, tables, lens, act)
                nxt = self._sample_rows(ex, None, mode, logits=logits,
                                        counts=counts, gstate=gstate,
                                        noise=noise[k])
            nxt = torch.where(act, nxt.to(tok.dtype), tok)
            emit = act
            emitted.append(emit)
            rem = torch.where(act, rem - 1, rem)
            lens = torch.where(act, lens + 1, lens)
            act = act & (rem > 0) & (nxt != eos)
            tok = nxt
            toks.append(nxt)
            if mode == "proc":
                counts = counts.index_put((rows, nxt), emit.to(counts.dtype),
                                          accumulate=True)
                gstate = torch.where(emit, ex["gtab"][ex["gid"], gstate, nxt],
                                     gstate)
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
        dt = time.perf_counter() - t_dev
        self.dispatch_seconds += dt
        if self._tel is not None:
            self._tel.observe("prefill_chunk_ms", dt * 1e3)
            self._tel.req_event(self._tel_src, r.uid, "prefill_chunk",
                                filled=end)
        r.filled = end
        if end < r.t0:
            return
        # prompt complete: publish full prompt pages to the prefix cache
        # (before the first decode write), then take the first token; it
        # enters position t0, its key counter
        self._publish_prefix(r)
        t_dev = time.perf_counter()
        tok = self._select_tokens([r], [r.t0], self._block_mode([r]),
                                  logits=logits)[0]
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
        rows = [None] * w
        for r in decodes:
            active[r.slot] = True
            rows[r.slot] = r
        mode = self._block_mode(decodes)
        fold = mode == "sampled" and self.sample_fold
        # the token fed at position lens enters position lens + 1: its key
        # counter
        positions = self._lens_np[:w] + 1
        t_dev = time.perf_counter()
        a, b = self._decode_math(
            self._to_dev(self._tok_np[:w]), self._to_dev(self._tables_np[:w]),
            self._to_dev(self._lens_np[:w]), self._to_dev(active),
            topk=self.sample_k if fold else None)
        if fold:
            toks = self._select_tokens(rows, positions, mode, topv=a, topi=b)
        else:
            toks = self._select_tokens(rows, positions, mode, logits=a,
                                       greedy=b)
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
                if blk is True:        # every participant faulted at the
                    return True        # sync point; still a step
            if self._can_chain(blk):
                self._pending = self._chain_block(blk)
            self._process_block(blk)
        except InjectedFault:
            raise                      # faults fire at dispatch only
        except Exception:
            self._pending = None
            self._abort_in_flight()
            raise
        return True

    @torch.no_grad()
    def _dispatch_block(self):
        """Host sync point: shed deadlines, admit, check the fault points
        (once per request per block), then queue one block. Returns a
        _FusedBlock, True when every participant faulted, or None when
        idle."""
        self._expire_deadlines()
        self._admit()
        prefills = [r for r in self._slots if r and r.state == PREFILL]
        decodes = [r for r in self._slots if r and r.state == DECODE]
        if not prefills and not decodes:
            self._idle_or_raise()      # raises on a stuck queue head
            return None
        live_pf, live_dec = [], []
        for r in prefills:
            try:
                fault_point("cb.prefill", detail=f"uid={r.uid}")
                live_pf.append(r)
            except InjectedFault as e:
                self._fail_request(r, "prefill", e)
        for r in decodes:
            try:
                fault_point("cb.decode", detail=f"uid={r.uid}")
                live_dec.append(r)
            except InjectedFault as e:
                self._fail_request(r, "decode", e)
        if not live_pf and not live_dec:
            self.steps += 1
            return True
        prefills, decodes = live_pf, live_dec
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
        T = self._spec
        if T:
            # the host side of the draft / verify boundary: one proposal
            # of K * (want + 1) tokens per request, sliced into per-pass
            # drafts. A fully accepted pass emits want drafts and the
            # target's bonus token, so consecutive passes stride want + 1
            # through the continuation; a pass after a rejection mostly
            # mismatches and degrades to one target token, never a wrong
            # one. dlen counts each pass's real drafts.
            drafts = np.zeros((K, w, T - 1), np.int64)
            dlen = np.zeros((K, w), np.int64)
        for r in decodes:
            if T:
                try:
                    fault_point("cb.draft", detail=f"uid={r.uid}")
                except InjectedFault as e:
                    self._fail_request(r, "draft", e)
                    continue
                want = min(r.draft_k, T - 1)
                cont = np.empty((0,), np.int64)
                if want > 0:
                    t_draft = (time.monotonic()
                               if self._tel is not None else None)
                    try:
                        cont = np.asarray(self._drafter.timed_propose(
                            np.concatenate([r.ids,
                                            np.asarray(r.out, np.int64)]),
                            K * (want + 1), sampling=r.sampling),
                            np.int64).ravel()
                    except Exception:
                        # a broken drafter degrades this request's
                        # speculation, never its correctness
                        self.draft_errors += 1
                        cont = np.empty((0,), np.int64)
                    if t_draft is not None:
                        self._tel.observe(
                            "draft_ms", (time.monotonic() - t_draft) * 1e3)
                stride = want + 1
                for s in range(K):
                    seg = cont[s * stride:s * stride + want]
                    drafts[s, r.slot, :seg.size] = seg
                    dlen[s, r.slot] = seg.size
                try:
                    # the verify boundary: after this request's drafter
                    # ran, before it joins the verify dispatch; it retires
                    # with the plain decode boundary's stage
                    fault_point("cb.verify", detail=f"uid={r.uid}")
                except InjectedFault as e:
                    self._fail_request(r, "decode", e)
                    continue
            pos = int(self._lens_np[r.slot])
            # the block writes KV at positions [pos, pos + K) while the
            # slot stays active (K verify passes of up to T tokens each
            # under speculation): copy every shared page it can touch now
            hi = min(pos + (K * T if T else K), r.t0 + r.max_new_tokens - 1)
            self._make_writable(r, pos, max(hi, pos + 1))
            self._tok_np[r.slot] = r.tok
            act[r.slot] = True
            rem[r.slot] = r.max_new_tokens - len(r.out)
            if r.eos_token_id is not None:
                eos[r.slot] = r.eos_token_id
            blk.dec_items.append(r)
        if T and not blk.dec_items and not prefills:
            self.steps += 1            # every decoder faulted at draft
            return True
        blk.has_prefill = bool(prefills)
        blk.has_decode = bool(blk.dec_items)
        blk.mode = self._block_mode(prefills + blk.dec_items)
        blk.extras = self._block_extras(blk)
        blk.tables = self._to_dev(self._tables_np[:w])
        blk.eos_dev = self._to_dev(eos)
        t_dev = time.perf_counter()
        if blk.has_prefill:
            pf_end_dev = self._to_dev(pf_end)
            logits = self._prefill_phase(
                self._to_dev(pf_ids), blk.tables, self._to_dev(pf_start),
                pf_end_dev, self._to_dev(pf_act))
            if blk.mode == "greedy":
                blk.first = logits.argmax(-1)
            else:
                # the chunk's last token sits at pf_end - 1; the token it
                # emits enters position pf_end, its key counter
                blk.first = self._sample_rows(blk.extras, pf_end_dev,
                                              blk.mode, logits=logits)
        if blk.has_decode:
            carries = (blk.tables, self._to_dev(self._tok_np[:w]),
                       self._to_dev(self._lens_np[:w]), self._to_dev(act),
                       self._to_dev(rem), blk.eos_dev)
            if T:
                blk.dlens = dlen
                (blk.toks, blk.emitted, blk.tok_fin, blk.lens_fin,
                 blk.act_fin, blk.rem_fin) = self._spec_scan(
                    *carries, self._to_dev(drafts), self._to_dev(dlen),
                    blk.mode, blk.extras)
            else:
                (blk.toks, blk.emitted, blk.tok_fin, blk.lens_fin,
                 blk.act_fin, blk.rem_fin) = self._decode_scan(
                    *carries, blk.mode, blk.extras)
        self.dispatch_seconds += time.perf_counter() - t_dev
        self.fused_blocks += 1
        # steps advance by the block's device micro-steps, so TTLs stay
        # comparable with the per-step engine (expiry is checked only at
        # block boundaries, rounded up); a speculative block's micro-steps
        # are verify passes: TTLs count passes, not tokens
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
        if self._spec:
            # the drafter runs on the host against the newest context; a
            # chained block would verify stale drafts
            return False
        if self._queue or self._pending is not None:
            return False
        if any(s is not None and s.state == PREFILL for s in self._slots):
            return False
        if blk.mode == "proc":
            # penalty counts and grammar states advance on the host in
            # _push_token; a chained block would run the processor chain
            # against stale state
            return False
        ok = False
        for r in blk.dec_items:
            if r.state != DECODE:
                continue
            if r.deadline is not None or r.ttl_steps is not None:
                return False
            if r.shared_idx:
                return False
            if r.sampling.stop:
                # stop sequences retire on the host; a chained block would
                # keep writing KV into pages the retirement frees
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
        nxt.mode = blk.mode             # sampling inputs are static across
        nxt.extras = blk.extras         # a chain; the key counters ride the
        t_dev = time.perf_counter()     # device lens
        (nxt.toks, nxt.emitted, nxt.tok_fin, nxt.lens_fin, nxt.act_fin,
         nxt.rem_fin) = self._decode_scan(
            blk.tables, blk.tok_fin, blk.lens_fin, blk.act_fin, blk.rem_fin,
            blk.eos_dev, nxt.mode, nxt.extras)
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
            if self._tel is not None:
                self._tel.req_event(self._tel_src, r.uid, "prefill_chunk",
                                    filled=end)
            if end >= r.t0:
                # prompt complete: publish pages, then its first token
                self._publish_prefix(r)
                self._lens_np[r.slot] = r.t0
                r.state = DECODE
                self._push_token(r, int(first[r.slot]))
        if blk.has_decode and self._spec:
            self._replay_spec(blk, toks, emitted)
        elif blk.has_decode:
            for k in range(blk.K):
                for r in blk.dec_items:
                    if r.state != DECODE or r.slot is None:
                        continue       # retired at an earlier k, or
                        #                cancelled while in flight
                    if not emitted[k, r.slot]:
                        continue
                    self._lens_np[r.slot] += 1
                    self._push_token(r, int(toks[k, r.slot]))

    def _replay_spec(self, blk, toks, emitted):
        """A speculative block's tokens ([K, w, T] with their emitted
        mask): each pass's emitted prefix goes through _push_token, and
        its acceptance feeds the counters and the adaptive draft length
        (halve on a pass that accepted nothing, double on a clean sweep,
        within [1, T - 1])."""
        T = self._spec
        for s in range(toks.shape[0]):
            for r in blk.dec_items:
                if r.state != DECODE or r.slot is None:
                    continue           # retired at an earlier pass, or
                    #                    cancelled while in flight
                em = emitted[s, r.slot]
                n = int(em.sum())
                if n == 0:
                    continue
                # drafts past the remaining budget can never be accepted:
                # they are not charged as offered
                offered = min(int(blk.dlens[s, r.slot]),
                              max(r.max_new_tokens - len(r.out) - 1, 0))
                accepted = min(max(0, n - 1), offered)
                self.spec_passes += 1
                self.spec_emitted += n
                self.spec_drafted_total += offered
                self.spec_accepted_total += accepted
                r.spec_drafted += offered
                r.spec_accepted += accepted
                if r.sampling.do_sample:
                    self._spec_sampled_offered += offered
                    self._spec_sampled_accepted += accepted
                if self._tel is not None:
                    self._tel.req_event(self._tel_src, r.uid, "spec_pass",
                                        offered=offered, accepted=accepted,
                                        emitted=n)
                if self.spec_adaptive and offered:
                    if accepted >= offered and n > offered:
                        r.draft_k = min(T - 1, max(1, r.draft_k * 2))
                    elif accepted == 0:
                        r.draft_k = max(1, r.draft_k // 2)
                slot = r.slot
                for i in range(T):
                    if not em[i]:
                        continue
                    self._lens_np[slot] += 1
                    self._push_token(r, int(toks[s, slot, i]))
                    if r.state != DECODE:
                        break          # EOS or budget inside the pass

    def _push_token(self, r, tok):
        tok = int(tok)
        r.out.append(tok)
        r.tok = tok
        if r.sampling.needs_processors:
            # host-authoritative processor state (the fused scan's carries
            # are recomputed here)
            r.counts[tok] = r.counts.get(tok, 0) + 1
            g = r.sampling.grammar
            if g is not None:
                r.gstate = int(g.advance(r.gstate, tok))
        if self._tel is not None and len(r.out) == 1:
            # the TTFT host point: the first generated token reached the
            # host
            self._tel.req_first_token(self._tel_src, r.uid)
        # fair share: 1 / share virtual time per emitted token, so a
        # speculating tenant's higher per-pass yield is charged like plain
        # decode
        share = self._tenant_cfg.get(r.tenant, {}).get("share", 1.0)
        self._tenant_vt[r.tenant] = self._vt(r.tenant) + 1.0 / share
        self._tenant_tokens[r.tenant] += 1
        if (r.eos_token_id is not None and tok == r.eos_token_id) or \
                len(r.out) >= r.max_new_tokens:
            self._retire(r)
        elif r.sampling.stop and stop_hit(r.out, r.sampling.stop):
            # stop sequences retire here, on the host: the device scan does
            # not see them (so _can_chain refuses blocks that carry any)
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
        if self._tel is not None:
            self._tel.req_done(self._tel_src, r.uid, state,
                               n_tokens=len(r.out), stage=stage,
                               error=type(exc).__name__)

    def _retire(self, r):
        r.result = np.concatenate([r.ids, np.asarray(r.out, np.int64)])
        r.state = DONE
        self._release_slot(r)
        if self._tel is not None:
            self._tel.req_done(self._tel_src, r.uid, DONE,
                               n_tokens=len(r.out))

    def _abort_in_flight(self):
        """A step died mid-flight: the pools may hold half-written pages.
        Rebuild them empty; queued requests survive."""
        self._pending = None
        self._reset_kv()
