"""Fault-tolerant multi-replica serving: the availability layer.

Counterpart of `paddle_tpu/inference/router.py`, host Python over the
port's engines (it imports no JAX). One ContinuousBatchingEngine is one
fault domain: a poisoned dispatch kills every in-flight request, and a
weight deploy stops traffic. `EngineRouter` fronts N engine replicas and
makes the fleet behave like one engine that does not die:

  - health-balanced routing: each add_request lands on the replica with
    the most headroom (queue depth, free slots, free KV pages). Per-tenant
    admission (tenant= / priority=) rides through to every replica's own
    fair-share policy.
  - failover: a replica failure (an armed `replica.step` /
    `replica.heartbeat` / `replica.admit` fault point, or a real exception
    escaping the engine) re-queues its in-flight requests on the
    survivors, generated tokens folded into the prompt, so greedy
    continuations equal an uninterrupted run; the delivery ledger gives
    exactly-once results (duplicate deliveries are counted and dropped).
  - quarantine: a replica that keeps failing trips a circuit breaker
    (closed -> open); re-admission runs as bounded `retry_with_backoff`
    probes (seeded jitter); a surviving probe half-opens it, a clean step
    closes it, another failure reopens it with a doubled backoff.
  - zero-downtime weight hot-swap: hot_swap() rolls a snapshot through the
    fleet one replica at a time — drain, load + CRC32-verify through the
    atomic checkpoint layer (distributed/checkpoint.py), flip at a block
    boundary, re-admit. A CheckpointCorruptError rolls every flipped
    replica back, so the fleet never serves a torn deploy.
  - disaggregated prefill / decode (topology=), cache-aware routing over
    the fleet prefix index (prefix_routing=), fleet-wide adapter deploys,
    and one merged telemetry view.

The replica boundary is `EngineReplica`, the only class that touches
engine internals; a process backend (ROADMAP A7.8) reimplements that
surface over RPC and the router stays as it is.

Numerics: routing never changes tokens. Greedy outputs through the router
equal a single engine serving the same requests.
"""
import collections
import os
import time
import uuid
import warnings

import numpy as np

from ..failsafe import (InjectedFault, RetriesExhaustedError, fault_point,
                        retry_with_backoff)
from .adapters import AdapterError
from .scheduler import (DECODE, DEMOTED, DONE, FAILED, PREFILL, QUEUED,
                        EngineBusyError, EngineFullError, RequestFailure,
                        RequestFailedError, RequestNotFinishedError,
                        SchedulerError, UnknownRequestError)

ACTIVE, DRAINING = "active", "draining"

# device-domain token shared by every in-process EngineReplica: two
# replicas whose endpoints carry the same token live in one process (one
# CUDA context), so a KV handoff between them may negotiate the device
# transport (handoff.negotiate). Unique per process and per import.
_PROC_TOKEN = f"router:{os.getpid()}:{uuid.uuid4().hex[:8]}"


class ReplicaFailedError(SchedulerError):
    """A replica was declared dead (fault point or escaped exception);
    its in-flight work was re-queued on survivors."""


class NoReplicaAvailableError(EngineBusyError):
    """No replica can take this request right now (all quarantined or
    at queue_limit) and the router's own hold queue is full — typed
    backpressure, nothing was enqueued."""


class HotSwapError(SchedulerError):
    """A weight hot-swap aborted; every replica was rolled back to (or
    never left) the old weights and serving continued throughout.
    Carries the underlying cause as __cause__."""


class AdapterDeployError(SchedulerError):
    """A fleet-wide adapter registry write (EngineRouter.load_adapter)
    landed on ZERO replicas — the fine-tune is not servable anywhere.
    Partial failures do NOT raise: the summary names the stragglers and
    the fleet keeps serving from the replicas that loaded it."""


class CircuitBreaker:
    """Per-replica quarantine state machine.

    closed: normal traffic; `threshold` CONSECUTIVE failures open it.
    open: no traffic; after `probe_backoff` router steps a re-admission
      probe may run (the router wraps it in retry_with_backoff). A
      failed probe doubles the backoff (capped); a surviving probe
      moves to half-open.
    half-open: trial traffic; ONE clean step closes the breaker (and
      resets the backoff), ONE failure reopens it.
    """

    __slots__ = ("threshold", "state", "failures", "probe_backoff",
                 "_base_backoff", "next_probe_step", "opened", "reopened",
                 "closed_after_probe", "last_error")

    def __init__(self, threshold=2, probe_backoff=4):
        self.threshold = max(1, int(threshold))
        self.state = "closed"
        self.failures = 0               # consecutive
        self._base_backoff = max(1, int(probe_backoff))
        self.probe_backoff = self._base_backoff
        self.next_probe_step = None     # router step gating the probe
        self.opened = 0                 # lifetime open transitions
        self.reopened = 0               # opens from half-open/failed probe
        self.closed_after_probe = 0
        self.last_error = None

    def record_failure(self, exc, at_step):
        self.failures += 1
        self.last_error = f"{type(exc).__name__}: {exc}"
        if self.state == "half_open" or self.failures >= self.threshold:
            self._open(at_step, reopen=self.state == "half_open")

    def record_success(self):
        self.failures = 0
        if self.state == "half_open":
            self.state = "closed"
            self.probe_backoff = self._base_backoff
            self.closed_after_probe += 1

    def record_probe_failure(self, at_step):
        self._open(at_step, reopen=True)

    def record_probe_success(self):
        self.state = "half_open"

    def ready_to_probe(self, step):
        return self.state == "open" and step >= self.next_probe_step

    def _open(self, at_step, reopen=False):
        if self.state != "open":
            self.opened += 1
        if reopen:
            self.reopened += 1
            self.probe_backoff = min(self.probe_backoff * 2,
                                     64 * self._base_backoff)
        self.state = "open"
        self.next_probe_step = at_step + self.probe_backoff


class EngineReplica:
    """One serving replica behind the router — the replica BOUNDARY.

    This in-process backend wraps a ContinuousBatchingEngine directly;
    everything the router needs goes through these methods, so a
    process/pod backend only reimplements this class (same surface over
    RPC), never the router. The engine object survives a declared
    failure: a fault-point kill leaves it intact (its requests are
    evicted and re-queued elsewhere), a real mid-dispatch exception
    already rebuilt its pools via the engine's own abort path — either
    way `step()`/`submit()` remain callable, which is what quarantine
    probes verify before re-admission.
    """

    def __init__(self, name, factory, role="any"):
        self.name = name
        self._factory = factory
        self.engine = factory()
        self.state = ACTIVE
        self.role = role                # "prefill" | "decode" | "any"
        #                                 (disaggregated topology mode;
        #                                 "any" = the classic fleet)
        self.breaker = None             # installed by the router
        self.kills = 0                  # declared failures
        self.swaps = 0                  # weight flips applied
        self.failed_probes = 0          # consecutive exhausted probe
        #                                 series (rebuild trigger)
        self._prefix_index = None       # fleet prefix index (re-wired
        #                                 across rebuilds)
        self.telemetry = None           # per-replica Telemetry — lives
        #                                 HERE, not on the engine, so
        #                                 histograms survive a rebuild
        self.adapters = {}              # name -> path registry (LoRA;
        #                                 replayed across rebuilds so a
        #                                 fresh engine serves the same
        #                                 fine-tunes)
        self.adapters_pending = {}      # name -> "load"|"evict": ops
        #                                 deferred while quarantined,
        #                                 drained at the next clean
        #                                 probe (rebuild covers them
        #                                 via the registry replay)

    # -- traffic -----------------------------------------------------------
    def submit(self, spec):
        """Admit a resume spec (scheduler.export_request shape); returns
        this replica's engine uid."""
        return self.engine.submit_resume(spec)

    def step(self):
        return self.engine.step()

    def health(self):
        return self.engine.health()

    def headroom(self):
        """O(1) routing snapshot (queued/running/slots/pages) — the
        hot-path subset of health(), which walks the engine's full
        request history and is for monitors/probes only."""
        return self.engine.headroom()

    def has_work(self):
        # demoted counts as work: the engine's restore sweep only runs
        # when stepped — a replica whose ONLY live request is parked in
        # the tier must keep stepping or that request strands forever
        h = self.engine.headroom()
        return bool(h["queued"] or h["running"] or h.get("demoted"))

    # -- per-request state -------------------------------------------------
    def status(self, uid):
        return self.engine.status(uid)

    def result(self, uid):
        return self.engine.result(uid)

    def failure(self, uid):
        return self.engine.failures().get(uid)

    def export_resume(self, uid):
        return self.engine.export_request(uid)

    def evict(self, uid):
        """Drop a request from this replica WITHOUT failing it at the
        router level (its re-queued copy carries the work forward);
        pages/slots reclaim through the engine's cancel path."""
        try:
            self.engine.cancel(uid)
        except UnknownRequestError:
            pass
        return None

    def queue_head_uid(self):
        """The engine uid an idle-engine EngineFullError is complaining
        about (ContinuousBatchingEngine.queue_head_uid — one
        definition; the fleet worker serves the same call)."""
        return self.engine.queue_head_uid()

    # -- telemetry ------------------------------------------------------------
    def attach_telemetry(self, tel):
        """Wire this replica's engine into a Telemetry under the
        replica name. The Telemetry object (and with it the metrics
        registry and completed traces) belongs to the REPLICA, so p50/
        p95/p99 survive engine rebuilds, failover, and hot-swap —
        rebuild() re-attaches the fresh engine to the same object."""
        self.telemetry = tel
        self.engine.attach_telemetry(tel, src=self.name)

    def metrics_registry(self, sample=True):
        """This replica's MetricsRegistry for the router's fleet merge
        (None without telemetry). sample=True rate-converts a fresh
        health() snapshot first. A ProcessReplica reimplements this as
        the cross-process registry pull — one RPC fetches registry
        state + health together."""
        tel = self.telemetry
        if tel is None:
            return None
        if sample:
            try:
                tel.registry.sample(self.health())
            except Exception:
                pass                    # metrics must never throw
        return tel.registry

    def sync_telemetry(self):
        """Refresh remote telemetry mirrors (trace export); in-process
        traces are already live — nothing to do."""
        return None

    def extra_health(self):
        """Backend-specific additions to the router's per-replica
        health entry (the in-process schema is pinned; a process
        backend adds its worker block here)."""
        return {}

    # -- multi-LoRA adapters (inference/adapters.py) --------------------------
    def load_adapter(self, name, path):
        """Hot-load a LoRA adapter into this replica's pool and record
        it in the replica registry (replayed by rebuild() so a fresh
        engine serves the same fine-tunes)."""
        slot = self.engine.load_adapter(name, path)
        self.adapters[name] = str(path)
        self.adapters_pending.pop(name, None)
        return slot

    def evict_adapter(self, name):
        """Engine first, registry second: a REFUSED evict (live
        requests pin the adapter) must leave the rebuild-replay
        registry intact, or a later rebuild would strand salvaged
        requests that still name it."""
        slot = self.engine.evict_adapter(name)
        self.adapters.pop(name, None)
        self.adapters_pending.pop(name, None)
        return slot

    def pin_adapter(self, name, pinned=True):
        return self.engine.pin_adapter(name, pinned=pinned)

    # -- fleet prefix index (cache-aware routing) -----------------------------
    def attach_prefix_index(self, index):
        """Wire this replica's engine into the fleet prefix index under
        the replica name (publishes on prefill, retracts on eviction)."""
        self._prefix_index = index
        self.engine.attach_prefix_index(index, self.name)

    def page_size(self):
        return self.engine.page_size

    def export_prefix(self, ids, device=False):
        """Ticketed export of this replica's cached prefix chain for
        `ids` (None when nothing is cached — a stale index hint);
        device=True keeps the pages on device (negotiated same-runtime
        ships only)."""
        return self.engine.export_prefix_pages(ids, device=device)

    def import_prefix(self, payload):
        return self.engine.import_prefix_pages(payload)

    def finish_prefix_export(self, token):
        return self.engine.finish_prefix_export(token)

    def abort_prefix_export(self, token):
        return self.engine.abort_prefix_export(token)

    # -- KV-page handoff (disaggregated prefill/decode) ----------------------
    def transport_endpoint(self):
        """Transport-negotiation endpoint (handoff.negotiate): every
        in-process replica shares this process's device-domain token, and
        `backend` is its engine's torch device type, so co-located pools
        on one device type negotiate the device path (pages stay
        tensors, no host bounce); `store` is None — in-process replicas
        need no rendezvous store to move bytes."""
        return {"proc": _PROC_TOKEN, "backend": self.engine.device.type,
                "store": None}

    def export_kv(self, uid, transport="host"):
        """Package a decode-state request's KV image for migration
        (scheduler.export_kv_pages — CRC-stamped, ticketed). transport
        is the negotiated kind: "device" keeps page blobs on device
        (same-runtime targets only), "host"/"store" take the
        host-bounce CRC path."""
        return self.engine.export_kv_pages(
            uid, device=(transport == "device"))

    def import_kv(self, payload):
        """Seat an exported request here; returns this replica's engine
        uid (scheduler.import_kv_pages — verified, rollback-safe)."""
        return self.engine.import_kv_pages(payload)

    def release_handoff(self, uid):
        return self.engine.release_handoff(uid)

    def abort_handoff(self, uid):
        return self.engine.abort_handoff(uid)

    # -- weights -----------------------------------------------------------
    def export_weights(self):
        return self.engine.export_weights()

    def load_weights_snapshot(self, path):
        return self.engine.load_weights_snapshot(path)

    def save_weights_snapshot(self, path, step=None):
        return self.engine.save_weights_snapshot(path, step=step)

    def install_weights(self, new):
        self.engine.install_weights(new)
        self.swaps += 1

    # -- lifecycle ---------------------------------------------------------
    def rebuild(self):
        """Fresh engine from the factory (a quarantine probe's last
        resort when the current engine object is unusable). The fleet
        prefix index is re-wired — and this replica's stale claims
        dropped, its cache died with the old engine. Telemetry is
        re-attached too: the registry and completed traces live on
        this replica, only the dead engine's LIVE traces drop (its uid
        space restarts)."""
        self.engine = self._factory()
        if self._prefix_index is not None:
            try:
                self._prefix_index.drop_replica(self.name)
            except Exception:
                pass
            self.engine.attach_prefix_index(self._prefix_index, self.name)
        if self.telemetry is not None:
            self.engine.attach_telemetry(self.telemetry, src=self.name)
        for name, path in self.adapters.items():
            try:
                self.engine.load_adapter(name, path)
            except Exception:
                pass                    # the registry stays; a request
                #                         naming it fails typed, the
                #                         fleet's other replicas serve
        self.adapters_pending.clear()   # replay covered the loads; a
        #                                 fresh engine never held an
        #                                 evict-pending adapter
        return self.engine


class _RouterRequest:
    """Router-side ledger entry for one submitted request."""

    __slots__ = ("uid", "replica", "engine_uid", "state", "result",
                 "failure", "requeues", "tenant")

    def __init__(self, uid, tenant):
        self.uid = uid
        self.replica = None             # current replica name
        self.engine_uid = None
        self.state = QUEUED
        self.result = None
        self.failure = None
        self.requeues = 0
        self.tenant = tenant


class EngineRouter:
    """Health-checked router over N engine replicas (module docstring).

    factory: zero-arg callable building ONE ContinuousBatchingEngine
      (each replica calls it once; quarantine probes may call it again
      to rebuild a wrecked engine). All replicas must share model +
      engine config — the router assumes any replica can serve any
      request.
    replicas: fleet size (>= 1).
    quarantine_threshold: consecutive declared failures that open a
      replica's circuit breaker.
    probe_backoff: router steps between an open breaker and its first
      re-admission probe (doubles per failed probe, capped).
    probe_retries / probe_base_delay / probe_jitter / probe_max_elapsed:
      the retry_with_backoff budget of ONE probe attempt series; seeded
      jitter keeps schedules deterministic, probe_sleep is injectable
      for tests.
    hold_limit: bound on the router's own hold queue (requests parked
      while every replica is quarantined/draining). None = unbounded.
    """

    # consecutive exhausted probe series before a quarantined replica's
    # engine object is presumed wrecked and rebuilt from the factory
    REBUILD_AFTER_PROBES = 3

    def __init__(self, factory=None, replicas=2, quarantine_threshold=2,
                 probe_backoff=4, probe_retries=1, probe_base_delay=0.01,
                 probe_jitter=0.0, probe_max_elapsed=None, probe_seed=0,
                 probe_sleep=time.sleep, hold_limit=None, topology=None,
                 prefix_routing=False, prefix_index=None, telemetry=None,
                 backends=None):
        # backends=[replica, ...]: PRE-BUILT replica backends instead
        # of factory-built in-process engines — the process-fleet mode
        # (ROADMAP A7.8's ProcessReplica, or any object serving the
        # EngineReplica surface). The router wires breakers, roles,
        # telemetry, and the prefix index onto them and then runs
        # UNCHANGED: routing, failover salvage, quarantine, hot-swap,
        # disagg handoff, and the metrics merge all go through the same
        # boundary methods. With topology=, roles assign by position
        # (first `prefill` workers, then `decode`).
        # topology={"prefill": N, "decode": M}: DISAGGREGATED mode —
        # N prefill workers take every fresh admission, M decode
        # workers receive requests at first-token via KV-page handoff
        # (export_kv_pages/import_kv_pages: page-table remap + refcount
        # transfer, CRC-checked; zero prefill recompute). A request
        # whose handoff cannot land right now keeps decoding on its
        # prefill worker and retries next step (availability over
        # purity); a worker dying mid-handoff re-queues through the
        # standard salvage path — exactly-once, byte-identical
        # continuation. `replicas` is ignored when topology is given.
        self._topology = None
        roles = None
        if topology is not None:
            np_ = int(topology.get("prefill", 0))
            nd = int(topology.get("decode", 0))
            if np_ < 1 or nd < 1:
                raise ValueError(
                    f"topology needs at least one prefill and one "
                    f"decode worker, got {topology!r}")
            self._topology = {"prefill": np_, "decode": nd}
            roles = ["prefill"] * np_ + ["decode"] * nd
            replicas = np_ + nd
        if backends is not None:
            self._replicas = list(backends)
            if roles is not None and len(self._replicas) != len(roles):
                raise ValueError(
                    f"topology {self._topology} needs "
                    f"{len(roles)} backends, got {len(self._replicas)}")
            for i, rep in enumerate(self._replicas):
                rep.role = roles[i] if roles else rep.role or "any"
                rep.breaker = CircuitBreaker(
                    threshold=quarantine_threshold,
                    probe_backoff=probe_backoff)
            replicas = len(self._replicas)
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        if backends is None:
            if factory is None:
                raise ValueError(
                    "EngineRouter needs an engine factory (or "
                    "backends=[...] for a process-backed fleet)")
            self._replicas = []
            for i in range(int(replicas)):
                role = roles[i] if roles else "any"
                name = f"{role[0] if roles else 'r'}{i}"
                rep = EngineReplica(name, factory, role=role)
                rep.breaker = CircuitBreaker(
                    threshold=quarantine_threshold,
                    probe_backoff=probe_backoff)
                self._replicas.append(rep)
        self._by_name = {r.name: r for r in self._replicas}
        # prefix_routing=True: CACHE-AWARE routing — replicas publish
        # their content-addressed prefix chains into a fleet index
        # (inference/prefix_index.py; pass prefix_index= to share a
        # StorePrefixIndex across processes) and each fresh admission
        # lands on the replica holding the LONGEST cached prefix,
        # headroom-weighted (a replica with no free slot or a backlog
        # ranks below a fresh one regardless of coverage). When the
        # best-prefix replica lacks headroom, its cached pages SHIP to
        # the chosen replica over the ticketed page-transfer path
        # instead of re-prefilling. Dead/rebuilt replicas drop out of the
        # index; every hint is advisory — a stale entry costs one
        # re-prefill, never correctness.
        self.prefix_index = None
        if prefix_routing or prefix_index is not None:
            if prefix_index is None:
                from .prefix_index import PrefixIndex
                prefix_index = PrefixIndex()
            self.prefix_index = prefix_index
            for rep in self._replicas:
                rep.attach_prefix_index(prefix_index)
        # telemetry=True (or a telemetry.Telemetry used as the ROUTER-
        # level source) wires the whole fleet: each replica gets its
        # OWN Telemetry (registry + traces live on the EngineReplica,
        # so p50/p95/p99 survive engine rebuilds, failover, hot-swap)
        # and the router keeps one for fleet-level request traces
        # (route / requeue / handoff legs). metrics() merges the
        # per-replica registries into one fleet view;
        # export_chrome_trace() merges the timelines.
        self._tel = None
        self.telemetry = None
        if telemetry:
            from .telemetry import Telemetry
            if isinstance(telemetry, Telemetry):
                self._tel = telemetry
                self._tel.name = "router"
            else:
                self._tel = Telemetry(name="router")
            self.telemetry = self._tel
            for rep in self._replicas:
                # replica faults already land in the router timeline
                # via its hook; per-replica hooks would duplicate them
                rep.attach_telemetry(
                    Telemetry(name=rep.name, capture_faults=False))
        self._probe_kw = dict(retries=int(probe_retries),
                              base_delay=float(probe_base_delay),
                              jitter=float(probe_jitter),
                              max_elapsed=probe_max_elapsed,
                              seed=int(probe_seed), sleep=probe_sleep,
                              raise_exhausted=True)
        # elastic-fleet seams (ROADMAP A7.9's FleetController):
        # the factory and breaker config are kept so add_replica can
        # build new in-process replicas after construction; affinity
        # maps adapter name -> replica-name set (routing preference,
        # not a constraint); shedding=True is the controller's LAST
        # resort — fresh admissions refuse typed until it clears.
        # All of it is INERT until a controller acts: a router nobody
        # scales behaves byte-identically to one without these fields.
        self._factory = factory
        self._breaker_kw = dict(threshold=int(quarantine_threshold),
                                probe_backoff=int(probe_backoff))
        self._adapter_affinity = {}
        self.shedding = False
        self.hold_limit = None if hold_limit is None else int(hold_limit)
        self._reqs = {}                 # router uid -> _RouterRequest
        self._assigned = collections.defaultdict(set)  # name -> {ruid}
        self._held = collections.deque()               # unrouted ruids
        self._specs = {}                # ruid -> pending resume spec
        self._next_uid = 0
        self._rr = 0                    # routing tie-break rotation
        # observability (tests and chip_smoke.py assert on these)
        self.steps = 0
        self.failovers = 0              # replica-declared-dead events
        self.requeued = 0               # in-flight requests moved
        self.duplicates_dropped = 0     # second deliveries ignored
        self.probes = 0
        self.hot_swaps = 0              # completed fleet swaps
        self.swap_rollbacks = 0
        self.kv_handoffs = 0            # prefill->decode page migrations
        self.handoff_failures = 0       # export/import/commit attempts
        #                                 that fell back (request safe
        #                                 either way — never lost)
        self.handoff_transports = collections.Counter()
        #                                 which negotiated path each
        #                                 landed handoff ran (device/
        #                                 store/host — the LOUD tag)
        self.prefix_routed = 0          # admissions steered by the index
        self.prefix_ships = 0           # prefix-page chains shipped to
        #                                 a fresh replica pre-admission
        self.prefix_ship_failures = 0   # ships that fell back (request
        #                                 re-prefills — never lost)
        self.prefix_ship_transports = collections.Counter()
        #                                 which path each landed ship
        #                                 ran (device/host)
        self.prefix_ship_fallbacks = 0  # device-pair ships whose device
        #                                 export failed and that retried
        #                                 through the host bounce (each
        #                                 also warns and, with
        #                                 telemetry, logs an event)
        self.crash_loops = 0            # replicas that hit the respawn
        #                                 circuit-breaker cap (fleet
        #                                 mode; counted once per
        #                                 crash-loop episode)
        self.shed_rejections = 0        # admissions refused while the
        #                                 controller had shedding on

    # -- public ------------------------------------------------------------
    def add_request(self, ids, max_new_tokens=32, eos_token_id=None,
                    deadline_ms=None, ttl_steps=None, tenant=None,
                    priority=None, adapter=None, sampling=None):
        """Queue one prompt on the healthiest replica; returns a ROUTER
        uid (stable across failovers — the engine-level uid may change
        when the request migrates). Signature mirrors
        ContinuousBatchingEngine.add_request (adapter= names a LoRA
        fine-tune deployed via load_adapter — the name rides the spec
        through failover and KV handoff; sampling= is a SamplingParams
        or its to_spec() dict and likewise rides the spec, so a sampled
        request keeps its temperature/top-k/top-p AND its counter-based
        key stream across failover and disagg handoff); per-tenant
        admission is enforced by each replica's own policy."""
        if self.shedding:
            # the autoscale controller's documented last resort: fleet
            # at max_replicas and still SLO-breached — refuse typed at
            # the door (clients retry with backoff) instead of growing
            # an unbounded hold queue
            self.shed_rejections += 1
            raise NoReplicaAvailableError(
                "router is load-shedding (fleet at max capacity and "
                "SLO-breached); retry later")
        ids = np.asarray(ids, np.int64).ravel()
        deadline = (time.monotonic() + deadline_ms / 1e3
                    if deadline_ms is not None else None)
        if sampling is not None and not isinstance(sampling, dict):
            sampling = sampling.to_spec()   # SamplingParams -> wire dict
        spec = {"prompt": ids, "max_new_tokens": int(max_new_tokens),
                "eos_token_id": eos_token_id, "tenant": tenant or "default",
                "priority": priority, "ttl_steps": ttl_steps,
                "deadline": deadline, "adapter": adapter,
                "sampling": sampling}
        rr = _RouterRequest(self._next_uid, spec["tenant"])
        self._next_uid += 1
        self._reqs[rr.uid] = rr
        if self._tel is not None:
            self._tel.req_start("router", rr.uid, prompt_len=ids.size,
                                max_new=int(max_new_tokens))
        try:
            self._route(rr, spec)
        except Exception:
            del self._reqs[rr.uid]
            if self._tel is not None:
                self._tel.drop("router", rr.uid)
            raise
        return rr.uid

    def step(self):
        """One router iteration: re-route held requests, probe
        quarantined replicas, then step every serving replica once
        (collecting completions after each). Returns False when no
        replica had work and nothing is held."""
        self.steps += 1
        self._flush_held()
        did = False
        for rep in self._replicas:
            if rep.breaker.state == "open":
                if rep.breaker.ready_to_probe(self.steps):
                    did |= self._probe(rep)
                continue
            if not rep.has_work():
                if rep.breaker.state == "half_open":
                    # no trial traffic arrived: a clean idle heartbeat
                    # is the closing observation (otherwise a lightly
                    # loaded fleet leaves revived replicas half-open
                    # forever — traffic always prefers closed ones)
                    try:
                        fault_point("replica.heartbeat", detail=rep.name)
                        rep.headroom()
                        rep.breaker.record_success()
                    except Exception as e:
                        self._on_replica_failure(rep, e)
                    did = True
                continue
            try:
                fault_point("replica.heartbeat", detail=rep.name)
                fault_point("replica.step", detail=rep.name)
                moved = rep.step()
            except EngineFullError as e:
                # a request that can NEVER fit an idle replica is a
                # per-REQUEST problem (capacity), not a replica fault
                self._fail_stuck_head(rep, e)
                did = True
                continue
            except Exception as e:      # InjectedFault or real
                self._on_replica_failure(rep, e)
                did = True
                continue
            rep.breaker.record_success()
            self._collect(rep)
            did = did or moved
        if self._topology is not None:
            did |= self._handoff_sweep()
        return did or bool(self._held)

    def drain(self):
        """Run until every submitted request has a result or failure.
        Returns {router_uid: output} for requests completed by this
        call."""
        before = {u for u, r in self._reqs.items() if r.state == DONE}
        while self.step():
            pass
        # a final collect: completions from the last productive step
        for rep in self._replicas:
            if rep.breaker.state != "open":
                self._collect(rep)
        return {u: r.result for u, r in self._reqs.items()
                if r.state == DONE and u not in before}

    def result(self, uid):
        """Exactly-once output for a router uid: the SAME array no
        matter how many replicas the request crossed or how many times
        a replica tried to deliver it. Typed errors mirror the
        scheduler's."""
        rr = self._reqs.get(uid)
        if rr is None:
            raise UnknownRequestError(f"unknown request uid {uid}")
        if rr.state == FAILED:
            raise RequestFailedError(rr.failure)
        if rr.state != DONE:
            raise RequestNotFinishedError(
                f"request {uid} is {rr.state}, not done")
        return rr.result

    def status(self, uid):
        rr = self._reqs.get(uid)
        if rr is None:
            raise UnknownRequestError(f"unknown request uid {uid}")
        return rr.state

    def failures(self):
        """{router_uid: RequestFailure} for requests that failed AT THE
        ROUTER LEVEL (shed deadlines, capacity, exhausted re-queues) —
        replica-local failures that were recovered by failover never
        appear here."""
        return {u: r.failure for u, r in self._reqs.items()
                if r.failure is not None}

    def pending(self):
        # DEMOTED mirrors in from tiered replicas (_collect): a parked
        # request is LIVE — it restores and finishes; dropping it here
        # would let a `while router.pending(): step()` caller stop
        # stepping and strand the conversation in the tier
        return [u for u, r in self._reqs.items()
                if r.state in (QUEUED, PREFILL, DECODE, DEMOTED)]

    def __len__(self):
        return len(self.pending())

    def health(self):
        """Fleet snapshot: per-replica engine health + breaker state,
        plus the router's own counters."""
        reps = {}
        for rep in self._replicas:
            br = rep.breaker
            entry = {"state": rep.state, "role": rep.role,
                     "breaker": br.state,
                     "failures": br.failures, "kills": rep.kills,
                     "swaps": rep.swaps, "last_error": br.last_error,
                     "assigned": len(self._assigned[rep.name])}
            if br.state != "open":
                try:
                    entry.update(rep.headroom())
                except Exception as e:  # health must never throw
                    entry["health_error"] = f"{type(e).__name__}: {e}"
            try:
                entry.update(rep.extra_health())
            except Exception:
                pass                    # backend extras are advisory
            reps[rep.name] = entry
        states = collections.Counter(r.state for r in self._reqs.values())
        return {
            "replicas": reps,
            "held": len(self._held),
            "pending": len(self.pending()),
            "done": states[DONE],
            "failed": states[FAILED],
            "steps": self.steps,
            "failovers": self.failovers,
            "requeued": self.requeued,
            "duplicates_dropped": self.duplicates_dropped,
            "probes": self.probes,
            "hot_swaps": self.hot_swaps,
            "swap_rollbacks": self.swap_rollbacks,
            "topology": self._topology,
            "kv_handoffs": self.kv_handoffs,
            "handoff_failures": self.handoff_failures,
            # cache-aware routing
            "prefix_routing": self.prefix_index is not None,
            "prefix_routed": self.prefix_routed,
            "prefix_ships": self.prefix_ships,
            "prefix_ship_failures": self.prefix_ship_failures,
            "prefix_index": (self.prefix_index.stats()
                             if self.prefix_index is not None else None),
            # elastic fleet (ROADMAP A7.9)
            "crash_loops": self.crash_loops,
            "shedding": self.shedding,
            "shed_rejections": self.shed_rejections,
            "adapter_affinity": self.adapter_affinity(),
        }

    # -- telemetry / fleet metrics -----------------------------------------
    def metrics(self):
        """ONE fleet metrics view (requires telemetry=): the merged
        per-replica registries — TTFT/TPOT/queue-wait/block/handoff/
        restore histograms whose counts survive failover, rebuild, and
        hot-swap because each registry lives on its EngineReplica — plus
        per-replica snapshots and the router's own control-plane
        counters. Each call also rate-samples every reachable replica's
        health() counters into its registry (the `<counter>_per_s`
        gauges), so two metrics() calls a scrape interval apart give
        live rates."""
        out = {"router": {
            "steps": self.steps, "failovers": self.failovers,
            "requeued": self.requeued, "probes": self.probes,
            "hot_swaps": self.hot_swaps,
            "swap_rollbacks": self.swap_rollbacks,
            "kv_handoffs": self.kv_handoffs,
            "handoff_failures": self.handoff_failures,
            "prefix_ship_fallbacks": self.prefix_ship_fallbacks,
            "held": len(self._held), "pending": len(self.pending()),
            "crash_loops": self.crash_loops,
            "shed_rejections": self.shed_rejections,
            "replicas": len(self._replicas),
        }}
        if self._tel is None:
            out["fleet"] = None
            out["replicas"] = {}
            return out
        from .telemetry import MetricsRegistry
        regs = []
        reps_snap = {}
        for rep in self._replicas:
            # metrics_registry is the backend-agnostic pull: the
            # in-process replica samples its own health() into its
            # registry; a ProcessReplica fetches the remote registry
            # state + health in ONE rpc and answers from its mirror
            # (last-known state when the worker is unreachable — fleet
            # p99s must not vanish with the process)
            try:
                if rep.breaker.state == "open":
                    # a blackholed worker's pull would block a full
                    # call_timeout PER SCRAPE (and serve_prometheus
                    # renders under one lock, so every concurrent
                    # scrape queues behind it): an open breaker
                    # answers from the mirror — the last-known state
                    # it exists to keep — until a probe closes it
                    reg = getattr(rep.telemetry, "registry", None)
                else:
                    reg = rep.metrics_registry(sample=True)
            except Exception:           # metrics must never throw
                reg = getattr(rep.telemetry, "registry", None)
            if reg is None:
                continue
            regs.append(reg)
            reps_snap[rep.name] = reg.snapshot()
        regs.append(self._tel.registry)
        out["fleet"] = MetricsRegistry.merged(regs).snapshot()
        out["replicas"] = reps_snap
        return out

    def prometheus(self, prefix="paddle_tpu"):
        """Prometheus text exposition of the merged fleet registry."""
        if self._tel is None:
            raise ValueError("prometheus() needs EngineRouter("
                             "telemetry=...) — nothing is collected")
        from .telemetry import MetricsRegistry
        regs = []
        for rep in self._replicas:
            try:
                if rep.breaker.state == "open":
                    reg = getattr(rep.telemetry, "registry", None)
                else:                   # (see metrics(): an open
                    #                     breaker answers from the
                    #                     mirror, never the wire)
                    reg = rep.metrics_registry(sample=False)
            except Exception:
                reg = getattr(rep.telemetry, "registry", None)
            if reg is not None:
                regs.append(reg)
        regs.append(self._tel.registry)
        return MetricsRegistry.merged(regs).prometheus(prefix)

    def export_chrome_trace(self, path):
        """Write the FLEET timeline (router legs + every replica's
        request spans) as one perfetto-loadable chrome-trace JSON —
        each source is a pid, each request a tid. Remote replicas'
        trace mirrors are refreshed first (one rpc per live worker)."""
        if self._tel is None:
            raise ValueError("export_chrome_trace() needs EngineRouter("
                             "telemetry=...) — nothing was traced")
        from .telemetry import export_chrome_trace
        for rep in self._replicas:
            try:
                if rep.breaker.state != "open":
                    rep.sync_telemetry()
            except Exception:
                pass                    # export what we last saw
        tels = [self._tel] + [rep.telemetry for rep in self._replicas
                              if rep.telemetry is not None]
        return export_chrome_trace(path, tels)

    # -- multi-LoRA adapter deployment (inference/adapters.py) ---------------
    def load_adapter(self, name, path, replicas=None):
        """Deploy a fine-tune to the FLEET: one registry write fanned
        to every reachable replica's pool (quarantined replicas pick
        it up at rebuild — EngineReplica.rebuild replays its adapter
        registry). Returns {replica: "loaded" | "error: ..."}; raises
        AdapterDeployError only when NO replica could load (a partial
        fleet still serves the adapter — routing is health-ordered and
        a replica without it fails that request typed, which failover
        then re-routes).

        replicas=[names]: AFFINITY deploy — fan only to that subset
        and record it as the adapter's routing preference (the
        autoscale controller places hot fine-tunes this way so every
        replica stops paying pool pages for every adapter)."""
        targets = self._replicas
        if replicas is not None:
            unknown = [r for r in replicas if r not in self._by_name]
            if unknown:
                raise ValueError(
                    f"load_adapter names unknown replicas {unknown}")
            targets = [self._by_name[r] for r in replicas]
        summary = {}
        ok = deferred = 0
        for rep in targets:
            if rep.breaker.state == "open":
                # recorded for the drain at the next clean probe AND
                # for rebuild's registry replay — a quarantined
                # replica usually re-enters via a probe, not a rebuild
                rep.adapters[name] = str(path)
                rep.adapters_pending[name] = "load"
                summary[rep.name] = "deferred-quarantined"
                deferred += 1
                continue
            try:
                rep.load_adapter(name, path)
                summary[rep.name] = "loaded"
                ok += 1
            except Exception as e:
                summary[rep.name] = f"error: {type(e).__name__}: {e}"
        if not ok and not deferred:
            raise AdapterDeployError(
                f"adapter {name!r} failed to load on every replica: "
                f"{summary}")
        if replicas is not None:
            self.set_adapter_affinity(name, list(replicas))
        if self._tel is not None:
            # counted only for deploys that LANDED (or deferred) —
            # a fleet-wide failure raised above, and a dashboard must
            # not read it as a successful deploy
            self._tel.event("adapter_deploy", name=name, loaded=ok)
            self._tel.registry.count("adapter_deploys")
        return summary

    def evict_adapter(self, name):
        """Evict a fine-tune fleet-wide (replicas with live requests
        on it refuse typed and keep it — report, don't force)."""
        self._adapter_affinity.pop(name, None)
        summary = {}
        for rep in self._replicas:
            if rep.breaker.state == "open":
                # the live worker (if any) keeps serving it until the
                # next clean probe drains the pending evict; rebuild
                # satisfies it too (the registry entry is gone)
                rep.adapters.pop(name, None)
                rep.adapters_pending[name] = "evict"
                summary[rep.name] = "deferred-quarantined"
                continue
            try:
                rep.evict_adapter(name)
                summary[rep.name] = "evicted"
            except Exception as e:
                summary[rep.name] = f"error: {type(e).__name__}: {e}"
        return summary

    # -- weight hot-swap ---------------------------------------------------
    def save_weights_snapshot(self, path, step=None):
        """Snapshot the fleet's CURRENT weights (from the first
        non-quarantined replica — homogeneous by construction) through
        the atomic CRC32-manifest checkpoint layer; the artifact a
        later hot_swap() loads and verifies."""
        for rep in self._replicas:
            if rep.breaker.state != "open":
                return rep.save_weights_snapshot(path, step=step)
        raise ReplicaFailedError(
            "every replica is quarantined — no healthy weights to "
            "snapshot")

    def hot_swap(self, path):
        """Zero-downtime rolling weight swap: for each replica — hold
        its queue, MIGRATE its running requests to the other replicas,
        load + verify `path` through the atomic CRC32-manifest
        checkpoint layer, flip at a block boundary, re-admit. Serving
        never stops: the other replicas keep stepping traffic (and
        absorb the migrations). On CheckpointCorruptError (or any
        load/flip error) every already-flipped replica is rolled back
        to the old weights — the fleet finishes the call either fully
        on the new snapshot or fully on the old one, never mixed —
        and HotSwapError is raised with the cause chained.

        Quarantined replicas are skipped (flagged in the summary); a
        later successful probe re-admits them still on the old weights,
        so re-run hot_swap after recovery if the fleet must converge.
        Replicas an operator already put in DRAINING (drain_replica)
        are likewise skipped and LEFT draining — a deploy must not
        silently un-drain a maintenance hold. Returns {replica_name:
        "swapped" | "skipped-quarantined" | "skipped-draining"}."""
        flipped = []                    # (replica, old_weights)
        drained_here = set()            # replicas THIS call set DRAINING
        summary = {}
        try:
            for rep in self._replicas:
                if rep.breaker.state == "open":
                    summary[rep.name] = "skipped-quarantined"
                    continue
                if rep.state == DRAINING:
                    summary[rep.name] = "skipped-draining"
                    continue
                rep.state = DRAINING    # routing skips it from here on
                drained_here.add(rep.name)
                self._migrate_running(rep)
                old = rep.export_weights()
                new = rep.load_weights_snapshot(path)   # CRC32 + shapes
                rep.install_weights(new)                # block boundary
                flipped.append((rep, old))
                rep.state = ACTIVE
                summary[rep.name] = "swapped"
        except Exception as e:
            for rep, old in flipped:
                rep.state = DRAINING
                self._migrate_running(rep)      # should be none; safety
                rep.install_weights(old)
            self.swap_rollbacks += 1
            for rep in self._replicas:
                if rep.state == DRAINING and rep.name in drained_here:
                    rep.state = ACTIVE  # operator-drained stay drained
            if self._tel is not None:
                self._tel.event("hot_swap_rollback", path=str(path),
                                error=f"{type(e).__name__}: {e}")
            raise HotSwapError(
                f"hot swap of {path!r} aborted "
                f"({type(e).__name__}: {e}); all replicas rolled back "
                "to the previous weights, serving continued") from e
        self.hot_swaps += 1
        if self._tel is not None:
            self._tel.event("hot_swap", path=str(path),
                            swapped=sum(1 for v in summary.values()
                                        if v == "swapped"))
        return summary

    def drain_replica(self, name):
        """Graceful drain without a swap: hold the replica's queue and
        migrate its running requests to the rest of the fleet. The
        replica stays DRAINING (no new traffic) until activate()."""
        rep = self._by_name[name]
        rep.state = DRAINING
        self._migrate_running(rep)
        return rep

    def activate(self, name):
        self._by_name[name].state = ACTIVE

    # -- elastic fleet (ROADMAP A7.9's controller drives these) -------------
    def add_replica(self, backend=None, name=None, role="any"):
        """Scale-out seam: wire ONE new replica into the live router.

        backend: a pre-built replica (FleetHandle.spawn_worker's
        ProcessReplica, or anything serving the EngineReplica surface);
        None builds an in-process EngineReplica from the router's own
        factory. The new replica gets a fresh breaker and — when the
        router runs telemetry / a prefix index — its own Telemetry and
        the shared index, exactly as construction wires them."""
        if backend is None:
            if self._factory is None:
                raise ValueError(
                    "add_replica needs backend= on a router built "
                    "over backends (no factory to construct from)")
            name = name or f"r{self._next_replica_ordinal()}"
            backend = EngineReplica(name, self._factory, role=role)
        else:
            if role != "any" or not getattr(backend, "role", None):
                backend.role = role
        if backend.name in self._by_name:
            raise ValueError(
                f"replica name {backend.name!r} already serves")
        backend.breaker = CircuitBreaker(**self._breaker_kw)
        if self._tel is not None:
            from .telemetry import Telemetry
            backend.attach_telemetry(
                Telemetry(name=backend.name, capture_faults=False))
        if self.prefix_index is not None:
            backend.attach_prefix_index(self.prefix_index)
        self._replicas.append(backend)
        self._by_name[backend.name] = backend
        if self._topology is not None and \
                backend.role in self._topology:
            self._topology[backend.role] += 1
        if self._tel is not None:
            self._tel.event("scale_out", replica=backend.name,
                            role=backend.role,
                            fleet=len(self._replicas))
        return backend

    def _next_replica_ordinal(self):
        n = len(self._replicas)
        while f"r{n}" in self._by_name:
            n += 1
        return n

    def retire_replica(self, name):
        """Drain-then-retire with ZERO lost requests: full evacuation
        through the same salvage triage failover uses — finished work
        delivers exactly-once, live work re-queues on the rest of the
        fleet with committed tokens folded in, engine-queued requests
        re-route too (they carry no KV). The retired replica's
        lifetime telemetry merges into the router registry so fleet
        p99s survive the retirement. Returns the detached replica — the
        caller shuts its worker down."""
        rep = self._by_name.get(name)
        if rep is None:
            raise ValueError(f"unknown replica {name!r}")
        if len(self._replicas) <= 1:
            raise ValueError("cannot retire the last replica")
        if self._topology is not None and rep.role in self._topology \
                and self._topology[rep.role] <= 1:
            raise ValueError(
                f"cannot retire the last {rep.role!r} worker of a "
                "disaggregated topology")
        rep.state = DRAINING            # routing skips it from here on
        for ruid in list(self._assigned[rep.name]):
            self._salvage_one(rep, ruid)
        if self._tel is not None:
            reg = getattr(rep.telemetry, "registry", None)
            if reg is not None:
                self._tel.registry.merge(reg)
            self._tel.event("scale_in", replica=rep.name,
                            fleet=len(self._replicas) - 1)
        self._replicas.remove(rep)
        del self._by_name[name]
        self._assigned.pop(name, None)
        if self._topology is not None and rep.role in self._topology:
            self._topology[rep.role] -= 1
        if self.prefix_index is not None:
            try:
                self.prefix_index.drop_replica(name)
            except Exception:
                pass
        for aff in self._adapter_affinity.values():
            aff.discard(name)
        return rep

    def set_replica_role(self, name, role):
        """Live prefill<->decode rebalance (topology mode): flip the
        worker's role in place — no drain, no respawn. A decode worker
        that becomes a prefill worker keeps its running requests; the
        next step's handoff sweep migrates their decode-state KV to
        the decode pool over the negotiated transport (byte-identical
        continuation, zero recompute) — the hot-swap drain + KV
        handoff machinery repurposed for role changes."""
        rep = self._by_name.get(name)
        if rep is None:
            raise ValueError(f"unknown replica {name!r}")
        if role not in ("prefill", "decode", "any"):
            raise ValueError(f"unknown role {role!r}")
        if self._topology is None:
            raise ValueError(
                "set_replica_role needs a disaggregated topology "
                "(EngineRouter(topology=...))")
        old = rep.role
        if old == role:
            return rep
        if old in self._topology and self._topology[old] <= 1:
            raise ValueError(
                f"cannot re-role the last {old!r} worker")
        rep.role = role
        if old in self._topology:
            self._topology[old] -= 1
        self._topology[role] = self._topology.get(role, 0) + 1
        if self._tel is not None:
            self._tel.event("rebalance", replica=name,
                            from_role=old, to_role=role,
                            topology=dict(self._topology))
        return rep

    def shift_queued(self, max_moves=8):
        """Post-scale-out rebalance: salvage engine-QUEUED requests
        off the deepest backlogs so they re-route health-ordered —
        typically onto the fresh empty replica. Queued requests carry
        no KV, so each move is a pure re-route (the same
        keep-nothing-behind triage as failover, minus the failure).
        Returns how many moved.

        The backlogs are read once, before the first move: a request this
        call moved onto another replica is not in that replica's snapshot,
        so it is never moved a second time (back to the backlog it left).
        """
        moved = 0
        by_depth = [(rep, list(self._assigned[rep.name])) for rep in
                    sorted(self._replicas,
                           key=lambda r: -len(self._assigned[r.name]))]
        for rep, backlog in by_depth:
            if moved >= max_moves:
                break
            if rep.breaker.state == "open" or rep.state != ACTIVE:
                continue
            for ruid in backlog:
                if moved >= max_moves:
                    break
                rr = self._reqs[ruid]
                if rr.state != QUEUED:
                    continue
                try:
                    if rep.status(rr.engine_uid) != QUEUED:
                        continue        # seated since we looked
                except Exception:
                    continue            # next step's failover handles
                self._salvage_one(rep, ruid)
                moved += 1
        return moved

    def set_adapter_affinity(self, name, replicas):
        """Pin adapter `name`'s routing preference to a replica
        subset: admissions naming it try these first (health-ordered
        within the subset), everyone else stays fallback — a replica
        without the adapter refuses typed and routing moves on, so
        affinity can never strand a request. Empty/None clears."""
        if not replicas:
            self._adapter_affinity.pop(name, None)
            return
        unknown = [r for r in replicas if r not in self._by_name]
        if unknown:
            raise ValueError(
                f"affinity names unknown replicas {unknown}")
        self._adapter_affinity[name] = set(replicas)

    def adapter_affinity(self):
        return {n: sorted(s)
                for n, s in self._adapter_affinity.items()}

    # -- routing -----------------------------------------------------------
    # TIER-AWARE routing: an admission whose
    # KV page need reaches this floor counts as a "long conversation"
    # and weighs each replica's `pages_demoted` (device pages parked in
    # its KV tier) against its raw free pages — a replica that freed
    # pages by demoting running requests is NOT really that free:
    # seating a long request there deepens the oversubscription spiral
    # (its parked conversations restore, demote the newcomer, repeat).
    # Short requests keep the plain health order (they fit in the churn).
    tier_aware_pages = 4

    def _routable(self, exclude=(), page_need=None):
        """Replicas that may take NEW work, healthiest first: fewest
        queued, most free slots, most free pages (discounted by tier
        pressure for long conversations — see tier_aware_pages);
        half-open breakers rank after closed ones (trial traffic only
        when the healthy fleet is full); a rotating tie-break spreads
        exact ties instead of piling them on r0. `exclude`d replicas
        are skipped ENTIRELY — no heartbeat, no headroom read — so
        salvaging a dying replica never re-heartbeats it and
        double-charges its breaker for one logical failure."""
        cand = []
        n = len(self._replicas)
        long_conv = (page_need is not None
                     and page_need >= self.tier_aware_pages)
        for i, rep in enumerate(self._replicas):
            if rep.name in exclude or rep.state != ACTIVE or \
                    rep.breaker.state == "open":
                continue
            try:
                fault_point("replica.heartbeat", detail=rep.name)
                h = rep.headroom()
            except Exception as e:
                self._on_replica_failure(rep, e)
                continue
            free = h["pages_free"]
            if long_conv:
                free -= h.get("pages_demoted", 0)
            cand.append((rep.breaker.state == "half_open", h["queued"],
                         h["running"] - h["slots_total"], -free,
                         (i - self._rr) % n, rep))
        cand.sort(key=lambda t: t[:5])
        self._rr += 1
        return [t[-1] for t in cand]

    def _page_need(self, spec):
        """KV pages the spec's admission would claim (the engines'
        _pages_needed rule) — the tier-aware routing weight. None when
        it cannot be derived (no replicas / malformed spec): routing
        falls back to the plain health order."""
        try:
            prompt = spec.get("prompt")
            if prompt is None or not self._replicas:
                return None
            p = int(self._replicas[0].page_size())
            t0 = int(np.asarray(prompt).size)
            mnt = int(spec.get("max_new_tokens") or 0)
            return -(-max(t0, t0 + mnt - 1) // p)
        except Exception:
            return None

    def _route(self, rr, spec, exclude=(), internal=False):
        """Place a request (fresh or re-queued) on the best replica; if
        none can take it, hold it at the router (bounded) rather than
        drop it.

        internal=True (failover/migration/held re-routing) NEVER
        raises: backpressure and limits only apply to fresh admissions —
        a salvaged request that cannot be placed right now is held
        unconditionally (dropping it would break zero-loss), and one no
        replica can EVER take fails at the router instead of aborting
        the salvage loop that is resolving its replica's death."""
        last_busy = None
        reps = self._routable(exclude, page_need=self._page_need(spec))
        if self._topology is not None:
            # disaggregated mode: every fresh admission (and every
            # spec-requeue — a salvaged request re-prefills anyway)
            # prefers the prefill pool; decode workers are the fallback
            # when NO prefill worker is routable (availability over
            # purity — a quarantined prefill tier must not black-hole
            # admissions while healthy decode engines idle). Prefix
            # ordering applies WITHIN the prefill pool only — ordering
            # (or shipping pages to) a decode worker the topology
            # reorder then bypasses would waste the whole transfer
            pf = [r for r in reps if r.role == "prefill"]
            if self.prefix_index is not None and pf:
                pf = self._prefix_order(spec, pf)
            reps = pf + [r for r in reps if r.role != "prefill"]
        elif self.prefix_index is not None and reps:
            reps = self._prefix_order(spec, reps)
        aff = (self._adapter_affinity.get(spec.get("adapter"))
               if spec.get("adapter") else None)
        if aff:
            # affinity is a PREFERENCE: the pool-resident subset tries
            # first (its internal health order kept), the rest stay as
            # fallback — a non-affinity replica without the adapter
            # refuses typed and the loop moves on, so a dead affinity
            # set degrades to the ordinary deployment-gap path instead
            # of stranding the request
            reps = ([r for r in reps if r.name in aff]
                    + [r for r in reps if r.name not in aff])
        for rep in reps:
            try:
                fault_point("replica.admit", detail=rep.name)
                euid = rep.submit(spec)
            except (EngineBusyError, ValueError, AdapterError) as e:
                # ValueError = this engine can't EVER take it (length
                # beyond max_len) — with homogeneous replicas that is a
                # caller error on fresh admissions. AdapterError = the
                # adapter isn't deployed HERE (a partial registry
                # write, or a rebuild whose replay failed) — a
                # DEPLOYMENT gap, not a replica fault: try the next
                # replica without charging the breaker; surfaced typed
                # when no replica serves it.
                if isinstance(e, ValueError):
                    if internal:
                        self._deliver(rr.uid, failure=RequestFailure(
                            rr.uid, "capacity", e, self.steps))
                        return False
                    raise
                last_busy = e
                continue
            except Exception as e:      # InjectedFault or real
                self._on_replica_failure(rep, e)
                continue
            rr.replica, rr.engine_uid = rep.name, euid
            rr.state = QUEUED
            self._assigned[rep.name].add(rr.uid)
            # keep the submitted spec: if the replica later dies with
            # unreadable host state, failover re-submits THIS spec (work
            # since then is recomputed; delivery stays exactly-once)
            self._specs[rr.uid] = spec
            if self._tel is not None:
                # "route" (NOT "seat"): it marks the router-side seat
                # timestamp for the span chain but must not observe
                # queue_wait_ms — the engine's own seat already does,
                # and the fleet merge would double-count
                self._tel.req_event("router", rr.uid, "route",
                                    replica=rep.name)
            return True
        if isinstance(last_busy, AdapterError):
            # every tried replica refused the ADAPTER (not capacity):
            # if NO replica's registry knows the name, no probe or
            # retry can ever place it — surface typed instead of
            # holding the request forever on a typo (a name some
            # quarantined replica still registers may recover: hold)
            name = spec.get("adapter")
            if not any(name in r.adapters for r in self._replicas):
                if internal:
                    self._deliver(rr.uid, failure=RequestFailure(
                        rr.uid, "adapter", last_busy, self.steps))
                    return False
                raise last_busy
        if not internal:
            if last_busy is not None and not self._held and \
                    all(r.breaker.state != "open" and r.state == ACTIVE
                        for r in self._replicas):
                # every replica is healthy but at queue_limit: surface
                # the engines' own backpressure instead of absorbing it
                raise last_busy
            if self.hold_limit is not None and \
                    len(self._held) >= self.hold_limit:
                raise NoReplicaAvailableError(
                    f"no replica can take this request "
                    f"({len(self._held)} already held at "
                    f"hold_limit={self.hold_limit}); retry later")
        self._specs[rr.uid] = spec
        rr.replica, rr.engine_uid = None, None
        rr.state = QUEUED
        self._held.append(rr.uid)
        if self._tel is not None:
            self._tel.req_event("router", rr.uid, "hold",
                                held=len(self._held))
        return False

    # -- cache-aware routing (fleet prefix index) ----------------------------
    def _prefix_order(self, spec, reps):
        """Reorder routable replicas by cached-prefix coverage,
        HEADROOM-WEIGHTED: replicas with a free slot and an empty
        queue rank first (longest coverage among them wins; a hot
        replica doesn't melt just because it holds the cache), loaded
        ones keep their health order behind. When the longest-coverage
        replica is NOT the chosen one, its cached pages ship to the
        chosen replica over the ticketed page-transfer path — the
        admission then hits locally instead of re-prefilling. Every
        failure path falls back to plain health routing (the index is
        a hint)."""
        from .prefix_index import prompt_digests
        try:
            digs = prompt_digests(spec["prompt"], reps[0].page_size())
            cov = self.prefix_index.lookup(digs) if digs else {}
        except Exception:
            return reps
        if not cov:
            return reps
        free = {}
        for rep in reps:
            try:
                h = rep.headroom()
                free[rep.name] = (h["queued"] == 0
                                  and h["running"] < h["slots_total"])
            except Exception:
                free[rep.name] = False
        order = {rep.name: i for i, rep in enumerate(reps)}
        reps = sorted(reps, key=lambda rp: (
            not free[rp.name], -cov.get(rp.name, 0), order[rp.name]))
        chosen = reps[0]
        best = max(reps, key=lambda rp: cov.get(rp.name, 0))
        best_cov = cov.get(best.name, 0)
        shipped = False
        if best_cov > cov.get(chosen.name, 0) and free[chosen.name]:
            # the best-prefix replica lacks headroom: move the pages to
            # the replica that has it, not the request to the hot one
            shipped = self._ship_prefix(best, chosen, spec["prompt"])
            if shipped:
                self.prefix_ships += 1
            else:
                self.prefix_ship_failures += 1
        if cov.get(chosen.name, 0) or shipped:
            self.prefix_routed += 1
        return reps

    def _transport_kind(self, src, dst):
        """Negotiated transport for a page move src -> dst (handoff.
        negotiate over the replicas' endpoints): "device" when they
        share a process and device type (no host bounce), "store" when
        both sit on one fleet store, else "host". Never raises —
        an unreadable endpoint degrades to the always-works host
        path."""
        from .handoff import negotiate
        try:
            return negotiate(src.transport_endpoint(),
                             dst.transport_endpoint())
        except Exception:
            return "host"

    def _ship_prefix(self, src, dst, prompt):
        """One prefix-page ship src -> dst (ticketed, CRC-checked;
        device-domain pairs skip the host bounce). Never raises;
        False = fell back (the request re-prefills)."""
        device = self._transport_kind(src, dst) == "device"
        try:
            payload = src.export_prefix(prompt, device=device)
        except Exception as e:
            if not device:
                return False
            # transport.device fault (or a device-path failure): the
            # host-bounce path still works — fall back LOUDLY: counted,
            # warned, and logged as a fleet event
            self.prefix_ship_fallbacks += 1
            warnings.warn(f"prefix ship {src.name} -> {dst.name}: the "
                          f"device export failed ({type(e).__name__}: "
                          f"{e}); falling back to the host bounce",
                          RuntimeWarning, stacklevel=2)
            if self._tel is not None:
                self._tel.event("prefix_ship_fallback", src=src.name,
                                dst=dst.name,
                                error=f"{type(e).__name__}: {e}")
            device = False
            try:
                payload = src.export_prefix(prompt)
            except Exception:
                return False
        if payload is None:
            return False                # stale hint: nothing cached
        try:
            dst.import_prefix(payload)
        except Exception:
            try:
                src.abort_prefix_export(payload["token"])
            except Exception:
                pass
            return False
        try:
            src.finish_prefix_export(payload["token"])
        except Exception:
            pass                        # ticket leak-proof: commit is
        #                                 local bookkeeping only
        self.prefix_ship_transports["device" if device else "host"] += 1
        return True

    def _flush_held(self):
        for _ in range(len(self._held)):
            ruid = self._held.popleft()
            rr = self._reqs[ruid]
            if rr.state not in (QUEUED,) or ruid not in self._specs:
                continue
            # re-holds on failure; never raises (these requests were
            # already admitted once — backpressure applies to fresh
            # admissions only)
            self._route(rr, self._specs[ruid], internal=True)

    # -- delivery (exactly-once) -------------------------------------------
    def _deliver(self, ruid, result=None, failure=None):
        """Commit a terminal outcome for a router uid EXACTLY ONCE: the
        first delivery wins, every later one (a replica replaying its
        results after a failover, an injected duplicate) is counted and
        dropped."""
        rr = self._reqs.get(ruid)
        if rr is None:
            return False
        if rr.state in (DONE, FAILED):
            self.duplicates_dropped += 1
            return False
        if rr.replica is not None:
            self._assigned[rr.replica].discard(ruid)
        rr.replica, rr.engine_uid = None, None
        if failure is not None:
            rr.state, rr.failure = FAILED, failure
        else:
            rr.state, rr.result = DONE, result
        self._specs.pop(ruid, None)
        if self._tel is not None:
            # "delivered"/"failed_delivery" rather than the engines'
            # "done"/"failed": the ENGINE's req_done already counted
            # requests_done/requests_failed on its replica registry —
            # reusing those state strings here would double-count every
            # outcome in the merged fleet counters
            self._tel.req_done("router", ruid,
                               "delivered" if failure is None
                               else "failed_delivery",
                               stage=(failure.stage
                                      if failure is not None else None))
        return True

    def _collect(self, rep):
        """Pull terminal outcomes from a replica into the router ledger
        (and mirror live states for status()). A replica that becomes
        UNREACHABLE mid-collect (a process worker killed between its
        step and this read) aborts the pass — its requests stay
        assigned and the next step()'s failure handling salvages them
        through the standard failover path."""
        # only TRANSPORT-class failures abort the pass (FleetRPCError,
        # or an injected rpc.call/heartbeat fault standing in for one);
        # a deterministic bug in result()/_deliver() must stay LOUD —
        # swallowing it here would recur every step and spin drain()
        # forever on a healthy replica
        from .fleet import FleetRPCError
        transport_errs = (FleetRPCError, InjectedFault)
        for ruid in list(self._assigned[rep.name]):
            rr = self._reqs[ruid]
            try:
                st = rep.status(rr.engine_uid)
            except UnknownRequestError:
                continue
            except transport_errs:
                break
            try:
                if st == DONE:
                    self._deliver(ruid,
                                  result=rep.result(rr.engine_uid))
                elif st in (FAILED, "cancelled"):
                    self._deliver(ruid,
                                  failure=rep.failure(rr.engine_uid))
                else:
                    rr.state = st
            except transport_errs:
                break                   # unreachable mid-fetch: the
                #                         next step salvages
        return None

    # -- failover ----------------------------------------------------------
    def _salvage_one(self, rep, ruid, keep_queued=False):
        """Resolve ONE request assigned to a dead/draining replica —
        the single triage shared by failover and migration. Finished
        work delivers (exactly-once, never recomputed), per-request
        failures (deadline/cancel/poison) surface, live work re-queues
        on the rest of the fleet with its generated tokens folded into
        the prompt. keep_queued=True (migration) leaves engine-queued
        requests in place — they carry no KV, so they hold through a
        weight flip. Never raises."""
        rr = self._reqs[ruid]
        if ruid not in self._assigned[rep.name] or \
                rr.replica != rep.name:
            # REENTRANCY: re-routing a salvaged request reads other
            # replicas' health, whose fault points can declare THIS
            # replica dead again in a nested handler that already moved
            # this ruid — processing the stale snapshot entry would
            # re-queue it twice and evict whichever innocent request
            # now owns its old engine uid here
            return
        salvage = None
        try:
            st = rep.status(rr.engine_uid)
            if st == DONE:
                # completed before the failure but not yet collected:
                # deliver, don't re-run (exactly-once)
                self._deliver(ruid, result=rep.result(rr.engine_uid))
                return
            if st in (FAILED, "cancelled"):
                fl = rep.failure(rr.engine_uid)
                if fl is not None and fl.stage != "engine":
                    # the REQUEST failed (deadline/cancel/poison), not
                    # the replica — failover must not resurrect it
                    self._deliver(ruid, failure=fl)
                    return
                # stage=="engine": the replica's pools died under it —
                # its committed tokens are still in the record's host
                # state; fall through to re-queue
            elif st == QUEUED and keep_queued:
                return
            salvage = rep.export_resume(rr.engine_uid)
        except Exception:
            # replica host state unreadable: re-submit the LAST known
            # spec (original prompt if never re-queued) — tokens may be
            # recomputed but never delivered twice
            salvage = self._specs.get(ruid)
        self._assigned[rep.name].discard(ruid)
        rep.evict(rr.engine_uid)
        rr.replica, rr.engine_uid = None, None
        rr.state = QUEUED
        if salvage is None:
            self._deliver(ruid, failure=RequestFailure(
                ruid, "replica",
                ReplicaFailedError(
                    f"replica {rep.name} died and the request could "
                    "not be salvaged"), self.steps))
            return
        rr.requeues += 1
        self.requeued += 1
        if self._tel is not None:
            # the failover leg in the request's fleet timeline: its
            # engine-side trace on `rep` ended (cancelled); the
            # continuation re-prefills elsewhere byte-identically
            self._tel.req_event("router", ruid, "requeue",
                                from_replica=rep.name,
                                requeues=rr.requeues)
        self._route(rr, self._clean_spec(salvage), exclude=(rep.name,),
                    internal=True)

    def _on_replica_failure(self, rep, exc):
        """Declare a replica dead for its CURRENT work: salvage every
        assigned request, then charge the breaker. The replica object
        itself stays usable — a fault-point kill leaves the engine
        intact minus the evicted requests, a real dispatch error
        already rebuilt its pools — so a closed/half-open breaker lets
        it take fresh traffic next step, and an open one routes it
        through quarantine probes instead."""
        rep.kills += 1
        self.failovers += 1
        if self._tel is not None:
            self._tel.event("replica_failure", replica=rep.name,
                            error=f"{type(exc).__name__}: {exc}",
                            assigned=len(self._assigned[rep.name]))
        if self.prefix_index is not None:
            # stale index claims would keep routing traffic (and ships)
            # at a dead cache; the replica re-publishes as it re-serves
            try:
                self.prefix_index.drop_replica(rep.name)
            except Exception:
                pass
        for ruid in list(self._assigned[rep.name]):
            self._salvage_one(rep, ruid)
        rep.breaker.record_failure(exc, self.steps)

    @staticmethod
    def _clean_spec(spec):
        """export_request payload -> submit_resume payload (drop the
        source engine's bookkeeping keys; "generated" rides along so
        the target engine knows a continuation is RESUMED — its first
        local token is not the request's TTFT)."""
        return {k: spec[k] for k in
                ("prompt", "max_new_tokens", "eos_token_id", "tenant",
                 "priority", "ttl_steps", "deadline", "generated",
                 "adapter")
                if k in spec}

    def _migrate_running(self, rep):
        """Hot-swap/drain helper: move a DRAINING replica's admitted
        (prefill/decode) requests to the rest of the fleet so the
        weight flip sees empty slots. Queued requests HOLD on the
        replica through the flip (they carry no KV) — that is the
        'queue held at the block boundary' contract."""
        for ruid in list(self._assigned[rep.name]):
            self._salvage_one(rep, ruid, keep_queued=True)

    # -- disaggregated prefill/decode handoff --------------------------------
    def _handoff_sweep(self):
        """Migrate every first-token-ready request off the prefill
        workers onto decode workers (topology mode). Runs once per
        router step, AFTER the replica stepping loop, so handoffs
        always happen at an engine sync point (no in-flight block holds
        newer tokens than the host sees). A request whose handoff
        cannot land keeps decoding where it is and retries next step."""
        moved = False
        for rep in self._replicas:
            if rep.role != "prefill" or rep.state != ACTIVE or \
                    rep.breaker.state == "open":
                continue
            for ruid in list(self._assigned[rep.name]):
                rr = self._reqs[ruid]
                if rr.state == DECODE and rr.replica == rep.name:
                    moved |= self._handoff_kv(rep, ruid)
        return moved

    def _handoff_kv(self, rep, ruid):
        """One prefill->decode KV-page migration, exactly-once under a
        kill at ANY of its three fault points:

          kv.export  — fires before the source opens its ticket: the
            request is untouched, it keeps decoding on the prefill
            worker (retry next sweep).
          kv.import  — the target engine rolls the import back whole
            (pages freed, token not burned); the next target is tried,
            else the export is aborted and the request stays.
          handoff.commit — the source dies AFTER the target seated the
            copy: the ledger was repointed FIRST, so delivery comes
            from the target exactly once; the source's zombie copy is
            evicted and its ticket aborted, and the source is declared
            failed so its other requests salvage normally.

        Greedy continuations are byte-identical to a single-engine run
        in every branch: the landed copy decodes from the imported
        bytes, a fallen-back request continues from its own pages.

        TRANSPORT: each (source, target) pair negotiates the cheapest
        path (handoff.negotiate) — "device" keeps the pages on device
        end-to-end (same process), "store"
        rides the chunked StoreKVTransport between fleet workers (only
        a handle crosses the router), "host" is the CRC-stamped
        payload through this process (always works). Device-eligible
        targets are tried first; a device-path failure (the
        `transport.device` fault point) falls back LOUDLY to the
        host-bounce export. The transport that actually ran is tagged
        in the request's telemetry leg and counted in
        `handoff_transports`."""
        rr = self._reqs[ruid]
        euid = rr.engine_uid

        def has_room(t):
            h = t.headroom()           # O(1) — the routing snapshot
            return (h["running"] < h["slots_total"]
                    and h["pages_free"] > 0)

        # pre-filter saturated targets BEFORE paying the export: the
        # payload is a full host copy + CRC pass of every KV page, and
        # a slotless (or page-exhausted) target would only bounce it;
        # the import side re-checks the exact page need pre-CRC, so a
        # near-full pool costs a cheap refusal, not a checksum sweep
        targets = [t for t in self._routable(exclude=(rep.name,))
                   if t.role == "decode" and has_room(t)]
        if not targets:
            return False               # no decode capacity: stay put
        groups = {}
        for t in targets:
            groups.setdefault(self._transport_kind(rep, t),
                              []).append(t)
        landed = None
        faults_charged = False
        for kind in ("device", "store", "host"):
            tgts = groups.get(kind)
            if not tgts:
                continue
            try:
                payload = rep.export_kv(euid, kind)
            except Exception:
                # export fault (kv.export pre-ticket, the device
                # path's transport.device, a store send failure, or a
                # lost RPC reply AFTER the worker ticketed): the
                # request keeps serving on the source, but the ticket
                # may be open — settle it (a no-op when the fault
                # fired pre-ticket) or the orphaned token pins its
                # pages out of PrefixCache.evict forever. ANY
                # negotiated-path failure retries the same targets
                # over the host-bounce path — negotiation is an
                # optimization, never a new way to lose a handoff
                try:
                    rep.abort_handoff(euid)
                except Exception:
                    pass
                if self._retired_at_source(rep, ruid):
                    return False       # delivered: nothing to move
                self.handoff_failures += 1
                faults_charged = True
                if kind != "host":
                    groups.setdefault("host", []).extend(tgts)
                continue
            hard_failed = []
            for tgt in tgts:
                try:
                    new_euid = tgt.import_kv(payload)
                except (EngineBusyError, EngineFullError):
                    continue           # full target (slots or pages):
                    #                    backpressure, try the next
                except Exception:
                    # kv.import fault: the target engine already rolled
                    # its import back (pages freed, token reusable)
                    self.handoff_failures += 1
                    faults_charged = True
                    hard_failed.append(tgt)
                    continue
                landed = (tgt, new_euid, kind)
                break
            if landed is not None:
                break
            rep.abort_handoff(euid)    # this kind's export is settled
            #                            before the next kind exports
            if kind != "host" and hard_failed:
                # a HARD import failure on the negotiated path (not
                # backpressure — a full target stays full either way)
                # retries those targets over the host-bounce payload:
                # same fallback contract as the export side
                groups.setdefault("host", []).extend(hard_failed)
        if landed is None:
            # every export/import fault was already charged above; the
            # trailing count covers the all-backpressure exhaustion so
            # one logical failed handoff never bills twice
            if not faults_charged:
                self.handoff_failures += 1
            return False
        tgt, new_euid, kind = landed
        self.handoff_transports[kind] += 1
        # repoint the ledger BEFORE the source commit: if the source
        # dies at handoff.commit the request is already owned by the
        # target — the source's salvage loop skips it (assignment
        # check) and its zombie copy can never deliver
        self._assigned[rep.name].discard(ruid)
        rr.replica, rr.engine_uid = tgt.name, new_euid
        self._assigned[tgt.name].add(ruid)
        try:
            fault_point("handoff.commit",
                        detail=f"{rep.name}->{tgt.name} uid={ruid}")
            rep.release_handoff(euid)
        except Exception as e:
            # source died at commit: burn its zombie copy and declare
            # the worker failed (its OTHER requests re-queue); the
            # migrated request itself is safe on the target
            try:
                rep.abort_handoff(euid)
            except Exception:
                pass
            rep.evict(euid)
            self.handoff_failures += 1
            self._on_replica_failure(rep, e)
            self.kv_handoffs += 1
            return True
        self.kv_handoffs += 1
        if self._tel is not None:
            # handoff_ms itself is observed by the SOURCE engine's
            # telemetry (kv_export -> migrated pairing); the router
            # trace records the fleet-level leg — LOUDLY tagged with
            # the transport that actually moved the pages
            self._tel.req_event("router", ruid, "handoff",
                                from_replica=rep.name,
                                to_replica=tgt.name,
                                transport=kind)
        return True

    def _retired_at_source(self, rep, ruid):
        """True (and the request delivered) when an export was refused
        because the request retired at its source: an engine settles its
        in-flight chained block before an export, and that block may finish
        the request. Its replica then has no work left, so no step would
        collect it and every later sweep would retry a dead handoff."""
        try:
            st = rep.status(self._reqs[ruid].engine_uid)
        except Exception:
            return False
        if st not in (DONE, FAILED, "cancelled"):
            return False
        self._collect(rep)
        return True

    def _fail_stuck_head(self, rep, exc):
        """EngineFullError on an idle replica: the queue-head request
        can NEVER fit — fail that ONE request at the router (it would
        never fit any homogeneous replica either) and keep the replica
        serving."""
        euid = rep.queue_head_uid()
        ruid = next((u for u in self._assigned[rep.name]
                     if self._reqs[u].engine_uid == euid), None)
        if ruid is None:
            return
        self._assigned[rep.name].discard(ruid)
        rep.evict(euid)
        self._deliver(ruid, failure=RequestFailure(
            ruid, "capacity", exc, self.steps))

    # -- quarantine probes -------------------------------------------------
    def _probe(self, rep):
        """Bounded re-admission probe for an open breaker: heartbeat
        the replica (its OWN fault point, so chaos runs exercise probe
        failure too) and check it answers health sanely, under
        retry_with_backoff's seeded-jitter schedule. Success -> the
        breaker goes half-open (trial traffic); RetriesExhaustedError
        -> it reopens with a doubled backoff — and after
        REBUILD_AFTER_PROBES consecutive exhausted probe series the
        engine object itself is presumed wrecked and rebuilt from the
        factory (any still-assigned requests are salvaged first: a
        rebuild resets the engine's uid space, so their host state
        would otherwise be unreachable). Never raises."""
        self.probes += 1

        def attempt():
            fault_point("replica.heartbeat", detail=f"{rep.name}:probe")
            h = rep.health()
            if not isinstance(h, dict) or "pages_free" not in h:
                raise ReplicaFailedError(
                    f"replica {rep.name} probe returned a malformed "
                    f"health snapshot: {type(h).__name__}")
            return h

        try:
            retry_with_backoff(attempt, **self._probe_kw)
        except RetriesExhaustedError as e:
            rep.breaker.last_error = str(e)
            rep.breaker.record_probe_failure(self.steps)
            rep.failed_probes += 1
            if rep.failed_probes >= self.REBUILD_AFTER_PROBES:
                for ruid in list(self._assigned[rep.name]):
                    self._salvage_one(rep, ruid)
                try:
                    rep.rebuild()
                except Exception as re_exc:  # factory itself broken,
                    #                          or the respawn governor
                    #                          refused (backoff window /
                    #                          crash-loop cap): keep
                    #                          probing, breaker stays
                    #                          open
                    from .fleet import ReplicaCrashLoopError
                    if isinstance(re_exc, ReplicaCrashLoopError) and \
                            not getattr(rep, "_crash_looped", False):
                        # one crash-loop EPISODE counts once, however
                        # many later probes re-refuse
                        rep._crash_looped = True
                        self.crash_loops += 1
                        if self._tel is not None:
                            self._tel.event("crash_loop",
                                            replica=rep.name)
                    rep.breaker.last_error = (
                        f"rebuild failed: {type(re_exc).__name__}: "
                        f"{re_exc}")
                else:
                    rep.failed_probes = 0
            return False
        rep.failed_probes = 0
        rep.breaker.record_probe_success()
        rep._crash_looped = False       # clean probe ends the episode
        if hasattr(rep, "note_recovery"):
            rep.note_recovery()         # reset the respawn governor
        self._drain_adapter_pending(rep)
        return True

    def _drain_adapter_pending(self, rep):
        """Apply adapter registry writes that landed while `rep` was
        quarantined (the probe just proved it answers): loads replay
        from the registry, evicts retire the stale fine-tune. A
        failure keeps the op pending for the next probe (a busy
        adapter refuses evicts until its requests retire)."""
        for name, op in list(rep.adapters_pending.items()):
            try:
                if op == "load":
                    rep.load_adapter(name, rep.adapters[name])
                else:
                    rep.evict_adapter(name)
                rep.adapters_pending.pop(name, None)
            except AdapterError as e:
                from .adapters import UnknownAdapterError
                if op == "evict" and isinstance(e, UnknownAdapterError):
                    # the replica never held it (its load was itself
                    # deferred, or a respawn dropped it): the desired
                    # end state — adapter absent — already holds
                    rep.adapters_pending.pop(name, None)
            except Exception:
                pass
