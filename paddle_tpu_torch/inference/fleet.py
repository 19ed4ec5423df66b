"""Process-backed replica fleet: one EngineRouter over many processes.

Counterpart of `paddle_tpu/inference/fleet.py`. Each worker process owns one
ContinuousBatchingEngine (on its own CUDA context, or on the CPU when its
spec asks for it) and serves the `EngineReplica` method surface over the
framed RPC socket of `distributed/rpc.py` (4-byte big-endian length +
pickle); workers rendezvous through a `distributed/store.py` TCPStore.

Pieces:

  - `EngineHost` -- the WORKER side: one engine behind the RPC socket.
    Rendezvous through the store: the worker publishes `{ns}/{name}/addr`
    (ip, port, pid, incarnation, backend = the engine's torch device type)
    and re-publishes on respawn. Typed scheduler errors are pickled whole
    and re-raised on the client. Every `step()` also persists the worker's
    in-flight resume LEDGER (`{ns}/{name}/ledger`, deadlines shipped as a
    RELATIVE budget) so a kill -9'd worker's requests salvage from the
    store instead of recomputing from the original prompt. Every answer is
    a host value (numpy arrays, Python scalars): nothing on the CUDA
    device crosses the wire.
  - `ProcessReplica` -- the ROUTER side: a drop-in `EngineReplica` whose
    methods are RPCs. A dead worker process IS the router's
    `replica.step` failure path: the call raises `FleetRPCError`, the
    failover salvages via `export_resume` (answered from the store ledger
    when the worker is unreachable). `rebuild()` respawns the worker when
    a respawner is wired, so the router's quarantine-probe rebuild works
    across processes; `RespawnGovernor` backs it off and caps it.
  - `spawn_fleet` -- spawns N workers via `distributed/spawn.py` (the
    `spawn` start method: a forked child cannot use CUDA), waits for
    rendezvous, wires the fleet-default `StorePrefixIndex`, and returns a
    `FleetHandle` whose ProcessReplicas go to `EngineRouter(backends=...)`.
  - `python -m paddle_tpu_torch.inference.fleet --worker` -- one
    standalone worker (multi-host fleets: one per host, all pointing at
    the master store).

Two workers never share a runtime: a worker's transport endpoint names its
own incarnation, so a KV handoff between workers negotiates "store" (the
chunked StoreKVTransport; only a handle crosses the router) and never
"device". The port's one addition to the wire surface is the read-only
`EngineHost.rpc_kernel_launches`.

`spawn_fleet(traffic_target=)` sizes the fleet through the cost model
(`cost_model.size_fleet`) and keeps the sizing record on `FleetHandle.plan`;
a `cost_model.EngineSpec` (the planner's output) lowers to its spec dict
through `.fleet_spec()` wherever a spec dict is taken.

Fault points: `rpc.call` (client side of every RPC), `fleet.heartbeat`
(worker liveness reads), with the reference's detail strings.

Numerics: the fleet never changes tokens. Greedy outputs through a
2-process fleet equal the single-process router's, under kill -9 too.
"""
import importlib
import os
import pickle
import random
import socket
import threading
import time
import uuid

import numpy as np

from ..distributed.rpc import recv_msg, send_msg
from ..failsafe import fault_point
from .scheduler import QUEUED, SchedulerError, UnknownRequestError

ACTIVE = "active"                       # router.ACTIVE redefined: the
#                                         router imports fleet (lazily,
#                                         inside functions), so fleet
#                                         must never import router at
#                                         module level -- that would
#                                         close the cycle

class FleetRPCError(SchedulerError):
    """A fleet RPC failed at the TRANSPORT level (connect refused,
    peer closed, deadline) — the signal the router treats as a replica
    failure.  Application errors re-raise TYPED (the worker pickles
    the exception object itself)."""


class ReplicaCrashLoopError(SchedulerError):
    """A worker hit its respawn circuit-breaker cap: every respawn
    died again before a clean probe.  The replica stays quarantined
    (breaker open, never half-opens into a rebuild) until an operator
    — or the autoscale controller — replaces it; the router counts
    these in metrics() as `router.crash_loops`."""


class RespawnGovernor:
    """Backoff + circuit breaker for `ProcessReplica.rebuild()`.

    Quarantine probes fire on the router's schedule, not the crash's:
    a worker that dies on boot would otherwise be respawned in a tight
    loop (fork, crash, probe, fork ...).  The governor makes each
    successive respawn wait exponentially longer (with jitter, so a
    fleet of crashed workers doesn't thundering-herd the host) and
    refuses outright after `cap` attempts without an intervening clean
    probe.  A refusal inside the backoff window raises FleetRPCError —
    the probe records an ordinary failure and the router's own breaker
    backoff keeps the replica parked; past the cap it raises the typed
    ReplicaCrashLoopError.

    time_fn is injectable so tests pin the window without sleeping.
    """

    def __init__(self, cap=5, base_delay=0.25, max_delay=30.0,
                 jitter=0.5, seed=None, time_fn=None):
        self.cap = int(cap)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.jitter = float(jitter)
        self._rng = random.Random(seed)
        self._time = time_fn or time.monotonic
        self.attempts = 0               # respawns since last recovery
        self.not_before = 0.0           # earliest next admit (time_fn)

    def admit(self, name="worker"):
        """Gate one respawn attempt; on admission, start the next
        backoff window."""
        if self.attempts >= self.cap:
            raise ReplicaCrashLoopError(
                f"worker {name!r} hit the respawn cap "
                f"({self.attempts}/{self.cap}) without a clean probe "
                "— crash loop; replace the worker")
        now = self._time()
        if now < self.not_before:
            raise FleetRPCError(
                f"worker {name!r} respawn refused for another "
                f"{self.not_before - now:.2f}s (backoff after attempt "
                f"{self.attempts}/{self.cap})")
        self.attempts += 1
        delay = min(self.max_delay,
                    self.base_delay * (2 ** (self.attempts - 1)))
        delay *= 1.0 + self.jitter * self._rng.random()
        self.not_before = now + delay
        return self

    def recovered(self):
        """A clean probe after a respawn closes the breaker."""
        self.attempts = 0
        self.not_before = 0.0


class _RemoteTraceback(Exception):
    """Carrier for a worker-side traceback, chained as __cause__ under
    the re-raised typed exception."""

    def __str__(self):
        return "\n" + (self.args[0] if self.args else "")


def _ship_spec(spec):
    """Prepare a resume spec for the wire: absolute monotonic deadlines
    do not survive a process boundary (each host has its own clock), so
    ship the REMAINING budget and let the receiver rebase — the
    relative-budget rule of the KV handoff, applied to every spec that
    crosses the RPC plane (submit, export_resume, the store ledger)."""
    spec = dict(spec)
    if spec.get("deadline") is not None:
        spec["deadline_remaining_ms"] = max(
            0.0, (spec["deadline"] - time.monotonic()) * 1e3)
    spec["deadline"] = None
    return spec


def _land_spec(spec):
    """Rebase a wire spec's relative deadline budget onto THIS
    process's monotonic clock."""
    spec = dict(spec)
    rem = spec.pop("deadline_remaining_ms", None)
    if rem is not None:
        spec["deadline"] = time.monotonic() + float(rem) / 1e3
    return spec


def build_engine_from_spec(spec):
    """Build a ContinuousBatchingEngine from a plain (JSON/pickle-able)
    spec dict -- the worker-process factory that needs no code shipped:

      {"model": {"preset": "tiny", "seed": 0, <LlamaConfig overrides>},
       "engine": {<ContinuousBatchingEngine kwargs>}}

    The seed draws the weights (`LlamaForCausalLM(cfg, device=, seed=)`),
    so every process builds the same parameters on the same device type
    (the fleet identity contract needs every replica to hold the same
    weights, and there is no shared memory to alias). The engine kwargs
    may carry `device`; CUDA is the default, and the model is drawn there
    too. The model itself is dropped once the engine holds its snapshot,
    and the CUDA caching allocator's reserve is released, so a worker
    keeps only the engine's weights and pools on the card.

    Also accepts a `cost_model.EngineSpec` directly (the planner's
    output): it lowers to exactly this dict via .fleet_spec(), so a
    searched spec and a hand-written dict with the same fields build the
    same engine through ONE construction path.
    """
    if hasattr(spec, "fleet_spec"):   # cost_model.EngineSpec
        spec = spec.fleet_spec()
    import torch
    from .. import resolve_device
    from ..models.llama import LlamaConfig, LlamaForCausalLM
    from .scheduler import ContinuousBatchingEngine
    model_spec = dict(spec.get("model") or {})
    engine_kw = dict(spec.get("engine") or {})
    seed = int(model_spec.pop("seed", 0))
    preset = model_spec.pop("preset", "tiny")
    if preset == "tiny":
        cfg = LlamaConfig.tiny(**model_spec)
    elif preset == "config":
        cfg = LlamaConfig(**model_spec)
    else:
        raise ValueError(f"unknown model preset {preset!r}")
    dev = engine_kw.get("device")
    if isinstance(dev, (list, tuple)):  # tp: one device per shard
        dev = dev[0] if dev else None
    dev = resolve_device(dev)
    model = LlamaForCausalLM(cfg, device=dev, seed=seed)
    engine = ContinuousBatchingEngine(model, **engine_kw)
    del model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return engine


def resolve_factory(factory):
    """Engine factory from any of the worker-config forms: a spec dict
    (build_engine_from_spec), a `cost_model.EngineSpec`, a
    "module:function" import path, or a picklable zero-arg callable."""
    if hasattr(factory, "fleet_spec"):   # cost_model.EngineSpec
        factory = factory.fleet_spec()
    if isinstance(factory, dict):
        return lambda: build_engine_from_spec(factory)
    if isinstance(factory, str):
        mod, _, fn = factory.partition(":")
        if not fn:
            raise ValueError(
                f"factory path {factory!r} must be 'module:function'")
        return getattr(importlib.import_module(mod), fn)
    if callable(factory):
        return factory
    raise TypeError(f"cannot resolve an engine factory from "
                    f"{type(factory).__name__}")


class EngineHost:
    """Worker-side server: ONE engine behind the framed RPC socket.

    The dispatch table is exactly the `EngineReplica` surface plus the
    fleet-plane extras (telemetry_state, ledger, store-keyed KV
    transfer, staged weights).  All engine access is serialized under
    one lock — the engine is single-threaded by design, and the router
    drives replicas sequentially anyway.

    store: TCPStore client (rendezvous + ledger + KV transfer).
    namespace: store key prefix (several fleets can share one store).
    ledger_every: persist the in-flight resume ledger every N engine
      steps (the ledger is what a router salvages from after a
      kill -9, so a smaller interval trades store traffic for salvage
      freshness — each write re-ships every live request's full
      folded prompt, so 1 = every step makes the store round trip a
      per-step cost that grows with conversation length; tokens after
      the last write recompute byte-identically either way, so the
      default 8 only bounds recompute, never correctness).
    """

    def __init__(self, engine, name, store, namespace="fleet",
                 ledger_every=8, bind_ip=None):
        self.engine = engine
        self.name = name
        self.store = store
        self.ns = namespace
        self.ledger_every = max(1, int(ledger_every))
        self.incarnation = uuid.uuid4().hex[:12]
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._conns = set()
        self._kv_keys = {}              # uid -> store transfer key
        self._staged = {}               # token -> staged weight tree
        self._steps_since_ledger = 0
        self._kv_transport = None
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        # same trust posture as distributed/rpc: pickle protocol, keep
        # it on loopback unless the launcher provides the pod interface
        self._srv.bind((bind_ip or os.getenv("PADDLE_RPC_BIND_IP",
                                             "127.0.0.1"), 0))
        self._srv.listen(64)
        self.ip, self.port = self._srv.getsockname()
        self._thread = None
        self._register()
        self._write_ledger()            # an empty ledger beats a stale
        #                                 predecessor's after a respawn

    # -- rendezvous ----------------------------------------------------------
    def _register(self):
        self.backend = self.engine.device.type
        self.store.set(f"{self.ns}/{self.name}/addr", pickle.dumps({
            "ip": self.ip, "port": self.port, "pid": os.getpid(),
            "incarnation": self.incarnation, "backend": self.backend,
        }))

    # -- serve loop ----------------------------------------------------------
    def start(self):
        """Serve on a background thread (the in-process worker tests
        and serve_llama's --fleet-worker use this; the spawned process
        entry calls serve_forever)."""
        self._thread = threading.Thread(target=self.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def serve_forever(self):
        self._srv.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            self._conns.add(conn)
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()

    def _handle(self, conn):
        try:
            with conn:
                while not self._stop.is_set():
                    method, args, kwargs = recv_msg(conn)
                    try:
                        fn = getattr(self, f"rpc_{method}", None)
                        if fn is None:
                            raise AttributeError(
                                f"fleet worker has no method {method!r}")
                        with self._lock:
                            result = fn(*args, **(kwargs or {}))
                        reply = (True, result)
                    except BaseException as e:  # noqa: BLE001 — shipped
                        import traceback
                        reply = (False, self._picklable(e),
                                 traceback.format_exc())
                    try:
                        send_msg(conn, reply)
                    except Exception:
                        # the reply itself didn't pickle (exotic result):
                        # degrade to a typed error, never a torn stream
                        send_msg(conn, (False, FleetRPCError(
                            f"worker {self.name}: reply to {method!r} "
                            "was not picklable"), ""))
        except (ConnectionError, OSError, EOFError):
            pass
        finally:
            self._conns.discard(conn)

    @staticmethod
    def _picklable(exc):
        try:
            pickle.loads(pickle.dumps(exc))
            return exc
        except Exception:
            return SchedulerError(f"{type(exc).__name__}: {exc}")

    def stop(self):
        """Graceful stop: close the server and every connection."""
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        self.kill_connections()
        if self._thread is not None:
            self._thread.join(timeout=2)

    def kill_connections(self):
        """Abrupt close of every live connection WITHOUT replies — the
        in-process stand-in for kill -9 (tests; a real kill is the real
        thing)."""
        for conn in list(self._conns):
            try:
                conn.close()
            except OSError:
                pass

    # -- ledger --------------------------------------------------------------
    def _write_ledger(self):
        """Persist the in-flight resume ledger: {engine_uid: spec} with
        deadlines as REMAINING budget.  This is the state a router
        salvages from when this process is unreachable — tokens
        generated after the last write are recomputed (byte-identical
        by the prompt fold), never lost and never delivered twice."""
        specs = {}
        for spec in self.engine.export_inflight():
            specs[spec["uid"]] = _ship_spec(spec)
        try:
            self.store.set(f"{self.ns}/{self.name}/ledger",
                           pickle.dumps(specs))
        except Exception:
            pass                        # advisory: salvage falls back
        #                                 to the router's own spec copy
        self._steps_since_ledger = 0

    # -- EngineReplica surface (rpc_*) ---------------------------------------
    def rpc_ping(self):
        return {"pid": os.getpid(), "incarnation": self.incarnation,
                "steps": self.engine.steps}

    def rpc_endpoint(self):
        """Transport-negotiation endpoint (inference/handoff.py
        `negotiate`): `proc` is this HOST's incarnation token -- never
        equal to another process's (or the router's), so device-domain
        negotiation can only pair replicas that truly share a process
        (two workers negotiate "store", never "device"); `store` names
        the rendezvous all this fleet's workers
        share, enabling the chunked StoreKVTransport path."""
        return {"proc": f"host:{self.incarnation}",
                "backend": self.backend,
                "store": (self.store.host, self.store.port, self.ns)}

    def rpc_submit(self, spec):
        uid = self.engine.submit_resume(_land_spec(spec))
        self._write_ledger()
        return uid

    def rpc_step(self):
        moved = self.engine.step()
        self._steps_since_ledger += 1
        if self._steps_since_ledger >= self.ledger_every:
            self._write_ledger()
        return moved

    def rpc_health(self):
        return self.engine.health()

    def rpc_headroom(self):
        return self.engine.headroom()

    def rpc_has_work(self):
        h = self.engine.headroom()
        return bool(h["queued"] or h["running"] or h.get("demoted"))

    def rpc_status(self, uid):
        return self.engine.status(uid)

    def rpc_result(self, uid):
        return np.asarray(self.engine.result(uid))

    def rpc_kernel_launches(self):
        """This worker's `paddle_tpu_torch.ops.kernel_launches()` (launch
        counts since the worker started or last reset them). Read-only,
        and the port's only addition to the wire surface: it changes
        nothing the engine computes; a router reads it to see that every
        worker process really went through its kernels."""
        from ..ops import kernel_launches
        return {k: int(v) for k, v in kernel_launches().items()}

    def rpc_failure(self, uid):
        return self.engine.failures().get(uid)

    def rpc_export_resume(self, uid):
        return _ship_spec(self.engine.export_request(uid))

    def rpc_evict(self, uid):
        try:
            self.engine.cancel(uid)
        except UnknownRequestError:
            pass
        self._write_ledger()
        return None

    def rpc_queue_head_uid(self):
        return self.engine.queue_head_uid()

    def rpc_page_size(self):
        return self.engine.page_size

    def rpc_alloc_stats(self):
        """Leak-accounting snapshot (tests assert zero page leak PER
        WORKER — the pool lives here, not at the router)."""
        eng = self.engine
        return {"available": eng.allocator.available,
                "n_pages": eng.allocator.n_pages,
                "prefix_pages": (0 if eng._prefix is None
                                 else len(eng._prefix))}

    # -- KV handoff ----------------------------------------------------------
    def _transport(self):
        if self._kv_transport is None:
            from .handoff import StoreKVTransport
            self._kv_transport = StoreKVTransport(
                self.store, prefix=f"{self.ns}/kvxfer")
        return self._kv_transport

    def rpc_export_kv(self, uid):
        # export_kv_pages already ships the deadline as a REMAINING
        # budget inside the payload spec
        return self.engine.export_kv_pages(uid)

    def rpc_export_kv_store(self, uid):
        """Store-transport export: the payload rides the TCPStore as
        chunked keys (handoff.StoreKVTransport) and only a HANDLE
        crosses the RPC plane — the router never holds the KV bytes."""
        payload = self.engine.export_kv_pages(uid, transport="store")
        try:
            key = self._transport().send(payload)
        except Exception:
            self.engine.abort_handoff(uid)
            raise
        self._kv_keys[uid] = key
        return {"store_key": key, "token": payload["token"],
                "geometry": payload["geometry"]}

    def rpc_import_kv(self, payload):
        uid = self.engine.import_kv_pages(payload)
        self._write_ledger()
        return uid

    def rpc_import_kv_store(self, handle, timeout_ms=30000):
        payload = self._transport().recv(handle["store_key"],
                                         timeout_ms=timeout_ms)
        uid = self.engine.import_kv_pages(payload)
        self._write_ledger()
        try:                            # bytes are consumed; the source
            self._transport().delete(handle["store_key"])
        except Exception:               # release also deletes (no-op)
            pass
        return uid

    def rpc_release_handoff(self, uid):
        out = self.engine.release_handoff(uid)
        key = self._kv_keys.pop(uid, None)
        if key is not None:
            try:
                self._transport().delete(key)
            except Exception:
                pass
        self._write_ledger()
        return out

    def rpc_abort_handoff(self, uid):
        self.engine.abort_handoff(uid)
        key = self._kv_keys.pop(uid, None)
        if key is not None:
            try:
                self._transport().delete(key)
            except Exception:
                pass
        return None

    # -- prefix shipping ------------------------------------------------------
    def rpc_export_prefix(self, ids):
        return self.engine.export_prefix_pages(ids)

    def rpc_import_prefix(self, payload):
        return self.engine.import_prefix_pages(payload)

    def rpc_finish_prefix_export(self, token):
        return self.engine.finish_prefix_export(token)

    def rpc_abort_prefix_export(self, token):
        return self.engine.abort_prefix_export(token)

    def rpc_attach_prefix_index(self, host, port, prefix):
        """Wire this worker's engine into the fleet StorePrefixIndex —
        the worker opens its OWN store connection (a ctypes client
        cannot ride a pickle)."""
        from .prefix_index import StorePrefixIndex
        index = StorePrefixIndex.connect(host, port, prefix=prefix)
        self.engine.attach_prefix_index(index, self.name)
        return None

    # -- multi-LoRA adapters ---------------------------------------------------
    def rpc_load_adapter(self, name, path):
        return self.engine.load_adapter(name, path)

    def rpc_evict_adapter(self, name):
        return self.engine.evict_adapter(name)

    def rpc_pin_adapter(self, name, pinned=True):
        return self.engine.pin_adapter(name, pinned=pinned)

    # -- weights --------------------------------------------------------------
    def rpc_export_weights(self):
        """The engine's weight tree as host numpy arrays (a bf16 tensor as
        numpy's bfloat16 layout, descr '<V2', as the snapshot files hold
        it): nothing on the device crosses the wire."""
        from ..distributed.checkpoint import (_flatten, _to_host,
                                              _unflatten)
        leaves, treedef = _flatten(self.engine.export_weights())
        host = []
        for leaf in leaves:
            arr, bf16 = _to_host(leaf)
            host.append(arr.view("<V2") if bf16 else arr)
        return _unflatten(treedef, host)

    def rpc_load_weights_snapshot(self, path):
        """Load + verify the snapshot WORKER-side and stage it under a
        token — install_weights takes the handle, so the weight bytes
        never round-trip through the router."""
        new = self.engine.load_weights_snapshot(path)
        token = uuid.uuid4().hex[:12]
        self._staged[token] = new
        return {"__staged_weights__": token}

    def rpc_save_weights_snapshot(self, path, step=None):
        return self.engine.save_weights_snapshot(path, step=step)

    def rpc_install_weights(self, new):
        if isinstance(new, dict) and "__staged_weights__" in new:
            new = self._staged.pop(new["__staged_weights__"])
        else:
            # a host tree (another worker's rpc_export_weights): placed
            # like this engine's own leaves, dtype and device
            from ..distributed.checkpoint import (_flatten, _place,
                                                  tree_structure,
                                                  _unflatten)
            like, treedef = _flatten(self.engine.export_weights())
            if tree_structure(new) != treedef:
                raise ValueError(
                    "install_weights: tree structure does not match this "
                    "engine's weights")
            new = _unflatten(treedef, [_place(a, t) for a, t in
                                       zip(_flatten(new)[0], like)])
        self.engine.install_weights(new)
        return None

    # -- telemetry -------------------------------------------------------------
    def rpc_attach_telemetry(self, src, capture_faults=True):
        from .telemetry import Telemetry
        self.engine.attach_telemetry(
            Telemetry(name=src, capture_faults=capture_faults), src=src)
        return None

    def rpc_telemetry_state(self, full=False):
        """One pull of the worker's telemetry: registry state
        (histograms merge router-side into the fleet view) and a
        health snapshot so the router's rate sampling rides the same
        round trip; full=True adds the trace plane (done/live traces,
        gevents, log) for the fleet chrome-trace export — metrics
        pulls skip it (a scrape only reads the registry, and the
        trace payload dwarfs it)."""
        tel = self.engine.telemetry
        if tel is None:
            return None
        state = tel.state(full=full)
        state["incarnation"] = self.incarnation
        state["health"] = self.engine.health()
        return state

    def rpc_shutdown(self):
        # reply first, then stop (the client gets a clean ack)
        threading.Thread(target=self.stop, daemon=True).start()
        return True


class ProcessReplica:
    """Drop-in `EngineReplica` whose engine lives in another process.

    The router runs UNCHANGED over these: routing, failover salvage,
    circuit breakers, hot-swap, prefix routing, disagg topology, and
    the metrics()/prometheus() fleet merge all go through the same
    method surface — here each method is one framed RPC.  Transport
    failures raise FleetRPCError, which IS the replica-failure signal
    the router already handles; `status`/`export_resume` fall back to
    the worker's store-persisted ledger so a kill -9'd worker's
    in-flight requests salvage with their committed tokens instead of
    recomputing from the original prompt.

    respawn: zero-arg callable that re-launches the worker process
      (spawn_fleet wires one) — makes the router's quarantine-probe
      `rebuild()` path work across processes.
    call_timeout: per-RPC deadline in seconds (socket timeout). A hung
      worker surfaces as FleetRPCError — the heartbeat-timeout replica
      failure.  Generous by default: a cold worker's first step pays
      its jit compiles.
    """

    def __init__(self, name, store, namespace="fleet", role="any",
                 respawn=None, call_timeout=300.0,
                 connect_timeout_ms=60000, governor=None):
        self.name = name
        self.store = store
        self.ns = namespace
        self.role = role
        self.state = ACTIVE
        self.breaker = None             # installed by the router
        self.kills = 0
        self.swaps = 0
        self.failed_probes = 0
        self.telemetry = None
        self.respawn = respawn
        self.governor = (governor if governor is not None
                         else RespawnGovernor())
        self.respawns = 0               # rebuild()s actually admitted
        self.call_timeout = float(call_timeout)
        self.connect_timeout_ms = int(connect_timeout_ms)
        self.rpc_errors = 0             # transport-level call failures
        self.adapters = {}              # name -> path registry (LoRA;
        #                                 replayed into a respawned
        #                                 worker by rebuild())
        self.adapters_pending = {}      # name -> "load"|"evict": ops
        #                                 deferred while quarantined,
        #                                 drained at the next clean
        #                                 probe (router._drain_
        #                                 adapter_pending)
        self._prefix_index = None
        self._sock = None
        self._sock_lock = threading.Lock()
        self._addr = None               # last resolved rendezvous entry
        self._endpoint = None           # cached transport endpoint
        self._page_size = None

    # -- wire ---------------------------------------------------------------
    def _resolve(self, wait=True):
        raw = self.store.get(f"{self.ns}/{self.name}/addr", wait=wait,
                             timeout_ms=self.connect_timeout_ms)
        self._addr = pickle.loads(bytes(raw))
        return self._addr

    def _connect(self):
        addr = self._resolve()
        sock = socket.create_connection((addr["ip"], addr["port"]),
                                        timeout=self.call_timeout)
        return sock

    def _call(self, method, *args, **kwargs):
        fault_point("rpc.call", detail=f"{self.name}:{method}")
        with self._sock_lock:
            try:
                if self._sock is None:
                    self._sock = self._connect()
                self._sock.settimeout(self.call_timeout)
                send_msg(self._sock, (method, args, kwargs))
                reply = recv_msg(self._sock)
            except (ConnectionError, OSError, EOFError, TimeoutError,
                    pickle.UnpicklingError) as e:
                if self._sock is not None:
                    try:
                        self._sock.close()
                    except OSError:
                        pass
                    self._sock = None
                self.rpc_errors += 1
                raise FleetRPCError(
                    f"rpc {method!r} to worker {self.name!r} failed: "
                    f"{type(e).__name__}: {e}") from e
        ok, *rest = reply
        if ok:
            return rest[0]
        exc, tb = rest if len(rest) == 2 else (rest[0], "")
        if tb:
            exc.__cause__ = _RemoteTraceback(tb)
        raise exc

    def _ledger(self):
        """The worker's store-persisted resume ledger ({engine_uid:
        wire spec}) — the salvage source when the process itself is
        gone.  None when unreadable."""
        try:
            raw = self.store.get(f"{self.ns}/{self.name}/ledger",
                                 wait=False)
            return pickle.loads(bytes(raw))
        except Exception:
            return None

    # -- traffic -------------------------------------------------------------
    def submit(self, spec):
        return self._call("submit", _ship_spec(spec))

    def step(self):
        fault_point("fleet.heartbeat", detail=self.name)
        return self._call("step")

    def health(self):
        return self._call("health")

    def headroom(self):
        fault_point("fleet.heartbeat", detail=self.name)
        return self._call("headroom")

    def has_work(self):
        # NEVER raises: the router polls has_work outside its failure
        # handling — an unreachable worker reports True so the next
        # step() surfaces the failure through the salvage path instead
        # of silently stranding its requests
        try:
            return self._call("has_work")
        except Exception:
            return True

    # -- per-request state ----------------------------------------------------
    def status(self, uid):
        """Worker state for an engine uid; when the process is
        UNREACHABLE, answer from the store ledger (a live state keeps
        the salvage path moving), else report QUEUED — the router's
        next step() on this replica raises inside its failure handling
        and failover resolves the request for real."""
        try:
            return self._call("status", uid)
        except FleetRPCError:
            led = self._ledger()
            if led is not None and uid in led:
                return led[uid].get("state", QUEUED)
            return QUEUED

    def result(self, uid):
        return self._call("result", uid)

    def failure(self, uid):
        return self._call("failure", uid)

    def export_resume(self, uid):
        """Resume spec for a worker request — from the live worker when
        reachable, else the store-persisted ledger (tokens committed
        after the last ledger write are recomputed, byte-identically,
        by the prompt fold).  Deadlines arrive as REMAINING budget and
        are rebased onto THIS process's clock."""
        try:
            return _land_spec(self._call("export_resume", uid))
        except FleetRPCError:
            led = self._ledger()
            if led is None or uid not in led:
                raise
            return _land_spec(led[uid])

    def evict(self, uid):
        try:
            self._call("evict", uid)
        except (FleetRPCError, UnknownRequestError):
            pass                        # dead worker: nothing to evict
        return None

    def queue_head_uid(self):
        return self._call("queue_head_uid")

    # -- telemetry -------------------------------------------------------------
    def attach_telemetry(self, tel):
        """The worker gets its OWN Telemetry (engine observations must
        not cross a process per event); the router keeps this MIRROR,
        refreshed by metrics_registry() pulls — histogram counts
        survive worker death and respawn because dead incarnations fold
        into the mirror's base registry."""
        from .telemetry import ReplicaTelemetryMirror
        name = getattr(tel, "name", None) or self.name
        self.telemetry = ReplicaTelemetryMirror(name)
        self._tel_capture_faults = (getattr(tel, "_fault_hook", None)
                                    is not None)
        self._call("attach_telemetry", name,
                   capture_faults=self._tel_capture_faults)

    def metrics_registry(self, sample=True, full=False):
        """Fetch the remote registry snapshot over RPC and materialize
        it into the local mirror; returns the mirror's registry (the
        object EngineRouter.metrics()/prometheus() merge).  On an
        unreachable worker the LAST KNOWN state answers — fleet p99s
        must not vanish with the process that produced them. Metrics
        pulls ship the registry only; full=True adds the trace plane
        (the chrome-trace export's sync_telemetry path)."""
        if self.telemetry is None:
            return None
        state = None
        try:
            state = self._call("telemetry_state", full=full)
        except Exception:
            pass
        if state is not None:
            self.telemetry.install_state(state)
            if sample:
                try:
                    self.telemetry.registry.sample(state["health"])
                except Exception:
                    pass
        return self.telemetry.registry

    def sync_telemetry(self):
        """Refresh the mirror's traces (the fleet chrome-trace export
        pulls these) without rate sampling."""
        self.metrics_registry(sample=False, full=True)

    # -- fleet prefix index ----------------------------------------------------
    def attach_prefix_index(self, index):
        ep = getattr(index, "endpoint", None)
        if ep is None:
            raise ValueError(
                "a process-backed fleet needs a StorePrefixIndex (the "
                "in-memory PrefixIndex cannot be shared across "
                "processes) — pass prefix_index=StorePrefixIndex(store)")
        self._prefix_index = index
        host, port, prefix = ep
        self._call("attach_prefix_index", host, port, prefix)

    def page_size(self):
        if self._page_size is None:
            self._page_size = self._call("page_size")
        return self._page_size

    def export_prefix(self, ids, device=False):
        # the device flag is a negotiation outcome that can never name
        # a cross-process pair; prefix ships to/from workers ride the
        # host path (CRC-stamped pickle through the router)
        return self._call("export_prefix", np.asarray(ids, np.int64))

    def import_prefix(self, payload):
        return self._call("import_prefix", payload)

    def finish_prefix_export(self, token):
        return self._call("finish_prefix_export", token)

    def abort_prefix_export(self, token):
        return self._call("abort_prefix_export", token)

    # -- KV handoff ------------------------------------------------------------
    def transport_endpoint(self):
        if self._endpoint is None:
            self._endpoint = self._call("endpoint")
        return self._endpoint

    def export_kv(self, uid, transport="host"):
        """KV-image export under the NEGOTIATED transport: "store"
        publishes the pages through the chunked StoreKVTransport and
        returns only a handle; "host" ships the CRC-stamped payload
        over the RPC plane (the mixed in-process/process fallback).
        "device" can never negotiate to a ProcessReplica (distinct
        processes do not share a device runtime)."""
        if transport == "store":
            return self._call("export_kv_store", uid)
        return self._call("export_kv", uid)

    def import_kv(self, payload):
        if isinstance(payload, dict) and "store_key" in payload:
            return self._call("import_kv_store", payload)
        if payload.get("transport") == "device":
            from .handoff import KVHandoffError
            raise KVHandoffError(
                "a device-transport payload cannot cross a process "
                "boundary (negotiation bug)")
        return self._call("import_kv", payload)

    def release_handoff(self, uid):
        return self._call("release_handoff", uid)

    def abort_handoff(self, uid):
        try:
            return self._call("abort_handoff", uid)
        except FleetRPCError:
            return None                 # dead worker: ticket died too

    # -- multi-LoRA adapters -----------------------------------------------------
    def load_adapter(self, name, path):
        """Registry write over RPC: the worker hot-loads the adapter
        from `path` (a path every host can read — the deploy contract,
        same as weight snapshots); recorded replica-side so rebuild()
        replays it into a respawned worker."""
        slot = self._call("load_adapter", name, str(path))
        self.adapters[name] = str(path)
        self.adapters_pending.pop(name, None)
        return slot

    def evict_adapter(self, name):
        """Worker first, registry second — a refused evict (live
        requests pin the adapter) keeps the rebuild-replay entry."""
        slot = self._call("evict_adapter", name)
        self.adapters.pop(name, None)
        self.adapters_pending.pop(name, None)
        return slot

    def pin_adapter(self, name, pinned=True):
        return self._call("pin_adapter", name, pinned=pinned)

    # -- weights ----------------------------------------------------------------
    def export_weights(self):
        return self._call("export_weights")

    def kernel_launches(self):
        """The worker's kernel launch counts (EngineHost.rpc_kernel_
        launches)."""
        return self._call("kernel_launches")

    def load_weights_snapshot(self, path):
        return self._call("load_weights_snapshot", str(path))

    def save_weights_snapshot(self, path, step=None):
        return self._call("save_weights_snapshot", str(path), step=step)

    def install_weights(self, new):
        self._call("install_weights", new)
        self.swaps += 1

    # -- lifecycle ---------------------------------------------------------------
    def extra_health(self):
        """Fleet-mode additions to the router's per-replica health
        entry (the in-process schema stays pinned as-is)."""
        return {"worker": {
            "pid": (self._addr or {}).get("pid"),
            "incarnation": (self._addr or {}).get("incarnation"),
            "rpc_errors": self.rpc_errors,
            "respawns": self.respawns,
            "respawn_attempts": (self.governor.attempts
                                 if self.governor else 0),
        }}

    def rebuild(self):
        """Respawn the worker process (the router's quarantine-probe
        last resort).  The old process — if somehow still alive — is
        orphaned behind a fresh rendezvous entry; telemetry history
        folds into the mirror's base so fleet histograms survive the
        incarnation change."""
        if self.respawn is None:
            raise RuntimeError(
                f"worker {self.name} is unreachable and no respawner "
                "is wired (spawn_fleet provides one)")
        if self.governor is not None:
            self.governor.admit(self.name)
        self.respawns += 1
        if self.telemetry is not None:
            self.telemetry.fold_incarnation()
        old = (self._addr or {}).get("incarnation")
        with self._sock_lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None
        self._endpoint = None
        self.respawn()
        deadline = time.monotonic() + self.connect_timeout_ms / 1e3
        while True:
            addr = self._resolve()
            if addr.get("incarnation") != old:
                break
            if time.monotonic() > deadline:
                raise FleetRPCError(
                    f"worker {self.name} respawn never re-registered")
            time.sleep(0.05)
        if self.telemetry is not None:
            # same capture_faults as the original attach — the worker
            # default (True) would double-record faults the router's
            # own hook already captures
            self._call("attach_telemetry", self.telemetry.name,
                       capture_faults=getattr(
                           self, "_tel_capture_faults", True))
        if self._prefix_index is not None:
            try:
                self._prefix_index.drop_replica(self.name)
            except Exception:
                pass
            host, port, prefix = self._prefix_index.endpoint
            self._call("attach_prefix_index", host, port, prefix)
        for name, path in self.adapters.items():
            try:
                self._call("load_adapter", name, path)
            except Exception:
                pass                    # registry kept; requests naming
                #                         it fail typed on this replica
        self.adapters_pending.clear()   # replay covered the loads; the
        #                                 respawned worker never held an
        #                                 evict-pending adapter
        return self

    def note_recovery(self):
        """Router hook: a clean quarantine probe resets the respawn
        governor so a later crash starts a fresh backoff ladder."""
        if self.governor is not None:
            self.governor.recovered()

    def shutdown(self):
        try:
            return self._call("shutdown")
        except FleetRPCError:
            return False


# -- spawning -----------------------------------------------------------------
def _worker_entry(cfg):
    """Spawned-process target (module-level: multiprocessing spawn
    pickles it by reference).  The rank env var distributed/spawn.py
    sets picks this worker's name."""
    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    name = cfg["names"][rank]
    from ..distributed.store import TCPStore
    store = TCPStore(cfg["store_host"], cfg["store_port"])
    engine = resolve_factory(cfg["factory"])()
    host = EngineHost(engine, name, store,
                      namespace=cfg.get("namespace", "fleet"),
                      ledger_every=cfg.get("ledger_every", 8))
    host.serve_forever()


def _make_respawner(cfg, procs, rank):
    """Zero-arg respawn closure for worker `rank`: re-launch via
    _respawn_wrap with the rank env var, track the process in `procs`
    so FleetHandle.shutdown() still reaps it."""
    def respawn():
        import multiprocessing
        ctx = multiprocessing.get_context("spawn")
        env = dict(os.environ, PADDLE_TRAINER_ID=str(rank),
                   PADDLE_TRAINERS_NUM=str(len(cfg["names"])))
        p = ctx.Process(target=_respawn_wrap, args=(cfg, env),
                        daemon=False)
        p.start()
        procs.append(p)
    return respawn


def _await_worker(rep, procs):
    """Block until `rep`'s worker has registered (as `rep._resolve()`
    does), but fail at once when one of the spawned `procs` exits first (a
    worker whose engine build crashed, say out of device memory) instead of
    waiting out `connect_timeout_ms`."""
    key = f"{rep.ns}/{rep.name}/addr"
    deadline = time.monotonic() + rep.connect_timeout_ms / 1e3
    while not rep.store.check([key]):
        dead = [p for p in procs if p.exitcode is not None]
        if dead:
            raise FleetRPCError(
                f"worker {rep.name!r}: a spawned worker process exited with "
                f"code {dead[0].exitcode} before the fleet registered")
        if time.monotonic() > deadline:
            break                       # _resolve raises the timeout
        time.sleep(0.1)
    return rep._resolve()


class FleetHandle:
    """What spawn_fleet returns: the ProcessReplicas (pass them to
    EngineRouter(backends=...)), the spawned processes, the rendezvous
    store, and the fleet-default StorePrefixIndex (None when prefix
    publication is off).  `plan` carries the cost-model sizing record
    when spawn_fleet sized the fleet from a traffic target."""

    def __init__(self, replicas, procs, store, prefix_index,
                 cfg=None, call_timeout=300.0,
                 connect_timeout_ms=120000, plan=None):
        self.replicas = replicas
        self.procs = procs
        self.store = store
        self.prefix_index = prefix_index
        self.plan = plan
        self._cfg = cfg
        self._call_timeout = call_timeout
        self._connect_timeout_ms = connect_timeout_ms

    def spawn_worker(self, role="any", name=None):
        """Scale-out: launch ONE more worker into this fleet and
        return its ProcessReplica (hand it to router.add_replica).
        The new worker rendezvouses through the same store; a worker
        that never registers is reaped before the error surfaces."""
        if self._cfg is None:
            raise RuntimeError(
                "this FleetHandle was not built by spawn_fleet — no "
                "worker config to launch from")
        rank = len(self._cfg["names"])
        name = name or f"{self._cfg.get('name_prefix', 'w')}{rank}"
        self._cfg["names"].append(name)
        _make_respawner(self._cfg, self.procs, rank)()
        p = self.procs[-1]
        rep = ProcessReplica(
            name, self.store,
            namespace=self._cfg.get("namespace", "fleet"), role=role,
            respawn=_make_respawner(self._cfg, self.procs, rank),
            call_timeout=self._call_timeout,
            connect_timeout_ms=self._connect_timeout_ms)
        try:
            _await_worker(rep, [p])     # block until the worker is up
        except BaseException:
            self._cfg["names"].pop()
            if p.is_alive():
                p.terminate()
            p.join(timeout=2.0)
            if p.is_alive():
                p.kill()
            raise
        self.replicas.append(rep)
        return rep

    def retire_worker(self, name, timeout=5.0):
        """Scale-in counterpart: shut the named worker down and drop
        it from the handle.  The router must have drained/retired the
        replica FIRST — this only reaps the process.  Its rank slot in
        the worker config stays (ranks are append-only), so later
        spawns never reuse a live name."""
        rep = next((r for r in self.replicas if r.name == name), None)
        if rep is None:
            return False
        alive_before = sum(p.is_alive() for p in self.procs)
        ok = rep.shutdown()
        self.replicas.remove(rep)
        if not ok:
            return True                 # worker already unreachable —
            #                             nothing to wait for
        deadline = time.monotonic() + timeout
        while (sum(p.is_alive() for p in self.procs) >= alive_before
               and alive_before and time.monotonic() < deadline):
            time.sleep(0.05)            # wait for ITS process to exit
        return True

    def shutdown(self, timeout=5.0):
        """Graceful worker shutdown, then escalate: join, terminate,
        kill.  Safe on already-dead workers."""
        for rep in self.replicas:
            rep.shutdown()
        deadline = time.monotonic() + timeout
        for p in self.procs:
            p.join(timeout=max(0.1, deadline - time.monotonic()))
            if p.is_alive():
                p.terminate()
                p.join(timeout=1.0)
            if p.is_alive():
                p.kill()
        return self


def spawn_fleet(factory, n=None, store=None, namespace="fleet",
                roles=None, name_prefix="w", ledger_every=8,
                prefix_index=True, call_timeout=300.0,
                connect_timeout_ms=120000, traffic_target=None):
    """Spawn an n-worker process fleet and return a FleetHandle.

    factory: an engine-spec dict (build_engine_from_spec -- the
      no-code-shipped form the CLI uses; `"device": "cpu"` in its engine
      kwargs runs the workers on the CPU), a "module:function" import
      path, or a picklable zero-arg callable.
    n: worker count; None asks the cost model to size the fleet from
      `traffic_target` (spec-dict factories only — sizing needs the
      model config).
    traffic_target: {"qps": float, "prompt_len": int, "gen_tokens":
      int, ...} forwarded to cost_model.size_fleet; the sizing record
      (predictions + headroom) lands on handle.plan, and the autoscale
      controller reuses the same pricing (autoscale.price_from_spec).
    store: an existing TCPStore MASTER client to rendezvous through;
      None creates one on an ephemeral loopback port.
    roles: per-worker roles for a disaggregated topology (e.g.
      ["prefill", "decode"]); default "any".
    prefix_index: True wires the fleet-default StorePrefixIndex over
      the rendezvous store (the natural multi-process backend — pass
      it to EngineRouter(prefix_index=handle.prefix_index)); False
      skips it.
    """
    from ..distributed.spawn import spawn
    from ..distributed.store import TCPStore
    plan = None
    if n is None:
        if traffic_target is None:
            raise ValueError("spawn_fleet needs n= or traffic_target=")
        if not isinstance(factory, dict):
            raise ValueError(
                "traffic_target sizing needs a spec-dict factory (the "
                "cost model prices from the model config; a callable "
                "factory hides it)")
        from ..cost_model import size_fleet
        n, plan = size_fleet(factory, **dict(traffic_target))
    if store is None:
        store = TCPStore("127.0.0.1", 0, is_master=True, world_size=1)
    names = [f"{name_prefix}{i}" for i in range(int(n))]
    cfg = {"names": names, "store_host": store.host,
           "store_port": store.port, "namespace": namespace,
           "factory": factory, "ledger_every": int(ledger_every),
           "name_prefix": name_prefix}
    procs = spawn(_worker_entry, args=(cfg,), nprocs=int(n), join=False)

    index = None
    if prefix_index:
        from .prefix_index import StorePrefixIndex
        index = StorePrefixIndex(store, prefix=f"{namespace}/pfxidx")
    replicas = []
    try:
        for i, name in enumerate(names):
            rep = ProcessReplica(
                name, store, namespace=namespace,
                role=(roles[i] if roles else "any"),
                respawn=_make_respawner(cfg, procs, i),
                call_timeout=call_timeout,
                connect_timeout_ms=connect_timeout_ms)
            _await_worker(rep, procs)   # block until the worker is up
            replicas.append(rep)
    except BaseException:
        # a worker that never rendezvoused (slow build past
        # connect_timeout_ms, or died before publishing its addr key)
        # must not leave N non-daemon children serving forever — no
        # FleetHandle exists yet, so nobody could ever shutdown() them
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=2.0)
            if p.is_alive():
                p.kill()
        raise
    return FleetHandle(replicas, procs, store, index, cfg=cfg,
                       call_timeout=call_timeout,
                       connect_timeout_ms=connect_timeout_ms,
                       plan=plan)


def _respawn_wrap(cfg, env):
    os.environ.update(env)
    _worker_entry(cfg)


# -- standalone worker CLI -----------------------------------------------------
def main(argv=None):
    """`python -m paddle_tpu_torch.inference.fleet --worker --name w0
    --store HOST:PORT [--spec-json '{...}']` — the multi-host entry:
    run one per host, all pointing at the master store, then build the
    router with ProcessReplica(name, store) per worker (serve_llama's
    --fleet does the single-host version of all of this)."""
    import argparse
    import json
    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--worker", action="store_true", required=True)
    ap.add_argument("--name", required=True)
    ap.add_argument("--store", required=True, metavar="HOST:PORT")
    ap.add_argument("--namespace", default="fleet")
    ap.add_argument("--ledger-every", type=int, default=8)
    ap.add_argument("--spec-json", default=None,
                    help="engine spec for build_engine_from_spec "
                         '(default: the tiny demo model, e.g. '
                         '\'{"model": {"preset": "tiny"}, "engine": '
                         '{"max_len": 64, "page_size": 16}}\')')
    ap.add_argument("--factory", default=None, metavar="MODULE:FN",
                    help="import-path engine factory (overrides "
                         "--spec-json)")
    ap.add_argument("--device", default=None,
                    help="the engine's device for a spec (cuda, the "
                         "default, or cpu); overrides the spec's own")
    args = ap.parse_args(argv)
    host_s, _, port_s = args.store.partition(":")
    from ..distributed.store import TCPStore
    store = TCPStore(host_s, int(port_s))
    factory = args.factory or json.loads(
        args.spec_json or '{"model": {"preset": "tiny"}, '
                          '"engine": {"max_len": 64, "page_size": 16, '
                          '"max_batch": 2}}')
    if args.device is not None and isinstance(factory, dict):
        factory.setdefault("engine", {})["device"] = args.device
    engine = resolve_factory(factory)()
    host = EngineHost(engine, args.name, store,
                      namespace=args.namespace,
                      ledger_every=args.ledger_every)
    print(f"fleet worker {args.name} serving on {host.ip}:{host.port} "
          f"(store {args.store}, ns {args.namespace})", flush=True)
    host.serve_forever()


if __name__ == "__main__":             # pragma: no cover - CLI entry
    main()
