"""SLO-driven elastic fleet: the controller that closes the telemetry ->
control loop over an `EngineRouter`.

Counterpart of `paddle_tpu/inference/autoscale.py`. `FleetController`
reads the router's windowed fleet percentiles (TTFT / TPOT / queue-wait
p99 over the sliding window) and acts on the router's elastic seams:

  - **Scale out/in against SLO targets.** A sustained breach spawns one
    worker per decision (`FleetHandle.spawn_worker` in fleet mode, the
    router's own factory in-process); sustained slack drains-then-retires
    the shallowest worker through `router.retire_replica` -- the salvage
    triage failover uses, so scale-down loses zero requests.
  - **Rebalances the prefill:decode split live**: a role flip is
    `router.set_replica_role`; the next handoff sweep migrates decode-state
    runners off a new prefill worker over the negotiated KV transport.
  - **Places adapters by affinity**: the hottest adapters (by the pools'
    per-adapter request counters) are pinned on a replica subset, and
    routing prefers the subset with a typed fallback.
  - **Degrades instead of oscillating**: hysteresis (breach / slack
    streaks), a post-action cooldown, the respawn circuit breaker
    (`fleet.RespawnGovernor`), and load-shedding as the last resort when
    the fleet is at max_replicas and still breached.

Control law: one `tick()` reads `router.metrics()["fleet"]["windows"]`,
updates the streaks and takes AT MOST ONE scaling action, then sits out
`cooldown_ticks` ticks. Every decision, the no-ops included, lands in a
bounded decision log with its wall-clock latency.

Fault points: `scale.spawn`, `scale.retire`, `scale.rebalance` -- each
fires BEFORE its action commits (a failed spawn leaves the fleet as it
was; a failed retire leaves the replica serving; a failed rebalance
leaves roles unchanged).

The cost-model price gate (`price=price_from_spec(spec)`) prices one more
replica through `cost_model.predict_serving` before paying for it;
`price=None` (the default) runs every other part of the loop. A router
nobody ticks serves exactly as one built without this module.
"""
import collections
import time

from ..failsafe import fault_point

__all__ = ["SLOTarget", "FleetController"]


class SLOTarget:
    """The targets one controller holds.  None disables a signal; the
    p99s are read from the WINDOWED histograms (last-N-seconds view),
    so the controller reacts to current load."""

    def __init__(self, ttft_p99_ms=None, tpot_p99_ms=None,
                 queue_wait_p99_ms=None):
        self.ttft_p99_ms = ttft_p99_ms
        self.tpot_p99_ms = tpot_p99_ms
        self.queue_wait_p99_ms = queue_wait_p99_ms
        if not any((ttft_p99_ms, tpot_p99_ms, queue_wait_p99_ms)):
            raise ValueError("an SLOTarget needs at least one target")

    def watched(self):
        return [(k, t) for k, t in (
            ("ttft_ms", self.ttft_p99_ms),
            ("tpot_ms", self.tpot_p99_ms),
            ("queue_wait_ms", self.queue_wait_p99_ms)) if t]

    def __repr__(self):
        return (f"SLOTarget(ttft={self.ttft_p99_ms}, "
                f"tpot={self.tpot_p99_ms}, "
                f"queue_wait={self.queue_wait_p99_ms})")


class FleetController:
    """EngineRouter-level autoscaling policy (module docstring).

    router: the live EngineRouter (telemetry= required — the windowed
      percentiles are the control signal).
    slo: SLOTarget.
    spawner: callable(role) -> replica backend for scale-out (wire
      `lambda role: handle.spawn_worker(role=role)` in fleet mode);
      None scales out through the router's own factory.
    retirer: callable(name) after a retire — reap the worker process
      (`handle.retire_worker` in fleet mode); None for in-process.
    min_replicas / max_replicas: fleet-size clamp.
    breach_ticks: consecutive breached ticks before scaling out
      (hysteresis — one bad scrape must not buy a worker).
    slack_ticks: consecutive slack ticks before scaling in (slack =
      every watched p99 under slack_frac x target AND nothing held).
    cooldown_ticks: ticks to sit out after ANY scaling action, so the
      new capacity shows up in the window before the next decision.
    shed_after_ticks: breached ticks AT max_replicas before the
      last-resort load shed switches on (it clears with the breach).
    min_window_count: observations a windowed histogram needs before
      its p99 is trusted (tiny samples make noisy percentiles).
    price: optional callable(n_replicas_after) -> dict with at least
      {"fits": bool} — a cost-model gate for scale-out (see
      `price_from_spec`).  When it reports fits=False the controller
      refuses to spawn and (at the cap rule) sheds instead.
    rebalance: enable the live prefill:decode rebalancer (topology
      mode only; auto-detected when None).
    affinity_adapters: keep the N hottest adapters pinned on
      affinity_replicas replicas each (0 disables).
    time_fn: injectable clock for the decision-latency stamps.
    """

    def __init__(self, router, slo, spawner=None, retirer=None,
                 min_replicas=1, max_replicas=4, breach_ticks=2,
                 slack_ticks=4, cooldown_ticks=3, slack_frac=0.5,
                 shed_after_ticks=3, min_window_count=4, price=None,
                 rebalance=None, affinity_adapters=0,
                 affinity_replicas=1, decision_log=64,
                 time_fn=time.monotonic):
        self.router = router
        self.slo = slo
        self.spawner = spawner
        self.retirer = retirer
        self.min_replicas = max(1, int(min_replicas))
        self.max_replicas = max(self.min_replicas, int(max_replicas))
        self.breach_ticks = max(1, int(breach_ticks))
        self.slack_ticks = max(1, int(slack_ticks))
        self.cooldown_ticks = max(0, int(cooldown_ticks))
        self.slack_frac = float(slack_frac)
        self.shed_after_ticks = max(1, int(shed_after_ticks))
        self.min_window_count = max(1, int(min_window_count))
        self.price = price
        self.rebalance = rebalance
        self.affinity_adapters = int(affinity_adapters)
        self.affinity_replicas = max(1, int(affinity_replicas))
        self._time = time_fn
        # control state
        self.ticks = 0
        self._breach_streak = 0
        self._slack_streak = 0
        self._cooldown = 0
        self._shed_streak = 0
        self._last_step = -1
        # outcome counters (bench + tests read these)
        self.scale_outs = 0
        self.scale_ins = 0
        self.rebalances = 0
        self.sheds = 0
        self.spawn_failures = 0
        self.decisions = collections.deque(maxlen=int(decision_log))

    # -- signal extraction ---------------------------------------------------
    def _read(self):
        """One scrape: (windows, health, metrics) — windows is the
        {hist_name: snapshot} current-load view the decisions run on."""
        m = self.router.metrics()
        fleet = m.get("fleet") or {}
        return fleet.get("windows") or {}, self.router.health(), m

    def _breach(self, windows):
        """Worst breached target, or None.  Only windows with enough
        observations vote — an empty window is evidence of idleness,
        not of a 0ms p99."""
        worst = None
        for key, target in self.slo.watched():
            snap = windows.get(key) or {}
            if snap.get("count", 0) < self.min_window_count:
                continue
            p99 = float(snap.get("p99_ms", 0.0))
            if p99 > target:
                ratio = p99 / target
                if worst is None or ratio > worst["ratio"]:
                    worst = {"signal": key, "p99_ms": p99,
                             "target_ms": target, "ratio": ratio}
        return worst

    def _slack(self, windows, health):
        """True when the fleet is demonstrably over-provisioned: every
        watched signal WITH data sits under slack_frac x target, the
        router holds nothing, and the queues are empty."""
        if health["held"] or health["pending"]:
            return False
        for key, target in self.slo.watched():
            snap = windows.get(key) or {}
            if snap.get("count", 0) < 1:
                continue
            if float(snap.get("p99_ms", 0.0)) > self.slack_frac * target:
                return False
        return True

    # -- the control tick ----------------------------------------------------
    def maybe_tick(self, every_steps=8):
        """Rate-limited tick keyed on router.steps — call it from the
        serving loop; it no-ops until the router has stepped
        `every_steps` more times."""
        if self.router.steps - self._last_step < int(every_steps):
            return None
        self._last_step = self.router.steps
        return self.tick()

    def tick(self):
        """One control iteration: scrape, update streaks, take at most
        one scaling action.  Returns the decision record."""
        t0 = self._time()
        self.ticks += 1
        windows, health, _ = self._read()
        n = len(self.router._replicas)
        breach = self._breach(windows)
        slack = self._slack(windows, health)
        # queue growth is a breach signal even before latency
        # histograms fill (CPU-scale tests and cold starts): a held
        # queue means no replica could take the work at all
        if breach is None and health["held"] > 0 and \
                self.slo.queue_wait_p99_ms is not None:
            breach = {"signal": "held", "p99_ms": float(health["held"]),
                      "target_ms": 0.0, "ratio": float("inf")}
        if breach is not None:
            self._breach_streak += 1
            self._slack_streak = 0
        elif slack:
            self._slack_streak += 1
            self._breach_streak = 0
        else:
            self._breach_streak = 0
            self._slack_streak = 0
        action, detail = "none", {}
        if self._cooldown > 0:
            self._cooldown -= 1
            action = "cooldown"
        elif breach is not None and \
                self._breach_streak >= self.breach_ticks:
            if n < self.max_replicas:
                action, detail = self._scale_out(breach)
            else:
                action, detail = self._maybe_shed(breach)
        elif slack and self._slack_streak >= self.slack_ticks and \
                n > self.min_replicas:
            action, detail = self._scale_in()
        elif self._rebalance_enabled():
            action, detail = self._maybe_rebalance(health)
        if breach is None:
            self._shed_streak = 0
            if self.router.shedding:
                # the last resort clears WITH the breach, not a timer
                self.router.shedding = False
                detail = dict(detail, shed_cleared=True)
        if self.affinity_adapters > 0:
            try:
                placed = self._place_adapters(health)
                if placed:
                    detail = dict(detail, affinity_placed=placed)
            except Exception:
                pass                    # placement is advisory
        rec = {"tick": self.ticks, "action": action,
               "replicas": len(self.router._replicas),
               "breach": breach, "slack": slack,
               "breach_streak": self._breach_streak,
               "slack_streak": self._slack_streak,
               "decision_ms": (self._time() - t0) * 1e3, **detail}
        self.decisions.append(rec)
        return rec

    # -- actions -------------------------------------------------------------
    def _scale_out(self, breach):
        role = self._needy_role(breach)
        if self.price is not None:
            try:
                priced = self.price(len(self.router._replicas) + 1)
            except Exception as e:
                priced = {"fits": True,
                          "error": f"{type(e).__name__}: {e}"}
            if not priced.get("fits", True):
                # the cost model says one more replica does not fit
                # HBM: treat the fleet as capped
                return self._maybe_shed(breach, priced=priced)
        else:
            priced = None
        try:
            fault_point("scale.spawn",
                        detail=f"n={len(self.router._replicas) + 1}")
            if self.spawner is not None:
                backend = self.spawner(role)
                rep = self.router.add_replica(backend=backend,
                                              role=role)
            else:
                rep = self.router.add_replica(role=role)
        except Exception as e:
            self.spawn_failures += 1
            return "spawn_failed", {"error": f"{type(e).__name__}: {e}"}
        moved = self.router.shift_queued()
        self.scale_outs += 1
        self._cooldown = self.cooldown_ticks
        self._breach_streak = 0
        return "scale_out", {"replica": rep.name, "role": role,
                             "shifted": moved, "priced": priced}

    def _scale_in(self):
        victim = self._retire_victim()
        if victim is None:
            return "none", {}
        try:
            fault_point("scale.retire", detail=victim.name)
            self.router.retire_replica(victim.name)
        except Exception as e:
            return "retire_failed", {"replica": victim.name,
                                     "error": f"{type(e).__name__}: {e}"}
        if self.retirer is not None:
            try:
                self.retirer(victim.name)
            except Exception:
                pass                    # reaping is best-effort; the
                #                         router already detached it
        self.scale_ins += 1
        self._cooldown = self.cooldown_ticks
        self._slack_streak = 0
        return "scale_in", {"replica": victim.name}

    def _maybe_shed(self, breach, priced=None):
        """At max capacity (or HBM-capped) and still breached: after
        shed_after_ticks more breached ticks, flip the last resort."""
        self._shed_streak += 1
        if self._shed_streak >= self.shed_after_ticks and \
                not self.router.shedding:
            self.router.shedding = True
            self.sheds += 1
            return "shed", {"breach": breach, "priced": priced}
        return "capped", {"breach": breach, "priced": priced,
                          "shed_streak": self._shed_streak}

    def _rebalance_enabled(self):
        if self.rebalance is not None:
            return bool(self.rebalance)
        return self.router._topology is not None

    def _maybe_rebalance(self, health):
        """Flip one worker's role when the pools' pressure is lopsided:
        pressure = (queued + running) per worker of the role.  Guarded
        by the same cooldown as scaling, and never drops a pool below
        one worker."""
        if self.router._topology is None:
            return "none", {}
        press = {"prefill": [], "decode": []}
        for name, h in health["replicas"].items():
            role = h.get("role")
            if role in press and h.get("breaker") != "open":
                press[role].append(
                    (h.get("queued", 0) + h.get("running", 0), name, h))
        npf, ndc = len(press["prefill"]), len(press["decode"])
        if npf < 1 or ndc < 1:
            return "none", {}
        p_load = sum(q for q, _, _ in press["prefill"]) / npf
        d_load = sum(q for q, _, _ in press["decode"]) / ndc
        flip = None
        if p_load > 2.0 * d_load + 1.0 and ndc > 1:
            # prefill starved: the idlest decode worker re-roles
            flip = (min(press["decode"])[1], "prefill")
        elif d_load > 2.0 * p_load + 1.0 and npf > 1:
            flip = (min(press["prefill"])[1], "decode")
        if flip is None:
            return "none", {}
        name, role = flip
        try:
            fault_point("scale.rebalance", detail=f"{name}->{role}")
            self.router.set_replica_role(name, role)
        except Exception as e:
            return "rebalance_failed", {
                "replica": name, "error": f"{type(e).__name__}: {e}"}
        self.rebalances += 1
        self._cooldown = self.cooldown_ticks
        return "rebalance", {"replica": name, "to_role": role,
                             "prefill_load": p_load,
                             "decode_load": d_load}

    # -- adapter affinity placement ------------------------------------------
    def _place_adapters(self, health):
        """Pin the N hottest adapters (by the pools' per-adapter
        request counters) on an affinity subset each, route-preferred;
        everything else keeps the fan-to-all default.  The counters
        live in the engines' full health() (the router's per-replica
        entry carries only the O(1) headroom subset), so this polls
        reachable replicas directly — advisory, breaker-respecting."""
        traffic = collections.Counter()
        for rep in self.router._replicas:
            if rep.breaker.state == "open":
                continue
            try:
                reqs = (rep.health().get("adapters") or {}) \
                    .get("requests") or {}
            except Exception:
                continue
            for name, c in reqs.items():
                traffic[name] += int(c)
        placed = []
        current = self.router.adapter_affinity()
        hot = [n for n, _ in traffic.most_common(self.affinity_adapters)]
        for name in hot:
            if name in current:
                continue
            # any replica's registry knows the deploy path
            path = next((r.adapters.get(name)
                         for r in self.router._replicas
                         if name in getattr(r, "adapters", {})), None)
            if path is None:
                continue
            members = [r.name for r in self.router._routable()
                       ][:self.affinity_replicas]
            if not members:
                continue
            self.router.set_adapter_affinity(name, members)
            for rn in members:
                rep = self.router._by_name[rn]
                try:
                    if name not in rep.adapters:
                        rep.load_adapter(name, path)
                    rep.pin_adapter(name)
                except Exception:
                    pass                # preference, not a constraint
            placed.append({"adapter": name, "replicas": members})
        return placed

    # -- victim selection ----------------------------------------------------
    def _needy_role(self, breach):
        """Role for a scale-out spawn: TTFT pressure wants prefill,
        TPOT wants decode; non-disaggregated fleets spawn 'any'."""
        if self.router._topology is None:
            return "any"
        return {"ttft_ms": "prefill", "queue_wait_ms": "prefill",
                "held": "prefill"}.get(breach["signal"], "decode")

    def _retire_victim(self):
        """Quarantined (breaker-open) workers first — they contribute
        no capacity, so retiring one is free and removes the broken
        worker from the fleet; then the shallowest ACTIVE replica
        (moves the least state).  Never the last of a disagg role."""
        topo = self.router._topology
        cand = []
        for rep in self.router._replicas:
            if topo is not None and rep.role in topo and \
                    topo[rep.role] <= 1:
                continue
            dead = (rep.state != "active"
                    or rep.breaker.state == "open")
            cand.append((0 if dead else 1,
                         len(self.router._assigned[rep.name]),
                         rep.name, rep))
        return min(cand)[3] if cand else None

    # -- observability -------------------------------------------------------
    def stats(self):
        return {"ticks": self.ticks, "scale_outs": self.scale_outs,
                "scale_ins": self.scale_ins,
                "rebalances": self.rebalances, "sheds": self.sheds,
                "spawn_failures": self.spawn_failures,
                "shedding": self.router.shedding,
                "replicas": len(self.router._replicas),
                "breach_streak": self._breach_streak,
                "slack_streak": self._slack_streak,
                "cooldown": self._cooldown,
                "last_decision": (self.decisions[-1]
                                  if self.decisions else None)}


def price_from_spec(fleet_spec, prompt_len=128, gen_tokens=64,
                    calib=None):
    """Build a FleetController price= callable from a worker spec dict
    — the same predict_serving pricing spawn_fleet's traffic_target
    sizing uses, so the controller and the spawner agree on what a
    replica costs before paying for it."""
    from ..cost_model import (model_cfg_from_fleet_spec,
                              predict_serving, spec_from_fleet_dict)
    cfg = model_cfg_from_fleet_spec(fleet_spec)

    def price(n_replicas):
        spec = spec_from_fleet_dict(fleet_spec, replicas=n_replicas)
        cost = predict_serving(cfg, spec, calib=calib,
                               prompt_len=prompt_len,
                               gen_tokens=gen_tokens)
        return {"fits": cost.fits, "hbm_gb": cost.hbm_gb,
                "ttft_ms": cost.meta["ttft_ms"],
                "tpot_ms": cost.meta["tpot_ms"],
                "fleet_tokens_per_sec":
                    cost.meta["fleet_tokens_per_sec"]}
    return price
