"""Serving telemetry plane: request lifecycle tracing and latency metrics.

Counterpart of `paddle_tpu/inference/telemetry.py` (the engine-level
plane; it imports no JAX, so the port keeps its own copy), with the
router-side `ReplicaTelemetryMirror` of a process-backed replica.

Design constraints, as in the reference:

  - No device sync. Every timestamp is `time.monotonic()` captured at a
    host point the engine already visits: block boundaries, admission,
    retirement. Telemetry never reads a device value and never changes
    what the engine computes (greedy outputs are byte-identical with it
    on and off).
  - `telemetry=None` stays the default and costs one branch per site
    (`if self._tel is not None`).
  - Everything is bounded: per-request event lists, the completed-trace
    ring, the structured event log, the JSONL write buffer.

Pieces:

  - `Histogram`: fixed log-spaced millisecond buckets; `observe`,
    `percentile` (linear interpolation inside a bucket), `merge`.
  - `SlidingWindowHistogram` / `MetricsRegistry`: named histograms,
    counters, rate-converted deltas of `health()` snapshots (`sample()`),
    Prometheus text exposition (`prometheus()`), last-window percentiles.
  - `RequestTrace`: one request's lifecycle: submit, queue wait (seat),
    prefill chunks, first token (TTFT), speculation passes with accept
    counts, preemption, retirement.
  - `Telemetry`: the object `ContinuousBatchingEngine(telemetry=...)`
    feeds; exports a chrome-trace / Perfetto JSON timeline
    (`export_chrome_trace`), a Prometheus-style text snapshot and a
    structured JSONL event log. A `failsafe` fault hook (installed by
    default) drops injected and real fault firings into the same timeline.
  - `serve_prometheus`: a stdlib HTTP thread serving `/metrics`.
"""
import bisect
import collections
import json
import time
import weakref

# Histogram bucket upper bounds in MILLISECONDS, log-spaced from 0.1ms
# to 60s (+ an implicit overflow bucket). Fixed buckets are what make
# fleet aggregation trivial: merging two replicas' histograms is an
# elementwise add, so router-level p99 survives replica death — the
# per-request samples do not have to.
DEFAULT_BUCKETS_MS = (0.1, 0.2, 0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0,
                      100.0, 200.0, 500.0, 1000.0, 2000.0, 5000.0,
                      10000.0, 30000.0, 60000.0)


class Histogram:
    """Fixed-bucket latency histogram (values in ms)."""

    __slots__ = ("buckets", "counts", "count", "total", "vmin", "vmax")

    def __init__(self, buckets=DEFAULT_BUCKETS_MS):
        self.buckets = tuple(float(b) for b in buckets)
        self.counts = [0] * (len(self.buckets) + 1)   # + overflow
        self.count = 0
        self.total = 0.0
        self.vmin = None
        self.vmax = None

    def observe(self, v):
        v = float(v)
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.count += 1
        self.total += v
        self.vmin = v if self.vmin is None else min(self.vmin, v)
        self.vmax = v if self.vmax is None else max(self.vmax, v)

    def merge(self, other):
        """Elementwise add (fleet aggregation). Buckets must match —
        they do by construction, every registry uses the defaults
        unless a caller deliberately diverges."""
        if other.buckets != self.buckets:
            raise ValueError(
                f"cannot merge histograms with different buckets "
                f"({len(self.buckets)} vs {len(other.buckets)} edges)")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.total += other.total
        if other.vmin is not None:
            self.vmin = (other.vmin if self.vmin is None
                         else min(self.vmin, other.vmin))
        if other.vmax is not None:
            self.vmax = (other.vmax if self.vmax is None
                         else max(self.vmax, other.vmax))
        return self

    def percentile(self, p):
        """Estimated p-th percentile: walk the cumulative counts,
        interpolate linearly inside the landing bucket (the overflow
        bucket reports the observed max — the honest answer for a
        fixed-bucket histogram)."""
        if not self.count:
            return 0.0
        target = self.count * min(max(float(p), 0.0), 100.0) / 100.0
        cum = 0
        for i, c in enumerate(self.counts):
            if c and cum + c >= target:
                if i >= len(self.buckets):          # overflow bucket
                    return self.vmax
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = self.buckets[i]
                return lo + (hi - lo) * max(0.0, target - cum) / c
            cum += c
        return self.vmax if self.vmax is not None else 0.0

    def snapshot(self):
        if not self.count:
            return {"count": 0}
        return {"count": self.count,
                "sum_ms": round(self.total, 3),
                "min_ms": round(self.vmin, 3),
                "max_ms": round(self.vmax, 3),
                "p50_ms": round(self.percentile(50), 3),
                "p90_ms": round(self.percentile(90), 3),
                "p95_ms": round(self.percentile(95), 3),
                "p99_ms": round(self.percentile(99), 3)}


class SlidingWindowHistogram:
    """Last-N-seconds view of a latency stream: K rotating Histogram
    slices of window_s/K seconds each.  `observe` lands in the current
    slice; `window()` merges the slices still inside the window into
    one plain Histogram, so p50/p99 answer "what is TTFT NOW", not
    "since boot" — the signal an autoscaler must react to (a lifetime
    aggregate takes minutes to reflect a spike that started seconds
    ago, and never forgets one that ended).

    Slices are timestamped with time.monotonic(); cross-process state
    ships slice AGES instead (monotonic clocks do not survive a process
    boundary):
    `state()` emits [(age_s, Histogram)], `install()` rebases onto the
    receiver's clock.
    """

    __slots__ = ("window_s", "n_slices", "slice_s", "buckets", "slices")

    def __init__(self, window_s=60.0, n_slices=6,
                 buckets=DEFAULT_BUCKETS_MS):
        self.window_s = float(window_s)
        self.n_slices = max(1, int(n_slices))
        self.slice_s = self.window_s / self.n_slices
        self.buckets = tuple(buckets)
        self.slices = collections.deque()   # [(t_slice_start, Histogram)]

    def observe(self, v, now=None):
        now = time.monotonic() if now is None else float(now)
        while self.slices and \
                now - self.slices[0][0] > self.window_s + self.slice_s:
            self.slices.popleft()
        if not self.slices or now - self.slices[-1][0] >= self.slice_s:
            self.slices.append((now, Histogram(self.buckets)))
        self.slices[-1][1].observe(v)

    def window(self, now=None):
        """One merged Histogram over the slices still inside the
        window (a fresh object — the live slices are never mutated by
        a read)."""
        now = time.monotonic() if now is None else float(now)
        out = Histogram(self.buckets)
        for t0, h in self.slices:
            if now - t0 <= self.window_s + self.slice_s:
                out.merge(h)
        return out

    def merge(self, other):
        """Fleet aggregation: adopt the other view's slices (slice
        objects are shared read-only — window() copies, and a merged
        registry is a throwaway snapshot, never observed into).
        Staleness is window()'s problem — it filters by age at read
        time, so adopting everything here stays correct.  Keeps the
        deque time-ordered so a later observe still rotates right."""
        if other.slices:
            self.slices = collections.deque(
                sorted(list(self.slices) + list(other.slices),
                       key=lambda s: s[0]))
        return self

    def state(self, now=None):
        """Picklable cross-process snapshot: slice ages, not
        timestamps."""
        now = time.monotonic() if now is None else float(now)
        return {"window_s": self.window_s, "n_slices": self.n_slices,
                "slices": [(now - t0, h) for t0, h in self.slices]}

    @classmethod
    def install(cls, state, now=None):
        """Rebase a state() snapshot onto THIS process's clock."""
        now = time.monotonic() if now is None else float(now)
        swh = cls(window_s=state["window_s"],
                  n_slices=state.get("n_slices", 6))
        swh.slices = collections.deque(
            sorted(((now - age, h) for age, h in state["slices"]),
                   key=lambda s: s[0]))
        return swh


# Default sliding-window span for MetricsRegistry's windowed
# percentiles (docs/observability.md "Windowed metrics") — wide enough
# to smooth one noisy request, short enough that a spike that ended is
# forgotten within a minute.
DEFAULT_WINDOW_S = 60.0


class MetricsRegistry:
    """Named histograms + counters + health-counter rates.

    The standard histogram names the serving stack feeds (auto-created
    on first observe — callers never pre-register):

      ttft_ms          submit -> first token
      tpot_ms          time per output token over a request's decode
      queue_wait_ms    submit -> seated in a slot
      block_ms         one engine step()/fused-block wall
      prefill_chunk_ms one chunked-prefill dispatch wall
      draft_ms         host-side drafter propose() wall (speculation)
      handoff_ms       KV-page export -> source release (disagg move)
      restore_ms       tier demote -> restore re-seat
      e2e_ms           submit -> retirement (any terminal state)
    """

    def __init__(self, buckets=DEFAULT_BUCKETS_MS,
                 window_s=DEFAULT_WINDOW_S):
        self._buckets = tuple(buckets)
        self.hist = {}
        self.counters = collections.Counter()
        self.window_s = float(window_s)
        self.win = {}                   # name -> SlidingWindowHistogram
        self._last_sample = None        # (t_monotonic, {name: value})
        self._rates = {}

    def observe(self, name, value_ms, now=None):
        h = self.hist.get(name)
        if h is None:
            h = self.hist[name] = Histogram(self._buckets)
        h.observe(value_ms)
        w = self.win.get(name)
        if w is None:
            w = self.win[name] = SlidingWindowHistogram(
                self.window_s, buckets=self._buckets)
        w.observe(value_ms, now=now)

    def window_hist(self, name, now=None):
        """Merged last-window Histogram for `name` (empty Histogram
        when nothing was observed — .count == 0, percentile == 0)."""
        w = self.win.get(name)
        if w is None:
            return Histogram(self._buckets)
        return w.window(now=now)

    def window_snapshot(self, now=None):
        """{name: histogram-snapshot + window_s} over the sliding
        windows — the `windows` key of snapshot().  Keys inside each
        entry are the Histogram.snapshot() schema plus `window_s`
        (schema-pinned in tests/test_telemetry.py — renaming one must
        fail a test, not a dashboard or the autoscale controller)."""
        out = {}
        for name in sorted(self.win):
            snap = self.window_hist(name, now=now).snapshot()
            snap["window_s"] = self.win[name].window_s
            out[name] = snap
        return out

    def count(self, name, n=1):
        self.counters[name] += n

    def sample(self, counters):
        """Rate-convert a monotonic counter snapshot (an engine/router
        `health()` dict): numeric leaves become `<name>_per_s` deltas
        against the previous sample. Call it periodically (a metrics
        scrape, `EngineRouter.metrics()`, serve_llama's
        `--metrics-every`); returns the current rates dict."""
        now = time.monotonic()
        num = {k: float(v) for k, v in counters.items()
               if isinstance(v, (int, float)) and not isinstance(v, bool)}
        if self._last_sample is not None:
            t0, prev = self._last_sample
            dt = max(now - t0, 1e-9)
            self._rates = {f"{k}_per_s": (v - prev[k]) / dt
                           for k, v in num.items() if k in prev}
        self._last_sample = (now, num)
        return dict(self._rates)

    def rates(self):
        return dict(self._rates)

    def merge(self, other):
        # list() copies: `other` may be a LIVE registry another thread
        # (the serving loop, a fleet mirror pull) is inserting into
        # while a scrape thread merges — iterating the dict directly
        # would raise "dictionary changed size during iteration"
        for name, h in list(other.hist.items()):
            mine = self.hist.get(name)
            if mine is None:
                mine = self.hist[name] = Histogram(h.buckets)
            mine.merge(h)
        for name, w in list(getattr(other, "win", {}).items()):
            mine = self.win.get(name)
            if mine is None:
                mine = self.win[name] = SlidingWindowHistogram(
                    w.window_s, buckets=w.buckets)
            mine.merge(w)
        self.counters.update(dict(other.counters))
        for k, v in list(other._rates.items()):
            self._rates[k] = self._rates.get(k, 0.0) + v
        return self

    @classmethod
    def merged(cls, registries):
        """One fleet view over per-replica registries (histogram counts
        add; counters sum; rates sum)."""
        out = cls()
        for reg in registries:
            out.merge(reg)
        return out

    def snapshot(self):
        return {"histograms": {n: h.snapshot()
                               for n, h in sorted(self.hist.items())},
                "windows": self.window_snapshot(),
                "counters": dict(sorted(self.counters.items())),
                "rates": {k: round(v, 4)
                          for k, v in sorted(self._rates.items())}}

    def prometheus(self, prefix="paddle_tpu"):
        """Prometheus text exposition of the registry: cumulative
        histogram buckets (`le` labels in ms), counters, and sampled
        health rates as gauges."""
        lines = []
        for name in sorted(self.hist):
            h = self.hist[name]
            base = f"{prefix}_{name}"
            lines.append(f"# TYPE {base} histogram")
            cum = 0
            for edge, c in zip(h.buckets, h.counts):
                cum += c
                lines.append(f'{base}_bucket{{le="{edge:g}"}} {cum}')
            cum += h.counts[-1]
            lines.append(f'{base}_bucket{{le="+Inf"}} {cum}')
            lines.append(f"{base}_sum {h.total:g}")
            lines.append(f"{base}_count {h.count}")
        for name in sorted(self.counters):
            lines.append(f"# TYPE {prefix}_{name} counter")
            lines.append(f"{prefix}_{name} {self.counters[name]}")
        for name in sorted(self._rates):
            lines.append(f"# TYPE {prefix}_{name} gauge")
            lines.append(f"{prefix}_{name} {self._rates[name]:g}")
        return "\n".join(lines) + "\n"


class RequestTrace:
    """One request's lifecycle record (host timestamps only).

    The well-known phase timestamps are promoted to slots (they drive
    the histogram observations and the chrome-trace span chain); every
    other lifecycle transition lives in `events` as (t, name, attrs).
    """

    __slots__ = ("src", "uid", "t_submit", "t_seat", "t_first", "t_done",
                 "state", "stage", "n_tokens", "prompt_len", "max_new",
                 "events", "dropped_events")

    def __init__(self, src, uid, t_submit=None, prompt_len=0, max_new=0):
        self.src = src
        self.uid = uid
        self.t_submit = t_submit
        self.t_seat = None              # admitted into a slot
        self.t_first = None             # first token emitted HERE
        self.t_done = None              # terminal transition
        self.state = None               # done/failed/cancelled/migrated
        self.stage = None               # failure stage, when failed
        self.n_tokens = 0
        self.prompt_len = int(prompt_len)
        self.max_new = int(max_new)
        self.events = []                # [(t, name, attrs-or-None)]
        self.dropped_events = 0

    def last(self, name):
        """Timestamp of the most recent event `name` (None if absent)."""
        for t, n, _ in reversed(self.events):
            if n == name:
                return t
        return None

    def phases(self):
        """Event names in order — the span-chain check surface."""
        return [n for _, n, _ in self.events]

    def imported(self):
        """True when this trace began as a KV-page import (mid-stream
        seat: the first token was emitted on the SOURCE engine)."""
        return any(n == "import_seat" for _, n, _ in self.events)

    def complete_chain(self):
        """True when the retired request's span chain is whole:
        admission -> seat -> first token -> retirement (an imported
        continuation's first token lives on its source engine, so the
        import seat stands in for it there)."""
        return (self.t_submit is not None and self.t_seat is not None
                and self.t_done is not None
                and (self.t_first is not None or self.imported()))

    def __repr__(self):
        return (f"RequestTrace({self.src}/{self.uid}, state={self.state},"
                f" events={len(self.events)})")


class Telemetry:
    """The telemetry object threaded through the serving stack.

    One Telemetry per engine (or per replica — `EngineRouter` attaches
    one to each `EngineReplica`, where it survives engine rebuilds).
    All methods are cheap host work: a dict lookup, a monotonic read,
    an append. Single-threaded by assumption, like the engines that
    feed it.

    name: source label (replica name in a fleet; pid name in the
      chrome trace).
    max_done / max_log: bounds on the completed-trace ring and the
      structured event log.
    jsonl_path: stream the event log to this file (bounded buffering:
      entries flush every `flush_every` events and on flush()/close()).
    capture_faults: install a weakref `failsafe` fault hook so injected
      and real fault firings appear in this timeline (docs/
      observability.md "Fault events").
    """

    MAX_TRACE_EVENTS = 4096             # per-request event cap

    def __init__(self, name="engine", registry=None, max_done=1024,
                 max_log=16384, jsonl_path=None, flush_every=256,
                 capture_faults=True, buckets=DEFAULT_BUCKETS_MS):
        self.name = name
        self.registry = registry if registry is not None \
            else MetricsRegistry(buckets)
        self._live = {}                 # (src, uid) -> RequestTrace
        self.done = collections.deque(maxlen=max_done)
        self.log = collections.deque(maxlen=max_log)
        self._gevents = collections.deque(maxlen=4096)  # non-request
        self._jsonl_path = jsonl_path
        self._jsonl_buf = []
        self._flush_every = max(1, int(flush_every))
        self._fault_hook = None
        if capture_faults:
            self._install_fault_hook()

    # -- request lifecycle (the engine-facing fast surface) ------------------
    def req_start(self, src, uid, prompt_len=0, max_new=0):
        now = time.monotonic()
        tr = RequestTrace(src, uid, now, prompt_len, max_new)
        self._live[(src, uid)] = tr
        self._ev(tr, now, "submit", None)
        return tr

    def req_event(self, src, uid, name, **attrs):
        """Record one lifecycle transition. Well-known names also feed
        the histograms: "seat"/"import_seat" close the queue-wait span,
        "restore" pairs with the last "demote" (restore_ms), "migrated"
        pairs with the last "kv_export" (handoff_ms)."""
        now = time.monotonic()
        tr = self._live.get((src, uid))
        if tr is None:
            # attached mid-flight (or a stale uid): trace lazily so the
            # caller never has to care — the chain is simply incomplete
            tr = RequestTrace(src, uid)
            self._live[(src, uid)] = tr
        if name in ("seat", "import_seat", "route"):
            # all three mark the seat timestamp for the span chain;
            # only an ENGINE "seat" observes queue_wait_ms — the
            # router's "route" and a handoff "import_seat" would
            # double-count the wait the engine already measured
            if tr.t_seat is None:
                tr.t_seat = now
                if name == "seat" and tr.t_submit is not None:
                    self.registry.observe(
                        "queue_wait_ms", (now - tr.t_submit) * 1e3)
        elif name == "restore":
            t0 = tr.last("demote")
            if t0 is not None:
                self.registry.observe("restore_ms", (now - t0) * 1e3)
        elif name == "migrated":
            t0 = tr.last("kv_export")
            if t0 is not None:
                self.registry.observe("handoff_ms", (now - t0) * 1e3)
        self._ev(tr, now, name, attrs or None)

    def req_first_token(self, src, uid):
        now = time.monotonic()
        tr = self._live.get((src, uid))
        if tr is None or tr.t_first is not None:
            return
        tr.t_first = now
        # a RESUMED continuation (failover re-queue with committed
        # tokens folded into the prompt — see submit_resume's "resume"
        # event) gets its span timestamp but NOT a ttft_ms observation:
        # the request's real first token was emitted on the engine it
        # resumed FROM, and observing again would make the fleet ttft
        # count exceed retired requests
        if tr.t_submit is not None and tr.last("resume") is None:
            self.registry.observe("ttft_ms", (now - tr.t_submit) * 1e3)
        self._ev(tr, now, "first_token", None)

    def req_done(self, src, uid, state, n_tokens=0, stage=None,
                 error=None):
        """Terminal transition: close the trace, observe e2e (and, for
        a DONE request, time-per-output-token over the tokens this
        engine emitted), move it to the completed ring."""
        now = time.monotonic()
        tr = self._live.pop((src, uid), None)
        if tr is None:
            tr = RequestTrace(src, uid)
        tr.t_done = now
        tr.state = state
        tr.stage = stage
        tr.n_tokens = int(n_tokens)
        attrs = {"state": state}
        if stage is not None:
            attrs["stage"] = stage
        if error is not None:
            attrs["error"] = error
        self._ev(tr, now, "retire", attrs)
        self.registry.count(f"requests_{state}")
        if tr.t_submit is not None:
            self.registry.observe("e2e_ms", (now - tr.t_submit) * 1e3)
        if state == "done" and tr.n_tokens >= 1:
            t_ref = tr.t_first if tr.t_first is not None else tr.t_seat
            if t_ref is None:
                t_ref = tr.t_submit
            if t_ref is not None:
                self.registry.observe(
                    "tpot_ms",
                    (now - t_ref) * 1e3 / max(1, tr.n_tokens - 1))
        self.done.append(tr)
        return tr

    def drop(self, src, uid):
        """Forget a live trace (an admission that was rolled back)."""
        self._live.pop((src, uid), None)

    def reset_live(self, src):
        """Drop every live trace under `src` — called when an engine is
        rebuilt under a replica name (its uid space restarts)."""
        for key in [k for k in self._live if k[0] == src]:
            del self._live[key]

    # -- non-request events / metrics ---------------------------------------
    def event(self, name, **attrs):
        """Engine/fleet-level event (fault firing, hot-swap, replica
        failure): structured-log + chrome-trace instant + counter."""
        now = time.monotonic()
        entry = {"t": now, "src": self.name, "ev": name}
        if attrs:
            entry.update(attrs)
        self.log.append(entry)
        self._jsonl(entry)
        self._gevents.append((now, name, attrs or None))
        self.registry.count(f"events_{name}")

    def observe(self, name, value_ms):
        self.registry.observe(name, value_ms)

    def block(self, ms):
        """One engine step()/fused-block wall observation."""
        self.registry.observe("block_ms", ms)
        self.registry.count("blocks")

    def sample(self, counters):
        """Rate-convert a health() counter snapshot (see
        MetricsRegistry.sample)."""
        return self.registry.sample(counters)

    # -- read side -----------------------------------------------------------
    def trace(self, src, uid):
        """The trace for (src, uid): live first, else the most recent
        completed one."""
        tr = self._live.get((src, uid))
        if tr is not None:
            return tr
        for tr in reversed(self.done):
            if tr.src == src and tr.uid == uid:
                return tr
        return None

    def done_traces(self):
        return list(self.done)

    def live_traces(self):
        return list(self._live.values())

    def summary(self):
        """Compact one-line-able metrics dict (serve_llama's
        --metrics-every print): per-histogram p50/p99 + counts,
        counters, sampled rates."""
        out = {}
        for name, h in sorted(self.registry.hist.items()):
            if h.count:
                out[f"{name}_p50"] = round(h.percentile(50), 3)
                out[f"{name}_p99"] = round(h.percentile(99), 3)
                out[f"{name}_count"] = h.count
        out.update(sorted(self.registry.counters.items()))
        for k, v in sorted(self.registry.rates().items()):
            if v:                       # zero rates are noise in a line
                out[k] = round(v, 3)
        return out

    def prometheus(self, prefix="paddle_tpu"):
        return self.registry.prometheus(prefix)

    # -- cross-process state (the fleet pull) ---------------------------------
    def state(self, full=True):
        """Picklable snapshot of this telemetry's plane — registry
        (histograms + counters) and, when `full`, traces and event
        logs — the payload a fleet worker ships when the router pulls
        its metrics (inference/fleet.py `telemetry_state`). Everything
        in it is plain data (__slots__ classes, deques, Counters), so
        the RPC framing's pickle carries it without custom reducers.

        full=False is the metrics-pull shape: every scrape and
        `EngineRouter.metrics()` call only consumes the registry +
        health, so shipping hundreds of done traces, the live set,
        the gevents ring, and the JSONL log per pull per worker would
        be continuous redundant wire traffic — the trace plane ships
        only on `sync_telemetry()` (the chrome-trace export path)."""
        st = {"name": self.name,
              "hist": dict(self.registry.hist),
              # sliding windows ship as slice AGES (monotonic clocks do
              # not survive a process boundary); install rebases them
              "win": {n: w.state()
                      for n, w in self.registry.win.items()},
              "counters": collections.Counter(self.registry.counters)}
        if full:
            st.update(done=list(self.done),
                      live=list(self._live.items()),
                      gevents=list(self._gevents),
                      log=list(self.log))
        return st

    # -- exports -------------------------------------------------------------
    def chrome_trace(self):
        return chrome_trace([self])

    def export_chrome_trace(self, path):
        """Write this telemetry's timeline as chrome-trace JSON
        (loadable in Perfetto / chrome://tracing)."""
        return export_chrome_trace(path, [self])

    def export_jsonl(self, path):
        """Write the in-memory structured event log (bounded — the
        newest max_log entries) as one JSON object per line."""
        with open(path, "w") as f:
            for entry in self.log:
                f.write(json.dumps(entry) + "\n")
        return path

    def flush(self):
        """Flush the streaming JSONL buffer (jsonl_path mode)."""
        if self._jsonl_path and self._jsonl_buf:
            with open(self._jsonl_path, "a") as f:
                f.write("".join(self._jsonl_buf))
            self._jsonl_buf = []

    def close(self):
        """Flush and detach the fault hook (tests; long-lived processes
        may simply drop the object — the hook is weakref'd)."""
        if self._fault_hook is not None:
            from ..failsafe import remove_fault_hook
            remove_fault_hook(self._fault_hook)
            self._fault_hook = None
        self.flush()

    # -- internals -----------------------------------------------------------
    def _ev(self, tr, now, name, attrs):
        if len(tr.events) >= self.MAX_TRACE_EVENTS:
            tr.dropped_events += 1
        else:
            tr.events.append((now, name, attrs))
        entry = {"t": now, "src": tr.src, "uid": tr.uid, "ev": name}
        if attrs:
            entry.update(attrs)
        self.log.append(entry)
        self._jsonl(entry)

    def _jsonl(self, entry):
        if self._jsonl_path is None:
            return
        self._jsonl_buf.append(json.dumps(entry) + "\n")
        if len(self._jsonl_buf) >= self._flush_every:
            self.flush()

    def _install_fault_hook(self):
        from ..failsafe import add_fault_hook, remove_fault_hook
        ref = weakref.ref(self)

        def hook(point, detail):
            tel = ref()
            if tel is None:             # self was collected: self-remove
                remove_fault_hook(hook)
                return
            tel.event("fault", point=point, detail=detail)

        add_fault_hook(hook)
        self._fault_hook = hook


class ReplicaTelemetryMirror(Telemetry):
    """Router-side mirror of a PROCESS replica's telemetry: the object
    `EngineRouter.metrics()/prometheus()/export_chrome_trace()` read
    when the replica's engine lives in another process
    (`inference/fleet.py`'s ProcessReplica).

    Each `install_state` pull replaces the mirror's registry contents
    and traces with the worker's snapshot, merged over a BASE registry
    that accumulates dead incarnations: when the worker is killed (or
    respawned by a quarantine-probe rebuild), the last-known counts
    fold into the base instead of vanishing, so fleet p50/p95/p99
    survive replica death across process boundaries. The sliding
    windows are the live incarnation's only (a current-load view).
    Rate sampling (`registry.sample`) stays LOCAL to the mirror's
    registry object, so `<counter>_per_s` gauges keep their baseline
    across pulls."""

    def __init__(self, name):
        super().__init__(name=name, capture_faults=False)
        self._base = MetricsRegistry()
        self._cur = None                # (incarnation, hist, counters)

    def install_state(self, state):
        if state is None:
            return
        inc = state.get("incarnation")
        if self._cur is not None and self._cur[0] != inc:
            self.fold_incarnation()     # the old worker is gone: keep
            #                             its last-known counts (and
            #                             drop the rate baseline)
        self._cur = (inc, state["hist"], state["counters"])
        merged = MetricsRegistry()
        merged.merge(self._base)
        cur = MetricsRegistry()
        cur.hist = state["hist"]
        cur.counters = state["counters"]
        merged.merge(cur)
        # materialize into self.registry IN PLACE: the registry object
        # identity (and its _last_sample rate baseline) must survive
        # the refresh -- it is what the router merges and samples
        self.registry.hist = merged.hist
        self.registry.counters = merged.counters
        if "win" in state:
            # windows are a CURRENT-load view: the live incarnation's
            # rebased slices replace the mirror's (the base registry
            # keeps a dead incarnation's lifetime histograms, not its
            # windows)
            self.registry.win = {
                n: SlidingWindowHistogram.install(st)
                for n, st in state["win"].items()}
        if "done" in state:             # a full pull (sync_telemetry);
            #                             registry-only pulls keep the
            #                             mirror's last-known traces
            self.done = collections.deque(state["done"],
                                          maxlen=self.done.maxlen)
            self._live = dict(state["live"])
            self._gevents = collections.deque(state["gevents"],
                                              maxlen=4096)
            self.log = collections.deque(state["log"],
                                         maxlen=self.log.maxlen)

    def fold_incarnation(self):
        """Fold the current incarnation's last-known registry into the
        base (called when the worker dies or respawns)."""
        if self._cur is None:
            return
        _, hist, counters = self._cur
        cur = MetricsRegistry()
        cur.hist = hist
        cur.counters = counters
        self._base.merge(cur)
        self._cur = None
        # whatever incarnation reports next starts its counters near
        # zero: sampling it against this one's baseline would export
        # large NEGATIVE <counter>_per_s gauges -- drop the baseline so
        # both fold paths skip one rate interval
        self.registry._last_sample = None
        self.registry._rates = {}


# -- chrome-trace (perfetto) export ------------------------------------------
def _trace_spans(tr):
    """Derive the span chain for one completed request trace:
    queue -> prefill -> decode, plus a "demoted" span per
    demote/restore pair. Returns [(name, t0, t1)]."""
    spans = []
    if tr.t_submit is not None and tr.t_seat is not None:
        spans.append(("queue", tr.t_submit, tr.t_seat))
    if tr.t_seat is not None:
        end_pf = tr.t_first if tr.t_first is not None else \
            (tr.t_done if tr.t_done is not None else tr.t_seat)
        spans.append(("prefill", tr.t_seat, end_pf))
    if tr.t_done is not None:
        start_dec = tr.t_first if tr.t_first is not None else tr.t_seat
        if start_dec is not None:
            spans.append(("decode", start_dec, tr.t_done))
    t_dem = None
    for t, name, _ in tr.events:
        if name == "demote":
            t_dem = t
        elif name == "restore" and t_dem is not None:
            spans.append(("demoted", t_dem, t))
            t_dem = None
    return spans


def chrome_trace(telemetries):
    """Build one chrome-trace JSON dict over several Telemetry sources
    (a fleet: the router's plus each replica's). Each source is a
    `pid`, each request a `tid`; phase spans are "X" events, every
    other lifecycle transition (and fleet events like fault firings) an
    instant. Timestamps are normalized to the earliest event."""
    t0 = None
    for tel in telemetries:
        for tr in list(tel.done) + list(tel._live.values()):
            if tr.events:
                t = tr.events[0][0]
                t0 = t if t0 is None else min(t0, t)
        for t, _, _ in tel._gevents:
            t0 = t if t0 is None else min(t0, t)
    if t0 is None:
        t0 = 0.0

    def us(t):
        return round((t - t0) * 1e6, 1)

    events = []
    for pid, tel in enumerate(telemetries):
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": tel.name}})
        for tr in list(tel.done) + list(tel._live.values()):
            tid = int(tr.uid) if isinstance(tr.uid, int) else \
                abs(hash(tr.uid)) % (1 << 31)
            for name, a, b in _trace_spans(tr):
                events.append({"ph": "X", "name": name, "pid": pid,
                               "tid": tid, "ts": us(a),
                               "dur": max(0.1, us(b) - us(a)),
                               "args": {"uid": tr.uid, "src": tr.src}})
            for t, name, attrs in tr.events:
                ev = {"ph": "i", "s": "t", "name": name, "pid": pid,
                      "tid": tid, "ts": us(t),
                      "args": dict(attrs or {}, uid=tr.uid)}
                events.append(ev)
        for t, name, attrs in tel._gevents:
            events.append({"ph": "i", "s": "p", "name": name, "pid": pid,
                           "tid": 0, "ts": us(t),
                           "args": dict(attrs or {})})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def export_chrome_trace(path, telemetries):
    """Write a merged chrome-trace JSON for the given Telemetry
    sources; returns `path`."""
    with open(path, "w") as f:
        json.dump(chrome_trace(telemetries), f)
    return path


# -- Prometheus scrape endpoint ----------------------------------------------
def serve_prometheus(source, port=0, host="127.0.0.1"):
    """Serve `source.prometheus()` at /metrics over a stdlib
    http.server THREAD (a Telemetry, a MetricsRegistry, or anything with
    .prometheus() works as the source).

    Returns the ThreadingHTTPServer: read the bound port from
    `.server_address[1]` (port=0 picks an ephemeral one), stop with
    `.shutdown()`. Each GET renders a FRESH exposition, so scraping a
    fleet router also pulls its remote replicas' registries.

    Renders are serialized (one lock per endpoint) and retried once on
    RuntimeError: the source's registries are LIVE objects the serving
    thread keeps mutating, and two concurrent scrapes of a fleet
    router would race each other's mirror pulls."""
    import http.server
    import threading

    render_lock = threading.Lock()

    class _Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path.rstrip("/") not in ("", "/metrics"):
                self.send_error(404)
                return
            try:
                with render_lock:
                    try:
                        body = source.prometheus().encode()
                    except RuntimeError:
                        # dict mutated mid-iteration by the serving
                        # thread: one retry re-reads a settled view
                        body = source.prometheus().encode()
            except Exception as e:      # noqa: BLE001 — scrape answer
                self.send_error(500, f"{type(e).__name__}: {e}")
                return
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):   # scrapes are not stdout news
            pass

    class _Server(http.server.ThreadingHTTPServer):
        def shutdown(self):
            # the documented stop is .shutdown() alone — close the
            # listening socket with it, or every open/close cycle (a
            # fleet restart, a test) leaks the bound fd until exit
            super().shutdown()
            self.server_close()

    srv = _Server((host, int(port)), _Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv
