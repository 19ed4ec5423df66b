"""Deterministic fault injection and retry/backoff.

Counterpart of `paddle_tpu/failsafe.py`, copied whole (it imports no JAX):
the port keeps its own registry of armed faults, so arming one package
never arms the other's sites, while the environment activation reads the
same variable with the same syntax, so a chaos run arms both packages the
same way. The environment arms fault sites only; it never picks a kernel
path.

  fault_point("cb.decode")        # declare a named fault site (free when
                                  # nothing is armed: one dict lookup)
  with inject("cb.decode", nth=3):
      ...                         # the 3rd call to that site raises
                                  # InjectedFault; scope ends, site disarms

  with inject("page.alloc", p=0.05, seed=7):
      ...                         # seeded probabilistic faults: the same
                                  # seed fires on the same calls, always

Activation from the environment (no code changes):

  PADDLE_TPU_FAULTS="cb.prefill:nth=1,cb.decode:p=0.02:seed=3"

Sites self-register on first call; `fault_points()` returns the catalog of
every site this process has passed through. The serving engine's sites
carry the reference's names and detail strings: `page.alloc`
(PageAllocator.alloc), `cb.admit`, `cb.prefill`, `cb.decode`, `cb.draft`
and `cb.verify` (ContinuousBatchingEngine). `retry_with_backoff` is the
shared bounded-retry helper with a deterministic, injectable sleep.
"""
import os
import random
import threading
import time


class RetriesExhaustedError(RuntimeError):
    """retry_with_backoff gave up: the retry budget ran out (with
    raise_exhausted=True) or the max_elapsed cap tripped. Carries the
    last underlying exception as .last_exception (also chained via
    __cause__), plus .attempts and .elapsed (sum of backoff delays —
    deterministic under an injected sleep)."""

    def __init__(self, last_exception, attempts, elapsed, why):
        self.last_exception = last_exception
        self.attempts = attempts
        self.elapsed = elapsed
        super().__init__(
            f"retries exhausted after {attempts} attempt(s) ({why}); "
            f"last error: {type(last_exception).__name__}: "
            f"{last_exception}")


class InjectedFault(RuntimeError):
    """The error a triggered fault point raises (unless the armed spec
    carries a custom exception class). Carries the point name so handlers
    can record WHICH site fired."""

    def __init__(self, point, detail=None):
        self.point = point
        self.detail = detail
        msg = f"injected fault at {point!r}"
        if detail is not None:
            msg += f" ({detail})"
        super().__init__(msg)


class FaultSpec:
    """One armed fault: fires on the nth call, with probability p per
    call (seeded — deterministic across runs), or on every call; at most
    `times` firings (None = unlimited)."""

    def __init__(self, name, nth=None, p=None, seed=0, times=None,
                 exc=None):
        if nth is not None and p is not None:
            raise ValueError("arm with nth= OR p=, not both")
        self.name = name
        self.nth = ({int(nth)} if isinstance(nth, int)
                    else {int(x) for x in nth}) if nth is not None else None
        self.p = float(p) if p is not None else None
        self.rng = random.Random(seed)
        if times is None:
            if self.nth is not None:
                times = len(self.nth)    # fire on EVERY listed call
            elif self.p is None:
                times = 1                # bare always-fire: once
            # p-mode default: unlimited
        self.remaining = times          # None = fire forever
        self.exc = exc or InjectedFault
        self.calls = 0                  # calls seen while armed
        self.fired = 0
        self._from_env = False

    def should_fire(self):
        self.calls += 1
        if self.remaining is not None and self.remaining <= 0:
            return False
        if self.nth is not None:
            fire = self.calls in self.nth
        elif self.p is not None:
            fire = self.rng.random() < self.p
        else:
            fire = True
        if fire:
            self.fired += 1
            if self.remaining is not None:
                self.remaining -= 1
        return fire

    def make_exc(self, detail=None):
        if self.exc is InjectedFault:
            return InjectedFault(self.name, detail)
        try:
            return self.exc(f"injected fault at {self.name!r}")
        except TypeError:
            return self.exc()


_LOCK = threading.RLock()
_ARMED = {}          # name -> FaultSpec
_SEEN = {}           # name -> lifetime call count (the site catalog)
_ENV_CACHE = [None]  # last-parsed PADDLE_TPU_FAULTS value
_FAULT_HOOKS = []    # observers called when a fault FIRES (telemetry)

ENV_VAR = "PADDLE_TPU_FAULTS"


def _sync_env():
    """Arm/disarm specs from PADDLE_TPU_FAULTS when it changes.
    Grammar: comma-separated entries, each `name[:key=value]*` with keys
    nth, p, seed, times. A bare `name` fires on every call."""
    s = os.environ.get(ENV_VAR, "")
    if s == _ENV_CACHE[0]:
        return
    for name in [n for n, sp in _ARMED.items() if sp._from_env]:
        del _ARMED[name]
    _ENV_CACHE[0] = s
    for entry in filter(None, (e.strip() for e in s.split(","))):
        parts = entry.split(":")
        name, kw = parts[0], {}
        for field in parts[1:]:
            k, _, v = field.partition("=")
            if k == "nth":
                kw["nth"] = int(v)
            elif k in ("p", "probability"):
                kw["p"] = float(v)
            elif k == "seed":
                kw["seed"] = int(v)
            elif k == "times":
                kw["times"] = int(v)
            else:
                raise ValueError(
                    f"{ENV_VAR}: unknown field {k!r} in entry {entry!r} "
                    "(expected nth=/p=/seed=/times=)")
        spec = FaultSpec(name, **kw)
        spec._from_env = True
        _ARMED[name] = spec


def arm(name, nth=None, p=None, seed=0, times=None, exc=None):
    """Arm a fault at `name` (programmatic form of `inject`). Returns the
    FaultSpec (inspect .calls/.fired afterwards)."""
    with _LOCK:
        spec = FaultSpec(name, nth=nth, p=p, seed=seed, times=times,
                         exc=exc)
        _ARMED[name] = spec
        return spec


def disarm(name):
    with _LOCK:
        _ARMED.pop(name, None)


def reset():
    """Disarm everything (incl. env-armed specs until the env changes
    again — tests call this between cases)."""
    with _LOCK:
        _ARMED.clear()
        _ENV_CACHE[0] = os.environ.get(ENV_VAR, "")


def add_fault_hook(fn):
    """Register an observer called as fn(point_name, detail) whenever a
    fault point FIRES (the armed spec decided this call raises). The
    hook runs before the exception propagates and outside the harness
    lock; hook errors are swallowed — observability must never change
    fault semantics. The serving telemetry plane installs one so
    injected and real faults land in the same request timeline
    (docs/observability.md). Returns fn for decorator use."""
    with _LOCK:
        _FAULT_HOOKS.append(fn)
    return fn


def remove_fault_hook(fn):
    with _LOCK:
        try:
            _FAULT_HOOKS.remove(fn)
        except ValueError:
            pass


def fault_point(name, detail=None):
    """Declare a fault site. Raises the armed exception when a spec for
    `name` decides this call fires; otherwise ~free. `detail` (e.g. a
    request uid) rides into the raised InjectedFault. Registered fault
    hooks (add_fault_hook) observe every firing."""
    with _LOCK:
        _SEEN[name] = _SEEN.get(name, 0) + 1
        _sync_env()
        spec = _ARMED.get(name)
        if spec is None or not spec.should_fire():
            return
        hooks = list(_FAULT_HOOKS)
    for h in hooks:
        try:
            h(name, detail)
        except Exception:
            pass
    raise spec.make_exc(detail)


def fault_points():
    """Catalog: every fault-site name this process has passed through."""
    return sorted(_SEEN)


def armed():
    """{name: FaultSpec} currently armed."""
    return dict(_ARMED)


class inject:
    """Context manager: arm a fault for the scope, disarm on exit.

        with inject("ckpt.commit", nth=1):
            ...
    The armed FaultSpec is the `as` target (check .fired afterwards).
    """

    def __init__(self, name, nth=None, p=None, seed=0, times=None,
                 exc=None):
        self._args = dict(nth=nth, p=p, seed=seed, times=times, exc=exc)
        self.name = name
        self.spec = None

    def __enter__(self):
        self.spec = arm(self.name, **self._args)
        return self.spec

    def __exit__(self, *exc_info):
        with _LOCK:
            if _ARMED.get(self.name) is self.spec:
                del _ARMED[self.name]
        return False


def retry_with_backoff(fn, retries=5, base_delay=0.05, factor=2.0,
                       max_delay=2.0, retry_on=(Exception,), jitter=0.0,
                       seed=0, on_retry=None, sleep=time.sleep,
                       max_elapsed=None, raise_exhausted=False):
    """Call fn() up to retries+1 times with exponential backoff.

    Returns fn()'s value; once the budget runs out, re-raises the LAST
    error (default) or raises RetriesExhaustedError carrying it
    (raise_exhausted=True — the router's quarantine probes use this so
    callers can catch ONE typed error instead of `retry_on`).

    `retry_on` bounds what is retryable (everything else propagates
    immediately). `jitter` adds up to jitter*delay of seeded
    (deterministic) random spread — same seed, same schedule, always.
    `max_elapsed` caps the TOTAL backoff budget: when the delays slept
    so far plus the next delay would exceed it, the helper stops
    retrying and raises RetriesExhaustedError (elapsed is the sum of
    scheduled delays, so the cap stays deterministic under an injected
    sleep). `sleep` is injectable so tests assert the delay schedule
    without waiting it out; `on_retry(attempt, exc, delay)` is the
    observability hook.
    """
    if retries < 0:
        raise ValueError(f"retries must be >= 0, got {retries}")
    rng = random.Random(seed)
    delay = float(base_delay)
    elapsed = 0.0
    for attempt in range(retries + 1):
        try:
            return fn()
        except retry_on as e:
            if attempt == retries:
                if raise_exhausted:
                    raise RetriesExhaustedError(
                        e, attempt + 1, elapsed,
                        f"retry budget of {retries} spent") from e
                raise
            d = min(delay, max_delay)
            if jitter:
                d += rng.random() * jitter * d
            if max_elapsed is not None and elapsed + d > max_elapsed:
                raise RetriesExhaustedError(
                    e, attempt + 1, elapsed,
                    f"max_elapsed={max_elapsed}s cap hit") from e
            if on_retry is not None:
                on_retry(attempt + 1, e, d)
            sleep(d)
            elapsed += d
            delay *= factor
