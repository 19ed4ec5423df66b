"""paddle_tpu_torch.failsafe against paddle_tpu.failsafe.

Replays tests/test_failsafe.py (nth-call and seeded-probabilistic
triggers, environment and context activation, scoping, the bounded
retry/backoff schedule) on the port's module, and holds the two packages
to each other: the same `inject(p=..., seed=...)` fires on the same calls
in both, and the one environment variable arms both the same way while
their registries stay separate. Every comparison is exact (firing
sequences, delay schedules, call counts).
"""
import os

import pytest

from paddle_tpu import failsafe as jfs
from paddle_tpu_torch import failsafe
from paddle_tpu_torch.failsafe import (InjectedFault, fault_point, inject,
                                       retry_with_backoff)


@pytest.fixture(autouse=True)
def _clean():
    failsafe.reset()
    jfs.reset()
    yield
    os.environ.pop(failsafe.ENV_VAR, None)
    failsafe.reset()
    jfs.reset()


def _pattern(mod, name, n=60, **kw):
    """Which of n calls to `name` fire under mod.inject(name, **kw)."""
    out = []
    with mod.inject(name, **kw):
        for _ in range(n):
            try:
                mod.fault_point(name)
                out.append(0)
            except mod.InjectedFault:
                out.append(1)
    return out


# ---------------------------------------------------- the two packages
@pytest.mark.parametrize("kw", [dict(p=0.3, seed=7, times=None),
                                dict(p=0.05, seed=11, times=None),
                                dict(p=0.5, seed=3, times=4),
                                dict(nth=[2, 9, 31]), dict(nth=5),
                                dict()])
def test_firing_sequence_equals_reference(kw):
    """Exact: the same spec fires on the same calls in both packages."""
    ref = _pattern(jfs, "t.same", **kw)
    got = _pattern(failsafe, "t.same", **kw)
    assert got == ref and sum(got) > 0


def test_registries_are_separate():
    """Arming the port's site leaves the reference's site silent, and the
    other way round."""
    with inject("t.sep"):
        jfs.fault_point("t.sep")
        with pytest.raises(InjectedFault):
            fault_point("t.sep")
    with jfs.inject("t.sep2"):
        fault_point("t.sep2")
        with pytest.raises(jfs.InjectedFault):
            jfs.fault_point("t.sep2")


def test_env_arms_both_packages_the_same_way():
    """One PADDLE_TPU_FAULTS value arms both packages: each fires on its
    own second call."""
    assert failsafe.ENV_VAR == jfs.ENV_VAR == "PADDLE_TPU_FAULTS"
    os.environ[failsafe.ENV_VAR] = "t.both:nth=2"
    fired = {}
    for name, mod in (("port", failsafe), ("ref", jfs)):
        fired[name] = []
        for i in range(1, 5):
            try:
                mod.fault_point("t.both")
            except mod.InjectedFault:
                fired[name].append(i)
    assert fired == {"port": [2], "ref": [2]}


def test_fault_hook_sees_firings():
    seen = []

    def hook(point, detail):
        seen.append((point, detail))

    failsafe.add_fault_hook(hook)
    try:
        with inject("t.hook"):
            with pytest.raises(InjectedFault):
                fault_point("t.hook", detail="uid=3")
        fault_point("t.hook")
    finally:
        failsafe.remove_fault_hook(hook)
    assert seen == [("t.hook", "uid=3")]


# ----------------------------------------- tests/test_failsafe.py replay
class TestFaultPoint:
    def test_disarmed_is_silent(self):
        for _ in range(10):
            fault_point("t.noop")
        assert "t.noop" in failsafe.fault_points()

    def test_nth_call_fires_exactly_once(self):
        fired = []
        with inject("t.nth", nth=3) as spec:
            for i in range(1, 7):
                try:
                    fault_point("t.nth")
                except InjectedFault:
                    fired.append(i)
        assert fired == [3]
        assert spec.calls == 6 and spec.fired == 1

    def test_always_fires_once_by_default(self):
        with inject("t.always"):
            with pytest.raises(InjectedFault, match="t.always"):
                fault_point("t.always")
            fault_point("t.always")          # default times=1: spent

    def test_multi_nth_fires_on_every_listed_call(self):
        assert _pattern(failsafe, "t.multi", n=7, nth=[2, 5]) == \
            [0, 1, 0, 0, 1, 0, 0]

    def test_times_bounds_firings(self):
        assert sum(_pattern(failsafe, "t.times", n=5, p=1.0,
                            times=2)) == 2

    def test_seeded_probability_is_deterministic(self):
        a = _pattern(failsafe, "t.prob", n=50, p=0.3, seed=7, times=None)
        b = _pattern(failsafe, "t.prob", n=50, p=0.3, seed=7, times=None)
        assert a == b and sum(a) > 0
        assert _pattern(failsafe, "t.prob", n=50, p=0.3, seed=8,
                        times=None) != a

    def test_scope_disarms_even_on_error(self):
        with pytest.raises(ValueError):
            with inject("t.scope", nth=1):
                raise ValueError("unrelated")
        fault_point("t.scope")            # disarmed: silent

    def test_custom_exception_class(self):
        with inject("t.exc", exc=OSError):
            with pytest.raises(OSError, match="t.exc"):
                fault_point("t.exc")

    def test_detail_rides_into_fault(self):
        with inject("t.detail"):
            with pytest.raises(InjectedFault, match="uid=42"):
                fault_point("t.detail", detail="uid=42")

    def test_nth_and_p_conflict(self):
        with pytest.raises(ValueError, match="not both"):
            failsafe.FaultSpec("t.bad", nth=1, p=0.5)

    def test_arm_disarm_and_armed(self):
        spec = failsafe.arm("t.arm", nth=1)
        assert failsafe.armed()["t.arm"] is spec
        failsafe.disarm("t.arm")
        fault_point("t.arm")
        assert "t.arm" not in failsafe.armed() and spec.calls == 0


class TestEnvActivation:
    def test_env_arms_and_fires(self):
        os.environ[failsafe.ENV_VAR] = "t.env:nth=2"
        try:
            fault_point("t.env")                      # call 1: silent
            with pytest.raises(InjectedFault):
                fault_point("t.env")                  # call 2: fires
            fault_point("t.env")                      # spent
        finally:
            del os.environ[failsafe.ENV_VAR]
        failsafe.reset()
        fault_point("t.env")                          # env gone: silent

    def test_env_probabilistic_with_seed(self):
        os.environ[failsafe.ENV_VAR] = "t.envp:p=1.0:seed=3:times=1"
        try:
            with pytest.raises(InjectedFault):
                fault_point("t.envp")
        finally:
            del os.environ[failsafe.ENV_VAR]

    def test_env_bad_field_raises(self):
        os.environ[failsafe.ENV_VAR] = "t.envbad:bogus=1"
        try:
            with pytest.raises(ValueError, match="bogus"):
                fault_point("t.envbad")
        finally:
            del os.environ[failsafe.ENV_VAR]
            failsafe.reset()


def _dead(exc=OSError, msg="x"):
    def fn():
        raise exc(msg)
    return fn


class TestRetryWithBackoff:
    def test_succeeds_after_transient_failures(self):
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("transient")
            return "ok"

        slept = []
        assert retry_with_backoff(flaky, retries=5, base_delay=0.1,
                                  sleep=slept.append) == "ok"
        assert len(calls) == 3
        assert slept == [0.1, 0.2]        # exponential schedule

    def test_exhausts_and_reraises_last(self):
        slept = []
        with pytest.raises(ConnectionError, match="still down"):
            retry_with_backoff(_dead(ConnectionError, "still down"),
                               retries=3, base_delay=0.05,
                               sleep=slept.append)
        assert len(slept) == 3

    def test_max_delay_caps_schedule(self):
        slept = []
        with pytest.raises(OSError):
            retry_with_backoff(_dead(), retries=4, base_delay=1.0,
                               factor=10.0, max_delay=2.5,
                               sleep=slept.append)
        assert slept == [1.0, 2.5, 2.5, 2.5]

    def test_retry_on_filters(self):
        with pytest.raises(KeyError):
            retry_with_backoff(_dead(KeyError), retries=5,
                               retry_on=(OSError,), sleep=lambda _: None)

    def test_on_retry_observability(self):
        seen = []

        def flaky():
            if len(seen) < 2:
                raise OSError("t")
            return 1

        retry_with_backoff(flaky, retries=5, base_delay=0.1,
                           on_retry=lambda n, e, d: seen.append((n, d)),
                           sleep=lambda _: None)
        assert seen == [(1, 0.1), (2, 0.2)]

    def test_negative_retries_rejected(self):
        with pytest.raises(ValueError, match="retries"):
            retry_with_backoff(lambda: 1, retries=-1)

    def test_works_with_fault_point(self):
        with inject("t.retry", nth=1):
            out = retry_with_backoff(lambda: fault_point("t.retry") or 7,
                                     retries=2, sleep=lambda _: None)
        assert out == 7

    def test_seeded_jitter_equals_reference(self):
        """Exact: the jittered schedule is the reference's for the same
        seed, and another seed spreads differently."""
        def schedule(mod, seed):
            slept = []
            with pytest.raises(OSError):
                mod.retry_with_backoff(_dead(), retries=3, base_delay=0.1,
                                       jitter=0.5, seed=seed,
                                       sleep=slept.append)
            return slept

        got = schedule(failsafe, 7)
        assert got == schedule(failsafe, 7) == schedule(jfs, 7)
        for base, d in zip([0.1, 0.2, 0.4], got):
            assert base < d <= base * 1.5
        assert schedule(failsafe, 9) != got

    def test_max_elapsed_cap_raises_typed(self):
        slept = []
        with pytest.raises(failsafe.RetriesExhaustedError) as ei:
            retry_with_backoff(_dead(ConnectionError, "still down"),
                               retries=10, base_delay=1.0, factor=2.0,
                               max_delay=100.0, max_elapsed=5.0,
                               sleep=slept.append)
        assert slept == [1.0, 2.0]
        assert isinstance(ei.value.last_exception, ConnectionError)
        assert ei.value.attempts == 3 and ei.value.elapsed == 3.0
        assert isinstance(ei.value.__cause__, ConnectionError)

    def test_raise_exhausted_types_the_budget_exit(self):
        with pytest.raises(failsafe.RetriesExhaustedError) as ei:
            retry_with_backoff(_dead(), retries=2, base_delay=0.01,
                               raise_exhausted=True, sleep=lambda _: None)
        assert ei.value.attempts == 3
        assert isinstance(ei.value.last_exception, OSError)
        with pytest.raises(OSError):
            retry_with_backoff(_dead(), retries=2, base_delay=0.01,
                               sleep=lambda _: None)
