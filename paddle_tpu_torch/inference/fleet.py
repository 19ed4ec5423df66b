"""Process-backed replica fleet: the error types the router already catches.

Counterpart of the error classes of `paddle_tpu/inference/fleet.py`. The
process fleet itself (the worker-side `EngineHost`, the RPC-backed
`ProcessReplica`, the respawn governor, `FleetHandle`) is not ported yet
(ROADMAP A7.8); `EngineRouter` catches these two types, so they live where
that module will define them.
"""
from .scheduler import SchedulerError


class FleetRPCError(SchedulerError):
    """A fleet RPC failed at the transport level (connect refused, peer
    closed, deadline) — the signal the router treats as a replica
    failure."""


class ReplicaCrashLoopError(SchedulerError):
    """A worker hit its respawn circuit-breaker cap: every respawn died
    again before a clean probe. The replica stays quarantined until an
    operator (or the autoscale controller) replaces it; the router counts
    these as `crash_loops`."""
