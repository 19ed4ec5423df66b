"""Parallel environment and rendezvous.

Counterpart of `paddle_tpu/distributed/parallel_env.py` (ref:
python/paddle/distributed/parallel.py:60 ParallelEnv, :318
init_parallel_env). The env-var contract is the reference's:
PADDLE_TRAINER_ID (rank), PADDLE_TRAINERS_NUM (world size),
FLAGS_selected_gpus (the rank's card), PADDLE_TRAINER_ENDPOINTS /
PADDLE_CURRENT_ENDPOINT, and MASTER_ADDR / MASTER_PORT for the rendezvous.

A world above 1 rendezvouses through the port's TCPStore
(`distributed/store.py`), hosted by rank 0 on MASTER_PORT + 1 as in the
reference; the connect retries through `failsafe.retry_with_backoff` behind
the `dist.store_init` fault point. Every rank publishes where its tensors
live ("<host>/cpu" or "<host>/cuda:<i>") under `init/device/<rank>`, then
`init_ready`, then one `torch.distributed.init_process_group` over a
`PrefixStore` of the same store, with the backend `choose_backend` reads off
that map, then `init/done/<rank>` and `init_done`. `torch.distributed`
takes the place of `jax.distributed.initialize`. A failed
`init_process_group` raises the backend's own error on every rank: the
failing rank posts `init/failed/<rank>`, and rank 0 keeps the store up
until every rank has posted "done" or "failed" (bounded by the store's
timeout), so no peer loses the store mid-rendezvous; nothing retries on
another backend. A world of 1 does no rendezvous.

The rank's device is `init_parallel_env(device=)`: CUDA (the card
FLAGS_selected_gpus names, else the current one) unless the caller asks for
the CPU; without a CUDA device and without that request it raises.
"""
import datetime
import os
import socket
import time

import torch

from .. import resolve_device

_state = {"initialized": False, "store": None, "device": None}


def _env_device_id():
    return int(os.getenv("FLAGS_selected_gpus", "0").split(",")[0] or 0)


class ParallelEnv:
    """ref: parallel.py:60 — the env-var contract."""

    def __init__(self):
        self._rank = int(os.getenv("PADDLE_TRAINER_ID", "0"))
        self._world_size = int(os.getenv("PADDLE_TRAINERS_NUM", "1"))
        self._device_id = _env_device_id()
        eps = os.getenv("PADDLE_TRAINER_ENDPOINTS", "")
        self._trainer_endpoints = eps.split(",") if eps else []
        self._current_endpoint = os.getenv("PADDLE_CURRENT_ENDPOINT", "")

    @property
    def rank(self):
        if _state["initialized"] and _torch_initialized():
            return torch.distributed.get_rank()
        return self._rank

    @property
    def world_size(self):
        if _state["initialized"] and _torch_initialized():
            return torch.distributed.get_world_size()
        return self._world_size

    @property
    def device_id(self):
        return self._device_id

    @property
    def local_rank(self):
        return int(os.getenv("PADDLE_LOCAL_RANK", str(self._device_id)))

    @property
    def current_endpoint(self):
        return self._current_endpoint

    @property
    def trainer_endpoints(self):
        return self._trainer_endpoints

    @property
    def nranks(self):
        return self.world_size

    @property
    def local_device_count(self):
        """The cards this host shows (1 on a host without CUDA: its CPU)."""
        return torch.cuda.device_count() or 1


def _torch_initialized():
    return torch.distributed.is_available() and torch.distributed.is_initialized()


def _rank_device(device, env):
    if device is None:
        device = f"cuda:{env.device_id}"
    return resolve_device(device)


def device_tag(device):
    """What a rank publishes of where its tensors live: "<host>/<device>"."""
    return f"{socket.gethostname()}/{torch.device(device)}"


def choose_backend(devices):
    """The process group's backend from the ranks' devices, in rank order
    (`device_tag` strings, "<host>/cpu" or "<host>/cuda:<i>"; the host part
    may be left out):

      - "gloo" when a rank's tensors live on the CPU (NCCL carries CUDA
        tensors only);
      - "nccl" when every rank owns a distinct CUDA device;
      - "gloo" when CUDA ranks share a device (NCCL takes one rank per
        device): two ranks on one card.
    """
    kinds = [d.rsplit("/", 1)[-1] for d in devices]
    if any(not k.startswith("cuda") for k in kinds):
        return "gloo"
    if len(set(devices)) == len(devices):
        return "nccl"
    return "gloo"


def _master():
    env = ParallelEnv()
    master, port = os.getenv("MASTER_ADDR"), os.getenv("MASTER_PORT")
    if (not master or not port) and env.trainer_endpoints:
        master, port = env.trainer_endpoints[0].rsplit(":", 1)
    if not master or not port:
        raise RuntimeError(
            "init_parallel_env: a world above 1 needs MASTER_ADDR and "
            "MASTER_PORT (or PADDLE_TRAINER_ENDPOINTS) for the rendezvous")
    return master, int(port)


def init_parallel_env(strategy=None, device=None):
    """ref: parallel.py:318 — env parse -> TCPStore (:489) -> process group
    -> barrier. Returns the ParallelEnv; a second call returns at once."""
    if _state["initialized"]:
        return ParallelEnv()
    env = ParallelEnv()
    dev = _rank_device(device, env)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    world = env.world_size
    if world > 1:
        import torch.distributed as tdist
        from ..failsafe import fault_point, retry_with_backoff
        from .store import TCPStore
        master, port = _master()
        rank = env.rank

        def _connect():
            fault_point("dist.store_init")
            return TCPStore(master, port + 1, world_size=world,
                            is_master=(rank == 0), timeout=120)

        # only the connect retries: the counter barriers are not
        # idempotent (each call counts a rank), so they run once a rank
        store = retry_with_backoff(
            _connect,
            retries=int(os.getenv("PADDLE_STORE_RETRIES", "3")),
            base_delay=float(os.getenv("PADDLE_STORE_BACKOFF", "0.25")),
            max_delay=5.0)
        store.set(f"init/device/{rank}", device_tag(dev))
        store.barrier("init_ready", world)
        devices = [store.get(f"init/device/{r}").decode()
                   for r in range(world)]
        backend = choose_backend(devices)
        try:
            tdist.init_process_group(
                backend, store=tdist.PrefixStore("pg", store._store),
                rank=rank, world_size=world,
                timeout=datetime.timedelta(seconds=600))
        except Exception as e:
            _init_failed(store, rank, world, e)
            raise
        store.set(f"init/done/{rank}", b"1")
        store.barrier("init_done", world)
        _state["store"] = store
    _state.update(initialized=True, device=dev)
    from . import collective
    # a verb called before init made a world group of 1
    collective._world_group[0] = None
    collective._ensure_world_group()
    return env


def _init_failed(store, rank, world, err):
    """A failed `init_process_group` on `rank`: post `init/failed/<rank>`;
    the store's host (rank 0) then waits, bounded by the store's timeout,
    until every rank has posted "done" or "failed" before it retires the
    store, so a peer still reading its rendezvous keys never loses the
    store under it and raises its own backend error too. Nothing
    retries."""
    from .store import retire
    try:
        store.set(f"init/failed/{rank}", f"{type(err).__name__}: {err}")
    except Exception:       # the host is gone: the caller's error stands
        pass
    if rank == 0:
        deadline = time.monotonic() + store._timeout.total_seconds()
        left = set(range(world))
        while left and time.monotonic() < deadline:
            left = {r for r in left
                    if not store.check(f"init/done/{r}")
                    and not store.check(f"init/failed/{r}")}
            if left:
                time.sleep(0.05)
    retire(store)


def get_store():
    """The world TCPStore of init_parallel_env (None for a world of 1): it
    carries the object collectives."""
    return _state["store"]


def get_device():
    """The device this rank's tensors live on (None before init)."""
    return _state["device"]


def get_backend():
    """The live torch.distributed backend's name; None without one (a world
    of 1, or before init)."""
    if _torch_initialized():
        return torch.distributed.get_backend()
    return None


def is_initialized():
    return _state["initialized"]


def _reset():
    """Drop the process group and the store (destroy_process_group())."""
    from .store import retire
    if _torch_initialized():
        torch.distributed.destroy_process_group()
    retire(_state["store"])
    _state.update(initialized=False, store=None, device=None)


def get_rank(group=None):
    if group is not None:
        return group.rank
    return ParallelEnv().rank


def get_world_size(group=None):
    if group is not None:
        return group.nranks
    return ParallelEnv().world_size
