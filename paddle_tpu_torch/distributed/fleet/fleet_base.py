"""The Fleet singleton (collective mode).

Counterpart of `paddle_tpu/distributed/fleet/fleet_base.py` (ref:
python/paddle/distributed/fleet/fleet.py:101 Fleet; init:169,
_init_hybrid_parallel_env:385, distributed_optimizer:1044; wrapper
selection ref: fleet/model.py:30,126-165). `init(is_collective=True)`
brings the process group up (`init_parallel_env`) and builds the topology
and the hybrid communicate group exactly as the reference does; each rank
is one device, so the reference's device count is the world size here
(the default, with no degree given, is all data parallel).

`distributed_model` returns `DataParallel` in the "data_parallel" mode and
`TensorParallel` in the "tensor_parallel" mode; `distributed_optimizer`
returns the optimizer unchanged in the first and `HybridParallelOptimizer`
in the second (ref: fleet_base.py:95-122). The other modes raise
`FleetModeError` naming their ROADMAP item: pipeline parallel A8.7,
sharding A8.8; so does the `mesh` property with an axis above 1 (the
device mesh, A8.10) and the parameter-server mode, `is_collective=False`
(A8.12).

A world above 1 must equal the topology's size. A world of 1 takes any
degrees (BERT config 2's dp 8 on one process): nothing crosses a wire, and
`DataParallel` passes through.
"""
from ..parallel_env import get_rank, get_world_size, init_parallel_env
from ..topology import CommunicateTopology, HybridCommunicateGroup
from .distributed_strategy import DistributedStrategy

HYBRID_AXES = ("data", "pipe", "sharding", "model")

_MODE_ITEMS = {"pipeline_parallel": "A8.7", "sharding_parallel": "A8.8"}
_PORTED_MODES = ("data_parallel", "tensor_parallel")


class FleetModeError(NotImplementedError):
    """A Fleet mode or feature whose modules are not ported yet."""


def _ps_refused(what):
    return FleetModeError(
        f"fleet {what}: the parameter server (`ps/`, fleet.init("
        f"is_collective=False)) is not ported yet (ROADMAP A8.12)")


class Fleet:
    def __init__(self):
        self._is_initialized = False
        self._hcg = None
        self._topology = None
        self._strategy = None

    def init(self, role_maker=None, is_collective=True, strategy=None,
             device=None):
        """ref: fleet.py:169 + _init_hybrid_parallel_env:385. `device` is
        this rank's (init_parallel_env's): CUDA unless asked for the CPU."""
        if not is_collective:
            raise _ps_refused("init(is_collective=False)")
        self._strategy = strategy or DistributedStrategy()
        init_parallel_env(device=device)
        hc = self._strategy.hybrid_configs
        dp, mp = int(hc["dp_degree"]), int(hc["mp_degree"])
        pp, sh = int(hc["pp_degree"]), int(hc["sharding_degree"])
        sep = int(hc.get("sep_degree", 1))
        ndev = get_world_size()
        degrees = {"data": dp, "pipe": pp, "sharding": sh, "model": mp}
        specified = dp * mp * pp * sh * sep
        if specified <= 1 < ndev and dp == 1:
            # default: everything data parallel, as the reference
            degrees["data"] = ndev if specified == 1 else dp
        names = list(HYBRID_AXES)
        dims = [degrees[n] for n in names]
        if sep > 1:
            names.append("sep")
            dims.append(sep)
        self._topology = CommunicateTopology(names, dims)
        if ndev > 1 and self._topology.world_size() != ndev:
            raise ValueError(
                f"fleet.init: the hybrid degrees {dict(zip(names, dims))} "
                f"make {self._topology.world_size()} ranks, but the world "
                f"has {ndev}")
        self._hcg = HybridCommunicateGroup(self._topology)
        self._is_initialized = True
        return self

    @property
    def is_initialized(self):
        return self._is_initialized

    def get_hybrid_communicate_group(self):
        return self._hcg

    @property
    def strategy(self):
        return self._strategy

    @property
    def mesh(self):
        """None while every axis is 1; a device mesh over axes above 1 is
        ROADMAP A8.10."""
        if self._topology is not None and any(
                self._topology.get_dim(n) > 1
                for n in self._topology.get_hybrid_group_names()):
            raise FleetModeError(
                "fleet.mesh: a device mesh over hybrid axes above 1 is not "
                "ported yet (ROADMAP A8.10)")
        return None

    def worker_index(self):
        return get_rank()

    def worker_num(self):
        return get_world_size()

    def is_first_worker(self):
        return get_rank() == 0

    def barrier_worker(self):
        from ..collective import barrier
        barrier()

    def _require_ported_mode(self, what):
        mode = self._hcg.get_parallel_mode()
        if mode not in _PORTED_MODES:
            raise FleetModeError(
                f"fleet.{what}: the {mode} mode is not ported yet (ROADMAP "
                f"{_MODE_ITEMS[mode]})")
        return mode

    def distributed_model(self, model):
        """Wrapper selection (ref: fleet/model.py:126-165)."""
        from ..parallel import DataParallel
        from .meta_parallel import TensorParallel
        mode = self._require_ported_mode("distributed_model")
        if mode == "tensor_parallel":
            return TensorParallel(model, self._hcg, strategy=self._strategy)
        return DataParallel(model, group=self._hcg.get_data_parallel_group())

    def distributed_optimizer(self, optimizer, strategy=None):
        """ref: fleet.py:1044 — data parallel needs no wrapper (the
        gradients are averaged before the optimizer sees them); tensor
        parallel takes `HybridParallelOptimizer`."""
        if self._hcg is None:
            return optimizer
        if self._require_ported_mode("distributed_optimizer") == \
                "data_parallel":
            return optimizer
        from .meta_optimizers import HybridParallelOptimizer
        return HybridParallelOptimizer(optimizer, self._hcg,
                                       strategy or self._strategy)

    # the parameter-server lifecycle (ref: fleet.py:679, :780)
    def init_server(self, *args, **kwargs):
        raise _ps_refused("init_server")

    def run_server(self):
        raise _ps_refused("run_server")

    def stop_server(self):
        raise _ps_refused("stop_server")

    def init_worker(self):
        raise _ps_refused("init_worker")


fleet_instance = Fleet()


def init(role_maker=None, is_collective=True, strategy=None, device=None):
    return fleet_instance.init(role_maker, is_collective, strategy, device)


def get_hybrid_communicate_group():
    return fleet_instance.get_hybrid_communicate_group()


def distributed_model(model):
    return fleet_instance.distributed_model(model)


def distributed_optimizer(optimizer, strategy=None):
    return fleet_instance.distributed_optimizer(optimizer, strategy)


def worker_index():
    return fleet_instance.worker_index()


def worker_num():
    return fleet_instance.worker_num()


def is_first_worker():
    return fleet_instance.is_first_worker()
