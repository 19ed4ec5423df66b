"""Fleet (collective mode), counterpart of `paddle_tpu/distributed/fleet/`
(ref: python/paddle/distributed/fleet/fleet.py:101): `fleet.init` builds
the topology and the hybrid communicate group; `distributed_model` /
`distributed_optimizer` pick the data- or tensor-parallel wrapper; the
tensor-parallel layers are `meta_parallel`. The other modes, the
parameter server and the datasets are ROADMAP A8.6-A8.15."""
from .distributed_strategy import DistributedStrategy  # noqa: F401
from .fleet_base import (Fleet, FleetModeError, init,  # noqa: F401
                         get_hybrid_communicate_group, distributed_model,
                         distributed_optimizer, worker_index, worker_num,
                         is_first_worker, fleet_instance)
from .utils import hybrid_parallel_util  # noqa: F401
from . import meta_parallel, meta_optimizers  # noqa: F401
from ..topology import (CommunicateTopology,  # noqa: F401
                        HybridCommunicateGroup)
