"""Hybrid-parallel topology.

Counterpart of `paddle_tpu/distributed/topology.py` (ref:
python/paddle/distributed/fleet/base/topology.py — CommunicateTopology:53,
HybridCommunicateGroup:139). The coordinate math is the reference's,
unchanged: the same four axes (data, pipe, sharding, model), the same rank
order, the same comm lists. The per-axis groups are the port's
`new_group`s over each axis's ranks (process groups among their members;
the reference tags them with their mesh axis, which needs the device mesh
of ROADMAP A8.10, so here they carry none).
"""
import itertools

import numpy as np

from .collective import new_group
from .parallel_env import get_rank, get_world_size


class ParallelMode:
    """ref: topology.py:28 — the hybrid-parallel mode ids."""

    DATA_PARALLEL = 0
    TENSOR_PARALLEL = 1
    PIPELINE_PARALLEL = 2
    SHARDING_PARALLEL = 3


class CommunicateTopology:
    """ref: topology.py:53."""

    def __init__(self, hybrid_group_names=("data", "pipe", "sharding", "model"),
                 dims=(1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(int(d) for d in dims)
        self.coordinate = collections_namedtuple("Coordinate",
                                                 self._parallel_names)
        self._world_size = int(np.prod(self._dims))
        ranges = [range(d) for d in self._dims]
        all_coords = [self.coordinate(*c) for c in itertools.product(*ranges)]
        self._coord2rank = dict(zip(all_coords, range(len(all_coords))))
        self._rank2coord = dict(zip(self._coord2rank.values(),
                                    self._coord2rank.keys()))

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return self._world_size

    def get_rank(self, **args):
        assert len(args) == len(self._dims)
        key = self.coordinate(**args)
        return self._coord2rank[key]

    def get_coord(self, rank):
        return self._rank2coord[rank]

    def get_axis_list(self, axis_name, index):
        """All ranks whose coordinate on axis_name == index."""
        axis = self._parallel_names.index(axis_name)
        ranks = [self._coord2rank[c] for c in self._coord2rank
                 if c[axis] == index]
        return sorted(ranks)

    def get_comm_list(self, axis_name):
        """List of rank-groups along axis_name (one group per setting of the
        other axes) — ref: topology.py get_comm_list."""
        assert axis_name in self._parallel_names
        other_axis_names = [n for n in self._parallel_names if n != axis_name]
        ranges = [range(self.get_dim(n)) for n in other_axis_names]
        all_result = []
        for x in itertools.product(*ranges):
            key_coord = dict(zip(other_axis_names, x))
            result = []
            for i in range(self.get_dim(axis_name)):
                key_coord[axis_name] = i
                result.append(self._coord2rank[self.coordinate(**key_coord)])
            all_result.append(result)
        return all_result

    def get_rank_from_stage(self, global_rank, **kwargs):
        coord = self.get_coord(global_rank)
        tf = coord._replace(**kwargs)._asdict()
        return self.get_rank(**tf)


def collections_namedtuple(name, fields):
    import collections
    return collections.namedtuple(name, fields)


class HybridCommunicateGroup:
    """ref: topology.py:139 — per-axis groups + check group."""

    def __init__(self, topology):
        self._topo = topology
        self.global_rank = get_rank()
        self._dp_degree = self._topo.get_dim("data")
        self._mp_degree = self._topo.get_dim("model")
        self._pp_degree = self._topo.get_dim("pipe")
        self._sharding_degree = self._topo.get_dim("sharding")
        self._sep_degree = (self._topo.get_dim("sep")
                            if "sep" in self._topo.get_hybrid_group_names()
                            else 1)

        self._data_parallel_id = self._get_id_on_axis("data")
        self._model_parallel_id = self._get_id_on_axis("model")
        self._sharding_parallel_id = self._get_id_on_axis("sharding")
        self.stage_id = self._get_id_on_axis("pipe")

        # per-axis groups
        self._dp_group = self._create_axis_group("data")
        self._mp_group = self._create_axis_group("model")
        self._pp_group = self._create_axis_group("pipe")
        self._sharding_group = self._create_axis_group("sharding")
        self._sep_group = (self._create_axis_group("sep")
                           if self._sep_degree > 1 else None)
        # check group spans everything (amp inf/nan vote —
        # ref: topology.py:181)
        self._check_group = new_group(list(range(self._topo.world_size())))

    def _get_id_on_axis(self, axis):
        if self._topo.world_size() == 1:
            return 0
        coord = self._topo.get_coord(self.global_rank % self._topo.world_size())
        return getattr(coord, axis)

    def _create_axis_group(self, axis):
        comm_lists = self._topo.get_comm_list(axis)
        my = self.global_rank % self._topo.world_size()
        for ranks in comm_lists:
            if my in ranks:
                return new_group(ranks)
        return new_group(comm_lists[0])

    def get_parallel_mode(self):
        if (self._mp_degree == 1 and self._pp_degree == 1
                and self._sharding_degree == 1 and self._dp_degree > 1):
            return "data_parallel"
        if self._sharding_degree > 1 and self._mp_degree == 1 \
                and self._pp_degree == 1:
            return "sharding_parallel"
        if self._mp_degree > 1 and self._pp_degree == 1:
            return "tensor_parallel"
        if self._pp_degree > 1:
            return "pipeline_parallel"
        return "data_parallel"

    def topology(self):
        return self._topo

    def get_global_rank(self):
        return self.global_rank

    # data parallel
    def get_data_parallel_rank(self):
        return self._data_parallel_id

    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_data_parallel_group(self):
        return self._dp_group

    def get_data_parallel_group_src_rank(self):
        return self._dp_group.ranks[0]

    # model (tensor) parallel
    def get_model_parallel_rank(self):
        return self._model_parallel_id

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_model_parallel_group(self):
        return self._mp_group

    def get_model_parallel_group_src_rank(self):
        return self._mp_group.ranks[0]

    # pipeline
    def get_stage_id(self):
        return self.stage_id

    def get_pipe_parallel_rank(self):
        return self.stage_id

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_pipe_parallel_group(self):
        return self._pp_group

    def is_first_stage(self):
        return self.stage_id == 0

    def is_last_stage(self):
        return self.stage_id == self._pp_degree - 1

    # sharding
    def get_sharding_parallel_rank(self):
        return self._sharding_parallel_id

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_sharding_parallel_group(self):
        return self._sharding_group

    def get_sharding_parallel_group_src_rank(self):
        return self._sharding_group.ranks[0]

    # sep (sequence / context parallel)
    def get_sep_parallel_rank(self):
        return self._get_id_on_axis("sep") if self._sep_degree > 1 else 0

    def get_sep_parallel_world_size(self):
        return self._sep_degree

    def get_sep_parallel_group(self):
        return self._sep_group

    # check
    def get_check_parallel_group(self, sharding=False):
        return self._check_group

    def get_rank_from_stage(self, stage_id, **kwargs):
        return self._topo.get_rank_from_stage(self.global_rank,
                                              pipe=stage_id, **kwargs)

    # p2p neighbors (ref: topology.py:289)
    def get_p2p_groups(self):
        return None

    @property
    def prev_rank(self):
        return (self.stage_id - 1) % self._pp_degree

    @property
    def next_rank(self):
        return (self.stage_id + 1) % self._pp_degree
