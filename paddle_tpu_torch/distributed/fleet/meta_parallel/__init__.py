"""meta_parallel namespace (ref: python/paddle/distributed/fleet/
meta_parallel/__init__.py), counterpart of
`paddle_tpu/distributed/fleet/meta_parallel/`.

Ported: the tensor-parallel layers, ops and RNG tracker, `TensorParallel`
and `MetaParallelBase`. The pipeline names (`LayerDesc`,
`SharedLayerDesc`, `SegmentLayers`, `PipelineLayer`, `PipelineParallel`,
`PipelineParallelWithInterleave`) raise `MetaParallelError` naming ROADMAP
A8.7, the sharding names (`ShardingParallel`, `GroupShardedStage2`,
`GroupShardedStage3`, `GroupShardedOptimizerStage2`) A8.8.
"""
from .parallel_layers.mp_layers import (VocabParallelEmbedding,  # noqa: F401
                                        ColumnParallelLinear,
                                        RowParallelLinear,
                                        ParallelCrossEntropy)
from .parallel_layers import mp_ops  # noqa: F401
from .parallel_layers.random import (RNGStatesTracker,  # noqa: F401
                                     get_rng_state_tracker,
                                     model_parallel_random_seed)
from .meta_parallel_base import MetaParallelBase  # noqa: F401
from .tensor_parallel import TensorParallel  # noqa: F401


class MetaParallelError(NotImplementedError):
    """A meta_parallel name whose parallelism is not ported yet."""


_UNPORTED = {
    **{n: ("pipeline parallelism", "A8.7")
       for n in ("LayerDesc", "SharedLayerDesc", "SegmentLayers",
                 "PipelineLayer", "PipelineParallel",
                 "PipelineParallelWithInterleave")},
    **{n: ("sharding (ZeRO)", "A8.8")
       for n in ("ShardingParallel", "GroupShardedStage2",
                 "GroupShardedStage3", "GroupShardedOptimizerStage2")},
}


def _refused(name, what, item):
    def refuse(*args, **kwargs):
        raise MetaParallelError(
            f"meta_parallel.{name}: {what} is not ported yet (ROADMAP "
            f"{item})")
    refuse.__name__ = refuse.__qualname__ = name
    return refuse


for _n, (_what, _item) in _UNPORTED.items():
    globals()[_n] = _refused(_n, _what, _item)
del _n, _what, _item
