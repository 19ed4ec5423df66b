"""The tensor-parallel layers, ops and RNG tracker (the reference's
`parallel_layers/`); its pipeline layers (`pp_layers`) are ROADMAP A8.7
and its ring attention A8.6."""
from .mp_layers import (VocabParallelEmbedding,  # noqa: F401
                        ColumnParallelLinear, RowParallelLinear,
                        ParallelCrossEntropy)
from .random import (RNGStatesTracker, get_rng_state_tracker,  # noqa: F401
                     model_parallel_random_seed)
from . import mp_ops  # noqa: F401
