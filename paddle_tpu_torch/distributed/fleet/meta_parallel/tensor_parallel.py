"""TensorParallel (ref: python/paddle/distributed/fleet/meta_parallel/
tensor_parallel.py:27), counterpart of the reference's wrapper.

The reference is one controller: its `forward` runs the wrapped layers as
one SPMD region over the mesh (`meta_parallel/spmd.py:68 spmd_forward`)
and has nothing to broadcast. Here each model-parallel rank is a process
running its own forward over its shards, as in Paddle, so `spmd_forward`
has no counterpart: the wrapper broadcasts the replicated parameters over
the model-parallel group (`broadcast_mp_parameters`) and every parameter
over the data-parallel group (`broadcast_dp_parameters`) once, at
construction, then runs the layers; the layers' collectives do the rest.
"""
from .meta_parallel_base import MetaParallelBase


class TensorParallel(MetaParallelBase):
    def _prepare_for_model(self):
        from ..utils.hybrid_parallel_util import (broadcast_dp_parameters,
                                                  broadcast_mp_parameters)
        broadcast_mp_parameters(self._layers, self._hcg)
        broadcast_dp_parameters(self._layers, self._hcg)

    def forward(self, *inputs, **kwargs):
        """The inputs from the model-parallel group's first rank to the
        group (`broadcast_input_data`), then the layers."""
        from ..utils.hybrid_parallel_util import broadcast_input_data
        out = broadcast_input_data(self._hcg, *inputs, **kwargs)
        inputs, kwargs = (out, {}) if not kwargs else out
        return self._layers(*inputs, **kwargs)
