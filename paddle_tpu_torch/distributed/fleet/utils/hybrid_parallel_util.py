"""Cross-wrapper glue of the data-parallel axis.

Counterpart of `paddle_tpu/distributed/fleet/utils/hybrid_parallel_util.py`
(ref: python/paddle/distributed/fleet/utils/hybrid_parallel_util.py —
broadcast_dp_parameters:186, fused_allreduce_gradients:206). The reference
holds one logical copy of every parameter, so its broadcasts are identity;
here every rank holds its own, so `broadcast_dp_parameters` broadcasts each
parameter from the data-parallel group's first rank.

The functions of the other axes (tensor A8.5, sequence A8.6, sharding
A8.8) have nothing to do while their axis has one rank, and raise
`HybridAxisError` naming their ROADMAP item when it has more.
"""
import torch

from ...collective import ReduceOp, all_reduce, broadcast


class HybridAxisError(NotImplementedError):
    """A hybrid axis above 1 whose parallelism is not ported yet."""


def _axis_refused(fn, axis, item):
    return HybridAxisError(
        f"{fn}: the {axis} axis above 1 is not ported yet (ROADMAP {item})")


def _degree(hcg, getter):
    return 1 if hcg is None else int(getattr(hcg, getter)())


def broadcast_input_data(hcg, *inputs, **kwargs):
    if _degree(hcg, "get_model_parallel_world_size") > 1:
        raise _axis_refused("broadcast_input_data", "model", "A8.5")
    return inputs if not kwargs else (inputs, kwargs)


def broadcast_mp_parameters(model, hcg):
    if _degree(hcg, "get_model_parallel_world_size") > 1:
        raise _axis_refused("broadcast_mp_parameters", "model", "A8.5")


@torch.no_grad()
def broadcast_dp_parameters(model, hcg):
    """Every parameter from the data-parallel group's first rank to the
    group: the ranks start from one state."""
    group = hcg.get_data_parallel_group() if hcg is not None else None
    if group is None or group.nranks <= 1:
        return
    src = hcg.get_data_parallel_group_src_rank()
    for p in model.parameters():
        broadcast(p.data, src=src, group=group)


def broadcast_sharding_parameters(model, hcg):
    if _degree(hcg, "get_sharding_parallel_world_size") > 1:
        raise _axis_refused("broadcast_sharding_parameters", "sharding",
                            "A8.8")


def broadcast_sep_parameters(model, hcg):
    if _degree(hcg, "get_sep_parallel_world_size") > 1:
        raise _axis_refused("broadcast_sep_parameters", "sep", "A8.6")


@torch.no_grad()
def fused_allreduce_gradients(parameter_list, hcg, compress=None,
                              compress_chunk=None):
    """ref: :206 — average the gradients over the data-parallel group.

    compress="int8": each average rides the chunked int8 all-reduce
    (stateless: no error feedback; EagerReducer carries it). The
    reference's second half, summing sequence-parallel parameters' grads
    over the model axis, is ROADMAP A8.6 and raises."""
    if compress not in (None, "int8"):
        raise ValueError(f"compress must be None or 'int8', got "
                         f"{compress!r}")
    params = list(parameter_list)
    if any(getattr(p, "sequence_parallel", False) for p in params):
        raise _axis_refused("fused_allreduce_gradients", "sequence", "A8.6")
    group = hcg.get_data_parallel_group() if hcg is not None else None
    if group is not None and group.nranks > 1:
        for p in params:
            if p.grad is not None:
                all_reduce(p.grad, op=ReduceOp.AVG, group=group,
                           compress=compress, compress_chunk=compress_chunk)


def sharding_reduce_gradients(parameter_list, hcg):
    if _degree(hcg, "get_sharding_parallel_world_size") > 1:
        raise _axis_refused("sharding_reduce_gradients", "sharding", "A8.8")
    fused_allreduce_gradients(parameter_list, hcg)
