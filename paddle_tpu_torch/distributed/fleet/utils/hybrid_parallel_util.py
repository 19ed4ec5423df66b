"""Cross-wrapper glue of the data- and model-parallel axes.

Counterpart of `paddle_tpu/distributed/fleet/utils/hybrid_parallel_util.py`
(ref: python/paddle/distributed/fleet/utils/hybrid_parallel_util.py —
broadcast_input_data:96, broadcast_mp_parameters:168,
broadcast_dp_parameters:186, fused_allreduce_gradients:206). The
reference holds one logical copy of every parameter and input, so its
broadcasts are identity (ref :14-20); here every rank holds its own:
`broadcast_dp_parameters` broadcasts each parameter from the
data-parallel group's first rank, `broadcast_mp_parameters` each
replicated parameter (one whose `is_distributed` is not set: norms,
row-parallel biases, GPT's position table) from the model-parallel
group's first rank, and `broadcast_input_data` each tensor input over the
model-parallel group, in place.

The functions of the other axes (sequence A8.6, sharding A8.8) have
nothing to do while their axis has one rank, and raise `HybridAxisError`
naming their ROADMAP item when it has more.
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


def _mp_group(hcg):
    """The model-parallel group when it spans more than one process."""
    from ...parallel_env import get_world_size
    group = hcg.get_model_parallel_group() if hcg is not None else None
    if group is None or group.nranks <= 1 or get_world_size() <= 1:
        return None
    return group


@torch.no_grad()
def broadcast_input_data(hcg, *inputs, **kwargs):
    """Every tensor input (positional and keyword) from the model-parallel
    group's first rank to the group, in place."""
    group = _mp_group(hcg)
    if group is not None:
        src = hcg.get_model_parallel_group_src_rank()
        for t in list(inputs) + list(kwargs.values()):
            if isinstance(t, torch.Tensor):
                broadcast(t, src=src, group=group)
    return inputs if not kwargs else (inputs, kwargs)


@torch.no_grad()
def broadcast_mp_parameters(model, hcg):
    """Every replicated parameter (`is_distributed` unset) from the
    model-parallel group's first rank to the group; the shards stay."""
    group = _mp_group(hcg)
    if group is None:
        return
    src = hcg.get_model_parallel_group_src_rank()
    for p in model.parameters():
        if not getattr(p, "is_distributed", False):
            broadcast(p.data, src=src, group=group)


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
