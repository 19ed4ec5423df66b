"""Tensor-parallel collective primitives over the model-parallel group.

Counterpart of `paddle_tpu/distributed/fleet/meta_parallel/
parallel_layers/mp_ops.py` (ref: python/paddle/distributed/fleet/layers/
mpu/mp_ops.py — _c_identity:27, _c_concat:91, _c_split:153,
_mp_allreduce:219, _c_softmax_with_cross_entropy:375, split:653). The
reference's ops are `custom_vjp`s over `lax.psum` on the "model" mesh axis
inside one SPMD program; here each model-parallel rank is its own process,
as in Paddle, and each op is a `torch.autograd.Function` whose forward and
backward are the port's collectives (`distributed/collective.py`) over the
hybrid group's model-parallel group:

  - `_c_identity`: identity forward, all-reduce (SUM) backward — the input
    of a column-parallel layer;
  - `_mp_allreduce`: all-reduce forward, identity backward — the output of
    a row-parallel layer, and every completion of disjoint per-rank
    partials (the vocab-parallel embedding and CE), so no gradient is
    summed twice;
  - `_c_concat`: gather the last dim forward, keep the local slice
    backward; `_c_split`: the reverse.

`group=None` takes the model-parallel group of `fleet.init`; a group of
one rank (a world of 1, whatever mp_degree says) makes every op pass its
input through.

`comm_stats` counts the model-parallel collectives a process ran (calls,
bytes of the tensors reduced or gathered) and, while `comm_timing(True)`,
their seconds on the host clock with the device synchronized around each
call.
"""
import contextlib
import time

import torch

comm_stats = {"calls": 0, "bytes": 0, "seconds": 0.0}
_timing = [False]


def reset_comm_stats():
    comm_stats.update(calls=0, bytes=0, seconds=0.0)


@contextlib.contextmanager
def comm_timing(on=True):
    """Time every model-parallel collective in this block (the device is
    synchronized before and after each: a measurement, not the step)."""
    prev = _timing[0]
    _timing[0] = bool(on)
    try:
        yield
    finally:
        _timing[0] = prev


def _world_size():
    from ....parallel_env import get_world_size
    return get_world_size()


def resolve_group(group=None):
    """The model-parallel group an op runs over: `group`, else the hybrid
    group's (`fleet.init`); None when it has one rank."""
    if _world_size() <= 1:
        return None
    if group is None:
        from ...fleet_base import fleet_instance
        hcg = fleet_instance.get_hybrid_communicate_group()
        group = None if hcg is None else hcg.get_model_parallel_group()
    if group is None or group.nranks <= 1:
        return None
    return group


def _sync(t):
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _collective(t, fn):
    comm_stats["calls"] += 1
    comm_stats["bytes"] += t.numel() * t.element_size()
    if not _timing[0]:
        return fn()
    _sync(t)
    t0 = time.perf_counter()
    out = fn()
    _sync(t)
    comm_stats["seconds"] += time.perf_counter() - t0
    return out


def all_reduce_(t, group, op=None):
    """In-place all-reduce of `t` over `group` (SUM unless `op`)."""
    from ....collective import ReduceOp, all_reduce
    op = ReduceOp.SUM if op is None else op
    _collective(t, lambda: all_reduce(t, op=op, group=group))
    return t


def gather_last(t, group):
    """Every group rank's `t`, concatenated along the last dim in rank
    order."""
    from ....collective import all_gather
    outs = []
    _collective(t, lambda: all_gather(outs, t.contiguous(), group=group))
    return torch.cat(outs, dim=-1)


def local_last(t, group):
    """This rank's slice of the last dim (equal parts)."""
    n = t.shape[-1] // group.nranks
    return t[..., group.rank * n:(group.rank + 1) * n].contiguous()


class _Identity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Concat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return gather_last(x, group)

    @staticmethod
    def backward(ctx, g):
        return local_last(g, ctx.group), None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return local_last(x, group)

    @staticmethod
    def backward(ctx, g):
        return gather_last(g, ctx.group), None


def _c_identity(tensor, group=None, skip_c_identity_dynamic=False):
    """Identity forward, all-reduce backward (column-parallel input)."""
    group = resolve_group(group)
    return tensor if group is None else _Identity.apply(tensor, group)


def _mp_allreduce(tensor, op=None, group=None, use_calc_stream=True,
                  use_model_parallel=True):
    """All-reduce forward, identity backward (row-parallel output)."""
    group = resolve_group(group)
    return tensor if group is None else _AllReduce.apply(tensor, group)


def _c_concat(tensor, group=None):
    """All-gather along the last dim (ref: mp_ops.py:91)."""
    group = resolve_group(group)
    return tensor if group is None else _Concat.apply(tensor, group)


def _c_split(tensor, group=None):
    """Keep the local slice of the last dim (ref: mp_ops.py:153)."""
    group = resolve_group(group)
    return tensor if group is None else _Split.apply(tensor, group)


def _c_softmax_with_cross_entropy(logits, label, group=None,
                                  return_softmax=False, ignore_index=-100):
    """Vocab-parallel softmax CE (ref: mp_ops.py:375): `logits` holds this
    rank's vocab shard on its last dim, `label` global ids ([...] or
    [..., 1]). Returns the loss [..., 1] (and the local softmax)."""
    from .....ops.fused_ce import vocab_parallel_ce_rows
    group = resolve_group(group)
    lab = torch.as_tensor(label, device=logits.device)
    if lab.dim() == logits.dim():
        lab = lab.squeeze(-1)
    loss, shifted, gsum = vocab_parallel_ce_rows(
        logits.float(), lab, axis=group, ignore_index=ignore_index)
    loss = loss[..., None]
    if return_softmax:
        return loss, torch.exp(shifted) / gsum
    return loss


def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    """Tensor-split helper (ref: mp_ops.py:653): builds the matching
    parallel layer on x's device and applies it."""
    from .mp_layers import (ColumnParallelLinear, RowParallelLinear,
                            VocabParallelEmbedding)
    dev = x.device
    if operation == "linear":
        if axis == 0:
            layer = RowParallelLinear(size[0], size[1],
                                      weight_attr=weight_attr,
                                      has_bias=bias_attr is not False,
                                      input_is_parallel=False, device=dev)
        else:
            layer = ColumnParallelLinear(size[0], size[1],
                                         weight_attr=weight_attr,
                                         has_bias=bias_attr is not False,
                                         gather_output=gather_out,
                                         device=dev)
        return layer(x)
    if operation == "embedding":
        layer = VocabParallelEmbedding(size[0], size[1],
                                       weight_attr=weight_attr, device=dev)
        return layer(x)
    raise ValueError(f"unsupported split operation {operation}")
