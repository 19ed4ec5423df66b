"""Collective communication on `torch.distributed`.

Counterpart of `paddle_tpu/distributed/collective.py` (ref:
python/paddle/distributed/collective.py, communication/*.py). The
reference runs its eager cross-process verbs as host gathers over
`jax.distributed` and its world TCPStore; here every tensor verb is one
`torch.distributed` call (or a few) on the caller's tensors, in place, on
the process group `init_parallel_env` brought up. The object collectives
keep the reference's store transport (per-group generation keys under the
world TCPStore), so their semantics, subgroups included, are the
reference's.

Groups: `new_group(ranks)` rides `torch.distributed.new_group(ranks,
use_local_synchronization=True)`, called by the members only (a non-member
gets a Group with rank -1 and no process group), one torch group per rank
set; a group of the whole world uses the default group and a group of one
needs none. A verb called by a non-member raises ValueError ("not a
member"); a verb over more than one rank before `init_parallel_env` raises
RuntimeError: it never runs as a no-op. A group with an `axis_name` (the
reference's SPMD-region branch, collectives over a mesh axis inside
shard_map) needs the device mesh of ROADMAP A8.10 and raises
`MeshAxisError`.

Reductions: SUM / MAX / MIN / PROD are torch's; AVG is a SUM divided by
the group's size (a true division; integers truncate toward zero, as the
reference's float mean cast back does). Integers come out exact. With two
ranks a float SUM is one addition, so every rank holds the reference's
bits; from three ranks on gloo's ring adds in another order than the
reference's rank-order sum (within a few ulps of it).

Verbs gloo does not carry for CUDA tensors, composed from verbs that it
does (decided by backend and device, never by catching a failure): under
gloo, CUDA tensors go natively only through `all_reduce`, `broadcast` and
`all_gather`, so `reduce_scatter` is an all_reduce and a slice (on the CPU
too: gloo has no reduce_scatter), `alltoall` / `all_to_all_single` are an
all_gather and slices, `scatter` is a broadcast of the stacked list and a
slice, and `send` / `recv` stage the tensor through a host copy. Under
NCCL every verb is native. `alltoall` (a list) is always one
`all_to_all_single` of the stacked list.

`sync_op=False` returns the torch work handle (or, where a verb finishes
on the host after its collective, a task whose `wait()` does both); the
default blocks and returns what the reference returns.
"""
import pickle

import torch

from .parallel_env import get_rank, get_world_size, is_initialized


class ReduceOp:
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3
    AVG = 4


class MeshAxisError(NotImplementedError):
    """A collective over a device-mesh axis (the reference's SPMD-region
    branch): the port has no device mesh yet (ROADMAP A8.10)."""


def _refuse_mesh_axis(axis_name):
    if axis_name is not None:
        raise MeshAxisError(
            f"a group over mesh axis {axis_name!r} runs its collectives "
            f"inside a compiled SPMD region, which needs the device mesh "
            f"(ROADMAP A8.10)")


class Group:
    """Communication group: the member ranks (global), this rank's index
    among them (-1 for a non-member) and the torch process group that
    carries them (None: the default group, or a group of one)."""

    def __init__(self, rank_in_group, id, ranks, axis_name=None, name=None,
                 pg=None):
        _refuse_mesh_axis(axis_name)
        self.rank = rank_in_group
        self.id = id
        self.ranks = ranks
        self.axis_name = None
        self.name = name or f"group_{id}"
        self.pg = pg

    @property
    def nranks(self):
        return len(self.ranks)

    @property
    def world_size(self):
        return self.nranks

    def get_group_rank(self, rank):
        return self.ranks.index(rank) if rank in self.ranks else -1

    @property
    def process_group(self):
        return self

    def __repr__(self):
        return f"Group(id={self.id}, nranks={self.nranks}, ranks={self.ranks})"


_groups = {}
_world_group = [None]
_next_gid = [0]
_torch_groups = {}      # rank tuple -> torch ProcessGroup


def _ensure_world_group():
    if _world_group[0] is None:
        n = get_world_size()
        g = Group(get_rank(), 0, list(range(n)), name="world")
        _world_group[0] = g
        _groups[0] = g
    return _world_group[0]


def _torch_subgroup(ranks):
    key = tuple(ranks)
    if key not in _torch_groups:
        _torch_groups[key] = torch.distributed.new_group(
            list(ranks), use_local_synchronization=True)
    return _torch_groups[key]


def new_group(ranks=None, backend=None, timeout=None, axis_name=None):
    """ref: collective.py:185 new_group. Every rank may call it; only the
    members join the torch group."""
    _refuse_mesh_axis(axis_name)
    _next_gid[0] += 1
    gid = _next_gid[0]
    my = get_rank()
    world = get_world_size()
    ranks = sorted(ranks) if ranks else list(range(world))
    rig = ranks.index(my) if my in ranks else -1
    pg = None
    if (rig >= 0 and 1 < len(ranks) < world and ranks[-1] < world
            and is_initialized() and torch.distributed.is_initialized()):
        pg = _torch_subgroup(ranks)
    g = Group(rig, gid, ranks, pg=pg)
    _groups[gid] = g
    return g


def get_group(id=0):
    return _groups.get(id)


def is_available():
    """ref: collective.py is_available — whether torch was built with
    torch.distributed."""
    return torch.distributed.is_available()


def destroy_process_group(group=None):
    """ref: collective.py destroy_process_group — drop one group, or every
    group and the default process group (then init_parallel_env may run
    again)."""
    from .parallel_env import _reset
    if group is None:
        _groups.clear()
        _world_group[0] = None
        _next_gid[0] = 0
        _torch_groups.clear()
        _eager_seq.clear()
        _reset()
        return
    _groups.pop(group.id, None)
    if group.id == 0:
        _world_group[0] = None
    if group.pg is not None and not any(g.pg is group.pg
                                        for g in _groups.values()):
        _torch_groups.pop(tuple(group.ranks), None)
        torch.distributed.destroy_process_group(group.pg)


def _group_size(group):
    if group is None:
        return _ensure_world_group().nranks
    return group.nranks


def _require_initialized_multiproc(verb):
    """A verb over more than one rank needs the process group; a silent
    no-op would train unsynchronised replicas."""
    if not is_initialized() or not torch.distributed.is_initialized():
        raise RuntimeError(
            f"paddle.distributed.{verb}: world_size > 1, but the process "
            f"group is not initialized. Call "
            f"paddle.distributed.init_parallel_env() first.")


def _require_member(verb, group):
    me = get_rank()
    if group is not None and me not in list(group.ranks):
        raise ValueError(
            f"paddle.distributed.{verb}: rank {me} is not a member of "
            f"group {list(group.ranks)} — collectives must only be "
            f"called by group members")


def _enter(verb, group):
    """The checks every tensor verb over more than one rank makes first."""
    _require_member(verb, group)
    _require_initialized_multiproc(verb)


def _pg(group):
    return None if group is None else group.pg


def _group_ranks(group):
    if group is None:
        return list(range(_group_size(None)))
    return list(group.ranks)


def _my_group_rank(group):
    if group is None:
        return get_rank()
    return group.rank


# -- native or composed --------------------------------------------------------
# what gloo carries for CUDA tensors, and for CPU tensors
_GLOO_CUDA = frozenset({"all_reduce", "broadcast", "all_gather"})
_GLOO_CPU = _GLOO_CUDA | {"all_to_all_single", "scatter", "send", "recv"}


def _native(verb, tensor):
    """Whether the live backend takes `verb` on `tensor`'s device."""
    if torch.distributed.get_backend() == "nccl":
        return True
    return verb in (_GLOO_CUDA if tensor.is_cuda else _GLOO_CPU)


class _Task:
    """A verb's pending work: torch work handles, then what finishes it on
    the host (a division, a copy out of a staging buffer)."""

    def __init__(self, works=(), finish=None, keep=()):
        self._works = [w for w in works if w is not None]
        self._finish = finish
        self._keep = keep         # staging buffers the works still read

    def wait(self, timeout=None):
        for w in self._works:
            w.wait()
        if self._finish is not None:
            finish, self._finish = self._finish, None
            finish()
        self._keep = ()
        return True

    def is_completed(self):
        return self._finish is None and all(w.is_completed()
                                            for w in self._works)


def _done(result, sync_op, works=(), finish=None, keep=()):
    """Block (sync_op) and return the verb's result, or return the pending
    work: torch's own handle where nothing is left to do on the host."""
    works = [w for w in works if w is not None]
    if not sync_op and finish is None and not keep and len(works) == 1:
        return works[0]
    task = _Task(works, finish, keep)
    if sync_op:
        task.wait()
        return result
    return task


def _torch_op(op):
    R = torch.distributed.ReduceOp
    ops = {ReduceOp.SUM: R.SUM, ReduceOp.AVG: R.SUM, ReduceOp.MAX: R.MAX,
           ReduceOp.MIN: R.MIN, ReduceOp.PROD: R.PRODUCT}
    if op not in ops:
        raise ValueError(f"unknown ReduceOp {op!r}")
    return ops[op]


def _divide_(t, n):
    """t /= n in place: a true division for floats (by a tensor on t's
    device: CUDA would multiply by the reciprocal of a Python scalar), a
    truncation toward zero for integers."""
    if t.is_floating_point():
        t.div_(torch.full((), n, dtype=t.dtype, device=t.device))
    else:
        t.copy_(torch.div(t, n, rounding_mode="trunc"))


def _process_gather(tensor, group):
    """[n_group, ...]: every group rank's `tensor`, stacked in group-rank
    order (the int8 all-reduce's payload transport)."""
    outs = [torch.empty_like(tensor) for _ in range(_group_size(group))]
    torch.distributed.all_gather(outs, tensor.contiguous(), group=_pg(group))
    return torch.stack(outs)


# -- tensor verbs ---------------------------------------------------------------
def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True,
               compress=None, compress_chunk=None):
    """ref: communication/all_reduce.py. In place on `tensor`.

    compress="int8": SUM / AVG ride the chunked int8 all-reduce
    (`comm_compress.eager_quantized_allreduce`: one int8 + scales payload
    gathered, the dequantized rows summed in rank order). Lossy: callers
    that care about the bias carry error feedback (EagerReducer does)."""
    if compress not in (None, "int8"):
        raise ValueError(f"compress must be None or 'int8', got "
                         f"{compress!r}")
    if compress == "int8" and op not in (ReduceOp.SUM, ReduceOp.AVG):
        raise ValueError("compress='int8' supports SUM/AVG only")
    n = _group_size(group)
    if n == 1:
        return _done(tensor, sync_op)
    _enter("all_reduce", group)
    if compress == "int8":
        from . import comm_compress as _cc
        tot, _err = _cc.eager_quantized_allreduce(
            tensor, group, chunk=_cc.resolve_chunk(compress_chunk))
        if op == ReduceOp.AVG:
            _divide_(tot, n)
        tensor.copy_(tot.reshape(tensor.shape))
        return _done(tensor, sync_op)
    torch_op = _torch_op(op)
    work = torch.distributed.all_reduce(tensor, op=torch_op, group=_pg(group),
                                        async_op=True)
    finish = (lambda: _divide_(tensor, n)) if op == ReduceOp.AVG else None
    return _done(tensor, sync_op, [work], finish)


def all_gather(tensor_list, tensor, group=None, sync_op=True, axis=0):
    """ref: communication/all_gather.py — appends every group rank's
    tensor to tensor_list, in group-rank order."""
    n = _group_size(group)
    if n == 1:
        tensor_list.append(tensor)
        return _done(tensor_list, sync_op)
    _enter("all_gather", group)
    outs = [torch.empty_like(tensor) for _ in range(n)]
    work = torch.distributed.all_gather(outs, tensor.contiguous(),
                                        group=_pg(group), async_op=True)
    tensor_list.extend(outs)
    return _done(tensor_list, sync_op, [work])


def all_gather_into_tensor(tensor, group=None, concat_axis=0):
    """Every group rank's tensor concatenated along concat_axis (a new
    tensor). NCCL gathers into the tensor at once; gloo gathers a list."""
    n = _group_size(group)
    if n == 1:
        return tensor
    _enter("all_gather_into_tensor", group)
    x = tensor.contiguous()
    if torch.distributed.get_backend() == "nccl" and concat_axis == 0:
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        torch.distributed.all_gather_into_tensor(out, x, group=_pg(group))
        return out
    outs = []
    all_gather(outs, x, group=group)
    return torch.cat(outs, dim=concat_axis)


def reduce_scatter(tensor, tensor_list_or_input, op=ReduceOp.SUM, group=None,
                   sync_op=True, compress=None, compress_chunk=None):
    """ref: communication/reduce_scatter.py — the reduction of every rank's
    input, cut into n row blocks; block r lands in rank r's `tensor`.

    compress="int8" (SUM only): the int8 all-reduce, then this rank's
    block. gloo: an all_reduce and a slice; NCCL: reduce_scatter_tensor."""
    if compress not in (None, "int8"):
        raise ValueError(f"compress must be None or 'int8', got "
                         f"{compress!r}")
    if compress == "int8" and op != ReduceOp.SUM:
        raise ValueError("compress='int8' reduce_scatter supports SUM only")
    if isinstance(tensor_list_or_input, (list, tuple)):
        inp = torch.cat(list(tensor_list_or_input), dim=0)
    else:
        inp = tensor_list_or_input
    n = _group_size(group)
    if n == 1:
        tensor.copy_(inp.reshape(tensor.shape))
        return _done(tensor, sync_op)
    _enter("reduce_scatter", group)
    my = _my_group_rank(group)
    rows = inp.shape[0] // n
    if compress == "int8":
        from . import comm_compress as _cc
        tot, _err = _cc.eager_quantized_allreduce(
            inp, group, chunk=_cc.resolve_chunk(compress_chunk))
        tensor.copy_(tot[my * rows:(my + 1) * rows])
        return _done(tensor, sync_op)
    if _native("reduce_scatter", inp):
        work = torch.distributed.reduce_scatter_tensor(
            tensor, inp.contiguous(), op=_torch_op(op), group=_pg(group),
            async_op=True)
        finish = (lambda: _divide_(tensor, n)) if op == ReduceOp.AVG else None
        return _done(tensor, sync_op, [work], finish)
    full = inp.clone()
    work = torch.distributed.all_reduce(full, op=_torch_op(op),
                                        group=_pg(group), async_op=True)

    def finish():
        if op == ReduceOp.AVG:
            _divide_(full, n)
        tensor.copy_(full[my * rows:(my + 1) * rows])
    return _done(tensor, sync_op, [work], finish)


def _split_tables(splits, n, group, device):
    """[n][n] split tables of every group rank (row s: source s's)."""
    t = torch.tensor([int(x) for x in splits], dtype=torch.int64,
                     device=device)
    return _process_gather(t, group).tolist()


def all_to_all_single(output, input, out_split_sizes=None, in_split_sizes=None,
                      group=None, sync_op=True):
    """ref: communication/all_to_all.py alltoall_single — source s's rows
    for this rank (its block `my` of s's split table) land in `output` in
    source order. Heterogeneous split tables are allowed: when
    out_split_sizes is not given, the ranks exchange their tables first."""
    n = _group_size(group)
    if n == 1:
        output.copy_(input.reshape(output.shape))
        return _done(output, sync_op)
    _enter("all_to_all_single", group)
    my = _my_group_rank(group)
    inp = input.contiguous()
    if in_split_sizes is not None:
        in_splits = [int(x) for x in in_split_sizes]
        tables = None
        if out_split_sizes is not None:
            out_splits = [int(x) for x in out_split_sizes]
        else:
            tables = _split_tables(in_splits, n, group, inp.device)
            out_splits = [tables[s][my] for s in range(n)]
    else:
        rows = inp.shape[0] // n
        in_splits, out_splits, tables = [rows] * n, [rows] * n, None
    got = (sum(out_splits),) + tuple(inp.shape[1:])
    if tuple(output.shape) != got:
        raise ValueError(
            f"all_to_all_single output shape {tuple(output.shape)} does not "
            f"match received {got} (check out_split_sizes)")
    if _native("all_to_all_single", inp):
        work = torch.distributed.all_to_all_single(
            output, inp, out_splits, in_splits, group=_pg(group),
            async_op=True)
        return _done(output, sync_op, [work])
    # composed: every source's whole buffer, padded to the longest, then
    # this rank's block of each
    if tables is None:
        tables = _split_tables(in_splits, n, group, inp.device)
    max_rows = max(sum(t) for t in tables)
    if inp.shape[0] < max_rows:
        inp = torch.cat([inp, inp.new_zeros((max_rows - inp.shape[0],)
                                            + tuple(inp.shape[1:]))])
    allin = _process_gather(inp, group)
    parts = []
    for s in range(n):
        lo = sum(tables[s][:my])
        parts.append(allin[s][lo:lo + tables[s][my]])
    output.copy_(torch.cat(parts))
    return _done(output, sync_op)


def alltoall(out_tensor_list, in_tensor_list, group=None, sync_op=True):
    """ref: communication/all_to_all.py — in_tensor_list[j] goes to group
    rank j; out_tensor_list gets one tensor from each source, in order."""
    n = _group_size(group)
    if n == 1:
        out_tensor_list.extend(in_tensor_list)
        return _done(out_tensor_list, sync_op)
    _enter("alltoall", group)
    x = torch.stack(list(in_tensor_list))
    out = torch.empty_like(x)
    all_to_all_single(out, x, group=group)
    out_tensor_list.extend(out.unbind(0))
    return _done(out_tensor_list, sync_op)


def broadcast(tensor, src=0, group=None, sync_op=True):
    """ref: communication/broadcast.py — `src` is a global rank."""
    n = _group_size(group)
    if n == 1:
        return _done(tensor, sync_op)
    _enter("broadcast", group)
    if group is not None and group.get_group_rank(src) < 0:
        raise ValueError(f"broadcast src {src} is not in group "
                         f"{group.ranks}")
    work = torch.distributed.broadcast(tensor, src=src, group=_pg(group),
                                       async_op=True)
    return _done(tensor, sync_op, [work])


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """ref: communication/reduce.py. As in the reference every rank gets
    the reduction (`dst` names the canonical copy): it is all_reduce."""
    return all_reduce(tensor, op, group, sync_op)


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """ref: communication/scatter.py — src's tensor_list[r] lands in group
    rank r's `tensor` (other ranks may pass no list)."""
    n = _group_size(group)
    if n == 1:
        if tensor_list:
            tensor.copy_(tensor_list[0])
        return _done(tensor, sync_op)
    _enter("scatter", group)
    my = _my_group_rank(group)
    if group is not None and group.get_group_rank(src) < 0:
        raise ValueError(f"scatter src {src} is not in group "
                         f"{group.ranks}")
    is_src = get_rank() == src
    if _native("scatter", tensor):
        lst = [t.contiguous() for t in tensor_list] if is_src else None
        work = torch.distributed.scatter(tensor, lst, src=src,
                                         group=_pg(group), async_op=True)
        return _done(tensor, sync_op, [work])
    if is_src:
        stacked = torch.stack([t.to(tensor.device, tensor.dtype)
                               for t in tensor_list])
    else:
        stacked = tensor.new_zeros((n,) + tuple(tensor.shape))
    work = torch.distributed.broadcast(stacked, src=src, group=_pg(group),
                                       async_op=True)
    return _done(tensor, sync_op, [work],
                 lambda: tensor.copy_(stacked[my]))


# -- point to point ------------------------------------------------------------
def send(tensor, dst=0, group=None, sync_op=True):
    """p2p send (ref: communication/send.py); `dst` is a global rank. A
    CUDA tensor under gloo goes through a host copy."""
    if _group_size(group) == 1:
        return _done(tensor, sync_op)
    _require_initialized_multiproc("send")
    buf = (tensor.contiguous() if _native("send", tensor)
           else tensor.detach().cpu())
    work = torch.distributed.isend(buf, dst)
    return _done(tensor, sync_op, [work], keep=(buf,))


def recv(tensor, src=0, group=None, sync_op=True):
    """p2p recv into `tensor` from global rank `src`."""
    if _group_size(group) == 1:
        return _done(tensor, sync_op)
    _require_initialized_multiproc("recv")
    if _native("recv", tensor) and tensor.is_contiguous():
        work = torch.distributed.irecv(tensor, src)
        return _done(tensor, sync_op, [work])
    buf = torch.empty(tensor.shape, dtype=tensor.dtype,
                      device="cpu" if tensor.is_cuda
                      and not _native("recv", tensor) else tensor.device)
    work = torch.distributed.irecv(buf, src)
    return _done(tensor, sync_op, [work], lambda: tensor.copy_(buf))


def isend(tensor, dst=0, group=None):
    return send(tensor, dst, group, sync_op=False)


def irecv(tensor, src=0, group=None):
    return recv(tensor, src, group, sync_op=False)


class P2POp:
    """One pending p2p operation (ref: communication/batch_isend_irecv.py
    P2POp)."""

    def __init__(self, op, tensor, peer, group=None):
        if op not in (isend, irecv):
            raise RuntimeError("op must be paddle.distributed.isend or "
                               "paddle.distributed.irecv")
        self.op = op
        self.tensor = tensor
        self.peer = peer
        self.group = group


def batch_isend_irecv(p2p_op_list):
    """ref: communication/batch_isend_irecv.py. Posts every isend and irecv
    at once and returns when all are done (the reference's eager path
    returns with the receives filled); the list holds one finished task."""
    if not p2p_op_list:
        return []
    if not all(isinstance(o, P2POp) for o in p2p_op_list):
        raise RuntimeError("p2p_op_list must contain only P2POp objects")
    group = p2p_op_list[0].group
    if any(o.group is not group for o in p2p_op_list):
        raise RuntimeError("all P2POps in one batch_isend_irecv must use "
                           "the same group")
    sends = [o for o in p2p_op_list if o.op is isend]
    recvs = [o for o in p2p_op_list if o.op is irecv]
    if _group_size(group) == 1:
        if len(sends) != len(recvs):
            raise RuntimeError("unmatched isend/irecv ops in p2p_op_list")
        for s, r in zip(sends, recvs):
            r.tensor.copy_(s.tensor)
        return [_Task()]
    _require_initialized_multiproc("batch_isend_irecv")
    tasks = [o.op(o.tensor, o.peer, group) for o in sends + recvs]
    for t in tasks:
        t.wait()
    return [_Task()]


def barrier(group=None):
    """ref: communication/barrier — waits for this rank's queued device
    work, then for every rank."""
    from .parallel_env import get_device
    dev = get_device()
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if _group_size(group) > 1:
        _enter("barrier", group)
        torch.distributed.barrier(group=_pg(group))


def wait(tensor, group=None, use_calc_stream=True):
    """Block the host until the work queued on `tensor`'s stream is done."""
    if tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()


def split(x, num_or_sections, axis=0):
    """paddle.split: an int cuts x into that many equal parts; a list gives
    the sizes (one of them may be -1: the rest)."""
    if isinstance(num_or_sections, int):
        if x.shape[axis] % num_or_sections:
            raise ValueError(f"split: dim {axis} of size {x.shape[axis]} is "
                             f"not divisible into {num_or_sections} parts")
        return list(torch.split(x, x.shape[axis] // num_or_sections, axis))
    sizes = [int(s) for s in num_or_sections]
    if sizes.count(-1) > 1:
        raise ValueError("split: at most one section may be -1")
    if -1 in sizes:
        sizes[sizes.index(-1)] = x.shape[axis] - (sum(sizes) + 1)
    return list(torch.split(x, sizes, axis))


# -- object collectives over the world TCPStore --------------------------------
_eager_seq = {}


def _group_key(group):
    """Stable store-key prefix per group ('world' or the member ranks)."""
    if group is None:
        return "world"
    return "g" + "_".join(str(r) for r in group.ranks)


def _next_seq(group=None):
    """Per-group generation counter: a group's members advance it together,
    so store keys pair up even when subsets run different verbs."""
    k = _group_key(group)
    _eager_seq[k] = _eager_seq.get(k, 0) + 1
    return _eager_seq[k]


def _world_store_or_raise(verb):
    from .parallel_env import get_store
    st = get_store()
    if st is None:
        raise RuntimeError(
            f"paddle.distributed.{verb}: cross-process object collectives "
            f"need the TCPStore rendezvous of init_parallel_env() "
            f"(MASTER_ADDR/MASTER_PORT).")
    return st


def all_gather_object(object_list, obj, group=None):
    """ref: communication/all_gather.py all_gather_object — any picklable,
    over the world TCPStore."""
    gen = _next_seq(group)      # bumped before any early return
    n = _group_size(group)
    if n == 1:
        object_list.append(obj)
        return object_list
    _require_initialized_multiproc("all_gather_object")
    _require_member("all_gather_object", group)
    st = _world_store_or_raise("all_gather_object")
    ranks = _group_ranks(group)
    gk = _group_key(group)
    st.set(f"obj_ag/{gk}/{gen}/{get_rank()}", pickle.dumps(obj))
    for r in ranks:
        raw = st.get(f"obj_ag/{gk}/{gen}/{r}", wait=True, timeout_ms=120000)
        object_list.append(pickle.loads(raw))
    # the last reader sweeps this generation's keys
    if st.add(f"obj_ag/{gk}/{gen}/done", 1) == len(ranks):
        for r in ranks:
            st.delete_key(f"obj_ag/{gk}/{gen}/{r}")
        st.delete_key(f"obj_ag/{gk}/{gen}/done")
    return object_list


def broadcast_object_list(object_list, src=0, group=None):
    """ref: communication/broadcast.py broadcast_object_list — in place:
    the other ranks' slots are replaced by src's objects."""
    gen = _next_seq(group)
    n = _group_size(group)
    if n == 1:
        return object_list
    _require_initialized_multiproc("broadcast_object_list")
    _require_member("broadcast_object_list", group)
    if group is not None and src not in list(group.ranks):
        raise ValueError(
            f"broadcast_object_list src {src} is not in group "
            f"{list(group.ranks)}")
    st = _world_store_or_raise("broadcast_object_list")
    gk = _group_key(group)
    if get_rank() == src:
        st.set(f"obj_bc/{gk}/{gen}", pickle.dumps(list(object_list)))
        return object_list
    raw = st.get(f"obj_bc/{gk}/{gen}", wait=True, timeout_ms=120000)
    object_list[:] = pickle.loads(raw)
    if st.add(f"obj_bc/{gk}/{gen}/done", 1) == n - 1:  # the last reader sweeps
        st.delete_key(f"obj_bc/{gk}/{gen}")
        st.delete_key(f"obj_bc/{gk}/{gen}/done")
    return object_list


def scatter_object_list(out_object_list, in_object_list=None, src=0,
                        group=None):
    """ref: communication/scatter.py scatter_object_list — group rank r
    gets src's in_object_list[r]. A non-src rank that passes a list takes
    its slot from it (the reference's single-controller convenience)."""
    gen = _next_seq(group)
    n = _group_size(group)
    if n == 1:
        out_object_list.append(in_object_list[0] if in_object_list else None)
        return out_object_list
    my = group.rank if group is not None and group.rank >= 0 else get_rank()
    if in_object_list is not None and get_rank() != src:
        out_object_list.append(in_object_list[my])
        return out_object_list
    _require_initialized_multiproc("scatter_object_list")
    _require_member("scatter_object_list", group)
    if group is not None and src not in list(group.ranks):
        raise ValueError(
            f"scatter_object_list src {src} is not in group "
            f"{list(group.ranks)}")
    st = _world_store_or_raise("scatter_object_list")
    gk = _group_key(group)
    if get_rank() == src:
        for i, r in enumerate(_group_ranks(group)):
            if r == get_rank():
                continue  # src takes its slot directly
            st.set(f"obj_sc/{gk}/{gen}/{r}", pickle.dumps(in_object_list[i]))
        out_object_list.append(in_object_list[my])
        return out_object_list
    key = f"obj_sc/{gk}/{gen}/{get_rank()}"
    raw = st.get(key, wait=True, timeout_ms=120000)
    st.delete_key(key)  # single-consumer key
    out_object_list.append(pickle.loads(raw))
    return out_object_list
