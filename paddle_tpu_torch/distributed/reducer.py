"""EagerReducer: bucketed gradient averaging for eager DataParallel.

Counterpart of `paddle_tpu/distributed/reducer.py` (ref:
paddle/fluid/distributed/collective/reducer.cc EagerReducer +
python/paddle/fluid/dygraph/parallel.py:121 build_groups):

  - the parameters that take a gradient (`requires_grad`) are grouped in
    REVERSE creation order (gradients arrive roughly in that order during
    backward) into buckets capped at `bucket_bytes`, counting 4 bytes an
    element; a parameter is never split, so one larger than the cap has a
    bucket of its own;
  - each parameter's `register_post_accumulate_grad_hook` marks it ready
    once its gradient is accumulated; the hook that completes a bucket
    flushes it at once, as ONE all_reduce(AVG) of the bucket's gradients
    flattened in f32, split back into the `.grad`s;
  - the first hook of a backward queues `sync()` on the autograd engine
    (`Variable._execution_engine.queue_callback`), which flushes the
    buckets left incomplete (parameters that took no gradient) when the
    backward ends; a bucket flushes once a backward, and a `sync()` after
    the backward finds nothing left to flush;
  - `enabled = False` (DataParallel.no_sync) suppresses flushing: the
    gradients keep accumulating locally.

compress="int8": a flush rides the eager int8 all-reduce
(`comm_compress.eager_quantized_allreduce`) with a per-bucket
error-feedback residual carried to the next flush of the bucket, dropped
when the bucket's members with a gradient change. Sparse gradients (the
reference's SelectedRows branch, which gathers rows) raise
`SparseGradientError`: the port has no SelectedRows (ROADMAP A9.1).

Counters for the card's measurements: `flushes`, `flush_seconds` (host
wall time inside the flushes' collectives) and `flush_bytes` (f32 bytes
reduced).
"""
import time
import weakref

import torch

from .collective import all_reduce, ReduceOp
from .comm_compress import resolve_chunk


class SparseGradientError(NotImplementedError):
    """A sparse gradient reached the reducer (ROADMAP A9.1)."""


def _sparse_refused(what):
    return SparseGradientError(
        f"{what}: sparse gradients ride SelectedRows in the reference, which "
        f"the port has not ported (ROADMAP A9.1)")


class EagerReducer:
    def __init__(self, params, bucket_bytes=25 * 1024 * 1024, group=None,
                 compress=None, compress_chunk=None):
        if compress not in (None, "int8"):
            raise ValueError(f"compress must be None or 'int8', got "
                             f"{compress!r}")
        self.compress = compress
        self.compress_chunk = resolve_chunk(compress_chunk)
        self._ef_residual = {}
        self._ef_members = {}    # bucket -> the member set its residual is for
        self.group = group
        self.params = [p for p in params if p.requires_grad]
        if any(getattr(p, "is_sparse_grad", False) for p in self.params):
            raise _sparse_refused("EagerReducer")
        self.enabled = True
        self.buckets = []
        cur, cur_bytes = [], 0
        for p in reversed(self.params):
            nbytes = p.numel() * 4
            if cur and cur_bytes + nbytes > bucket_bytes:
                self.buckets.append(cur)
                cur, cur_bytes = [], 0
            cur.append(p)
            cur_bytes += nbytes
        if cur:
            self.buckets.append(cur)
        self._bucket_of = {}
        for bi, b in enumerate(self.buckets):
            for p in b:
                self._bucket_of[id(p)] = bi
        self._reset()
        self.flushes, self.flush_seconds, self.flush_bytes = 0, 0.0, 0
        # weak self: parameters outlive wrappers, and a dropped reducer's
        # hooks must neither keep it alive nor act on later backwards
        ref = weakref.ref(self)
        self._handles = [p.register_post_accumulate_grad_hook(
            self._make_hook(ref, id(p))) for p in self.params]

    @staticmethod
    def _make_hook(ref, pid):
        def hook(param):
            self_ = ref()
            if self_ is not None and self_.enabled:
                self_._on_grad(pid)
        return hook

    def _on_grad(self, pid):
        if not self._callback_queued:
            self._callback_queued = True
            torch.autograd.Variable._execution_engine.queue_callback(
                self._on_backward_done)
        bi = self._bucket_of[pid]
        self._ready[bi].add(pid)
        if (len(self._ready[bi]) == len(self.buckets[bi])
                and not self._flushed[bi]):
            self._flush_bucket(bi)

    def _on_backward_done(self):
        self._callback_queued = False
        if self.enabled and any(self._ready):
            self.sync()

    @torch.no_grad()
    def _flush_bucket(self, bi):
        bucket = [p for p in self.buckets[bi] if p.grad is not None]
        self._flushed[bi] = True
        if not bucket:
            return
        if any(p.grad.is_sparse for p in bucket):
            raise _sparse_refused("EagerReducer bucket flush")
        present = tuple(i for i, p in enumerate(self.buckets[bi])
                        if p.grad is not None)
        fused = torch.cat([p.grad.reshape(-1).float() for p in bucket])
        t0 = time.perf_counter()
        self._reduce_fused(fused, bi, present)
        self.flush_seconds += time.perf_counter() - t0
        self.flushes += 1
        self.flush_bytes += fused.numel() * 4
        off = 0
        for p in bucket:
            n = p.grad.numel()
            p.grad.copy_(fused[off:off + n].view(p.grad.shape))
            off += n

    def _reduce_fused(self, fused, bi, present=None):
        """AVG-all-reduce one fused bucket in place. compress="int8" adds
        the bucket's previous residual before quantizing and keeps the new
        quantization error (EF-SGD a bucket)."""
        if self.compress != "int8":
            all_reduce(fused, op=ReduceOp.AVG, group=self.group)
            return
        from . import collective
        from . import comm_compress as _cc
        from .parallel_env import get_world_size
        world = (self.group.nranks if self.group is not None
                 else get_world_size())
        if world <= 1:
            return  # nothing crosses a wire: exact
        collective._require_initialized_multiproc("all_reduce")
        v = fused
        res = self._ef_residual.get(bi)
        # a residual computed for another member set must reset, even
        # when the fused lengths coincide
        if (res is not None and self._ef_members.get(bi) == present
                and res.shape == v.shape):
            v = v + res
        tot, err = _cc.eager_quantized_allreduce(
            v, self.group, chunk=self.compress_chunk)
        self._ef_residual[bi] = err
        self._ef_members[bi] = present
        # AVG like the exact flush; the residual stays unscaled (every rank
        # feeds its own error back, and the next average divides by world)
        fused.copy_(tot / torch.full((), float(world), device=tot.device))

    # -- public ---------------------------------------------------------------
    def sync(self):
        """Flush every bucket with a ready gradient that has not flushed
        (the end-of-backward callback calls it); a second call finds none."""
        if not self.enabled:
            self._reset()
            return
        for bi in range(len(self.buckets)):
            if not self._flushed[bi] and self._ready[bi]:
                self._flush_bucket(bi)
        self._reset()

    def _reset(self):
        self._ready = [set() for _ in self.buckets]
        self._flushed = [False] * len(self.buckets)
        self._callback_queued = False

    def remove(self):
        """Detach the reducer's hooks from the parameters."""
        for h in self._handles:
            h.remove()
        self._handles = []
