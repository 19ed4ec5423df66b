"""HybridParallelOptimizer (ref: python/paddle/distributed/fleet/
meta_optimizers/dygraph_optimizer/hybrid_parallel_optimizer.py:186),
counterpart of `paddle_tpu/distributed/fleet/meta_optimizers/
hybrid_parallel_optimizer.py`.

The optimizer `fleet.distributed_optimizer` returns outside the pure
data-parallel mode. Each rank updates its own shards and replicated
parameters with the wrapped optimizer's rule: the model-parallel layers
already left every rank the dense gradient of what it holds. With a
data-parallel axis above 1 (tensor x data parallelism under fleet, where
no `DataParallel` wraps the model) `step` first averages the gradients
over the data-parallel group (`fused_allreduce_gradients`), as the
reference's does.

`HybridParallelClipGrad` (ref :45, the global-norm clip whose squared
norm sums over the model, pipe and sharding groups) raises naming ROADMAP
A9.1 while the port's optimizers refuse `grad_clip`.
"""
import torch


class HybridParallelClipGrad:
    """ref: hybrid_parallel_optimizer.py:45."""

    def __init__(self, clip, hcg):
        raise NotImplementedError(
            "HybridParallelClipGrad: gradient clipping (`grad_clip`) is not "
            "ported yet (ROADMAP A9.1)")


class HybridParallelOptimizer:
    """ref: hybrid_parallel_optimizer.py:186."""

    def __init__(self, optimizer, hcg, strategy=None):
        self._inner_opt = optimizer
        self._hcg = hcg
        self._strategy = strategy
        self._dp_sync = (hcg is not None
                         and hcg.get_parallel_mode() != "data_parallel"
                         and hcg.get_data_parallel_world_size() > 1)

    @torch.no_grad()
    def step(self):
        if self._dp_sync:
            from ..utils.hybrid_parallel_util import fused_allreduce_gradients
            fused_allreduce_gradients(
                [p for _, p in self._inner_opt._params], self._hcg)
        self._inner_opt.step()

    def clear_grad(self, *a, **k):
        self._inner_opt.clear_grad(*a, **k)

    clear_gradients = clear_grad

    def minimize(self, loss, *a, **k):
        loss.backward()
        self.step()
        return None, None

    def get_lr(self):
        return self._inner_opt.get_lr()

    def set_lr(self, lr):
        self._inner_opt.set_lr(lr)

    def __getattr__(self, item):
        if item == "_inner_opt":
            raise AttributeError(item)
        return getattr(self._inner_opt, item)
