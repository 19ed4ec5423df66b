"""Fleet's meta-optimizers (counterpart of `paddle_tpu/distributed/fleet/
meta_optimizers/`): `HybridParallelOptimizer` and its clip. The sharding
optimizer is ROADMAP A8.8, the grad scaler and DGC / LocalSGD A8.15."""
from .hybrid_parallel_optimizer import (HybridParallelOptimizer,  # noqa: F401
                                        HybridParallelClipGrad)
