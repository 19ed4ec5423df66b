"""paddle.optimizer's eager optimizers (Adam, AdamW) for torch Parameters.

Counterpart of `paddle_tpu/optimizer/` as far as BERT pretraining needs
it; the other optimizers, `LRScheduler` and `grad_clip` wait (ROADMAP
A9.1).
"""
from .optimizer import L1Decay, L2Decay, Optimizer  # noqa: F401
from .optimizers import Adam, AdamW  # noqa: F401
