"""paddle.optimizer's eager optimizers (SGD, Adam, AdamW) for torch
Parameters.

Counterpart of `paddle_tpu/optimizer/` as far as BERT pretraining and
data-parallel training need it; the other optimizers, `LRScheduler` and
`grad_clip` wait (ROADMAP A9.1).
"""
from .optimizer import L1Decay, L2Decay, Optimizer  # noqa: F401
from .optimizers import SGD, Adam, AdamW  # noqa: F401
