"""Hand-written CUDA kernels for Hopper, one module per Pallas TPU kernel of
`paddle_tpu/ops/pallas/` that the port has reached. Each module holds the
wrapper (plain PyTorch version for CPU tensors, the CUDA kernel for CUDA
tensors) and the plain version itself.

`sdpa` and `rmsnorm` are the training model's two slots, the counterparts
of the reference's `pallas`-backend registrations here
(`paddle_tpu/ops/pallas/__init__.py`). The port has no kernel registry:
each slot is one differentiable function whose wrappers dispatch by the
tensor's device.
"""
from ...framework import random as frnd
from .flash_attention import FlashAttention
from .rms_norm import rms_norm as rmsnorm  # noqa: F401  (the rms_norm slot)


def sdpa(q, k, v, causal=False, scale=None, dropout_p=0.0):
    """Scaled dot-product attention on [b, s, h, d] (k/v at q's head
    count): `FlashAttention`, forward and backward kernels on CUDA.
    Non-causal by default, as the reference's slot. With `dropout_p > 0`
    the call draws its seed where the reference's
    `flash_attention_pallas` does, `randint(next_key(), (), 0, 2^31 - 1)`
    (the framework key stream: the step's scope, else the global
    generator), and drops attention weights inside the kernels."""
    seed = None
    if dropout_p and dropout_p > 0.0:
        seed = int(frnd.randint(frnd.next_key(), (), 0, 2 ** 31 - 1))
    return FlashAttention.apply(q, k, v, causal, scale, None,
                                float(dropout_p or 0.0), seed)
