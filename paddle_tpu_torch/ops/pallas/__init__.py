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
from .flash_attention import FlashAttention
from .rms_norm import rms_norm as rmsnorm  # noqa: F401  (the rms_norm slot)


def sdpa(q, k, v, causal=False, scale=None):
    """Scaled dot-product attention on [b, s, h, d] (k/v at q's head
    count): `FlashAttention`, forward and backward kernels on CUDA.
    Non-causal by default, as the reference's slot."""
    return FlashAttention.apply(q, k, v, causal, scale)
