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


def sdpa(q, k, v, *rest, causal=False, scale=None, dropout_p=0.0,
         mask_needs_grad=False):
    """Scaled dot-product attention on [b, s, h, d] (k/v at q's head
    count), the reference's `_sdpa_pallas`: `rest` is an optional mask
    (additive, or bool: `flash_attention.norm_mask`), and the call is
    `FlashAttention`, forward and backward kernels on CUDA. Non-causal by
    default, as the reference's slot. A mask that needs its gradient
    (`mask_needs_grad`) takes the plain attention of
    `nn.functional._sdpa_xla` instead, as the reference does: the kernels
    give the mask none. With `dropout_p > 0` the call draws its seed where
    the reference's `flash_attention_pallas` does, `randint(next_key(),
    (), 0, 2^31 - 1)` (the framework key stream: the step's scope, else
    the global generator), and drops attention weights inside the
    kernels."""
    mask = rest[0] if rest else None
    if mask is not None and mask_needs_grad:
        from ...nn.functional import _sdpa_xla
        return _sdpa_xla(q, k, v, mask, causal=causal, scale=scale,
                         dropout_p=dropout_p)
    seed = None
    if dropout_p and dropout_p > 0.0:
        seed = int(frnd.randint(frnd.next_key(), (), 0, 2 ** 31 - 1))
    return FlashAttention.apply(q, k, v, causal, scale, None,
                                float(dropout_p or 0.0), seed, mask)
