"""The functionals the GPT model uses: dropout, layer_norm, gelu.

Counterparts of `paddle_tpu/nn/functional/common.py` (`dropout`),
`norm.py` (`layer_norm`) and `activation.py` (`gelu`), with the
reference's parameters in its order and its arithmetic:

- `dropout` draws its keep mask with `framework.random.bernoulli(
  next_key(), 1 - p, shape)` (float64 uniforms, as the reference under
  x64) and scales kept values by dividing by (1 - p) in x's dtype;
- `layer_norm` normalises in f32, casts to x's dtype, then multiplies by
  the weight and adds the bias in that dtype (not `F.layer_norm`, which
  rounds once at the end and so differs in bf16);
- `gelu(approximate=True)` is jax.nn.gelu's tanh form written out, so
  each product rounds in x's dtype as it does there.
"""
import math

import torch

from ..framework import random as frnd


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Paddle's dropout: with `training` and 0 < p < 1, zero each element
    (or, with `axis`, each slice along the other axes) with probability p;
    mode "upscale_in_train" divides the kept ones by 1 - p, mode
    "downscale_in_infer" keeps them as they are and multiplies by 1 - p
    outside training."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    if p == 1.0:
        return x * 0.0
    key = frnd.next_key()
    if axis is None:
        shape = tuple(x.shape)
    else:
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        axes = [a % x.dim() for a in axes]
        shape = tuple(x.shape[i] if i in axes else 1 for i in range(x.dim()))
    keep = frnd.bernoulli(key, 1.0 - p, shape, device=x.device)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if mode == "upscale_in_train":
        # a tensor divisor in x's dtype: JAX divides by (1 - p) rounded to
        # x's dtype, and torch would multiply by the reciprocal of a
        # Python float on CUDA
        denom = torch.full((), 1.0 - p, dtype=x.dtype, device=x.device)
        return torch.where(keep, x / denom, zero)
    return torch.where(keep, x, zero)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05,
               name=None):
    """Normalise over the trailing `normalized_shape` dims in f32 (mean,
    then the mean of squared deviations), cast to x's dtype, then
    `* weight + bias` in that dtype."""
    ns = normalized_shape if isinstance(normalized_shape, (list, tuple)) \
        else [normalized_shape]
    dims = tuple(range(-len(ns), 0))
    a = x.float()
    mean = a.mean(dim=dims, keepdim=True)
    c = a - mean
    var = (c * c).mean(dim=dims, keepdim=True)
    out = (c * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


_SQRT_2_OVER_PI = math.sqrt(2 / math.pi)


def gelu(x, approximate=False, name=None):
    """GELU; `approximate=True` is the tanh form
    x * 0.5 (1 + tanh(sqrt(2 / pi) (x + 0.044715 x^3))), each step in x's
    dtype as jax.nn.gelu computes it."""
    if not approximate:
        return torch.nn.functional.gelu(x)
    c = torch.full((), _SQRT_2_OVER_PI, dtype=x.dtype, device=x.device)
    inner = c * (x + 0.044715 * (x * x * x))
    return x * (0.5 * (1.0 + torch.tanh(inner)))
