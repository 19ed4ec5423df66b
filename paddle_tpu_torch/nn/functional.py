"""The functionals the GPT and BERT models use: dropout, layer_norm, gelu,
tanh, scaled_dot_product_attention and cross_entropy.

Counterparts of `paddle_tpu/nn/functional/common.py` (`dropout`),
`norm.py` (`layer_norm`), `activation.py` (`gelu`, `tanh`),
`attention.py` (`scaled_dot_product_attention`, `_sdpa_xla`) and
`loss.py` (`cross_entropy`), with the reference's parameters in its order
and its arithmetic:

- `dropout` draws its keep mask with `framework.random.bernoulli(
  next_key(), 1 - p, shape)` (float64 uniforms, as the reference under
  x64) and scales kept values by dividing by (1 - p) in x's dtype;
- `layer_norm` normalises in f32, casts to x's dtype, then multiplies by
  the weight and adds the bias in that dtype (not `F.layer_norm`, which
  rounds once at the end and so differs in bf16);
- `gelu(approximate=True)` is jax.nn.gelu's tanh form written out, so
  each product rounds in x's dtype as it does there; the default erf form
  is torch's, within 1e-6 of `jax.nn.gelu(approximate=False)` in f32;
- `scaled_dot_product_attention` routes to the `sdpa` slot (the flash
  kernels), or, for a mask that needs its gradient, to `_sdpa_xla`, the
  reference's plain attention with its `bernoulli` dropout;
- `cross_entropy` takes hard labels; its mean is over the rows not
  ignored, divided by max(count, 1).
"""
import math

import torch

from ..framework import random as frnd

_SOFT_LABEL = ("cross_entropy(soft_label=True) is not ported yet (ROADMAP "
               "A9.1): the port takes hard labels")


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


def tanh(x, name=None):
    return torch.tanh(x)


def _sdpa_xla(q, k, v, *rest, causal=False, scale=None, dropout_p=0.0):
    """The reference's plain attention (`_sdpa_xla`) on [b, s, h, d]:
    logits in q's dtype, causal and bool masks at -1e9, an additive mask
    added, softmax in f32 cast back to q's dtype, and dropout by
    `bernoulli(next_key(), 1 - p, probs.shape)` dividing by 1 - p. Every
    op is differentiable, the mask's too."""
    mask = rest[0] if rest else None
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * s
    neg = torch.full((), -1e9, dtype=logits.dtype, device=logits.device)
    if causal:
        ql, kl = logits.shape[-2], logits.shape[-1]
        tri = torch.ones((ql, kl), dtype=torch.bool,
                         device=logits.device).tril(kl - ql)
        logits = torch.where(tri, logits, neg)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = torch.where(mask, logits, neg)
        else:
            logits = logits + mask
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    if dropout_p and dropout_p > 0.0:
        keep = frnd.bernoulli(frnd.next_key(), 1.0 - dropout_p,
                              tuple(probs.shape), device=probs.device)
        denom = torch.full((), 1.0 - dropout_p, dtype=probs.dtype,
                           device=probs.device)
        probs = torch.where(keep, probs / denom,
                            torch.zeros((), dtype=probs.dtype,
                                        device=probs.device))
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False, training=True,
                                 name=None):
    """Attention on [batch, seq, num_heads, head_dim] (Paddle's layout).
    Outside training dropout is off. Fewer key/value heads than query
    heads (GQA) are repeated head-wise first. The call goes to the `sdpa`
    slot (`ops.pallas.sdpa`: `FlashAttention`, the flash kernels on CUDA),
    with the mask in the reference's place; a mask tensor that requires
    its gradient goes to `_sdpa_xla`, as the reference sends it there.
    The port has no context-parallel ('sep') mesh axis: its trainer
    refuses one (ROADMAP A8.6), so the reference's ring path is absent."""
    from ..ops.pallas import sdpa
    if not training:
        dropout_p = 0.0
    h_q, h_kv = query.shape[2], key.shape[2]
    if h_kv != h_q:
        if h_q % h_kv:
            raise ValueError(
                f"query heads {h_q} must be a multiple of kv heads {h_kv}")
        key = key.repeat_interleave(h_q // h_kv, dim=2)
        value = value.repeat_interleave(h_q // h_kv, dim=2)
    args = [query, key, value]
    mask_needs_grad = False
    if attn_mask is not None:
        args.append(attn_mask)
        mask_needs_grad = bool(attn_mask.requires_grad)
    return sdpa(*args, causal=is_causal, dropout_p=dropout_p,
                mask_needs_grad=mask_needs_grad)


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross-entropy against hard labels along `axis`, as the
    reference's `cross_entropy`: log_softmax (or log of the clipped input
    when not `use_softmax`), the label's entry picked (labels clipped into
    range, so an ignored one picks a harmless entry), label smoothing
    mixing in the mean of the log-probabilities, zero where the label is
    `ignore_index`, then times `weight[label]` when given. "mean" divides
    the sum by the number of rows not ignored (at least 1), or with a
    weight by the sum of their weights (at least 1e-12); "sum" sums;
    "none" returns the rows. `soft_label=True` raises (ROADMAP A9.1)."""
    if soft_label:
        raise NotImplementedError(_SOFT_LABEL)
    ax = axis % input.dim()
    if use_softmax:
        logp = torch.log_softmax(input, dim=ax)
    else:
        logp = torch.log(torch.clamp(input, min=1e-20))
    ids = label
    if ids.dim() == logp.dim():
        ids = ids.squeeze(ax)
    n_cls = logp.shape[ax]
    safe = ids.clamp(0, n_cls - 1).long()
    loss = -torch.take_along_dim(logp, safe.unsqueeze(ax), dim=ax).squeeze(ax)
    if label_smoothing > 0:
        smooth = -logp.mean(dim=ax)
        loss = (1 - label_smoothing) * loss + label_smoothing * smooth
    valid = ids != ignore_index
    zero = torch.zeros((), dtype=loss.dtype, device=loss.device)
    loss = torch.where(valid, loss, zero)
    if weight is not None:
        wt = torch.where(valid, weight[safe], torch.zeros(
            (), dtype=weight.dtype, device=weight.device))
        loss = loss * wt
        if reduction == "mean":
            return loss.sum() / torch.clamp(wt.sum(), min=1e-12)
    if reduction == "mean":
        return loss.sum() / torch.clamp(valid.to(loss.dtype).sum(), min=1.0)
    if reduction == "sum":
        return loss.sum()
    return loss


def relu(x, name=None):
    return torch.relu(x)
