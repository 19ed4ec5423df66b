"""Next-token selection shared by the serving engine's decode loops.

Counterpart of `_sample` in `paddle_tpu/models/generation.py`. Greedy is
`torch.argmax`, where the first maximum wins, as with `jnp.argmax`.
Sampling follows the reference's key flow and arithmetic: the caller
splits its key before every token, the logits keep their dtype through the
temperature / top-k / top-p cuts, and the draw is
`inference.sampling.categorical` (JAX's threefry bits and Gumbel noise), so
the same seed gives the reference's tokens.
"""
import torch


def _sample(logits, key, do_sample, temperature, top_k, top_p):
    """logits: [b, V]; key: a [2] key (`inference.sampling.key`/`split`)
    used for the whole [b, V] draw. Returns [b] int64 token ids."""
    if not do_sample:
        return torch.argmax(logits, dim=-1)
    # imported here: the inference package imports this module
    from ..inference.sampling import _softmax, categorical

    def full(v):
        return torch.full_like(logits[..., :1], v)

    logits = logits / full(max(float(temperature), 1e-6))
    if top_k and top_k > 0:
        kth = torch.sort(logits, dim=-1).values[..., -top_k][..., None]
        logits = torch.where(logits < kth, full(-1e30), logits)
    if top_p and top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(_softmax(sorted_logits), dim=-1)
        cutoff_idx = torch.sum(cum < full(top_p), dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, full(-1e30), logits)
    return categorical(key, logits)
