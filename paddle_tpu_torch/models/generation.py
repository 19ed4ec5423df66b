"""Next-token selection shared by the serving engine's decode loops.

Counterpart of `_sample` in `paddle_tpu/models/generation.py`. Greedy is
`torch.argmax`, where the first maximum wins, as with `jnp.argmax`.
Sampling draws from a `torch.Generator`; it cannot give JAX's random bits
for the same seed.
"""
import torch


def _sample(logits, generator, do_sample, temperature, top_k, top_p):
    """logits: [b, V]. Returns [b] int64 token ids."""
    if not do_sample:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / max(float(temperature), 1e-6)
    if top_k and top_k > 0:
        kth = torch.sort(logits, dim=-1).values[..., -top_k][..., None]
        logits = torch.where(logits < kth, torch.full_like(logits, -1e30),
                             logits)
    if top_p and top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = torch.sum(cum < top_p, dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, torch.full_like(logits, -1e30),
                             logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
