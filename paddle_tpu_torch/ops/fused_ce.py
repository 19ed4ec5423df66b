"""Chunked fused lm-head + softmax cross-entropy.

Counterpart of `paddle_tpu/ops/fused_ce.py`. The head product and the CE
are computed a chunk of rows at a time, each chunk under
`torch.utils.checkpoint`, so the full [N, V] logits never exist: the
forward holds one chunk's f32 logits at a time, and the backward
recomputes each chunk's logits and accumulates dW chunk by chunk. In the
reference this is a checkpointed `lax.scan` in XLA, not a Pallas kernel,
and here it is torch ops.

The vocab is not sharded: `axis` must be None (vocab parallelism is ROADMAP
A8).
"""
import torch
from torch.utils.checkpoint import checkpoint


def _no_vocab_axis(axis):
    if axis is not None:
        raise NotImplementedError(
            "vocab-parallel CE (a mesh axis over the vocab) is not ported "
            "yet (ROADMAP A8)")


def vocab_parallel_ce_rows(logits, labels, axis=None, ignore_index=-100):
    """Per-row CE over f32 logits [..., V] against int labels [...].

    Returns (loss [...], shifted [..., V], gsum [..., 1]) as the reference
    does: shifted = logits - rowmax (the max carries no gradient) and
    gsum = sum(exp(shifted)). Rows whose label is ignore_index get loss 0
    (and so gradient 0); a label outside [0, V) picks 0."""
    _no_vocab_axis(axis)
    v = logits.shape[-1]
    lmax = logits.max(dim=-1, keepdim=True).values.detach()
    shifted = logits - lmax
    gsum = torch.exp(shifted).sum(dim=-1, keepdim=True)
    lse = torch.log(gsum)[..., 0]
    in_range = (labels >= 0) & (labels < v)
    safe = labels.clamp(0, v - 1).long()
    picked = torch.gather(shifted, -1, safe[..., None])[..., 0]
    picked = torch.where(in_range, picked, torch.zeros_like(picked))
    loss = torch.where(labels != ignore_index, lse - picked,
                       torch.zeros_like(lse))
    return loss, shifted, gsum


def _chunk_total(hc, w, lc, ignore_index, f32_product):
    if f32_product:
        logits = hc.float() @ w.float()
    else:
        logits = (hc @ w).float()
    loss, _, _ = vocab_parallel_ce_rows(logits, lc, ignore_index=ignore_index)
    return loss.sum()


def fused_linear_ce(h, w, labels, axis=None, chunk=4096, ignore_index=-100,
                    precision=None):
    """Sum of per-token CE of softmax(h @ w) against labels.

    h: [N, H]; w: [H, V]; labels: [N] int. Returns (total f32 scalar,
    n_valid f32 scalar): ignored rows (and the pad rows that fill the last
    chunk, which carry ignore_index) add 0 to the total and are not
    counted. precision="highest" forms each chunk's logits from f32 copies
    of h and w (the reference's f32 product); otherwise the product runs in
    the operands' dtype (for bf16: f32 accumulation, the logits rounded to
    bf16 once) and is then widened to f32 for the CE."""
    _no_vocab_axis(axis)
    n, hid = h.shape
    c = min(int(chunk), n)
    pad = (-n) % c
    if pad:
        h = torch.cat([h, h.new_zeros((pad, hid))])
        labels = torch.cat([labels, labels.new_full((pad,), ignore_index)])
    f32_product = precision == "highest"
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, n + pad, c):
        hc, lc = h[i:i + c], labels[i:i + c]
        if torch.is_grad_enabled() and (h.requires_grad or w.requires_grad):
            part = checkpoint(_chunk_total, hc, w, lc, ignore_index,
                              f32_product, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            part = _chunk_total(hc, w, lc, ignore_index, f32_product)
        total = total + part
    n_valid = (labels != ignore_index).sum().to(torch.float32)
    return total, n_valid
