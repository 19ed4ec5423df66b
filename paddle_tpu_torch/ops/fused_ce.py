"""Chunked fused lm-head + softmax cross-entropy, dense or vocab-parallel.

Counterpart of `paddle_tpu/ops/fused_ce.py`. The head product and the CE
are computed a chunk of rows at a time, each chunk an autograd Function
(`_CEChunk`) that saves only its inputs and the rows' log-sum-exp, so the
full [N, V] logits never exist: the forward holds one chunk's f32 logits
at a time, and the backward recomputes each chunk's logits, forms
softmax - onehot and accumulates dW chunk by chunk. In the reference this
is a checkpointed `lax.scan` in XLA, not a Pallas kernel, and here it is
torch ops.

Vocab parallelism: `axis` is the model-parallel `Group` the vocab dim is
split over (rank r holds columns [r V / n, (r + 1) V / n)); a group of
one rank, or None, is the dense CE. The reference's `axis` names a mesh
axis; a name here (a str) needs the device mesh and raises naming ROADMAP
A8.10. Over a group the reference's c_softmax_with_cross_entropy math
(ref: paddle/fluid/operators/collective/c_softmax_with_cross_entropy_op
.cu.h): the row max by an all-reduce MAX (no gradient), the sum of exps
and the picked logit (the owning shard's) by one all-reduce SUM, each
rank's gradient local, softmax_local - onehot_local, with no all-reduce
in the backward (the completion is `mp_ops._mp_allreduce`'s identity
backward: a SUM whose backward summed again would scale every gradient
by the mp degree, which the reference undoes with its `_untied_psum(
"model")(loss / mp)`).
"""
import torch


def _vocab_group(axis):
    """The model-parallel group of `axis` (None: dense)."""
    if axis is None:
        return None
    if isinstance(axis, str):
        raise NotImplementedError(
            f"vocab-parallel CE over mesh axis {axis!r}: the port has no "
            f"device mesh (ROADMAP A8.10); pass the model-parallel Group")
    from ..distributed.fleet.meta_parallel.parallel_layers.mp_ops import \
        resolve_group
    return resolve_group(axis)


def _row_max(logits, group):
    lmax = logits.detach().max(dim=-1, keepdim=True).values
    if group is not None:
        from ..distributed.collective import ReduceOp
        from ..distributed.fleet.meta_parallel.parallel_layers.mp_ops \
            import all_reduce_
        lmax = all_reduce_(lmax.clone(), group, ReduceOp.MAX)
    return lmax


def vocab_parallel_ce_rows(logits, labels, axis=None, ignore_index=-100):
    """Per-row CE over f32 logits [..., V_local] against int labels [...]
    (global vocab ids).

    Returns (loss [...], shifted [..., V_local], gsum [..., 1]) as the
    reference does: shifted = logits - rowmax (the max carries no
    gradient) and gsum = sum(exp(shifted)) over the whole vocab. Rows whose
    label is ignore_index get loss 0 (and so gradient 0); a label outside
    the vocab picks 0."""
    group = _vocab_group(axis)
    v = logits.shape[-1]
    v_start = 0 if group is None else group.rank * v
    shifted = logits - _row_max(logits, group)
    gsum = torch.exp(shifted).sum(dim=-1, keepdim=True)
    local = labels - v_start
    in_range = (local >= 0) & (local < v)
    safe = local.clamp(0, v - 1).long()
    picked = torch.gather(shifted, -1, safe[..., None])
    picked = torch.where(in_range[..., None], picked,
                         torch.zeros_like(picked))
    if group is not None:
        from ..distributed.fleet.meta_parallel.parallel_layers.mp_ops import \
            _mp_allreduce
        both = _mp_allreduce(torch.cat([gsum, picked], dim=-1), group=group)
        gsum, picked = both[..., :1], both[..., 1:]
    lse = torch.log(gsum)[..., 0]
    loss = torch.where(labels != ignore_index, lse - picked[..., 0],
                       torch.zeros_like(lse))
    return loss, shifted, gsum


def _logits(hc, w, f32_product):
    if f32_product:
        return hc.float() @ w.float()
    return (hc @ w).float()


class _CEChunk(torch.autograd.Function):
    """One chunk's CE sum over the vocab, or over this rank's shard of it
    with a `group`: the collectives in the forward only; the backward
    recomputes the chunk's logits and forms softmax_local - onehot_local
    from the saved (global) log-sum-exp."""

    @staticmethod
    def forward(ctx, hc, w, lc, group, ignore_index, f32_product):
        with torch.no_grad():
            logits = _logits(hc, w, f32_product)
            loss, shifted, gsum = vocab_parallel_ce_rows(
                logits, lc, axis=group, ignore_index=ignore_index)
            lse = (logits - shifted)[:, :1] + torch.log(gsum)    # [c, 1]
        ctx.save_for_backward(hc, w, lc, lse)
        ctx.group, ctx.ignore_index = group, ignore_index
        ctx.f32_product = f32_product
        return loss.sum()

    @staticmethod
    def backward(ctx, g):
        hc, w, lc, lse = ctx.saved_tensors
        logits = _logits(hc, w, ctx.f32_product)
        v = logits.shape[-1]
        local = lc - (0 if ctx.group is None else ctx.group.rank * v)
        hit = (local >= 0) & (local < v)
        d = torch.exp(logits - lse)
        d.scatter_add_(1, local.clamp(0, v - 1).long()[:, None],
                       -hit.to(d.dtype)[:, None])
        d = d * ((lc != ctx.ignore_index).to(d.dtype) * g)[:, None]
        if ctx.f32_product:
            dh = (d @ w.float().t()).to(hc.dtype)
            dw = (hc.float().t() @ d).to(w.dtype)
        else:
            d = d.to(hc.dtype)
            dh, dw = d @ w.t(), hc.t() @ d
        return dh, dw, None, None, None, None


def fused_linear_ce(h, w, labels, axis=None, chunk=4096, ignore_index=-100,
                    precision=None):
    """Sum of per-token CE of softmax(h @ w) against labels.

    h: [N, H]; w: [H, V_local]; labels: [N] int (global ids); axis: the
    model-parallel Group the vocab is split over, or None. Returns (total
    f32 scalar, n_valid f32 scalar): ignored rows (and the pad rows that
    fill the last chunk, which carry ignore_index) add 0 to the total and
    are not counted. precision="highest" forms each chunk's logits from
    f32 copies of h and w (the reference's f32 product); otherwise the
    product runs in the operands' dtype (for bf16: f32 accumulation, the
    logits rounded to bf16 once) and is then widened to f32 for the CE.
    Over a group, the caller feeds h through `mp_ops._c_identity` (the
    column-parallel input: its gradient sums the shards' partials), as the
    reference's trainer does."""
    group = _vocab_group(axis)
    n, hid = h.shape
    c = min(int(chunk), n)
    pad = (-n) % c
    if pad:
        h = torch.cat([h, h.new_zeros((pad, hid))])
        labels = torch.cat([labels, labels.new_full((pad,), ignore_index)])
    f32_product = precision == "highest"
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, n + pad, c):
        total = total + _CEChunk.apply(h[i:i + c], w, labels[i:i + c], group,
                                       ignore_index, f32_product)
    n_valid = (labels != ignore_index).sum().to(torch.float32)
    return total, n_valid
