"""Drafters for speculative decoding, and the rejection-sampling rule the
engine's sample-and-match specializes.

Counterpart of `paddle_tpu/inference/speculative.py`. The drafters are
host numpy code and are the reference's; `ModelDrafter` runs the port's
`LlamaForCausalLM` and `rejection_sample` draws with the port's threefry
(`inference/sampling.py`: `split`, `uniform`, `categorical`), the same bits
as `jax.random` on the same key.

Speculative decoding emits more than one accepted token per verification
pass: a cheap drafter proposes the next few tokens, the target model
scores all of them in one multi-token-q pass, and an on-device
accept/reject commits the longest matching prefix plus the target's own
next token. A bad draft only degrades a pass to one (target-chosen) token,
so drafters may be heuristic.

Two drafters cost no extra model:

  - `NGramDrafter`: prompt-lookup decoding. The trailing n-gram of the
    request's context (prompt + generated so far) is matched against its
    own earlier tokens, and the continuation after the most recent
    occurrence is proposed. `max_ctx` caps the scanned window: the
    per-propose cost is O(window * n) on the host, between device
    dispatches.
  - `PrefixCacheDrafter`: drafts from the engine's content-addressed
    `PrefixCache`: other requests' cached prompt chains are observed
    continuations of this request's context.

`ModelDrafter` wraps a small draft model: greedy proposals from a dense
forward over the context padded to a `bucket` multiple.

Acceptance (engine side): the target draws its own token at every draft
position, greedy = argmax, sampled = `select_from_topk` with the position
key fold_in(seed, position), the key the unspeculated stream uses there.
Draft i is accepted iff it equals the target's token at its position and
every earlier draft was accepted (sample-and-match). Every drafter here
proposes one deterministic continuation, a delta distribution, and for it
sample-and-match is rejection sampling: the acceptance probability is
p(draft) and the emitted token is distributed exactly p either way (see
`rejection_sample`). It also makes the sampled stream equal to the
unspeculated one token for token.
"""
import time

import numpy as np
import torch

from .sampling import categorical, split, uniform


def rejection_sample(p_probs, q_probs, draft, key):
    """Distribution-preserving verification of one draft token (the
    general-q rule the engine's sample-and-match specializes): accept
    `draft` with probability min(1, p[draft] / q[draft]); on rejection,
    emit a sample of the normalized residual max(p - q, 0). The emitted
    token is distributed exactly p for any proposal q.

    p_probs / q_probs: [V] probability rows; draft: the proposed id; key:
    a [2] key of `inference.sampling` (`key(seed)`, `fold_keys`). Draws
    as the reference does with `jax.random` on the same key: split into
    (k_u, k_r), u = uniform(k_u), the residual's categorical under k_r.
    Returns (accepted bool, token int64) as 0-d tensors."""
    p = torch.as_tensor(p_probs, dtype=torch.float32)
    q = torch.as_tensor(q_probs, dtype=torch.float32, device=p.device)
    d = int(draft)
    k_u, k_r = split(key.to(p.device))
    u = uniform(k_u, (1,))[0]          # element 0: the bits of shape ()
    accepted = u * q[d] <= p[d]
    resid = torch.clamp(p - q, min=0.0)
    resid = resid / torch.clamp(resid.sum(), min=1e-30)
    alt = categorical(k_r, torch.log(torch.clamp(resid, min=1e-30)))
    return accepted, torch.where(accepted, torch.tensor(d, device=p.device),
                                 alt)


class Drafter:
    """Interface: propose up to `k` continuation tokens for a context.

    `ctx` is the request's full token history (prompt + every generated
    token, the last of which is the token about to be fed). Return a 1-D
    int array of length <= k; shorter (or empty) shrinks this pass's
    speculation. It runs on the host once per request per block."""

    name = "base"
    # a sampling-aware drafter sets this and takes propose(ctx, k,
    # sampling=...), the request's SamplingParams (None for greedy)
    sampling_aware = False

    def propose(self, ctx, k):
        raise NotImplementedError

    def timed_propose(self, ctx, k, sampling=None):
        """propose() with self-accounting: `proposals` and
        `propose_seconds` accumulate on the instance (lazily, so
        subclasses that skip super().__init__ still work). The engine
        calls this one. `sampling` reaches propose() only for
        sampling-aware drafters."""
        t0 = time.perf_counter()
        try:
            if self.sampling_aware:
                return self.propose(ctx, k, sampling=sampling)
            return self.propose(ctx, k)
        finally:
            self.proposals = getattr(self, "proposals", 0) + 1
            self.propose_seconds = (getattr(self, "propose_seconds", 0.0)
                                    + time.perf_counter() - t0)

    def __repr__(self):
        return f"{type(self).__name__}()"


class NGramDrafter(Drafter):
    """Prompt-lookup drafting: the continuation after the most recent
    earlier occurrence of the context's trailing n-gram, trying n = `n`
    down to `min_n` (the longest pattern with an earlier occurrence
    wins)."""

    name = "ngram"

    def __init__(self, n=3, min_n=1, max_ctx=4096):
        if n < min_n or min_n < 1:
            raise ValueError(f"need n >= min_n >= 1, got n={n} "
                             f"min_n={min_n}")
        self.n = int(n)
        self.min_n = int(min_n)
        # scan window cap (None = unbounded): proposals come from the
        # trailing max_ctx tokens only
        self.max_ctx = None if max_ctx is None else int(max_ctx)

    def propose(self, ctx, k):
        ctx = np.asarray(ctx)
        if self.max_ctx is not None and ctx.size > self.max_ctx:
            ctx = ctx[-self.max_ctx:]
        out = np.empty((0,), np.int64)
        if k <= 0:
            return out
        for n in range(min(self.n, ctx.size - 1), self.min_n - 1, -1):
            pat = ctx[-n:]
            win = np.lib.stride_tricks.sliding_window_view(ctx, n)
            hits = np.flatnonzero((win == pat).all(axis=1))
            # drop the trailing self-match; keep the most recent earlier
            # occurrence that has at least one continuation token
            hits = hits[hits + n < ctx.size]
            if hits.size:
                s = int(hits[-1])
                return ctx[s + n:s + n + k].astype(np.int64)
        return out


class PrefixCacheDrafter(Drafter):
    """Drafts from the engine's prefix cache: `PrefixCache.continuation`
    walks the cached page chains of the request's context. `fallback`
    (what drafter="prefix" installs: an NGramDrafter) handles a cold cache
    or a divergent context."""

    name = "prefix"

    def __init__(self, cache, fallback=None):
        self.cache = cache
        self.fallback = fallback

    def propose(self, ctx, k):
        if self.cache is not None:
            out = self.cache.continuation(np.asarray(ctx), k)
            if out.size:
                return out
        if self.fallback is not None:
            return self.fallback.propose(ctx, k)
        return np.empty((0,), np.int64)


class ModelDrafter(Drafter):
    """Greedy proposals from a small draft model (the port's
    `LlamaForCausalLM`, on its own device). Each proposal step runs one
    dense forward over the context padded after its true tokens up to a
    `bucket` multiple; causal attention leaves the scored position
    untouched. k forwards per propose()."""

    name = "model"

    def __init__(self, model, bucket=32, max_ctx=None):
        self.model = model
        self.bucket = int(bucket)
        self.max_ctx = max_ctx      # optional cap: draft from the tail

    @torch.no_grad()
    def propose(self, ctx, k):
        ctx = np.asarray(ctx, np.int64)
        if self.max_ctx is not None and ctx.size > self.max_ctx:
            ctx = ctx[-self.max_ctx:]
        dev = next(self.model.parameters()).device
        out = []
        toks = list(ctx)
        for _ in range(max(0, k)):
            t = len(toks)
            t_pad = -(-t // self.bucket) * self.bucket
            ids = np.zeros((1, t_pad), np.int64)
            ids[0, :t] = toks
            logits = self.model(torch.as_tensor(ids, device=dev))[0, t - 1]
            nxt = int(logits.argmax())
            out.append(nxt)
            toks.append(nxt)
        return np.asarray(out, np.int64)


def resolve_drafter(spec, prefix_cache=None):
    """Engine knob -> Drafter instance: a Drafter, or "ngram" / "prefix"
    (the zero-extra-model drafters); "prefix" needs the engine's
    PrefixCache and falls back to n-gram proposals when the cache walk
    has nothing."""
    if isinstance(spec, Drafter):
        return spec
    if spec in (None, "ngram"):
        return NGramDrafter()
    if spec == "prefix":
        if prefix_cache is None:
            raise ValueError(
                "drafter='prefix' needs prefix_cache=True on the engine "
                "(the drafter walks the content-addressed page chains)")
        return PrefixCacheDrafter(prefix_cache, fallback=NGramDrafter())
    raise ValueError(
        f"drafter must be a Drafter instance, 'ngram' or 'prefix', "
        f"got {spec!r}")
