"""Autoregressive generation with a dense KV cache, outside the engines.

Counterpart of `paddle_tpu/models/generation.py`: `_decode_math` runs one
step (or the prompt's prefill) through the LLaMA stack writing
preallocated [b, max_len, nh, hd] caches, and `generate` drives the token
loop with greedy or top-k / top-p sampling. PyTorch runs eagerly, so
there is no compiled step and no weight swap: the model's own modules and
parameters are read under `torch.no_grad()`.

The arithmetic is the reference's, dtype promotion included: the rope
tables are f32, so in a bf16 model q and k leave the rope in f32 (k is
rounded to the cache's dtype when written), the scores and the softmax run
in f32, and every product of an f32 operand with a bf16 weight is formed
in f32, as `jnp` promotes. The norms go through the model's `RMSNorm`
modules (the `rmsnorm` slot: `csrc/rms_norm.cu` on CUDA, 2L + 1 launches
per forward call); the products stay `torch.matmul` / `einsum`, as the
reference computes them outside any Pallas kernel.

`_sample` is the next-token selection the serving engine's decode loops
share. Greedy is `torch.argmax`, where the first maximum wins, as with
`jnp.argmax`. Sampling follows the reference's key flow and arithmetic:
the caller splits its key before every token, the logits keep their dtype
through the temperature / top-k / top-p cuts, and the draw is
`inference.sampling.categorical` (JAX's threefry bits and Gumbel noise),
so the same seed gives the reference's tokens.
"""
import math

import numpy as np
import torch

from ..ops.pallas.paged_attention import expand_kv_heads
from .llama import LlamaForCausalLM, _rope_cache


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


def _promoted(*xs):
    """The operands cast to their promoted dtype (`jnp`'s rule for a
    product of an f32 and a bf16 array)."""
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return [x.to(dt) for x in xs]


def _mm(x, w):
    return torch.matmul(*_promoted(x, w))


def _decode_math(model, ids, caches, pos, max_len):
    """One step (or prefill chunk) through the LLaMA stack writing KV caches.
    ids: [b, t] int64 on the model's device; caches: list of (k, v)
    [b, max_len, nh, hd], written in place; pos: the int position of
    ids[:, 0]. Returns (logits [b, V], caches)."""
    cfg = model.config
    h = model.llama.embed_tokens(ids)                     # [b, t, H]
    b, t = ids.shape
    dev = h.device
    cos, sin = _rope_cache(max_len, cfg.hidden_size // cfg.num_attention_heads,
                           cfg.rope_theta, torch.float32, dev)
    pos_ids = pos + torch.arange(t, device=dev)
    kpos = torch.arange(max_len, device=dev)[None, None, None, :]
    qpos = pos_ids[None, None, :, None]
    mask = kpos <= qpos
    c = cos[pos_ids][None, :, None, :]
    s = sin[pos_ids][None, :, None, :]

    for li, layer in enumerate(model.llama.layers):
        attn = layer.self_attn
        x = layer.input_layernorm(h)
        q = _mm(x, attn.q_proj.weight)
        k = _mm(x, attn.k_proj.weight)
        v = _mm(x, attn.v_proj.weight)
        hd = attn.head_dim
        nh = q.shape[-1] // hd
        nh_kv = k.shape[-1] // hd   # GQA: k/v may carry fewer heads
        q = q.reshape(b, t, nh, hd)
        k = k.reshape(b, t, nh_kv, hd)
        v = v.reshape(b, t, nh_kv, hd)
        d2 = hd // 2

        def rope(x_):
            x1, x2 = x_[..., :d2], x_[..., d2:]
            return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1)

        q, k = rope(q), rope(k)
        # expand to query heads for the dense cache and attention (the GQA
        # convention every path shares)
        k = expand_kv_heads(k, nh)
        v = expand_kv_heads(v, nh)
        k_buf, v_buf = caches[li]
        k_buf[:, pos:pos + t] = k.to(k_buf.dtype)
        v_buf[:, pos:pos + t] = v.to(v_buf.dtype)
        # attention over the filled prefix
        logits = torch.einsum("bqhd,bkhd->bhqk", *_promoted(q, k_buf)) \
            / math.sqrt(hd)
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
        probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
        ctx = torch.einsum("bhqk,bkhd->bqhd", *_promoted(probs, v_buf))
        ctx = ctx.reshape(b, t, nh * hd)
        h = torch.add(*_promoted(h, _mm(ctx, attn.o_proj.weight)))
        x2 = layer.post_attention_layernorm(h)
        g = _mm(x2, layer.mlp.gate_proj.weight)
        u = _mm(x2, layer.mlp.up_proj.weight)
        act = u * (g * (1.0 / (1.0 + torch.exp(-g))))
        h = torch.add(*_promoted(h, _mm(act, layer.mlp.down_proj.weight)))

    h = model.llama.norm(h)
    logits = _mm(h[:, -1], model.lm_head.weight)
    return logits, caches


def generate(model, input_ids, max_new_tokens=32, do_sample=False,
             temperature=1.0, top_k=0, top_p=1.0, eos_token_id=None,
             seed=0):
    """Greedy/sampling generation for LlamaForCausalLM, on the model's
    device. input_ids: tensor/ndarray [b, t0]. Returns ndarray
    [b, t0+new]; with `eos_token_id` the loop stops once every row emitted
    it in the same step."""
    assert isinstance(model, LlamaForCausalLM), "generate: LLaMA family only"
    from ..inference import sampling
    model.eval()
    cfg = model.config
    ids = input_ids.detach().cpu().numpy() if torch.is_tensor(input_ids) \
        else np.asarray(input_ids)
    b, t0 = ids.shape
    max_len = t0 + max_new_tokens
    nh = cfg.num_attention_heads
    hd = cfg.hidden_size // nh
    w = model.lm_head.weight
    dev, dtype = w.device, w.dtype
    with torch.no_grad():
        caches = [(torch.zeros((b, max_len, nh, hd), dtype=dtype, device=dev),
                   torch.zeros((b, max_len, nh, hd), dtype=dtype, device=dev))
                  for _ in range(cfg.num_hidden_layers)]
        logits, caches = _decode_math(
            model, torch.as_tensor(ids, dtype=torch.int64, device=dev),
            caches, 0, max_len)
        # the reference's key flow: key(seed) draws the first token, then
        # one split before every later token
        key = sampling.key(seed, device=dev)
        nxt = _sample(logits, key, do_sample, temperature, top_k, top_p)
        out = [nxt.cpu().numpy()[:, None]]
        pos = t0
        for _ in range(max_new_tokens - 1):
            key, sub = sampling.split(key)
            logits, caches = _decode_math(model, nxt[:, None], caches, pos,
                                          max_len)
            nxt = _sample(logits, sub, do_sample, temperature, top_k, top_p)
            out.append(nxt.cpu().numpy()[:, None])
            pos += 1
            if eos_token_id is not None and np.all(out[-1] == eos_token_id):
                break
    return np.concatenate([ids] + [o.astype(ids.dtype) for o in out], axis=1)
