"""LLaMA family, dense, as `nn.Module`s.

Counterpart of `paddle_tpu/models/llama.py`. Weights are `nn.Parameter`s
in Paddle's [in, out] layout (not `nn.Linear`'s [out, in]) and carry the
reference's parameter names (`llama.layers.{i}.self_attn.q_proj.weight`,
...), so a state moves between the two packages by name with no
transposes (`paddle_tpu_torch.convert.load_numpy_params`).

Initialisation follows the reference's distributions, drawn in parameter
order from one `torch.Generator`: XavierUniform for the projections and
the lm_head, XavierNormal for the embedding, ones for the norms.

`forward` is the training path: the norms go through the `rmsnorm` slot
(the RMSNorm kernel on CUDA, its analytic backward) and attention through
the `sdpa` slot (`FlashAttention`: the flash forward and backward kernels
on CUDA); on the CPU both take their plain versions. The serving engine
(`inference/serving.py`) reads the weights and never calls it.
`LlamaPretrainingCriterion` is the reference's token-mean CE.

Tensor parallelism: built under `fleet.init(mp_degree=n)` in a world of n
or more, the model takes the reference's model-parallel layers
(`distributed/fleet/meta_parallel`): q / k / v, gate and up
column-parallel, o and down row-parallel, the embedding vocab-parallel,
the lm_head column-parallel with `gather_output=False` and the criterion
vocab-parallel; attention splits by whole heads (`num_attention_heads`
and `num_key_value_heads` divisible by n, else ValueError) and runs on
the rank's heads. Each rank draws the full weights and keeps its slices,
so its shards equal the mp-1 model's. At mp 1 (a world of 1, whatever
mp_degree says) the modules are the plain ones above, unchanged.
"""
import math

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..nn import Embedding, Linear
from ..ops.pallas import rmsnorm, sdpa
from ..ops.pallas.paged_attention import expand_kv_heads


def model_parallel():
    """(group, degree) of the model-parallel group the layers split over:
    `fleet.init`'s, (None, 1) in a world of 1."""
    from ..distributed.fleet.meta_parallel.parallel_layers.mp_layers import \
        _mp_group_and_size
    return _mp_group_and_size(None)


def _split_heads(nh, nh_kv, mp):
    if nh % mp or nh_kv % mp:
        raise ValueError(
            f"tensor parallelism splits attention by whole heads: "
            f"num_attention_heads {nh} and num_key_value_heads {nh_kv} must "
            f"both be divisible by mp {mp}")


class LlamaConfig:
    def __init__(self, vocab_size=32000, hidden_size=4096,
                 intermediate_size=11008, num_hidden_layers=32,
                 num_attention_heads=32, num_key_value_heads=None,
                 max_position_embeddings=2048, rms_norm_eps=1e-6,
                 rope_theta=10000.0, dtype="float32", tie_word_embeddings=False,
                 recompute=False, sequence_parallel=False):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.num_key_value_heads = num_key_value_heads or num_attention_heads
        self.max_position_embeddings = max_position_embeddings
        self.rms_norm_eps = rms_norm_eps
        self.rope_theta = rope_theta
        self.dtype = dtype
        self.tie_word_embeddings = tie_word_embeddings
        self.recompute = recompute
        self.sequence_parallel = sequence_parallel

    @staticmethod
    def llama_7b(**kw):
        return LlamaConfig(hidden_size=4096, intermediate_size=11008,
                           num_hidden_layers=32, num_attention_heads=32, **kw)

    @staticmethod
    def llama_13b(**kw):
        return LlamaConfig(hidden_size=5120, intermediate_size=13824,
                           num_hidden_layers=40, num_attention_heads=40, **kw)

    @staticmethod
    def tiny(**kw):
        kw.setdefault("vocab_size", 128)
        kw.setdefault("hidden_size", 64)
        kw.setdefault("intermediate_size", 128)
        kw.setdefault("num_hidden_layers", 4)
        kw.setdefault("num_attention_heads", 4)
        kw.setdefault("max_position_embeddings", 128)
        return LlamaConfig(**kw)


def _rope_cache(seq_len, head_dim, theta, dtype=torch.float32, device=None):
    """(cos, sin) tables [seq_len, head_dim / 2], computed in float64 with
    numpy and rounded once to `dtype`, as the reference does."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))
    freqs = np.outer(np.arange(seq_len), inv)
    return (torch.tensor(np.cos(freqs), dtype=dtype, device=device),
            torch.tensor(np.sin(freqs), dtype=dtype, device=device))


def apply_rotary(x, cos, sin):
    """x: [b, s, h, d]; rotates the two halves of the head dim (not
    interleaved pairs)."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    c = cos[None, :x.shape[1], None, :]
    s = sin[None, :x.shape[1], None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


class RMSNorm(nn.Module):
    """Training cast order: the weight multiplies in f32 before the cast
    back (the serving engine's `_rms` casts first)."""

    def __init__(self, hidden_size, eps, device):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(hidden_size, device=device))

    def forward(self, x):
        return rmsnorm(x, self.weight, self.eps)


class LlamaAttention(nn.Module):
    def __init__(self, config, gen, device):
        super().__init__()
        self.hidden_size = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.head_dim = self.hidden_size // self.num_heads
        self.num_kv_heads = config.num_key_value_heads
        kv_out = self.num_kv_heads * self.head_dim
        H = self.hidden_size
        group, mp = model_parallel()
        if mp == 1:
            self.q_proj = Linear(H, H, gen, device, bias=False)
            self.k_proj = Linear(H, kv_out, gen, device, bias=False)
            self.v_proj = Linear(H, kv_out, gen, device, bias=False)
            self.o_proj = Linear(H, H, gen, device, bias=False)
        else:
            from ..distributed.fleet.meta_parallel import (
                ColumnParallelLinear as Col, RowParallelLinear as Row)
            _split_heads(self.num_heads, self.num_kv_heads, mp)
            self.num_heads //= mp          # this rank's heads
            kw = dict(has_bias=False, gather_output=False, mp_group=group,
                      gen=gen, device=device)
            self.q_proj = Col(H, H, **kw)
            self.k_proj = Col(H, kv_out, **kw)
            self.v_proj = Col(H, kv_out, **kw)
            self.o_proj = Row(H, H, has_bias=False, input_is_parallel=True,
                              mp_group=group, gen=gen, device=device)
        cos, sin = _rope_cache(config.max_position_embeddings, self.head_dim,
                               config.rope_theta, device=device)
        self.register_buffer("_cos", cos, persistent=False)
        self.register_buffer("_sin", sin, persistent=False)

    def forward(self, hidden_states):
        b, s, _ = hidden_states.shape
        hd = self.head_dim
        q = self.q_proj(hidden_states).reshape(b, s, -1, hd)
        k = self.k_proj(hidden_states).reshape(b, s, -1, hd)
        v = self.v_proj(hidden_states).reshape(b, s, -1, hd)
        c = self._cos[:s].to(q.dtype)
        sn = self._sin[:s].to(q.dtype)
        q = apply_rotary(q, c, sn)
        k = apply_rotary(k, c, sn)
        k = expand_kv_heads(k, self.num_heads)
        v = expand_kv_heads(v, self.num_heads)
        out = sdpa(q, k, v, causal=True, scale=1.0 / math.sqrt(hd))
        return self.o_proj(out.reshape(b, s, -1))


class LlamaMLP(nn.Module):
    def __init__(self, config, gen, device):
        super().__init__()
        H, I = config.hidden_size, config.intermediate_size
        group, mp = model_parallel()
        if mp == 1:
            self.gate_proj = Linear(H, I, gen, device, bias=False)
            self.up_proj = Linear(H, I, gen, device, bias=False)
            self.down_proj = Linear(I, H, gen, device, bias=False)
            return
        from ..distributed.fleet.meta_parallel import (
            ColumnParallelLinear as Col, RowParallelLinear as Row)
        kw = dict(has_bias=False, mp_group=group, gen=gen, device=device)
        self.gate_proj = Col(H, I, gather_output=False, **kw)
        self.up_proj = Col(H, I, gather_output=False, **kw)
        self.down_proj = Row(I, H, input_is_parallel=True, **kw)

    def forward(self, x):
        g = self.gate_proj(x)
        u = self.up_proj(x)
        return self.down_proj(u * (g * (1.0 / (1.0 + torch.exp(-g)))))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config, gen, device):
        super().__init__()
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       config.rms_norm_eps, device)
        self.self_attn = LlamaAttention(config, gen, device)
        self.post_attention_layernorm = RMSNorm(config.hidden_size,
                                                config.rms_norm_eps, device)
        self.mlp = LlamaMLP(config, gen, device)

    def forward(self, hidden_states):
        h = hidden_states + self.self_attn(self.input_layernorm(hidden_states))
        return h + self.mlp(self.post_attention_layernorm(h))


class LlamaModel(nn.Module):
    def __init__(self, config, gen, device):
        super().__init__()
        self.config = config
        group, mp = model_parallel()
        if mp == 1:
            self.embed_tokens = Embedding(config.vocab_size,
                                          config.hidden_size, gen, device)
        else:
            from ..distributed.fleet.meta_parallel import \
                VocabParallelEmbedding
            self.embed_tokens = VocabParallelEmbedding(
                config.vocab_size, config.hidden_size, mp_group=group,
                gen=gen, device=device)
        self.layers = nn.ModuleList([LlamaDecoderLayer(config, gen, device)
                                     for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps, device)

    def forward(self, input_ids):
        h = self.embed_tokens(input_ids)
        for layer in self.layers:
            h = layer(h)
        return self.norm(h)


class LlamaForCausalLM(nn.Module):
    """LLaMA with its lm_head. `device` defaults to CUDA (see
    `paddle_tpu_torch.resolve_device`); `seed` seeds the generator the
    weights are drawn from. `mp_group` / `mp_degree`: the model-parallel
    group the layers split over (None / 1 at mp 1)."""

    def __init__(self, config, device=None, seed=0):
        super().__init__()
        device = resolve_device(device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        self.config = config
        self.mp_group, self.mp_degree = model_parallel()
        self.llama = LlamaModel(config, gen, device)
        if self.mp_degree == 1:
            self.lm_head = Linear(config.hidden_size, config.vocab_size, gen,
                                  device, bias=False)
        else:
            from ..distributed.fleet.meta_parallel import ColumnParallelLinear
            self.lm_head = ColumnParallelLinear(
                config.hidden_size, config.vocab_size, has_bias=False,
                gather_output=False, mp_group=self.mp_group, gen=gen,
                device=device)
        self.criterion = LlamaPretrainingCriterion(config,
                                                   mp_group=self.mp_group)

    def forward(self, input_ids, labels=None):
        logits = self.lm_head(self.llama(input_ids))
        if labels is not None:
            return self.criterion(logits, labels)
        return logits


class LlamaPretrainingCriterion(nn.Module):
    """Token-mean softmax CE over the logits, the reference's: its
    `ParallelCrossEntropy` (`mp_layers`) and the mean. Rows labelled
    `ignore_index` add 0 to the sum and still count in the mean. Over a
    model-parallel `mp_group` the logits are this rank's vocab shard."""

    def __init__(self, config=None, ignore_index=-100, mp_group=None):
        super().__init__()
        from ..distributed.fleet.meta_parallel import ParallelCrossEntropy
        self.ce = ParallelCrossEntropy(mp_group=mp_group,
                                       ignore_index=ignore_index)
        self.ignore_index = ignore_index

    def forward(self, logits, labels):
        return self.ce(logits, labels).mean()
