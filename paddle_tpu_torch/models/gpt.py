"""GPT family (pre-LN, learned positions), as `nn.Module`s.

Counterpart of `paddle_tpu/models/gpt.py`. Weights keep Paddle's [in, out]
layout and the reference's parameter names
(`gpt.h.{i}.attn.q_proj.weight`, `gpt.embeddings.position_embeddings.
weight`, ...), so a state moves between the two packages by name
(`paddle_tpu_torch.convert`). Initialisation follows the reference's
distributions (`mp_layers.py`), drawn in parameter order from one
`torch.Generator`: XavierNormal for the word table, Normal(0, 1) for the
position table, XavierUniform weights and zero biases for the
projections, XavierUniform for the lm_head, ones and zeros for the norms.

In training (`self.training`, the default) the embedding and each
layer's MLP output go through hidden dropout, and attention through the
`sdpa` slot at `causal=True, dropout_p=attention_probs_dropout_prob`:
`FlashAttention` with the flash kernels' dropout branch on CUDA, its plain
version on the CPU. Every draw takes its key from the framework key
stream (`framework.random.next_key`): inside the trainer's `key_scope`
they are the reference's counters (embedding 1, the attention seed 2, the
hidden dropout 3, the same for every layer; see `models/train_step.py`).

Tensor parallelism (built under `fleet.init(mp_degree=n)` in a world of n
or more), as the reference's model: the word table vocab-parallel (the
position table replicated), q / k / v and fc_in column-parallel, out_proj
and fc_out row-parallel (their biases replicated, added after the
all-reduce), the lm_head column-parallel with `gather_output=False` and
the CE vocab-parallel; attention runs on the rank's nh / n heads. The
dropout draws are the reference's under its `{"model": n}` shard_map:
every rank binds the same step key, so the hidden dropout on the
replicated activations draws one mask on every rank, and the attention
seed is the same on every rank while the flash kernels hash the LOCAL
head index (`_slice_id`), so rank r's heads draw as heads 0 .. nh / n - 1
of the dense model. At mp 1 the modules are the plain ones, unchanged.

Not ported: `gpt_pipeline_layers` (the pipeline LayerDesc list, ROADMAP
A8.7) and the `sep` position offset of context parallelism (A8.6); the
first raises, and the trainer refuses a `sep` mesh axis.
"""
import torch
from torch import nn

from .. import resolve_device
from ..nn import Dropout, Embedding, LayerNorm, Linear
from ..nn import functional as F
from ..ops.pallas import sdpa
from .llama import model_parallel


class GPTConfig:
    def __init__(self, vocab_size=50304, hidden_size=768, num_hidden_layers=12,
                 num_attention_heads=12, intermediate_size=None,
                 max_position_embeddings=1024, hidden_dropout_prob=0.1,
                 attention_probs_dropout_prob=0.1, layer_norm_eps=1e-5,
                 recompute=False):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size or 4 * hidden_size
        self.max_position_embeddings = max_position_embeddings
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.layer_norm_eps = layer_norm_eps
        self.recompute = recompute

    @staticmethod
    def gpt3_1p3b(**kw):
        return GPTConfig(hidden_size=2048, num_hidden_layers=24,
                         num_attention_heads=16, **kw)

    @staticmethod
    def tiny(**kw):
        kw.setdefault("vocab_size", 128)
        kw.setdefault("hidden_size", 64)
        kw.setdefault("num_hidden_layers", 4)
        kw.setdefault("num_attention_heads", 4)
        kw.setdefault("max_position_embeddings", 64)
        return GPTConfig(**kw)


class GPTEmbeddings(nn.Module):
    def __init__(self, config, gen, device):
        super().__init__()
        group, mp = model_parallel()
        if mp == 1:
            self.word_embeddings = Embedding(config.vocab_size,
                                             config.hidden_size, gen, device)
        else:
            from ..distributed.fleet.meta_parallel import \
                VocabParallelEmbedding
            self.word_embeddings = VocabParallelEmbedding(
                config.vocab_size, config.hidden_size, mp_group=group,
                gen=gen, device=device)
        self.position_embeddings = Embedding(config.max_position_embeddings,
                                             config.hidden_size, gen, device,
                                             std=1.0)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, input_ids):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        emb = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        return self.dropout(emb)


class GPTAttention(nn.Module):
    def __init__(self, config, gen, device):
        super().__init__()
        self.num_heads = config.num_attention_heads
        self.head_dim = config.hidden_size // self.num_heads
        H = config.hidden_size
        group, mp = model_parallel()
        if mp == 1:
            self.q_proj = Linear(H, H, gen, device)
            self.k_proj = Linear(H, H, gen, device)
            self.v_proj = Linear(H, H, gen, device)
            self.out_proj = Linear(H, H, gen, device)
        else:
            from ..distributed.fleet.meta_parallel import (
                ColumnParallelLinear as Col, RowParallelLinear as Row)
            from .llama import _split_heads
            _split_heads(self.num_heads, self.num_heads, mp)
            self.num_heads //= mp          # this rank's heads
            kw = dict(has_bias=True, gather_output=False, mp_group=group,
                      gen=gen, device=device)
            self.q_proj = Col(H, H, **kw)
            self.k_proj = Col(H, H, **kw)
            self.v_proj = Col(H, H, **kw)
            self.out_proj = Row(H, H, has_bias=True, input_is_parallel=True,
                                mp_group=group, gen=gen, device=device)
        self.dropout_p = config.attention_probs_dropout_prob

    def forward(self, x):
        b, s, _ = x.shape
        hd = self.head_dim
        q = self.q_proj(x).reshape(b, s, -1, hd)
        k = self.k_proj(x).reshape(b, s, -1, hd)
        v = self.v_proj(x).reshape(b, s, -1, hd)
        out = sdpa(q, k, v, causal=True,
                   dropout_p=self.dropout_p if self.training else 0.0)
        return self.out_proj(out.reshape(b, s, -1))


class GPTDecoderLayer(nn.Module):
    def __init__(self, config, gen, device):
        super().__init__()
        H, eps = config.hidden_size, config.layer_norm_eps
        self.ln_1 = LayerNorm(H, eps, device)
        self.attn = GPTAttention(config, gen, device)
        self.ln_2 = LayerNorm(H, eps, device)
        I = config.intermediate_size
        group, mp = model_parallel()
        if mp == 1:
            self.fc_in = Linear(H, I, gen, device)
            self.fc_out = Linear(I, H, gen, device)
        else:
            from ..distributed.fleet.meta_parallel import (
                ColumnParallelLinear as Col, RowParallelLinear as Row)
            kw = dict(has_bias=True, mp_group=group, gen=gen, device=device)
            self.fc_in = Col(H, I, gather_output=False, **kw)
            self.fc_out = Row(I, H, input_is_parallel=True, **kw)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, x):
        h = x + self.attn(self.ln_1(x))
        ff = self.fc_out(F.gelu(self.fc_in(self.ln_2(h)), approximate=True))
        return h + self.dropout(ff)


class GPTModel(nn.Module):
    def __init__(self, config, gen, device):
        super().__init__()
        self.config = config
        self.embeddings = GPTEmbeddings(config, gen, device)
        self.h = nn.ModuleList([GPTDecoderLayer(config, gen, device)
                                for _ in range(config.num_hidden_layers)])
        self.ln_f = LayerNorm(config.hidden_size, config.layer_norm_eps,
                              device)

    def forward(self, input_ids):
        x = self.embeddings(input_ids)
        for layer in self.h:
            x = layer(x)
        return self.ln_f(x)


class GPTForCausalLM(nn.Module):
    """GPT with its (untied, bias-free) lm_head. `device` defaults to CUDA
    (see `paddle_tpu_torch.resolve_device`); `seed` seeds the generator
    the weights are drawn from. `forward(ids, labels)` returns the token
    mean of `ce`, as the reference. `mp_group` / `mp_degree`: the
    model-parallel group the layers split over (None / 1 at mp 1)."""

    def __init__(self, config, device=None, seed=0):
        super().__init__()
        device = resolve_device(device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        self.config = config
        self.mp_group, self.mp_degree = model_parallel()
        self.gpt = GPTModel(config, gen, device)
        if self.mp_degree == 1:
            self.lm_head = Linear(config.hidden_size, config.vocab_size, gen,
                                  device, bias=False)
        else:
            from ..distributed.fleet.meta_parallel import ColumnParallelLinear
            self.lm_head = ColumnParallelLinear(
                config.hidden_size, config.vocab_size, has_bias=False,
                gather_output=False, mp_group=self.mp_group, gen=gen,
                device=device)
        from ..distributed.fleet.meta_parallel import ParallelCrossEntropy
        self.ce = ParallelCrossEntropy(mp_group=self.mp_group)

    def forward(self, input_ids, labels=None):
        logits = self.lm_head(self.gpt(input_ids))
        if labels is not None:
            return self.ce(logits, labels).mean()
        return logits


def gpt_pipeline_layers(config):
    """The reference's LayerDesc list for `PipelineLayer`: not ported."""
    raise NotImplementedError(
        "gpt_pipeline_layers (the pipeline LayerDesc list) is not ported "
        "yet (ROADMAP A8.7)")
