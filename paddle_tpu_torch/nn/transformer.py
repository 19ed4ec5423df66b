"""The Transformer encoder, as `nn.Module`s.

Counterpart of `paddle_tpu/nn/layer/transformer.py`: `MultiHeadAttention`
(without its incremental caches), `TransformerEncoderLayer` (post-norm by
default, pre-norm with `normalize_before`) and `TransformerEncoder`, with
the reference's constructor parameters in its order and its parameter
names (`self_attn.q_proj.weight`, `linear1`, `norm1`, ...). Each layer
draws its weights from the caller's `torch.Generator` (port-only `gen=`,
default torch's global generator) on `device` (default CUDA, see
`paddle_tpu_torch.resolve_device`). `TransformerEncoder` deep-copies its
first layer for the others, as the reference does, so every layer starts
from the same weights.

Attention goes through `F.scaled_dot_product_attention`, so through the
flash kernels on CUDA: non-causal, with the mask given (`attn_mask`,
additive or bool) and attention dropout in training.

Not ported (ROADMAP A9.1): the `cache=` forms and `gen_cache` (the
incremental decoding caches), `weight_attr` / `bias_attr` other than None
(or `bias_attr=False`, no biases), and the decoder classes
(`TransformerDecoderLayer`, `TransformerDecoder`, `Transformer`).
"""
import copy

from torch import nn

from .. import resolve_device
from . import Dropout, LayerNorm, Linear
from . import functional as F

_NO_CACHE = ("the incremental caches of MultiHeadAttention (cache=, "
             "gen_cache) are not ported yet (ROADMAP A9.1)")


def _bias(weight_attr, bias_attr):
    """Whether the layer's Linears carry a bias; ParamAttrs other than the
    defaults are refused."""
    if weight_attr is not None or bias_attr not in (None, False):
        raise NotImplementedError(
            "weight_attr / bias_attr other than None (or bias_attr=False) "
            "are not ported yet (ROADMAP A9.1)")
    return bias_attr is not False


class MultiHeadAttention(nn.Module):
    """q/k/v/out projections around `F.scaled_dot_product_attention`, on
    [batch, seq, embed_dim]."""

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, gen=None, device=None):
        super().__init__()
        device = resolve_device(device)
        bias = _bias(weight_attr, bias_attr)
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.dropout = dropout
        self.need_weights = need_weights
        self.q_proj = Linear(embed_dim, embed_dim, gen, device, bias)
        self.k_proj = Linear(self.kdim, embed_dim, gen, device, bias)
        self.v_proj = Linear(self.vdim, embed_dim, gen, device, bias)
        self.out_proj = Linear(embed_dim, embed_dim, gen, device, bias)

    def gen_cache(self, key, value=None, type=None):
        raise NotImplementedError(_NO_CACHE)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        if cache is not None:
            raise NotImplementedError(_NO_CACHE)
        key = query if key is None else key
        value = key if value is None else value
        b, s = query.shape[0], query.shape[1]
        nh, hd = self.num_heads, self.head_dim
        q = self.q_proj(query).reshape(b, s, nh, hd)
        k = self.k_proj(key).reshape(b, key.shape[1], nh, hd)
        v = self.v_proj(value).reshape(b, value.shape[1], nh, hd)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask,
            dropout_p=self.dropout if self.training else 0.0)
        out = self.out_proj(out.reshape(b, s, self.embed_dim))
        return (out, None) if self.need_weights else out


class TransformerEncoderLayer(nn.Module):
    """Self-attention, then the feed-forward block; each sublayer runs
    sublayer -> dropout -> residual -> norm (post-norm), or norm ->
    sublayer -> dropout -> residual with `normalize_before`. Dropout draws,
    in order: the attention's seed, `dropout1`, the activation's
    `dropout`, `dropout2`."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, gen=None, device=None):
        super().__init__()
        device = resolve_device(device)
        bias = _bias(weight_attr, bias_attr)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr, gen=gen,
                                            device=device)
        self.linear1 = Linear(d_model, dim_feedforward, gen, device, bias)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, gen, device, bias)
        self.norm1 = LayerNorm(d_model, layer_norm_eps, device)
        self.norm2 = LayerNorm(d_model, layer_norm_eps, device)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def _sublayer(self, x, norm, fn, drop):
        y = x + drop(fn(norm(x) if self.normalize_before else x))
        return y if self.normalize_before else norm(y)

    def forward(self, src, src_mask=None, cache=None):
        if cache is not None:
            raise NotImplementedError(_NO_CACHE)
        src = self._sublayer(src, self.norm1,
                             lambda h: self.self_attn(h, h, h, src_mask),
                             self.dropout1)
        return self._sublayer(
            src, self.norm2,
            lambda h: self.linear2(self.dropout(self.activation(
                self.linear1(h)))),
            self.dropout2)

    def gen_cache(self, src):
        raise NotImplementedError(_NO_CACHE)


class TransformerEncoder(nn.Module):
    """`num_layers` encoder layers: `encoder_layer` and deep copies of it
    (so all start from its weights), then the optional final `norm`."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = nn.ModuleList([encoder_layer] + [
            copy.deepcopy(encoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        if cache is not None:
            raise NotImplementedError(_NO_CACHE)
        out = src
        for layer in self.layers:
            out = layer(out, src_mask)
        return self.norm(out) if self.norm is not None else out

    def gen_cache(self, src):
        raise NotImplementedError(_NO_CACHE)
