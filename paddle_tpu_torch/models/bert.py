"""BERT family (MLM pretraining, sequence classification), as `nn.Module`s.

Counterpart of `paddle_tpu/models/bert.py`, built on the port's
`nn.transformer.TransformerEncoder`. Weights keep Paddle's [in, out]
layout and the reference's parameter names
(`bert.encoder.layers.{i}.self_attn.q_proj.weight`, `decoder.bias`, ...),
so a state moves between the two packages by name
(`paddle_tpu_torch.convert.load_numpy_params`). Initialisation follows
the reference's distributions, drawn in parameter order from one
`torch.Generator` seeded with `seed`: Normal(0, 1) for the three
embedding tables (Paddle's `nn.Embedding`), XavierUniform weights and
zero biases for the Linears, ones and zeros for the LayerNorms; the
encoder's layers are deep copies of the first.

The attention mask is the reference's: `attention_mask` [b, s] (1 for a
token, 0 for padding) becomes the additive [b, 1, 1, s] mask
`where(m > 0, 0, -1e9)` in the hidden dtype (-1e9 rounds to -998244352
in bf16), which the flash kernels add to every query row of every head.
Attention is bidirectional (`causal=False`).

In training (`self.training`, the default) the embeddings and each
layer's sublayers go through dropout, and attention through the flash
kernels' dropout branch. Outside a `framework.random.key_scope` every
draw takes the global generator's next key (`paddle.seed` is
`framework.random.seed`), in the reference's order: the embeddings, then
per layer the attention's seed, `dropout1`, the activation's dropout and
`dropout2`.
"""
import torch
from torch import nn

from .. import resolve_device
from ..nn import Dropout, Embedding, LayerNorm, Linear
from ..nn import functional as F
from ..nn.transformer import TransformerEncoder, TransformerEncoderLayer


class BertConfig:
    def __init__(self, vocab_size=30522, hidden_size=768, num_hidden_layers=12,
                 num_attention_heads=12, intermediate_size=3072,
                 hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                 max_position_embeddings=512, type_vocab_size=2,
                 layer_norm_eps=1e-12):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.max_position_embeddings = max_position_embeddings
        self.type_vocab_size = type_vocab_size
        self.layer_norm_eps = layer_norm_eps

    @staticmethod
    def base(**kw):
        return BertConfig(**kw)

    @staticmethod
    def tiny(**kw):
        kw.setdefault("vocab_size", 256)
        kw.setdefault("hidden_size", 64)
        kw.setdefault("num_hidden_layers", 2)
        kw.setdefault("num_attention_heads", 4)
        kw.setdefault("intermediate_size", 128)
        kw.setdefault("max_position_embeddings", 64)
        return BertConfig(**kw)


class BertEmbeddings(nn.Module):
    def __init__(self, config, gen, device):
        super().__init__()
        H = config.hidden_size
        self.word_embeddings = Embedding(config.vocab_size, H, gen, device,
                                         std=1.0)
        self.position_embeddings = Embedding(config.max_position_embeddings,
                                             H, gen, device, std=1.0)
        self.token_type_embeddings = Embedding(config.type_vocab_size, H, gen,
                                               device, std=1.0)
        self.layer_norm = LayerNorm(H, config.layer_norm_eps, device)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        emb = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        if token_type_ids is not None:
            emb = emb + self.token_type_embeddings(token_type_ids)
        return self.dropout(self.layer_norm(emb))


class BertModel(nn.Module):
    """Embeddings, the encoder and the pooler; `forward` returns (hidden
    states [b, s, H], pooled = tanh(pooler(first token)))."""

    def __init__(self, config, gen, device):
        super().__init__()
        self.config = config
        self.embeddings = BertEmbeddings(config, gen, device)
        enc_layer = TransformerEncoderLayer(
            config.hidden_size, config.num_attention_heads,
            config.intermediate_size, dropout=config.hidden_dropout_prob,
            activation="gelu",
            attn_dropout=config.attention_probs_dropout_prob,
            layer_norm_eps=config.layer_norm_eps, gen=gen, device=device)
        self.encoder = TransformerEncoder(enc_layer, config.num_hidden_layers)
        self.pooler = Linear(config.hidden_size, config.hidden_size, gen,
                             device)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        h = self.embeddings(input_ids, token_type_ids)
        mask = None
        if attention_mask is not None:
            m = attention_mask[:, None, None, :].to(h.device)
            mask = torch.where(m > 0, 0.0, -1e9).to(h.dtype)
        h = self.encoder(h, mask)
        return h, F.tanh(self.pooler(h[:, 0]))


def _generator(device, seed):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


class BertForMaskedLM(nn.Module):
    """BERT with the MLM head (transform, gelu, LayerNorm, decoder over
    the vocabulary). `forward(..., labels)` returns the cross-entropy mean
    over the labelled positions (`ignore_index=-100`). `device` defaults
    to CUDA; `seed` seeds the weights' generator."""

    def __init__(self, config, device=None, seed=0):
        super().__init__()
        device = resolve_device(device)
        gen = _generator(device, seed)
        self.config = config
        self.bert = BertModel(config, gen, device)
        H = config.hidden_size
        self.transform = Linear(H, H, gen, device)
        self.layer_norm = LayerNorm(H, config.layer_norm_eps, device)
        self.decoder = Linear(H, config.vocab_size, gen, device)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None):
        h, _ = self.bert(input_ids, token_type_ids, attention_mask)
        h = self.layer_norm(F.gelu(self.transform(h)))
        logits = self.decoder(h)
        if labels is not None:
            return F.cross_entropy(logits, labels, ignore_index=-100)
        return logits


class BertForSequenceClassification(nn.Module):
    """BERT with a classifier over the pooled first token (after
    dropout); returns the logits [b, num_classes]."""

    def __init__(self, config, num_classes=2, device=None, seed=0):
        super().__init__()
        device = resolve_device(device)
        gen = _generator(device, seed)
        self.config = config
        self.bert = BertModel(config, gen, device)
        self.dropout = Dropout(config.hidden_dropout_prob)
        self.classifier = Linear(config.hidden_size, num_classes, gen, device)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        return self.classifier(self.dropout(pooled))
