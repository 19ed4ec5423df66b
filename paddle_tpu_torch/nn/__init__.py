"""The layers the port's models are built from, as plain `nn.Module`s.

Counterparts of `paddle_tpu/nn/layer/common.py` (`Linear`, `Embedding`,
`Dropout`) and `norm.py` (`LayerNorm`), and of the model-parallel layers
at one rank (`ColumnParallelLinear`, `RowParallelLinear`,
`VocabParallelEmbedding`), which compute the same. Weights keep Paddle's
[in, out] layout and the reference's parameter names (`weight`, `bias`);
initial values are drawn from the caller's `torch.Generator` with the
reference's distributions (`nn/initializer.py`): XavierUniform weights and
zero biases for a Linear, ones and zeros for a LayerNorm.
"""
import torch
from torch import nn

from . import functional as F
from .initializer import normal, xavier_normal, xavier_uniform


class Linear(nn.Module):
    """y = x @ W (+ b), W [in, out]; `bias=False` leaves `bias` None."""

    def __init__(self, in_features, out_features, gen, device, bias=True):
        super().__init__()
        self.weight = nn.Parameter(
            xavier_uniform((in_features, out_features), gen, device))
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device))
                     if bias else None)

    def forward(self, x):
        y = x @ self.weight
        return y if self.bias is None else y + self.bias


class Embedding(nn.Module):
    """Rows of a [num, dim] table; XavierNormal (VocabParallelEmbedding)
    by default, or Normal(0, `std`) (Paddle's `nn.Embedding`)."""

    def __init__(self, num_embeddings, embedding_dim, gen, device, std=None):
        super().__init__()
        shape = (num_embeddings, embedding_dim)
        self.weight = nn.Parameter(
            xavier_normal(shape, gen, device) if std is None
            else normal(shape, gen, device, std=std))

    def forward(self, ids):
        return self.weight[ids]


class LayerNorm(nn.Module):
    """`F.layer_norm` over the last dim with a weight (ones) and a bias
    (zeros)."""

    def __init__(self, hidden_size, epsilon, device):
        super().__init__()
        self._epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(hidden_size, device=device))
        self.bias = nn.Parameter(torch.zeros(hidden_size, device=device))

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1], self.weight, self.bias,
                            self._epsilon)


class Dropout(nn.Module):
    """`F.dropout` in training mode (`self.training`), its keys from the
    framework key stream (`framework.random.next_key`)."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train"):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, self.axis, self.training, self.mode)
