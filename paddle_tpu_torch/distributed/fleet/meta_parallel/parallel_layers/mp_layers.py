"""Megatron-style tensor-parallel layers, a shard a rank.

Counterpart of `paddle_tpu/distributed/fleet/meta_parallel/
parallel_layers/mp_layers.py` (ref: python/paddle/distributed/fleet/
layers/mpu/mp_layers.py — VocabParallelEmbedding:35,
ColumnParallelLinear:173, RowParallelLinear:332, ParallelCrossEntropy:498).
The reference's Parameters hold the full logical tensor with a `dist_attr`
and one SPMD program shards them; here, as in Paddle, each model-parallel
rank is a process holding its own shard (`weight` of the local shape), and
the layer's collectives are `mp_ops`' autograd functions over the
model-parallel group. Each parameter records the reference's `dist_attr`
(the mesh axis of each dim: "model" on the split one) and
`is_distributed`, which `convert.shard_numpy_params` / `gather_shards`
read.

Weights keep Paddle's [in, out] layout. A layer draws the FULL tensor
from the caller's `torch.Generator` with the reference's distribution
(XavierNormal for the embedding, XavierUniform for the linears, zero
biases) and keeps its slice: every rank draws the same stream, so a model
built at mp n holds exactly the slices of the same model built at mp 1.

The model-parallel group is `mp_group`, else `fleet.init`'s; in a world of
1 it has one member whatever mp_degree says, and each layer holds the
whole weight and computes exactly what `nn.Linear` / `nn.Embedding` of
the port compute.
"""
import torch
from torch import nn

from .....nn.initializer import xavier_normal, xavier_uniform
from . import mp_ops


def _mp_group_and_size(mp_group=None):
    group = mp_ops.resolve_group(mp_group)
    return group, 1 if group is None else group.nranks


def _no_attr(weight_attr):
    if weight_attr is not None:
        raise NotImplementedError(
            "weight_attr (a ParamAttr initialiser) is not ported; the layer "
            "draws the reference's default distribution from `gen` "
            "(ROADMAP A9.1)")


def _rank(group):
    return 0 if group is None else group.rank


def _param(t, dist_attr, world):
    p = nn.Parameter(t.contiguous())
    p.dist_attr = dist_attr
    p.is_distributed = world > 1 and "model" in dist_attr
    return p


class VocabParallelEmbedding(nn.Module):
    """ref: mp_layers.py:35 — the vocab dim split over the group: rank r
    holds rows [r V / n, (r + 1) V / n)."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, gen=None, device=None):
        super().__init__()
        _no_attr(weight_attr)
        self.group, self.world_size = _mp_group_and_size(mp_group)
        if num_embeddings % self.world_size:
            raise ValueError(f"VocabParallelEmbedding: vocab {num_embeddings}"
                             f" is not divisible by mp {self.world_size}")
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        n = num_embeddings // self.world_size
        self.vocab_start = _rank(self.group) * n
        full = xavier_normal((num_embeddings, embedding_dim), gen, device)
        self.weight = _param(full[self.vocab_start:self.vocab_start + n],
                             ("model", None), self.world_size)

    def forward(self, x):
        if self.group is None:
            return self.weight[x]
        n = self.weight.shape[0]
        local = x - self.vocab_start
        in_range = (local >= 0) & (local < n)
        out = self.weight[local.clamp(0, n - 1)]
        out = torch.where(in_range[..., None], out, torch.zeros_like(out))
        # disjoint per-rank rows: the identity-backward completion, so the
        # table's gradient is not summed again over the group
        return mp_ops._mp_allreduce(out, group=self.group)


class ColumnParallelLinear(nn.Module):
    """ref: mp_layers.py:173 — weight [in, out] split on out."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=None, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, gen=None, device=None):
        super().__init__()
        _no_attr(weight_attr)
        self.group, self.world_size = _mp_group_and_size(mp_group)
        if out_features % self.world_size:
            raise ValueError(f"ColumnParallelLinear: out_features "
                             f"{out_features} is not divisible by mp "
                             f"{self.world_size}")
        self.in_features = in_features
        self.out_features = out_features
        self.gather_output = gather_output
        n = self.output_size_per_partition = out_features // self.world_size
        c0 = _rank(self.group) * n
        full = xavier_uniform((in_features, out_features), gen, device)
        self.weight = _param(full[:, c0:c0 + n], (None, "model"),
                             self.world_size)
        has_bias = True if has_bias is None else has_bias
        self.bias = (_param(torch.zeros(n, device=device), ("model",),
                            self.world_size) if has_bias else None)

    def forward(self, x):
        x = mp_ops._c_identity(x, group=self.group)
        y = x @ self.weight
        if self.bias is not None:
            y = y + self.bias
        if self.gather_output:
            y = mp_ops._c_concat(y, group=self.group)
        return y


class RowParallelLinear(nn.Module):
    """ref: mp_layers.py:332 — weight [in, out] split on in; the bias is
    replicated and added after the all-reduce."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None, gen=None,
                 device=None):
        super().__init__()
        _no_attr(weight_attr)
        self.group, self.world_size = _mp_group_and_size(mp_group)
        if in_features % self.world_size:
            raise ValueError(f"RowParallelLinear: in_features {in_features} "
                             f"is not divisible by mp {self.world_size}")
        self.in_features = in_features
        self.out_features = out_features
        self.input_is_parallel = input_is_parallel
        n = self.input_size_per_partition = in_features // self.world_size
        r0 = _rank(self.group) * n
        full = xavier_uniform((in_features, out_features), gen, device)
        self.weight = _param(full[r0:r0 + n], ("model", None),
                             self.world_size)
        self.bias = (_param(torch.zeros(out_features, device=device),
                            (None,), self.world_size) if has_bias else None)

    def forward(self, x):
        if not self.input_is_parallel:
            x = mp_ops._c_split(x, group=self.group)
        y = mp_ops._mp_allreduce(x @ self.weight, group=self.group)
        return y if self.bias is None else y + self.bias


class ParallelCrossEntropy(nn.Module):
    """ref: mp_layers.py:498 — per-token CE over vocab-split logits,
    [..., 1] in f32."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.group, self.world_size = _mp_group_and_size(mp_group)
        self.ignore_index = ignore_index

    def forward(self, input, label):
        return mp_ops._c_softmax_with_cross_entropy(
            input, label, group=self.group, ignore_index=self.ignore_index)
