"""Parameter initialisers drawn from a `torch.Generator`, with the
reference's distributions (`paddle_tpu/nn/initializer`): XavierUniform,
XavierNormal and Normal over Paddle's [in, out] (or [num, dim]) shapes."""
import math

import torch


def xavier_uniform(shape, gen, device):
    fan_in, fan_out = shape
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape, device=device).uniform_(-limit, limit,
                                                      generator=gen)


def xavier_normal(shape, gen, device):
    fan_in, fan_out = shape
    std = math.sqrt(2.0 / (fan_in + fan_out))
    return torch.empty(shape, device=device).normal_(0.0, std, generator=gen)


def normal(shape, gen, device, mean=0.0, std=1.0):
    return torch.empty(shape, device=device).normal_(mean, std, generator=gen)
