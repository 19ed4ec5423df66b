"""Move a `paddle_tpu` model's parameters into a `paddle_tpu_torch` model.

Both packages keep Paddle's [in, out] weight layout and the same parameter
names, so the copy is by name with no transposes.
"""
import numpy as np
import torch


def load_numpy_params(model, arrays):
    """Copy `arrays` ({parameter name: numpy array}, e.g. the JAX model's
    `named_parameters()` as numpy) into `model` in place. Every name of
    either side must appear on the other with the same shape; anything
    else raises ValueError. Values are copied bit for bit (dtype cast only
    where the two dtypes differ)."""
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(arrays))
    extra = sorted(set(arrays) - set(params))
    if missing or extra:
        raise ValueError(f"parameter names differ: missing {missing}, "
                         f"unexpected {extra}")
    for name, p in params.items():
        a = np.asarray(arrays[name])
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(a.shape)} does not match "
                             f"the model's {tuple(p.shape)}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(torch.tensor(np.asarray(arrays[name])))
    return model
