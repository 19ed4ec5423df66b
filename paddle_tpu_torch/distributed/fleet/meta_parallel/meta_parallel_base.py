"""MetaParallelBase (ref: python/paddle/distributed/fleet/meta_parallel/
meta_parallel_base.py), counterpart of the reference's: an `nn.Module`
around the user's layers whose parameters and state dict are the wrapped
layers' (names unprefixed), so a state moves between the wrapper and the
bare model by name."""
from torch import nn


class MetaParallelBase(nn.Module):
    def __init__(self, layers, hcg, strategy=None):
        super().__init__()
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy
        self._prepare_for_model()

    def _prepare_for_model(self):
        pass

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def load_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.load_state_dict(state_dict, *args, **kwargs)

    set_state_dict = load_state_dict

    def parameters(self, recurse=True):
        return self._layers.parameters(recurse)

    def named_parameters(self, prefix="", recurse=True,
                         remove_duplicate=True):
        return self._layers.named_parameters(prefix, recurse,
                                             remove_duplicate)
