"""Quantization observers (counterpart of `paddle_tpu/quantization/`).

The part the PTQ calibration (`quantization/ptq.py`) needs: the running
absmax activation observer, the observer base class (an `nn.Module` whose
forward watches the tensor flowing through it and returns it unchanged),
the default PTQ activation observer `_AbsmaxActObserver` and the
`_ObservedLinear` calibration wrapper. The QAT layers, the `quanter`
factories and the `PTQ` / `QuantConfig` deploy API of the reference are
not ported.
"""
import torch
from torch import nn


class AbsmaxObserver:
    """Running absmax of every tensor observed; `scale()` is absmax / qmax
    (1.0 before anything nonzero was seen)."""

    def __init__(self, quant_bits=8):
        self.quant_bits = quant_bits
        self._absmax = 0.0

    def observe(self, x):
        x = torch.as_tensor(x)
        self._absmax = max(self._absmax, float(torch.max(torch.abs(x))))
        return self

    def scale(self):
        qmax = 2 ** (self.quant_bits - 1) - 1
        return self._absmax / qmax if self._absmax else 1.0


class BaseObserver(nn.Module):
    """A module that watches the tensors flowing through it (forward
    returns its input) and reports quantization parameters."""

    def __init__(self, quant_bits=8):
        super().__init__()
        self.quant_bits = quant_bits

    def forward(self, x):
        self._observe(x)
        return x

    def _observe(self, x):
        raise NotImplementedError

    def scales(self):
        raise NotImplementedError

    def zero_points(self):
        return 0.0


class _AbsmaxActObserver(BaseObserver):
    """Default PTQ activation observer: running absmax."""

    def __init__(self, quant_bits=8):
        super().__init__(quant_bits)
        self._impl = AbsmaxObserver(quant_bits)

    def _observe(self, x):
        self._impl.observe(x.detach())

    @property
    def observed(self):
        return self._impl._absmax > 0

    def scales(self):
        return self._impl.scale()


class _ObservedLinear(nn.Module):
    """Calibration wrapper: observe the activations, run the Linear."""

    def __init__(self, linear, act_observer):
        super().__init__()
        self.inner = linear
        self.act_observer = act_observer

    def forward(self, x):
        if self.act_observer is not None:
            x = self.act_observer(x)
        return self.inner(x)
