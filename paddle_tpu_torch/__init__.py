"""paddle_tpu_torch: the PyTorch + CUDA counterpart of `paddle_tpu`.

The JAX package `paddle_tpu` is the reference; this package mirrors its
layout (`models/llama.py`, `inference/serving.py`, `ops/pallas/<kernel>.py`)
and replaces each Pallas TPU kernel with a CUDA kernel written by hand for
Hopper (`csrc/*.cu`, built by `_build.py` at first use).

Device rule: every entry point runs on ``"cuda"`` unless the caller passes
``device="cpu"``. Without a CUDA device and without an explicit CPU
request it raises; it never drops to the CPU on its own.
"""
import torch

__version__ = "0.1.0"


def resolve_device(device=None):
    """The device an entry point runs on: ``"cuda"`` by default, the CPU
    only when asked for. Raises when CUDA is asked for (explicitly or by
    default) and no CUDA device is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on CUDA by default and no CUDA device "
                "is available; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {device!r}: expected cuda or cpu")
