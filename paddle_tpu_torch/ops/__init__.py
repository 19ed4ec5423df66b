"""Kernel wrappers and their launch counters.

Every wrapper counts the launches of its CUDA kernel in a plain integer
(`wrapper.launches`), raised by one where it launches the kernel and
nowhere else: a CPU call (the plain version) does not count. A run shows
that it went through the kernels by resetting the counts, running, and
reading `kernel_launches()`.
"""
from .pallas.decode_megakernel import decode_megakernel
from .pallas.flash_attention import flash_attention_bwd, flash_attention_fwd
from .pallas.paged_attention import paged_attention, ragged_paged_attention
from .pallas.quantized_matmul import quantized_matmul
from .pallas.rms_norm import rms_norm_fwd

_WRAPPERS = {
    "quantized_matmul": quantized_matmul,
    "paged_attention": paged_attention,
    "flash_attention_fwd": flash_attention_fwd,
    "ragged_paged_attention": ragged_paged_attention,
    "rms_norm": rms_norm_fwd,
    "flash_attention_bwd": flash_attention_bwd,
    "decode_megakernel": decode_megakernel,
}


def kernel_launches():
    """{kernel name: launches since the last reset}."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_kernel_launches():
    for fn in _WRAPPERS.values():
        fn.launches = 0
