"""Kernel wrappers and their launch counters.

Every wrapper counts the launches of its CUDA kernel in a plain integer
(`wrapper.launches`), raised by one where it launches the kernel and
nowhere else: a CPU call (the plain version) does not count. A run shows
that it went through the kernels by resetting the counts, running, and
reading `kernel_launches()`. The decode megakernel's top-K fold (its
`head_k > 1` branch) and its speculative verify schedule (`tq > 1`) are
also counted on their own, as "decode_megakernel_topk" and
"decode_megakernel_verify", and so are its tensor-parallel segment
launches, as "decode_megakernel_tp" (all of those launches are in
"decode_megakernel" too), and so are the flash kernels' launches with attention dropout, as
"flash_attention_fwd_dropout" and "flash_attention_bwd_dropout", with an
additive mask, as "flash_attention_{fwd,bwd}_masked", and without the causal
skip, as "flash_attention_{fwd,bwd}_noncausal" (all of them also in
"flash_attention_fwd" and "flash_attention_bwd").
The ragged kernel has two entries, each counted on its own:
`ragged_paged_attention` (chunked prefill) and `spec_verify_attention`
(the speculative verify pass). The launches of the tensor-core builds are
counted on their own too, as "ragged_paged_attention_tc" (the chunked
prefill in bf16, also in "ragged_paged_attention"),
"flash_attention_fwd_tc" (the bf16 forward, also in "flash_attention_fwd")
and "flash_attention_bwd_tc" (the bf16 backward, also in
"flash_attention_bwd"). The launches of the decode kernel and of the ragged
kernel's per-page build that take the staged walk (`paged_route`) are
counted on their own as well: "paged_attention_staged",
"ragged_paged_attention_staged" and "spec_verify_attention_staged" (each
also in its wrapper's count).
"""
from .pallas.decode_megakernel import decode_megakernel
from .pallas.flash_attention import flash_attention_bwd, flash_attention_fwd
from .pallas.paged_attention import (paged_attention, ragged_paged_attention,
                                     spec_verify_attention)
from .pallas.quantized_matmul import quantized_matmul
from .pallas.rms_norm import rms_norm_fwd

_WRAPPERS = {
    "quantized_matmul": quantized_matmul,
    "paged_attention": paged_attention,
    "flash_attention_fwd": flash_attention_fwd,
    "ragged_paged_attention": ragged_paged_attention,
    "spec_verify_attention": spec_verify_attention,
    "rms_norm": rms_norm_fwd,
    "flash_attention_bwd": flash_attention_bwd,
    "decode_megakernel": decode_megakernel,
}


def kernel_launches():
    """{kernel name: launches since the last reset}."""
    out = {name: fn.launches for name, fn in _WRAPPERS.items()}
    out["decode_megakernel_topk"] = decode_megakernel.fold_launches
    out["decode_megakernel_verify"] = decode_megakernel.verify_launches
    out["decode_megakernel_tp"] = decode_megakernel.seg_launches
    out["ragged_paged_attention_tc"] = ragged_paged_attention.tc_launches
    out["flash_attention_fwd_tc"] = flash_attention_fwd.tc_launches
    out["flash_attention_bwd_tc"] = flash_attention_bwd.tc_launches
    for fn in (paged_attention, ragged_paged_attention, spec_verify_attention):
        out[fn.__name__ + "_staged"] = fn.staged_launches
    for fn in (flash_attention_fwd, flash_attention_bwd):
        out[fn.__name__ + "_dropout"] = fn.dropout_launches
        out[fn.__name__ + "_masked"] = fn.mask_launches
        out[fn.__name__ + "_noncausal"] = fn.noncausal_launches
    return out


def reset_kernel_launches():
    for fn in _WRAPPERS.values():
        fn.launches = 0
    decode_megakernel.fold_launches = 0
    decode_megakernel.verify_launches = 0
    decode_megakernel.seg_launches = 0
    ragged_paged_attention.tc_launches = 0
    flash_attention_fwd.tc_launches = 0
    flash_attention_bwd.tc_launches = 0
    for fn in (paged_attention, ragged_paged_attention, spec_verify_attention):
        fn.staged_launches = 0
    for fn in (flash_attention_fwd, flash_attention_bwd):
        fn.dropout_launches = fn.mask_launches = fn.noncausal_launches = 0
