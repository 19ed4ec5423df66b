"""Which CUDA build each kernel wrapper takes, and what every build's C
entry and Python wrapper check before a launch.

The ragged kernel has two builds (`ragged_route`): the tensor-core build
for the chunked-prefill entry in bf16 at tq > 1 (d 64 or 128, page a
multiple of 16 up to 128), the per-page build for everything else (tq = 1
and the verify entry, held bit for bit to the decode kernel; f32). The
flash forward has two (`flash_fwd_route`): bf16 on wgmma, f32 on the CUDA
cores. The flash backward has two (`flash_bwd_route`): bf16 on the tensor
cores with no dQ partial buffer, f32 with its [ceil(s / 64), b, s, h, d]
partials.
The routes are functions of entry, dtype and shape alone, so they are
pinned here without a card; so are the C entries' argument counts against
`_build.SIGNATURES`, parsed from `csrc/`.
"""
import math
import re

import pytest
import torch

from paddle_tpu_torch import _build
from paddle_tpu_torch.ops.pallas import flash_attention as tf
from paddle_tpu_torch.ops.pallas import paged_attention as tp

torch.set_num_threads(1)

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("entry,dtype,d,p,tq,build", [
    ("prefill", BF16, 128, 64, 128, "tc"),     # the CB engine's prefill at 7B
    ("prefill", BF16, 64, 16, 64, "tc"),
    ("prefill", BF16, 128, 128, 2, "tc"),
    ("prefill", BF16, 64, 48, 32, "tc"),       # a multiple of 16, not of 64
    ("prefill", BF16, 128, 64, 1, "page"),     # tq = 1: the decode kernel's bits
    ("verify", BF16, 128, 64, 4, "page"),      # sequential decode steps' bits
    ("verify", BF16, 128, 64, 1, "page"),
    ("prefill", F32, 128, 64, 128, "page"),    # f32 would be TF32
    ("prefill", BF16, 16, 8, 8, "page"),       # the tiny model
    ("prefill", BF16, 32, 64, 128, "page"),
    ("prefill", BF16, 256, 64, 128, "page"),
    ("prefill", BF16, 128, 8, 128, "page"),
    ("prefill", BF16, 128, 24, 128, "page"),
    ("prefill", BF16, 128, 256, 128, "page"),
])
def test_ragged_route(entry, dtype, d, p, tq, build):
    assert tp.ragged_route(entry, dtype, d, p, tq) == build


def test_ragged_route_refuses_unknown_entries():
    with pytest.raises(ValueError, match="entry"):
        tp.ragged_route("decode", BF16, 128, 64, 128)


@pytest.mark.parametrize("b,s,h,d", [(32, 1024, 16, 64), (8, 1024, 16, 128),
                                     (32, 512, 12, 64), (1, 130, 3, 128),
                                     (2, 200, 2, 64)])
def test_bf16_backward_has_no_partial_buffer(b, s, h, d):
    """Every bf16 backward takes the tensor-core build, which allocates no
    [nk, b, s, h, d] dQ partial; f32 keeps the partials, one per 64-key
    tile."""
    assert tf.flash_bwd_route(BF16, b, s, h, d) == ("tc", None)
    build, shape = tf.flash_bwd_route(F32, b, s, h, d)
    assert build == "f32"
    assert shape == (math.ceil(s / tf.BWD_TILE), b, s, h, d)


# (branch, dtype, b, s, h, d, build): every forward launch of the serving
# and training paths, each branch at its main path's shape
@pytest.mark.parametrize("branch,dtype,b,s,h,d,build", [
    ("causal, serving prefill", BF16, 4, 320, 32, 128, "tc"),
    ("causal, llama350m", BF16, 32, 1024, 16, 64, "tc"),
    ("causal, llama1p3b", BF16, 8, 1024, 16, 128, "tc"),
    ("dropout, gpt3_1p3b", BF16, 8, 1024, 16, 128, "tc"),
    ("mask, non-causal, bert_base", BF16, 32, 512, 12, 64, "tc"),
    ("mask, d 128", BF16, 2, 300, 4, 128, "tc"),
    ("causal, f32 train_parity", F32, 4, 256, 16, 64, "f32"),
    ("dropout, f32", F32, 2, 1024, 16, 128, "f32"),
    ("mask, non-causal, bert_base f32", F32, 32, 512, 12, 64, "f32"),
    ("mask, f32, d 128", F32, 2, 300, 4, 128, "f32"),
])
def test_flash_fwd_route(branch, dtype, b, s, h, d, build):
    """bf16 takes the wgmma build at d 64 and 128 whatever the branch
    (causal, dropout, mask); f32 keeps the CUDA-core build (TF32 would
    break the f32 parity gates)."""
    assert tf.flash_fwd_route(dtype, b, s, h, d) == build


def _c_entries():
    """{name: number of parameters} of every `extern "C" int` in csrc/."""
    out = {}
    for src in _build.sources():
        text = src.read_text()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            params = [x for x in m.group(2).split(",") if x.strip()]
            out[m.group(1)] = (len(params), src.name)
    return out


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_every_signature_has_a_c_entry(name):
    """Each C entry that `_build.library()` binds is defined in csrc/ with
    as many parameters as its ctypes signature lists."""
    entries = _c_entries()
    assert name in entries, f"{name} has no extern \"C\" int definition"
    n, src = entries[name]
    assert n == len(_build.SIGNATURES[name]), (name, src, n)


def test_tensor_core_sources_are_built():
    names = {s.name for s in _build.sources()}
    assert {"ragged_paged_attention_tc.cu", "flash_attention_bwd_tc.cu",
            "ragged_paged_attention.cu", "flash_attention_bwd.cu",
            "flash_attention_tc.cu", "flash_attention.cu"} <= names


def _no_library(monkeypatch):
    def refuse():
        raise AssertionError("a launch was attempted")
    monkeypatch.setattr(_build, "library", refuse)


def test_ragged_wrappers_validate_before_launch(monkeypatch):
    """Shapes are checked before the device (meta tensors reach no
    library), and the dtype and head-dim checks of the CUDA path raise
    before any build: the wrappers never call `_build.library()` on
    inputs they refuse."""
    _no_library(monkeypatch)
    meta = dict(device="meta")
    q = torch.empty(2, 8, 4, 64, dtype=BF16, **meta)
    kp = torch.empty(6, 16, 2, 64, dtype=BF16, **meta)
    table = torch.empty(2, 3, dtype=torch.int32, **meta)
    lens = torch.empty(2, dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="shapes"):
        tp.ragged_paged_attention(q, kp, kp[:, :, :1], table, lens, lens)
    with pytest.raises(ValueError, match="shapes"):
        tp.spec_verify_attention(q[:, :, :3], kp, kp, table, lens)
    with pytest.raises(ValueError, match="unsupported device"):
        tp.ragged_paged_attention(q, kp, kp, table, lens, lens)
    with pytest.raises(ValueError, match="unsupported device"):
        tp.spec_verify_attention(q, kp, kp, table, lens)


def test_flash_backward_validates_before_launch(monkeypatch):
    _no_library(monkeypatch)
    q = torch.empty(1, 64, 2, 64, dtype=BF16, device="meta")
    lse = torch.empty(1, 2, 64, dtype=F32, device="meta")
    with pytest.raises(ValueError, match="lse"):
        tf.flash_attention_bwd(q, q, q, q, lse[:, :1], q)
    with pytest.raises(ValueError, match="must match"):
        tf.flash_attention_bwd(q, q, q, q[:, :32], lse, q)
    with pytest.raises(ValueError, match="unsupported device"):
        tf.flash_attention_bwd(q, q, q, q, lse, q)


def test_flash_forward_validates_before_launch(monkeypatch):
    """Shapes, s_true, dropout and the mask's broadcast are checked before
    the device: meta tensors reach no library."""
    _no_library(monkeypatch)
    q = torch.empty(1, 64, 2, 64, dtype=BF16, device="meta")
    with pytest.raises(ValueError, match="equal"):
        tf.flash_attention_fwd(q, q[:, :32], q)
    with pytest.raises(ValueError, match="s_true"):
        tf.flash_attention_fwd(q, q, q, s_true=65)
    with pytest.raises(ValueError, match="dropout_p"):
        tf.flash_attention_fwd(q, q, q, dropout_p=1.0)
    with pytest.raises(ValueError, match="seed"):
        tf.flash_attention_fwd(q, q, q, dropout_p=0.1)
    mask = torch.empty(1, 3, 64, 64, dtype=F32, device="meta")
    with pytest.raises(ValueError, match="broadcast"):
        tf.flash_attention_fwd(q, q, q, mask=mask)
    with pytest.raises(ValueError, match="unsupported device"):
        tf.flash_attention_fwd(q, q, q)


def test_forward_tc_launches_are_counted():
    """`kernel_launches()` reads the wgmma build's launches apart (they are
    also in "flash_attention_fwd") and the reset clears them."""
    from paddle_tpu_torch.ops import kernel_launches, reset_kernel_launches
    tf.flash_attention_fwd.tc_launches = 3
    assert kernel_launches()["flash_attention_fwd_tc"] == 3
    reset_kernel_launches()
    assert kernel_launches()["flash_attention_fwd_tc"] == 0


@pytest.mark.parametrize("dtypes,d,match", [
    ((BF16, BF16, BF16, F32, BF16), 64, "one dtype"),
    ((torch.float16,) * 5, 64, "one dtype"),
    ((BF16,) * 5, 96, "d 64 or 128"),
    ((F32,) * 5, 32, "d 64 or 128"),
])
def test_flash_kernel_input_check(dtypes, d, match):
    """The check the CUDA path of both flash wrappers runs before a
    launch: one dtype of bf16 or f32 across q, k, v, o and dO, d 64 or
    128."""
    q, k, v, o, do = (torch.empty(1, 4, 1, d, dtype=t) for t in dtypes)
    with pytest.raises(ValueError, match=match):
        tf._check_kernel_inputs("flash_attention_bwd", q, k, v, d, (o, do))


def test_flash_kernel_input_check_takes_both_builds():
    for dt in (BF16, F32):
        for d in (64, 128):
            x = torch.empty(1, 4, 1, d, dtype=dt)
            tf._check_kernel_inputs("flash_attention_bwd", x, x, x, d, (x, x))


def test_aligned16_copies_only_misaligned_tensors():
    base = torch.zeros(64, dtype=BF16)
    assert _build.aligned16(base) is base
    off = base[1:9]
    assert off.data_ptr() % 16
    fixed = _build.aligned16(off)
    assert fixed.data_ptr() % 16 == 0 and torch.equal(fixed, off)


@pytest.mark.parametrize("kernel,group", [
    ("flash_fwd_kernel", "flash_attention_fwd"),       # f32 forward
    ("flash_fwd_tc_kernel", "flash_attention_fwd"),    # bf16, wgmma
    ("flash_bwd_kernel", "flash_attention_bwd"),     # f32 backward
    ("bwd_dkdv_kernel", "flash_attention_bwd"),      # bf16, tensor cores
    ("bwd_dq_kernel", "flash_attention_bwd"),
    ("rms_fwd_kernel", "rms_norm"),
])
def test_profile_groups_name_every_training_kernel(kernel, group):
    """The training profile sums device time by kernel group: each
    training kernel of csrc/ lands in its own group, not in "other"."""
    from paddle_tpu_torch.train_llama import KERNEL_GROUPS
    defined = "".join(s.read_text() for s in _build.sources())
    assert re.search(rf"\b{kernel}\(", defined), f"{kernel} not in csrc/"
    name = f"void (anonymous namespace)::{kernel}<128, false, false>(int)"
    assert next(g for g, pat in KERNEL_GROUPS if pat.search(name)) == group
