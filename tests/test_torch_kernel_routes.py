"""Which CUDA build each kernel wrapper takes, and what every build's C
entry and Python wrapper check before a launch.

The ragged kernel has two builds (`ragged_route`): the tensor-core build
for the chunked-prefill entry in bf16 at tq > 1 (d 64 or 128, page a
multiple of 16 up to 128), the per-page build for everything else (tq = 1
and the verify entry, held bit for bit to the decode kernel; f32). The
flash forward has two (`flash_fwd_route`): bf16 on wgmma, f32 on the CUDA
cores. The flash backward has two (`flash_bwd_route`): bf16 on the tensor
cores with no dQ partial buffer, f32 with its [ceil(s / key tile), b, s,
h, d] partials (128 keys a tile at d 64, 64 at d 128).
The routes are functions of entry, dtype and shape alone, so they are
pinned here without a card; so are the C entries' argument counts against
`_build.SIGNATURES`, parsed from `csrc/`.
"""
import ctypes
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
    [nk, b, s, h, d] dQ partial; f32 keeps the partials, one per key tile
    of `csrc/flash_attention_bwd.cu` (128 keys at d 64, 64 at d 128)."""
    assert tf.flash_bwd_route(BF16, b, s, h, d) == ("tc", None)
    build, shape = tf.flash_bwd_route(F32, b, s, h, d)
    assert build == "f32"
    assert shape == (math.ceil(s / tf.bwd_key_tile(d)), b, s, h, d)


# (b, s, h, d, partials): the f32 backward's dQ partial count at the
# shapes the f32 paths launch: BERT-base f32 (4 partials of 128 keys, half
# the 64-key tile's 8), the d 128 rows of chip_smoke, the f32 LLaMA parity
# shape, ragged lengths
@pytest.mark.parametrize("b,s,h,d,n_part", [
    (32, 512, 12, 64, 4),
    (2, 1024, 16, 128, 16),
    (2, 300, 4, 128, 5),
    (4, 256, 16, 64, 2),
    (2, 200, 2, 64, 2),
    (1, 130, 3, 128, 3),
    (2, 129, 2, 64, 2),
])
def test_f32_backward_partials_by_key_tile(b, s, h, d, n_part):
    """The f32 build takes 128-key tiles at d 64 (K, V, two stages of Q and
    dO, P and dS in 193 KB of shared memory) and 64-key tiles at d 128
    (225 KB), and never a tensor-core build."""
    assert tf.bwd_key_tile(d) == (128 if d == 64 else 64)
    build, shape = tf.flash_bwd_route(F32, b, s, h, d)
    assert build == "f32"
    assert shape == (n_part, b, s, h, d)
    assert tf.flash_fwd_route(F32, b, s, h, d) == "f32"


def test_f32_backward_entry_takes_the_partial_count():
    """The C entry of the f32 backward takes n_part right after the
    partial buffer, so a wrapper whose key tile disagreed with the
    kernel's would be refused there, not write past the buffer."""
    text = next(src for src in _build.sources()
                if src.name == "flash_attention_bwd.cu").read_text()
    m = re.search(r'extern "C" int ptt_flash_attention_bwd\(([^)]*)\)', text)
    params = [x.split()[-1].lstrip("*") for x in m.group(1).split(",")]
    assert params[6:8] == ["dq_part", "n_part"]
    assert _build.SIGNATURES["ptt_flash_attention_bwd"][7] is ctypes.c_int
    assert "n_part != (s + Tile<D>::kBK - 1) / Tile<D>::kBK" in text


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


# every (dtype, d, page) the engines and chip_smoke.py launch the decode
# kernel or the per-page ragged build at: pages 8, 16, 64, 128; d 16, 64,
# 128; bf16 and f32 (the GQA factor does not enter the plan). Two stages
# of f32 pages of 128 tokens at d 128 (2 x 128 KB) exceed the ring's
# budget: that shape keeps the direct walk.
_PAGED_SHAPES = [(dt, d, p) for dt in (BF16, F32) for d in (16, 64, 128)
                 for p in (8, 16, 64, 128)]


@pytest.mark.parametrize("dtype,d,p", _PAGED_SHAPES)
def test_paged_route_and_stage_plan(dtype, d, p):
    stages, nbytes = tp.paged_stage_plan(dtype, d, p)
    stage = 2 * p * d * (4 if dtype == F32 else 2)
    direct = (dtype, d, p) == (F32, 128, 128)
    assert tp.paged_route(dtype, d, p) == ("direct" if direct else "staged")
    if direct:
        assert (stages, nbytes) == (0, 0)
        assert 2 * stage > tp.RING_BUDGET_BYTES
        return
    assert 2 <= stages <= tp.RING_MAX_STAGES
    assert nbytes == stages * stage <= tp.RING_BUDGET_BYTES
    # as many bytes in flight as the target asks, unless the stage cap or
    # the budget stops the ring first; never a stage more than needed
    assert (nbytes >= tp.RING_TARGET_BYTES or stages == tp.RING_MAX_STAGES
            or nbytes + stage > tp.RING_BUDGET_BYTES)
    assert stages == 2 or (stages - 1) * stage < tp.RING_TARGET_BYTES
    assert (d * (4 if dtype == F32 else 2)) % 16 == 0   # one bulk copy a row


@pytest.mark.parametrize("dtype,d,p", [(BF16, 256, 128), (F32, 256, 64),
                                       (F32, 128, 128)])
def test_paged_route_direct_where_two_stages_do_not_fit(dtype, d, p):
    assert tp.paged_route(dtype, d, p) == "direct"
    assert tp.paged_stage_plan(dtype, d, p) == (0, 0)


def test_paged_stage_plan_refuses_rows_off_16_bytes():
    with pytest.raises(ValueError, match="16 bytes"):
        tp.paged_stage_plan(BF16, 4, 64)
    with pytest.raises(ValueError, match="no kernel"):
        tp.paged_stage_plan(torch.float16, 64, 64)


def _pools(offset):
    """Meta pools [6, 16, 2, 64] bf16 whose data starts `offset` elements
    into their storage (a meta tensor's data_ptr is its byte offset)."""
    flat = torch.empty(offset + 6 * 16 * 2 * 64, dtype=BF16, device="meta")
    return flat[offset:].view(6, 16, 2, 64)


@pytest.mark.parametrize("entry", ["paged_attention", "ragged_paged_attention",
                                   "spec_verify_attention"])
def test_wrappers_refuse_pools_off_16_bytes_before_launch(monkeypatch, entry):
    """The staged walk's bulk copies and the tensor-core build move
    16-byte pieces: a pool that does not start on 16 bytes is refused by
    every wrapper before any build (meta tensors reach no library)."""
    _no_library(monkeypatch)
    table = torch.empty(2, 3, dtype=torch.int32, device="meta")
    lens = torch.empty(2, dtype=torch.int32, device="meta")
    good, bad = _pools(0), _pools(1)
    assert bad.data_ptr() % 16 and good.data_ptr() % 16 == 0
    q = torch.empty(2, 4, 64, dtype=BF16, device="meta")
    q4 = torch.empty(2, 8, 4, 64, dtype=BF16, device="meta")
    calls = {
        "paged_attention": lambda kp, vp: tp.paged_attention(q, kp, vp, table, lens),
        "ragged_paged_attention": lambda kp, vp: tp.ragged_paged_attention(
            q4, kp, vp, table, lens, lens),
        "spec_verify_attention": lambda kp, vp: tp.spec_verify_attention(
            q4, kp, vp, table, lens),
    }
    for kp, vp in ((bad, good), (good, bad)):
        with pytest.raises(ValueError, match="16 bytes"):
            calls[entry](kp, vp)
    with pytest.raises(ValueError, match="unsupported device"):
        calls[entry](good, good)


def test_paged_attention_validates_before_launch(monkeypatch):
    """Shapes, dtypes and the head dim are checked before the device and
    before any build: meta tensors reach no library."""
    _no_library(monkeypatch)
    meta = dict(device="meta")
    q = torch.empty(2, 4, 64, dtype=BF16, **meta)
    kp = torch.empty(6, 16, 2, 64, dtype=BF16, **meta)
    table = torch.empty(2, 3, dtype=torch.int32, **meta)
    lens = torch.empty(2, dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="shapes"):
        tp.paged_attention(q, kp, kp[:, :, :1], table, lens)
    with pytest.raises(ValueError, match="shapes"):
        tp.paged_attention(q[:, :3], kp, kp, table, lens)
    with pytest.raises(ValueError, match="shapes"):
        tp.paged_attention(q, kp, kp, table[:1], lens)
    with pytest.raises(ValueError, match="shapes"):
        tp.paged_attention(q, kp, kp, table, lens[:1])
    with pytest.raises(ValueError, match="same dtype"):
        tp.paged_attention(q, kp.float(), kp, table, lens)
    q40 = torch.empty(2, 4, 40, dtype=BF16, **meta)
    kp40 = torch.empty(6, 16, 2, 40, dtype=BF16, **meta)
    with pytest.raises(ValueError, match="multiple of 16"):
        tp.paged_attention(q40, kp40, kp40, table, lens)
    with pytest.raises(ValueError, match="unsupported device"):
        tp.paged_attention(q, kp, kp, table, lens)


def test_per_page_kernels_share_the_page_step_and_the_ring():
    """Both per-page kernels walk their pages through one `PageRing` and
    one `online_softmax_page`, and the decode megakernel's attention phase
    still calls the same page step: tq = 1 and verify rows equal decode
    steps, and #7's attention equals #4, bit for bit."""
    csrc = _build.sources()[0].parent
    for name in ("paged_attention.cu", "ragged_paged_attention.cu"):
        text = (csrc / name).read_text()
        assert "ptt::online_softmax_page<" in text, name
        assert "ptt::PageRing<T>" in text, name
    assert "ptt::online_softmax_page<" in (csrc / "decode_megakernel.cuh").read_text()
    assert "struct PageRing" in (csrc / "common.cuh").read_text()


def test_staged_launches_are_counted_apart():
    """Each wrapper with a staged walk counts its staged launches beside
    `.launches`; `kernel_launches()` reads them and the reset clears them."""
    from paddle_tpu_torch.ops import kernel_launches, reset_kernel_launches
    wrappers = (tp.paged_attention, tp.ragged_paged_attention, tp.spec_verify_attention)
    reset_kernel_launches()
    for fn in wrappers:
        assert fn.staged_launches == 0 and fn.launches == 0
        assert kernel_launches()[fn.__name__ + "_staged"] == 0
        fn.staged_launches = 2
        assert kernel_launches()[fn.__name__ + "_staged"] == 2
    reset_kernel_launches()
    assert all(kernel_launches()[fn.__name__ + "_staged"] == 0 for fn in wrappers)


def test_cpu_calls_take_the_plain_version_and_count_nothing():
    """A CPU tensor takes the plain version on every shape, staged or
    direct by route: no launch, no staged launch."""
    from paddle_tpu_torch.ops import reset_kernel_launches
    reset_kernel_launches()
    g = torch.Generator().manual_seed(0)
    for dt, d, p in ((BF16, 64, 16), (F32, 128, 128)):
        q = torch.randn(2, 4, d, generator=g).to(dt)
        kp = torch.randn(4, p, 2, d, generator=g).to(dt)
        table = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
        lens = torch.tensor([p + 3, 1], dtype=torch.int32)
        out = tp.paged_attention(q, kp, kp, table, lens)
        ref = tp.paged_attention_reference(q, kp, kp, table, lens)
        assert torch.equal(out, ref)
        assert tp.paged_attention.launches == tp.paged_attention.staged_launches == 0


@pytest.fixture(scope="module")
def chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


# (kind, elem bytes, dropout, bound ms, bound by) at BERT-base's mask rows
# (b 32, s 512, h 12, d 64, non-causal, a [b, 1, 1, s] mask in the rows'
# dtype): f32 on the CUDA cores' 67 TFLOP/s, bf16 on the tensor cores'
# 989 TFLOP/s (those figures as before the f32 rows moved)
@pytest.mark.parametrize("kind,elem,dropout,ms,by", [
    ("fwd", 4, False, 0.3846, "operations"),
    ("bwd", 4, False, 0.9616, "operations"),
    ("fwd", 4, True, 0.4087, "operations"),
    ("bwd", 4, True, 0.9856, "operations"),
    ("fwd", 2, False, 0.0303, "bytes"),
    ("bwd", 2, False, 0.0651, "operations"),
])
def test_chip_smoke_flash_bounds(chip_smoke, kind, elem, dropout, ms, by):
    """`chip_smoke.flash_bound`, the bound of the flash rows: 4 d flops a
    visible pair forward, 10 d backward, plus 16 hash operations with
    dropout; an f32 row's flops go over the CUDA cores' f32 rate."""
    b, s, h, d = 32, 512, 12, 64
    got, got_by = chip_smoke.flash_bound(kind, b, s, h, d, elem, False,
                                         b * s * elem, dropout)
    assert got == pytest.approx(ms, abs=5e-5) and got_by == by


def test_chip_smoke_bound_ms_by_dtype(chip_smoke):
    """`bound_ms` divides tensor-core flops by the bf16 peak, and an f32
    row's flops by the CUDA cores' rate; bytes bound either alike."""
    bound_ms = chip_smoke.bound_ms
    assert bound_ms(0, 989e9) == (pytest.approx(1.0), "operations")
    assert bound_ms(0, 67e9, f32=True) == (pytest.approx(1.0), "operations")
    assert bound_ms(0, 0, 67e9) == (pytest.approx(1.0), "operations")
    assert bound_ms(3.35e9, 1e9, f32=True) == (pytest.approx(1.0), "bytes")


# -- the LoRA delta (ops/lora.py, csrc/lora_bgmv.cu) ---------------------------------
def _lora_operands(device, m=3, t=2, din=16, dout=24, r=4, dtype=F32):
    g = torch.Generator().manual_seed(5)
    x = torch.randn(m, t, din, generator=g).to(dtype).to(device)
    y = torch.randn(m, t, dout, generator=g).to(dtype).to(device)
    a = torch.randn(3, din, r, generator=g).to(device)
    b = torch.randn(3, r, dout, generator=g).to(device)
    aid = torch.tensor([1, 0, 2][:m], dtype=torch.int32).to(device)
    scale = torch.tensor([0.5, 0.0, 2.0][:m]).to(device)
    return x, y, a, b, aid, scale


def test_lora_cpu_takes_the_plain_version_and_counts_nothing():
    """A CPU tensor takes the einsum pair; aid-0 rows keep y's bits (a -0.0
    included) and nothing is counted."""
    from paddle_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from paddle_tpu_torch.ops.lora import (lora_apply, lora_apply_reference,
                                           lora_delta, lora_delta_reference)
    reset_kernel_launches()
    x, y, a, b, aid, scale = _lora_operands("cpu")
    y[1, 0, 0] = -0.0
    sel = ({"wq": a}, {"wq": b}, aid, scale, aid > 0)
    out = lora_apply(y, x, "wq", sel)
    assert torch.equal(out, lora_apply_reference(y, x, a, b, aid, scale))
    assert torch.equal(out[1].view(torch.int32), y[1].view(torch.int32))
    assert lora_apply(y, x, "wo", sel) is y          # not a target
    assert torch.equal(lora_delta(x, a, b, aid, scale),
                       lora_delta_reference(x, a, b, aid, scale))
    assert kernel_launches()["lora"] == 0


def test_lora_non_cpu_call_without_a_build_raises(monkeypatch):
    """A tensor off the CPU never takes the plain version: an unsupported
    device raises before any build, a refused operand raises before any
    build, and a launch with no build raises rather than falling back."""
    from paddle_tpu_torch.ops import lora
    _no_library(monkeypatch)
    x, y, a, b, aid, scale = _lora_operands("meta")
    sel = ({"wq": a}, {"wq": b}, aid, scale, aid > 0)
    with pytest.raises(ValueError, match="unsupported device"):
        lora.lora_apply(y, x, "wq", sel)
    with pytest.raises(ValueError, match="unsupported device"):
        lora.lora_delta(x, a, b, aid, scale)
    with pytest.raises(ValueError, match="int32"):
        lora._check(x, a, b, aid.long(), scale, y)
    big = torch.empty(3, 16, 65, device="meta")
    with pytest.raises(ValueError, match="rank"):
        lora._check(x, big, torch.empty(3, 65, 24, device="meta"), aid, scale, y)
    with pytest.raises(ValueError, match="contiguous"):
        lora._check(x.transpose(0, 1).contiguous().transpose(0, 1), a, b, aid,
                    scale, y)

    def no_nvcc():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(_build, "library", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc"):
        lora._launch(x, a, b, aid, scale, y)
    assert lora.lora_bgmv.launches == 0


def test_lora_source_states_why_it_exists():
    """The kernel replaces no pallas_call: its source says so and why, and
    what bounds it."""
    text = (_build.sources()[0].parent / "lora_bgmv.cu").read_text()
    assert "Replaces: no pl.pallas_call" in text
    assert "What bounds it" in text
    assert "lora_bgmv.cu" in {s.name for s in _build.sources()}


@pytest.mark.parametrize("din,dout,ms,by", [
    (4096, 4096, 0.0007043, "bytes"),
    (4096, 11008, 0.0013645, "bytes"),
    (11008, 4096, 0.0012325, "bytes"),
])
def test_chip_smoke_lora_bound(chip_smoke, din, dout, ms, by):
    """`chip_smoke.lora_bound`: x, y and out in bf16 once per row plus each
    distinct adapter's f32 factors once, over 3.35 TB/s; 2 (in + out) r
    flops a row over the CUDA cores' 67 TFLOP/s."""
    got, got_by = chip_smoke.lora_bound(32, din, dout, 16, 3)
    assert got == pytest.approx(ms, rel=1e-3) and got_by == by
