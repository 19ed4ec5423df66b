"""The int8 matmul's routes on the card, pinned on the CPU.

`quantized_matmul.qmm_route(dtype, m, k, n)` picks the kernel build a CUDA
call takes ("gemv", "tc" or "tiled") by dtype and shape alone, and
`gemv_build(k, n)` whether the GEMV streams its weight tiles through the
TMA ring ("ring": slabs of at least RING_MIN_K rows the ring can map) or
reads rows in place ("direct"). A weight's tensor map is encoded once per
(address, k, n) and kept (`weight_map`, `map_key`). The C
entries of the three builds are checked against `_build.SIGNATURES`, and
the plain version (what CPU tensors take, and the kernels' yardstick on
the card) against the JAX Pallas kernel in interpret mode at m > 8.
"""
import ctypes
import re

import numpy as np
import pytest
import torch

from paddle_tpu_torch import _build
from paddle_tpu_torch.ops import kernel_launches, reset_kernel_launches
from paddle_tpu_torch.ops.pallas import quantized_matmul as tq

BF16, F32 = torch.bfloat16, torch.float32
# LLaMA-7B's int8 products (k, n): q/k/v/o, gate/up, down, the head
SHAPES_7B = [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000)]
# the same products' shards at tp 2 (column-split q/k/v, gate/up and the
# head; row-split o and down)
SHAPES_TP2 = [(4096, 2048), (2048, 4096), (4096, 5504), (5504, 4096), (4096, 16000)]


@pytest.mark.parametrize("k,n", SHAPES_7B + SHAPES_TP2)
@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 6, 7, 8, 32, 1024, 1280])
def test_route_of_every_7b_shape(m, k, n):
    """bf16 x: decode widths (m <= 8) take the GEMV; the verify (32) and
    prefill (1024, 1280) widths the tensor-core build. The GEMV streams
    the down projection (k 11008) through its ring and reads the shorter
    slabs (k 4096, and down's k 5504 on a psum shard) in place."""
    route = tq.qmm_route(BF16, m, k, n)
    assert route == ("gemv" if m <= 8 else "tc")
    assert tq.ring_fits(n)
    assert tq.gemv_build(k, n) == ("ring" if k == 11008 else "direct")


@pytest.mark.parametrize("m", [1, 8, 9, 32, 1280])
@pytest.mark.parametrize("k,n", SHAPES_7B + [(333, 100), (600, 80)])
def test_f32_stays_on_the_gemv(m, k, n):
    """f32 x takes the GEMV at every width (TF32 would break the f32 parity
    gates), in chunks of 8 rows."""
    assert tq.qmm_route(F32, m, k, n) == "gemv"


@pytest.mark.parametrize("m,k,n,route,build", [
    (3, 333, 100, "gemv", "direct"),     # chip_smoke's ragged GEMV row
    (40, 333, 100, "tiled", "direct"),   # chip_smoke's ragged tiled row
    (40, 4096, 100, "tiled", "direct"),  # n % 16 != 0: no weight map
    (40, 4100, 4096, "tiled", "direct"), # k % 8 != 0: no x map
    (40, 0, 4096, "tiled", "direct"),    # no k: nothing for the copies
    (9, 4096, 4096, "tc", "direct"),     # the first width past the GEMV
    (8, 333, 100, "gemv", "direct"),
    (5, 64, 48, "gemv", "direct"),       # a slab too short for the ring
    (4, 8192, 4096, "gemv", "ring"),     # the shortest slab on the ring
    (4, 8191, 4096, "gemv", "direct"),
    (4, 11008, 100, "gemv", "direct"),   # long, but rows the ring cannot map
    (1, 13824, 5120, "gemv", "ring"),    # LLaMA-13B's down projection
])
def test_route_of_ragged_shapes(m, k, n, route, build):
    assert tq.qmm_route(BF16, m, k, n) == route
    assert tq.gemv_build(k, n) == build
    assert tq.ring_fits(n) == (n % 16 == 0)


@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("size", ["llama_7b", "llama_13b"])
def test_chip_smoke_counts_the_ring_gemvs(size, tp):
    """`chip_smoke.qmm_ring_gemvs`, from which the card's exact launch
    gates count the ring's launches: of an op-chain decode step's int8
    GEMVs, the down projection (k = intermediate) takes the ring, every
    other layer product and the head (k = hidden) the direct build."""
    import importlib.util
    import pathlib
    from paddle_tpu_torch.models.llama import LlamaConfig
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert cs.qmm_ring_gemvs(getattr(LlamaConfig, size)(), tp) == (1, 0)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int8, torch.int32])
def test_unsupported_dtypes_are_refused(dtype):
    """A dtype the kernels do not take is a typed refusal (a ValueError),
    whatever the shape."""
    for m in (1, 8, 1280):
        with pytest.raises(tq.QmmDtypeError, match="bf16 or f32"):
            tq.qmm_route(dtype, m, 4096, 4096)
    assert issubclass(tq.QmmDtypeError, ValueError)


def _c_params(name):
    """The parameter list of `extern "C" int name(...)` in csrc/."""
    for src in _build.sources():
        m = re.search(r'extern "C" int ' + name + r'\(([^)]*)\)', src.read_text())
        if m:
            return [" ".join(p.split()) for p in m.group(1).split(",")]
    raise AssertionError(f"{name} has no extern \"C\" definition")


@pytest.mark.parametrize("name,params", [
    ("ptt_quantized_matmul", ["x", "w", "scales", "out", "m", "k", "n", "dtype", "route",
                              "wmap", "device", "stream"]),
    ("ptt_quantized_matmul_tc", ["x", "w", "scales", "out", "m", "k", "n", "wmap", "device",
                                 "stream"]),
    ("ptt_quantized_matmul_map", ["w", "k", "n", "route", "out"]),
])
def test_c_entries_match_signatures(name, params):
    """Each entry's parameters, in order, and their ctypes: a pointer for
    every `void*`, an int for every `int`."""
    c = _c_params(name)
    assert [p.split()[-1].lstrip("*") for p in c] == params
    sig = _build.SIGNATURES[name]
    assert len(sig) == len(c)
    for p, t in zip(c, sig):
        assert t is (ctypes.c_void_p if "*" in p else ctypes.c_int), (name, p)


def test_c_constants_match_python():
    """The route codes and the GEMV's row chunk the wrapper passes are the
    C side's."""
    hdr = (_build._CSRC / "quantized_matmul.cuh").read_text()
    assert re.search(r"kMapRing = 0, kMapTc = 1", hdr)
    assert tq._MAP_ROUTE == {"ring": 0, "tc": 1}
    src = (_build._CSRC / "quantized_matmul.cu").read_text()
    assert "route 0: the GEMV" in src and "route 1: the tiled WMMA GEMM" in src
    assert tq._ROUTE_CODE == {"gemv": 0, "tiled": 1}
    assert "return launch_gemv_as<T, 8>" in src and tq.GEMV_MAX_ROWS == 8
    assert {"quantized_matmul.cu", "quantized_matmul_tc.cu"} <= {
        s.name for s in _build.sources()}


class _FakeLib:
    """Stands in for the kernel library: records the weight-map encodes."""

    def __init__(self):
        self.encodes = []

    def ptt_quantized_matmul_map(self, w, k, n, route, out):
        self.encodes.append((w.value, k, n, route))
        ctypes.memset(out, len(self.encodes), tq.MAP_BYTES)
        return 0


@pytest.fixture
def fake_lib(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(tq, "_maps", {route: type(c)() for route, c in tq._maps.items()})
    return lib


def test_map_key_is_address_and_shape():
    w = torch.zeros(64, 48, dtype=torch.int8)
    assert tq.map_key(w) == (w.data_ptr(), 64, 48)
    assert tq.map_key(w[:32]) == (w.data_ptr(), 32, 48)
    assert tq.map_key(w[32:]) == (w.data_ptr() + 32 * 48, 32, 48)


def test_weight_map_is_encoded_once_per_key(fake_lib):
    w = torch.zeros(64, 48, dtype=torch.int8)
    a = tq.weight_map("ring", w)
    b = tq.weight_map("ring", w)
    assert a is b and len(a.raw) == tq.MAP_BYTES
    assert fake_lib.encodes == [(w.data_ptr(), 64, 48, 0)]
    # another route, another map; the same route on another key, another
    tq.weight_map("tc", w)
    tq.weight_map("ring", w[:32])
    assert fake_lib.encodes[1:] == [(w.data_ptr(), 64, 48, 1), (w.data_ptr(), 32, 48, 0)]
    # a different tensor of the same shape at the same address (a key
    # names its map: address, shape and box are all a map holds)
    again = torch.zeros(64, 48, dtype=torch.int8)
    if again.data_ptr() == w.data_ptr():
        assert tq.weight_map("ring", again) is a


def test_weight_map_keeps_every_weight(fake_lib):
    """A model's weights called in turn, as an op chain's decode steps call
    them: LLaMA-7B at tp 2 gives 2 x (7 x 32 + 1) = 450 weights a step.
    Each is encoded once, however many steps cycle over them."""
    ws = [torch.zeros(16, 16, dtype=torch.int8) for _ in range(450)]
    first = [tq.weight_map("tc", w) for w in ws]
    for _ in range(2):
        assert all(tq.weight_map("tc", w) is b for w, b in zip(ws, first))
    assert len(fake_lib.encodes) == len(tq._maps["tc"]) == 450
    assert sorted(e[0] for e in fake_lib.encodes) == sorted(w.data_ptr() for w in ws)


def test_cpu_calls_launch_nothing(monkeypatch):
    """CPU tensors take the plain version at every route's shape: no
    library, no counted launch."""
    def refuse():
        raise AssertionError("a launch was attempted")
    monkeypatch.setattr(_build, "library", refuse)
    reset_kernel_launches()
    g = torch.Generator().manual_seed(0)
    for m, k, n in ((4, 64, 48), (40, 64, 48), (40, 33, 20)):
        x = torch.randn(m, k, generator=g).to(BF16)
        wq, sc = tq.quantize_weights(torch.randn(k, n, generator=g))
        out = tq.quantized_matmul(x, wq, sc)
        assert out.shape == (m, n) and out.dtype == BF16
    counts = kernel_launches()
    assert counts["quantized_matmul"] == counts["quantized_matmul_tc"] == \
        counts["quantized_matmul_ring"] == 0


def test_launch_counters_reset():
    tq.quantized_matmul.tc_launches = 3
    tq.quantized_matmul.ring_launches = 5
    assert kernel_launches()["quantized_matmul_tc"] == 3
    assert kernel_launches()["quantized_matmul_ring"] == 5
    reset_kernel_launches()
    assert kernel_launches()["quantized_matmul_tc"] == 0
    assert kernel_launches()["quantized_matmul_ring"] == 0


def test_refusals_before_any_build(monkeypatch):
    """Shapes and the device are checked before the library is asked for."""
    def refuse():
        raise AssertionError("a launch was attempted")
    monkeypatch.setattr(_build, "library", refuse)
    wq = torch.empty(64, 48, dtype=torch.int8, device="meta")
    sc = torch.empty(48, dtype=F32, device="meta")
    with pytest.raises(ValueError, match="shapes"):
        tq.quantized_matmul(torch.empty(4, 63, dtype=BF16, device="meta"), wq, sc)
    with pytest.raises(ValueError, match="unsupported device"):
        tq.quantized_matmul(torch.empty(4, 64, dtype=BF16, device="meta"), wq, sc)


@pytest.mark.parametrize("m,k,n", [(40, 600, 80), (24, 1030, 64), (9, 512, 48)])
def test_plain_matches_pallas_interpret_past_the_gemv(m, k, n):
    """The plain version at the tensor-core and tiled routes' widths (m >
    8) against the JAX kernel in interpret mode, f32: rtol 1e-5 and atol
    1e-5 of the largest output (both sum f32 partials over k tiles of 512,
    in another order inside a tile, so an output that cancels differs by
    rounding errors of the size of the terms, not of the sum)."""
    import jax.numpy as jnp
    from paddle_tpu.ops.pallas import quantized_matmul as jq
    rs = np.random.RandomState(m * 1000 + k)
    x = rs.standard_normal((m, k)).astype(np.float32)
    w = rs.standard_normal((k, n)).astype(np.float32)
    wq_j, sc_j = jq.quantize_weights(jnp.asarray(w))
    ref = np.asarray(jq.quantized_matmul(jnp.asarray(x), wq_j, sc_j, interpret=True))
    wq_t, sc_t = tq.quantize_weights(torch.from_numpy(w))
    got = tq.quantized_matmul_reference(torch.from_numpy(x), wq_t, sc_t)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * float(np.abs(ref).max()))
    # the wrapper on CPU tensors is the plain version, bit for bit
    same = tq.quantized_matmul(torch.from_numpy(x), wq_t, sc_t)
    assert torch.equal(same, got)
