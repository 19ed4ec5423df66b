"""The decode megakernel's weight ring, pinned on the host.

Every projection of `csrc/decode_megakernel.cuh` reads its weight tiles
through a ring of shared-memory stages filled by TMA tensor copies
(`ptt::SlabRing`). Its plan (`slab_ring_plan`: stages, tile rows, shared
memory), the route of each projection (`slab_route`: the ring, or rows
read directly where a row is not a multiple of 16 bytes) and the tensor
maps' spec (`MegakernelPack.map_spec`) are functions of shapes alone, so
they are checked here without a card: for every shape the engines build
at LLaMA-7B (tp 1, 2 and 4 shards, bf16 and int8 weights, the head's vocab
slice), and the argument struct against the C one field for field.
"""
import ctypes
import importlib.util
import pathlib
import re

import pytest
import torch

from paddle_tpu_torch.inference.scheduler import ContinuousBatchingEngine
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops.pallas import decode_megakernel as dm
from paddle_tpu_torch.ops.pallas.quantized_matmul import quantize_weights

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "paddle_tpu_torch" / "csrc"
BF16, I8, F32 = torch.bfloat16, torch.int8, torch.float32
# LLaMA-7B: hidden, heads (MHA), head dim, ffn, vocab; the engines' page
H7, NH7, HD7, F7, V7, PAGE = 4096, 32, 128, 11008, 32000, 64


def _shard_projections(tp):
    """(name, k, n) of every weight a tp shard's pack holds at 7B: the
    column slices of wq / wk / wv / wg / wu, the replicated wo and wd, the
    vocab slice of the head."""
    nq = NH7 * HD7 // tp
    return [("wq", H7, nq), ("wk", H7, nq), ("wv", H7, nq),
            ("wo", NH7 * HD7, H7), ("wg", H7, F7 // tp), ("wu", H7, F7 // tp),
            ("wd", F7, H7), ("head", H7, V7 // tp)]


# the launches a shard's pack takes: (seg, R, head, head_k); tail's widths
# are the full head counts, which do not change the plan (rep is the same)
_LAUNCHES = [("full", R, head, k) for R in (1, 4, 8)
             for head, k in ((False, 1), (True, 1), (True, 8), (True, 128))] + \
    [(seg, 8, seg == "down", 1) for seg in ("qkv", "tail", "down")]


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("wdtype", [BF16, I8])
def test_ring_plan_fits_every_7b_shape(tp, wdtype):
    nh = NH7 // tp
    w = 1 if wdtype == I8 else 2
    step = 128 // w                     # rows between a thread's chain steps
    _, rows, _ = dm.slab_ring_plan(BF16, wdtype, dm.MAX_ROWS, H7, nh, nh, HD7,
                                   PAGE, dm.MAX_HEAD_K, head=True)
    assert rows % step == 0 and step <= rows <= 256
    tile = rows * dm.SLAB_COLS * w
    assert tile % 128 == 0 and tile <= dm.RING_TILE_MAX_BYTES
    for seg, R, head, head_k in _LAUNCHES:
        stages, r, smem = dm.slab_ring_plan(BF16, wdtype, R, H7, nh, nh, HD7,
                                            PAGE, head_k, head, rows=rows)
        assert r == rows
        assert dm.RING_MIN_STAGES <= stages <= dm.RING_MAX_STAGES
        assert smem + dm.RING_RESERVE <= dm.MAX_SMEM
        # the bytes in flight per SM come from the ring: at least 3 tiles
        # of 8 KB or more beyond the one the block works on
        assert (stages - 1) * tile >= 3 * 8192
        fold = 6 * dm.MAX_ROWS * max(head_k, 32) * 4 if head and head_k > 1 else 0
        assert smem == dm._AUX_SMEM + R * H7 * 2 + fold + 128 + stages * (tile + 16)
    # every weight takes the ring: rows of whole 16-byte pieces (the
    # tensor maps' byte stride), a box 32 columns wide of whole pieces too
    for name, k, n in _shard_projections(tp):
        assert dm.slab_route(wdtype, n) == "ring", name
        assert (n * w) % 16 == 0 and (dm.SLAB_COLS * w) % 16 == 0
        assert k >= rows


@pytest.mark.parametrize("dtype,wdtype,n,route", [
    (F32, I8, 1000, "direct"),    # chip_smoke's f32 int8 head: 1000-byte rows
    (F32, F32, 1000, "ring"),
    (BF16, BF16, 1000, "ring"),
    (BF16, I8, 32000, "ring"),
    (BF16, I8, 5504, "ring"),     # tp 2's gate / up slice
    (BF16, BF16, 36, "direct"),   # 72-byte rows
])
def test_slab_route_by_shape(dtype, wdtype, n, route):
    assert dm.slab_route(wdtype, n) == route


def test_ring_plan_refuses_with_a_typed_error():
    """Shapes whose ring does not fit raise MegakernelShapeError (a
    ValueError), and megakernel_supported says no, so no engine picks the
    megakernel for them."""
    with pytest.raises(dm.MegakernelShapeError, match="weight ring"):
        dm.slab_ring_plan(BF16, BF16, 8, 12288, 96, 96, 128, 64, 128, head=True)
    assert issubclass(dm.MegakernelShapeError, ValueError)
    assert not dm.megakernel_supported(96, 96, 128, 12288, 28672)
    assert dm.megakernel_supported(64, 8, 128, 8192, 28672)   # 70B-wide rows
    # f32 rows at 7B width (128 KB of x beside the fold's lists) leave room
    # for 64-row tiles of f32 weights, not for 128-row ones
    stages, rows, _ = dm.slab_ring_plan(F32, F32, 8, H7, 32, 32, 128, 64, 128,
                                        head=True)
    assert rows == 64 and stages >= dm.RING_MIN_STAGES
    with pytest.raises(dm.MegakernelShapeError):
        dm.slab_ring_plan(F32, F32, 8, H7, 32, 32, 128, 64, 128, head=True,
                          rows=128)


def _c_struct_fields():
    src = (CSRC / "decode_megakernel.cuh").read_text()
    body = re.search(r"struct PttMkArgs \{(.*?)\n\};", src, re.S).group(1)
    fields = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip().rstrip(";")
        if not decl:
            continue
        if "*" in decl:                 # const long long* ptrs
            cut = decl.rindex("*") + 1
            kind = "ptr"
        else:                           # int layer0, n_layers
            cut = decl.index(" ")
            kind = {"int": "int", "float": "float"}[decl[:cut]]
        fields += [(name.strip(), kind) for name in decl[cut:].split(",")]
    return fields


def test_mk_args_match_the_c_struct_field_for_field():
    py = [(n, {ctypes.c_void_p: "ptr", ctypes.c_int: "int",
               ctypes.c_float: "float"}[t]) for n, t in dm._MkArgs._fields_]
    assert py == _c_struct_fields()
    assert ("maps", "ptr") in py and ("ring_stages", "int") in py


def _tiny_pack(quant, V, F=48):
    g = torch.Generator().manual_seed(0)
    H, nh, nh_kv, hd, p = 32, 4, 2, 8, 8

    def w(k, n):
        t = torch.randn(k, n, generator=g) * 0.1
        return quantize_weights(t) if quant else t

    layers = [dict(ln1=torch.ones(H), ln2=torch.ones(H), wq=w(H, nh * hd),
                   wk=w(H, nh_kv * hd), wv=w(H, nh_kv * hd), wo=w(nh * hd, H),
                   wg=w(H, F), wu=w(H, F), wd=w(F, H)) for _ in range(2)]
    flat = [torch.zeros(4 * p + 1, nh_kv, hd) for _ in range(4)]
    cos = torch.zeros(4 * p, hd // 2)
    return dm.MegakernelPack(layers, flat[:2], flat[2:], cos, cos, nh=nh,
                             nh_kv=nh_kv, hd=hd, eps=1e-5, page_size=p,
                             norm=torch.ones(H), head=w(H, V))


@pytest.mark.parametrize("quant,V,head_on_ring", [(False, 50, False),
                                                  (False, 64, True),
                                                  (True, 50, False),
                                                  (True, 64, True)])
def test_map_spec_follows_the_pointer_table(quant, V, head_on_ring):
    """One (address, k, n) row per projection of each layer in the table's
    order (wq .. wd), then the head in slot 0 of the last row; zeros and a
    clear ring_mask bit for a weight read directly (rows of 50 int8 or f32
    values: not whole 16-byte pieces).
    No tensor map is encoded off the card."""
    pack = _tiny_pack(quant, V)
    spec = pack.map_spec.tolist()
    assert len(spec) == (pack.n_layers + 1) * dm.MAPS_PER_ROW
    keys = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")
    for li, ws in enumerate(pack.layers):
        for j, key in enumerate(keys):
            t = ws[key][0] if quant else ws[key]
            assert spec[li * 7 + j] == [t.data_ptr(), *t.shape]
            assert int(pack.ptrs[li, 2 + 2 * j]) == t.data_ptr()
    head = pack.head[0] if quant else pack.head
    want = [head.data_ptr(), *head.shape] if head_on_ring else [0, 0, 0]
    assert spec[pack.n_layers * 7] == want
    assert spec[pack.n_layers * 7 + 1:] == [[0, 0, 0]] * 6
    assert pack.ring_mask == 0x7f | (0x80 if head_on_ring else 0)
    assert pack.maps is None and pack.ring_rows is None


def test_map_spec_is_rebuilt_with_the_pointer_table():
    """A pool rebuild (`_abort_in_flight`, `_reset_kv`) builds a new pack:
    its pointer table and its maps' spec are made anew together."""
    cfg = LlamaConfig(vocab_size=64, hidden_size=32, intermediate_size=48,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=64)
    model = LlamaForCausalLM(cfg, device="cpu", seed=0)
    eng = ContinuousBatchingEngine(model, megakernel="multi", device="cpu",
                                   max_len=64, page_size=8, max_batch=2)
    old = eng._mk_pack
    eng._abort_in_flight()
    new = eng._mk_pack
    assert new is not old and new.map_spec is not old.map_spec
    assert torch.equal(new.map_spec, old.map_spec)    # the same weights
    assert int(new.ptrs[0, dm.P_KP]) == eng._k_flat[0].data_ptr()


def test_phase_timer_finds_the_kernels_anchors():
    """tools/mk_phases.py instruments the shipped kernel (the ring design):
    every phase boundary's anchor is found once."""
    spec = importlib.util.spec_from_file_location("mk_phases",
                                                  ROOT / "tools" / "mk_phases.py")
    mk = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mk)
    design, src = mk.patched_header((CSRC / "decode_megakernel.cuh").read_text())
    assert design == "ring"
    for k in range(mk.N):
        assert f"PTT_CLK({k});" in src or (k in (1, 2, 3) and mk.QKV_CLK in src), k
    assert "__device__ __forceinline__ void mk_body(const PttMkArgs a)" in src


@pytest.mark.parametrize("quant", [False, True])
def test_layer_projections_take_the_ring_together(quant):
    """One projection whose rows are not whole 16-byte pieces (gate / up of
    50 columns) sends every projection of the layers to the direct route:
    each phase's jobs then have one tile count, as the kernel's stream
    needs. The head keeps its own route."""
    pack = _tiny_pack(quant, 64, F=50)
    assert pack.ring_mask == 0x80
    spec = pack.map_spec.tolist()
    assert spec[:pack.n_layers * 7] == [[0, 0, 0]] * (pack.n_layers * 7)
    assert spec[pack.n_layers * 7][0] != 0


@pytest.mark.parametrize("wdtype", [BF16, I8])
def test_ring_plan_takes_widths_below_a_tile(wdtype):
    """A hidden width below the tile height (the CPU tests' tiny models:
    hidden 64 against int8's 128-row tiles) still has a plan: O's and
    down's x is staged a whole tile at a time, and xs is sized for it."""
    stages, rows, smem = dm.slab_ring_plan(BF16, wdtype, 8, 64, 4, 2, 16, 8, 128,
                                           head=True)
    assert rows >= 64 and stages >= dm.RING_MIN_STAGES
    fold = 6 * dm.MAX_ROWS * 128 * 4
    w = 1 if wdtype == I8 else 2
    assert smem == dm._AUX_SMEM + 8 * rows * 2 + fold + 128 + stages * (
        rows * dm.SLAB_COLS * w + 16)
    assert dm.megakernel_supported(4, 2, 16, 64, 128)
