"""int8 weight-only matmul: out[m, n] = (x @ w_int8)[m, n] * scale[n].

Counterpart of `paddle_tpu/ops/pallas/quantized_matmul.py`. The Pallas
TPU kernel `_qmm_kernel` is replaced by three routes on the card, picked
by dtype and shape alone (`qmm_route`):

- "gemv" (m <= 8, or f32 x at any m in chunks of 8 rows; decode and the
  heads): `csrc/quantized_matmul.cu`, `ptt::gemv_slab`'s sums. Long
  weights whose rows are whole 16-byte pieces (`gemv_build` "ring": k >=
  RING_MIN_K, n % 16 == 0; LLaMA-7B's down projection) stream their tiles
  through a TMA-fed `ptt::SlabRing` from a persistent grid; the others
  ("direct") read rows in place. Both give the same bits, which are also
  the decode megakernel's for an int8 projection.
- "tc" (bf16 x, m > 8, n % 16 == 0, 0 < k, k % 8 == 0; prefill and the
  verify pass): `csrc/quantized_matmul_tc.cu`, wgmma on out^T = W^T x^T
  with the int8 tiles widened to bf16 in registers as the A operand. A
  row's bits depend only on that row of x, on the weight and on the
  scales, never on m.
- "tiled" (bf16 x, m > 8, other shapes): the WMMA build of
  `csrc/quantized_matmul.cu`.

The plain PyTorch version serves CPU tensors and is the yardstick the
kernels are held against on the card.

Weights keep Paddle's [k, n] ("[in, out]") layout with one f32 scale per
output channel, exactly as `quantize_weights` produces them.
"""
import ctypes

import torch

from ... import _build

K_TILE = 512   # the reference's k tile: f32 partial sums are added per tile

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
GEMV_MAX_ROWS = 8        # the GEMV's rows a block (m <= 8 is decode)
MAP_BYTES = 128          # sizeof(CUtensorMap)
# The ring's fill and per-tile waits pay off only over long slabs: in turns
# on an H100 (tools/tree_ab.py qmm) it beat the direct build at k 11008 (by
# 5-12%) and lost to it at k 4096 (by 9-24% at n 4096 and 32000, within
# 3% either way at n 11008).
RING_MIN_K = 8192
_MAP_ROUTE = {"ring": 0, "tc": 1}   # ptt::qmm::kMapRing, kMapTc
_ROUTE_CODE = {"gemv": 0, "tiled": 1}


class QmmDtypeError(ValueError):
    """x of a dtype the kernels do not take (bf16 and f32 only), or an
    output dtype other than x's."""


def qmm_route(dtype, m, k, n):
    """The kernel build a CUDA call with x of `dtype` [m, k] and an int8
    [k, n] weight takes: "gemv", "tc" or "tiled". By dtype and shape
    alone; raises QmmDtypeError for a dtype the kernels do not take."""
    if dtype not in _DTYPE_CODE:
        raise QmmDtypeError(
            f"quantized_matmul kernels take bf16 or f32 x, not {dtype}")
    if dtype == torch.float32 or m <= GEMV_MAX_ROWS:
        return "gemv"
    if n % 16 == 0 and k > 0 and k % 8 == 0:
        return "tc"
    return "tiled"


def ring_fits(n):
    """Whether the ring can stream an int8 [k, n] weight: its TMA tensor
    copies need rows of a multiple of 16 bytes."""
    return n % 16 == 0


def gemv_build(k, n):
    """How the GEMV reads an int8 [k, n] weight: "ring" (tiles by TMA
    tensor copies, for slabs of at least RING_MIN_K rows the ring can
    map) or "direct" (rows from device memory). By shape alone, like the
    megakernel's `slab_route`; both give the same bits."""
    return "ring" if k >= RING_MIN_K and ring_fits(n) else "direct"


def map_key(w):
    """What a weight's tensor map depends on: (address, k, n)."""
    return (w.data_ptr(), w.shape[0], w.shape[1])


_maps = {route: {} for route in _MAP_ROUTE}


def weight_map(route, w):
    """The tensor map of int8 weight w for `route` ("ring" or "tc"), as
    MAP_BYTES host bytes: encoded once per `map_key` and kept for the
    life of the process, so a launch encodes none, however many weights a
    model's layers and shards hold. A map holds only the address, the
    shape and the box, so a key names its map even after the weight is
    freed and another of its shape takes the address; the keys are as
    many as the (address, k, n) the allocator ever hands out."""
    cache, key = _maps[route], map_key(w)
    buf = cache.get(key)
    if buf is None:
        buf = ctypes.create_string_buffer(MAP_BYTES)
        code = _build.library().ptt_quantized_matmul_map(
            ctypes.c_void_p(w.data_ptr()), w.shape[0], w.shape[1],
            _MAP_ROUTE[route], buf)
        _build.check(code, f"quantized_matmul {route} map")
        cache[key] = buf
    return buf


def quantize_weights(w, axis=0):
    """Symmetric per-channel int8 quantization of a [k, n] weight.
    Returns (w_int8 [k, n], scales [n] f32): absmax over `axis` / 127,
    round half to even, clip to +-127. Plain torch, not a kernel."""
    w = w.float()
    amax = torch.amax(torch.abs(w), dim=axis, keepdim=True)
    scales = amax / 127.0
    wq = torch.clamp(torch.round(w / torch.clamp(scales, min=1e-12)),
                     -127, 127)
    return wq.to(torch.int8), scales.reshape(-1)


def quantized_matmul_reference(x, w_int8, scales, out_dtype=None):
    """Plain version: f32 partial products over k tiles of 512, summed
    tile by tile as the reference kernel does, scale applied once at the
    end."""
    m, k = x.shape
    out_dtype = out_dtype or x.dtype
    xf = x.float()
    acc = torch.zeros((m, w_int8.shape[1]), dtype=torch.float32,
                      device=x.device)
    for k0 in range(0, k, K_TILE):
        acc += xf[:, k0:k0 + K_TILE] @ w_int8[k0:k0 + K_TILE].float()
    return (acc * scales.float()[None, :]).to(out_dtype)


def quantized_matmul(x, w_int8, scales, out_dtype=None):
    """x: [m, k] float; w_int8: [k, n] int8; scales: [n] f32.
    Returns [m, n] in out_dtype (default x.dtype).

    A CPU tensor takes the plain version. A CUDA tensor takes the kernel
    build of `qmm_route` (bf16 or f32 x, output in x's dtype) or raises;
    there is no fallback."""
    if x.dim() != 2 or w_int8.dim() != 2 or x.shape[1] != w_int8.shape[0] \
            or scales.shape != (w_int8.shape[1],):
        raise ValueError(
            f"quantized_matmul shapes: x {tuple(x.shape)}, w "
            f"{tuple(w_int8.shape)}, scales {tuple(scales.shape)}")
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return quantized_matmul_reference(x, w_int8, scales, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"quantized_matmul: unsupported device {x.device}")
    m, k = x.shape
    n = w_int8.shape[1]
    route = qmm_route(x.dtype, m, k, n)
    if out_dtype != x.dtype:
        raise QmmDtypeError(
            f"quantized_matmul kernels emit x's dtype; got x {x.dtype}, "
            f"out {out_dtype}")
    if w_int8.dtype != torch.int8 or scales.dtype != torch.float32:
        raise ValueError(
            f"quantized_matmul kernel takes int8 w and f32 scales; got "
            f"{w_int8.dtype}, {scales.dtype}")
    for t in (w_int8, scales):
        if t.device != x.device:
            raise ValueError("quantized_matmul: operands on different devices")
    x = x.contiguous()
    w_int8 = w_int8.contiguous()
    scales = scales.contiguous()
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    ring = route == "gemv" and gemv_build(k, n) == "ring"
    if route == "tc" or ring:
        # the tensor copies read from 16-byte-aligned bases
        w_int8 = _build.aligned16(w_int8)
    lib = _build.library()
    if route == "tc":
        x = _build.aligned16(x)
        code = lib.ptt_quantized_matmul_tc(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(w_int8.data_ptr()),
            ctypes.c_void_p(scales.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            m, k, n, weight_map("tc", w_int8), x.device.index,
            _build.stream_ptr(x.device))
    else:
        code = lib.ptt_quantized_matmul(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(w_int8.data_ptr()),
            ctypes.c_void_p(scales.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            m, k, n, _DTYPE_CODE[x.dtype], _ROUTE_CODE[route],
            weight_map("ring", w_int8) if ring else None, x.device.index,
            _build.stream_ptr(x.device))
    _build.check(code, f"quantized_matmul ({route})")
    quantized_matmul.launches += 1
    if route == "tc":
        quantized_matmul.tc_launches += 1
    elif ring:
        quantized_matmul.ring_launches += 1
    return out


def _gemv_launch(x, w_int8, scales, build):
    """The GEMV on CUDA tensors through the named build ("ring" or
    "direct") whatever `gemv_build` says, for the card's bit gate of the
    ring against the direct build and its timing at every shape the ring
    fits. Never a route: counts no launch."""
    m, k = x.shape
    n = w_int8.shape[1]
    if qmm_route(x.dtype, m, k, n) != "gemv":
        raise ValueError("_gemv_launch: not a GEMV shape")
    if build == "ring" and not ring_fits(n):
        raise ValueError("_gemv_launch: the ring needs n % 16 == 0")
    x, w_int8, scales = (t.contiguous() for t in (x, w_int8, scales))
    w_int8 = _build.aligned16(w_int8)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    code = _build.library().ptt_quantized_matmul(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(w_int8.data_ptr()),
        ctypes.c_void_p(scales.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        m, k, n, _DTYPE_CODE[x.dtype], _ROUTE_CODE["gemv"],
        weight_map("ring", w_int8) if build == "ring" else None,
        x.device.index, _build.stream_ptr(x.device))
    _build.check(code, f"quantized_matmul ({build} GEMV)")
    return out


quantized_matmul.launches = 0
quantized_matmul.tc_launches = 0
quantized_matmul.ring_launches = 0
