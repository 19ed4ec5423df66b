"""Chunked int8 quantization, the two-stage quantized all-reduce, and the
eager int8 all-reduce.

Counterpart of the parts of `paddle_tpu/distributed/comm_compress.py` that
tensor-parallel serving's `tp_compress="int8"` rides (inference/tp.py
`TPContext.reduce`): `quantize_int8` / `dequantize_int8`, their row forms,
and `quantized_psum`; and of its eager half, which the collectives'
`compress="int8"` and EagerReducer's compressed bucket flushes ride:
`eager_quantized_allreduce`, `wire_bytes` and `resolve_chunk`. The mesh
trainer's `quantized_psum_scatter` and `all_gather_with_qscatter_grad` wait
for ROADMAP A8.8 / A8.10. The reference runs inside `shard_map` over a mesh
axis; here one process holds every rank's tensor, so `quantized_psum`
takes the list of per-rank tensors (one per shard, in rank order) and
plays the collectives out explicitly: an all-to-all is a hand-over of
rows, an all-gather a concatenation in rank order.

Stages (as in the reference): each rank quantizes its n outgoing shards
of the flattened tensor (int8 with one f32 scale per `chunk` values); the
all-to-all hands rank r every peer's int8 copy of shard r; rank r
accumulates them exactly in f32, re-quantizes the sum, and the int8
all-gather hands every rank every accumulated shard. Error enters only at
the two quantization points.
"""
import torch

DEFAULT_CHUNK = 256


def resolve_chunk(compress_chunk):
    """None -> DEFAULT_CHUNK; anything else must be an int >= 1 (every
    compress_chunk= entry point funnels through here, so a 0 fails at
    construction)."""
    if compress_chunk is None:
        return DEFAULT_CHUNK
    c = int(compress_chunk)
    if c < 1:
        raise ValueError(f"compress_chunk must be >= 1, got "
                         f"{compress_chunk!r}")
    return c


def _quantize_rows(rows, chunk):
    """rows: f32 [n, m] -> (q int8 [n, nchunk, chunk], s f32 [n, nchunk]).
    Per-row chunked symmetric quantization with the tail zero-padded; a
    chunk of zeros takes scale 1."""
    n, m = rows.shape
    pad = (-m) % chunk
    if pad:
        rows = torch.cat([rows, rows.new_zeros((n, pad))], dim=1)
    blocks = rows.reshape(n, -1, chunk)
    amax = blocks.abs().amax(dim=2)
    # divide by tensors: CUDA turns a division by a Python scalar into a
    # multiplication by its reciprocal, another rounding than the reference
    s = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                    torch.ones_like(amax))
    q = torch.clamp(torch.round(blocks / s[:, :, None]), -127, 127)
    return q.to(torch.int8), s


def _dequantize_rows(q, s, m):
    """(q [n, nchunk, chunk], s [n, nchunk]) -> f32 [n, m]."""
    rows = q.float() * s[:, :, None].float()
    return rows.reshape(q.shape[0], -1)[:, :m]


def quantize_int8(x, chunk=DEFAULT_CHUNK):
    """x: float tensor, any shape -> (q int8 [nchunk, chunk] with the tail
    zero-padded, scales f32 [nchunk] (amax / 127 per chunk; 1 for a chunk
    of zeros), x.numel())."""
    flat = x.reshape(-1).float()
    q, s = _quantize_rows(flat[None, :], chunk)
    return q[0], s[0], flat.shape[0]


def dequantize_int8(q, scales, size=None, shape=None):
    """The inverse of quantize_int8 up to rounding: int8 rows times their
    scales, cut to `size` values and reshaped to `shape` when given."""
    m = q.numel() if size is None else size
    flat = _dequantize_rows(q[None, ...], scales[None, ...], m)[0]
    return flat.reshape(shape) if shape is not None else flat


def quantized_psum(xs, chunk=DEFAULT_CHUNK):
    """The int8 all-reduce of one tensor per rank (xs, in rank order, all
    of one shape and dtype; each on its rank's device).

    Returns (ys, errs), one entry per rank on that rank's device:
      ys[r]   ~= sum(xs), in xs[r]'s dtype (every rank holds the same
              values);
      errs[r] f32, rank r's error-feedback residual: sum(xs) == y +
              sum(errs) up to f32 rounding. Stage-1 error is each rank's
              own; the stage-2 error of shard r is charged to rank r alone.
    """
    n = len(xs)
    if n == 1:
        return [xs[0]], [torch.zeros(xs[0].shape, dtype=torch.float32,
                                     device=xs[0].device)]
    shape, dtype = xs[0].shape, xs[0].dtype
    flats = [x.reshape(-1).float() for x in xs]
    size = flats[0].shape[0]
    shard = -(-size // n)
    pad = n * shard - size
    if pad:
        flats = [torch.cat([f, f.new_zeros(pad)]) for f in flats]
    # stage 1: every rank quantizes its n outgoing shards
    qs, ss = zip(*(_quantize_rows(f.reshape(n, shard), chunk)
                   for f in flats))
    accs, acc_hats, gathered = [], [], []
    for r in range(n):
        dev = flats[r].device
        # the all-to-all: rank r receives every peer's int8 copy of shard r
        q_t = torch.stack([q[r].to(dev) for q in qs])
        s_t = torch.stack([s[r].to(dev) for s in ss])
        acc = _dequantize_rows(q_t, s_t, shard).sum(dim=0)   # exact f32
        # stage 2: re-quantize the accumulated shard for the all-gather
        q2, s2 = _quantize_rows(acc[None, :], chunk)
        accs.append(acc)
        acc_hats.append(_dequantize_rows(q2, s2, shard)[0])
        gathered.append((q2[0], s2[0]))
    ys, errs = [], []
    for r in range(n):
        dev = flats[r].device
        qg = torch.stack([q.to(dev) for q, _ in gathered])
        sg = torch.stack([s.to(dev) for _, s in gathered])
        y = _dequantize_rows(qg, sg, shard).reshape(-1)[:size]
        ys.append(y.reshape(shape).to(dtype))
        xhat = _dequantize_rows(qs[r], ss[r], shard).reshape(-1)
        err = flats[r] - xhat
        lo = r * shard
        err[lo:lo + shard] += accs[r] - acc_hats[r]
        errs.append(err[:size].reshape(shape))
    return ys, errs


def eager_quantized_allreduce(arr, group=None, chunk=DEFAULT_CHUNK):
    """The int8 all-reduce of the eager cross-process path.

    arr: a float tensor on this rank. Its int8 rows and f32 scales are
    packed into ONE byte payload, gathered from every group rank (one
    collective a flush, ~4x fewer bytes than f32), dequantized and summed
    in rank order. Returns (sum f32 tensor of arr's shape, err f32 tensor):
    err is this rank's quantization residual (arr - its dequantized copy),
    what error feedback carries into the next flush."""
    from . import collective
    shape = tuple(arr.shape)
    q, s, size = quantize_int8(arr, chunk=chunk)
    xhat = dequantize_int8(q, s, size, shape)
    err = arr.float().reshape(shape) - xhat
    payload = torch.cat([q.reshape(-1).view(torch.uint8),
                         s.contiguous().view(torch.uint8)])
    gathered = collective._process_gather(payload, group)    # [n, bytes]
    nr, nq = gathered.shape[0], q.numel()
    qg = gathered[:, :nq].contiguous().view(torch.int8).reshape(
        (nr,) + tuple(q.shape))
    sg = gathered[:, nq:].contiguous().view(torch.float32)
    tot = _dequantize_rows(qg, sg, size).sum(dim=0).reshape(shape)
    return tot, err


def wire_bytes(size, n, dtype_bytes=4, chunk=DEFAULT_CHUNK,
               compressed=False, scatter_only=False):
    """Analytic bytes on the wire per rank for a ring all-reduce of `size`
    elements over `n` ranks.

    Exact f32: 2*(n-1)/n * size * 4   (reduce-scatter + all-gather).
    int8:      the same element traffic at 1 byte + f32 scales every
    `chunk`. scatter_only drops the all-gather phase (the ZeRO
    reduce-to-owner pattern)."""
    if n <= 1:
        return 0
    phases = 1 if scatter_only else 2
    frac = (n - 1) / n
    if not compressed:
        return int(phases * frac * size * dtype_bytes)
    scale_bytes = 4 * (-(-size // chunk))
    return int(phases * frac * (size * 1 + scale_bytes))
