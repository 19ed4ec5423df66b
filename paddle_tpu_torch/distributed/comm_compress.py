"""Chunked int8 quantization and the two-stage quantized all-reduce.

Counterpart of the part of `paddle_tpu/distributed/comm_compress.py` that
tensor-parallel serving's `tp_compress="int8"` rides (inference/tp.py
`TPContext.reduce`): `quantize_int8` / `dequantize_int8`, their row forms,
and `quantized_psum`. The reference runs inside `shard_map` over a mesh
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
