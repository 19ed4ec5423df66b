"""RNG state: JAX's threefry key stream, bit for bit, in torch.

Counterpart of `paddle_tpu/framework/random.py`. Two regimes, as there:

- eager: a global `Generator` splits its key per draw (`next_key()`
  outside any scope);
- in a step: the trainer binds the step's key with `key_scope(key)`, and
  each draw folds the scope's counter into it, `fold_in(key, counter)`,
  counting from 1.

Keys are [2] int64 tensors holding the two uint32 words of a JAX key (its
`key_data`), on the CPU unless made elsewhere. The key operations follow
JAX's partitionable threefry layout (`jax_threefry_partitionable=True`,
the default): `key(seed)` splits a 64-bit seed into its high and low
words, `fold_in(key, n)` hashes the counter pair (0, n), `split(key, n)`
the pairs (0, i), and `random_bits` the 64-bit flat index of every
element as (hi, lo). Words are held in int64 tensors masked to 32 bits
(torch's uint32 lacks the shifts and adds).

The samplers reproduce `jax.random`'s arithmetic: `uniform` fills the
mantissa of 1.0 with the top random bits (float64 draws 64 bits, float32
32, bfloat16 8); `bernoulli(key, p, shape)` is `uniform(key, shape,
dtype(p)) < p`, with JAX's dtype rule under x64 (which the reference turns
on): a Python float is float64, a float32 value float32; `randint` is
`jax.random.randint`'s two-split modular scheme for int32.

`cached_draws()` memoises draws within its block: a scope key
`fold_in(key, n)`, a `randint` and a `bernoulli` mask are pure functions
of their arguments (key words, counter, p, dtype, shape, device), so a
repeated draw (the same counter under a rewound scope, or a recompute)
returns the first one's tensor instead of hashing again.
"""
import contextlib

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


# ---------------------------------------------------------------------------
# threefry2x32 and JAX's key operations


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x1, x2)
    under the key words (k1, k2); all int64 tensors of 32-bit values,
    broadcast together. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def key(seed, device=None):
    """`jax.random.key(seed)` as a [2] int64 tensor: a 64-bit seed splits
    into its high and low words (a 32-bit seed pads the high word with
    0); negative seeds wrap as two's complement."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return torch.tensor([s >> 32, s & _M32], dtype=torch.int64,
                        device=device)


def as_key(k):
    """A key from a [2] tensor or array of uint32 words (for instance
    `numpy.asarray(jax.random.key_data(k))`), as a [2] int64 tensor on the
    CPU (a tensor keeps its device)."""
    if isinstance(k, torch.Tensor):
        t = k.to(torch.int64)
    else:
        t = torch.from_numpy(np.asarray(k).astype(np.int64))
    if tuple(t.shape) != (2,):
        raise ValueError(f"a key is two uint32 words; got shape "
                         f"{tuple(t.shape)}")
    return t & _M32


def fold_in(keys, data):
    """`jax.random.fold_in` over a batch: keys [..., 2], data [...] (or an
    int) -> [..., 2]. The counter pair is (0, data)."""
    data = torch.as_tensor(data, device=keys.device).to(torch.int64) & _M32
    b1, b2 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack([b1, b2], dim=-1)


def split(k, num=2):
    """`jax.random.split(k, num)`: [2] -> [num, 2], the counter pairs
    (0, i)."""
    i = torch.arange(num, dtype=torch.int64, device=k.device)
    b1, b2 = threefry2x32(k[0], k[1], torch.zeros_like(i), i)
    return torch.stack([b1, b2], dim=-1)


def random_bits(keys, shape, bit_width=32, device=None):
    """`jax.random.bits` of `shape` under each key of keys [..., 2]:
    [..., *shape] int64 words of `bit_width` (8, 16, 32 or 64) bits, on
    `device` (default: the keys'). Element i (row-major within `shape`)
    hashes the counter pair (i >> 32, i & 0xFFFFFFFF); the result keeps
    bits1 ^ bits2, truncated to the width, or at 64 bits (bits1 << 32) |
    bits2, wrapped into int64 as two's complement."""
    if bit_width not in (8, 16, 32, 64):
        raise ValueError(f"bit_width must be 8, 16, 32 or 64; got "
                         f"{bit_width}")
    shape = tuple(int(d) for d in shape)
    device = keys.device if device is None else torch.device(device)
    keys = keys.to(device)
    n = int(np.prod(shape, dtype=np.int64))
    idx = torch.arange(n, dtype=torch.int64, device=device)
    kshape = tuple(keys.shape[:-1]) + (1,) * len(shape)
    k1 = keys[..., 0].reshape(kshape)
    k2 = keys[..., 1].reshape(kshape)
    b1, b2 = threefry2x32(k1, k2, (idx >> 32).reshape(shape),
                          (idx & _M32).reshape(shape))
    if bit_width == 64:
        return (b1 << 32) | b2
    bits = b1 ^ b2
    if bit_width < 32:
        bits = bits & ((1 << bit_width) - 1)
    return bits


# bits, mantissa bits, the integer type of the same width, the bits of 1.0
_FLOAT_BITS = {torch.float64: (64, 52, torch.int64, 0x3FF0000000000000),
               torch.float32: (32, 23, torch.int32, 0x3F800000),
               torch.bfloat16: (16, 7, torch.int16, 0x3F80)}


def uniform(keys, shape, dtype=torch.float32, minval=0.0, device=None):
    """`jax.random.uniform(key, shape, dtype, minval, 1.0)` per key: random
    mantissa bits under the exponent of 1.0, minus 1, scaled to
    [minval, 1) in `dtype`. bf16 (fewer than 8 mantissa bits) draws 8-bit
    randoms, as JAX does."""
    nbits, nmant, itype, one = _FLOAT_BITS[dtype]
    rng_bits = 8 if nmant < 8 else nbits
    bits = random_bits(keys, shape, rng_bits, device)
    # an arithmetic shift masked to the mantissa is the logical shift
    mant = (bits >> (rng_bits - nmant)) & ((1 << nmant) - 1)
    fbits = mant | one
    floats = fbits.to(itype).view(dtype) - torch.ones((), dtype=dtype,
                                                      device=bits.device)
    lo = torch.full((), minval, dtype=dtype, device=bits.device)
    hi = torch.ones((), dtype=dtype, device=bits.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


# ---------------------------------------------------------------------------
# samplers


_draw_cache = None


@contextlib.contextmanager
def cached_draws():
    """Within the block, a scope key, `randint` or `bernoulli` draw
    repeated with the same arguments returns the first one's tensor.
    Nested blocks share the outermost cache; it is dropped when that block
    ends."""
    global _draw_cache
    outer = _draw_cache is not None
    if not outer:
        _draw_cache = {}
    try:
        yield
    finally:
        if not outer:
            _draw_cache = None


def _memo(tag, compute):
    """compute(), or inside `cached_draws` the value first computed under
    `tag`."""
    if _draw_cache is None:
        return compute()
    hit = _draw_cache.get(tag)
    if hit is None:
        hit = _draw_cache[tag] = compute()
    return hit


def _words(k):
    return tuple(int(w) for w in k.tolist())


def _p_dtype(p):
    """JAX's `lax.dtype(p)` under x64: a Python float is float64; a
    tensor or numpy value keeps its floating dtype."""
    if isinstance(p, torch.Tensor):
        return p.dtype
    if isinstance(p, (np.floating, np.ndarray)):
        return {np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64}[np.asarray(p).dtype]
    return torch.float64


def bernoulli(key, p=0.5, shape=(), device=None):
    """`jax.random.bernoulli(key, p, shape)` (mode "low"): a bool tensor of
    `shape` on `device`, True where `uniform(key, shape, dtype(p)) < p`.
    A Python float p draws float64 uniforms (64 random bits a value), as
    the reference does under x64."""
    dtype = _p_dtype(p)
    shape = tuple(int(d) for d in shape)
    device = key.device if device is None else torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())

    def draw():
        pt = torch.as_tensor(p, dtype=dtype).to(device)
        return uniform(key, shape, dtype, device=device) < pt

    return _memo(("bernoulli", _words(key), float(p), dtype, shape,
                  str(device)), draw)


def mul32(a, b):
    """a * b mod 2^32 for an int64 tensor a of 32-bit values and an int
    b < 2^32, in products below 2^48 (no int64 overflow)."""
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & _M32


def randint(key, shape, minval, maxval, dtype=torch.int32):
    """`jax.random.randint(key, shape, minval, maxval, int32)` on the
    key's device: two subkeys from `split(key)` give a high and a low
    32-bit draw, combined modulo span = maxval - minval as
    (hi % span * (2^32 % span) + lo % span) % span in uint32 arithmetic
    (`jax/_src/random.py` `_randint`). int32 only."""
    if dtype != torch.int32:
        raise NotImplementedError(f"randint is ported for int32 only; got "
                                  f"{dtype}")
    shape = tuple(int(d) for d in shape)
    return _memo(("randint", _words(key), shape, int(minval), int(maxval)),
                 lambda: _randint32(key, shape, minval, maxval))


def _randint32(key, shape, minval, maxval):
    lo_i, hi_i = -(1 << 31), (1 << 31) - 1
    minval, maxval = int(minval), int(maxval)
    out_of_range = maxval > hi_i
    mn, mx = min(max(minval, lo_i), hi_i), min(max(maxval, lo_i), hi_i)
    span = (mx - mn) & _M32
    if mx <= mn:
        span = 1
    elif out_of_range:
        span = (span + 1) & _M32
    k1, k2 = split(key)
    higher = random_bits(k1, shape, 32)
    lower = random_bits(k2, shape, 32)
    if span == 0:     # the full 2^32 range: the remainders change nothing
        off = lower
    else:
        mult = (1 << 16) % span
        mult = ((mult * mult) & _M32) % span
        off = (mul32(higher % span, mult) + lower % span) & _M32
        off = off % span
    val = (mn + off) & _M32
    return torch.where(val >= (1 << 31), val - (1 << 32), val).to(torch.int32)


# ---------------------------------------------------------------------------
# the generator and the key scope


class Generator:
    """Stateful RNG handle: `next_key()` splits its key and returns the
    second half, keeping the first (`jax.random.split`, as the reference's
    Generator). The key is made at the first draw."""

    def __init__(self, seed=0):
        self.manual_seed(seed)

    def manual_seed(self, seed):
        self._seed = int(seed)
        self._key = None
        return self

    def next_key(self):
        pair = split(key(self._seed) if self._key is None else self._key)
        self._key = pair[0]
        return pair[1]


_default_generator = Generator(np.random.randint(0, 2 ** 31 - 1))

# the boxes [key, counter] bound by key_scope, innermost last
_key_stack = []


def seed(value):
    """`paddle.seed`: reseed the global generator."""
    return _default_generator.manual_seed(value)


@contextlib.contextmanager
def key_scope(key):
    """Bind `key` (see `as_key`) for the draws in this block; yields its
    box [key, counter] (counter 0: the first draw folds in 1). A caller
    that must replay a run's draws sets the counter back (`box[1] = n`)."""
    box = [as_key(key), 0]
    _key_stack.append(box)
    try:
        yield box
    finally:
        _key_stack.pop()


def next_key():
    """The key of one draw: fold_in(scope key, ++counter) inside a
    `key_scope`, else the global generator's next split."""
    if _key_stack:
        box = _key_stack[-1]
        box[1] += 1
        k, n = box
        return _memo(("fold_in", _words(k), n), lambda: fold_in(k, n))
    return _default_generator.next_key()


def current_scope():
    """The innermost `key_scope`'s box [key, counter], or None."""
    return _key_stack[-1] if _key_stack else None
