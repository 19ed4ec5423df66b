"""framework/random.py: paddle_tpu_torch's key stream and samplers against
`jax.random` and `paddle_tpu.framework.random` (JAX under x64, which
importing paddle_tpu turns on).

Every test pins exact bits; none uses a tolerance:
  - `key_scope`/`next_key`: the keys fold_in(key, 1..n) of a scope, the
    counter box, and `split` of a scope key;
  - `bernoulli` at a Python float p (float64 uniforms: 64 random bits a
    value) and at a float32 p, over several keys and shapes;
  - `randint(key, (), 0, 2^31 - 1, int32)` over 200 keys (the flash
    dropout seed), and other ranges and shapes;
  - `uniform` in float64;
  - the global generator's split-per-draw stream after `seed`;
  - `cached_draws` returning the first draw's tensor.
Keys and draws are compared as uint32 words / values.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu  # noqa: F401  (turns on x64, as the reference runs)
from paddle_tpu.framework import random as jrnd
from paddle_tpu_torch.framework import random as R

torch.set_num_threads(1)

SEEDS = [0, 1, 7, 12345, 2 ** 31 - 2, 2 ** 32 + 5]


def _kd(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_scope_draws_equal_reference(seed):
    """Exact bits: five draws in a scope are fold_in(key, 1..5), the box
    counts them, and a split of a scope key matches."""
    k = jax.random.key(seed)
    with jrnd.key_scope(k):
        ref = [_kd(jrnd.next_key()) for _ in range(5)]
    ref_split = _kd(jax.random.split(jax.random.fold_in(k, 3), 4))
    with R.key_scope(_kd(k)) as box:
        got = [R.next_key().numpy() for _ in range(5)]
        assert box[1] == 5 and R.current_scope() is box
    assert R.current_scope() is None
    np.testing.assert_array_equal(np.stack(got), np.stack(ref))
    np.testing.assert_array_equal(
        R.split(R.fold_in(R.as_key(_kd(k)), 3), 4).numpy(), ref_split)


def test_nested_scopes_use_the_innermost():
    k1, k2 = jax.random.key(3), jax.random.key(4)
    with jrnd.key_scope(k1):
        a = _kd(jrnd.next_key())
        with jrnd.key_scope(k2):
            b = _kd(jrnd.next_key())
        c = _kd(jrnd.next_key())
    with R.key_scope(_kd(k1)):
        got_a = R.next_key().numpy()
        with R.key_scope(_kd(k2)):
            got_b = R.next_key().numpy()
        got_c = R.next_key().numpy()
    for g, r in ((got_a, a), (got_b, b), (got_c, c)):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("p", [0.9, 0.5, 0.1, np.float32(0.9),
                               np.float32(0.3)],
                         ids=["f64_0.9", "f64_0.5", "f64_0.1", "f32_0.9",
                              "f32_0.3"])
@pytest.mark.parametrize("shape", [(3, 37), (2, 5, 7), ()])
def test_bernoulli_bits_equal_jax(p, shape):
    """Exact bits over 4 keys: a Python float draws float64 uniforms (64
    random bits), a float32 p float32 ones."""
    for seed in (0, 11, 2 ** 31 - 2, 99991):
        k = jax.random.key(seed)
        ref = np.asarray(jax.random.bernoulli(k, p, shape))
        got = R.bernoulli(R.as_key(_kd(k)), p, shape)
        assert got.dtype == torch.bool and tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy(), ref)


def test_bernoulli_float64_uses_64_bits():
    """The float64 draw differs from a float32 draw of the same p on some
    element: the reference's mask needs all 64 bits."""
    k = jax.random.key(5)
    f64 = R.bernoulli(R.as_key(_kd(k)), 0.9, (64, 64))
    f32 = R.bernoulli(R.as_key(_kd(k)), np.float32(0.9), (64, 64))
    assert not torch.equal(f64, f32)


def test_uniform_float64_bits_equal_jax():
    k = jax.random.key(21)
    ref = np.asarray(jax.random.uniform(k, (5, 9), jnp.float64))
    got = R.uniform(R.as_key(_kd(k)), (5, 9), torch.float64).numpy()
    np.testing.assert_array_equal(got.view(np.uint64), ref.view(np.uint64))


def test_randint_seed_draw_equals_jax_over_many_keys():
    """Exact values: the flash dropout seed `randint(key, (), 0, 2^31 - 1,
    int32)` over 200 keys folded from one."""
    base = jax.random.key(2024)
    keys = [jax.random.fold_in(base, i) for i in range(200)]
    ref = [int(jax.random.randint(k, (), 0, 2 ** 31 - 1, jnp.int32))
           for k in keys]
    got = [int(R.randint(R.as_key(_kd(k)), (), 0, 2 ** 31 - 1))
           for k in keys]
    assert got == ref


@pytest.mark.parametrize("lo,hi", [(0, 2 ** 31 - 1), (-5, 17),
                                   (-2 ** 31, 2 ** 31 - 1), (3, 3),
                                   (0, 2 ** 31), (7, 1000003)])
def test_randint_ranges_equal_jax(lo, hi):
    k = jax.random.key(77)
    ref = np.asarray(jax.random.randint(k, (16,), lo, hi, jnp.int32))
    got = R.randint(R.as_key(_kd(k)), (16,), lo, hi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_global_generator_stream_equals_reference():
    """Exact bits: after seed(s) each next_key splits the generator's key
    and returns the second half, as the reference's Generator."""
    saved = jrnd.get_rng_state()
    try:
        jrnd.seed(1234)
        ref = [_kd(jrnd.next_key()) for _ in range(6)]
    finally:
        jrnd.set_rng_state(saved)
    R.seed(1234)
    got = [R.next_key().numpy() for _ in range(6)]
    np.testing.assert_array_equal(np.stack(got), np.stack(ref))
    # a reseed restarts the stream; a Generator of its own is independent
    R.seed(1234)
    assert np.array_equal(R.next_key().numpy(), ref[0])
    np.testing.assert_array_equal(R.Generator(1234).next_key().numpy(),
                                  ref[0])


def test_cached_draws_return_the_first_draw():
    k = R.key(9)
    with R.cached_draws():
        a = R.bernoulli(k, 0.9, (4, 4))
        assert R.bernoulli(k, 0.9, (4, 4)) is a
        assert R.bernoulli(k, 0.8, (4, 4)) is not a
        r = R.randint(k, (), 0, 100)
        assert R.randint(k, (), 0, 100) is r
        with R.key_scope(k) as box:
            first = R.next_key()
            box[1] = 0
            assert R.next_key() is first
    assert R.bernoulli(k, 0.9, (4, 4)) is not a
    assert torch.equal(R.bernoulli(k, 0.9, (4, 4)), a)
