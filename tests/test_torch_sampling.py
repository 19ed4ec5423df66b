"""inference/sampling.py: paddle_tpu_torch's key stream and selection math
against the JAX package's (`jax.random` and paddle_tpu/inference/sampling.py).

Each test says what it pins:
  - exact bits: threefry key words of `key`, `fold_keys`, `fold_in` and
    `split` over seeded (seed, position) pairs, seeds above 2^32 and
    negative seeds included (JAX under x64 for those), and the uniform
    bits in f32 and bf16;
  - tolerance: Gumbel noise within rtol 1e-6 (torch's CPU `log` and XLA's
    differ in the last bit on some elements; near zero, where a relative
    bound means nothing, atol 1e-6);
  - exact ids: `categorical`, `select_from_topk` (sampled and greedy
    rows), and `top_k` against `lax.top_k` with ties (value descending,
    ties to the lower index);
  - exact values: `apply_penalties`, neutral rows passing through bit for
    bit;
  - exact tables: the token automatons of a regex-style pattern and of
    `json_schema_pattern` against the JAX package's, and stop_hit.
Inputs are numpy draws from fixed seeds, handed to both sides.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from paddle_tpu.inference import sampling as J
from paddle_tpu.jax_compat import enable_x64
from paddle_tpu_torch.inference import sampling as S

torch.set_num_threads(1)


def _kd(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def _seeds(n, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32),
            rng.randint(0, 1 << 20, n).astype(np.int32))


# ---------------------------------------------------------------- key bits
def test_fold_keys_bits_equal_jax():
    """Exact bits: the engine's key per (uint32 seed, position), 200
    seeded pairs."""
    seeds, pos = _seeds(200)
    ref = _kd(J.fold_keys(jnp.asarray(seeds), jnp.asarray(pos)))
    got = S.fold_keys(torch.tensor(seeds.astype(np.int64)),
                      torch.tensor(pos)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1, 2 ** 32 + 5,
                                  (1 << 63) - 3, -1, -(2 ** 40)])
def test_key_split_fold_in_bits_equal_jax(seed):
    """Exact bits: key(seed) (64-bit seeds keep both words, JAX under
    x64), a split chain of 6 and fold_in of 5 counters."""
    with enable_x64(True):
        k = jax.random.key(seed)
        chain = []
        for _ in range(6):
            k, sub = jax.random.split(k)
            chain.append(_kd(sub))
        folds = [_kd(jax.random.fold_in(jax.random.key(seed), c))
                 for c in (0, 1, 17, 4095, 2 ** 31 - 1)]
        first = _kd(jax.random.key(seed))
    t = S.key(seed)
    np.testing.assert_array_equal(t.numpy(), first)
    for want in chain:
        t, sub = S.split(t)
        np.testing.assert_array_equal(sub.numpy(), want)
    got = S.fold_in(S.key(seed).expand(5, 2),
                    torch.tensor([0, 1, 17, 4095, 2 ** 31 - 1]))
    np.testing.assert_array_equal(got.numpy(), np.stack(folds))


def test_split_num_and_random_bits_equal_jax():
    """Exact bits: split into 5, and 32/16/8-bit random words over a
    [3, 77] shape (the partitionable counter layout)."""
    k = jax.random.key(99)
    np.testing.assert_array_equal(S.split(S.key(99), 5).numpy(),
                                  _kd(jax.random.split(k, 5)))
    for width, dt in ((32, jnp.uint32), (16, jnp.uint16), (8, jnp.uint8)):
        ref = np.asarray(jax.random.bits(k, (3, 77), dt)).astype(np.int64)
        got = S.random_bits(S.key(99), (3, 77), width).numpy()
        np.testing.assert_array_equal(got, ref, err_msg=str(width))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_uniform_bits_and_gumbel_tolerance(dtype):
    """Exact bits: uniform on [tiny, 1) (bf16 draws 8-bit randoms).
    Tolerance: Gumbel noise, rtol 1e-6 / atol 1e-6 (the last bit of
    `log`)."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    keys = J.fold_keys(jnp.asarray(_seeds(4)[0]), jnp.arange(4))
    tkeys = S.fold_keys(torch.tensor(_seeds(4)[0].astype(np.int64)),
                        torch.arange(4))
    tiny = float(jnp.finfo(jdt).tiny)
    ref_u = jax.vmap(lambda k: jax.random.uniform(
        k, (500,), jdt, minval=tiny, maxval=1.0))(keys)
    got_u = S.uniform(tkeys, (500,), tdt, minval=torch.finfo(tdt).tiny)
    np.testing.assert_array_equal(got_u.float().numpy(),
                                  np.asarray(ref_u).astype(np.float32))
    ref_g = np.asarray(jax.vmap(lambda k: jax.random.gumbel(
        k, (500,), jdt))(keys)).astype(np.float32)
    got_g = S.gumbel(tkeys, (500,), tdt).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got_g, ref_g, rtol=1e-6, atol=1e-6)
    else:   # bf16 rounds both logs to 8 bits: one bf16 step at most
        np.testing.assert_allclose(got_g, ref_g, rtol=2 ** -7, atol=2 ** -7)


# ---------------------------------------------------------------- ids
def test_categorical_ids_equal_jax():
    """Exact ids: one key over a [4, 32000] row block (the static engine's
    draw) and per-row keys over [64, 8] (the engine's candidate rows)."""
    rng = np.random.RandomState(1)
    logits = rng.randn(4, 32000).astype(np.float32) * 3
    for seed in (0, 5, 123456):
        ref = np.asarray(jax.random.categorical(jax.random.key(seed),
                                                jnp.asarray(logits)))
        got = S.categorical(S.key(seed), torch.tensor(logits)).numpy()
        np.testing.assert_array_equal(got, ref)
    seeds, pos = _seeds(64, seed=2)
    rows = rng.randn(64, 8).astype(np.float32)
    keys = J.fold_keys(jnp.asarray(seeds), jnp.asarray(pos))
    ref = np.asarray(jax.vmap(jax.random.categorical)(keys,
                                                      jnp.asarray(rows)))
    got = S.categorical(S.fold_keys(torch.tensor(seeds.astype(np.int64)),
                                    torch.tensor(pos)),
                        torch.tensor(rows)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_select_from_topk_ids_equal_jax():
    """Exact ids: 256 rows of sorted candidates with mixed do_sample,
    temperature, top_k (0 = all), top_p and min_p; greedy rows take
    topi[:, 0]."""
    rng = np.random.RandomState(4)
    w, K = 256, 8
    topv = -np.sort(-rng.randn(w, K).astype(np.float32) * 2, axis=1)
    topi = rng.randint(0, 32000, (w, K)).astype(np.int32)
    dos = rng.rand(w) > 0.25
    temp = rng.uniform(0.3, 1.5, w).astype(np.float32)
    tk = rng.randint(0, K + 1, w).astype(np.int32)
    tp = rng.uniform(0.5, 1.0, w).astype(np.float32)
    mp = np.where(rng.rand(w) > 0.5, rng.uniform(0, 0.2, w),
                  0).astype(np.float32)
    seeds, pos = _seeds(w, seed=5)
    ref = np.asarray(J.select_from_topk(
        jnp.asarray(topv), jnp.asarray(topi),
        J.fold_keys(jnp.asarray(seeds), jnp.asarray(pos)), jnp.asarray(dos),
        jnp.asarray(temp), jnp.asarray(tk), jnp.asarray(tp),
        jnp.asarray(mp)))
    got = S.select_from_topk(
        torch.tensor(topv), torch.tensor(topi).long(),
        S.fold_keys(torch.tensor(seeds.astype(np.int64)), torch.tensor(pos)),
        torch.tensor(dos), torch.tensor(temp), torch.tensor(tk),
        torch.tensor(tp), torch.tensor(mp)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[~dos], topi[~dos, 0])
    assert (got[dos] != topi[dos, 0]).any()      # the draws do sample


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_top_k_tie_order_equals_lax(dtype):
    """Exact values and ids: `top_k` against `lax.top_k` on rows with many
    ties (values from a 5-level grid), k in {1, 8, 128}."""
    rng = np.random.RandomState(6)
    x = rng.randint(-2, 3, (6, 1000)).astype(np.float32) * 0.5
    for k in (1, 8, 128):
        rv, ri = jax.lax.top_k(jnp.asarray(x, getattr(jnp, dtype)), k)
        tv, ti = S.top_k(torch.tensor(x).to(getattr(torch, dtype)), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(tv.float().numpy(),
                                      np.asarray(rv).astype(np.float32))


def test_apply_penalties_equal_jax():
    """Exact values: rows with each penalty alone, all three, and neutral
    rows, which pass through bit for bit."""
    rng = np.random.RandomState(11)
    logits = rng.randn(5, 300).astype(np.float32) * 4
    counts = rng.randint(0, 3, (5, 300)).astype(np.int32)
    rep = np.array([1.0, 1.3, 1.0, 1.0, 1.2], np.float32)
    pres = np.array([0.0, 0.0, 0.4, 0.0, 0.1], np.float32)
    frq = np.array([0.0, 0.0, 0.0, 0.25, 0.3], np.float32)
    ref = np.asarray(J.apply_penalties(*map(jnp.asarray, (logits, counts, rep,
                                                          pres, frq))))
    got = S.apply_penalties(*map(torch.tensor, (logits, counts, rep, pres,
                                                frq))).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[0], logits[0])


# ---------------------------------------------------------------- host side
def _vocab():
    toks = [""] * 40
    for i in range(10):
        toks[i] = str(i)
    toks[10:20] = ["-", "[", "]", ",", "true", "false", "tr", "ue", "1,",
                   '"a"']
    return toks


@pytest.mark.parametrize("case", ["regex", "schema"])
def test_automaton_tables_equal_jax(case):
    """Exact tables: the token automaton (table, mask, accepting states) of
    a pattern built from the combinators, and of a JSON-schema object,
    equal the JAX package's."""
    toks = _vocab()

    def build(m):
        if case == "regex":
            pat = m.Seq(m.Opt("-"), m.Plus(m.Chars(m.DIGITS)),
                        m.Star(m.Seq(",", m.Plus(m.Chars("01")))))
            return m.TokenMaskAutomaton.from_pattern(pat, toks, eos_id=39)
        schema = {"type": "object",
                  "properties": {"n": {"type": "integer"},
                                 "b": {"type": "boolean"},
                                 "xs": {"type": "array",
                                        "items": {"type": "integer"},
                                        "maxItems": 2}}}
        return m.TokenMaskAutomaton.from_json_schema(schema, toks, eos_id=39)

    a, b = build(S), build(J)
    np.testing.assert_array_equal(a.table, b.table)
    np.testing.assert_array_equal(a.mask, b.mask)
    assert a.accept_states == b.accept_states and a.n_states > 3
    spec = a.to_spec()
    c = S.TokenMaskAutomaton.from_spec(spec)
    np.testing.assert_array_equal(c.table, a.table)
    sp = S.SamplingParams(do_sample=True, grammar=a, stop=[(1, 2)])
    assert sp.needs_processors
    assert S.SamplingParams.from_spec(sp.to_spec()).to_spec() == sp.to_spec()
    assert S.stop_hit([5, 1, 2], ((1, 2),)) and not S.stop_hit([1], ((1, 2),))
    with pytest.raises(ValueError):
        S.SamplingParams(top_p=0.0)
