"""The port's threefry twin (``ops/prng.py``) against ``jax.random`` on
the CPU, bit for bit: keys, ``split``, ``fold_in``, ``random_bits``,
``uniform``, ``bernoulli``, ``gumbel`` and ``categorical``, with host
(numpy) keys and with torch keys, single and batched (``jax.vmap``), and a
hypothesis property over keys and shapes. Every comparison is exact: equal
words, equal float32 bit patterns, equal indices.

The twin reproduces JAX's partitionable threefry layout; the first test
pins the flag, so a JAX that changes its default fails here instead of
drifting."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from datatunerx_tpu_torch.ops import prng

SEEDS = [0, 1, 2**31 - 1, 2**31, 2**32 + 5, -1, -5, 123456789]
SHAPES = [(), (5,), (4, 32000)]


def _same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    if want.dtype == np.float32:
        got = np.asarray(got, np.float32)
        # NaN is NaN whatever its sign bit; every other value bit for bit
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        ok = ~np.isnan(want)
        np.testing.assert_array_equal(got[ok].view(np.uint32),
                                      want[ok].view(np.uint32))
    else:
        np.testing.assert_array_equal(got.astype(np.int64),
                                      want.astype(np.int64))


def _keys(seed):
    """(jax key, host key, torch key) for one seed."""
    hk = prng.PRNGKey(seed)
    return jax.random.PRNGKey(seed), hk, prng.to_device(hk, "cpu")


def test_jax_runs_the_layout_the_twin_copies():
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert not jax.config.jax_enable_x64


def test_random123_known_answer():
    k0, k1 = np.uint64(0x13198A2E), np.uint64(0x03707344)
    x = prng.threefry2x32(k0, k1, np.uint64(0x243F6A88),
                          np.uint64(0x85A308D3))
    assert (int(x[0]), int(x[1])) == (0xC4923A9C, 0x483DF7A0)
    t = prng.threefry2x32(*(torch.tensor(v, dtype=torch.int64) for v in (
        0x13198A2E, 0x03707344, 0x243F6A88, 0x85A308D3)))
    assert (int(t[0]), int(t[1])) == (0xC4923A9C, 0x483DF7A0)


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_at_edge_seeds(seed):
    jk, hk, tk = _keys(seed)
    _same(hk, jk)
    _same(tk, jk)


@pytest.mark.parametrize("n", [2, 3, 5])
def test_split(n):
    jk, hk, tk = _keys(7)
    want = jax.random.split(jk, n)
    _same(prng.split(hk, n), want)
    _same(prng.split(tk, n), want)
    # a batch of keys splits row by row (jax.vmap)
    ks = jax.random.split(jk, 4)
    _same(prng.split(np.asarray(ks), n),
          jax.vmap(lambda k: jax.random.split(k, n))(ks))


@pytest.mark.parametrize("data", [0, 1, 123, 2**31, 2**32 - 1])
def test_fold_in(data):
    jk, hk, tk = _keys(11)
    want = jax.random.fold_in(jk, data)
    _same(prng.fold_in(hk, data), want)
    _same(prng.fold_in(tk, data), want)


@pytest.mark.parametrize("shape", SHAPES)
def test_random_bits(shape):
    jk, hk, tk = _keys(3)
    want = jax.random.bits(jk, shape)
    _same(prng.random_bits(hk, shape), want)
    _same(prng.random_bits(tk, shape), want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-3.3, 7.1), (1e-30, 1.0)])
def test_uniform(shape, lo, hi):
    jk, hk, tk = _keys(5)
    want = jax.random.uniform(jk, shape, minval=lo, maxval=hi)
    _same(prng.uniform(hk, shape, lo, hi), want)
    _same(prng.uniform(tk, shape, lo, hi), want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
def test_bernoulli(shape, p):
    jk, hk, tk = _keys(9)
    want = jax.random.bernoulli(jk, p, shape)
    _same(prng.bernoulli(hk, p, shape), want)
    _same(prng.bernoulli(tk, p, shape), want)


@pytest.mark.parametrize("shape", SHAPES)
def test_gumbel(shape):
    jk, hk, tk = _keys(13)
    want = jax.random.gumbel(jk, shape)
    _same(prng.gumbel(hk, shape), want)
    _same(prng.gumbel(tk, shape), want)


def test_xla_log_on_edges_and_a_million_values():
    """``xla_log`` against ``jnp.log`` on the CPU: zero and denormals
    (flushed: -inf), infinities, negatives and NaN, and a million
    uniforms across magnitudes."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.random(1_000_000, dtype=np.float32),
        (rng.random(10_000) * 1e-30).astype(np.float32),
        (rng.random(10_000) * 1e30).astype(np.float32),
        np.array([0.0, -0.0, 1e-45, 1e-39, 1.17549435e-38, 1.0, 0.5, 2.0,
                  np.inf, -np.inf, -1.0, np.nan], np.float32)])
    want = np.asarray(jnp.log(jnp.asarray(x)))
    _same(prng.xla_log(x), want)
    _same(prng.xla_log(torch.from_numpy(x)), want)


@pytest.mark.parametrize("shape", SHAPES[1:])
def test_categorical(shape):
    jk, hk, tk = _keys(17)
    logits = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    want = jax.random.categorical(jk, logits)
    _same(prng.categorical(hk, logits), want)
    _same(prng.categorical(tk, torch.from_numpy(logits)), want)


def test_categorical_one_key_a_row_with_masked_lanes():
    """The engines' draw: one key per row over ``[S, V]`` logits with
    ``-inf`` lanes (the top-p filter), as ``jax.vmap``."""
    ks = jax.random.split(jax.random.PRNGKey(2), 4)
    logits = np.random.default_rng(2).normal(size=(4, 32000)) \
        .astype(np.float32)
    logits[:, 100:] = -np.inf
    want = jax.vmap(jax.random.categorical)(ks, logits)
    _same(prng.categorical(np.asarray(ks), logits), want)
    _same(prng.categorical(torch.from_numpy(np.asarray(ks).astype(np.int64)),
                           torch.from_numpy(logits)), want)


@settings(max_examples=60, deadline=None)
@given(words=st.tuples(st.integers(0, 2**32 - 1), st.integers(0, 2**32 - 1)),
       shape=st.lists(st.integers(1, 7), max_size=3),
       n=st.integers(1, 6), data=st.integers(0, 2**32 - 1))
def test_property_any_key_and_shape(words, shape, n, data):
    jk = jnp.asarray(np.array(words, np.uint32))
    hk = np.array(words, np.uint32)
    shape = tuple(shape)
    _same(prng.split(hk, n), jax.random.split(jk, n))
    _same(prng.fold_in(hk, data), jax.random.fold_in(jk, data))
    _same(prng.random_bits(hk, shape), jax.random.bits(jk, shape))
    _same(prng.uniform(hk, shape), jax.random.uniform(jk, shape))
    _same(prng.gumbel(hk, shape), jax.random.gumbel(jk, shape))
