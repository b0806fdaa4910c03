"""The cluster sampler's arithmetic (K9 in ``csrc/sampling.cu``: C blocks a
row, each holding one contiguous slice), emulated on the CPU in float32,
against the reference's blocked twin ``pallas_sampling._xla_sample`` from
numpy-seeded logits.

The emulation is the kernel's order of operations: each block's (max, first
index) over its slice, merged in block order under the first-index rule;
each block's 256 thread chunks of exp(x - m), their exclusive scan and the
block's total; Z as the blocks' totals summed in block order and each
block's exclusive CDF offset; each block's first crossing of u*Z from its
offset, the cluster's smallest winning, the argmax when none crosses.

Tolerances: token ids exact in greedy mode and for rows at temperature
<= 0; a sampled row may differ only where u*Z lies within 1e-5*Z of a CDF
step between the two tokens (the sums run in another order)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

from datatunerx_tpu.ops import pallas_sampling as ps

NT = 256  # threads a block


def _slice(vp, c):
    """A block's slice: vp / c floats rounded up to whole 16-byte vectors."""
    return (-(-vp // c) + 3) // 4 * 4


def _emulate(x, temps, us, *, C, greedy):
    s, vp = x.shape
    chunk = _slice(vp, C)
    out = np.zeros(s, np.int32)
    for row in range(s):
        xr = x[row]
        bounds = [(min(vp, c * chunk), min(vp, (c + 1) * chunk))
                  for c in range(C)]
        m, idx = np.float32(ps.NEG_INF), 0
        for lo, hi in bounds:  # block order, strictly greater wins
            if hi > lo:
                bm = xr[lo:hi].max()
                if bm > m:
                    m, idx = bm, lo + int(np.argmax(xr[lo:hi]))
        if greedy or temps[row] <= 0:
            out[row] = idx
            continue
        parts = []
        for lo, hi in bounds:
            n = hi - lo
            tch = -(-n // NT) if n else 1
            e = np.zeros(NT * tch, np.float32)
            e[:n] = np.exp(xr[lo:hi] - m)
            e = e.reshape(NT, tch)
            own = e.sum(axis=1, dtype=np.float32)
            excl = np.concatenate([[0], np.cumsum(own, dtype=np.float32)[:-1]])
            parts.append((lo, n, e, excl.astype(np.float32),
                          np.float32(own.sum(dtype=np.float32))))
        z = np.float32(0)
        offs = []
        for p in parts:
            offs.append(z)
            z = np.float32(z + p[4])
        thresh = np.float32(us[row]) * z
        first = None
        for (lo, n, e, excl, _), off in zip(parts, offs):
            cum = (off + excl)[:, None] + np.cumsum(e, axis=1, dtype=np.float32)
            hit = np.flatnonzero((cum > thresh).reshape(-1)[:n])
            if hit.size:
                first = lo + int(hit[0])
                break
        out[row] = idx if first is None else first
    return out


@functools.lru_cache(maxsize=None)
def _case(V, S):
    """Padded, pre-scaled logits (the reference's ``_prep``), temperatures
    with every fourth row at 0, and the uniforms."""
    rng = np.random.default_rng(V + S)
    logits = (rng.normal(size=(S, V)) * 2.0).astype(np.float32)
    temps = (rng.random(S) + 0.3).astype(np.float32)
    temps[::4] = 0.0
    us = rng.random(S).astype(np.float32)
    return logits, temps, us


@functools.lru_cache(maxsize=None)
def _reference(V, S, mode, ties=()):
    logits, temps, us = _case(V, S)
    logits = _with_ties(logits, ties)
    x, bn = ps._prep(jnp.asarray(logits), jnp.asarray(temps), mode=mode)
    got = ps._xla_sample(x, jnp.asarray(temps), jnp.asarray(us), bn=bn,
                         greedy=mode == "greedy")
    return np.asarray(x, np.float32), np.asarray(got)


def _with_ties(logits, ties):
    logits = logits.copy()
    for row, cols in ties:
        top = logits[row].max() + 1.0
        logits[row, list(cols)] = top
    return logits


def _at_cdf_boundary(xr, u, a, b):
    e = np.exp(xr.astype(np.float64) - xr.max())
    cdf, z = np.cumsum(e), e.sum()
    lo, hi = min(a, b), max(a, b)
    return np.abs(cdf[lo:hi] - u * z).min() <= 1e-5 * z


def _check(got, want, x, temps, us, greedy):
    for i, (a, b) in enumerate(zip(got, want)):
        if greedy or temps[i] <= 0:
            assert a == b, (i, a, b)
        elif a != b:
            assert _at_cdf_boundary(x[i], float(us[i]), a, b), (i, a, b)


@pytest.mark.parametrize("mode", ["greedy", "simple"])
@pytest.mark.parametrize("S", [1, 4, 64])
@pytest.mark.parametrize("V", [512, 3104, 32000])
@pytest.mark.parametrize("C", [1, 8, 16])
def test_cluster_arithmetic_matches_the_reference(C, V, S, mode):
    _, temps, us = _case(V, S)
    x, want = _reference(V, S, mode)
    greedy = mode == "greedy"
    got = _emulate(x, temps, us, C=C, greedy=greedy)
    _check(got, want, x, temps, us, greedy)


@pytest.mark.parametrize("mode", ["greedy", "simple"])
@pytest.mark.parametrize("C", [8, 16])
def test_equal_maxima_across_slices_take_the_first_index(C, mode):
    """Equal maxima at the last element of one block's slice and the first
    of the next, at two slices' first elements, and at a row's first and
    last elements: the first index wins, as in the reference."""
    V, S = 32000, 4
    sl = _slice(V, C)
    ties = ((0, (sl - 1, sl)), (1, (sl, 3 * sl)), (2, (0, V - 1)),
            (3, (2 * sl, 2 * sl + 1)))
    logits, temps, us = _case(V, S)
    x, want = _reference(V, S, mode, ties)
    greedy = mode == "greedy"
    got = _emulate(x, temps, us, C=C, greedy=greedy)
    _check(got, want, x, temps, us, greedy)
    if greedy:
        assert list(got) == [sl - 1, sl, 0, 2 * sl]


@pytest.mark.parametrize("V,C", [(512, 16), (3104, 16), (32000, 16),
                                 (128, 16)])
def test_slices_cover_the_row_once(V, C):
    sl = _slice(V, C)
    cols = [i for c in range(C) for i in range(min(V, c * sl),
                                               min(V, (c + 1) * sl))]
    assert cols == list(range(V)) and sl % 4 == 0
