"""The port's sampling epilogue held against the JAX package on the CPU:
K9's plain version ``_plain_sample`` against the reference's ``_xla_sample``
(the twin of its Pallas kernel), fed the same prepped logits and the same
uniforms; the nucleus path ``_topp_sample``; and the legacy sampler.

Tolerances: greedy token ids are exact (max and compare are order-exact).
Sampled ids are exact except where ``u*Z`` lies within 1e-5*Z of a CDF
boundary between the two answers — there the two f32 sums, taken in a
different order, may land on either side; the test checks that this is the
case for every mismatch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datatunerx_tpu.ops import pallas_sampling as jps
from datatunerx_tpu_torch.ops import cuda_sampling as tcs
from datatunerx_tpu_torch.serving.engine import _sample_jit


def _logits(seed, S, V, scale=2.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((S, V)) * scale).astype(np.float32)


def _prep_both(logits, temps, mode):
    jx, jbn = jps._prep(jnp.asarray(logits), jnp.asarray(temps), mode=mode)
    tx, tbn = tcs._prep(torch.from_numpy(logits), torch.from_numpy(temps),
                        mode=mode)
    assert tbn == jbn
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))  # same prep
    return jx, tx, tbn


def _at_cdf_boundary(x_row, u, a, b):
    """A CDF boundary between tokens a and b lies within 1e-5*Z of u*Z."""
    row = x_row.astype(np.float64)
    e = np.exp(row - row.max())
    cdf, z = np.cumsum(e), e.sum()
    lo, hi = min(a, b), max(a, b)
    return np.abs(cdf[lo:hi] - u * z).min() <= 1e-5 * z


@pytest.mark.parametrize("V", [512, 3104, 32000])
def test_greedy_exact_including_ties(V):
    logits = _logits(0, 5, V)
    logits[1, 3] = logits[1, V - 2] = logits[1].max() + 1.0  # exact tie
    logits[2, :] = 0.5  # all tied: the first index wins
    temps = np.zeros((5,), np.float32)
    jx, tx, bn = _prep_both(logits, temps, "greedy")
    want = np.asarray(jps._xla_sample(jx, jnp.asarray(temps), None, bn=bn,
                                      greedy=True))
    got = tcs._plain_sample(tx, torch.from_numpy(temps), None, bn=bn,
                            greedy=True)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[1] == 3 and got[2] == 0
    np.testing.assert_array_equal(got.numpy(),
                                  torch.argmax(torch.from_numpy(logits),
                                               -1).numpy())


@pytest.mark.parametrize("V", [512, 3104, 32000])
def test_simple_exact_up_to_cdf_boundaries(V):
    S = 16
    logits = _logits(1, S, V, scale=3.0)
    temps = np.linspace(0.3, 1.5, S).astype(np.float32)
    temps[5] = 0.0  # a greedy row inside a sampled batch
    us = np.random.default_rng(2).random(S).astype(np.float32)
    jx, tx, bn = _prep_both(logits, temps, "simple")
    want = np.asarray(jps._xla_sample(jx, jnp.asarray(temps),
                                      jnp.asarray(us), bn=bn, greedy=False))
    got = tcs._plain_sample(tx, torch.from_numpy(temps),
                            torch.from_numpy(us), bn=bn,
                            greedy=False).numpy()
    for r in range(S):
        if got[r] != want[r]:
            assert temps[r] > 0
            assert _at_cdf_boundary(np.asarray(jx)[r], us[r], got[r],
                                    want[r]), r
    assert got[5] == np.argmax(logits[5])


def test_kernel_wrapper_takes_plain_version_on_cpu():
    logits = _logits(3, 4, 3104)
    temps = np.array([0.7, 0.0, 1.0, 0.9], np.float32)
    us = np.array([0.1, 0.5, 0.9, 0.999], np.float32)
    before = tcs.kernel_sample.launches
    for mode in ("greedy", "simple"):
        tx, bn = tcs._prep(torch.from_numpy(logits), torch.from_numpy(temps),
                           mode=mode)
        got = tcs.kernel_sample(tx, torch.from_numpy(temps),
                                torch.from_numpy(us), greedy=mode == "greedy")
        want = tcs._plain_sample(tx, torch.from_numpy(temps),
                                 torch.from_numpy(us), bn=bn,
                                 greedy=mode == "greedy")
        assert torch.equal(got, want)
    assert tcs.kernel_sample.launches == before
    with pytest.raises(ValueError, match="mode"):
        tcs.fused_sample(torch.from_numpy(logits), torch.from_numpy(temps),
                         None, None, mode="beam")


def test_topp_same_nucleus_support():
    S, V = 6, 512
    logits = _logits(4, S, V, scale=2.5)
    temps = np.array([0.8, 1.0, 0.5, 0.0, 1.2, 0.9], np.float32)
    top_ps = np.array([0.9, 0.5, 0.95, 0.9, 0.3, 1.0], np.float32)
    rng = np.random.default_rng(5)
    for _ in range(8):
        us = rng.random(S).astype(np.float32)
        want = np.asarray(jps._topp_sample(
            jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(top_ps),
            jnp.asarray(us)))
        got = tcs.fused_sample(torch.from_numpy(logits),
                               torch.from_numpy(temps),
                               torch.from_numpy(top_ps),
                               torch.from_numpy(us), mode="topp").numpy()
        for r in range(S):
            if temps[r] <= 0:
                assert got[r] == want[r] == np.argmax(logits[r])
                continue
            # the nucleus: sorted-prefix tokens whose preceding mass is
            # within top_p (all tokens when top_p == 1)
            sc = logits[r].astype(np.float64) / temps[r]
            order = np.argsort(-sc, kind="stable")
            p = np.exp(sc[order] - sc[order].max())
            p /= p.sum()
            before = np.cumsum(p) - p
            keep = (before <= top_ps[r] + 1e-6) | (top_ps[r] >= 1.0)
            support = set(order[keep].tolist())
            assert got[r] in support and want[r] in support
            if got[r] != want[r]:
                # different tokens only at a CDF boundary of the nucleus
                cdf = np.cumsum(np.where(keep, p, 0.0))
                assert np.abs(cdf - us[r] * cdf[-1]).min() <= 1e-5


def test_legacy_sampler_greedy_rows_and_support():
    S, V = 4, 300
    logits = torch.from_numpy(_logits(6, S, V))
    temps = torch.tensor([0.0, 0.7, 0.7, 0.0])
    top_p = torch.tensor([1.0, 0.5, 1.0, 0.2])
    us = torch.tensor([0.3, 0.6, 0.99, 0.5])
    got = _sample_jit(logits, temps, top_p, us)
    assert got.dtype == torch.int32
    am = torch.argmax(logits, -1)
    assert got[0] == am[0] and got[3] == am[3]
    # top-p 0.5 keeps only the head of the sorted distribution
    probs = torch.softmax(logits[1] / 0.7, -1)
    srt, idx = torch.sort(probs, descending=True)
    keep = idx[(torch.cumsum(srt, 0) - srt) <= 0.5]
    assert int(got[1]) in keep.tolist()
