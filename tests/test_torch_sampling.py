"""The port's sampling epilogue held against the JAX package on the CPU:
K9's plain version ``_plain_sample`` against the reference's ``_xla_sample``
(the twin of its Pallas kernel), fed the same prepped logits and the same
uniforms; the nucleus path ``_topp_sample``; the legacy sampler; and, on
the threefry twin (``ops/prng.py``), the draws themselves: ``sample_rows``
and ``_sample_jit`` bit for bit against the reference's on the same logits
and keys, and the batched engines' sampled streams against the JAX
engine's for the same seeds.

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
from datatunerx_tpu.serving.engine import _sample_jit as j_sample_jit
from datatunerx_tpu_torch.ops import cuda_sampling as tcs
from datatunerx_tpu_torch.ops import prng
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
    keys = prng.to_device(np.stack([prng.PRNGKey(i) for i in range(S)]),
                          "cpu")
    got = _sample_jit(logits, temps, top_p, keys)
    assert got.dtype == torch.int32
    am = torch.argmax(logits, -1)
    assert got[0] == am[0] and got[3] == am[3]
    # top-p 0.5 keeps only the head of the sorted distribution
    probs = torch.softmax(logits[1] / 0.7, -1)
    srt, idx = torch.sort(probs, descending=True)
    keep = idx[(torch.cumsum(srt, 0) - srt) <= 0.5]
    assert int(got[1]) in keep.tolist()


def _rows(seed=0, S=4, V=3000):
    logits = _logits(seed, S, V)
    temps = np.array([0.8, 0.8, 1.2, 0.0], np.float32)[:S]
    top_ps = np.array([1.0, 0.9, 1.0, 1.0], np.float32)[:S]
    keys = np.stack([prng.PRNGKey(100 + i) for i in range(S)])
    return logits, temps, top_ps, keys


@pytest.mark.parametrize("mode", ["greedy", "simple", "topp"])
def test_sample_rows_draws_the_reference_bits(mode):
    """The same logits and keys: equal tokens and equal new keys (exact)."""
    logits, temps, top_ps, keys = _rows()
    jt, jk = jps.sample_rows(jnp.asarray(logits), jnp.asarray(temps),
                             jnp.asarray(top_ps), jnp.asarray(keys),
                             mode=mode, impl="xla")
    tt, tk = tcs.sample_rows(torch.from_numpy(logits),
                             torch.from_numpy(temps),
                             torch.from_numpy(top_ps), keys, mode=mode)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tk, np.asarray(jk))


def test_legacy_sampler_draws_the_reference_bits():
    """``_sample_jit`` (categorical over the filtered sorted logits) on the
    same logits and draw keys as the reference's, row by row (exact)."""
    import jax

    logits, temps, top_ps, keys = _rows(1)
    want = jax.vmap(j_sample_jit)(jnp.asarray(logits), jnp.asarray(temps),
                                  jnp.asarray(top_ps), jnp.asarray(keys))
    got = _sample_jit(torch.from_numpy(logits), torch.from_numpy(temps),
                      torch.from_numpy(top_ps), prng.to_device(keys, "cpu"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # an all-greedy batch skips the draw and gives the argmax
    greedy = _sample_jit(torch.from_numpy(logits), torch.zeros(4),
                         torch.ones(4), None)
    np.testing.assert_array_equal(greedy.numpy(), logits.argmax(-1))


# ------------------------------------------------ the engines' sampled streams
# The preset:debug weights with the final norm scaled by 64: random weights
# give near-flat next-token distributions, where a bf16 rounding that the
# two frameworks place differently moves any sampled token; at this scale a
# step's distribution has a head, as a trained model's has.
LOGIT_SCALE = 64.0
SAMPLED = [(0.8, 1.0, 100), (0.8, 0.9, 101), (1.2, 1.0, 102), (0.0, 1.0, 103)]
NEW = 12


@pytest.fixture(scope="module")
def peaked_export(tmp_path_factory):
    import jax

    from datatunerx_tpu.training.checkpoint import export_merged_model
    from datatunerx_tpu.utils.model_loader import load_model_and_tokenizer

    cfg, params, _ = load_model_and_tokenizer("preset:debug")
    params = dict(params)
    params["norm"] = {"scale": params["norm"]["scale"] * LOGIT_SCALE}
    d = tmp_path_factory.mktemp("peaked_export")
    export_merged_model(jax.device_get(params), cfg, str(d))
    return str(d)


def _sampled_run(engine):
    tok = engine.tokenizer
    reqs = [engine.submit(tok.encode(f"prompt number {i} " * (i + 1)),
                          max_new_tokens=NEW, temperature=t, top_p=p,
                          seed=seed)
            for i, (t, p, seed) in enumerate(SAMPLED)]
    for r in reqs:
        assert r.done.wait(300) and r.error is None, r.error
    return [r.tokens for r in reqs]


def _parting_explained(export, prompt, prefix, token, temp, top_p, seed):
    """A sampled stream's parting step is explained by the logits alone:
    the step's draw key (the seed's key split once a token) drawn by the
    REFERENCE's legacy sampler over the PORT's logits for the step (a
    bf16 forward over the prompt plus the agreed prefix) gives the port's
    token, and the two frameworks' logits there lie within 4 bf16 ulps of
    each other. So the random bits are the reference's; a bf16 rounding
    that the frameworks place differently moved the draw."""
    import jax

    from datatunerx_tpu.models.llama import forward as jforward
    from datatunerx_tpu.utils.decoding import prepare_prompt
    from datatunerx_tpu.utils.model_loader import load_model_and_tokenizer
    from datatunerx_tpu_torch.models.llama import forward as tforward
    from datatunerx_tpu_torch.utils.model_loader import (
        load_model_and_tokenizer as tload,
    )

    cfg, params, tok = load_model_and_tokenizer(export, dtype=jnp.bfloat16)
    ids, mask, positions, _, n, _, _ = prepare_prompt(
        prompt, tok.eos_token_id, 256, NEW)
    k = len(prefix)
    seq, pos = ids + list(prefix), positions + list(range(n, n + k))
    msk = mask + [1] * k
    jrow = np.asarray(jforward(
        params, jnp.asarray([seq]), cfg, positions=jnp.asarray([pos]),
        attention_mask=jnp.asarray([msk]),
        compute_dtype=jnp.bfloat16)[0][0, -1])
    tcfg, tparams, _ = tload(export, dtype=torch.bfloat16, device="cpu")
    with torch.inference_mode():
        trow = tforward(tparams, torch.tensor([seq]), tcfg,
                        positions=torch.tensor([pos]),
                        attention_mask=torch.tensor([msk]),
                        compute_dtype=torch.bfloat16)[0][0, -1].numpy()
    key = jax.random.PRNGKey(seed)
    for _ in range(k + 1):
        key, sub = jax.random.split(key)
    drawn = int(j_sample_jit(jnp.asarray(trow), temp, top_p, sub))
    ulp = 2.0 ** (np.floor(np.log2(np.abs(jrow).max())) - 7)
    return drawn == token and np.abs(trow - jrow).max() <= 4 * ulp


@pytest.mark.parametrize("layout", [
    dict(kv_block_size=16, paged_kernel="on", sampling_epilogue="on"),
    dict(kv_block_size=16, paged_kernel="on", sampling_epilogue="off"),
    dict(kv_block_size=0, sampling_epilogue="off"),
], ids=["paged-epilogue", "paged-legacy", "dense-legacy"])
def test_batched_sampled_streams_match_jax_engine(peaked_export, layout):
    """Four concurrent requests (sampled, sampled top-p, hot, greedy) with
    the same seeds through the port's and the JAX package's engines on the
    same weights: the streams are equal token for token. A stream may part
    only where the logits explain it (``_parting_explained``),
    which is reported; the epilogue's streams must be equal throughout."""
    from datatunerx_tpu.serving.batched_engine import BatchedEngine as JEngine
    from datatunerx_tpu_torch.serving.batched_engine import BatchedEngine

    kw = dict(template="vanilla", max_seq_len=256, slots=4, decode_chunk=4,
              prefill_chunk=64, **layout)
    jeng = JEngine(peaked_export, **kw)
    try:
        want = _sampled_run(jeng)
    finally:
        jeng.close()
    eng = BatchedEngine(peaked_export, device="cpu", **kw)
    try:
        got = _sampled_run(eng)
        tok = eng.tokenizer
    finally:
        eng.close()
    assert len({tuple(w) for w in want}) > 1  # the draws really sample
    for i, (w, g) in enumerate(zip(want, got)):
        if w == g:
            continue
        n = next(j for j in range(min(len(w), len(g))) if w[j] != g[j])
        temp, top_p, seed = SAMPLED[i]
        assert layout["sampling_epilogue"] == "off" and temp > 0, (i, n)
        prompt = tok.encode(f"prompt number {i} " * (i + 1))
        assert _parting_explained(peaked_export, prompt, w[:n], g[n], temp,
                                  top_p, seed), f"request {i} parts at {n}"
        print(f"request {i} parts at step {n} (explained by the logits)")
