"""The port's dense KV cache held against the JAX package on the CPU:
``init_cache``, the dense branches of the cache interface (scalar and
per-slot cursors, a write past the row's end dropped as JAX's scatter drops
it), and forward logits over dense caches.

Inputs come from a numpy seed. Integer results and copied values are exact;
forward logits at float32 are held to atol 2e-4, rtol 2e-3
(``tests/test_torch_llama.py``'s bound: f32 sums in another order); the
port's paged gather path against its dense path is exact, as
``tests/test_paged_engine.py::test_paged_forward_matches_dense_exactly``
holds the reference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datatunerx_tpu.models.config import get_config as jget_config
from datatunerx_tpu.models.llama import forward as jforward
from datatunerx_tpu.models.llama import init_cache as jinit_cache
from datatunerx_tpu.models.llama import init_params as jinit
from datatunerx_tpu.ops import attention as jatt
from datatunerx_tpu_torch.models.config import get_config as tget_config
from datatunerx_tpu_torch.models.convert import cache_from_jax, params_from_jax
from datatunerx_tpu_torch.models.llama import forward as tforward
from datatunerx_tpu_torch.models.llama import init_cache as tinit_cache
from datatunerx_tpu_torch.ops import attention as tatt
from datatunerx_tpu_torch.ops.paged_attention import init_paged_cache

TOL = dict(atol=2e-4, rtol=2e-3)


@pytest.mark.parametrize("per_slot", [False, True])
@pytest.mark.parametrize("quant", [None, "int8"])
def test_init_cache_matches_reference(per_slot, quant):
    jc = jinit_cache(jget_config("debug"), 3, 24, dtype=jnp.float32,
                     per_slot=per_slot, quantize=quant)
    tc = tinit_cache(tget_config("debug"), 3, 24, dtype=torch.float32,
                     per_slot=per_slot, quantize=quant)
    assert sorted(tc) == sorted(jc)
    for name, leaf in jc.items():
        assert tuple(tc[name].shape) == tuple(leaf.shape), name
        assert str(tc[name].dtype).split(".")[1] == str(leaf.dtype), name
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(leaf))
    assert tatt.kv_cache_width(tc) == jatt.kv_cache_width(jc) == 24
    with pytest.raises(ValueError, match="unsupported cache quantization"):
        tinit_cache(tget_config("debug"), 1, 8, quantize="fp8")


def _dense_pair(rng, lens, S=12, B=3, d=4, quant=None):
    """The same dense cache, already holding values, on both sides (head
    vectors cut to ``d`` to keep the test small)."""
    KV = jget_config("debug").num_kv_heads
    jc = jinit_cache(jget_config("debug"), B, S, dtype=jnp.float32,
                     per_slot=np.ndim(lens) == 1, quantize=quant)
    jc = dict(jc, len=jnp.asarray(lens, jnp.int32))
    L = jc["k"].shape[0]
    for name in ("k", "v"):  # a cache that already holds something
        vals = rng.integers(-50, 50, size=(L, B, S, KV, d))
        jc[name] = jnp.asarray(vals).astype(jc[name].dtype)
    jc["pos"] = jnp.asarray(rng.integers(0, 9, size=(B, S)), jnp.int32)
    return jc, cache_from_jax(jax.device_get(jc))


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("lens, T", [
    (4, 3),                 # scalar cursor
    (10, 3),                # scalar cursor near the end: the start is clamped
    ([0, 5, 9], 1),         # per-slot cursors, one decode token
    ([2, 10, 12], 3),       # rows 1 and 2 run past the end: writes dropped
    ([12, 13, 11], 1),      # exhausted rows
])
def test_dense_writes_match_reference(lens, T, quant):
    rng = np.random.default_rng(0)
    jc, tc = _dense_pair(rng, lens, quant=quant)
    B, S = jc["pos"].shape
    positions = rng.integers(0, 40, size=(B, T)).astype(np.int32)
    mask = (rng.random((B, T)) > 0.3).astype(np.int32)
    jpos, jview = jatt.cache_positions_update(jc, jnp.asarray(positions),
                                              jnp.asarray(mask))
    targets = tatt.cache_write_targets(tc, T)
    tpos, tview = tatt.cache_positions_update(
        tc, torch.from_numpy(positions), torch.from_numpy(mask),
        targets=targets)
    assert tpos.data_ptr() == tc["pos"].data_ptr()  # updated in place
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tview.numpy(), np.asarray(jview))
    KV, d = jc["k"].shape[-2:]
    kw = rng.standard_normal((B, T, KV, d)).astype(np.float32)
    vw = rng.standard_normal((B, T, KV, d)).astype(np.float32)
    sc = (lambda c, n: c[n][0]) if quant else (lambda c, n: None)
    jout = jatt.kv_cache_update(jc, jc["k"][0], jc["v"][0], sc(jc, "k_scale"),
                                sc(jc, "v_scale"), jnp.asarray(kw),
                                jnp.asarray(vw))
    for tg in (targets, None):  # precomputed targets, or computed inside
        _, tc2 = _dense_pair(np.random.default_rng(0), lens, quant=quant)
        tout = tatt.kv_cache_update(
            tc2, tc2["k"][0], tc2["v"][0], sc(tc2, "k_scale"),
            sc(tc2, "v_scale"), torch.from_numpy(kw), torch.from_numpy(vw),
            targets=tg)
        assert tout[0].data_ptr() == tc2["k"][0].data_ptr()
        for got, want in zip(tout, jout):
            assert (got is None) == (want is None)
            if got is not None:
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dense_write_wider_than_the_row_raises():
    tc = tinit_cache(tget_config("debug"), 1, 4)
    with pytest.raises(ValueError, match="do not fit"):
        tatt.cache_write_targets(tc, 5)


@pytest.fixture(scope="module")
def weights():
    jcfg = jget_config("debug")
    jparams = jinit(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tparams = params_from_jax(jax.device_get(jparams), tget_config("debug"))
    return jcfg, jparams, tparams


def _inputs(vocab, B=2, P=24):
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, vocab, size=(B, P)).astype(np.int32)
    mask = np.ones((B, P), np.int32)
    mask[1, :5] = 0  # a left-padded row
    pos = np.stack([np.arange(P), np.maximum(np.arange(P) - 5, 0)])
    return prompt, mask, pos.astype(np.int32)


@pytest.mark.parametrize("per_slot", [False, True],
                         ids=["scalar_cursor", "per_slot"])
def test_dense_prefill_then_decode_matches_reference(weights, per_slot):
    jcfg, jparams, tparams = weights
    tcfg = tget_config("debug")
    prompt, mask, pos = _inputs(jcfg.vocab_size)
    jc = jinit_cache(jcfg, 2, 32, dtype=jnp.float32, per_slot=per_slot)
    tc = tinit_cache(tcfg, 2, 32, dtype=torch.float32, per_slot=per_slot)
    jl, jc = jforward(jparams, jnp.asarray(prompt), jcfg,
                      positions=jnp.asarray(pos),
                      attention_mask=jnp.asarray(mask), cache=jc)
    tl, tc = tforward(tparams, torch.from_numpy(prompt), tcfg,
                      positions=torch.from_numpy(pos),
                      attention_mask=torch.from_numpy(mask), cache=tc)
    live = mask.astype(bool)
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live], **TOL)
    nxt = pos[:, -1] + 1
    for step in range(4):
        tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        p = (nxt + step)[:, None].astype(np.int32)
        jl, jc = jforward(jparams, jnp.asarray(tok), jcfg,
                          positions=jnp.asarray(p), cache=jc)
        tl, tc = tforward(tparams, torch.from_numpy(tok), tcfg,
                          positions=torch.from_numpy(p), cache=tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tc["len"].shape == jc["len"].shape
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), **TOL)


def test_paged_forward_matches_dense_exactly(weights):
    """The port's counterpart of the reference's test of that name: prefill
    and a decode step give bit-equal logits on the two layouts, also when a
    slot holds fewer blocks than a full table."""
    _, _, tparams = weights
    tcfg = tget_config("debug")
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(
        rng.integers(0, tcfg.vocab_size, size=(2, 8)).astype(np.int32))
    dense = tinit_cache(tcfg, 2, 16, dtype=torch.float32, per_slot=True)
    ld, dense = tforward(tparams, toks, tcfg, cache=dense)
    nxt = ld[:, -1].argmax(-1).to(torch.int32)[:, None]
    pos = torch.full((2, 1), 8, dtype=torch.int32)
    l2d, _ = tforward(tparams, nxt, tcfg, positions=pos, cache=dense)
    for rows in ([[0, 1, 2, 3], [4, 5, 6, 7]], [[0, 1, 2, 3], [4, 5, 6, -1]]):
        paged = init_paged_cache(tcfg, 2, 8, 4, 4, dtype=torch.float32)
        paged["block_tables"] = torch.tensor(rows, dtype=torch.int32)
        lp, paged = tforward(tparams, toks, tcfg, cache=paged)
        assert torch.equal(ld, lp)
        l2p, _ = tforward(tparams, nxt, tcfg, positions=pos, cache=paged)
        assert torch.equal(l2d, l2p)
