"""The port's paged-attention ops held against the JAX package on the CPU:
rope, the attendability mask, the paged writes and gathers, and the plain
versions of the paged decode (K7) and multi-token (K8) kernels against the
Pallas kernels in interpret mode. Inputs are made from a numpy seed and
handed to both sides as numpy arrays.

Tolerances: integer results (positions, tables, masks) and copied values
are exact; rope is float32 at atol 1e-6 (both sides compute the same f32
formula, through different libm); the kernels are float32 at
atol=rtol=1e-5 and bf16 at atol 2^-8, rtol 2^-7 (about one bf16 ulp),
because their f32 sums run in a different order."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datatunerx_tpu.models import config as jcfg
from datatunerx_tpu.ops import attention as jatt
from datatunerx_tpu.ops import paged_attention as jpa
from datatunerx_tpu.ops import pallas_paged_attention as jpk
from datatunerx_tpu.ops import rope as jrope
from datatunerx_tpu_torch.models import config as tcfg
from datatunerx_tpu_torch.ops import attention as tatt
from datatunerx_tpu_torch.ops import cuda_paged_attention as tpk
from datatunerx_tpu_torch.ops import paged_attention as tpa
from datatunerx_tpu_torch.ops import rope as trope

BS = 8
SENT = jpa.POS_SENTINEL


def _np(x):
    return np.asarray(x, dtype=np.float32) if x.dtype != np.int32 else \
        np.asarray(x)


def test_presets_match_reference_field_for_field():
    assert sorted(tcfg.PRESETS) == sorted(jcfg.PRESETS)
    for name in jcfg.PRESETS:
        assert dataclasses.asdict(tcfg.PRESETS[name]) == \
            dataclasses.asdict(jcfg.PRESETS[name]), name
    assert [f.name for f in dataclasses.fields(tcfg.ModelConfig)] == \
        [f.name for f in dataclasses.fields(jcfg.ModelConfig)]


@pytest.mark.parametrize("scaling", [None, "linear", "dynamic"])
def test_rope_matches_reference(scaling):
    rng = np.random.default_rng(0)
    pos = rng.integers(0, 3000, size=(2, 7)).astype(np.int32)
    kw = dict(theta=10000.0, scaling_type=scaling, scaling_factor=2.0,
              max_seq_len=1024, seq_len=2048)
    jc, js = jrope.rope_cos_sin(jnp.asarray(pos), 16, **kw)
    tc, ts = trope.rope_cos_sin(torch.from_numpy(pos), 16, **kw)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6, rtol=0)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    jx = jrope.apply_rope(jnp.asarray(x), jc, js)
    tx = trope.apply_rope(torch.from_numpy(x), tc, ts)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-6, rtol=0)


def test_attention_allow_and_bias_match_reference():
    rng = np.random.default_rng(1)
    qp = rng.integers(0, 20, size=(2, 5)).astype(np.int32)
    kp = rng.integers(0, 20, size=(2, 24)).astype(np.int32)
    kp[:, -3:] = SENT
    valid = rng.random((2, 24)) > 0.2
    j = jatt.attention_allow(jnp.asarray(qp), jnp.asarray(kp),
                             jnp.asarray(valid))
    t = tatt.attention_allow(torch.from_numpy(qp), torch.from_numpy(kp),
                             torch.from_numpy(valid))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    jb = jatt.make_causal_bias(jnp.asarray(qp), jnp.asarray(kp))
    tb = tatt.make_causal_bias(torch.from_numpy(qp), torch.from_numpy(kp))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def test_block_allocator_and_reserve_math_match_reference():
    ja, ta = jpa.BlockAllocator(6), tpa.BlockAllocator(6)
    for n in (2, 3, 2):
        assert ta.alloc(n) == ja.alloc(n)
    ja.free([3, 1])
    ta.free([3, 1])
    assert ta.alloc(3) == ja.alloc(3)
    assert ta.free_count == ja.free_count
    with pytest.raises(tpa.BlockAllocatorError):
        ta.free([9])
    with pytest.raises(tpa.BlockAllocatorError):
        ta.free([5, 5])
    for args in ((100, 16), (100, 16, 5), (100, 16, 50, 128), (0, 16)):
        assert tpa.blocks_for_depth(*args) == jpa.blocks_for_depth(*args)


def _cache_pair(rng, slots=3, NB=10, nbps=4, KV=2, d=8, L=1):
    """The same paged cache on both sides: tables with -1 entries and a slot
    whose cursor sits at the end of its table (writes past it are
    invalid)."""
    tables = np.full((slots, nbps), -1, np.int32)
    tables[0, :3] = [4, 1, 7]
    tables[1, :1] = [2]
    tables[2, :4] = [0, 3, 5, 6]
    lens = np.array([5, 7, nbps * BS - 1], np.int32)
    pos = np.full((NB + 1, BS), SENT, np.int32)
    k = rng.standard_normal((L, NB + 1, BS, KV, d)).astype(np.float32)
    v = rng.standard_normal((L, NB + 1, BS, KV, d)).astype(np.float32)
    jc = {"len": jnp.asarray(lens), "block_tables": jnp.asarray(tables),
          "pos": jnp.asarray(pos[:NB]), "k": jnp.asarray(k[:, :NB]),
          "v": jnp.asarray(v[:, :NB])}
    tc = {"len": torch.from_numpy(lens.copy()),
          "block_tables": torch.from_numpy(tables.copy()),
          "pos": torch.from_numpy(pos.copy()), "k": torch.from_numpy(k.copy()),
          "v": torch.from_numpy(v.copy())}
    return jc, tc


@pytest.mark.parametrize("T", [1, 3])
def test_paged_writes_and_gathers_match_reference(T):
    """Positions and K/V scatter through the tables (invalid targets
    dropped by JAX, routed to the scratch block by the port), and the
    gathered views agree element for element."""
    rng = np.random.default_rng(2)
    jc, tc = _cache_pair(rng)
    B = 3
    upd = rng.integers(0, 50, size=(B, T)).astype(np.int32)
    jpool, jview = jpa.paged_record_positions(jc, jnp.asarray(upd))
    tpool, tview = tpa.paged_record_positions(tc, torch.from_numpy(upd))
    np.testing.assert_array_equal(tpool[:-1].numpy(), np.asarray(jpool))
    np.testing.assert_array_equal(tview.numpy(), np.asarray(jview))

    kw = rng.standard_normal((B, T, 2, 8)).astype(np.float32)
    vw = rng.standard_normal((B, T, 2, 8)).astype(np.float32)
    jk, jv, _, _, jka, jva, _, _ = jpa.paged_kv_update(
        jc["k"][0], jc["v"][0], None, None, jc["block_tables"], jc["len"],
        jnp.asarray(kw), jnp.asarray(vw), None, None)
    tk, tv, tka, tva = tpa.paged_kv_update(
        tc["k"][0], tc["v"][0], tc["block_tables"], tc["len"],
        torch.from_numpy(kw), torch.from_numpy(vw))
    assert tk.data_ptr() == tc["k"][0].data_ptr()  # updated in place
    np.testing.assert_array_equal(tk[:-1].numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv[:-1].numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tka.numpy(), np.asarray(jka))
    np.testing.assert_array_equal(tva.numpy(), np.asarray(jva))


def _kernel_inputs(rng, B, nbps, KV, G, d, lens, tables=None, T=1):
    """A block pool whose slots hold ``lens[b]`` tokens (positions
    0..len-1) through ``tables`` (default: disjoint ascending blocks)."""
    if tables is None:
        tables = np.full((B, nbps), -1, np.int32)
        nxt = 0
        for b in range(B):
            need = -(-lens[b] // BS)
            tables[b, :need] = np.arange(nxt, nxt + need)
            nxt += need
    NB = int(max(tables.max() + 1, 1))
    k = rng.standard_normal((NB + 1, BS, KV, d)).astype(np.float32)
    v = rng.standard_normal((NB + 1, BS, KV, d)).astype(np.float32)
    pos = np.full((NB + 1, BS), SENT, np.int32)
    for b in range(B):
        for i in range(lens[b]):
            pos[tables[b, i // BS], i % BS] = i
    q = rng.standard_normal((B, T, KV * G, d)).astype(np.float32)
    return tables, k, v, pos, q, NB


CASES = {
    # name: (B, nbps, KV, G, d, lens, tables)
    "ragged_with_minus_one": (3, 4, 2, 2, 16, [25, 9, 1], None),
    "empty_slot": (3, 3, 2, 2, 16, [17, 0, 5], None),
    "gqa": (2, 3, 4, 3, 8, [11, 20], None),
    "no_gqa": (2, 3, 2, 1, 16, [13, 6], None),
    "aliased_tables": (3, 4, 2, 2, 16, [20, 18, 12],
                       np.array([[0, 1, 2, -1], [0, 1, 3, -1],
                                 [0, 4, -1, -1]], np.int32)),
}
DTYPES = {
    "f32": (jnp.float32, torch.float32, dict(atol=1e-5, rtol=1e-5)),
    "bf16": (jnp.bfloat16, torch.bfloat16, dict(atol=2**-8, rtol=2**-7)),
}


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_plain_matches_pallas_kernel(case, dt):
    B, nbps, KV, G, d, lens, tables = CASES[case]
    jdt, tdt, tol = DTYPES[dt]
    rng = np.random.default_rng(3)
    tables, k, v, pos, q, NB = _kernel_inputs(rng, B, nbps, KV, G, d, lens,
                                              tables)
    qpos = np.array([max(n - 1, 0) for n in lens], np.int32)
    want = jpk.paged_decode_attention(
        jnp.asarray(q[:, 0]).astype(jdt), jnp.asarray(k[:NB]).astype(jdt),
        jnp.asarray(v[:NB]).astype(jdt), None, None, jnp.asarray(tables),
        jnp.asarray(pos[:NB]), jnp.asarray(qpos), interpret=True)
    before = tpk.paged_decode_attention.launches
    got = tpk.paged_decode_attention(
        torch.from_numpy(q[:, 0]).to(tdt), torch.from_numpy(k).to(tdt),
        torch.from_numpy(v).to(tdt), None, None, torch.from_numpy(tables),
        torch.from_numpy(pos), torch.from_numpy(qpos))
    assert tpk.paged_decode_attention.launches == before  # plain on the CPU
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)
    if case == "empty_slot":
        assert not got[1].any()


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_multitoken_plain_matches_pallas_kernel(case, dt):
    B, nbps, KV, G, d, lens, tables = CASES[case]
    jdt, tdt, tol = DTYPES[dt]
    T = 4
    rng = np.random.default_rng(4)
    tables, k, v, pos, q, NB = _kernel_inputs(rng, B, nbps, KV, G, d, lens,
                                              tables, T=T)
    # the chunk is the last T written tokens of each slot (post-write)
    qpos = np.stack([np.arange(n - T, n) for n in lens]).astype(np.int32)
    view = np.where((tables >= 0)[:, :, None], pos[np.maximum(tables, 0)],
                    SENT).reshape(B, -1)
    allow = np.array(jatt.attention_allow(jnp.asarray(qpos),
                                          jnp.asarray(view)))
    want = jpk.paged_multitoken_attention(
        jnp.asarray(q).astype(jdt), jnp.asarray(k[:NB]).astype(jdt),
        jnp.asarray(v[:NB]).astype(jdt), None, None, jnp.asarray(tables),
        jnp.asarray(allow), interpret=True)
    got = tpk.paged_multitoken_attention(
        torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
        torch.from_numpy(v).to(tdt), None, None, torch.from_numpy(tables),
        torch.from_numpy(allow))
    # rows with no attendable lane hold junk on both sides (the garbage
    # contract); parity is asserted on the others
    live = allow.any(-1)
    np.testing.assert_allclose(got.float().numpy()[live],
                               np.asarray(want, np.float32)[live], **tol)


def test_kernel_wrappers_refuse_int8_pools():
    q = torch.zeros((1, 4, 8))
    pool = torch.zeros((3, BS, 2, 8))
    with pytest.raises(NotImplementedError, match="int8"):
        tpk.paged_decode_attention(q, pool, pool, pool, pool,
                                   torch.zeros((1, 2), dtype=torch.int32),
                                   torch.zeros((3, BS), dtype=torch.int32),
                                   torch.zeros((1,), dtype=torch.int32))
