"""The paged block-row primitives and the allocator's refcounts, against the
JAX package's: ``paged_insert_row``, ``paged_extract_row`` (full and
``width``-trimmed), ``row_trim`` and ``paged_copy_block`` on the same numpy
pools (bf16, and int8 with f32 scale pools), bit for bit, and the
dtx-kv-session row format (``pack_kv_row``/``unpack_kv_row``,
``pack_logits``/``unpack_logits``) round-tripped across the two packages.

The port's pools hold one scratch block more than the JAX pools
(``ops/paged_attention.py``): lanes JAX drops land there, so the first
``NB`` blocks are what is compared."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datatunerx_tpu.ops import paged_attention as jpa
from datatunerx_tpu.serving import migration as jmig
from datatunerx_tpu_torch.models.convert import cache_from_jax
from datatunerx_tpu_torch.ops import paged_attention as tpa
from datatunerx_tpu_torch.ops.paged_attention import (
    POS_SENTINEL,
    BlockAllocator,
    BlockAllocatorError,
)
from datatunerx_tpu_torch.serving import migration as tmig

L, NB, BS, KV, D, S, NBPS = 2, 10, 4, 2, 8, 3, 5


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _jnp(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _pools(quant: bool, seed: int = 0):
    """A JAX paged cache with written blocks, and the port's copy."""
    rng = np.random.default_rng(seed)
    shape = (L, NB, BS, KV, D)
    cache = {
        "len": jnp.asarray(rng.integers(0, NBPS * BS, S), jnp.int32),
        "pos": jnp.asarray(rng.integers(0, 64, (NB, BS)), jnp.int32),
        "block_tables": jnp.asarray(
            [[1, 4, 2, -1, -1], [7, 3, 9, 8, 0], [-1] * NBPS], jnp.int32),
    }
    if quant:
        cache["k"] = jnp.asarray(rng.integers(-127, 128, shape), jnp.int8)
        cache["v"] = jnp.asarray(rng.integers(-127, 128, shape), jnp.int8)
        cache["k_scale"] = jnp.asarray(rng.random(shape[:-1]), jnp.float32)
        cache["v_scale"] = jnp.asarray(rng.random(shape[:-1]), jnp.float32)
    else:
        cache["k"] = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
        cache["v"] = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
    return cache, cache_from_jax({k: np.asarray(v) for k, v in cache.items()})


def _row(quant: bool, W: int, cursor: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    shape = (L, 1, W, KV, D)
    pos = np.full((1, W), POS_SENTINEL, np.int32)
    pos[0, :cursor] = np.arange(cursor)
    row = {"len": jnp.asarray(cursor, jnp.int32), "pos": jnp.asarray(pos)}
    if quant:
        row["k"] = jnp.asarray(rng.integers(-127, 128, shape), jnp.int8)
        row["v"] = jnp.asarray(rng.integers(-127, 128, shape), jnp.int8)
        row["k_scale"] = jnp.asarray(rng.random(shape[:-1]), jnp.float32)
        row["v_scale"] = jnp.asarray(rng.random(shape[:-1]), jnp.float32)
    else:
        row["k"] = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
        row["v"] = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
    return row, cache_from_jax({k: np.asarray(v) for k, v in row.items()})


def _assert_pools_equal(tcache, jcache, keys=("k", "v", "k_scale", "v_scale",
                                              "pos")):
    for key in keys:
        if key not in jcache:
            continue
        got = tcache[key]
        got = got[:NB] if key == "pos" else got[:, :NB]
        np.testing.assert_array_equal(_np(got), _jnp(jcache[key]), key)
    np.testing.assert_array_equal(_np(tcache["block_tables"]),
                                  _jnp(jcache["block_tables"]))


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("W", [8, 20, 28], ids=["short", "table", "past"])
def test_insert_row_matches_reference(quant, W):
    """A row scattered through a new table: narrower than the table, as
    wide, and wider than the slot's allocation (the excess is dropped)."""
    jcache, tcache = _pools(quant)
    jrow, trow = _row(quant, W, cursor=min(W, 7))
    table = [5, 6, 2, 4, -1]
    jout = jpa.paged_insert_row(jcache, 1, jnp.asarray(table, jnp.int32),
                                jrow)
    tpa.paged_insert_row(tcache, 1, torch.tensor(table, dtype=torch.int32),
                         trow)
    _assert_pools_equal(tcache, jout)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("width", [None, 1, 6, 9, 40],
                         ids=["full", "w1", "w6", "w9", "wide"])
@pytest.mark.parametrize("slot", [0, 1, 2])
def test_extract_row_matches_reference(quant, width, slot):
    jcache, tcache = _pools(quant)
    jrow = jpa.paged_extract_row(jcache, slot, 6, width=width)
    trow = tpa.paged_extract_row(tcache, slot, 6, width=width)
    assert int(trow["len"]) == int(jrow["len"]) == 6
    for key in ("k", "v", "k_scale", "v_scale", "pos"):
        if key in jrow:
            assert tuple(trow[key].shape) == tuple(jrow[key].shape), key
            np.testing.assert_array_equal(_np(trow[key]), _jnp(jrow[key]),
                                          key)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("width", [1, 5, 12, 99])
def test_row_trim_matches_reference(quant, width):
    jrow, trow = _row(quant, 12, cursor=9)
    jt, tt = jpa.row_trim(jrow, width), tpa.row_trim(trow, width)
    for key in ("k", "v", "k_scale", "v_scale", "pos"):
        if key in jt:
            np.testing.assert_array_equal(_np(tt[key]), _jnp(jt[key]), key)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("keep", [0, 1, 3, 4])
def test_copy_block_matches_reference_and_scrubs(quant, keep):
    jcache, tcache = _pools(quant)
    jout = jpa.paged_copy_block(jcache, jnp.asarray(4, jnp.int32),
                                jnp.asarray(6, jnp.int32),
                                jnp.asarray(keep, jnp.int32))
    tpa.paged_copy_block(tcache, 4, 6, keep)
    _assert_pools_equal(tcache, jout)
    pos = tcache["pos"][6]
    assert (pos[keep:] == POS_SENTINEL).all()
    assert torch.equal(pos[:keep], tcache["pos"][4][:keep])


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_insert_then_extract_round_trips(quant):
    """The port's own inverse pair: a row scattered into a slot's blocks
    gathers back to itself on the table's lanes."""
    _, tcache = _pools(quant)
    _, trow = _row(quant, 12, cursor=10)
    tpa.paged_insert_row(tcache, 2, torch.tensor([3, 8, 5, -1, -1],
                                                 dtype=torch.int32), trow)
    back = tpa.paged_extract_row(tcache, 2, 10, width=12)
    for key in ("k", "v", "k_scale", "v_scale", "pos"):
        if key in trow:
            assert torch.equal(back[key], trow[key]), key


# --------------------------------------------------- allocator refcounts

def test_allocator_refcount_share_copy_free_ordering():
    """alloc at ref 1, incref adds owners, every owner calls plain free,
    the block returns to the free list only at ref 0 — in any order."""
    a = BlockAllocator(6)
    held = a.alloc(3)  # [0, 1, 2]
    assert [a.refcount(b) for b in held] == [1, 1, 1]
    a.incref(held[:2])  # a prefix-cache entry maps blocks 0, 1
    assert a.refcount(0) == 2 and a.refcount(2) == 1
    a.free(held)
    assert a.refcount(0) == 1 and a.refcount(2) == 0
    assert a.free_count == 4  # 2 shared blocks still out
    assert a.alloc(4) == [2, 3, 4, 5]
    a.incref([0])
    a.free([0, 1])
    assert a.refcount(0) == 1 and a.refcount(1) == 0
    a.free([0])
    assert a.refcount(0) == 0
    a.free([2, 3, 4, 5])
    assert a.free_count == 6


def test_allocator_refcount_typed_errors_preserved():
    """Double frees, out-of-range ids, in-call duplicates and increfs of
    free blocks raise the typed error BEFORE any mutation."""
    a = BlockAllocator(4)
    held = a.alloc(2)
    a.incref(held)
    a.free(held)
    a.free(held)  # second owner — legitimate
    with pytest.raises(BlockAllocatorError):
        a.free(held)  # third free of a ref-0 block = double-free
    with pytest.raises(BlockAllocatorError):
        a.incref([0])  # incref of a FREE block
    with pytest.raises(BlockAllocatorError):
        a.incref([9])
    b = a.alloc(1)
    with pytest.raises(BlockAllocatorError):
        a.free([b[0], b[0]])  # duplicates in one call
    assert a.refcount(b[0]) == 1  # rejected calls changed nothing
    assert isinstance(BlockAllocatorError("x"), ValueError)


# ------------------------------------------------------ the row format

@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("wire", ["bf16", "int8"])
@pytest.mark.parametrize("into", [None, "int8"], ids=["into-bf16",
                                                      "into-int8"])
def test_kv_row_format_round_trips_across_packages(quant, wire, into):
    """A row packed by either package (base64 wire) unpacks in the other
    to the same arrays; the port's base64 bodies are the reference's."""
    jrow, trow = _row(quant, 16, cursor=11)
    jdoc = jmig.pack_kv_row(jrow, 11, wire)
    tdoc = tmig.pack_kv_row(trow, 11, wire)
    assert {k: v for k, v in tdoc.items()} == jdoc
    want = jmig.unpack_kv_row(jdoc, full_width=24, quantize=into)
    for doc in (jdoc, tdoc):
        got = tmig.unpack_kv_row(doc, full_width=24, quantize=into)
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(_np(got[key]), _jnp(want[key]),
                                          key)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_in_process_bodies_round_trip(quant):
    """``b64=False`` keeps host numpy bodies (the engine's parking) that
    unpack to the same row as the base64 wire."""
    _, trow = _row(quant, 16, cursor=9)
    wire = "int8" if quant else "bf16"
    raw = tmig.pack_kv_row(trow, 9, wire, b64=False)
    assert isinstance(raw["k"], np.ndarray)
    a = tmig.unpack_kv_row(raw, 16, "int8" if quant else None)
    b = tmig.unpack_kv_row(tmig.pack_kv_row(trow, 9, wire), 16,
                           "int8" if quant else None)
    for key in a:
        assert torch.equal(a[key], b[key]), key
    assert int((a["pos"][0, 9:] == POS_SENTINEL).sum()) == 7


def test_logits_round_trip_across_packages():
    logits = np.random.default_rng(3).standard_normal(50).astype(np.float32)
    assert tmig.pack_logits(torch.from_numpy(logits)) == \
        jmig.pack_logits(logits)
    payload = {"logits": jmig.pack_logits(logits)}
    assert np.array_equal(tmig.unpack_logits(payload, 50).numpy(), logits)
    raw = {"logits": tmig.pack_logits(torch.from_numpy(logits), b64=False)}
    assert np.array_equal(tmig.unpack_logits(raw, 50).numpy(),
                          np.asarray(jmig.unpack_logits(
                              {"logits": jmig.pack_logits(logits)}, 50)))
    with pytest.raises(ValueError, match="elements"):
        tmig.unpack_logits(payload, 49)
