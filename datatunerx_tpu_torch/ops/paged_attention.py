"""Paged KV cache: block pool + per-slot block tables (the port of
``datatunerx_tpu/ops/paged_attention.py``; vLLM PagedAttention, Sarathi
chunked prefill).

The cache is a POOL of fixed-size blocks (``block_size`` tokens each, shaped
``[L, num_blocks + 1, block_size, KV, d]``) plus a per-slot block table that
maps linear cache positions to physical blocks. Admission reserves
``ceil((prompt + max_new) / block_size)`` blocks from a host-side free list.

Reads go through a GATHER over the block table (the gather path, which is the
kernels' parity oracle) or through the in-place kernels of
``ops/cuda_paged_attention.py``. Unallocated table entries (-1) gather block
0's values, but their rope positions are forced to ``POS_SENTINEL``, which the
causal check masks.

Two differences from the JAX functions, both deliberate:

- **Writes are in place.** The JAX programs return new pools; here
  ``paged_record_positions``, ``paged_kv_write``, ``paged_insert_row`` and
  ``paged_copy_block`` update the pool tensors and return them.
- **Invalid targets land in a scratch block.** JAX drops a scatter to the
  out-of-range index ``num_blocks``; in torch that index is a device-side
  assert on CUDA. The pool therefore holds one block more than the allocator
  hands out, and every invalid target (slot exhausted, table entry -1) is
  routed to that last block, ``num_blocks``. No table ever names it, so no
  read sees what lands there, and the masking needs no host-synchronising
  boolean index.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import torch

# Marks invalid/pad cache slots: the causal check kv_pos <= q_pos then masks
# them with no separate validity plumbing.
POS_SENTINEL = 2**30


class BlockAllocatorError(ValueError):
    """A ``free()`` that would corrupt the free list: out-of-range block id,
    double-free of an already-free block, or duplicate ids in one call.
    Raised BEFORE any mutation — a rejected free changes nothing."""


class BlockAllocator:
    """Host-side refcounted free-list over the physical block pool.

    The scheduler thread is the only allocator writer, but gauges read
    ``free_count`` from HTTP threads — hence the lock. Blocks are handed out
    lowest-id-first and returned to the head of the free list, so tests can
    assert deterministic reuse.

    Refcounts are the copy-on-write substrate: ``alloc`` hands blocks out at
    refcount 1, ``incref`` adds an owner, and ``free`` drops one; a block
    returns to the free list only when its last owner lets go."""

    def __init__(self, num_blocks: int):
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks))
        self._ref = [0] * num_blocks  # 0 = on the free list
        self._lock = threading.Lock()

    @property
    def free_count(self) -> int:
        with self._lock:
            return len(self._free)

    def refcount(self, block: int) -> int:
        """Owners of one block (0 = free)."""
        with self._lock:
            return self._ref[int(block)]

    def alloc(self, n: int) -> Optional[List[int]]:
        """Reserve ``n`` blocks at refcount 1; None (and no change) when the
        pool can't cover the request — the caller keeps the request queued."""
        if n <= 0:
            return []
        with self._lock:
            if n > len(self._free):
                return None
            out, self._free = self._free[:n], self._free[n:]
            for b in out:
                self._ref[b] = 1
            return out

    def _validate(self, blocks: List[int], op: str) -> List[int]:
        ids = [int(b) for b in blocks]
        bad = [b for b in ids if not 0 <= b < self.num_blocks]
        if bad:
            raise BlockAllocatorError(
                f"{op} of out-of-range block id(s) {bad} "
                f"(pool has {self.num_blocks} blocks)")
        if len(set(ids)) != len(ids):
            dupes = sorted({b for b in ids if ids.count(b) > 1})
            raise BlockAllocatorError(
                f"{op} lists block id(s) {dupes} more than once")
        return ids

    def incref(self, blocks: List[int]):
        """Add one owner to each LIVE block (copy-on-write sharing: a slot's
        table or a prefix-cache entry mapping blocks it did not allocate).
        An incref of a free block is rejected before any mutation, like a
        double free."""
        if not blocks:
            return
        with self._lock:
            ids = self._validate(blocks, "incref()")
            dead = sorted(b for b in ids if self._ref[b] == 0)
            if dead:
                raise BlockAllocatorError(
                    f"incref() of free block id(s) {dead}: a shared "
                    "mapping must target live blocks")
            for b in ids:
                self._ref[b] += 1

    def free(self, blocks: List[int]):
        """Drop one owner per block; blocks whose last owner left return to
        the free list. Rejected (typed, pre-mutation) on out-of-range ids,
        duplicates in one call, and frees of already-free blocks."""
        if not blocks:
            return
        with self._lock:
            ids = self._validate(blocks, "free()")
            double = sorted(b for b in ids if self._ref[b] == 0)
            if double:
                raise BlockAllocatorError(
                    f"double-free of block id(s) {double}: already on the "
                    "free list")
            released = []
            for b in ids:
                self._ref[b] -= 1
                if self._ref[b] == 0:
                    released.append(b)
            if released:
                self._free = sorted(released) + self._free


def blocks_for_depth(depth: int, block_size: int, overshoot: int = 0,
                     cap_depth: Optional[int] = None) -> int:
    """Blocks a slot must reserve to hold ``depth`` tokens of KV plus
    ``overshoot`` scratch tokens, capped at ``cap_depth`` tokens."""
    total = depth + max(0, overshoot)
    if cap_depth is not None:
        total = min(total, cap_depth)
    return -(-total // block_size)


def init_paged_cache(cfg, slots: int, num_blocks: int, block_size: int,
                     blocks_per_slot: int, dtype=torch.bfloat16,
                     quantize: Optional[str] = None, device="cpu") -> Dict:
    """Block-pool KV cache. ``block_tables`` is ``[slots, blocks_per_slot]``
    int32 (-1 = unallocated); ``len`` is the per-slot linear write cursor;
    ``pos`` records each written token's rope position per (block, offset).
    Pools hold ``num_blocks + 1`` blocks: the last is the scratch target of
    invalid writes (see the module docstring). ``quantize="int8"`` stores K/V
    as int8 with f32 ``k_scale``/``v_scale`` pools, one scale per (token, KV
    head); the scale pools carry the scratch block too."""
    L = cfg.num_layers
    shape = (L, num_blocks + 1, block_size, cfg.num_kv_heads, cfg.head_dim)
    cache = {
        "len": torch.zeros((slots,), dtype=torch.int32, device=device),
        "pos": torch.full((num_blocks + 1, block_size), POS_SENTINEL,
                          dtype=torch.int32, device=device),
        "block_tables": torch.full((slots, blocks_per_slot), -1,
                                   dtype=torch.int32, device=device),
    }
    if quantize == "int8":
        dtype = torch.int8
        for name in ("k_scale", "v_scale"):
            cache[name] = torch.zeros(shape[:-1], dtype=torch.float32,
                                      device=device)
    elif quantize:
        raise ValueError(f"unsupported cache quantization {quantize!r}")
    cache["k"] = torch.zeros(shape, dtype=dtype, device=device)
    cache["v"] = torch.zeros(shape, dtype=dtype, device=device)
    return cache


def num_pool_blocks(pos_pool: torch.Tensor) -> int:
    """Blocks a table may name: the pool minus its scratch block."""
    return pos_pool.shape[0] - 1


def paged_view_width(cache: Dict) -> int:
    """Linear width of the gathered per-slot view (= dense-row equivalent)."""
    return cache["block_tables"].shape[1] * cache["k"].shape[2]


def _write_targets(tables: torch.Tensor, lens: torch.Tensor, T: int,
                   block_size: int, num_blocks: int):
    """Physical (block, offset) for the next ``T`` linear positions of each
    slot. Invalid targets (slot exhausted, table entry -1) get physical index
    ``num_blocks`` — the pool's scratch block."""
    idx = lens.to(torch.int64)[:, None] + torch.arange(
        T, dtype=torch.int64, device=lens.device)[None, :]  # [B, T]
    blk, off = idx // block_size, idx % block_size
    nbps = tables.shape[1]
    tbl = torch.gather(tables.to(torch.int64), 1, blk.clamp(0, nbps - 1))
    phys = torch.where((blk < nbps) & (tbl >= 0), tbl,
                       torch.full_like(tbl, num_blocks))
    return phys, off


def linear_targets(tables: torch.Tensor, lin: torch.Tensor, block_size: int,
                   num_blocks: int, valid: torch.Tensor):
    """Physical (block, offset) of ARBITRARY linear lanes ``lin [B, N]``
    (the reference's ``paged_linear_targets``: tree-window compaction moves
    lanes that are not one cursor-contiguous run). Lanes with ``valid``
    False, past the table or backed by no block get ``num_blocks``, the
    pool's scratch block."""
    blk, off = lin // block_size, lin % block_size
    nbps = tables.shape[1]
    tbl = torch.gather(tables.to(torch.int64), 1, blk.clamp(0, nbps - 1))
    ok = valid & (blk >= 0) & (blk < nbps) & (tbl >= 0)
    return torch.where(ok, tbl, torch.full_like(tbl, num_blocks)), off


def write_targets(cache: Dict, T: int):
    """Physical ``(block, offset)`` of each slot's next ``T`` cache lanes —
    the same for the pos pool and every layer's K/V pools, so a forward
    computes them once."""
    pool = cache["pos"]
    return _write_targets(cache["block_tables"], cache["len"], T,
                          pool.shape[1], num_pool_blocks(pool))


def _gather_tables(tables: torch.Tensor) -> torch.Tensor:
    """Table with -1 entries clamped to block 0 (the garbage a gather reads
    there is masked via sentinel positions)."""
    return torch.where(tables >= 0, tables, torch.zeros_like(tables)).long()


def paged_record_positions(cache: Dict, pos_update: torch.Tensor,
                           gather: bool = True, targets=None):
    """Scatter the new tokens' rope positions through the block tables INTO
    ``cache["pos"]`` (in place) and return ``(pos_pool, kv_positions
    [B, W])`` — the gathered linear position view the causal check masks
    against. Lanes backed by no block read as POS_SENTINEL.

    ``gather=False`` (the decode kernel path) skips the gathered view — the
    kernel masks against the pos POOL through the block table in place —
    and returns ``(pos_pool, None)``. ``targets`` are ``write_targets``'
    result when the caller already has them."""
    tables, pool = cache["block_tables"], cache["pos"]
    if targets is None:
        targets = write_targets(cache, pos_update.shape[1])
    pool.index_put_(targets, pos_update.to(pool.dtype))
    if not gather:
        return pool, None
    gathered = pool[_gather_tables(tables)]  # [B, nbps, bs]
    gathered = torch.where((tables >= 0)[:, :, None], gathered,
                           torch.full_like(gathered, POS_SENTINEL))
    return pool, gathered.reshape(tables.shape[0], -1)


def paged_kv_write(ck, cv, cks, cvs, tables, lens, k_w, v_w, ks_w, vs_w,
                   targets=None):
    """Per-layer paged write WITHOUT the gathered read-back — the kernel
    path's half of ``paged_kv_update``: scatter the new tokens' K/V (and, for
    int8 pools, their scales ``ks_w``/``vs_w`` into the scale pools
    ``cks``/``cvs``) through the block tables into the pools ``ck``/``cv``
    ``[NB+1, bs, KV, d]`` (in place) and return the pools; attention then
    reads the blocks in place."""
    if targets is None:
        targets = _write_targets(tables, lens, k_w.shape[1], ck.shape[1],
                                 ck.shape[0] - 1)
    ck.index_put_(targets, k_w.to(ck.dtype))
    cv.index_put_(targets, v_w.to(cv.dtype))
    if cks is not None:
        cks.index_put_(targets, ks_w.to(cks.dtype))
        cvs.index_put_(targets, vs_w.to(cvs.dtype))
    return ck, cv, cks, cvs


def paged_kv_update(ck, cv, cks, cvs, tables, lens, k_w, v_w, ks_w, vs_w,
                    targets=None):
    """Per-layer paged write + gathered read: the pools are updated in place
    and returned with the gathered ``[B, W, KV, d]`` views attention reads
    (and the gathered ``[B, W, KV]`` scales of int8 pools, else None) —
    element-identical to a dense row for every written lane, sentinel-masked
    elsewhere."""
    B = k_w.shape[0]
    ck, cv, cks, cvs = paged_kv_write(ck, cv, cks, cvs, tables, lens,
                                      k_w, v_w, ks_w, vs_w, targets)
    tbl = _gather_tables(tables)
    k_all = ck[tbl].reshape(B, -1, ck.shape[-2], ck.shape[-1])
    v_all = cv[tbl].reshape(B, -1, cv.shape[-2], cv.shape[-1])
    ks_all = vs_all = None
    if cks is not None:
        ks_all = cks[tbl].reshape(B, -1, cks.shape[-1])
        vs_all = cvs[tbl].reshape(B, -1, cvs.shape[-1])
    return ck, cv, cks, cvs, k_all, v_all, ks_all, vs_all


# --------------------------------------------------------- row import/export
def _row_targets(table_row: torch.Tensor, width: int, block_size: int,
                 num_blocks: int):
    """Physical (block, offset) of a slot's first ``width`` linear lanes;
    lanes past the table or backed by no block get ``num_blocks``, the
    pool's scratch block."""
    idx = torch.arange(width, dtype=torch.int64, device=table_row.device)
    blk, off = idx // block_size, idx % block_size
    nbps = table_row.shape[0]
    tbl = table_row.to(torch.int64)[blk.clamp(0, nbps - 1)]
    phys = torch.where((blk < nbps) & (tbl >= 0), tbl,
                       torch.full_like(tbl, num_blocks))
    return phys, off


def paged_insert_row(cache: Dict, slot: int, table_row: torch.Tensor,
                     row_cache: Dict) -> Dict:
    """Scatter a dense single-row cache (``k [L, 1, W, KV, d]``, a prefill,
    prefix-cache or parked-session row) into the slot's blocks and install
    its table, in place. Lanes past the row's cursor are POS_SENTINEL in
    the row already, so writing the full width doubles as the block scrub;
    lanes past the slot's allocation land in the scratch block."""
    pos = cache["pos"]
    W = row_cache["k"].shape[2]
    phys, off = _row_targets(table_row, W, pos.shape[1], num_pool_blocks(pos))
    cache["block_tables"][slot] = table_row.to(cache["block_tables"].dtype)
    for key in ("k", "v", "k_scale", "v_scale"):
        if key in cache:
            cache[key][:, phys, off] = row_cache[key][:, 0].to(
                cache[key].dtype)
    pos[phys, off] = row_cache["pos"][0].to(pos.dtype)
    return cache


def row_trim(row: Dict, width: int) -> Dict:
    """A dense single-row cache's first ``width`` linear lanes (views; the
    live prefix a parked session keeps)."""
    width = min(width, row["k"].shape[2])
    out: Dict = {"len": row.get("len")}
    for key in ("k", "v", "k_scale", "v_scale"):
        if key in row:
            out[key] = row[key][:, :, :width]
    out["pos"] = row["pos"][:, :width]
    return out


def paged_copy_block(cache: Dict, src: int, dst: int, keep: int) -> Dict:
    """Copy one physical block (K/V pools, int8 scale pools, pos row) onto
    another, in place — the copy-on-write primitive. Position lanes at
    offset >= ``keep`` are scrubbed to POS_SENTINEL in the destination, so
    a copied partial tail block never shows the source's later tokens to
    its new owner."""
    for key in ("k", "v", "k_scale", "v_scale"):
        if key in cache:
            cache[key][:, dst] = cache[key][:, src]
    pos = cache["pos"]
    lanes = torch.arange(pos.shape[1], device=pos.device)
    pos[dst] = torch.where(lanes < keep, pos[src],
                           torch.full_like(pos[src], POS_SENTINEL))
    return cache


def paged_extract_row(cache: Dict, slot: int, cursor: int, *,
                      width: Optional[int] = None) -> Dict:
    """Gather a slot's blocks back into a new dense single-row cache (the
    prefix-cache and parked-session row format), the inverse of
    ``paged_insert_row``; ``cursor`` becomes the row's write cursor.
    ``width`` trims the gather to the first ``ceil(width / block_size)``
    blocks (default: the whole table)."""
    tables = cache["block_tables"]
    nbps_total, block_size = tables.shape[1], cache["k"].shape[2]
    nbps = nbps_total if width is None else max(
        1, min(nbps_total, -(-int(width) // block_size)))
    table_row = tables[slot, :nbps]
    tbl = _gather_tables(table_row)
    L, KV, d = cache["k"].shape[0], cache["k"].shape[-2], cache["k"].shape[-1]
    W = nbps * block_size
    row: Dict = {
        "k": cache["k"][:, tbl].reshape(L, 1, W, KV, d),
        "v": cache["v"][:, tbl].reshape(L, 1, W, KV, d),
        "len": torch.tensor(int(cursor), dtype=torch.int32,
                            device=tables.device),
    }
    if "k_scale" in cache:
        row["k_scale"] = cache["k_scale"][:, tbl].reshape(L, 1, W, KV)
        row["v_scale"] = cache["v_scale"][:, tbl].reshape(L, 1, W, KV)
    pos = cache["pos"][tbl]  # [nbps, bs]
    pos = torch.where((table_row >= 0)[:, None], pos,
                      torch.full_like(pos, POS_SENTINEL))
    row["pos"] = pos.reshape(1, W)
    return row
