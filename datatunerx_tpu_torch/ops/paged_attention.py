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
  ``paged_record_positions`` and ``paged_kv_write`` update the pool tensors
  with ``index_put_`` and return them.
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
    assert deterministic reuse."""

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
                     device="cpu") -> Dict:
    """Block-pool KV cache. ``block_tables`` is ``[slots, blocks_per_slot]``
    int32 (-1 = unallocated); ``len`` is the per-slot linear write cursor;
    ``pos`` records each written token's rope position per (block, offset).
    Pools hold ``num_blocks + 1`` blocks: the last is the scratch target of
    invalid writes (see the module docstring)."""
    L = cfg.num_layers
    shape = (L, num_blocks + 1, block_size, cfg.num_kv_heads, cfg.head_dim)
    return {
        "len": torch.zeros((slots,), dtype=torch.int32, device=device),
        "pos": torch.full((num_blocks + 1, block_size), POS_SENTINEL,
                          dtype=torch.int32, device=device),
        "block_tables": torch.full((slots, blocks_per_slot), -1,
                                   dtype=torch.int32, device=device),
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


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


def paged_kv_write(ck, cv, tables, lens, k_w, v_w, targets=None):
    """Per-layer paged write WITHOUT the gathered read-back — the kernel
    path's half of ``paged_kv_update``: scatter the new tokens' K/V through
    the block tables into the pools ``ck``/``cv`` ``[NB+1, bs, KV, d]`` (in
    place) and return them; attention then reads the blocks in place."""
    if targets is None:
        targets = _write_targets(tables, lens, k_w.shape[1], ck.shape[1],
                                 ck.shape[0] - 1)
    ck.index_put_(targets, k_w.to(ck.dtype))
    cv.index_put_(targets, v_w.to(cv.dtype))
    return ck, cv


def paged_kv_update(ck, cv, tables, lens, k_w, v_w, targets=None):
    """Per-layer paged write + gathered read: the pools are updated in place
    and the gathered ``[B, W, KV, d]`` views attention reads are returned —
    element-identical to a dense row for every written lane, sentinel-masked
    elsewhere."""
    B = k_w.shape[0]
    ck, cv = paged_kv_write(ck, cv, tables, lens, k_w, v_w, targets)
    tbl = _gather_tables(tables)
    k_all = ck[tbl].reshape(B, -1, ck.shape[-2], ck.shape[-1])
    v_all = cv[tbl].reshape(B, -1, cv.shape[-2], cv.shape[-1])
    return ck, cv, k_all, v_all
