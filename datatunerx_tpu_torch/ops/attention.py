"""Attention ops and the paged KV-cache interface (the port of
``datatunerx_tpu/ops/attention.py``, paged branch).

Shapes: q [B, T, H, d]; k, v [B, S, KV, d] with H = KV * G (GQA).
Bias is additive, broadcastable to [B, 1, T, S]; softmax runs in f32.

The model writes and reads the cache through ``cache_positions_update`` /
``kv_cache_update``. This slice carries the paged block-pool cache only (a
cache dict with ``block_tables``); the dense layouts come with a later slice.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from datatunerx_tpu_torch.ops.paged_attention import (
    POS_SENTINEL,
    paged_kv_update,
    paged_kv_write,
    paged_record_positions,
    paged_view_width,
)


def softmax_scale(d: int) -> float:
    """The reference's scale arithmetic exactly: 1/sqrt(f32(d)) in f32 (a
    Python ``d ** -0.5`` double differs by one ulp for some head dims)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


def attention_allow(
    q_positions: torch.Tensor,  # [B, T] absolute positions of queries
    kv_positions: torch.Tensor,  # [B, S] absolute positions of keys
    kv_valid: Optional[torch.Tensor] = None,  # [B, S] bool — False for padding
) -> torch.Tensor:
    """The boolean attendability tensor [B, T, S] behind the causal bias.
    The paged multi-token kernel consumes this same tensor the gather path
    biases with, so mask parity between the two holds by construction."""
    ok = kv_positions[:, None, :] <= q_positions[:, :, None]  # causal
    if kv_valid is not None:
        ok = ok & kv_valid[:, None, :]
    return ok


def make_causal_bias(
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    kv_valid: Optional[torch.Tensor] = None,
    dtype=torch.float32,
) -> torch.Tensor:
    """Additive bias [B, 1, T, S]: 0 where attendable, finfo.min otherwise."""
    ok = attention_allow(q_positions, kv_positions, kv_valid)
    neg = torch.tensor(torch.finfo(dtype).min, dtype=dtype, device=ok.device)
    zero = torch.zeros((), dtype=dtype, device=ok.device)
    return torch.where(ok, zero, neg)[:, None, :, :]


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: torch.Tensor) -> torch.Tensor:
    """Reference attention: f32 scores and softmax, GQA via reshape, probs
    cast to ``v.dtype`` before the PV product (which accumulates in f32 and
    rounds once to ``v.dtype``). Returns [B, T, H, d]."""
    B, T, H, d = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.reshape(B, T, KV, G, d).to(torch.float32)
    logits = torch.einsum("btkgd,bskd->bkgts", qf, k.to(torch.float32))
    logits = logits * softmax_scale(d)
    bias4 = bias.to(torch.float32)  # [B, 1, T, S]
    logits = logits + bias4[:, :, None, :, :]
    probs = torch.softmax(logits, dim=-1)
    probs = probs.to(v.dtype).to(torch.float32)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v.to(torch.float32))
    return out.to(v.dtype).reshape(B, T, H, d)


def kv_cache_width(cache: dict) -> int:
    """Linear key width attention sees for one slot — the rope ``seq_len``."""
    return paged_view_width(cache)


def _require_paged(cache: dict):
    if "block_tables" not in cache:
        raise ValueError(
            "the dense KV cache is not ported yet (ROADMAP Queue 1, "
            "'dense cache'); pass a paged cache (init_paged_cache)")


def cache_positions_update(cache: dict, positions: torch.Tensor,
                           attention_mask, gather: bool = True,
                           targets=None):
    """Record the new tokens' rope positions at each slot's write cursor (in
    place in the pos pool). Returns ``(pos_pool, kv_positions)``; pads
    (attention_mask 0) get POS_SENTINEL so they are masked everywhere.
    ``gather=False`` (the decode kernel) skips the gathered view."""
    _require_paged(cache)
    pos_update = positions
    if attention_mask is not None:
        pos_update = torch.where(attention_mask.to(torch.bool), positions,
                                 torch.full_like(positions, POS_SENTINEL))
    return paged_record_positions(cache, pos_update, gather=gather,
                                  targets=targets)


def kv_cache_write_paged(cache: dict, ck, cv, k, v, targets=None):
    """Paged write WITHOUT the gathered read — the kernel path: scatter the
    new tokens through the block tables into one layer's pools (in place)."""
    return paged_kv_write(ck, cv, cache["block_tables"], cache["len"],
                          k.to(ck.dtype), v.to(cv.dtype), targets)


def kv_cache_update(cache: dict, ck, cv, k, v, targets=None):
    """One layer's cache write + full-width read: returns the pools (updated
    in place) and the ``[B, W, KV, d]`` views attention reads."""
    _require_paged(cache)
    ck, cv, k_all, v_all = paged_kv_update(
        ck, cv, cache["block_tables"], cache["len"],
        k.to(ck.dtype), v.to(cv.dtype), targets)
    return ck, cv, k_all.to(k.dtype), v_all.to(v.dtype)
