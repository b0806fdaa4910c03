"""Attention ops and the KV-cache interface (the port of
``datatunerx_tpu/ops/attention.py``).

Shapes: q [B, T, H, d]; k, v [B, S, KV, d] with H = KV * G (GQA).
Bias is additive, broadcastable to [B, 1, T, S]; softmax runs in f32.

The model writes and reads the cache through ``cache_write_targets`` /
``cache_positions_update`` / ``kv_cache_update``, over either layout: the
paged block pool (a cache dict with ``block_tables``,
``ops/paged_attention.py``) or the dense ``[L, B, S, KV, d]`` rows of
``models/llama.init_cache`` (scalar or per-slot cursors). Both hold bf16/f32
or, with ``k_scale``/``v_scale`` leaves, int8 K/V quantized per head vector on
write and dequantized on read.

Writes are in place (the JAX functions return new arrays). A dense write
past a row's end is dropped, as JAX's scatter drops it, without a
device-side assert and without a host sync: such a target is pointed at a
lane the step does not write and given that lane's own value back.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from datatunerx_tpu_torch.ops.paged_attention import (
    POS_SENTINEL,
    linear_targets,
    paged_kv_update,
    paged_kv_write,
    paged_record_positions,
    paged_view_width,
    write_targets,
)


def softmax_scale(d: int) -> float:
    """The reference's scale arithmetic exactly: 1/sqrt(f32(d)) in f32 (a
    Python ``d ** -0.5`` double differs by one ulp for some head dims)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))  # dtxlint: disable=DTX001 — host numpy scalar (d is a static shape), no device sync


def attention_allow(
    q_positions: torch.Tensor,  # [B, T] absolute positions of queries
    kv_positions: torch.Tensor,  # [B, S] absolute positions of keys
    kv_valid: Optional[torch.Tensor] = None,  # [B, S] bool — False for padding
    *,
    sliding_window: Optional[int] = None,
    q_segment_ids: Optional[torch.Tensor] = None,  # [B, T] packed sequences
    kv_segment_ids: Optional[torch.Tensor] = None,  # [B, S]
    window_mask: Optional[torch.Tensor] = None,  # [B, T, WN] bool
    window_start: Optional[torch.Tensor] = None,  # [B] window's first lane
) -> torch.Tensor:
    """The boolean attendability tensor [B, T, S] behind the causal bias.
    The paged multi-token kernel consumes this same tensor the gather path
    biases with, so mask parity between the two holds by construction.
    ``sliding_window`` keeps a key only when ``kv > q - window`` (Mistral);
    segment ids confine packed sequences to themselves.

    ``window_mask``/``window_start`` carve a WINDOW out of the key lanes:
    the ``WN`` linear lanes from ``window_start`` (a speculative verify or
    draft step's own writes). Inside it a lane must pass its mask column
    AND the causal check (tree siblings share a rope position, so
    causality alone cannot separate branches, and the causal check still
    masks unwritten sentinel lanes); outside it plain causal masking
    holds."""
    ok = kv_positions[:, None, :] <= q_positions[:, :, None]  # causal
    if sliding_window is not None:
        ok = ok & (kv_positions[:, None, :]
                   > q_positions[:, :, None] - sliding_window)
    if kv_valid is not None:
        ok = ok & kv_valid[:, None, :]
    if q_segment_ids is not None and kv_segment_ids is not None:
        ok = ok & (q_segment_ids[:, :, None] == kv_segment_ids[:, None, :])
    if window_mask is not None:
        B, T, WN = window_mask.shape
        S = kv_positions.shape[1]
        lane = torch.arange(S, dtype=torch.int64,
                            device=kv_positions.device)[None, :]
        w = lane - window_start.to(torch.int64)[:, None]  # [B, S]
        inside = (w >= 0) & (w < WN)
        wc = w.clamp(0, WN - 1)
        allowed = torch.gather(window_mask.to(torch.bool), 2,
                               wc[:, None, :].expand(B, T, S))
        ok = ok & (~inside[:, None, :] | allowed)
    return ok


def make_causal_bias(
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    kv_valid: Optional[torch.Tensor] = None,
    *,
    sliding_window: Optional[int] = None,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    window_mask: Optional[torch.Tensor] = None,
    window_start: Optional[torch.Tensor] = None,
    dtype=torch.float32,
) -> torch.Tensor:
    """Additive bias [B, 1, T, S]: 0 where attendable, finfo.min otherwise."""
    ok = attention_allow(q_positions, kv_positions, kv_valid,
                         sliding_window=sliding_window,
                         q_segment_ids=q_segment_ids,
                         kv_segment_ids=kv_segment_ids,
                         window_mask=window_mask, window_start=window_start)
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


def ring_active(mesh, axis: str = "sp") -> bool:
    """A sequence-parallel axis above 1 is active (the ring's condition)."""
    return mesh is not None and mesh.shape.get(axis, 1) > 1


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: Optional[torch.Tensor], *, impl: str = "xla",
              segment_ids: Optional[torch.Tensor] = None,
              mesh=None) -> torch.Tensor:
    """Dispatch on ``cfg.attention_impl``: ``xla`` is the biased reference
    path, ``flash`` the K1-K3 kernels (causal and segments in-kernel, the
    bias unused), ``ring`` the sequence-parallel ring over ``mesh``'s sp
    axis (``ops/ring_attention.py``; q/k/v are this rank's chunk) when
    that axis is above 1, else the plain biased attention, which is exact
    there (the model then hands the causal bias)."""
    if impl == "xla":
        return xla_attention(q, k, v, bias)
    if impl == "flash":
        from datatunerx_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, bias, segment_ids=segment_ids)
    if impl == "ring":
        if not ring_active(mesh):
            return xla_attention(q, k, v, bias)
        from datatunerx_tpu_torch.ops.ring_attention import (
            ring_attention_local,
        )

        return ring_attention_local(q, k, v, mesh)
    raise ValueError(f"unknown attention impl {impl!r}")


# ------------------------------------------------------- KV cache interface
def kv_quantize(x: torch.Tensor):
    """[..., head_dim] → (int8 values, per-vector f32 scale), bit for bit
    the reference's: ``scale = max|x| / 127`` in f32, values
    ``round(x / max(scale, 1e-8))`` half-to-even, clipped to ±127."""
    xf = x.to(torch.float32)
    scale = xf.abs().amax(dim=-1) / 127.0
    safe = scale.clamp(min=1e-8)
    q = torch.round(xf / safe[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def kv_dequantize(q: torch.Tensor, scale: torch.Tensor, dtype):
    """The f32 product ``q * scale``, rounded once to ``dtype``."""
    return (q.to(torch.float32) * scale[..., None]).to(dtype)


def kv_cache_width(cache: dict) -> int:
    """Linear key width attention sees for one slot — the rope ``seq_len``."""
    if "block_tables" in cache:
        return paged_view_width(cache)
    return cache["k"].shape[2]


def _dense_targets(cache: dict, T: int):
    """``(rows, lanes, valid)`` of the next ``T`` lanes of each dense row.

    Scalar cursor: one window for every row, its start clamped so that the
    window fits (``dynamic_update_slice``'s rule); ``rows``/``valid`` are
    None. Per-slot cursors: lane ``len[b] + t``; a lane past the row's end is
    invalid and points ``T`` lanes back instead, at a lane this step writes
    nowhere else, which ``_dense_put`` hands its own value."""
    S = cache["k"].shape[2]
    if T > S:
        raise ValueError(f"{T} new tokens do not fit a cache row of {S}")
    start = cache["len"].to(torch.int64)
    steps = torch.arange(T, dtype=torch.int64, device=start.device)
    if start.dim() == 0:
        return None, start.clamp(0, S - T) + steps, None
    idx = start[:, None] + steps[None, :]  # [B, T]
    valid = idx < S
    lanes = torch.where(valid, idx, idx - T).clamp(0, S - 1)
    rows = torch.arange(idx.shape[0], dtype=torch.int64,
                        device=start.device)[:, None]
    return rows, lanes, valid


def _dense_put(buf: torch.Tensor, targets, new: torch.Tensor):
    """Write ``new [B, T, ...]`` into ``buf [B, S, ...]`` at ``targets``, in
    place; invalid targets keep what the buffer holds."""
    rows, lanes, valid = targets
    new = new.to(buf.dtype)
    if rows is None:
        buf.index_copy_(1, lanes, new)
        return buf
    keep = valid.reshape(valid.shape + (1,) * (new.dim() - 2))
    buf.index_put_((rows, lanes), torch.where(keep, new, buf[rows, lanes]))
    return buf


def cache_write_targets(cache: dict, T: int):
    """Where the next ``T`` tokens of each slot land — the same for the
    position table and every layer's K/V (and scales), so a forward computes
    it once and hands it to the calls below."""
    if "block_tables" in cache:
        return write_targets(cache, T)
    return _dense_targets(cache, T)


def cache_positions_update(cache: dict, positions: torch.Tensor,
                           attention_mask, gather: bool = True,
                           targets=None):
    """Record the new tokens' rope positions at each slot's write cursor (in
    place). Returns ``(pos_state, kv_positions)``: the dense ``[B, S]`` table
    or the paged pos pool, and the per-slot linear view ``[B, W]`` the causal
    check masks against; pads (attention_mask 0) get POS_SENTINEL so they are
    masked everywhere. ``gather=False`` (the paged decode kernel) skips the
    gathered view."""
    pos_update = positions
    if attention_mask is not None:
        pos_update = torch.where(attention_mask.to(torch.bool), positions,
                                 torch.full_like(positions, POS_SENTINEL))
    if "block_tables" in cache:
        return paged_record_positions(cache, pos_update, gather=gather,
                                      targets=targets)
    if targets is None:
        targets = _dense_targets(cache, positions.shape[1])
    cache_pos = _dense_put(cache["pos"], targets, pos_update)
    return cache_pos, cache_pos


def _quantize_new(cks, k, v, ck, cv):
    """The new tokens as the cache stores them: int8 + scales for an int8
    cache, else cast to the cache's dtype. K and V are quantized in one
    stacked call (each head vector has its own scale, so stacking changes
    no bit): the decode step is bound by the count of small launches."""
    if cks is not None:
        q, scale = kv_quantize(torch.stack((k, v)))
        return q[0], q[1], scale[0], scale[1]
    return k.to(ck.dtype), v.to(cv.dtype), None, None


def kv_cache_write_paged(cache: dict, ck, cv, cks, cvs, k, v, targets=None):
    """Paged write WITHOUT the gathered read — the kernel path: quantize the
    new tokens exactly as ``kv_cache_update`` would and scatter them through
    the block tables into one layer's pools (in place)."""
    k_w, v_w, ks_w, vs_w = _quantize_new(cks, k, v, ck, cv)
    return paged_kv_write(ck, cv, cks, cvs, cache["block_tables"],
                          cache["len"], k_w, v_w, ks_w, vs_w, targets)


def kv_cache_update(cache: dict, ck, cv, cks, cvs, k, v, targets=None):
    """One layer's cache write + full-width read. ``ck``/``cv`` (and the int8
    scale leaves ``cks``/``cvs``, else None) are one layer's cache leaves,
    updated in place; returns them plus the ``[B, W, KV, d]`` views attention
    reads, dequantized when the cache is int8."""
    k_w, v_w, ks_w, vs_w = _quantize_new(cks, k, v, ck, cv)
    if "block_tables" in cache:
        ck, cv, cks, cvs, k_all, v_all, ks_all, vs_all = paged_kv_update(
            ck, cv, cks, cvs, cache["block_tables"], cache["len"],
            k_w, v_w, ks_w, vs_w, targets)
    else:
        if targets is None:
            targets = _dense_targets(cache, k.shape[1])
        for buf, new in ((ck, k_w), (cv, v_w), (cks, ks_w), (cvs, vs_w)):
            if buf is not None:
                _dense_put(buf, targets, new)
        k_all, v_all, ks_all, vs_all = ck, cv, cks, cvs
    if cks is not None:
        return (ck, cv, cks, cvs, kv_dequantize(k_all, ks_all, k.dtype),
                kv_dequantize(v_all, vs_all, v.dtype))
    return ck, cv, cks, cvs, k_all.to(k.dtype), v_all.to(v.dtype)


def compact_window(cache: dict, participate: torch.Tensor,
                   len0: torch.Tensor, src_cols: torch.Tensor,
                   keep: torch.Tensor, pos0: torch.Tensor, width: int):
    """Collapse a tree-verify window back into chain-invariant lanes, in
    place, on either cache layout (the reference's ``compact_window``).

    A tree step writes ``width`` lanes a row from the pre-step cursor
    ``len0``: column 0 the pending token, then the flattened tree nodes,
    siblings sharing a rope position. Only the accepted root-to-leaf path
    may survive (a stale sibling would pass any later read's causal
    check): its K/V (and int8 scales) move to the contiguous lanes
    ``len0+1 … len0+keep``, and every window lane's position becomes
    ``pos0+i`` where kept, POS_SENTINEL elsewhere. ``src_cols [B, D]`` is
    the window column of the path's depth-(i+1) node, ``keep [B]`` the
    accepted length, ``pos0 [B]`` the pending token's position; rows with
    ``participate`` False are untouched. ``len`` is not advanced here.

    Depths move in increasing order: depth i's destination lane
    ``len0+i+1`` lies below every later depth's source column (a column
    of depth j sits at ``len0+j`` or beyond), so no source is overwritten
    before it is read."""
    B, D = src_cols.shape
    dev = len0.device
    len0 = len0.to(torch.int64)
    keep = keep.to(torch.int64)
    src_cols = src_cols.to(torch.int64)
    part = participate.to(torch.bool)
    rows = torch.arange(B, dtype=torch.int64, device=dev)
    kv_keys = [k for k in ("k", "v", "k_scale", "v_scale") if k in cache]
    paged = "block_tables" in cache
    if paged:
        num_blocks = cache["pos"].shape[0] - 1
        bs = cache["pos"].shape[1]
        tables = cache["block_tables"]

        def phys(lin, valid):
            return linear_targets(tables, lin, bs, num_blocks, valid)
    W = None if paged else cache["pos"].shape[1]
    for i in range(D):
        move = part & (keep >= i + 1)
        src = len0 + src_cols[:, i]
        dst = len0 + i + 1
        if paged:
            sp, so = phys(src[:, None], move[:, None])
            dp, do = phys(dst[:, None], move[:, None])
            sp = sp.clamp(max=num_blocks)
            for key in kv_keys:
                leaf = cache[key]
                leaf[:, dp[:, 0], do[:, 0]] = leaf[:, sp[:, 0], so[:, 0]]
        else:
            src_c, dst_c = src.clamp(0, W - 1), dst.clamp(0, W - 1)
            for key in kv_keys:
                leaf = cache[key]
                vals = leaf[:, rows, src_c]
                cur = leaf[:, rows, dst_c]
                m = move.view((1, B) + (1,) * (vals.dim() - 2))
                leaf[:, rows, dst_c] = torch.where(m, vals, cur)
    lane = torch.arange(width, dtype=torch.int64, device=dev)[None, :]
    lane_lin = len0[:, None] + lane
    vals = torch.where(lane <= keep[:, None], pos0.to(torch.int64)[:, None]
                       + lane, torch.full_like(lane_lin, POS_SENTINEL))
    pos = cache["pos"]
    if paged:
        lp, lo = phys(lane_lin, part[:, None].expand(B, width))
        pos[lp, lo] = vals.to(pos.dtype)
    else:
        for j in range(width):
            lin = lane_lin[:, j]
            ok = part & (lin < W)
            lin_c = lin.clamp(0, W - 1)
            pos[rows, lin_c] = torch.where(ok, vals[:, j].to(pos.dtype),
                                           pos[rows, lin_c])
    return cache
