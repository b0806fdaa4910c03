"""Flash attention (causal or full, GQA, packed segments) with a flash
backward pass: the port of ``datatunerx_tpu/ops/flash_attention.py``.

The [T, S] score matrix never exists in device memory in either direction.
The forward (K1) stores only the per-row logsumexp; the backward recomputes
the probabilities tile by tile (FlashAttention-2: K2 accumulates dQ over key
tiles, K3 accumulates dK/dV over query tiles, with D = rowsum(dO * O)
computed outside the kernels, as the reference does).

K1, K2 and K3 are hand-written CUDA in ``csrc/flash_attention.cu`` (bf16
on tensor cores, f32 on CUDA cores); the design note there says what bounds
them. Each wrapper launches its kernel
for CUDA tensors (or raises) and runs the kernel's plain PyTorch version,
which repeats the reference's tile walk (``block_q`` x ``block_k`` tiles,
online softmax, causal tile skip), only for CPU tensors. The CUDA kernels
pick their own tiles (64 rows) whatever ``block_q``/``block_k`` say.

Masking is in-kernel: causal by index (``causal=False`` for the ring's past
chunks), plus packed-segment isolation by per-row ids (all-equal ids are
plain causal, so right-padded unpacked batches are exact). The layout at the
public function is the reference's: q [B, T, H, d], k/v [B, S, KV, d]; lse
and D are [B*H, T] float32.

``flash_fwd.launches``, ``flash_bwd_dq.launches`` and
``flash_bwd_dkv.launches`` count kernel launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from datatunerx_tpu_torch.ops import _build
from datatunerx_tpu_torch.ops.attention import softmax_scale

NEG_INF = -1e30  # finite: exp(NEG_INF - NEG_INF) must not arise as inf - inf
_KERNEL_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}
_KERNEL_HEAD_DIMS = (16, 32, 64, 128)


def _pick_block(n: int, cap: int = 512) -> int:
    """Largest power-of-two divisor of n, capped (the reference's tiles)."""
    b = 1
    while b < cap and n % (b * 2) == 0:
        b *= 2
    return min(b, cap)


# ------------------------------------------------------------------- plain
def _fold(q, k, v):
    """f32 views for the plain versions: q [B, KV, G, T, d], k/v
    [B, KV, S, d]."""
    B, T, H, d = q.shape
    KV = k.shape[2]
    qf = q.float().reshape(B, T, KV, H // KV, d).permute(0, 2, 3, 1, 4)
    return qf, k.float().permute(0, 2, 1, 3), v.float().permute(0, 2, 1, 3)


def _tile_mask(seg, causal, i0, i1, j0, j1, device):
    """[B|1, 1, 1, bq, bk] bool: which (query, key) pairs of a tile attend."""
    qp = torch.arange(i0, i1, device=device)[:, None]
    kp = torch.arange(j0, j1, device=device)[None, :]
    ok = ((kp <= qp) | (not causal))[None, None, None]
    if seg is not None:
        same = seg[:, i0:i1, None] == seg[:, None, j0:j1]  # [B, bq, bk]
        ok = ok & same[:, None, None]
    return ok


def _tiles(n: int, block: int):
    return [(s, min(s + block, n)) for s in range(0, n, block)]


def _skip(causal, i0, i1, j0):
    """The reference's causal tile skip: a key tile wholly in the future."""
    return causal and j0 > i1 - 1


def _plain_fwd(q, k, v, seg, causal, block_q, block_k):
    """K1's plain version: the online softmax over key tiles, per query
    tile. Returns (out [B, T, H, d] in q.dtype, lse [B*H, T] f32)."""
    B, T, H, d = q.shape
    S = k.shape[1]
    scale = softmax_scale(d)
    qf, kf, vf = _fold(q, k, v)
    out = torch.empty_like(qf)
    lse = torch.empty(qf.shape[:-1], dtype=torch.float32, device=q.device)
    for i0, i1 in _tiles(T, block_q):
        qt = qf[..., i0:i1, :]
        m = torch.full(qt.shape[:-1], NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qt)
        for j0, j1 in _tiles(S, block_k):
            if _skip(causal, i0, i1, j0):
                continue
            s = torch.einsum("bkgtd,bksd->bkgts", qt, kf[:, :, j0:j1]) * scale
            ok = _tile_mask(seg, causal, i0, i1, j0, j1, q.device)
            s = torch.where(ok, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.where(ok, torch.exp(s - m_new[..., None]),
                            torch.zeros_like(s))
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgts,bksd->bkgtd", p, vf[:, :, j0:j1])
            m = m_new
        lc = l.clamp(min=1e-30)
        out[..., i0:i1, :] = acc / lc[..., None]
        lse[..., i0:i1] = m + torch.log(lc)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, T, H, d).to(q.dtype)
    return out, lse.reshape(B * H, T)


def _plain_probs(qt, kt, lse_t, seg, causal, i0, i1, j0, j1, scale):
    """P of one tile, recomputed from the lse; masked lanes are 0."""
    s = torch.einsum("bkgtd,bksd->bkgts", qt, kt) * scale
    ok = _tile_mask(seg, causal, i0, i1, j0, j1, qt.device)
    return torch.where(ok, torch.exp(s - lse_t[..., None]), torch.zeros_like(s))


def _bwd_views(q, k, v, do, lse, dsum):
    B, T, H, d = q.shape
    KV = k.shape[2]
    qf, kf, vf = _fold(q, k, v)
    dof, _, _ = _fold(do, k, v)
    G = H // KV
    return (qf, kf, vf, dof, lse.reshape(B, KV, G, T),
            dsum.reshape(B, KV, G, T))


def _plain_bwd_dq(q, k, v, do, lse, dsum, seg, causal, block_q, block_k):
    """K2's plain version: dQ [B, T, H, d] in q.dtype."""
    B, T, H, d = q.shape
    S = k.shape[1]
    scale = softmax_scale(d)
    qf, kf, vf, dof, lse4, ds4 = _bwd_views(q, k, v, do, lse, dsum)
    dq = torch.zeros_like(qf)
    for i0, i1 in _tiles(T, block_q):
        for j0, j1 in _tiles(S, block_k):
            if _skip(causal, i0, i1, j0):
                continue
            kt = kf[:, :, j0:j1]
            p = _plain_probs(qf[..., i0:i1, :], kt, lse4[..., i0:i1], seg,
                             causal, i0, i1, j0, j1, scale)
            dp = torch.einsum("bkgtd,bksd->bkgts", dof[..., i0:i1, :],
                              vf[:, :, j0:j1])
            ds = p * (dp - ds4[..., i0:i1, None]) * scale
            dq[..., i0:i1, :] += torch.einsum("bkgts,bksd->bkgtd", ds, kt)
    return dq.permute(0, 3, 1, 2, 4).reshape(B, T, H, d).to(q.dtype)


def _plain_bwd_dkv(q, k, v, do, lse, dsum, seg, causal, block_q, block_k):
    """K3's plain version: (dK, dV) [B, S, KV, d] in k's/v's dtype. The
    G query heads of a KV group are summed in f32 before the one rounding,
    as K3 does (the reference rounds per head, then group-sums)."""
    T = q.shape[1]
    S = k.shape[1]
    scale = softmax_scale(q.shape[-1])
    qf, kf, vf, dof, lse4, ds4 = _bwd_views(q, k, v, do, lse, dsum)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for j0, j1 in _tiles(S, block_k):
        for i0, i1 in _tiles(T, block_q):
            if _skip(causal, i0, i1, j0):
                continue
            qt, dot = qf[..., i0:i1, :], dof[..., i0:i1, :]
            p = _plain_probs(qt, kf[:, :, j0:j1], lse4[..., i0:i1], seg,
                             causal, i0, i1, j0, j1, scale)
            dv[:, :, j0:j1] += torch.einsum("bkgts,bkgtd->bksd", p, dot)
            dp = torch.einsum("bkgtd,bksd->bkgts", dot, vf[:, :, j0:j1])
            ds = p * (dp - ds4[..., i0:i1, None]) * scale
            dk[:, :, j0:j1] += torch.einsum("bkgts,bkgtd->bksd", ds, qt)
    return (dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


# ----------------------------------------------------------------- wrappers
_require, _operand, _stream = _build.require, _build.operand, _build.stream


def _check_cuda(q, k, v):
    _require(q.device.type == "cuda",
             f"flash attention kernels run on CUDA tensors, got {q.device}")
    _require(q.dim() == 4 and k.dim() == 4 and k.shape == v.shape,
             f"q must be [B, T, H, d] and k, v matching [B, S, KV, d]; got "
             f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    _require(q.shape[0] == k.shape[0] and q.shape[-1] == k.shape[-1],
             f"batch/head dim of q {tuple(q.shape)} and k {tuple(k.shape)} "
             "differ")
    _require(q.shape[2] % k.shape[2] == 0,
             f"H={q.shape[2]} is not a multiple of KV={k.shape[2]}")
    _require(q.dtype in _KERNEL_DTYPES,
             f"flash attention kernels take bf16/f32, got {q.dtype}")
    _require(q.shape[-1] in _KERNEL_HEAD_DIMS,
             f"head dim {q.shape[-1]} not among the kernels' "
             f"{_KERNEL_HEAD_DIMS}")


def _seg_operand(seg, q, S):
    if seg is None:
        return None
    _require(q.shape[1] == S and tuple(seg.shape) == tuple(q.shape[:2]),
             f"segment ids must be [B, T] for self-attention, got "
             f"{tuple(seg.shape)} with T={q.shape[1]}, S={S}")
    return _operand(seg.to(torch.int32), "segment_ids", torch.int32, q.device)


def _dims(q, k):
    B, T, H, d = q.shape
    return B, T, k.shape[1], H, k.shape[2], d


def flash_fwd(q, k, v, segment_ids=None, *, causal: bool = True,
              block_q: int = 512, block_k: int = 512):
    """K1: (out [B, T, H, d] in q.dtype, lse [B*H, T] f32)."""
    if q.device.type == "cpu":
        return _plain_fwd(q, k, v, segment_ids, causal, block_q, block_k)
    _check_cuda(q, k, v)
    q = _operand(q, "q", q.dtype, q.device)
    k = _operand(k, "k", q.dtype, q.device)
    v = _operand(v, "v", q.dtype, q.device)
    seg = _seg_operand(segment_ids, q, k.shape[1])
    B, T, S, H, KV, d = _dims(q, k)
    out = torch.empty_like(q)
    lse = torch.empty((B * H, T), dtype=torch.float32, device=q.device)
    fn = getattr(_build.library(), f"dtx_flash_fwd_{_KERNEL_DTYPES[q.dtype]}")
    segp = None if seg is None else seg.data_ptr()
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), segp, segp,
              out.data_ptr(), lse.data_ptr(), B, T, S, H, KV, d, int(causal),
              softmax_scale(d), _stream(q))
    _build.check(code, "flash forward kernel (K1)")
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


def _bwd_operands(q, k, v, do, lse, dsum, segment_ids):
    _check_cuda(q, k, v)
    dev, dt = q.device, q.dtype
    q, k, v = (_operand(t, n, dt, dev) for t, n in ((q, "q"), (k, "k"),
                                                   (v, "v")))
    do = _operand(do, "dO", dt, dev)
    _require(do.shape == q.shape, f"dO {tuple(do.shape)} != q {tuple(q.shape)}")
    B, T, S, H, KV, d = _dims(q, k)
    for name, t in (("lse", lse), ("D", dsum)):
        _require(tuple(t.shape) == (B * H, T),
                 f"{name} must be [B*H={B * H}, T={T}], got {tuple(t.shape)}")
    lse = _operand(lse, "lse", torch.float32, dev)
    dsum = _operand(dsum, "D", torch.float32, dev)
    return q, k, v, do, lse, dsum, _seg_operand(segment_ids, q, S)


def flash_bwd_dq(q, k, v, do, lse, dsum, segment_ids=None, *,
                 causal: bool = True, block_q: int = 512, block_k: int = 512):
    """K2: dQ [B, T, H, d] in q.dtype from the forward's lse and
    D = rowsum(dO * O) [B*H, T]."""
    if q.device.type == "cpu":
        return _plain_bwd_dq(q, k, v, do, lse, dsum, segment_ids, causal,
                             block_q, block_k)
    q, k, v, do, lse, dsum, seg = _bwd_operands(q, k, v, do, lse, dsum,
                                                segment_ids)
    B, T, S, H, KV, d = _dims(q, k)
    dq = torch.empty_like(q)
    segp = None if seg is None else seg.data_ptr()
    fn = getattr(_build.library(),
                 f"dtx_flash_bwd_dq_{_KERNEL_DTYPES[q.dtype]}")
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              lse.data_ptr(), dsum.data_ptr(), segp, segp, dq.data_ptr(),
              B, T, S, H, KV, d, int(causal), softmax_scale(d), _stream(q))
    _build.check(code, "flash backward dQ kernel (K2)")
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, do, lse, dsum, segment_ids=None, *,
                  causal: bool = True, block_q: int = 512,
                  block_k: int = 512):
    """K3: (dK, dV) [B, S, KV, d]; the GQA group sum happens in the
    kernel, in f32."""
    if q.device.type == "cpu":
        return _plain_bwd_dkv(q, k, v, do, lse, dsum, segment_ids, causal,
                              block_q, block_k)
    q, k, v, do, lse, dsum, seg = _bwd_operands(q, k, v, do, lse, dsum,
                                                segment_ids)
    B, T, S, H, KV, d = _dims(q, k)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    segp = None if seg is None else seg.data_ptr()
    fn = getattr(_build.library(),
                 f"dtx_flash_bwd_dkv_{_KERNEL_DTYPES[q.dtype]}")
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              lse.data_ptr(), dsum.data_ptr(), segp, segp, dk.data_ptr(),
              dv.data_ptr(), B, T, S, H, KV, d, int(causal),
              softmax_scale(d), _stream(q))
    _build.check(code, "flash backward dK/dV kernel (K3)")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


def row_dot(do: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """D = rowsum(dO * O) in f32, [B*H, T] (outside the kernels, as the
    reference computes it outside Pallas)."""
    B, T, H, _ = out.shape
    d = (do.float() * out.float()).sum(dim=-1)  # [B, T, H]
    return d.permute(0, 2, 1).reshape(B * H, T).contiguous()


class _FlashAttention(torch.autograd.Function):
    """K1 forward; K2 + K3 backward (the reference's custom_vjp)."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal, block_q, block_k):
        out, lse = flash_fwd(q, k, v, segment_ids, causal=causal,
                             block_q=block_q, block_k=block_k)
        ctx.save_for_backward(q, k, v, segment_ids, out, lse)
        ctx.opts = dict(causal=causal, block_q=block_q, block_k=block_k)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, seg, out, lse = ctx.saved_tensors
        dsum = row_dot(do, out)
        dq = flash_bwd_dq(q, k, v, do, lse, dsum, seg, **ctx.opts)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, dsum, seg, **ctx.opts)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor,  # [B, T, H, d]
    k: torch.Tensor,  # [B, S, KV, d]
    v: torch.Tensor,
    bias=None,  # accepted for dispatch parity; masking happens in-kernel
    *,
    segment_ids: Optional[torch.Tensor] = None,  # [B, T] packed-segment ids
    causal: bool = True,
    block_q: int = 512,
    block_k: int = 512,
) -> torch.Tensor:
    """Differentiable flash attention, [B, T, H, d] in q.dtype. KV heads stay
    un-expanded: query head h reads KV head h // (H // KV). With
    ``segment_ids`` attention is confined within packed segments
    (self-attention: T == S, ids shared between q and kv). ``block_q`` /
    ``block_k`` tile the plain version (capped to power-of-two divisors of
    T and S, as the reference picks its tiles)."""
    T, S = q.shape[1], k.shape[1]
    if segment_ids is not None and T != S:
        raise ValueError(
            f"segment_ids requires self-attention (T == S), got T={T} S={S}")
    block_q = min(block_q, _pick_block(T))
    block_k = min(block_k, _pick_block(S))
    return _FlashAttention.apply(q, k, v, segment_ids, causal, block_q,
                                 block_k)
