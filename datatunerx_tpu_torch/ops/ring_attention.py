"""Ring attention: causal attention over a sequence cut into chunks across
the ``sp`` ranks of a mesh (the port of
``datatunerx_tpu/ops/ring_attention.py``).

Rank ``my`` of an ``n``-rank ring owns positions ``[my·t, (my+1)·t)``.
K/V chunks rotate around the ring (``_rotate``: one
``batch_isend_irecv`` to ``(my+1) % n`` from ``(my-1) % n``, the only
collective) while each rank merges the chunks' online-softmax statistics.

- ``ring_attention``: the chunked-einsum ring (f32 scores with a causal
  mask by global position), the parity path.
- ``ring_flash_attention``: each chunk runs the flash kernels K1–K3
  (``ops/flash_attention.py``). After ``r`` rotations a rank holds chunk
  ``(my - r) mod n``: the self chunk (r = 0) runs causal, the others
  ``causal=False``; a wrapped (future) chunk, ``my < r``, is still computed
  and weighted out by an lse of −inf, as the reference does, so results and
  launch counts match (n² K1, K2 and K3 launches over the ring). The
  backward is a reverse ring: dQ accumulates locally, the dK/dV
  accumulators travel with their chunk, and one extra rotation brings them
  home.

``ring_fwd_step`` and ``ring_bwd_step`` are one ring step each as plain
functions of (q, the chunk in hand, r, my, the accumulators): the autograd
ring calls them between rotations, and a single process can drive every
rank's schedule with the rotation done by indexing (``ring_schedule``).

``DTX_RING_IMPL`` (``flash``, the default, or ``xla``) picks the per-chunk
engine, as the reference reads it.
"""

from __future__ import annotations

import os

import torch

from datatunerx_tpu_torch.ops.attention import softmax_scale
from datatunerx_tpu_torch.ops import flash_attention as fa
from datatunerx_tpu_torch.ops.flash_attention import _pick_block, row_dot

NEG_INF = -1e30


# ------------------------------------------------------------- rotation
def _rotate(x: torch.Tensor, group, n: int, my: int,
            reverse: bool = False) -> torch.Tensor:
    """Send ``x`` to the next rank of the ring and receive the previous
    rank's (``reverse``: the other way round)."""
    import torch.distributed as dist

    if n == 1:
        return x
    ranks = dist.get_process_group_ranks(group)
    step = -1 if reverse else 1
    dst, src = ranks[(my + step) % n], ranks[(my - step) % n]
    x = x.contiguous()
    out = torch.empty_like(x)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, dst, group),
                                   dist.P2POp(dist.irecv, out, src, group)])
    for r in reqs:
        r.wait()
    return out


class _Rotate(torch.autograd.Function):
    """A differentiable rotation: the gradient rotates back."""

    @staticmethod
    def forward(ctx, x, group, n, my):
        ctx.args = (group, n, my)
        return _rotate(x, group, n, my)

    @staticmethod
    def backward(ctx, g):
        group, n, my = ctx.args
        return _rotate(g, group, n, my, reverse=True), None, None, None


# ------------------------------------------------------- the einsum ring
def _chunk_attention(q, k, v, q_pos, k_pos, scale):
    """One K/V chunk's unnormalized contribution and stats (GQA without
    expanding the KV heads). q [B, Tq, KV, G, d]; k, v [B, Tk, KV, d];
    returns (o [B, Tq, KV, G, d], m, l [B, Tq, KV, G, 1])."""
    s = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) * scale
    mask = k_pos[None, None, None, None, :] <= q_pos[None, None, None, :,
                                                     None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.clamp(m, min=NEG_INF / 2))
    p = torch.where(mask, p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    perm = (0, 3, 1, 2, 4)
    return o, m.permute(perm), l.permute(perm)


def ring_attention(q, k, v, group, n: int, my: int) -> torch.Tensor:
    """Causal ring attention with chunked einsums. q [B, t, H, d], k/v
    [B, t, KV, d]: this rank's chunk of the sequence."""
    B, T, H, d = q.shape
    KV = k.shape[2]
    G = H // KV
    qr = q.reshape(B, T, KV, G, d)
    scale = softmax_scale(d)
    q_pos = my * T + torch.arange(T, device=q.device)
    acc = torch.zeros((B, T, KV, G, d), dtype=torch.float32, device=q.device)
    m_run = torch.full((B, T, KV, G, 1), NEG_INF, dtype=torch.float32,
                       device=q.device)
    l_run = torch.zeros_like(m_run)
    kc, vc, src = k, v, my
    for r in range(n):
        k_pos = src * T + torch.arange(T, device=q.device)
        o_c, m_c, l_c = _chunk_attention(qr, kc, vc, q_pos, k_pos, scale)
        m_new = torch.maximum(m_run, m_c)
        corr_run = torch.exp(m_run - m_new)
        corr_c = torch.exp(m_c - m_new)
        acc = acc * corr_run + o_c * corr_c
        l_run = l_run * corr_run + l_c * corr_c
        m_run = m_new
        if r < n - 1:
            kc = _Rotate.apply(kc, group, n, my)
            vc = _Rotate.apply(vc, group, n, my)
        src = (src - 1) % n
    out = acc / torch.clamp(l_run, min=1e-30)
    return out.reshape(B, T, H, d).to(q.dtype)


# --------------------------------------------------------- the flash ring
def _lse_view(lse: torch.Tensor, B: int, H: int) -> torch.Tensor:
    """[B*H, T] → [B, T, H, 1], the out layout's broadcast."""
    return lse.reshape(B, H, -1).permute(0, 2, 1)[..., None]


def ring_fwd_step(q, kc, vc, r: int, my: int, acc_o=None, acc_lse=None,
                  plain: bool = False):
    """Ring step ``r`` of rank ``my`` holding chunk ``(my - r) mod n``:
    K1 on it (causal for the self chunk, r = 0) merged into the running
    (out f32 [B, t, H, d], lse f32 [B*H, t]) by their lse weights; a
    future chunk (my < r) weighs −inf. Returns the new accumulators.
    ``plain`` runs K1's plain version on whatever device q is (the chip
    check's reference schedule)."""
    blk = _pick_block(q.shape[1])  # the reference's tiles (plain version)
    if plain:
        o_c, lse_c = fa._plain_fwd(q, kc, vc, None, r == 0, blk, blk)
    else:
        o_c, lse_c = fa.flash_fwd(q, kc, vc, None, causal=r == 0,
                                  block_q=blk, block_k=blk)
    if r == 0:
        return o_c.float(), lse_c
    if my < r:
        lse_c = torch.full_like(lse_c, float("-inf"))
    B, _, H, _ = q.shape
    m = torch.maximum(acc_lse, lse_c)
    wa = torch.exp(acc_lse - m)
    wb = torch.exp(lse_c - m)
    denom = wa + wb
    acc_o = ((acc_o * _lse_view(wa, B, H) + o_c.float() * _lse_view(wb, B, H))
             / _lse_view(denom, B, H))
    return acc_o, m + torch.log(denom)


def ring_bwd_step(q, kc, vc, out, lse, do, dsum, r: int, my: int,
                  dq_acc=None, dk_acc=None, dv_acc=None,
                  plain: bool = False):
    """Reverse-ring step ``r``: K2 and K3 on the chunk in hand with the
    ring's final (out, lse) and D = rowsum(dO·out); the contributions of a
    future chunk are computed and multiplied by 0. Returns the f32
    accumulators (dq, this chunk's dk, dv). ``plain`` as ``ring_fwd_step``."""
    blk = _pick_block(q.shape[1])
    args = (q, kc, vc, do, lse, dsum, None)
    if plain:
        dq_c = fa._plain_bwd_dq(*args, r == 0, blk, blk)
        dk_c, dv_c = fa._plain_bwd_dkv(*args, r == 0, blk, blk)
    else:
        opts = dict(causal=r == 0, block_q=blk, block_k=blk)
        dq_c = fa.flash_bwd_dq(*args, **opts)
        dk_c, dv_c = fa.flash_bwd_dkv(*args, **opts)
    if r == 0:
        return dq_c.float(), dk_c.float(), dv_c.float()
    valid = 1.0 if my >= r else 0.0
    return (dq_acc + valid * dq_c.float(), dk_acc + valid * dk_c.float(),
            dv_acc + valid * dv_c.float())


class _RingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, n, my):
        acc_o, acc_lse = ring_fwd_step(q, k, v, 0, my)
        kc, vc = k, v
        for r in range(1, n):
            kc = _rotate(kc, group, n, my)
            vc = _rotate(vc, group, n, my)
            acc_o, acc_lse = ring_fwd_step(q, kc, vc, r, my, acc_o, acc_lse)
        out = acc_o.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, acc_lse)
        ctx.ring = (group, n, my)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        group, n, my = ctx.ring
        do = do.contiguous()
        dsum = row_dot(do, out)
        dq, dk, dv = ring_bwd_step(q, k, v, out, lse, do, dsum, 0, my)
        kc, vc = k, v
        for r in range(1, n):
            kc = _rotate(kc, group, n, my)
            vc = _rotate(vc, group, n, my)
            dk = _rotate(dk, group, n, my)
            dv = _rotate(dv, group, n, my)
            dq, dk, dv = ring_bwd_step(q, kc, vc, out, lse, do, dsum, r, my,
                                       dq, dk, dv)
        # one more rotation brings each chunk's accumulators home
        dk = _rotate(dk, group, n, my)
        dv = _rotate(dv, group, n, my)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


def ring_flash_attention(q, k, v, group, n: int, my: int) -> torch.Tensor:
    """Ring attention over K1–K3: q [B, t, H, d], k/v [B, t, KV, d], this
    rank's chunk; differentiable."""
    return _RingFlash.apply(q, k, v, group, n, my)


def ring_attention_local(q, k, v, mesh, axis: str = "sp") -> torch.Tensor:
    """The model's entry: the ring over ``axis`` of ``mesh``, per-chunk
    engine from ``DTX_RING_IMPL``."""
    group = mesh.group((axis,))
    n, my = mesh.shape[axis], mesh.coords[axis]
    impl = os.environ.get("DTX_RING_IMPL", "flash").strip().lower()
    fn = ring_attention if impl == "xla" else ring_flash_attention
    return fn(q, k, v, group, n, my)


# ------------------------------------------- the schedule in one process
def ring_schedule(qs, ks, vs, dos=None, plain: bool = False):
    """Every rank's ring in one process, rotations by indexing: ``qs``,
    ``ks``, ``vs`` (and ``dos`` for the backward) are the n ranks' chunks.
    Returns ([out_r], [lse_r]) and, with ``dos``, ([dq_r], [dk_c],
    [dv_c]) in the inputs' dtypes: the same steps, kernels and launch
    counts (n² each of K1, K2, K3) as n ranks on a real ring. ``plain``
    runs every step on the kernels' plain versions."""
    n = len(qs)
    outs, lses = [], []
    for my in range(n):
        acc_o, acc_lse = ring_fwd_step(qs[my], ks[my], vs[my], 0, my,
                                       plain=plain)
        for r in range(1, n):
            c = (my - r) % n
            acc_o, acc_lse = ring_fwd_step(qs[my], ks[c], vs[c], r, my,
                                           acc_o, acc_lse, plain=plain)
        outs.append(acc_o.to(qs[my].dtype))
        lses.append(acc_lse)
    if dos is None:
        return outs, lses
    dq_out = []
    dk_acc = [None] * n
    dv_acc = [None] * n
    dsums = [row_dot(do, out) for do, out in zip(dos, outs)]
    for r in range(n):
        for my in range(n):
            c = (my - r) % n
            dsum = dsums[my]
            if r == 0:
                dq, dk, dv = ring_bwd_step(qs[my], ks[c], vs[c], outs[my],
                                           lses[my], dos[my], dsum, 0, my,
                                           plain=plain)
                dq_out.append(dq)
            else:
                dq, dk, dv = ring_bwd_step(qs[my], ks[c], vs[c], outs[my],
                                           lses[my], dos[my], dsum, r, my,
                                           dq_out[my], dk_acc[c], dv_acc[c],
                                           plain=plain)
                dq_out[my] = dq
            dk_acc[c], dv_acc[c] = dk, dv
    return (outs, lses, [dq.to(q.dtype) for dq, q in zip(dq_out, qs)],
            [dk.to(k.dtype) for dk, k in zip(dk_acc, ks)],
            [dv.to(v.dtype) for dv, v in zip(dv_acc, vs)])
