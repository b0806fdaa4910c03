"""The port's flash attention (K1 forward, K2/K3 backward through the
autograd Function) against ``datatunerx_tpu.ops.flash_attention`` in Pallas
interpret mode and ``jax.grad`` of it, on the CPU at float32 (and the
backward's plain versions also in bf16), where the port runs the kernels'
plain versions.

Tolerance: atol = rtol = 2e-5 for outputs and lse, 5e-5 for gradients —
f32 sums over the same tiles in another order (the reference's own flash
tests hold the forward to the XLA path at 2e-5). Non-causal runs go through
the reference's ``_fwd``/``_bwd`` with ``causal=False`` (what ring attention
calls), since its public function is causal-only."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datatunerx_tpu.ops import flash_attention as jfa
from datatunerx_tpu_torch.ops import flash_attention as tfa

FWD_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=5e-5, rtol=5e-5)


def _inputs(seed, B=2, T=128, H=4, KV=2, d=32, packed=False):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, H, d)).astype(np.float32)
    k = rng.normal(size=(B, T, KV, d)).astype(np.float32)
    v = rng.normal(size=(B, T, KV, d)).astype(np.float32)
    do = rng.normal(size=(B, T, H, d)).astype(np.float32)
    seg = None
    if packed:
        # 3-5 segments per row, then a pad tail with id 0
        seg = np.zeros((B, T), np.int32)
        for b in range(B):
            n = int(rng.integers(3, 6))
            cuts = np.sort(rng.choice(np.arange(8, T - 8), n - 1,
                                      replace=False))
            bounds = [0, *cuts.tolist(), T - 8]
            for s in range(n):
                seg[b, bounds[s]:bounds[s + 1]] = s + 1
    return q, k, v, do, seg


def _t(x):
    return None if x is None else torch.from_numpy(x)


CASES = [
    # T, block, packed, GQA (H, KV)
    (128, 64, False, (4, 2)),
    (256, 128, False, (4, 2)),
    (256, 64, True, (4, 2)),
    (128, 128, True, (4, 4)),
]


@pytest.mark.parametrize("T,block,packed,heads", CASES)
def test_forward_and_grads_match_reference(T, block, packed, heads):
    H, KV = heads
    q, k, v, do, seg = _inputs(T + block, T=T, H=H, KV=KV, packed=packed)

    def jloss(q, k, v):
        out = jfa.flash_attention(
            q, k, v, segment_ids=None if seg is None else jnp.asarray(seg),
            block_q=block, block_k=block, interpret=True)
        return jnp.sum(out * jnp.asarray(do)), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tout = tfa.flash_attention(tq, tk, tv, segment_ids=_t(seg),
                               block_q=block, block_k=block)
    tout.backward(torch.from_numpy(do))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               **FWD_TOL)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)
        assert np.isfinite(got.numpy()).all()


@pytest.mark.parametrize("causal", [True, False])
def test_kernel_functions_match_reference_fwd_bwd(causal):
    """The three kernels' plain versions one by one against the reference's
    _fwd (out, lse) and _bwd (dq, dk, dv), causal and not."""
    B, T, H, KV, d, blk = 2, 128, 4, 2, 16, 64
    q, k, v, do, seg = _inputs(7, B=B, T=T, H=H, KV=KV, d=d, packed=True)
    G = H // KV
    fold = lambda x, n: jnp.asarray(x).transpose(0, 2, 1, 3).reshape(  # noqa
        B * n, T, d)
    jq, jk, jv, jdo = fold(q, H), fold(k, KV), fold(v, KV), fold(do, H)
    jseg = jnp.asarray(seg)
    jout, jlse = jfa._fwd(jq, jk, jv, jseg, jseg, block_q=blk, block_k=blk,
                          interpret=True, H=H, G=G, causal=causal)
    jdq, jdk, jdv = jfa._bwd(blk, blk, True, G,
                             (jq, jk, jv, jseg, jseg, jout, jlse), jdo,
                             causal=causal)

    tq, tk, tv, tdo, tseg = map(_t, (q, k, v, do, seg))
    out, lse = tfa.flash_fwd(tq, tk, tv, tseg, causal=causal, block_q=blk,
                             block_k=blk)
    unfold = lambda x, n: np.asarray(x).reshape(B, n, T, d).transpose(  # noqa
        0, 2, 1, 3)
    np.testing.assert_allclose(out.numpy(), unfold(jout, H), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **FWD_TOL)
    dsum = tfa.row_dot(tdo, out)
    dq = tfa.flash_bwd_dq(tq, tk, tv, tdo, lse, dsum, tseg, causal=causal,
                          block_q=blk, block_k=blk)
    dk, dv = tfa.flash_bwd_dkv(tq, tk, tv, tdo, lse, dsum, tseg,
                               causal=causal, block_q=blk, block_k=blk)
    np.testing.assert_allclose(dq.numpy(), unfold(jdq, H), **GRAD_TOL)
    np.testing.assert_allclose(dk.numpy(), unfold(jdk, KV), **GRAD_TOL)
    np.testing.assert_allclose(dv.numpy(), unfold(jdv, KV), **GRAD_TOL)


BF16_TOL = dict(atol=2**-6, rtol=2**-6)


@pytest.mark.parametrize("causal,packed", [(True, False), (True, True),
                                           (False, True)])
def test_plain_backward_matches_reference_in_bf16(causal, packed):
    """K2's and K3's plain versions on bf16 inputs against the reference's
    _bwd in interpret mode on the same bf16 inputs, with the forward's out
    and lse shared. On the card the bf16 kernels are held to these plain
    versions, so this closes the chain kernel -> plain -> reference in the
    working dtype. Tolerance atol = rtol = 2^-6: both round f32 sums of the
    same products once to bf16, in another order, and the reference rounds
    dK/dV per query head before its group sum where the port sums the G
    heads in f32 and rounds once."""
    B, T, H, KV, d, blk = 2, 128, 4, 2, 32, 64
    q, k, v, do, seg = _inputs(11, B=B, T=T, H=H, KV=KV, d=d, packed=packed)
    G = H // KV
    fold = lambda x, n: jnp.asarray(x, jnp.bfloat16).transpose(  # noqa
        0, 2, 1, 3).reshape(B * n, T, d)
    jq, jk, jv, jdo = fold(q, H), fold(k, KV), fold(v, KV), fold(do, H)
    jseg = jnp.asarray(np.zeros((B, T), np.int32) if seg is None else seg)
    jout, jlse = jfa._fwd(jq, jk, jv, jseg, jseg, block_q=blk, block_k=blk,
                          interpret=True, H=H, G=G, causal=causal)
    jdq, jdk, jdv = jfa._bwd(blk, blk, True, G,
                             (jq, jk, jv, jseg, jseg, jout, jlse), jdo,
                             causal=causal)

    def unfold(x, n):
        return np.array(x.astype(jnp.float32)).reshape(B, n, T, d) \
            .transpose(0, 2, 1, 3)

    tq, tk, tv, tdo = (torch.from_numpy(x).to(torch.bfloat16)
                       for x in (q, k, v, do))
    tout = torch.from_numpy(unfold(jout, H)).to(torch.bfloat16)
    lse = torch.from_numpy(np.array(jlse))
    dsum = tfa.row_dot(tdo, tout)
    opts = dict(causal=causal, block_q=blk, block_k=blk)
    dq = tfa.flash_bwd_dq(tq, tk, tv, tdo, lse, dsum, _t(seg), **opts)
    dk, dv = tfa.flash_bwd_dkv(tq, tk, tv, tdo, lse, dsum, _t(seg), **opts)
    for got, want in ((dq, unfold(jdq, H)), (dk, unfold(jdk, KV)),
                      (dv, unfold(jdv, KV))):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)


def test_pad_rows_of_a_packed_batch_stay_finite():
    """A packed row whose tail is pad (id 0) and whose first tiles hold no
    key of its segment: no NaN forward or backward."""
    q, k, v, do, seg = _inputs(3, B=1, T=128, H=2, KV=1, d=16, packed=True)
    seg[0, :] = 2
    seg[0, 100:] = 0  # pad tail
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, segment_ids=_t(seg), block_q=32,
                              block_k=32)
    out.backward(torch.from_numpy(do))
    for t in (out, tq.grad, tk.grad, tv.grad):
        assert torch.isfinite(t).all()


def test_launch_counters_do_not_move_on_the_cpu():
    q, k, v, do, _ = _inputs(4, B=1, T=64, H=2, KV=1, d=16)
    before = (tfa.flash_fwd.launches, tfa.flash_bwd_dq.launches,
              tfa.flash_bwd_dkv.launches)
    tq = torch.from_numpy(q).requires_grad_()
    tfa.flash_attention(tq, _t(k), _t(v)).sum().backward()
    assert (tfa.flash_fwd.launches, tfa.flash_bwd_dq.launches,
            tfa.flash_bwd_dkv.launches) == before


def _k1_numerics(q, k, v, seg, causal, block_k=64):
    """A test-local emulation of the bf16 K1's arithmetic on the tensor
    cores: f32 scores of the bf16 inputs, the online softmax over 64-key
    tiles with masked lanes 0 and l summed from the f32 p, p rounded to bf16
    as the operand of P·V with f32 accumulation, and O rounded once.
    Returns (out [B, T, H, d] bf16, lse [B*H, T] f32)."""
    B, T, H, d = q.shape
    S = k.shape[1]
    scale = d ** -0.5
    qf, kf, vf = tfa._fold(q, k, v)
    m = torch.full(qf.shape[:-1], tfa.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for j0, j1 in tfa._tiles(S, block_k):
        s = torch.einsum("bkgtd,bksd->bkgts", qf, kf[:, :, j0:j1]) * scale
        ok = tfa._tile_mask(seg, causal, 0, T, j0, j1, q.device)
        s = torch.where(ok, s, torch.full_like(s, tfa.NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(ok, torch.exp(s - m_new[..., None]),
                        torch.zeros_like(s))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgts,bksd->bkgtd", p.to(torch.bfloat16).float(),
            vf[:, :, j0:j1])
        m = m_new
    lc = l.clamp(min=1e-30)
    out = (acc / lc[..., None]).permute(0, 3, 1, 2, 4).reshape(B, T, H, d)
    return out.to(torch.bfloat16), (m + torch.log(lc)).reshape(B * H, T)


@pytest.mark.parametrize("packed", [False, True])
def test_k1_bf16_rounding_point_matches_reference(packed):
    """The bf16 K1 rounds P to bf16 as the operand of P·V, where the
    reference's _fwd keeps p in f32. This emulation of the kernel's
    arithmetic, on the same bf16 inputs as the reference in interpret mode,
    stays within the bound the card holds K1 to: atol = rtol = 2^-6 for the
    output (one bf16 rounding of each p, 2^-9 relative and random in sign,
    plus the output's own rounding) and 1e-4 for the lse, which both take
    from the f32 p."""
    B, T, H, KV, d, blk = 2, 256, 4, 2, 64, 64
    q, k, v, _, seg = _inputs(21 + packed, B=B, T=T, H=H, KV=KV, d=d,
                              packed=packed)
    G = H // KV
    fold = lambda x, n: jnp.asarray(x, jnp.bfloat16).transpose(  # noqa
        0, 2, 1, 3).reshape(B * n, T, d)
    jseg = jnp.asarray(np.zeros((B, T), np.int32) if seg is None else seg)
    jout, jlse = jfa._fwd(fold(q, H), fold(k, KV), fold(v, KV), jseg, jseg,
                          block_q=blk, block_k=blk, interpret=True, H=H, G=G,
                          causal=True)
    want = np.array(jout.astype(jnp.float32)).reshape(B, H, T, d) \
        .transpose(0, 2, 1, 3)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    out, lse = _k1_numerics(tq, tk, tv, _t(seg), causal=True)
    np.testing.assert_allclose(out.float().numpy(), want, **BF16_TOL)
    np.testing.assert_allclose(lse.numpy(), np.array(jlse), atol=1e-4,
                               rtol=1e-4)
    assert np.isfinite(out.float().numpy()).all()


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _hilo(x):
    """K3's hi/lo operand: the bf16 rounding plus the bf16 rounding of the
    remainder (``mma_sm90.cuh``'s ``c_to_a_split``)."""
    hi = _bf16(x)
    return hi + _bf16(x - hi)


def _k3_numerics(q, k, v, do, lse, dsum, seg, causal, rounds, block=256):
    """A test-local emulation of the bf16 K3's arithmetic: f32 scores and
    P, dS from the bf16 inputs, each operand of dV += P^T dO and
    dK += dS^T Q passed through ``rounds[name]`` (``_bf16``: one rounding;
    ``_hilo``: the kernel's split pair) with f32 accumulation, the G heads
    of a group summed in f32 and rounded once. Returns {name: (dK, dV)}
    (bf16) for every entry of ``rounds``, computed in one pass."""
    T, S = q.shape[1], k.shape[1]
    scale = tfa.softmax_scale(q.shape[-1])
    qf, kf, vf, dof, lse4, ds4 = tfa._bwd_views(q, k, v, do, lse, dsum)
    acc = {n: (torch.zeros_like(kf), torch.zeros_like(vf)) for n in rounds}
    for j0, j1 in tfa._tiles(S, block):
        for i0, i1 in tfa._tiles(T, block):
            if tfa._skip(causal, i0, i1, j0):
                continue
            qt, dot = qf[..., i0:i1, :], dof[..., i0:i1, :]
            p = tfa._plain_probs(qt, kf[:, :, j0:j1], lse4[..., i0:i1], seg,
                                 causal, i0, i1, j0, j1, scale)
            dp = torch.einsum("bkgtd,bksd->bkgts", dot, vf[:, :, j0:j1])
            ds = p * (dp - ds4[..., i0:i1, None]) * scale
            for name, (fp, fds) in rounds.items():
                dk, dv = acc[name]
                dv[:, :, j0:j1] += torch.einsum("bkgts,bkgtd->bksd", fp(p),
                                                dot)
                dk[:, :, j0:j1] += torch.einsum("bkgts,bkgtd->bksd", fds(ds),
                                                qt)
    return {n: (dk.permute(0, 2, 1, 3).to(k.dtype),
                dv.permute(0, 2, 1, 3).to(v.dtype))
            for n, (dk, dv) in acc.items()}


def _share_of_bound(got, want):
    """The largest error as a share of its element's bound (atol 2^-6 +
    rtol 2^-6 × |want|)."""
    g, w = got.float(), want.float()
    return float(((g - w).abs() / (2**-6 + 2**-6 * w.abs())).max())


@pytest.mark.parametrize("packed", [False, True])
def test_k3_bf16_rounding_point_matches_reference(packed):
    """The bf16 K3 passes P^T and dS^T to its second products as bf16
    hi/lo pairs (16 significant bits), where the reference keeps f32. The
    emulation of that arithmetic, on the same bf16 inputs as the
    reference's ``_bwd`` in interpret mode (out and lse shared), holds
    the bound the card holds K3 to: atol = rtol = 2^-6."""
    B, T, H, KV, d, blk = 2, 256, 4, 2, 64, 64
    q, k, v, do, seg = _inputs(31 + packed, B=B, T=T, H=H, KV=KV, d=d,
                               packed=packed)
    G = H // KV
    fold = lambda x, n: jnp.asarray(x, jnp.bfloat16).transpose(  # noqa
        0, 2, 1, 3).reshape(B * n, T, d)
    jq, jk, jv, jdo = fold(q, H), fold(k, KV), fold(v, KV), fold(do, H)
    jseg = jnp.asarray(np.zeros((B, T), np.int32) if seg is None else seg)
    jout, jlse = jfa._fwd(jq, jk, jv, jseg, jseg, block_q=blk, block_k=blk,
                          interpret=True, H=H, G=G, causal=True)
    _, jdk, jdv = jfa._bwd(blk, blk, True, G,
                           (jq, jk, jv, jseg, jseg, jout, jlse), jdo,
                           causal=True)

    def unfold(x, n):
        return np.array(x.astype(jnp.float32)).reshape(B, n, T, d) \
            .transpose(0, 2, 1, 3)

    tq, tk, tv, tdo = (torch.from_numpy(x).to(torch.bfloat16)
                       for x in (q, k, v, do))
    tout = torch.from_numpy(unfold(jout, H)).to(torch.bfloat16)
    lse = torch.from_numpy(np.array(jlse))
    dsum = tfa.row_dot(tdo, tout)
    dk, dv = _k3_numerics(tq, tk, tv, tdo, lse, dsum, _t(seg), True,
                          {"hilo": (_hilo, _hilo)})["hilo"]
    np.testing.assert_allclose(dk.float().numpy(), unfold(jdk, KV),
                               **BF16_TOL)
    np.testing.assert_allclose(dv.float().numpy(), unfold(jdv, KV),
                               **BF16_TOL)


def test_k3_single_rounding_uses_the_bound_and_the_split_does_not():
    """Where the rounding point bites: at the training geometry (T = 1024,
    H = 32, KV = 4, d = 64, a packed row: 8 x 1024 terms a key row), one
    bf16 rounding of P takes dV to more than half its bound against the
    plain f32-operand version (0.87 here; over it on the card at other
    draws of eight rows), and of dS dK to more than 0.4 (0.47); the pair
    keeps both under 0.35, what the outputs' own rounding leaves. K2's one
    rounding of dS (a sum over one head's keys) stays under 0.45."""
    T, H, KV, d = 1024, 32, 4, 64
    q, k, v, do, seg = _inputs(5, B=1, T=T, H=H, KV=KV, d=d, packed=True)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(torch.bfloat16)
                       for x in (q, k, v, do))
    tseg = _t(seg)
    out, lse = tfa._plain_fwd(tq, tk, tv, tseg, True, 256, 256)
    dsum = tfa.row_dot(tdo, out)
    want_dk, want_dv = tfa._plain_bwd_dkv(tq, tk, tv, tdo, lse, dsum, tseg,
                                          True, 256, 256)
    ident = lambda x: x  # noqa: E731
    got = _k3_numerics(tq, tk, tv, tdo, lse, dsum, tseg, True, {
        "P": (_bf16, ident), "dS": (ident, _bf16), "hilo": (_hilo, _hilo)})
    share_dv = _share_of_bound(got["P"][1], want_dv)
    share_dk = _share_of_bound(got["dS"][0], want_dk)
    split = max(_share_of_bound(got["hilo"][0], want_dk),
                _share_of_bound(got["hilo"][1], want_dv))
    assert share_dv > 0.5 and share_dk > 0.4, (share_dv, share_dk)
    assert split < 0.35, split
    # K2: dQ += dS K with dS rounded once, as the kernel does
    scale = tfa.softmax_scale(d)
    qf, kf, vf, dof, lse4, ds4 = tfa._bwd_views(tq, tk, tv, tdo, lse, dsum)
    dq = torch.zeros_like(qf)
    for i0, i1 in tfa._tiles(T, 256):
        for j0, j1 in tfa._tiles(T, 256):
            if tfa._skip(True, i0, i1, j0):
                continue
            kt = kf[:, :, j0:j1]
            p = tfa._plain_probs(qf[..., i0:i1, :], kt, lse4[..., i0:i1],
                                 tseg, True, i0, i1, j0, j1, scale)
            dp = torch.einsum("bkgtd,bksd->bkgts", dof[..., i0:i1, :],
                              vf[:, :, j0:j1])
            ds = p * (dp - ds4[..., i0:i1, None]) * scale
            dq[..., i0:i1, :] += torch.einsum("bkgts,bksd->bkgtd",
                                              _bf16(ds), kt)
    dq = dq.permute(0, 3, 1, 2, 4).reshape(1, T, H, d).to(torch.bfloat16)
    want_dq = tfa._plain_bwd_dq(tq, tk, tv, tdo, lse, dsum, tseg, True, 256,
                                256)
    assert _share_of_bound(dq, want_dq) < 0.45
