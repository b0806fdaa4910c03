"""K7's split-table arithmetic held against the JAX package on the CPU.

The CUDA K7 cuts each slot's block table into the splits that
``decode_splits`` chooses, computes each split's f32 running max and
normaliser, merges them in split order, forms p = exp(s - m) / max(l,
1e-30) rounded to the compute dtype under the merged (m, l), and sums the
splits' f32 P·V partials in split order. The kernel runs only on the card;
here a test-local emulation of that arithmetic is held against the Pallas
``_decode_kernel`` in interpret mode, over bf16 and int8 pools, splits of
one, two and three table blocks and the split ``decode_splits`` picks, a
table with a hole (-1 between live entries), a fully masked slot and an
empty slot. Inputs are made from a numpy seed and handed to both sides as
numpy arrays.

Tolerance: atol 2^-8 + rtol 2^-7 (about one bf16 ulp): the emulation and
the reference round at the same points and differ only in the order of
their f32 sums."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datatunerx_tpu.ops import attention as jatt
from datatunerx_tpu.ops import paged_attention as jpa
from datatunerx_tpu.ops import pallas_paged_attention as jpk
from datatunerx_tpu_torch.ops import attention as tatt
from datatunerx_tpu_torch.ops import cuda_paged_attention as tpk

BS = 8
H100_SMS = 132  # streaming multiprocessors of an H100 SXM
SENT = jpa.POS_SENTINEL
NEG_INF = -1e30
TOL = dict(atol=2**-8, rtol=2**-7)


def _emulate_split_decode(q, k, v, k_scale, v_scale, tables, pos, qpos,
                          splits, per):
    """K7's arithmetic: q [B, H, d]; pools [NB, bs, KV, d] (int8 with f32
    scales [NB, bs, KV], or q's dtype); tables [B, nbps]; pos [NB, bs];
    qpos [B]."""
    B, H, d = q.shape
    KV = k.shape[2]
    G = H // KV
    nbps = tables.shape[1]
    dt = q.dtype
    scale = tatt.softmax_scale(d)
    qf = q.float().reshape(B, KV, G, d)

    def block(pool, sc, blk):  # one block [bs, KV, d] as the kernel stages it
        x = pool[blk]
        if sc is not None:
            x = tatt.kv_dequantize(x, sc[blk], dt)
        return x.float()

    out = torch.zeros((B, KV, G, d))
    for b in range(B):
        ranges = [range(s * per, min(s * per + per, nbps))
                  for s in range(splits)]
        live = [[int(tables[b, j]) for j in r if tables[b, j] >= 0]
                for r in ranges]
        scores = []
        for blks in live:  # each split's masked scores [KV, G, lanes]
            parts = []
            for blk in blks:
                s = torch.einsum("kgd,tkd->kgt", qf[b],
                                 block(k, k_scale, blk)) * scale
                ok = torch.from_numpy(pos[blk] <= qpos[b])
                parts.append(torch.where(ok, s, torch.full_like(s, NEG_INF)))
            scores.append(torch.cat(parts, -1) if parts else None)
        # pass 0: each split's (m, l); a split with no live entry (NEG_INF, 0)
        stats = []
        for s in scores:
            if s is None:
                stats.append((torch.full((KV, G), NEG_INF),
                              torch.zeros((KV, G))))
            else:
                m = s.amax(-1)
                stats.append((m, torch.exp(s - m[..., None]).sum(-1)))
        # pass 1: the merge, in split order
        m = torch.full((KV, G), NEG_INF)
        for ms, _ in stats:
            m = torch.maximum(m, ms)
        l = torch.zeros((KV, G))
        for ms, ls in stats:
            l = l + ls * torch.exp(ms - m)
        l = l.clamp(min=1e-30)
        # the partials of the live splits, summed in split order
        for blks, s, (_, ls) in zip(live, scores, stats):
            if not bool((ls > 0).all()):
                continue
            p = (torch.exp(s - m[..., None]) / l[..., None]).to(dt).float()
            vt = torch.cat([block(v, v_scale, blk) for blk in blks], 0)
            out[b] += torch.einsum("kgt,tkd->kgd", p, vt)
    return out.reshape(B, H, d).to(dt)


def _case(rng, KV, G, d, nbps):
    """Four slots over a shuffled pool: a table with a hole (-1 between
    live entries), a fully masked slot (every cached position is past the
    query's), an empty slot, and a short ragged one."""
    tables = np.full((4, nbps), -1, np.int32)
    layout = {0: [0, 1, -1, 2, 3, 4, -1, 5], 1: [6, 7, 8], 2: [],
              3: [9]}
    for b, blks in layout.items():
        tables[b, :len(blks)] = blks
    perm = rng.permutation(10)
    tables = np.where(tables >= 0, perm[np.maximum(tables, 0)], -1).astype(
        np.int32)
    NB = 10
    pos = np.full((NB, BS), SENT, np.int32)
    lens = {0: 6 * BS - 3, 1: 3 * BS, 2: 0, 3: 5}
    for b, n in lens.items():
        blks = [t for t in tables[b] if t >= 0]
        for i in range(n):
            pos[blks[i // BS], i % BS] = i
    k = rng.standard_normal((NB, BS, KV, d)).astype(np.float32)
    v = rng.standard_normal((NB, BS, KV, d)).astype(np.float32)
    q = rng.standard_normal((4, KV * G, d)).astype(np.float32)
    # slot 1 is fully masked: its query sits before every cached position
    qpos = np.array([lens[0] - 1, -1, 0, lens[3] - 1], np.int32)
    return tables, pos, k, v, q, qpos


@pytest.mark.parametrize("per", [1, 2, 3, "auto"])
@pytest.mark.parametrize("pools", ["bf16", "int8"])
def test_split_decode_arithmetic_matches_pallas_kernel(pools, per):
    KV, G, d, nbps = 2, 4, 16, 8
    rng = np.random.default_rng(11)
    tables, pos, k, v, q, qpos = _case(rng, KV, G, d, nbps)
    if per == "auto":
        splits, per = tpk.decode_splits(4, KV, nbps, BS, H100_SMS)
    else:
        splits = -(-nbps // per)
    qj = jnp.asarray(q).astype(jnp.bfloat16)
    if pools == "int8":
        kq, ks = jatt.kv_quantize(jnp.asarray(k))
        vq, vs = jatt.kv_quantize(jnp.asarray(v))
        jargs = (kq, vq, ks, vs)
        targs = tuple(torch.from_numpy(np.array(x)) for x in jargs)
    else:
        jargs = (jnp.asarray(k).astype(jnp.bfloat16),
                 jnp.asarray(v).astype(jnp.bfloat16), None, None)
        targs = (torch.from_numpy(k).to(torch.bfloat16),
                 torch.from_numpy(v).to(torch.bfloat16), None, None)
    want = np.asarray(jpk.paged_decode_attention(
        qj, jargs[0], jargs[1], jargs[2], jargs[3], jnp.asarray(tables),
        jnp.asarray(pos), jnp.asarray(qpos), interpret=True), np.float32)
    got = _emulate_split_decode(
        torch.from_numpy(q).to(torch.bfloat16), *targs,
        torch.from_numpy(tables), pos, qpos, splits, per)
    np.testing.assert_allclose(got.float().numpy(), want, **TOL)
    assert not got[2].any()  # the empty slot writes zeros
    # the fully masked slot: uniform weights over its live lanes, finite
    assert np.isfinite(want[1]).all()


@pytest.mark.parametrize("B,KV,nbps,bs", [
    (4, 4, 64, 16),   # the smoke shape
    (1, 4, 64, 16),
    (4, 4, 256, 16),  # 4096-token slots
    (3, 2, 7, 8),     # a ragged last split
    (1, 1, 1, 16),
    (2, 8, 100, 1),   # one-token blocks: splits of >= 16 lanes
    (64, 32, 5, 16),  # more blocks than the card holds: one split
    (4, 4, 0, 16),    # an empty table
])
@pytest.mark.parametrize("sms", [H100_SMS, 114])  # SXM, PCIe
def test_decode_splits_cover_every_entry_once_in_order(B, KV, nbps, bs, sms):
    splits, per = tpk.decode_splits(B, KV, nbps, bs, sms)
    assert splits >= 1 and per >= 1
    covered = [j for s in range(splits)
               for j in range(s * per, min(s * per + per, nbps))]
    assert covered == list(range(nbps))  # once each, in order
    assert all(s * per < nbps for s in range(splits)) or nbps == 0
    assert per * bs >= min(16, max(1, nbps) * bs)  # >= 16 lanes where it can
    # about two blocks an SM: never many more than 2 * sms over B * KV, and
    # at most one cluster's worth
    assert splits <= max(1, -(-2 * sms // (B * KV)))
    assert splits <= tpk.DECODE_MAX_SPLITS
