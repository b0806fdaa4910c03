"""The bf16 K4/K5's weight staging (``csrc/nf4_gemm.cu``), emulated on the
CPU against the plain dequantization.

The card kernels run only on the H100; this test holds their decode's
arithmetic and layout here, in a test-local numpy emulation of what each
consumer thread does a step:

- it builds its block's 16-entry table ``bf16_rn(code[i] * s)`` (f32
  products, ``s = f32(scale_q) * meta[0]``), split into a low-byte and a
  high-byte table of four words, and looks nibbles up four at a time with
  byte permutes (``prmt``, emulated byte for byte; no selector uses the sign
  mode);
- it writes chunk ``c < 4`` from the low nibbles of bytes ``8c .. 8c + 7``
  and chunk ``c + 4`` from their high nibbles, at 16-byte chunk
  ``c ^ (row & 7)`` of its row (the 128-byte swizzle);
- K4's thread t owns channel ``n0 + t`` (row t of a [256][128-byte] tile,
  packed bytes read from an unswizzled {32 bytes, 256 rows} box); K5's owns
  channel ``c0 + t % 64`` in atom ``t / 64`` of four [64][128-byte] atoms
  (packed bytes read from a 128-byte-swizzled {128 bytes, 64 rows} box).

Un-swizzled, K4's tile holds rows of ``dequant_nf4(qw, (K, N), bf16).T`` and
K5's the [c][j] tile of the same matrix, bit for bit; channels past N
(scale 0) stage zeros. Every 16-byte read and store of a quarter-warp (8
consecutive threads) lands on 8 distinct 16-byte bank groups.
"""

import numpy as np
import pytest
import torch

from datatunerx_tpu_torch.ops import quant as tq

U32 = np.uint32


def _bytes_of(x):
    return [(x >> U32(8 * k)) & U32(0xFF) for k in range(4)]


def prmt(x, y, sel):
    """``__byte_perm(x, y, sel)``: byte n of the result is byte
    ``sel[4n + 2 : 4n]`` of the eight bytes {y, x}."""
    sel = np.asarray(sel, dtype=U32)
    assert not np.any(sel & U32(0x8888)), "a selector asks for sign mode"
    src = np.stack(np.broadcast_arrays(*(_bytes_of(np.asarray(x, U32))
                                         + _bytes_of(np.asarray(y, U32)))))
    out = np.zeros(src.shape[1:], dtype=U32)
    for n in range(4):
        idx = np.broadcast_to((sel >> U32(4 * n)) & U32(7), out.shape)
        out |= np.take_along_axis(src, idx[None].astype(np.int64), 0)[0] \
            << U32(8 * n)
    return out


def bf16_bits(f32):
    t = torch.from_numpy(np.ascontiguousarray(f32, dtype=np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def nf4_table(s):
    """s [T] f32 -> (tl, th): four words each, low and high bytes of the
    16 entries bf16_rn(code[i] * s)."""
    v = bf16_bits(tq.NF4_CODE[None, :] * s[:, None]).astype(U32)  # [T, 16]
    pairs = v[:, 0::2] | (v[:, 1::2] << U32(16))                  # [T, 8]
    tl = [prmt(pairs[:, 2 * m], pairs[:, 2 * m + 1], 0x6420) for m in range(4)]
    th = [prmt(pairs[:, 2 * m], pairs[:, 2 * m + 1], 0x7531) for m in range(4)]
    return tl, th


def lut16(t, sel, pick):
    return prmt(prmt(t[0], t[1], sel), prmt(t[2], t[3], sel), pick)


def decode_word(w, tl, th):
    sa, pa = w & U32(0x7777), ((w >> U32(1)) & U32(0x4444)) | U32(0x3210)
    sb = (w >> U32(16)) & U32(0x7777)
    pb = ((w >> U32(17)) & U32(0x4444)) | U32(0x3210)
    la, ha = lut16(tl, sa, pa), lut16(th, sa, pa)
    lb, hb = lut16(tl, sb, pb), lut16(th, sb, pb)
    return ([prmt(la, ha, 0x6240), prmt(lb, hb, 0x6240)],
            [prmt(la, ha, 0x7351), prmt(lb, hb, 0x7351)])


def distinct_bank_groups(addr):
    """The 16-byte accesses of each quarter-warp (8 consecutive threads)
    hit 8 distinct 16-byte bank groups."""
    groups = (np.asarray(addr) // 16 % 8).reshape(-1, 8)
    return all(len(set(g)) == 8 for g in groups)


class K4Role:
    """Thread t: channel n0 + t, block k0/64; row t of [256][128 B]."""
    tile_bytes = 256 * 128

    @staticmethod
    def box(packed_rows, n0, step):
        """The {32 bytes, 256 rows} TMA box, unswizzled; zeros past N."""
        box = np.zeros((256, 32), np.uint8)
        part = packed_rows[n0:n0 + 256, 32 * step:32 * step + 32]
        box[:len(part)] = part
        return box.reshape(-1)

    @staticmethod
    def src(t):
        return t * 32

    @staticmethod
    def rsw(t):
        return t * 128 | (t & 7) << 4

    @staticmethod
    def first_half(t):
        return (t >> 2) & 1

    @staticmethod
    def block(t, n0, step, nbk, N):
        return n0 + t, np.full_like(t, step)


class K5Role:
    """Thread t: channel c0 + t % 64, block j0/64 + t / 64; row t % 64 of
    atom t / 64 of [4][64][128 B]."""
    tile_bytes = 4 * 64 * 128

    @staticmethod
    def box(packed_rows, j0, step):
        """The {128 bytes, 64 rows} TMA box, 128-byte swizzle; zeros past
        N and past K/2 bytes."""
        plain = np.zeros((64, 128), np.uint8)
        part = packed_rows[64 * step:64 * step + 64, j0 // 2:j0 // 2 + 128]
        plain[:part.shape[0], :part.shape[1]] = part
        box = np.zeros((64, 8, 16), np.uint8)
        for r in range(64):
            for c in range(8):
                box[r, c ^ (r & 7)] = plain[r, 16 * c:16 * c + 16]
        return box.reshape(-1)

    @staticmethod
    def src(t):
        r = t & 63
        return r * 128 + (((2 * (t >> 6)) ^ (r & 7)) << 4)

    @staticmethod
    def rsw(t):
        return ((t >> 6) * 8192 + (t & 63) * 128) | (t & 7) << 4

    @staticmethod
    def first_half(t):
        return np.zeros_like(t)

    @staticmethod
    def block(t, j0, step, nbk, N):
        return 64 * step + (t & 63), j0 // 64 + (t >> 6)


def stage(role, qw, K, N, n0, step):
    """One step's staged B tile (bytes, swizzled) as the 256 consumer
    threads write it, after asserting each access is conflict-free."""
    nbk = K // 64
    packed_rows = qw["packed"].numpy().reshape(N, K // 2)
    box = role.box(packed_rows, n0, step)
    t = np.arange(256)
    ch, blk = role.block(t, n0, step, nbk, N)
    ok = (ch < N) & (blk < nbk)
    sq = np.where(ok, qw["scale_q"].numpy()[np.where(ok, ch * nbk + blk, 0)],
                  0)
    s = sq.astype(np.float32) * np.float32(qw["meta"][0].item())
    tl, th = nf4_table(s)
    tile = np.zeros(role.tile_bytes, np.uint8)
    # half h at src ^ h << 4; chunk c of the swizzled row at rsw ^ c << 4
    rsw = role.rsw(t)
    for u in range(2):
        h = role.first_half(t) ^ u
        src = role.src(t) ^ h << 4
        assert distinct_bank_groups(src)
        words = box[src[:, None] + np.arange(16)].copy().view(U32)  # [256, 4]
        lo, hi = [], []
        for q in range(4):
            wl, wh = decode_word(words[:, q], tl, th)
            lo += wl
            hi += wh
        for v in range(2):
            c = 2 * h + v
            for chunk, vals in ((c, lo[4 * v:4 * v + 4]),
                                (c + 4, hi[4 * v:4 * v + 4])):
                dst = rsw ^ chunk << 4
                assert distinct_bank_groups(dst)
                data = np.stack(vals, 1).astype(U32).view(np.uint8)
                tile[dst[:, None] + np.arange(16)] = data
    return tile


def unswizzle(tile, rows):
    """[rows][128 B] swizzled atoms -> [rows][64] bf16 bits."""
    b = tile.reshape(rows, 8, 16)
    out = np.empty_like(b)
    for r in range(rows):
        out[r] = b[r, [c ^ (r & 7) for c in range(8)]]
    return out.reshape(rows, 128).view(np.uint16)


def _qw(K, N, seed):
    """Random nibbles over all 16 codes, scale_q over 1 .. 127 with both
    ends present, a random per-tensor scale."""
    rng = np.random.default_rng(seed)
    nb = N * K // 64
    packed = rng.integers(0, 256, (nb, 32), dtype=np.uint8)
    i = np.arange(16, dtype=np.uint8)
    packed[0] = np.concatenate([i * 17, i << 4 | i[::-1]])  # every code twice
    scale_q = rng.integers(1, 128, nb).astype(np.int8)
    scale_q[:2] = (1, 127)
    scale_q[-2:] = (127, 1)
    meta = np.array([rng.uniform(1e-4, 1e-2), tq.NF4_LAYOUT_VERSION],
                    np.float32)
    return {"packed": torch.from_numpy(packed),
            "scale_q": torch.from_numpy(scale_q),
            "meta": torch.from_numpy(meta)}


@pytest.mark.parametrize("K,N", [(256, 320), (192, 288)])
def test_k4_staging_gives_rows_of_the_dequantized_weights(K, N):
    qw = _qw(K, N, K + N)
    wt = tq.dequant_nf4(qw, (K, N), torch.bfloat16).T.contiguous()  # [N, K]
    want_bits = wt.view(torch.int16).numpy().view(np.uint16)
    seen = set()
    for n0 in range(0, N, 256):
        for step in range(K // 64):
            got = unswizzle(stage(K4Role, qw, K, N, n0, step), 256)
            live = min(256, N - n0)
            np.testing.assert_array_equal(
                got[:live], want_bits[n0:n0 + live, 64 * step:64 * step + 64])
            assert not np.any(got[live:] & np.uint16(0x7FFF))  # ±0 past N
            seen |= set(np.unique(qw["packed"].numpy().reshape(N, -1)[
                n0:n0 + live, 32 * step:32 * step + 32] & 15).tolist())
    assert seen == set(range(16))


@pytest.mark.parametrize("K,N", [(256, 320), (192, 288)])
def test_k5_staging_gives_the_transposed_tile_of_the_dequantized_weights(
        K, N):
    qw = _qw(K, N, K * N)
    wt = tq.dequant_nf4(qw, (K, N), torch.bfloat16).T.contiguous()  # [N, K]
    want_bits = wt.view(torch.int16).numpy().view(np.uint16)
    for j0 in range(0, K, 256):
        for step in range((N + 63) // 64):
            tile = stage(K5Role, qw, K, N, j0, step)
            # atom a holds output columns j0 + 64 a .. + 63 of channel rows
            got = np.concatenate(
                [unswizzle(tile[a * 8192:(a + 1) * 8192], 64)
                 for a in range(4)], axis=1)                      # [64, 256]
            c0, live_c = 64 * step, min(64, N - 64 * step)
            live_j = min(256, K - j0)
            np.testing.assert_array_equal(
                got[:live_c, :live_j],
                want_bits[c0:c0 + live_c, j0:j0 + live_j])
            # channels past N and columns past K stage ±0
            assert not np.any(got[live_c:] & np.uint16(0x7FFF))
            assert not np.any(got[:, live_j:] & np.uint16(0x7FFF))


def test_table_lookup_covers_every_code_at_both_scale_ends():
    """Every nibble value looks up its own entry, at scale_q 1 and 127:
    the decode of bytes (i | (15 - i) << 4) gives code[i] and code[15 - i]
    times s, rounded to bf16."""
    meta = np.float32(0.0037)
    for sq in (1, 127):
        s = np.full(16, np.float32(sq) * meta, np.float32)
        tl, th = nf4_table(s)
        b = (np.arange(16) | (15 - np.arange(16)) << 4).astype(np.uint8)
        words = np.tile(b, (16, 1)).view(U32)                    # [16, 4]
        lo, hi = [], []
        for q in range(4):
            wl, wh = decode_word(words[:, q], tl, th)
            lo += wl
            hi += wh
        lo_bits = np.stack(lo, 1).view(np.uint16)[0]             # [16]
        hi_bits = np.stack(hi, 1).view(np.uint16)[0]
        want = bf16_bits(tq.NF4_CODE * (np.float32(sq) * meta))
        np.testing.assert_array_equal(lo_bits, want)
        np.testing.assert_array_equal(hi_bits, want[::-1])
