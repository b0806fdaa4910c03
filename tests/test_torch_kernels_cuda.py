"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU with nvcc (the kernels are built from
``datatunerx_tpu_torch/csrc`` at first use) and skip elsewhere; run them on
the GPU machine with ``python -m pytest -m cuda tests/test_torch_kernels_cuda.py``.
Tolerances: float32 atol=rtol=1e-5, bf16 atol 2^-8 / rtol 2^-7 (the
kernels' f32 sums run in another order than the plain versions'); token ids
exact for greedy sampling. Flash attention (K1-K3): float32 1e-4 (sums over
up to 1024 keys in another order, gradients of unit-scale inputs), bf16
2^-6 (outputs and gradients round once to bf16 from f32 sums taken in
another order, and a bf16 ulp at |x| ~ 2-4 is 2^-6; besides, the bf16 K1
and K2 run their second products on tensor cores with P and dS rounded to
bf16 as operands, where the plain versions keep them in f32: a relative
error of 2^-9 per term, random in sign, so about 1e-3 of a gradient's scale
after the sums over keys; K3, whose sums also run over the G heads of a KV
group, passes P and dS as bf16 hi/lo pairs, 2^-17 a term, and is held over
a sweep of eight draws at the training shapes). Quantized matmuls
(K4-K6): float32 atol=rtol=1e-4 (f32 sums over up to 5632 products in
another order), bf16 atol 2^-8 / rtol 2^-7 (the staged weights are
bit-equal to the plain version's; the f32 sums round once to bf16). The
int8-pool instantiations of K7/K8 hold K7/K8's tolerances (their staged
tiles equal the plain version's dequantized blocks bit for bit); the bf16
K8 runs on tensor cores and rounds p to bf16 where the plain version does,
so it too differs only by the order of its f32 sums. The fused
LoRA matmul (K10): float32 atol=rtol=1e-4, bf16 atol 2^-8 / rtol 2^-7 (the
kernel and its plain version round at the same points and differ only in
the order of their f32 sums), held against the plain version on every row
whose xa strip rounds as the plain version's does, and on every row against
the plain version given the kernel's own strip (which must lie within the
f32 sums' order error of the exact one). The split-table K7 holds K7's tolerances in
both dtypes (its splits merge (m, l) and sum the partials in split order,
rounding p and the output where the plain version does), and two calls on
the same inputs agree bit for bit; the bf16 K6 on ``wgmma`` holds K6's,
and the bf16 K4/K5 on ``wgmma`` hold K4/K5's (their staged tiles are
bit-equal to ``dequant_nf4(..., bf16)``). The threefry kernel is held bit
for bit: its keep masks and uniforms are integer-exact against the twin's
int64 ops, and a forward with dropout on gives the CPU's loss (rtol 1e-5,
f32 sums in another order)."""

import pytest
import torch

from datatunerx_tpu_torch.ops import cuda_paged_attention as cpa
from datatunerx_tpu_torch.ops import cuda_sampling as cs
from datatunerx_tpu_torch.ops.attention import attention_allow

pytestmark = pytest.mark.cuda

SENT = 2**30
TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
       torch.bfloat16: dict(atol=2**-8, rtol=2**-7)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _pool(lens, nbps, bs, KV, d, dtype, dev, gen):
    B = len(lens)
    NB = B * nbps
    tables = torch.full((B, nbps), -1, dtype=torch.int32)
    perm = torch.randperm(NB, generator=gen)
    nxt = 0
    for b, n in enumerate(lens):
        need = -(-n // bs)
        tables[b, :need] = perm[nxt:nxt + need].to(torch.int32)
        nxt += need
    pos = torch.full((NB + 1, bs), SENT, dtype=torch.int32)
    for b, n in enumerate(lens):
        for i in range(n):
            pos[tables[b, i // bs], i % bs] = i
    k = torch.randn((NB + 1, bs, KV, d), generator=gen).to(dtype)
    v = torch.randn((NB + 1, bs, KV, d), generator=gen).to(dtype)
    return tables.to(dev), pos.to(dev), k.to(dev), v.to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_matches_plain(cuda, dtype):
    gen = torch.Generator().manual_seed(0)
    lens = [40, 0, 17, 1]
    tables, pos, k, v = _pool(lens, 4, 16, 2, 16, dtype, cuda, gen)
    q = torch.randn((4, 8, 16), generator=gen).to(dtype).to(cuda)
    qpos = torch.tensor([max(n - 1, 0) for n in lens], dtype=torch.int32,
                        device=cuda)
    before = cpa.paged_decode_attention.launches
    got = cpa.paged_decode_attention(q, k, v, None, None, tables, pos, qpos)
    assert cpa.paged_decode_attention.launches == before + 1
    want = cpa._plain_decode(q, k, v, tables, pos, qpos)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    assert not got[1].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_multitoken_kernel_matches_plain(cuda, dtype):
    gen = torch.Generator().manual_seed(1)
    lens, T, bs = [48, 30], 12, 16
    tables, pos, k, v = _pool(lens, 4, bs, 2, 16, dtype, cuda, gen)
    q = torch.randn((2, T, 8, 16), generator=gen).to(dtype).to(cuda)
    qpos = torch.stack([torch.arange(n - T, n) for n in lens]).to(cuda)
    tbl = torch.where(tables >= 0, tables, torch.zeros_like(tables)).long()
    view = torch.where((tables >= 0)[:, :, None], pos[tbl],
                       torch.full_like(pos[tbl], SENT)).reshape(2, -1)
    allow = attention_allow(qpos, view)
    got = cpa.paged_multitoken_attention(q, k, v, None, None, tables, allow)
    want = cpa._plain_multitoken(q, k, v, tables, allow)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def _int8_pools(k, v):
    from datatunerx_tpu_torch.ops.attention import kv_quantize

    kq, ks = kv_quantize(k.float())
    vq, vs = kv_quantize(v.float())
    return kq, vq, ks, vs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 64, 8])  # 8: the element-wise staging loop
def test_decode_kernel_int8_pools_match_plain(cuda, dtype, d):
    gen = torch.Generator().manual_seed(4)
    lens = [40, 0, 17, 1]
    tables, pos, k, v = _pool(lens, 4, 16, 2, d, torch.float32, cuda, gen)
    kq, vq, ks, vs = _int8_pools(k, v)
    q = torch.randn((4, 8, d), generator=gen).to(dtype).to(cuda)
    qpos = torch.tensor([max(n - 1, 0) for n in lens], dtype=torch.int32,
                        device=cuda)
    before = (cpa.paged_decode_attention.launches,
              cpa.paged_decode_attention.int8_launches)
    got = cpa.paged_decode_attention(q, kq, vq, ks, vs, tables, pos, qpos)
    assert (cpa.paged_decode_attention.launches,
            cpa.paged_decode_attention.int8_launches) == \
        (before[0] + 1, before[1] + 1)
    want = cpa._plain_decode(q, kq, vq, tables, pos, qpos, ks, vs)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    assert not got[1].any()
    with pytest.raises(ValueError, match="scale pools"):
        cpa.paged_decode_attention(q, kq, vq, None, None, tables, pos, qpos)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_multitoken_kernel_int8_pools_match_plain(cuda, dtype):
    gen = torch.Generator().manual_seed(5)
    lens, T, bs = [48, 30], 12, 16
    tables, pos, k, v = _pool(lens, 4, bs, 2, 16, torch.float32, cuda, gen)
    kq, vq, ks, vs = _int8_pools(k, v)
    q = torch.randn((2, T, 8, 16), generator=gen).to(dtype).to(cuda)
    qpos = torch.stack([torch.arange(n - T, n) for n in lens]).to(cuda)
    tbl = torch.where(tables >= 0, tables, torch.zeros_like(tables)).long()
    view = torch.where((tables >= 0)[:, :, None], pos[tbl],
                       torch.full_like(pos[tbl], SENT)).reshape(2, -1)
    allow = attention_allow(qpos, view)
    before = cpa.paged_multitoken_attention.int8_launches
    got = cpa.paged_multitoken_attention(q, kq, vq, ks, vs, tables, allow)
    assert cpa.paged_multitoken_attention.int8_launches == before + 1
    want = cpa._plain_multitoken(q, kq, vq, tables, allow, ks, vs)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def _multitoken_case(lens, T, bs, nbps, KV, G, d, gen, dev):
    """Pools holding ``lens`` tokens per slot and a chunk of the last T of
    them as queries, with the gather path's allow operand."""
    tables, pos, k, v = _pool(lens, nbps, bs, KV, d, torch.float32, dev, gen)
    q = torch.randn((len(lens), T, KV * G, d), generator=gen).to(dev)
    qpos = torch.stack([torch.arange(n - T, n) for n in lens]).to(dev)
    tbl = torch.where(tables >= 0, tables, torch.zeros_like(tables)).long()
    view = torch.where((tables >= 0)[:, :, None], pos[tbl],
                       torch.full_like(pos[tbl], SENT)).reshape(len(lens), -1)
    return q, k, v, tables, attention_allow(qpos, view)


@pytest.mark.parametrize("pools", ["bf16", "int8"])
@pytest.mark.parametrize("T", [256, 200])  # 200: a ragged last row tile
def test_multitoken_kernel_at_tinyllama_heads(cuda, pools, T):
    """The bf16 K8 (tensor cores) at tinyllama-1.1b's heads: G = 8 query
    heads per KV head, d = 64, 16-token blocks, a prefill chunk of T rows
    over 768 and 300 cached tokens (a dead block between live ones)."""
    gen = torch.Generator().manual_seed(T)
    q, k, v, tables, allow = _multitoken_case([768, 300], T, 16, 64, 4, 8,
                                              64, gen, cuda)
    tables[1, 5] = -1  # a hole in the table: skipped, never read
    allow[1, :, 5 * 16:6 * 16] = False
    q = q.to(torch.bfloat16)
    pools_ = ((k.to(torch.bfloat16), v.to(torch.bfloat16), None, None)
              if pools == "bf16" else _int8_pools(k, v))
    got = cpa.paged_multitoken_attention(q, *pools_, tables, allow)
    want = cpa._plain_multitoken(q, pools_[0], pools_[1], tables, allow,
                                 pools_[2], pools_[3])
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pools", ["native", "int8"])
@pytest.mark.parametrize("ctx", [1, 16, 17, 1000, 4096])
def test_decode_kernel_at_tinyllama_heads(cuda, ctx, pools, dtype):
    """The split-table K7 at tinyllama-1.1b's heads (G = 8, d = 64, 16-token
    blocks): a slot of ``ctx`` cached tokens with a hole in its table (a -1
    between live entries) where it spans three blocks or more, an empty
    slot and a short one, over pools in q's dtype and int8 pools. Two calls
    agree bit for bit (the splits merge in a fixed order, no atomics)."""
    gen = torch.Generator().manual_seed(ctx)
    lens = [ctx, 0, max(1, ctx // 3)]
    tables, pos, k, v = _pool(lens, 256, 16, 4, 64, torch.float32, cuda, gen)
    if ctx > 32:
        tables[0, 1] = -1  # skipped, never read
    q = torch.randn((3, 32, 64), generator=gen).to(dtype).to(cuda)
    qpos = torch.tensor([n - 1 if n else 0 for n in lens], dtype=torch.int32,
                        device=cuda)
    pools_ = ((k.to(dtype), v.to(dtype), None, None) if pools == "native"
              else _int8_pools(k, v))
    before = cpa.paged_decode_attention.launches
    got = cpa.paged_decode_attention(q, *pools_, tables, pos, qpos)
    again = cpa.paged_decode_attention(q, *pools_, tables, pos, qpos)
    assert cpa.paged_decode_attention.launches == before + 2
    want = cpa._plain_decode(q, pools_[0], pools_[1], tables, pos, qpos,
                             pools_[2], pools_[3])
    assert torch.equal(got, again)
    assert torch.isfinite(got.float()).all()
    assert not got[1].any()  # the empty slot writes zeros
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def _resources(fn, n, *args):
    import ctypes

    from datatunerx_tpu_torch.ops import _build

    r = (ctypes.c_int * n)()
    _build.check(getattr(_build.library(), fn)(*args, ctypes.addressof(r)),
                 fn)
    return list(r)


def test_bf16_attention_kernels_do_not_spill(cuda):
    """The bf16 K1 and K8 (tensor cores), the split K7 (over bf16 and int8
    pools) and the wgmma K6 as the compiler built them keep
    every value in registers: 0 spill bytes (at each head dim for K1/K8)."""
    for d in (16, 32, 64, 128):
        r = _resources("dtx_flash_fwd_resources", 4, d)
        assert r[1] == 0 and r[3] >= 1, (d, r)
        r = _resources("dtx_paged_multitoken_resources", 8, d, 8,
                       cpa.multitoken_tile(256, 8))
        assert r[1] == 0 and r[5] == 0 and r[3] >= 1 and r[7] >= 1, (d, r)
    r = _resources("dtx_paged_decode_resources", 8, 64, 8)
    assert r[1] == 0 and r[5] == 0 and r[3] >= 1 and r[7] >= 1, r
    r = _resources("dtx_int8_matmul_resources", 4)
    assert r[1] == 0 and r[3] >= 1, r


def test_nf4_matmuls_do_not_spill(cuda):
    """The bf16 K4 and K5 (TMA + wgmma) as the compiler built them keep
    every value in registers: 0 spill bytes, one block an SM."""
    r = _resources("dtx_nf4_matmul_resources", 8)
    assert r[1] == 0 and r[5] == 0 and r[3] >= 1 and r[7] >= 1, r


def test_int8_matmul_runs_on_wgmma(cuda):
    """The bf16 K6, K4, K5 and the many-row bf16 K10 as built hold
    warpgroup tensor-core instructions (``HGMMA`` in their SASS), read with
    the toolkit's cuobjdump."""
    import os
    import shutil
    import subprocess

    from datatunerx_tpu_torch.ops import _build

    _build.library()
    lib = next(_build.BUILD_DIR.glob(
        f"libdtx_kernels-{_build._digest(_build._sources())}.so"))
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    funcs = sass.split("Function : ")
    for names in (("int8_gemm_wgmma",), ("nf4_gemm_wgmma", "Nf4Fwd"),
                  ("nf4_gemm_wgmma", "Nf4T"), ("lora_gemm_wgmma",)):
        found = [f for f in funcs
                 if all(n in f.splitlines()[0] for n in names)]
        assert found and all("HGMMA" in f for f in found), names


def test_new_kernels_do_not_spill(cuda):
    """The many-row bf16 K10 (TMA + wgmma, 128 x 256 and 128 x 128 tiles),
    the split K10 (bf16, f32) and the cluster K9 as built keep every value
    in registers: 0 spill bytes, at least one block an SM."""
    for fn, n in (("dtx_lora_gemm_resources", 8),
                  ("dtx_lora_split_resources", 8),
                  ("dtx_sample_resources", 4)):
        r = _resources(fn, n)
        for i in range(0, n, 4):
            assert r[i + 1] == 0 and r[i + 3] >= 1, (fn, r)


def test_split_plan_sizes_its_shared_memory_as_the_kernel(cuda):
    """The wrapper's ``_split_smem`` (which decides whether a split plan
    fits) gives the very bytes ``csrc/lora.cu``'s ``SplitSmem`` lays out."""
    from datatunerx_tpu_torch.ops import _build
    from datatunerx_tpu_torch.ops import cuda_lora as cl

    lib = _build.library()
    for M in (1, 3, 4, 16, 32):
        for K in (200, 2048, 5632):
            for r in (5, 8, 64):
                for S in (1, 2, 8, 16):
                    for bn, size in ((128, 2), (64, 2), (64, 4), (16, 4)):
                        args = (M, K, r, S, bn, size)
                        assert lib.dtx_lora_split_smem(*args) == \
                            cl._split_smem(*args), args


def _quant_digests(dev):
    """sha256 (first 16 hex digits) of the bf16 K4, K5 and K6 outputs at
    fixed inputs (a CPU generator, quantized on the CPU) at three of
    tinyllama-1.1b's projection shapes."""
    import hashlib

    from datatunerx_tpu_torch.ops import cuda_quant as cq
    from datatunerx_tpu_torch.ops import quant as tq

    gen = torch.Generator().manual_seed(2024)
    out = {}
    for K, N in ((2048, 2048), (2048, 256), (5632, 2048)):
        w = torch.randn((K, N), generator=gen) * 0.02
        qw = {k: v.to(dev) for k, v in tq.quantize_nf4(w).items()}
        q8 = {k: v.to(dev) for k, v in tq.quantize_int8(w).items()}
        x = torch.randn((200, K), generator=gen).to(torch.bfloat16).to(dev)
        g = torch.randn((200, N), generator=gen).to(torch.bfloat16).to(dev)
        for name, y in (("K4", cq.nf4_matmul(x, qw, (K, N))),
                        ("K5", cq.nf4_matmul_t(g, qw, (K, N))),
                        ("K6", cq.int8_matmul(x, q8["q"], q8["scale"]))):
            raw = y.contiguous().view(torch.int16).cpu().numpy().tobytes()
            out[f"{name} {K}x{N}"] = hashlib.sha256(raw).hexdigest()[:16]
    return out


# the bf16 K4-K6's outputs as the kernels computed them before the shared
# header (csrc/wgmma_sm90.cuh) gained K10's products
QUANT_DIGESTS = {
    "K4 2048x2048": "9ba3b1bb905e0568", "K5 2048x2048": "3478a2aae189a045",
    "K6 2048x2048": "371d85ca5f1ff619", "K4 2048x256": "fa2dff87840ff200",
    "K5 2048x256": "fc92c8f1a631c739", "K6 2048x256": "26e90c434e5714e7",
    "K4 5632x2048": "b12065780e7b5c71", "K5 5632x2048": "58e5be9ef46bd1ff",
    "K6 5632x2048": "dc305c81f9d34c3f",
}


def test_quant_kernels_bit_equal_to_their_recorded_outputs(cuda):
    """The bf16 K4, K5 and K6 still give the very bits they gave before
    ``wgmma_sm90.cuh`` was extended for K10."""
    assert _quant_digests(cuda) == QUANT_DIGESTS


LORA_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
            torch.bfloat16: dict(atol=2**-8, rtol=2**-7)}


def _lora_cases():
    from datatunerx_tpu_torch.ops.cuda_lora import _split_rows

    small = [
        (160, 128, 256, 8),    # the reference test's shape
        (4, 2048, 256, 8),     # a decode step on v_proj
        (200, 200, 136, 4),    # M, N, K off every tile; r rows of 8 bytes
        (37, 150, 99, 20),     # rows that are not whole 16-byte vectors
        (130, 64, 128, 64),    # the largest rank
        # decode steps whose widest split plan would not fit shared memory
        (4, 2048, 5632, 8),    # gate/up_proj
        (4, 5632, 2048, 8),    # down_proj
        (4, 2048, 5632, 32),   # gate/up_proj at r=32
        (4, 2048, 5632, 64),   # and at r=64
        (4, 5632, 2048, 64),   # down_proj at r=64
        (32, 2048, 2048, 64),  # the most f32 split rows at r=64
    ]
    big = [
        (8192, 2048, 2048, 8),  # a training batch on q_proj
        (8192, 2048, 256, 8),   # on v_proj (128 x 128 tiles)
        (8191, 2048, 2048, 8),  # a ragged last row tile
    ]
    for N in (2048, 256):  # the last row count on the split kernel, +- 1
        cross = _split_rows(N, torch.bfloat16)
        big += [(cross + d, 2048, N, 8) for d in (-1, 0, 1)]
    return ([(dt, *c) for dt in (torch.float32, torch.bfloat16) for c in small]
            + [(torch.bfloat16, *c) for c in big])


def _assert_lora_close(cl, x, w, a, b, scale, got):
    """K10's output against its plain version, with the strip's rounding
    read off the kernel. The kernel's xa (read back through W = 0, B = I,
    scale 1) must be an f32 sum of x A rounded once: within the sums' order
    error (2^-20 of sum |x A|) and half an ulp of the dtype of the exact
    strip. The output must hold the stated tolerance against the plain
    version given that strip, and against the plain version itself on every
    row but those whose strip rounds apart from the plain version's only
    where the exact (f64) strip lies within that order error of the bf16
    rounding midpoint between the two (there the f32 sums, in two orders,
    may round to neighbouring values, and the row moves by up to |B| scale
    ulps)."""
    dtype, dev = x.dtype, x.device
    K, r = a.shape
    xa_k = cl.lora_matmul(x, torch.zeros((K, r), dtype=dtype, device=dev), a,
                          torch.eye(r, dtype=dtype, device=dev), 1.0)
    xa64 = x.double() @ a.double()
    mag = x.double().abs() @ a.double().abs()
    _, e = torch.frexp(xa_k.double())
    half_ulp = torch.pow(2.0, e - (9 if dtype == torch.bfloat16 else 25))
    assert ((xa_k.double() - xa64).abs() <= 2**-20 * mag + half_ulp).all()
    xf, wf, bf = x.float(), w.float(), b.float()
    want = (xf @ wf + (xa_k.float() @ bf) * scale).to(dtype)
    torch.testing.assert_close(got.float(), want.float(), **LORA_TOL[dtype])
    plain = cl._plain_lora_matmul(x, w, a, b, scale)
    held = torch.ones(x.shape[0], dtype=torch.bool, device=dev)
    if dtype == torch.bfloat16:  # an f32 strip is not rounded
        xa_p = (xf @ a.float()).to(dtype)
        apart = xa_k != xa_p
        mid = (xa_k.double() + xa_p.double()) / 2
        tie = (xa64 - mid).abs() <= 2**-20 * mag
        held = ~(apart.any(dim=1) & (tie | ~apart).all(dim=1))
    torch.testing.assert_close(got[held].float(), plain[held].float(),
                               **LORA_TOL[dtype])


@pytest.mark.parametrize("dtype,M,K,N,r", _lora_cases())
def test_lora_kernel_matches_plain(cuda, dtype, M, K, N, r):
    from datatunerx_tpu_torch.ops import cuda_lora as cl

    gen = torch.Generator().manual_seed(M + K + N + r)

    def rnd(shape, s=1.0):
        return (torch.randn(shape, generator=gen) * s).to(dtype).to(cuda)

    x, w = rnd((M, K)), rnd((K, N), 0.05)
    a, b = rnd((K, r), 0.05), rnd((r, N), 0.05)
    before = cl.lora_matmul.launches
    got = cl.lora_matmul(x, w, a, b, 4.0)
    assert cl.lora_matmul.launches == before + 1
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert cl.lora_matmul.last == cl._route(M, K, N, r, dtype, sms)
    assert got.dtype == dtype and got.shape == (M, N)
    assert torch.isfinite(got.float()).all()
    _assert_lora_close(cl, x, w, a, b, 4.0, got)
    # the adapter really contributes: far from the base product alone
    base = cl._plain_lora_matmul(x, w, a, torch.zeros_like(b), 4.0)
    assert (got.float() - base.float()).abs().max() > 10 * LORA_TOL[dtype]["atol"]


def _flash_inputs(B, T, H, KV, d, dtype, dev, gen, packed):
    def rnd(*shape):
        return torch.randn(shape, generator=gen).to(dtype).to(dev)

    seg = None
    if packed:  # 3 segments and a pad tail per row
        seg = torch.zeros((B, T), dtype=torch.int32)
        for b in range(B):
            cuts = sorted(torch.randperm(T - 16, generator=gen)[:2].add(8)
                          .tolist())
            for s, (lo, hi) in enumerate(zip([0] + cuts, cuts + [T - 5])):
                seg[b, lo:hi] = s + 1
        seg = seg.to(dev)
    return rnd(B, T, H, d), rnd(B, T, KV, d), rnd(B, T, KV, d), \
        rnd(B, T, H, d), seg


FLASH_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
             torch.bfloat16: dict(atol=2**-6, rtol=2**-6)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,causal,packed,shape", [
    (64, True, False, (2, 200, 8, 2)),  # (B, T, H, KV); T: a ragged last tile
    (64, True, True, (2, 200, 8, 2)),
    (128, False, True, (2, 200, 8, 2)),
    (16, True, False, (2, 200, 8, 2)),
    (32, False, False, (2, 200, 8, 2)),
    # tinyllama-1.1b's heads (G = 8): the training length, and a ragged one
    (64, True, False, (1, 1024, 32, 4)),
    (64, True, True, (1, 1024, 32, 4)),
    (64, True, False, (2, 200, 32, 4)),
])
def test_flash_kernels_match_plain(cuda, dtype, d, causal, packed, shape):
    from datatunerx_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(3)
    B, T, H, KV = shape
    q, k, v, do, seg = _flash_inputs(B, T, H, KV, d, dtype, cuda, gen, packed)
    out, lse = fa.flash_fwd(q, k, v, seg, causal=causal)
    pout, plse = fa._plain_fwd(q, k, v, seg, causal, 64, 64)
    torch.testing.assert_close(out.float(), pout.float(), **FLASH_TOL[dtype])
    torch.testing.assert_close(lse, plse, atol=1e-4, rtol=1e-4)
    dsum = fa.row_dot(do, pout)
    dq = fa.flash_bwd_dq(q, k, v, do, plse, dsum, seg, causal=causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, plse, dsum, seg, causal=causal)
    pdq = fa._plain_bwd_dq(q, k, v, do, plse, dsum, seg, causal, 64, 64)
    pdk, pdv = fa._plain_bwd_dkv(q, k, v, do, plse, dsum, seg, causal, 64, 64)
    for got, want in ((dq, pdq), (dk, pdk), (dv, pdv)):
        assert torch.isfinite(got.float()).all()
        torch.testing.assert_close(got.float(), want.float(),
                                   **FLASH_TOL[dtype])


def test_flash_forward_pad_rows_stay_finite(cuda):
    """The bf16 K1 on a packed batch whose rows end in pad (id 0), one row
    whose first tiles hold no key of its own segment: finite, and equal to
    the plain version."""
    from datatunerx_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(9)
    B, T, H, KV, d = 2, 320, 8, 2, 64
    q, k, v, _, _ = _flash_inputs(B, T, H, KV, d, torch.bfloat16, cuda, gen,
                                  False)
    seg = torch.zeros((B, T), dtype=torch.int32)
    seg[0, :250] = 1
    seg[0, 250:] = 0  # pad tail
    seg[1, :130] = 3
    seg[1, 130:300] = 4
    seg = seg.to(cuda)
    out, lse = fa.flash_fwd(q, k, v, seg)
    pout, plse = fa._plain_fwd(q, k, v, seg, True, 64, 64)
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    torch.testing.assert_close(out.float(), pout.float(),
                               **FLASH_TOL[torch.bfloat16])
    torch.testing.assert_close(lse, plse, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("mode", ["greedy", "simple"])
def test_sampling_kernel_matches_plain(cuda, mode):
    gen = torch.Generator().manual_seed(2)
    logits = torch.randn((6, 3104), generator=gen).to(cuda)
    logits[2, 5] = logits[2, 3000] = logits[2].max() + 1
    temps = torch.tensor([0.0, 0.7, 0.0, 1.0, 0.5, 1.5], device=cuda)
    us = torch.rand((6,), generator=gen).to(cuda)
    x, bn = cs._prep(logits, temps, mode=mode)
    got = cs.kernel_sample(x, temps, us, greedy=mode == "greedy")
    want = cs._plain_sample(x, temps, us, bn=bn, greedy=mode == "greedy")
    if mode == "greedy":
        assert torch.equal(got, want) and int(got[2]) == 5
    else:
        assert torch.equal(got[temps <= 0], want[temps <= 0])


def _at_cdf_boundary(x, u, a, b):
    """Tokens a and b differ only where u*Z sits within 1e-5*Z of a CDF
    step between them (the kernel and the plain version sum in other
    orders)."""
    row = x.double()
    e = torch.exp(row - row.max())
    cdf, z = torch.cumsum(e, 0), e.sum()
    lo, hi = min(a, b), max(a, b)
    return float((cdf[lo:hi] - float(u) * z).abs().min()) <= 1e-5 * float(z)


@pytest.mark.parametrize("mode", ["greedy", "simple"])
def test_sampling_kernel_at_64_slots_with_ties_across_slices(cuda, mode):
    """K9 at V=32000 and S=64: equal maxima at the last element of one
    block's slice and the first of the next, and at two slices' first
    elements; greedy rows and rows at temperature 0 exact."""
    gen = torch.Generator().manual_seed(5)
    S, V = 64, 32000
    sl = -(-V // 16)  # a block's slice (16 blocks a row)
    logits = torch.randn((S, V), generator=gen) * 2.0
    logits[0, sl - 1] = logits[0, sl] = logits[0].max() + 1
    logits[1, sl] = logits[1, 2 * sl] = logits[1].max() + 1
    logits[2, 0] = logits[2, V - 1] = logits[2].max() + 1
    temps = torch.rand((S,), generator=gen) + 0.3
    temps[::4] = 0.0
    us = torch.rand((S,), generator=gen)
    logits, temps, us = logits.to(cuda), temps.to(cuda), us.to(cuda)
    x, bn = cs._prep(logits, temps, mode=mode)
    greedy = mode == "greedy"
    got = cs.kernel_sample(x, temps, us, greedy=greedy).cpu()
    want = cs._plain_sample(x, temps, us, bn=bn, greedy=greedy).cpu()
    if greedy:
        assert torch.equal(got, want)
        assert (int(got[0]), int(got[1]), int(got[2])) == (sl - 1, sl, 0)
        return
    for i in range(S):
        a, b = int(got[i]), int(want[i])
        if float(temps[i]) <= 0:
            assert a == b, i
        elif a != b:
            assert _at_cdf_boundary(x[i].cpu(), us[i], a, b), (i, a, b)


QUANT_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
             torch.bfloat16: dict(atol=2**-8, rtol=2**-7)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [1, 200, 8191])
@pytest.mark.parametrize("K,N", [(2048, 2048), (2048, 256), (2048, 5632),
                                 (5632, 2048)])
def test_int8_kernel_at_projection_shapes(cuda, dtype, M, K, N):
    """K6 at every projection shape of tinyllama-1.1b, with ragged row
    counts (the bf16 K6's TMA zero-fills the rows past M)."""
    from datatunerx_tpu_torch.ops import cuda_quant as cq
    from datatunerx_tpu_torch.ops import quant as tq

    gen = torch.Generator().manual_seed(M + K + N)
    q8 = tq.quantize_int8((torch.randn((K, N), generator=gen) * 0.02).to(cuda))
    x = torch.randn((M, K), generator=gen).to(dtype).to(cuda)
    got = cq.int8_matmul(x, q8["q"], q8["scale"])
    want = tq.matmul_int8(x, q8["q"], q8["scale"])
    assert got.dtype == dtype and got.shape == (M, N)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), **QUANT_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [1, 200, 8191])
@pytest.mark.parametrize("K,N", [(2048, 2048), (2048, 256), (2048, 5632),
                                 (5632, 2048)])
def test_nf4_kernels_at_projection_shapes(cuda, dtype, M, K, N):
    """K4 and K5 at every projection shape of tinyllama-1.1b, with ragged
    row counts (the bf16 kernels' TMA zero-fills the rows past M and drops
    them on the store)."""
    from datatunerx_tpu_torch.ops import cuda_quant as cq
    from datatunerx_tpu_torch.ops import quant as tq

    gen = torch.Generator().manual_seed(M + K + N)
    qw = tq.quantize_nf4((torch.randn((K, N), generator=gen) * 0.02).to(cuda))
    x = torch.randn((M, K), generator=gen).to(dtype).to(cuda)
    g = torch.randn((M, N), generator=gen).to(dtype).to(cuda)
    for got, want, width in (
            (cq.nf4_matmul(x, qw, (K, N)), tq.matmul_nf4(x, qw, (K, N)), N),
            (cq.nf4_matmul_t(g, qw, (K, N)), cq._plain_nf4_t(g, qw, (K, N)),
             K)):
        assert got.dtype == dtype and got.shape == (M, width)
        assert torch.isfinite(got.float()).all()
        torch.testing.assert_close(got.float(), want.float(),
                                   **QUANT_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,N", [(5632, 256), (192, 384), (2048, 144)])
def test_quant_kernels_match_plain(cuda, dtype, K, N):
    from datatunerx_tpu_torch.ops import cuda_quant as cq
    from datatunerx_tpu_torch.ops import quant as tq

    gen = torch.Generator().manual_seed(K + N)
    w = (torch.randn((K, N), generator=gen) * 0.05).to(cuda)
    x = torch.randn((2, 100, K), generator=gen).to(dtype).to(cuda)  # M=200
    g = torch.randn((2, 100, N), generator=gen).to(dtype).to(cuda)
    qw, q8 = tq.quantize_nf4(w), tq.quantize_int8(w)
    counts = (cq.nf4_matmul.launches, cq.nf4_matmul_t.launches,
              cq.int8_matmul.launches)
    y4 = cq.nf4_matmul(x, qw, (K, N))
    dx = cq.nf4_matmul_t(g, qw, (K, N))
    y8 = cq.int8_matmul(x, q8["q"], q8["scale"])
    assert (cq.nf4_matmul.launches, cq.nf4_matmul_t.launches,
            cq.int8_matmul.launches) == tuple(c + 1 for c in counts)
    for got, want in ((y4, tq.matmul_nf4(x, qw, (K, N))),
                      (dx, cq._plain_nf4_t(g, qw, (K, N))),
                      (y8, tq.matmul_int8(x, q8["q"], q8["scale"]))):
        assert got.dtype == dtype and got.shape == want.shape
        torch.testing.assert_close(got.float(), want.float(),
                                   **QUANT_TOL[dtype])


def test_quant_autograd_runs_the_kernels(cuda):
    from datatunerx_tpu_torch.ops import cuda_quant as cq
    from datatunerx_tpu_torch.ops import quant as tq

    gen = torch.Generator().manual_seed(7)
    K, N = 256, 128
    w = (torch.randn((K, N), generator=gen) * 0.05).to(cuda)
    qw = tq.quantize_nf4(w)
    x = torch.randn((64, K), generator=gen).to(cuda).requires_grad_()
    before = cq.nf4_matmul_t.launches
    (got,) = torch.autograd.grad(cq.cuda_matmul_nf4(x, qw, (K, N)).sum(), [x])
    assert cq.nf4_matmul_t.launches == before + 1
    want = tq.dequant_nf4(qw, (K, N)).sum(dim=1).expand(64, K)
    torch.testing.assert_close(got, want, **QUANT_TOL[torch.float32])


def test_nf4_backward_runs_k5_at_a_tinyllama_shape_in_bf16(cuda):
    """dx of ``cuda_matmul_nf4`` in bf16 at gate_proj's shape comes from
    the bf16 K5 and holds its plain version."""
    from datatunerx_tpu_torch.ops import cuda_quant as cq
    from datatunerx_tpu_torch.ops import quant as tq

    gen = torch.Generator().manual_seed(11)
    K, N = 2048, 5632
    qw = tq.quantize_nf4((torch.randn((K, N), generator=gen) * 0.02).to(cuda))
    x = torch.randn((2, 300, K), generator=gen).to(torch.bfloat16).to(cuda)
    g = torch.randn((2, 300, N), generator=gen).to(torch.bfloat16).to(cuda)
    x.requires_grad_()
    before = (cq.nf4_matmul.launches, cq.nf4_matmul_t.launches)
    y = cq.cuda_matmul_nf4(x, qw, (K, N))
    (got,) = torch.autograd.grad(y, [x], grad_outputs=g)
    assert (cq.nf4_matmul.launches, cq.nf4_matmul_t.launches) == (
        before[0] + 1, before[1] + 1)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    torch.testing.assert_close(got.float(),
                               cq._plain_nf4_t(g, qw, (K, N)).float(),
                               **QUANT_TOL[torch.bfloat16])


# ------------------------------------- prefix sharing: shared block tables
def _prefix_cache(quant: bool, gen):
    """A one-layer paged cache at tinyllama-1.1b's heads (KV = 4, d = 64,
    16-token blocks), on the CPU: slot 0 holds a 40-token prompt in blocks
    [3, 7, 1] and has decoded 6 tokens more into its tail block; slot 1
    maps slot 0's two full blocks (shared), a copy of its partial tail
    block (8 lanes kept, the rest scrubbed) and blocks of its own, and has
    written a 24-token suffix from base cursor 40."""
    from datatunerx_tpu_torch.ops.paged_attention import paged_copy_block

    NB, bs, KV, d = 12, 16, 4, 64
    k = torch.randn((1, NB + 1, bs, KV, d), generator=gen)
    v = torch.randn((1, NB + 1, bs, KV, d), generator=gen)
    cache = {"pos": torch.full((NB + 1, bs), SENT, dtype=torch.int32),
             "block_tables": torch.full((2, 8), -1, dtype=torch.int32),
             "len": torch.tensor([46, 64], dtype=torch.int32)}
    if quant:
        cache["k"], cache["v"], cache["k_scale"], cache["v_scale"] = \
            _int8_pools(k, v)
    else:
        cache["k"], cache["v"] = k.to(torch.bfloat16), v.to(torch.bfloat16)
    cache["block_tables"][0, :3] = torch.tensor([3, 7, 1])
    for i in range(46):
        cache["pos"][[3, 7, 1][i // bs], i % bs] = i
    paged_copy_block(cache, 1, 5, 8)  # slot 1's copy of the tail
    cache["block_tables"][1, :4] = torch.tensor([3, 7, 5, 9])
    for i in range(40, 64):
        cache["pos"][[3, 7, 5, 9][i // bs], i % bs] = i
    return cache


@pytest.mark.parametrize("pools", ["bf16", "int8"])
def test_row_primitives_on_cuda_pools_bit_equal_to_cpu(cuda, pools):
    """``paged_copy_block``, ``paged_insert_row`` and ``paged_extract_row``
    on CUDA pools (the scale pools too) leave the same bits as on the
    CPU."""
    from datatunerx_tpu_torch.ops import paged_attention as pa

    gen = torch.Generator().manual_seed(10)
    host = _prefix_cache(pools == "int8", gen)
    dev = {n: t.to(cuda) for n, t in host.items()}
    rows = []
    for cache in (host, dev):
        pa.paged_copy_block(cache, 7, 11, 5)
        row = pa.paged_extract_row(cache, 1, 64, width=64)
        table = torch.tensor([0, 2, 4, 6, 8, -1, -1, -1], dtype=torch.int32,
                             device=cache["pos"].device)
        pa.paged_insert_row(cache, 0, table, row)
        rows.append(pa.paged_extract_row(cache, 0, 64))
    for name, t in host.items():
        assert torch.equal(dev[name].cpu(), t), name
    for name, t in rows[0].items():
        assert torch.equal(rows[1][name].cpu(), t), name


@pytest.mark.parametrize("pools", ["bf16", "int8"])
def test_paged_kernels_over_a_shared_prefix_and_copied_tail(cuda, pools):
    """K8 for slot 1's suffix chunk (queries at positions 40-63, from a base
    cursor of 40, over two blocks slot 0 wrote and still holds and a copied
    tail block whose lanes past 8 are scrubbed) and K7 for both slots'
    next token, against their plain versions."""
    gen = torch.Generator().manual_seed(11)
    cache = {n: t.to(cuda) for n, t in
             _prefix_cache(pools == "int8", gen).items()}
    k, v = cache["k"][0], cache["v"][0]
    ks = cache["k_scale"][0] if pools == "int8" else None
    vs = cache["v_scale"][0] if pools == "int8" else None
    tables, pos = cache["block_tables"], cache["pos"]
    q = torch.randn((2, 24, 32, 64), generator=gen).to(torch.bfloat16)
    q = q.to(cuda)
    tbl = torch.where(tables >= 0, tables, torch.zeros_like(tables)).long()
    view = torch.where((tables >= 0)[:, :, None], pos[tbl],
                       torch.full_like(pos[tbl], SENT)).reshape(2, -1)
    qpos = torch.stack([torch.arange(22, 46), torch.arange(40, 64)]).to(cuda)
    allow = attention_allow(qpos, view)
    assert allow[1, 0, :41].all() and not allow[1, 0, 41:].any()
    before = cpa.paged_multitoken_attention.launches
    got = cpa.paged_multitoken_attention(q, k, v, ks, vs, tables, allow)
    assert cpa.paged_multitoken_attention.launches == before + 1
    want = cpa._plain_multitoken(q, k, v, tables, allow, ks, vs)
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[torch.bfloat16])
    q1 = q[:, -1].contiguous()
    qp = torch.tensor([45, 63], dtype=torch.int32, device=cuda)
    before = cpa.paged_decode_attention.launches
    got = cpa.paged_decode_attention(q1, k, v, ks, vs, tables, pos, qp)
    assert cpa.paged_decode_attention.launches == before + 1
    want = cpa._plain_decode(q1, k, v, tables, pos, qp, ks, vs)
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[torch.bfloat16])


def _mixed_adapter_engine(cuda, tmp_path, **kw):
    from datatunerx_tpu_torch.serving.adapters import make_adapter_sweep
    from datatunerx_tpu_torch.serving.batched_engine import BatchedEngine

    cks = make_adapter_sweep(str(tmp_path), "preset:debug", 3)
    eng = BatchedEngine("preset:debug", adapters=cks, template="vanilla",
                        max_seq_len=256, slots=4, decode_chunk=4,
                        kv_block_size=16, prefill_chunk=64,
                        paged_kernel="on", device=cuda, **kw)
    return eng, ["", *sorted(cks)]


def test_paged_kernels_through_a_mixed_adapter_batch(cuda, tmp_path,
                                                     monkeypatch):
    """Every K7 and K8 launch that a four-row mixed-adapter batch makes
    (the base and three adapters of ranks 2, 4 and 8, one decode step over
    all four rows' tables, chunked prefills through one-row views) equals
    its plain version on the same operands."""
    from datatunerx_tpu_torch.models import llama

    checked = {"decode": 0, "multitoken": 0}
    real_dec = llama.paged_attention_decode_step
    real_mt = llama.paged_attention_multitoken_step

    def dec(q, ck, cv, cks, cvs, cache, pos_pool, positions):
        before = cpa.paged_decode_attention.launches
        out = real_dec(q, ck, cv, cks, cvs, cache, pos_pool, positions)
        assert cpa.paged_decode_attention.launches == before + 1
        want = cpa._plain_decode(q[:, 0], ck, cv, cache["block_tables"],
                                 pos_pool, positions[:, 0], cks, cvs)
        torch.testing.assert_close(out[:, 0].float(), want.float(),
                                   **TOL[torch.bfloat16])
        checked["decode"] += 1
        return out

    def mt(q, ck, cv, cks, cvs, cache, allow):
        before = cpa.paged_multitoken_attention.launches
        out = real_mt(q, ck, cv, cks, cvs, cache, allow)
        assert cpa.paged_multitoken_attention.launches == before + 1
        want = cpa._plain_multitoken(q, ck, cv, cache["block_tables"], allow,
                                     cks, cvs)
        torch.testing.assert_close(out.float(), want.float(),
                                   **TOL[torch.bfloat16])
        checked["multitoken"] += 1
        return out

    monkeypatch.setattr(llama, "paged_attention_decode_step", dec)
    monkeypatch.setattr(llama, "paged_attention_multitoken_step", mt)
    eng, names = _mixed_adapter_engine(cuda, tmp_path)
    try:
        tok = eng.tokenizer
        prompts = [tok.encode(f"row {i} " * (8 + 10 * i)) for i in range(4)]
        reqs = [eng.submit(p, max_new_tokens=12, adapter=n)
                for p, n in zip(prompts, names)]
        outs = []
        for r in reqs:
            assert r.done.wait(300) and r.error is None, r.error
            outs.append(r.tokens)
    finally:
        eng.close()
    assert checked["decode"] > 0 and checked["multitoken"] > 0, checked
    assert len({tuple(o) for o in outs}) > 1  # the adapters differ


def test_pool_republish_during_decode_leaves_live_rows_unchanged(cuda,
                                                                 tmp_path):
    """While a pooled engine decodes a long adapter row and a base row, the
    admin side loads and unloads other adapters into the pool's free slots
    (each a clone, a write and a republish on another thread): both live
    streams equal the ones decoded with no such traffic."""
    from datatunerx_tpu_torch.serving.adapters import make_adapter_sweep
    from datatunerx_tpu_torch.serving.batched_engine import BatchedEngine

    cks = make_adapter_sweep(str(tmp_path), "preset:debug", 4)
    live, *others = sorted(cks)
    kw = dict(adapters={live: cks[live]}, adapter_pool=3, template="vanilla",
              max_seq_len=256, slots=2, decode_chunk=4, kv_block_size=16,
              device=cuda)
    tok_src = BatchedEngine("preset:debug", **kw)
    try:
        p = tok_src.tokenizer.encode("republish probe")
        want = [tok_src.generate(p, max_new_tokens=160, adapter=live),
                tok_src.generate(p, max_new_tokens=160)]
    finally:
        tok_src.close()
    eng = BatchedEngine("preset:debug", **kw)
    try:
        reqs = [eng.submit(p, max_new_tokens=160, adapter=live),
                eng.submit(p, max_new_tokens=160)]
        swaps = 0
        while not reqs[0].done.is_set():
            for name in others:
                eng.load_adapter(name, cks[name])
                swaps += 1
                eng.unload_adapter(name)
        for r in reqs:
            assert r.done.wait(300) and r.error is None, r.error
        assert swaps > 0
        assert [r.tokens for r in reqs] == want
    finally:
        eng.close()


# ---------------------------------------------------------- PR-13 shapes
@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("case", ["packed", "llama2"])
def test_flash_k3_holds_its_bound_over_a_seed_sweep(cuda, seed, case):
    """The bf16 K3 (P^T and dS^T as bf16 hi/lo pairs) against its plain
    version at the training shapes, eight draws each: tinyllama's heads
    on a packed 8 x 1024 batch, llama2-7b's at d = 128."""
    from datatunerx_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(1000 + seed)
    B, T, H, KV, d = ((8, 1024, 32, 4, 64) if case == "packed"
                      else (8, 1024, 32, 32, 128))
    q, k, v, do, seg = _flash_inputs(B, T, H, KV, d, torch.bfloat16, cuda,
                                     gen, case == "packed")
    out, lse = fa._plain_fwd(q, k, v, seg, True, 512, 512)
    dsum = fa.row_dot(do, out)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, dsum, seg)
    pdk, pdv = fa._plain_bwd_dkv(q, k, v, do, lse, dsum, seg, True, 512, 512)
    for got, want in ((dk, pdk), (dv, pdv)):
        assert torch.isfinite(got.float()).all()
        torch.testing.assert_close(got.float(), want.float(),
                                   **FLASH_TOL[torch.bfloat16])


def test_threefry_twin_on_the_card_equals_the_host(cuda):
    """``ops/prng.py`` on int64 words on the card, bit for bit against the
    host twin (numpy), and the Random123 known answer."""
    import numpy as np

    from datatunerx_tpu_torch.ops import prng

    hk = prng.PRNGKey(2**31 + 7)
    dk = prng.to_device(hk, cuda)
    keys = prng.split(hk, 4)
    logits = np.random.default_rng(0).normal(size=(4, 32000)).astype(
        np.float32)
    logits[:, 500:] = -np.inf
    pairs = [(prng.split(hk, 5), prng.split(dk, 5)),
             (prng.fold_in(hk, 99), prng.fold_in(dk, 99)),
             (prng.uniform(hk, (4,)), prng.uniform(dk, (4,))),
             (prng.random_bits(hk, (4, 32000)),
              prng.random_bits(dk, (4, 32000))),
             (prng.gumbel(hk, (4, 32000)), prng.gumbel(dk, (4, 32000))),
             (prng.categorical(keys, logits),
              prng.categorical(prng.to_device(keys, cuda),
                               torch.from_numpy(logits).to(cuda)))]
    for host, dev in pairs:
        got = dev.cpu().numpy()
        if host.dtype == np.float32:
            np.testing.assert_array_equal(got.view(np.uint32),
                                          host.view(np.uint32))
        else:
            np.testing.assert_array_equal(got.astype(np.int64),
                                          host.astype(np.int64))
    x = prng.threefry2x32(*(torch.tensor(w, dtype=torch.int64, device=cuda)
                            for w in (0x13198A2E, 0x03707344, 0x243F6A88,
                                      0x85A308D3)))
    assert (int(x[0]), int(x[1])) == (0xC4923A9C, 0x483DF7A0)


@pytest.mark.parametrize("pools", ["bf16", "int8"])
@pytest.mark.parametrize("tree", [False, True])
def test_multitoken_kernel_at_spec_verify_shapes(cuda, pools, tree):
    """K8 at the spec verify shapes over tinyllama's heads: the chain's
    T = k + 1 = 5 causal window, and the 2x3 tree's T = 7 columns under
    the branch ancestry mask at a non-zero window start (siblings share a
    rope position), four slots of ragged lengths."""
    import numpy as np

    from datatunerx_tpu_torch.ops.attention import kv_quantize
    from datatunerx_tpu_torch.serving.speculative import tree_verify_mask

    gen = torch.Generator().manual_seed(5 + tree)
    lens, bs, KV, d, H = [700, 301, 513, 64], 16, 4, 64, 32
    tables, pos, k, v = _pool(lens, 64, bs, KV, d, torch.bfloat16, cuda, gen)
    if tree:
        T = 7
        depth = np.array([0, 1, 1, 2, 2, 3, 3])
        wmask = torch.from_numpy(tree_verify_mask(2, 3)).to(cuda)
    else:
        T, depth, wmask = 5, np.arange(5), None
    tab = tables.cpu()
    for b, n in enumerate(lens):
        for c in range(T):
            lane = n - T + c
            pos[int(tab[b, lane // bs]), lane % bs] = n - T + int(depth[c])
    start = torch.tensor([n - T for n in lens], dtype=torch.int32,
                         device=cuda)
    qpos = start[:, None] + torch.from_numpy(depth.astype(np.int32)).to(cuda)
    gtab = torch.where(tables >= 0, tables, 0).long()
    kv_pos = pos[gtab].reshape(len(lens), -1)
    kv_pos = torch.where((tables >= 0).repeat_interleave(bs, 1), kv_pos,
                         torch.full_like(kv_pos, SENT))
    allow = attention_allow(qpos, kv_pos, window_mask=(
        None if wmask is None else wmask[None].expand(len(lens), T, T)),
        window_start=start)
    q = torch.randn((len(lens), T, H, d), generator=gen).to(
        torch.bfloat16).to(cuda)
    if pools == "int8":
        kq, ks = kv_quantize(k)
        vq, vs = kv_quantize(v)
        args = (kq, vq, ks, vs)
    else:
        args = (k, v, None, None)
    got = cpa.paged_multitoken_attention(q, *args, tables, allow)
    want = cpa._plain_multitoken(q, args[0], args[1], tables, allow,
                                 args[2], args[3])
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[torch.bfloat16])


@pytest.mark.parametrize("p", [0.9, 0.95, 0.5])
@pytest.mark.parametrize("shape", [(8, 1024, 2048), (8, 1024, 256),
                                   (3, 1001), (1,), (7,), (5, 13, 17)])
def test_threefry_kernel_is_bit_equal_to_its_plain_version(cuda, shape, p):
    """The dropout keep mask (``bernoulli(1 - lora_dropout)`` at the q_proj
    and v_proj inputs of phase 5's 8 x 1024 batch, and odd lengths) and
    the NEFTune draw over [-1, 1) equal the twin's int64 ops bit for bit;
    the mask also equals the host twin's (numpy)."""
    import numpy as np

    from datatunerx_tpu_torch.ops import cuda_prng, prng

    key = prng.fold_in(prng.fold_in(prng.PRNGKey(11), 0x57E9), 3)
    got = cuda_prng.bernoulli(key, p, shape, cuda)
    assert got.dtype == torch.bool and tuple(got.shape) == shape
    assert torch.equal(got, cuda_prng.plain_bernoulli(key, p, shape, cuda))
    u = cuda_prng.uniform(key, shape, -1.0, 1.0, cuda)
    want = cuda_prng.plain_uniform(key, shape, -1.0, 1.0, cuda)
    assert torch.equal(u.view(torch.int32), want.view(torch.int32))
    if int(np.prod(shape)) <= 1 << 16:
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      prng.bernoulli(key, p, shape))


def test_forward_with_dropout_gives_the_cpu_loss_on_the_card(cuda):
    """One f32 forward of ``preset:debug`` with LoRA dropout 0.1 and
    NEFTune on, the same key: the card's masks (the threefry kernel) are
    the CPU's (the plain version), so the losses agree to f32 sums in
    another order (rtol 1e-5)."""
    from datatunerx_tpu_torch.models.config import get_config
    from datatunerx_tpu_torch.models.llama import forward, init_params
    from datatunerx_tpu_torch.models.lora import init_lora_params
    from datatunerx_tpu_torch.ops import cuda_prng, prng
    from datatunerx_tpu_torch.training.loss import causal_lm_loss

    cfg = get_config("debug")
    gen = torch.Generator().manual_seed(4)
    tokens = torch.randint(3, cfg.vocab_size, (2, 128), generator=gen)
    from datatunerx_tpu_torch.training.optimizer import tree_map

    host = init_params(cfg, seed=0)
    host_lora = init_lora_params(cfg, 5, rank=8)
    for ab in host_lora["layers"].values():
        ab["b"] = torch.full_like(ab["b"], 0.02)
    losses = []
    before = cuda_prng.threefry_bits.launches
    for dev in ("cpu", cuda):
        params = tree_map(lambda x: x.to(dev), host)
        lora = tree_map(lambda x: x.to(dev), host_lora)
        logits, _ = forward(params, tokens.to(dev), cfg, lora=(lora, 4.0),
                            lora_dropout=0.1, dropout_rng=prng.PRNGKey(2),
                            neftune_alpha=5.0)
        s, n = causal_lm_loss(logits, tokens.to(dev))
        losses.append(float(s / n))
    # one mask a layer for q_proj and v_proj, and the noise
    assert cuda_prng.threefry_bits.launches - before == 2 * cfg.num_layers + 1
    assert losses[1] == pytest.approx(losses[0], rel=1e-5)
