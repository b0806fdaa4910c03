"""The few-row fused LoRA matmul's arithmetic (K10's split over K in
``csrc/lora.cu``), emulated on the CPU, against the Pallas kernel in
interpret mode from numpy-seeded inputs; and ``ops/cuda_lora.py``'s choice
of kernel (``_route``) and of splits (``_split_plan``).

The emulation is the kernel's order of operations: f32 partials of the base
product and of ``xa = x·A`` over each split's K range, summed in split
order; ``xa`` rounded once to the input dtype after that merge; ``xa·B``
in f32, times ``scale`` in f32, added, and rounded once to the output.
Tolerances are ``tests/test_torch_cuda_lora.py``'s: f32 atol = rtol = 2e-4,
bf16 atol = rtol = 2^-6 (both sides round ``xa`` and the output at the same
points; their f32 sums run in another order, which can move a rounded value
by one bf16 ulp)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datatunerx_tpu.ops.pallas_lora import pallas_lora_matmul
from datatunerx_tpu_torch.ops import cuda_lora as cl

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
TOL = {"f32": dict(atol=2e-4, rtol=2e-4), "bf16": dict(atol=2**-6, rtol=2**-6)}
SHAPES = {  # (M, K, N, r)
    "decode_v_proj": (4, 2048, 256, 8),
    "ragged": (3, 200, 136, 5),
}
SCALE = 4.0


def _round(a: np.ndarray, dt: str) -> np.ndarray:
    """f32 values rounded to dt (round to nearest even), back in f32."""
    return torch.from_numpy(a).to(TDT[dt]).float().numpy()


@functools.lru_cache(maxsize=None)
def _operands(shape, dt):
    M, K, N, r = SHAPES[shape]
    rng = np.random.default_rng(M + K + N + r)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = rng.normal(size=(K, N), scale=0.05).astype(np.float32)
    a = rng.normal(size=(K, r), scale=0.05).astype(np.float32)
    b = rng.normal(size=(r, N), scale=0.05).astype(np.float32)
    return tuple(_round(t, dt) for t in (x, w, a, b))


@functools.lru_cache(maxsize=None)
def _reference(shape, dt):
    x, w, a, b = _operands(shape, dt)
    out = pallas_lora_matmul(*(jnp.asarray(t).astype(JDT[dt])
                               for t in (x, w, a, b)), SCALE)
    return np.asarray(out.astype(jnp.float32))


def _split_ranges(K, S):
    """The kernel's K ranges: ceil(K / S) rows a split, the last shorter
    (or empty)."""
    ks = -(-K // S)
    return [(min(K, s * ks), min(K, (s + 1) * ks)) for s in range(S)]


def _emulate(x, w, a, b, scale, S, dt):
    """K10's split arithmetic: per-split f32 partials summed in split order,
    xa rounded once after the merge, one rounding of the output."""
    M, N, r = x.shape[0], w.shape[1], a.shape[1]
    c = np.zeros((M, N), np.float32)
    xa = np.zeros((M, r), np.float32)
    for lo, hi in _split_ranges(x.shape[1], S):
        c = c + x[:, lo:hi] @ w[lo:hi]
        xa = xa + x[:, lo:hi] @ a[lo:hi]
    xa = _round(xa, dt)
    d = (xa @ b).astype(np.float32)
    return _round(c + d * np.float32(scale), dt)


@pytest.mark.parametrize("S", [1, 8, 16])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_split_arithmetic_matches_the_pallas_kernel(shape, dt, S):
    x, w, a, b = _operands(shape, dt)
    got = _emulate(x, w, a, b, SCALE, S, dt)
    want = _reference(shape, dt)
    np.testing.assert_allclose(got, want, **TOL[dt])
    # and the port's plain version, which the card holds the kernel to
    plain = cl._plain_lora_matmul(
        *(torch.from_numpy(t).to(TDT[dt]) for t in (x, w, a, b)), SCALE)
    np.testing.assert_allclose(got, plain.float().numpy(), **TOL[dt])


@pytest.mark.parametrize("K,S", [(2048, 16), (200, 8), (200, 16), (7, 16)])
def test_split_ranges_cover_k_once(K, S):
    rows = [k for lo, hi in _split_ranges(K, S) for k in range(lo, hi)]
    assert rows == list(range(K))


H100_SMS = 132


@pytest.mark.parametrize("delta", [-1, 0, 1])
@pytest.mark.parametrize("N", [2048, 256])
def test_route_sends_few_bf16_rows_to_the_split_kernel(N, delta):
    """At the measured crossover (4 rows of q_proj's 2048 outputs, 16 of
    v_proj's 256) and one row either side."""
    cross = cl._split_rows(N, torch.bfloat16)
    assert cross == (4 if N > 1024 else 16)
    M = cross + delta
    route = cl._route(M, 2048, N, 8, torch.bfloat16, H100_SMS)[0]
    assert route == ("split" if M <= cross else "gemm")


def test_route_by_dtype_at_the_smoke_shapes():
    def route(M, N, dtype):
        return cl._route(M, 2048, N, 8, dtype, H100_SMS)[0]

    assert route(4, 2048, torch.bfloat16) == "split"
    assert route(8192, 2048, torch.bfloat16) == "gemm"
    assert route(4, 256, torch.float32) == "split"
    assert route(8192, 256, torch.float32) == "tiles"
    f32 = cl._split_rows(2048, torch.float32)
    assert route(f32, 2048, torch.float32) == "split"
    assert route(f32 + 1, 2048, torch.float32) == "tiles"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("N", [2048, 256])
def test_split_plan_fills_one_wave(dtype, N):
    """q_proj and v_proj at a decode step on the H100's 132 SMs: at least 64
    blocks, at most two an SM, clusters of at most 16 splits."""
    route, S, cv = cl._route(4, 2048, N, 8, dtype, H100_SMS)
    assert route == "split"
    vec = 16 // dtype.itemsize
    blocks = -(-N // (cv * vec)) * S
    assert 1 <= S <= cl.MAX_SPLITS and cv in (1, 2, 4, 8, 16)
    assert 64 <= blocks <= 2 * H100_SMS
    assert (S, cv) == {(torch.bfloat16, 2048): (16, 16),
                       (torch.bfloat16, 256): (16, 8),
                       (torch.float32, 2048): (8, 16),
                       (torch.float32, 256): (16, 16)}[dtype, N]


def test_split_smem_at_q_proj():
    """The split block's bytes at q_proj's bf16 decode step (M=4, K=2048,
    r=8, S=16, BN=128), term by term as ``csrc/lora.cu``'s ``SplitSmem``
    lays them out: W's [128, 128] bf16 piece, then floats: x [4][128],
    A [128][8], B [8][128], 8 k parts of xa [8][32], every split's xa
    [16][32], every split's outputs [16][32], the warps' [8][4][128]."""
    floats = 4 * 128 + 128 * 8 + 8 * 128 + 8 * 32 + 16 * 32 + 16 * 32 \
        + 8 * 4 * 128
    assert cl._split_smem(4, 2048, 8, 16, 128, 2) == 128 * 128 * 2 + 4 * floats


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M", [1, 4, 16, 24, 32])
@pytest.mark.parametrize("K,N", [(2048, 2048), (2048, 256), (2048, 5632),
                                 (5632, 2048), (200, 136)])
@pytest.mark.parametrize("r", [8, 32, 64])
def test_route_sends_only_plans_that_fit(dtype, M, K, N, r):
    """Every shape the wrapper takes (r <= 64, any K and N) gets a kernel:
    a split plan only where its block's shared memory fits, at most 16
    splits and a grid the card can hold; else the many-row kernel of the
    dtype, as before the split kernel existed."""
    route, S, cv = cl._route(M, K, N, r, dtype, H100_SMS)
    if M > cl._split_rows(N, dtype):
        assert route == ("gemm" if dtype == torch.bfloat16 else "tiles")
    if route != "split":
        assert (S, cv) == (None, None)
        assert route == ("gemm" if dtype == torch.bfloat16 else "tiles")
        return
    size = dtype.itemsize
    assert 1 <= S <= cl.MAX_SPLITS and cv in (1, 2, 4, 8, 16)
    assert cl._split_smem(M, K, r, S, cv * 16 // size, size) \
        <= cl.SPLIT_SMEM_MAX


@pytest.mark.parametrize("dtype,M,K,N,r,want", [
    # gate/up_proj in f32 at r=8: two splits would take 262,144 bytes of
    # W alone, so the plan stops halving at four
    (torch.float32, 4, 2048, 5632, 8, ("split", 4, 16)),
    # down_proj in f32: eight splits would not fit, sixteen do
    (torch.float32, 4, 5632, 2048, 8, ("split", 16, 16)),
    # gate/up_proj in bf16 at r=32: stops at eight splits
    (torch.bfloat16, 4, 2048, 5632, 32, ("split", 8, 16)),
    # r=64 over 24-32 f32 rows: the xa partials alone do not fit
    (torch.float32, 32, 2048, 2048, 64, ("tiles", None, None)),
    (torch.bfloat16, 4, 5632, 2048, 64, ("gemm", None, None)),
])
def test_route_where_the_widest_plan_does_not_fit(dtype, M, K, N, r, want):
    assert cl._route(M, K, N, r, dtype, H100_SMS) == want
