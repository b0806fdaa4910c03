"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU with nvcc (the kernels are built from
``datatunerx_tpu_torch/csrc`` at first use) and skip elsewhere; run them on
the GPU machine with ``python -m pytest -m cuda tests/test_torch_kernels_cuda.py``.
Tolerances: float32 atol=rtol=1e-5, bf16 atol 2^-8 / rtol 2^-7 (the
kernels' f32 sums run in another order than the plain versions'); token ids
exact for greedy sampling."""

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
