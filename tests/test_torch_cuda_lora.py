"""The plain version of the fused LoRA matmul (K10, ``ops/cuda_lora.py``)
against the Pallas kernel in interpret mode, on the CPU, from numpy-seeded
inputs.

Tolerances: the two float32 cases of ``tests/test_pallas_lora.py`` at that
file's own atol/rtol (2e-4; 1e-4 absolute for the zero adapter); bf16 at
atol 2^-6 + rtol 2^-6 (both round ``x·A`` and the output to bf16 at the same
points and differ only in the order of their f32 sums, which can move a
rounded value by one bf16 ulp); a shape off every tile multiple of the
port's kernel (128 x 128 x 64) and of the reference's blocks at 2e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datatunerx_tpu.ops.pallas_lora import pallas_lora_matmul
from datatunerx_tpu_torch.ops import cuda_lora as cl


def _operands(seed, lead, K, N, r, zero_b=False, w_scale=0.05):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(*lead, K)).astype(np.float32)
    w = rng.normal(size=(K, N), scale=w_scale).astype(np.float32)
    a = rng.normal(size=(K, r), scale=w_scale).astype(np.float32)
    b = (np.zeros((r, N)) if zero_b
         else rng.normal(size=(r, N), scale=0.05)).astype(np.float32)
    return x, w, a, b


CASES = {
    # name: (lead, K, N, r, scale, block_m, block_n, zero_b, w_scale, dtype, tol)
    "composite_f32": ((4, 40), 128, 256, 8, 2.0, 64, 128, False, 0.05, "f32",
                      dict(atol=2e-4, rtol=2e-4)),
    "zero_adapter_f32": ((8,), 64, 128, 4, 4.0, 8, 128, True, 1.0, "f32",
                         dict(atol=1e-4, rtol=0)),
    "composite_bf16": ((4, 40), 128, 256, 8, 2.0, 64, 128, False, 0.05,
                       "bf16", dict(atol=2**-6, rtol=2**-6)),
    "ragged_f32": ((3, 50), 200, 136, 5, 4.0, 50, 136, False, 0.05, "f32",
                   dict(atol=2e-4, rtol=2e-4)),
}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_lora_matmul_matches_pallas_kernel(case):
    lead, K, N, r, scale, bm, bn, zero_b, w_scale, dt, tol = CASES[case]
    x, w, a, b = _operands(0, lead, K, N, r, zero_b, w_scale)
    want = pallas_lora_matmul(
        *(jnp.asarray(t).astype(JDT[dt]) for t in (x, w, a, b)), scale,
        block_m=bm, block_n=bn)
    before = cl.lora_matmul.launches
    got = cl.lora_matmul(
        *(torch.from_numpy(t).to(TDT[dt]) for t in (x, w, a, b)), scale)
    assert cl.lora_matmul.launches == before  # the plain version on the CPU
    assert got.dtype == TDT[dt] and tuple(got.shape) == (*lead, N)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)
    # and against the composite the model's LoRA branch computes
    ref = x @ w + ((x @ a) @ b) * scale
    loose = dict(atol=0.1, rtol=0.05) if dt == "bf16" else tol
    np.testing.assert_allclose(got.float().numpy(), ref, **loose)
    if zero_b:
        np.testing.assert_allclose(got.numpy(), x @ w, atol=1e-4)


def test_lora_matmul_casts_weights_to_the_inputs_dtype():
    """W, A and B arrive in any float dtype and are cast to x's, as the
    reference kernel's ``astype(x.dtype)``."""
    x, w, a, b = _operands(1, (6,), 64, 128, 8)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = cl.lora_matmul(xb, *(torch.from_numpy(t) for t in (w, a, b)), 2.0)
    want = cl.lora_matmul(
        xb, *(torch.from_numpy(t).to(torch.bfloat16) for t in (w, a, b)), 2.0)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


@pytest.mark.parametrize("fault, match", [
    ("rank", "rank 65 is outside"),
    ("shape_a", "shapes do not fit"),
    ("shape_b", "shapes do not fit"),
    ("shape_x", "shapes do not fit"),
])
def test_lora_matmul_checks_its_operands(fault, match):
    K, N, r = 64, 128, 65 if fault == "rank" else 8
    x, w = torch.zeros((4, K)), torch.zeros((K, N))
    a, b = torch.zeros((K, r)), torch.zeros((r, N))
    if fault == "shape_a":
        a = a[:-1]
    elif fault == "shape_b":
        b = b[:, :-1]
    elif fault == "shape_x":
        x = x[:, :-1]
    with pytest.raises(ValueError, match=match):
        cl.lora_matmul(x, w, a, b, 1.0)
