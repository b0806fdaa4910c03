"""The port's quantization (``ops/quant.py``) and the plain versions of its
kernels (``ops/cuda_quant.py``: K4, K5, K6) against the JAX package on the
CPU, from the same numpy inputs.

Tolerances: quantized bytes (nf4 ``packed``/``scale_q``, int8 ``q``) are
bit-equal and dequantized weights equal; ``scale``/``meta`` within rtol 1e-6
(the reference's own stacked-vs-per-matrix drift, tests/test_quant.py). The
plain matmuls hold the reference's at f32 atol 1e-4 (tests/test_quant.py);
K4/K6's plain versions hold the Pallas kernels (interpret mode) at
atol/rtol 2e-3 and K5's at 1e-3, the reference's kernel tolerances; the
autograd dx holds ``jax.grad`` through the Pallas wrappers at 1e-5 (f32
sums in another order; the reference's own check allows 1e-2). The forward
on a quantized tree holds the JAX forward (``quant_impl="pallas"``) at
atol 2e-4 / rtol 2e-3, the logits tolerance of tests/test_model_parity.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datatunerx_tpu.models.config import get_config as jget_config
from datatunerx_tpu.models.lora import target_dims as jtarget_dims
from datatunerx_tpu.models.llama import forward as jforward
from datatunerx_tpu.models.llama import init_params as jinit
from datatunerx_tpu.ops import pallas_quant as jpq
from datatunerx_tpu.ops import quant as jq
from datatunerx_tpu_torch.models.config import get_config as tget_config
from datatunerx_tpu_torch.models.convert import params_from_jax
from datatunerx_tpu_torch.models.llama import forward as tforward
from datatunerx_tpu_torch.models.lora import target_dims
from datatunerx_tpu_torch.ops import cuda_quant as cq
from datatunerx_tpu_torch.ops import quant as tq


def _w(rng, shape, scale=0.05):
    return rng.normal(size=shape, scale=scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("shape", [(128, 64), (64, 96), (1408, 128),
                                   (64, 2)])
def test_quantizers_are_byte_identical_to_the_reference(shape):
    rng = np.random.default_rng(shape[0] + shape[1])
    w = _w(rng, shape)
    if shape == (64, 2):  # weights on the codebook: midpoint-free, exact
        w = np.tile(tq.NF4_CODE * 0.07, 8).reshape(2, 64).T.copy()
    jn, tn = jq.quantize_nf4(jnp.asarray(w)), tq.quantize_nf4(_t(w))
    assert tn["packed"].dtype == torch.uint8
    assert tn["scale_q"].dtype == torch.int8
    np.testing.assert_array_equal(tn["packed"].numpy(), np.asarray(jn["packed"]))
    np.testing.assert_array_equal(tn["scale_q"].numpy(),
                                  np.asarray(jn["scale_q"]))
    np.testing.assert_allclose(tn["meta"].numpy(), np.asarray(jn["meta"]),
                               rtol=1e-6)
    np.testing.assert_array_equal(tq.dequant_nf4(tn, shape).numpy(),
                                  np.asarray(jq.dequant_nf4(jn, shape)))
    j8, t8 = jq.quantize_int8(jnp.asarray(w)), tq.quantize_int8(_t(w))
    assert t8["q"].dtype == torch.int8
    np.testing.assert_array_equal(t8["q"].numpy(), np.asarray(j8["q"]))
    np.testing.assert_allclose(t8["scale"].numpy(), np.asarray(j8["scale"]),
                               rtol=1e-6)
    np.testing.assert_array_equal(
        tq.dequant_int8(t8["q"], t8["scale"]).numpy(),
        np.asarray(jq.dequant_int8(j8["q"], j8["scale"])))


def test_nf4_rejects_blocks_that_straddle_channels():
    with pytest.raises(ValueError, match="in_dim % block_size"):
        tq.quantize_nf4(torch.zeros(96, 4))
    params = {"layers": {n: {"kernel": torch.zeros(2, 96, 4)}
                         for n in tq.QUANT_KERNELS}}
    with pytest.raises(ValueError, match="in_dim % block_size"):
        tq.quantize_model_params(params, "int4")


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_model_quantize_and_dequantize_follow_the_reference(mode):
    cfg = jget_config("debug")
    jparams = jinit(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    jqp = jax.device_get(jq.quantize_model_params(jparams, mode))
    tqp = tq.quantize_model_params(params_from_jax(jax.device_get(jparams)),
                                   mode)
    for name in tq.QUANT_KERNELS:
        jl, tl = jqp["layers"][name], tqp["layers"][name]
        assert "kernel" not in tl and sorted(tl["quant"]) == sorted(jl["quant"])
        for leaf, want in jl["quant"].items():
            got = tl["quant"][leaf].numpy()
            assert got.shape == want.shape and got.dtype == want.dtype, leaf
            if want.dtype.kind == "f":
                np.testing.assert_allclose(got, want, rtol=1e-6)
            else:
                np.testing.assert_array_equal(got, want)
    # carried across by the weight bridge, leaf for leaf, bits kept
    carried = params_from_jax(jqp, tget_config("debug"), dtype=torch.bfloat16)
    for leaf, want in jqp["layers"]["q_proj"]["quant"].items():
        got = carried["layers"]["q_proj"]["quant"][leaf]
        assert got.dtype == (torch.float32 if want.dtype.kind == "f"
                             else _t(want).dtype)
        np.testing.assert_array_equal(got.numpy(), want)
    jd = jq.dequantize_model_params(
        jqp, mode, dims_fn=lambda n: jtarget_dims(cfg, n))
    td = tq.dequantize_model_params(
        carried, mode, dims_fn=lambda n: target_dims(cfg, n))
    for name in tq.QUANT_KERNELS:
        np.testing.assert_array_equal(td["layers"][name]["kernel"].numpy(),
                                      np.asarray(jd["layers"][name]["kernel"]))


def test_plain_matmuls_match_the_reference():
    rng = np.random.default_rng(1)
    w = _w(rng, (64, 96))
    x = _w(rng, (8, 64), scale=1.0)
    j8 = jq.quantize_int8(jnp.asarray(w))
    t8 = tq.quantize_int8(_t(w))
    np.testing.assert_allclose(
        tq.matmul_int8(_t(x), t8["q"], t8["scale"]).numpy(),
        np.asarray(jq.matmul_int8(jnp.asarray(x), j8["q"], j8["scale"])),
        atol=1e-4)
    jn = jq.quantize_nf4(jnp.asarray(w))
    tn = tq.quantize_nf4(_t(w))
    np.testing.assert_allclose(
        tq.matmul_nf4(_t(x), tn, (64, 96)).numpy(),
        np.asarray(jq.matmul_nf4(jnp.asarray(x), jn, (64, 96))), atol=1e-4)


@pytest.mark.parametrize("mode,K,N,lead", [
    ("int8", 128, 256, (4, 40)),   # M = 160: the reference pads rows
    ("int4", 128, 256, (4, 40)),
    ("int4", 1408, 128, (24,)),    # 22 blocks: two odd 11-block chunks
])
def test_k4_k6_plain_versions_match_the_pallas_kernels(mode, K, N, lead):
    rng = np.random.default_rng(K + N)
    w = _w(rng, (K, N))
    x = _w(rng, lead + (K,), scale=1.0)
    if mode == "int8":
        qw = jq.quantize_int8(jnp.asarray(w))
        want = jpq.pallas_matmul_int8(jnp.asarray(x), qw["q"], qw["scale"],
                                      block_m=64, block_n=128)
        before = cq.int8_matmul.launches
        got = cq.int8_matmul(_t(x), _t(qw["q"]), _t(qw["scale"]))
        assert cq.int8_matmul.launches == before  # CPU: the plain version
    else:
        qw = jq.quantize_nf4(jnp.asarray(w))
        want = jpq.pallas_matmul_nf4(jnp.asarray(x), qw, (K, N), block_m=64,
                                     block_n=128)
        before = cq.nf4_matmul.launches
        got = cq.nf4_matmul(_t(x), {k: _t(v) for k, v in qw.items()}, (K, N))
        assert cq.nf4_matmul.launches == before
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3,
                               rtol=2e-3)


@pytest.mark.parametrize("K,N,M,dtype", [
    (320, 256, 8, "float32"), (384, 512, 33, "float32"),
    (128, 384, 64, "float32"),
    (2048, 256, 8, "bfloat16"),  # tinyllama's k/v projection, as trained
], ids=["320-256-8", "384-512-33", "128-384-64", "2048-256-8-bf16"])
def test_k5_plain_version_matches_the_pallas_kernel(K, N, M, dtype):
    """bf16: both round W to bf16 and accumulate in f32, so they differ by
    the order of the f32 sums and the one rounding of the output: atol 2^-8
    + rtol 2^-7 (a bf16 ulp), the card tests' bf16 tolerance."""
    rng = np.random.default_rng(K * N + M)
    qw = jq.quantize_nf4(jnp.asarray(_w(rng, (K, N))))
    g = rng.standard_normal((M, N)).astype(np.float32)
    want = jpq._pallas_matmul_nf4_t_impl(jnp.asarray(g).astype(dtype), qw,
                                         (K, N), block_m=32, block_n=128)
    got = cq.nf4_matmul_t(_t(g).to(getattr(torch, dtype)),
                          {k: _t(v) for k, v in qw.items()}, (K, N))
    assert str(got.dtype) == f"torch.{dtype}" and want.dtype == dtype
    tol = (dict(atol=1e-3, rtol=1e-3) if dtype == "float32"
           else dict(atol=2**-8, rtol=2**-7))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(np.float32)), **tol)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_autograd_dx_matches_jax_grad_through_the_pallas_wrappers(mode):
    rng = np.random.default_rng(6)
    K, N = 128, 256
    w = _w(rng, (K, N))
    x = rng.standard_normal((8, K)).astype(np.float32)
    if mode == "int8":
        qw = jq.quantize_int8(jnp.asarray(w))
        jfn = lambda x: jpq.pallas_matmul_int8(  # noqa: E731
            x, qw["q"], qw["scale"], block_m=64, block_n=128)
        tfn = lambda x: cq.cuda_matmul_int8(  # noqa: E731
            x, _t(qw["q"]), _t(qw["scale"]))
    else:
        qw = jq.quantize_nf4(jnp.asarray(w))
        tqw = {k: _t(v) for k, v in qw.items()}
        jfn = lambda x: jpq.pallas_matmul_nf4(  # noqa: E731
            x, qw, (K, N), block_m=64, block_n=128)
        tfn = lambda x: cq.cuda_matmul_nf4(x, tqw, (K, N))  # noqa: E731
    want = jax.grad(lambda x: jnp.sum(jfn(x) ** 2))(jnp.asarray(x))
    tx = _t(x).requires_grad_()
    (got,) = torch.autograd.grad(torch.sum(tfn(tx) ** 2), [tx])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    assert not tfn(_t(x)).requires_grad  # the frozen base takes no grad


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_forward_on_a_quantized_tree_matches_the_reference(mode):
    jcfg = jget_config("debug", quantization=mode, quant_impl="pallas")
    tcfg = tget_config("debug", quantization=mode, quant_impl="pallas")
    jparams = jq.quantize_model_params(
        jinit(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32), mode)
    tparams = params_from_jax(jax.device_get(jparams), tcfg)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    jl, _ = jforward(jparams, jnp.asarray(tokens), jcfg)
    with torch.no_grad():
        tl, _ = tforward(tparams, torch.from_numpy(tokens), tcfg)
        xl, _ = tforward(tparams, torch.from_numpy(tokens),
                         dataclasses.replace(tcfg, quant_impl="xla"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-4,
                               rtol=2e-3)
    np.testing.assert_allclose(xl.numpy(), np.asarray(jl), atol=2e-4,
                               rtol=2e-3)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros((4, 64), dtype=torch.float16)
    qw = tq.quantize_nf4(torch.ones(64, 32))
    with pytest.raises(ValueError, match="CUDA"):
        cq._rows(x, 64, "x")
    with pytest.raises(ValueError, match="K % 64"):
        cq._nf4_operands(qw, (96, 32), torch.device("cpu"))
