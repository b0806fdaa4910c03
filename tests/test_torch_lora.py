"""The port's LoRA against the JAX package's at float32 on the CPU: init
shapes and bounds, ``merge_lora``, and the model forward with adapters
(xla and flash attention, padded and packed batches, remat on). Tolerance:
merge atol 1e-6 (one f32 einsum over r=8); forward logits atol 2e-4 /
rtol 2e-3, the tolerance tests/test_model_parity.py holds logits to."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datatunerx_tpu.data.preprocess import pack_to_block as jpack
from datatunerx_tpu.models.config import get_config as jget_config
from datatunerx_tpu.models.llama import forward as jforward
from datatunerx_tpu.models.llama import init_params as jinit
from datatunerx_tpu.models.lora import init_lora_params as jinit_lora
from datatunerx_tpu.models.lora import merge_lora as jmerge
from datatunerx_tpu_torch.models.config import get_config as tget_config
from datatunerx_tpu_torch.models.convert import lora_from_jax, params_from_jax
from datatunerx_tpu_torch.models.llama import forward as tforward
from datatunerx_tpu_torch.models.lora import (
    init_lora_params,
    lora_scaling,
    merge_lora,
    num_lora_params,
    target_dims,
)

TOL = dict(atol=2e-4, rtol=2e-3)
TARGETS = ("q_proj", "v_proj", "o_proj", "up_proj")


def test_init_shapes_bounds_and_zero_b():
    """PEFT's init from the threefry twin: bit-equal to the reference's
    ``init_lora_params`` under the same key (an int seed is
    ``PRNGKey(seed)``)."""
    cfg = tget_config("debug")
    lora = init_lora_params(cfg, 3, rank=4, targets=TARGETS)
    assert sorted(lora["layers"]) == sorted(TARGETS)
    for name, ab in lora["layers"].items():
        d_in, d_out = target_dims(cfg, name)
        assert ab["a"].shape == (cfg.num_layers, d_in, 4)
        assert ab["b"].shape == (cfg.num_layers, 4, d_out)
        assert not ab["b"].any()
        bound = 1.0 / math.sqrt(d_in)
        assert ab["a"].abs().max() <= bound
        assert ab["a"].abs().max() > 0.8 * bound  # uniform over the range
    again = init_lora_params(cfg, 3, rank=4, targets=TARGETS)
    assert all(torch.equal(again["layers"][t]["a"], lora["layers"][t]["a"])
               for t in TARGETS)
    jl = jinit_lora(jget_config("debug"), jax.random.PRNGKey(3), rank=4,
                    targets=TARGETS)
    assert num_lora_params(lora) == sum(
        x.size for x in jax.tree_util.tree_leaves(jl))
    for t in TARGETS:
        for leaf in ("a", "b"):
            np.testing.assert_array_equal(lora["layers"][t][leaf].numpy(),
                                          np.asarray(jl["layers"][t][leaf]))
    key = jax.random.fold_in(jax.random.PRNGKey(9), 0x10AA)
    jl = jinit_lora(jget_config("tinyllama-1.1b"), key, rank=8)
    tl = init_lora_params(tget_config("tinyllama-1.1b"), np.asarray(key),
                          rank=8)
    for t in ("q_proj", "v_proj"):
        np.testing.assert_array_equal(tl["layers"][t]["a"].numpy(),
                                      np.asarray(jl["layers"][t]["a"]))
    with pytest.raises(ValueError, match="invalid lora target"):
        init_lora_params(cfg, targets=("nope",))


def _jax_model(seed=0):
    jcfg = jget_config("debug")
    jparams = jinit(jcfg, jax.random.PRNGKey(seed))
    jlora = jinit_lora(jcfg, jax.random.PRNGKey(seed + 1), rank=8,
                       targets=TARGETS)
    rng = np.random.default_rng(seed)
    jlora = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.normal(size=x.shape) * 0.05, jnp.float32),
        jlora)  # non-zero B so the delta shows
    return jcfg, jparams, jlora


def test_merge_matches_reference():
    jcfg, jparams, jlora = _jax_model()
    tcfg = tget_config("debug")
    scale = lora_scaling(16, 8)
    want = jmerge(jparams, jlora, scale)
    got = merge_lora(params_from_jax(jax.device_get(jparams), tcfg),
                     lora_from_jax(jax.device_get(jlora), tcfg), scale)
    for name in TARGETS:
        np.testing.assert_allclose(
            got["layers"][name]["kernel"].numpy(),
            np.asarray(want["layers"][name]["kernel"]), atol=1e-6)
    np.testing.assert_array_equal(got["layers"]["k_proj"]["kernel"].numpy(),
                                  np.asarray(jparams["layers"]["k_proj"]
                                             ["kernel"]))


@pytest.mark.parametrize("impl,packed", [("xla", False), ("xla", True),
                                         ("flash", False), ("flash", True)])
def test_lora_forward_matches_reference(impl, packed):
    jcfg, jparams, jlora = _jax_model(1)
    jcfg = jget_config("debug", attention_impl=impl, remat="full")
    tcfg = tget_config("debug", attention_impl=impl, remat="dots")
    rng = np.random.default_rng(2)
    T = 128
    if packed:
        exs = []
        for _ in range(12):
            ids = rng.integers(3, 500, size=int(rng.integers(10, 60))).tolist()
            exs.append({"input_ids": ids, "labels": ids})
        batch = jpack(exs, T, use_native=False)
        batch = {k: v[:2] for k, v in batch.items()}
        kw = {k: batch[k] for k in ("attention_mask", "segment_ids",
                                    "positions")}
        tokens = batch["input_ids"]
    else:
        tokens = rng.integers(0, 500, size=(2, T)).astype(np.int32)
        kw = {}
    jl, _ = jforward(jparams, jnp.asarray(tokens), jcfg,
                     lora=(jlora, 2.0),
                     **{k: jnp.asarray(v) for k, v in kw.items()})
    tparams = params_from_jax(jax.device_get(jparams), tcfg)
    tlora = lora_from_jax(jax.device_get(jlora), tcfg)
    with torch.enable_grad():  # remat engages only where grads are taken
        tl, _ = tforward(tparams, torch.from_numpy(tokens), tcfg,
                         lora=(tlora, 2.0),
                         **{k: torch.from_numpy(v) for k, v in kw.items()})
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **TOL)
