"""The port's llama forward held against the JAX package at float32 on the
CPU, with the JAX weights moved across by ``params_from_jax``: a cache-less
call, and a paged cache driven through a two-chunk prefill (the multi-token
kernel path, K8) and four decode steps (the decode kernel path, K7) — JAX
with ``paged_kernel=True`` runs its Pallas kernels in interpret mode, the
port runs the kernels' plain versions on the CPU — plus the same on the
gather path. Tolerance: atol 2e-4, rtol 2e-3, the one
tests/test_model_parity.py holds logits to (f32 sums in another order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datatunerx_tpu.models.config import get_config as jget_config
from datatunerx_tpu.models.llama import forward as jforward
from datatunerx_tpu.models.llama import init_params as jinit
from datatunerx_tpu.ops.paged_attention import init_paged_cache as jinit_cache
from datatunerx_tpu_torch.models.config import get_config as tget_config
from datatunerx_tpu_torch.models.convert import params_from_jax
from datatunerx_tpu_torch.models.llama import forward as tforward
from datatunerx_tpu_torch.ops.paged_attention import (
    init_paged_cache as tinit_cache,
)

TOL = dict(atol=2e-4, rtol=2e-3)


@pytest.fixture(scope="module")
def weights():
    jcfg = jget_config("debug")
    jparams = jinit(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tparams = params_from_jax(jax.device_get(jparams), tget_config("debug"))
    return jcfg, jparams, tparams


def test_params_from_jax_keeps_the_tree(weights):
    jcfg, jparams, tparams = weights
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(flat_j) == sum(1 for _ in _leaves(tparams))
    for path, leaf in flat_j:
        node = tparams
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    with pytest.raises(ValueError, match="does not fit"):
        params_from_jax(jax.device_get(jparams), tget_config("tinyllama-1.1b"))


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def test_cacheless_forward_matches_reference(weights):
    jcfg, jparams, tparams = weights
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab_size, size=(2, 24)).astype(np.int32)
    mask = np.ones((2, 24), np.int32)
    mask[1, :5] = 0  # a left-padded row
    positions = np.stack([np.arange(24), np.maximum(np.arange(24) - 5, 0)])
    positions = positions.astype(np.int32)
    jl, _ = jforward(jparams, jnp.asarray(tokens), jcfg,
                     positions=jnp.asarray(positions),
                     attention_mask=jnp.asarray(mask))
    tl, _ = tforward(tparams, torch.from_numpy(tokens), tget_config("debug"),
                     positions=torch.from_numpy(positions),
                     attention_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("kernel", [True, False], ids=["kernel", "gather"])
def test_paged_prefill_then_decode_matches_reference(weights, kernel):
    jcfg, jparams, tparams = weights
    jcfg = dataclasses.replace(jcfg, paged_kernel=kernel)
    tcfg = dataclasses.replace(tget_config("debug"), paged_kernel=kernel)
    slots, NB, bs, nbps = 2, 8, 16, 4
    tables = np.array([[3, 0, 5, -1], [1, 6, 2, -1]], np.int32)
    jc = jinit_cache(jcfg, slots, NB, bs, nbps, dtype=jnp.float32)
    jc["block_tables"] = jnp.asarray(tables)
    tc = tinit_cache(tcfg, slots, NB, bs, nbps, dtype=torch.float32)
    tc["block_tables"] = torch.from_numpy(tables.copy())
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, jcfg.vocab_size, size=(slots, 32)).astype(np.int32)
    mask = np.ones((slots, 32), np.int32)
    mask[1, :3] = 0  # slot 1 is left-padded, as prepare_prompt pads
    pos = np.stack([np.arange(32), np.maximum(np.arange(32) - 3, 0)])
    pos = pos.astype(np.int32)
    for lo in (0, 16):  # two prefill chunks of 16
        sl = slice(lo, lo + 16)
        jl, jc = jforward(jparams, jnp.asarray(prompt[:, sl]), jcfg,
                          positions=jnp.asarray(pos[:, sl]),
                          attention_mask=jnp.asarray(mask[:, sl]), cache=jc)
        tl, tc = tforward(tparams, torch.from_numpy(prompt[:, sl]), tcfg,
                          positions=torch.from_numpy(pos[:, sl].copy()),
                          attention_mask=torch.from_numpy(mask[:, sl].copy()),
                          cache=tc)
        live = mask[:, sl].astype(bool)
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   **TOL)
    next_pos = pos[:, -1] + 1
    for step in range(4):  # decode steps (T == 1)
        tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        p = (next_pos + step)[:, None].astype(np.int32)
        jl, jc = jforward(jparams, jnp.asarray(tok), jcfg,
                          positions=jnp.asarray(p), cache=jc)
        tl, tc = tforward(tparams, torch.from_numpy(tok), tcfg,
                          positions=torch.from_numpy(p), cache=tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    np.testing.assert_array_equal(tc["pos"][:-1].numpy(),
                                  np.asarray(jc["pos"]))
    np.testing.assert_allclose(tc["k"][:, :-1].numpy(), np.asarray(jc["k"]),
                               **TOL)
