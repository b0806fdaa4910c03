"""The port's ``parallel/`` package and its capacity check on the CPU,
against the JAX package: ``mesh_shape_for`` and the rank layout of
``Mesh`` (the reference's device order, DCN slices), ``_spec_for`` leaf
for leaf against ``param_pspecs`` on LoRA, full, int8 and nf4 trees, the
host-side batch cut (``host_rows``, ``place_batch``), the threefry draws
of a rank's block (bit-equal to the slice of ``jax.random``'s draw over
the global shape, through the plain version and an emulation of the
kernel's counter arithmetic), ``estimate_footprint``'s exact terms
against the reference's, and ``check_admission`` on the card's budget."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from datatunerx_tpu.models.config import get_config as jget_config
from datatunerx_tpu.models.llama import init_params as jinit
from datatunerx_tpu.models.lora import init_lora_params as jinit_lora
from datatunerx_tpu.ops.quant import quantize_model_params as jquantize
from datatunerx_tpu.parallel import memory as jmemory
from datatunerx_tpu.parallel.mesh import make_mesh as jmake_mesh
from datatunerx_tpu.parallel.mesh import mesh_shape_for as jmesh_shape_for
from datatunerx_tpu.parallel.sharding import param_pspecs
from datatunerx_tpu.training.train_lib import TrainConfig as JTrainConfig
from datatunerx_tpu_torch.models.config import get_config
from datatunerx_tpu_torch.operator.capacity import (
    check_admission,
    resolve_model_config,
)
from datatunerx_tpu_torch.ops import cuda_prng, prng
from datatunerx_tpu_torch.parallel import memory
from datatunerx_tpu_torch.parallel.mesh import Mesh, make_mesh, mesh_shape_for
from datatunerx_tpu_torch.parallel.sharding import (
    _spec_for,
    host_rows,
    place_batch,
    shift_labels,
)
from datatunerx_tpu_torch.training.loss import IGNORE_INDEX
from datatunerx_tpu_torch.training.train_lib import TrainConfig


# ------------------------------------------------------------------ mesh
@pytest.mark.parametrize("n,kw", [
    (8, dict(fsdp=2, tp=1, sp=1)),  # tests/test_multislice.py
    (8, {}), (8, dict(dp=2)), (8, dict(tp=2)), (8, dict(dp=2, tp=2)),
    (8, dict(fsdp=4, sp=2)), (16, dict(fsdp=16)), (4, dict(dp=1, fsdp=2,
                                                           tp=2))])
def test_mesh_shape_for_matches_the_reference(n, kw):
    assert mesh_shape_for(n, **kw) == jmesh_shape_for(n, **kw)


@pytest.mark.parametrize("n,kw", [(16, dict(dp=1, fsdp=1)),
                                  (6, dict(tp=4)), (8, dict(dp=3))])
def test_mesh_shape_for_refuses_what_the_reference_refuses(n, kw):
    with pytest.raises(ValueError) as port:
        mesh_shape_for(n, **kw)
    with pytest.raises(ValueError) as ref:
        jmesh_shape_for(n, **kw)
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("shape,dcn", [((4, 2, 1, 1), 2), ((2, 2, 2, 1), 1),
                                       ((1, 2, 2, 2), 1), ((8, 1, 1, 1), 4)])
def test_rank_layout_is_the_reference_device_order(shape, dcn, devices8):
    """Rank r sits where device r sits in the reference's mesh (dp-major;
    with DCN slices, contiguous rank ranges), and each axis group holds the
    ranks that differ only on that axis."""
    jm = jmake_mesh(shape, devices=jax.devices()[:8], dcn_dp=dcn)
    ids = np.vectorize(lambda d: d.id)(np.asarray(jm.devices))
    for r in range(8):
        m = Mesh(shape, r)
        where = tuple(int(i) for i in np.argwhere(ids == r)[0])
        assert tuple(m.coords.values()) == where
        for i, ax in enumerate(("dp", "fsdp", "tp", "sp")):
            idx = list(where)
            idx[i] = slice(None)
            assert m.ranks((ax,)) == ids[tuple(idx)].tolist()
        assert m.data_index == where[0] * shape[1] + where[1]
        assert m.data_size == shape[0] * shape[1]


def test_make_mesh_without_a_process_group():
    assert make_mesh((1, 1, 1, 1)) is None
    assert make_mesh() is None
    with pytest.raises(ValueError, match="no process group"):
        make_mesh((2, 1, 1, 1))
    with pytest.raises(ValueError, match="divisible"):
        make_mesh((3, 2, 1, 1), dcn_dp=2)


# ------------------------------------------------------------- sharding
@functools.lru_cache(maxsize=1)
def _trees():
    cfg = jget_config("debug", attention_bias=True)
    params = jinit(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    lora = jinit_lora(cfg, jax.random.PRNGKey(1), rank=4,
                      targets=("q_proj", "k_proj", "v_proj", "o_proj",
                               "gate_proj", "up_proj", "down_proj"))
    return {"full": params, "lora": lora,
            "int8": jquantize(params, "int8"),
            "nf4": jquantize(params, "int4")}


@pytest.mark.parametrize("kind", ["lora", "full", "int8", "nf4"])
def test_spec_for_matches_param_pspecs_leaf_for_leaf(kind):
    tree = _trees()[kind]
    specs = param_pspecs(tree)
    n = 0
    for (path, leaf), spec in zip(
            jax.tree_util.tree_leaves_with_path(tree),
            jax.tree_util.tree_leaves(
                specs, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))):
        keys = tuple(getattr(k, "key", k) for k in path)
        assert _spec_for(keys, leaf) == tuple(spec), keys
        n += 1
    assert n > 8


def test_place_batch_cuts_chunks_after_the_global_shift():
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 50, size=(4, 16)).astype(np.int32)
    labels[:, :3] = IGNORE_INDEX
    batch = {"input_ids": labels.copy(), "labels": labels,
             "attention_mask": np.ones_like(labels)}
    chunks = [place_batch(host_rows(batch, Mesh((2, 1, 1, 2), r)),
                      Mesh((2, 1, 1, 2), r)) for r in range(4)]
    # rank (dp d, sp j) holds rows [2d, 2d+2) and positions [8j, 8j+8)
    for r, c in enumerate(chunks):
        d, j = divmod(r, 2)
        assert int(c["seq_len"]) == 16
        np.testing.assert_array_equal(
            c["input_ids"], labels[2 * d:2 * d + 2, 8 * j:8 * j + 8])
        np.testing.assert_array_equal(
            c["labels_next"],
            shift_labels(labels)[2 * d:2 * d + 2, 8 * j:8 * j + 8])
    # the last position of chunk 0 reads chunk 1's first label
    np.testing.assert_array_equal(chunks[0]["labels_next"][:, -1],
                                  labels[0:2, 8])
    assert (chunks[1]["labels_next"][:, -1] == IGNORE_INDEX).all()


# --------------------------------------------------------------- threefry
def _emulated_counters(shape, index):
    """The kernel's counters (csrc/threefry.cu ``Index::counter``) from the
    wrapper's ``kernel_index``, in 32-bit arithmetic where the kernel uses
    it."""
    off, n1, n2, s0, s1 = cuda_prng.kernel_index(shape, index)
    n = int(np.prod(shape))
    e = np.arange(n, dtype=np.uint64)
    if n1 <= 1 and n2 == n:
        return off + e
    el = e.astype(np.uint32)
    row = el // np.uint32(n2)
    i2 = el - row * np.uint32(n2)
    i0 = row // np.uint32(n1)
    i1 = row - i0 * np.uint32(n1)
    return (np.uint64(off) + i0.astype(np.uint64) * np.uint64(s0)
            + i1.astype(np.uint64) * np.uint64(s1) + i2.astype(np.uint64))


BLOCKS = [
    ((8, 12, 16), (0, 0, 0), (8, 12, 16)),  # the whole draw
    ((8, 12, 16), (4, 0, 0), (4, 12, 16)),  # dp: a contiguous range
    ((8, 12, 16), (0, 6, 0), (8, 6, 16)),  # sp: B strided runs
    ((8, 12, 16), (2, 6, 8), (2, 6, 8)),  # dp + sp + a tp column shard
    ((8, 12, 16), (6, 0, 4), (2, 12, 4)),  # a row module's input shard
    ((6, 1, 10), (3, 0, 0), (3, 1, 10)),
]


@pytest.mark.parametrize("global_shape,starts,local", BLOCKS)
def test_threefry_block_is_the_slice_of_the_global_draw(global_shape, starts,
                                                        local):
    key = prng.fold_in(prng.PRNGKey(42), 7)
    sl = tuple(slice(s, s + n) for s, n in zip(starts, local))
    idx = prng.slice_index(global_shape, starts)
    keep = np.asarray(jax.random.bernoulli(jnp.asarray(key), 0.9,
                                           global_shape))[sl]
    noise = np.asarray(jax.random.uniform(jnp.asarray(key), global_shape,
                                          jnp.float32, -1.0, 1.0))[sl]
    np.testing.assert_array_equal(
        cuda_prng.bernoulli(key, 0.9, local, "cpu", idx).numpy(), keep)
    np.testing.assert_array_equal(
        cuda_prng.uniform(key, local, -1.0, 1.0, "cpu", idx).numpy(), noise)
    hi, lo = prng._counters(local, np.zeros(1), idx)
    want = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    np.testing.assert_array_equal(_emulated_counters(local, idx),
                                  want.reshape(-1))


def test_threefry_without_an_index_is_unchanged():
    key = prng.PRNGKey(3)
    assert cuda_prng.kernel_index((4, 5), None) == (0, 1, 20, 0, 0)
    np.testing.assert_array_equal(
        cuda_prng.bernoulli(key, 0.5, (4, 5), "cpu").numpy(),
        np.asarray(jax.random.bernoulli(jnp.asarray(key), 0.5, (4, 5))))


# ----------------------------------------------------------------- memory
GEOMETRIES = [
    ("tinyllama-1.1b", {}, "lora", dict(batch=8, seq=1024), None),
    ("tinyllama-1.1b", {"quantization": "int4"}, "lora",
     dict(batch=8, seq=1024), None),
    ("tinyllama-1.1b", {"quantization": "int8"}, "lora",
     dict(batch=8, seq=1024), None),
    ("debug", {}, "full", dict(batch=8, seq=128),
     {"dp": 2, "fsdp": 2, "tp": 2, "sp": 1}),
    ("debug", {}, "lora", dict(batch=8, seq=128),
     {"dp": 1, "fsdp": 4, "tp": 1, "sp": 2}),
]


@pytest.mark.parametrize("preset,over,kind,geo,mesh", GEOMETRIES)
def test_footprint_exact_terms_equal_the_reference(preset, over, kind, geo,
                                                   mesh):
    """params, LoRA and gradients byte for byte; the optimizer state but
    for optax's step counters (int32 scalars the port keeps on the host);
    with ``activations="reference"`` the activation, logit and gather terms
    are the reference's formulas. (The port's own activation term is
    pinned below: it counts the port's remat, which saves more where the
    base is full precision and less where a quantized projection runs a
    custom kernel.)"""
    jcfg = jget_config(preset, attention_impl="flash", remat="dots", **over)
    cfg = get_config(preset, attention_impl="flash", remat="dots", **over)
    tkw = dict(finetuning_type=kind, lora_rank=8,
               lora_targets=("q_proj", "v_proj"))
    ref = jmemory.estimate_footprint(jcfg, JTrainConfig(**tkw),
                                     mesh_shape=mesh, **geo)
    port = memory.estimate_footprint(cfg, TrainConfig(**tkw),
                                     mesh_shape=mesh, **geo)
    as_ref = memory.estimate_footprint(cfg, TrainConfig(**tkw),
                                       mesh_shape=mesh,
                                       activations="reference", **geo)
    assert (port.params, port.lora, port.grads) == (ref.params, ref.lora,
                                                    ref.grads)
    assert 0 <= ref.opt_state - port.opt_state <= 16
    assert (as_ref.activations, as_ref.logits, as_ref.fsdp_gather) == (
        ref.activations, ref.logits, ref.fsdp_gather)
    assert port.logits > ref.logits
    assert port.fsdp_gather >= ref.fsdp_gather


def test_port_activation_term_pins_its_formula():
    """The port's remat term at phase 5's geometry (tinyllama LoRA r8 on
    q_proj,v_proj, 8 x 1024, dots): boundaries + every mm output + the
    norms' f32 live set + attention + MLP, times the margin; logits 14
    bytes an element."""
    cfg = get_config("tinyllama-1.1b", attention_impl="flash", remat="dots")
    fp = memory.estimate_footprint(
        cfg, TrainConfig(lora_rank=8, lora_targets=("q_proj", "v_proj")),
        batch=8, seq=1024)
    tok, L, D, F = 8 * 1024, 22, 2048, 5632
    saved = (2048 + 2 * 256 + 2 * D + 2 * F) + (8 + 2048) + (8 + 256)
    act = (2 * L * tok * D * 2 + L * tok * saved * 2 + 6 * tok * D * 4
           + 4 * tok * (2048 + 2 * 256) * 2 + 6 * tok * F * 2)
    assert fp.activations == int(act * memory.ACTIVATION_MARGIN)
    assert fp.logits == tok * 32000 * 14


def test_budget_is_named_by_card():
    assert memory.hbm_budget("h100-80gb") == int(85_017_493_504 * 0.94)
    assert memory.hbm_budget("v5e") == jmemory.hbm_budget("v5e")
    with pytest.raises(KeyError):
        memory.hbm_budget("v99")


_HP = {"loRA_R": "8", "loRA_Alpha": "32", "batchSize": "4",
       "blockSize": "1024", "PEFT": "true", "int4": "true",
       "attention": "flash"}


@pytest.mark.parametrize("model,hp,n,admit", [
    ("preset:llama2-7b", dict(_HP), 1, True),
    # full-parameter 7B: bf16 params and moments, f32 grads (67 GB) fit an
    # 80 GB card only at a small batch; 16 x 1024 does not
    ("preset:llama2-7b", dict(_HP, PEFT="false", int4="false",
                              batchSize="16"), 1, False),
    ("preset:llama2-7b", dict(_HP, meshShape="fsdp=16"), 4, False),
    ("/models/does-not-exist", dict(_HP), 1, True),
    ("preset:llama2-7b", dict(_HP, batchSize="not-a-number"), 1, True),
    ("preset:llama2-7b", dict(_HP, PEFT="false", int4="false",
                              meshShape="fsdp=16", batchSize="1"), 16, True),
    ("preset:llama2-7b", dict(_HP, batchSize="4"), 4, True),
    ("preset:llama2-7b", dict(_HP, batchSize="64"), 1, False),
    ("preset:llama2-7b", dict(_HP, batchSize="64"), 4, False),
    ("preset:mistral-7b", {"PEFT": "false", "batchSize": "1",
                           "blockSize": "1024", "attention": "flash",
                           "meshShape": "fsdp=16"}, 16, True),
    ("preset:mistral-7b", {"PEFT": "false", "batchSize": "1",
                           "blockSize": "1024", "attention": "flash",
                           "meshShape": "dp=1"}, 16, False),
])
def test_admission_cases_on_the_card_budget(model, hp, n, admit):
    """``tests/test_memory.py``'s admission cases against an 80 GB card."""
    denied = check_admission(model, hp, n_chips=n, generation="h100-80gb")
    assert (denied is None) == admit, denied
    if denied is not None:
        reason, breakdown = denied
        assert "tile" in reason or ("exceeds" in reason
                                    and "h100-80gb" in reason)


def test_resolve_model_config_from_dir(tmp_path):
    import json

    (tmp_path / "config.json").write_text(json.dumps(
        {"vocab_size": 128, "hidden_size": 64, "intermediate_size": 128,
         "num_layers": 2, "num_heads": 4, "num_kv_heads": 2,
         "head_dim": "None", "unknown_field": 1}))
    cfg = resolve_model_config(str(tmp_path), {"attention_impl": "flash"})
    assert cfg.hidden_size == 64 and cfg.head_dim == 16
    assert cfg.attention_impl == "flash"
    assert resolve_model_config("s3://bucket/model") is None
