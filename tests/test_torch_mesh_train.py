"""The port's ``Trainer`` under a mesh, run as gloo processes on the CPU,
against the JAX ``Trainer`` on the same mesh over the virtual CPU devices:
two ``train_step``s from the same params, adapters and batches (loss rtol
1e-5, step 2 rtol 1e-4; trained leaves atol 5e-5, the tolerances of
``tests/test_training.py``'s sharded cases), with LoRA dropout 0.1 and
NEFTune alpha 5, whose bits each rank draws as its block of the global
draw (the offset threefry twin).

SFT meshes: (2,1,1,1), the same as two DCN slices, (1,1,1,2) with
``--attention ring``, a QLoRA int4 base under dp 2 (the kernels' plain
versions) and under tp 2 (dequantized, ``quant_impl xla``), full
finetuning under fsdp 2; (2,2,1,1) with gradient accumulation (4 ranks).
Stages and optimizers: DPO under sp 2 with the ring, RM under sp 2 and tp
2 with flash, freeze under fsdp 2, adafactor (whole leaves) under fsdp 2
and lion under tp 2, each also equal to the port's one-device ``Trainer``.
The sharded run's checkpoint loads into a one-device ``Trainer``."""

import concurrent.futures

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from datatunerx_tpu.data.preprocess import pad_to_block as jpad
from datatunerx_tpu.models.config import get_config as jget_config
from datatunerx_tpu.models.llama import init_params as jinit
from datatunerx_tpu.ops.quant import quantize_model_params as jquantize
from datatunerx_tpu.parallel.mesh import make_mesh as jmake_mesh
from datatunerx_tpu.training.train_lib import TrainConfig as JTrainConfig
from datatunerx_tpu.training.train_lib import Trainer as JTrainer
from datatunerx_tpu_torch.models.config import get_config as tget_config
from datatunerx_tpu_torch.models.convert import lora_from_jax, params_from_jax
from datatunerx_tpu_torch.training.checkpoint import CheckpointManager
from datatunerx_tpu_torch.training.loss import IGNORE_INDEX
from datatunerx_tpu_torch.training.train_lib import TrainConfig, Trainer
from test_torch_gloo import World
from test_torch_parallel_workers import _to_numpy, train_many

B, T = 8, 64
TARGETS = ("q_proj", "v_proj", "o_proj", "down_proj")


def _batch(seed, accum=1):
    rng = np.random.default_rng(seed)
    exs = []
    for _ in range(B):
        n = int(rng.integers(20, T))
        ids = rng.integers(3, 512, size=n).tolist()
        p = int(rng.integers(1, n - 4))
        exs.append({"input_ids": ids, "labels": [IGNORE_INDEX] * p + ids[p:],
                    "attention_mask": [1] * n})
    b = jpad(exs, T, use_native=False)
    if accum > 1:
        b = {k: v.reshape(accum, -1, T) for k, v in b.items()}
    return b


WIDE = dict(hidden_size=128, intermediate_size=256, head_dim=32)
# name, mesh shape, finetuning type (+quantization[/quant impl]), attention,
# extras: dcn, accum, cfg (config overrides), stage, optimizer
SFT2 = [
    ("dp", (2, 1, 1, 1), "lora", "xla", {}),
    ("dcn", (2, 1, 1, 1), "lora", "xla", dict(dcn=2)),
    ("sp-ring", (1, 1, 1, 2), "lora", "ring", {}),
    ("int4-dp", (2, 1, 1, 1), "lora+int4", "flash", {}),
    # nf4 blocks stay whole over tp; the model cuts each rank's shard
    # (at D 128: a row shard of o_proj must hold whole 64-blocks)
    ("int4-tp", (1, 1, 2, 1), "lora+int4/xla", "xla", dict(cfg=WIDE)),
    ("full-fsdp", (1, 2, 1, 1), "full", "xla", {}),
]
# the stages and optimizers: DPO and RM where a pair's sums span the sp
# ranks (sp without the ring gathers q/k/v over sp and runs flash over the
# whole sequence), RM under tp with flash, freeze, adafactor on whole
# leaves under fsdp and lion under tp
STAGES2 = [
    ("dpo-sp-ring", (1, 1, 1, 2), "lora", "ring", dict(stage="dpo")),
    ("rm-sp-flash", (1, 1, 1, 2), "lora", "flash", dict(stage="rm")),
    ("rm-tp-flash", (1, 1, 2, 1), "lora", "flash", dict(stage="rm")),
    ("freeze-fsdp", (1, 2, 1, 1), "freeze", "xla", {}),
    ("adafactor-fsdp", (1, 2, 1, 1), "lora", "flash",
     dict(optimizer="adafactor")),
    ("lion-tp", (1, 1, 2, 1), "lora", "xla", dict(optimizer="lion")),
]
CASES4 = [("dp-fsdp-accum", (2, 2, 1, 1), "lora", "flash", dict(accum=2))]


def _pairs(seed):
    rng = np.random.default_rng(seed)
    out = {}
    for side in ("chosen", "rejected"):
        ids = rng.integers(3, 512, size=(4, T)).astype(np.int32)
        lab = ids.copy()
        lab[:, :20] = IGNORE_INDEX
        lab[:, 50 + seed % 5:] = IGNORE_INDEX
        out[f"{side}_ids"], out[f"{side}_labels"] = ids, lab
    return out


def _setup(case, tmp=None):
    """(the port's spec, the JAX trainer and its first state): the same
    params, adapters and batches for both."""
    name, shape, kind, impl, extra = case
    kind, _, quant = kind.partition("+")
    quant, _, impl_q = quant.partition("/")
    over = dict(extra.get("cfg", {}))
    if quant:
        over.update(quantization=quant, quant_impl=impl_q or "pallas")
    stage, accum, dcn = (extra.get("stage", "sft"), extra.get("accum", 1),
                         extra.get("dcn", 1))
    jcfg = jget_config("debug", attention_impl=impl, remat="full", **over)
    common = dict(finetuning_type=kind, stage=stage,
                  optimizer=extra.get("optimizer", "adamw"),
                  lora_dropout=0.1, neftune_alpha=5.0, learning_rate=1e-3,
                  total_steps=10, grad_accum=accum, lora_targets=TARGETS,
                  weight_decay=0.01, num_layer_trainable=1)
    jparams = jinit(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    if quant:
        jparams = jquantize(jparams, quant)
    host_params = jax.device_get(jparams)  # the step donates the state
    n = int(np.prod(shape))
    mesh = jmake_mesh(shape, devices=jax.devices()[:n], dcn_dp=dcn)
    jtr = JTrainer(jcfg, JTrainConfig(compute_dtype=jnp.float32, **common),
                   mesh=mesh)
    jstate = jtr.init_state(jparams, jax.random.PRNGKey(1))
    lora = None
    if kind == "lora":  # B starts at 0: give it values so A's grads move
        rng = np.random.default_rng(5)
        lora = jax.device_get(jstate.lora)
        for ab in lora["layers"].values():
            ab["b"] = (rng.normal(size=ab["b"].shape) * 0.05).astype(
                np.float32)
        jl = jax.tree_util.tree_map(jnp.asarray, lora)
        jstate = jstate.replace(lora=jl, opt_state=jtr.optimizer.init(jl))
    batches = ([_pairs(1), _pairs(2)] if stage != "sft"
               else [_batch(11, accum), _batch(12, accum)])
    tcfg = tget_config("debug", attention_impl=impl, remat="full", **over)
    tlora = None
    if lora is not None:
        tlora = lora_from_jax(lora, tcfg)
        if "v_head" in lora:  # rm's value head
            tlora["v_head"] = torch.from_numpy(np.array(lora["v_head"]))
    spec = dict(
        preset="debug", cfg=dict(attention_impl=impl, remat="full", **over),
        train=common, shape=shape, dcn=dcn, steps=2, batches=batches,
        params=_to_numpy(params_from_jax(host_params, tcfg)),
        lora=_to_numpy(tlora) if tlora is not None else None,
        checkpoint=None if tmp is None else str(tmp / name))
    return spec, (jtr, jstate)


def _reference(spec, jax_side):
    """The JAX trainer's steps: metrics and the trained tree."""
    jtr, jstate = jax_side
    want = {"loss": [], "grad_norm": []}
    for b in spec["batches"]:
        # the same input shardings for both steps: one compile of the step
        jstate, m = jtr.train_step(jtr.place_state(jstate), b)
        want["loss"].append(float(m["loss"]))
        want["grad_norm"].append(float(m["grad_norm"]))
    want["trainable"] = jax.device_get(
        jstate.lora if spec["lora"] is not None else jstate.params)
    return want


def _run(cases, n, tmp=None, **extra):
    """The port's world runs while the reference steps here: (the
    references, the specs, each rank's results); ``extra`` goes into every
    spec."""
    setups = [(dict(spec, **extra), jax_side)
              for spec, jax_side in (_setup(c, tmp) for c in cases)]
    world = World(train_many, n, [spec for spec, _ in setups], timeout=300)
    # the references compile concurrently (XLA compiles outside the GIL)
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        wants = list(pool.map(lambda s: _reference(*s), setups))
    return wants, [spec for spec, _ in setups], world.result()


def _compare(name, want, got):
    np.testing.assert_allclose(got["loss"][0], want["loss"][0], rtol=1e-5,
                               err_msg=name)
    np.testing.assert_allclose(got["loss"][1], want["loss"][1], rtol=1e-4,
                               err_msg=name)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=1e-4, err_msg=name)
    for path, leaf in jax.tree_util.tree_leaves_with_path(want["trainable"]):
        node = got["trainable"]
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node, np.asarray(leaf, np.float32),
                                   atol=5e-5, err_msg=f"{name} {path}")


def _compare_local(name, want, got):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5,
                               err_msg=name)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=1e-4, err_msg=name)

    def walk(w, g, path):
        if isinstance(w, dict):
            for k in w:
                walk(w[k], g[k], path + (k,))
        else:
            np.testing.assert_allclose(g, w, atol=5e-5,
                                       err_msg=f"{name} {path}")

    walk(want["trainable"], got["trainable"], ())


def test_stages_and_optimizers_under_a_mesh_equal_one_device(devices8):
    # rank 0 also runs the port's one-device Trainer from the same state
    # and batches
    wants, _, ranks = _run(STAGES2, 2, one_device=True)
    for (name, *_), want, *got in zip(STAGES2, wants, *ranks):
        _compare_local(f"{name} one device", got[0]["one_device"], got[0])
        for r in got:
            _compare(name, want, r)


def test_two_rank_meshes_match_the_reference(devices8, tmp_path):
    wants, specs, ranks = _run(SFT2, 2, tmp_path)
    for (name, *_), want, *got in zip(SFT2, wants, *ranks):
        for r in got:  # every rank ends with the same whole tree
            _compare(name, want, r)
    # the sharded run's state.pt is a one-device checkpoint
    i = [c[0] for c in SFT2].index("full-fsdp")
    want, spec = wants[i], specs[i]
    tcfg = tget_config("debug", attention_impl="xla", remat="full")
    tr = Trainer(tcfg, TrainConfig(compute_dtype=torch.float32,
                                   **spec["train"]), device="cpu")
    template = tr.init_state(_tree(spec["params"]), 1)
    restored, step = CheckpointManager(str(tmp_path / "full-fsdp")).restore(
        template)
    assert step == 2 and restored.step == 2
    for path, leaf in jax.tree_util.tree_leaves_with_path(want["trainable"]):
        node = restored.params
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node.float().numpy(), np.asarray(leaf),
                                   atol=5e-5)
    # one more step on one device runs from the restored sharded state
    _, m = tr.train_step(restored, spec["batches"][0])
    assert np.isfinite(float(m["loss"]))


def _tree(t):
    if isinstance(t, dict):
        return {k: _tree(v) for k, v in t.items()}
    return torch.from_numpy(np.array(t))


def test_four_rank_mesh_with_grad_accum_matches_the_reference(devices8):
    wants, _, ranks = _run(CASES4, 4)
    for (name, *_), want, *got in zip(CASES4, wants, *ranks):
        for r in got:
            _compare(name, want, r)
