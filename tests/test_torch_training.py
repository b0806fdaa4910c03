"""The port's training pieces against the JAX package on the CPU at float32:
the causal-LM loss, every optimizer under all six schedules against optax
over three updates (adafactor and lion also with a factored leaf and in
bf16), and one ``Trainer.train_step`` (lora, freeze, full; grad_accum 1
and 2; xla and flash attention; padded and packed batches) from the same
params, adapters and batch, with LoRA dropout 0.1 and NEFTune alpha 5: the
masks and the noise are the reference's bits (the threefry twin over its
key chain).

Tolerances (f32 sums in another order): loss rtol 1e-5; optimizer
trajectories rtol 1e-5 / atol 1e-7 (optax evaluates the schedule in f32,
the port in double); grad_norm rtol 1e-4; updated leaves atol 1e-5 (1 % of
the 1e-3 learning rate: Adam's first step maps g to lr*g/(|g| + 1e-8),
which turns f32 summation noise in a gradient of |g| ~ 1e-8 into a visible
fraction of lr) + rtol 1e-4. The QLoRA cases quantize the base with the
reference (nf4 and int8; its Pallas kernels run in interpret mode) and carry
the bytes across. adafactor and lion in bf16: rtol 1e-2 / atol 2^-8 (a
bf16 ulp at magnitude 1; a parameter that an update brings near zero keeps
the absolute error of the ulp it parted by)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datatunerx_tpu.data.preprocess import pack_to_block as jpack
from datatunerx_tpu.data.preprocess import pad_to_block as jpad
from datatunerx_tpu.models.config import get_config as jget_config
from datatunerx_tpu.models.llama import init_params as jinit
from datatunerx_tpu.ops.quant import quantize_model_params as jquantize
from datatunerx_tpu.training import optimizer as jopt
from datatunerx_tpu.training.loss import causal_lm_loss as jloss
from datatunerx_tpu.training.train_lib import TrainConfig as JTrainConfig
from datatunerx_tpu.training.train_lib import Trainer as JTrainer
from datatunerx_tpu_torch.models import llama as tllama
from datatunerx_tpu_torch.models.config import get_config as tget_config
from datatunerx_tpu_torch.models.convert import lora_from_jax, params_from_jax
from datatunerx_tpu_torch.training import optimizer as topt
from datatunerx_tpu_torch.training.loss import IGNORE_INDEX
from datatunerx_tpu_torch.training.loss import causal_lm_loss as tloss
from datatunerx_tpu_torch.training.train_lib import TrainConfig, Trainer

LEAF_TOL = dict(atol=1e-5, rtol=1e-4)


def test_causal_lm_loss_matches_reference():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 17, 50)).astype(np.float32)
    labels = rng.integers(0, 50, size=(3, 17)).astype(np.int32)
    labels[:, :5] = IGNORE_INDEX
    labels[2] = IGNORE_INDEX  # an all-masked row
    js, jn = jloss(jnp.asarray(logits), jnp.asarray(labels))
    ts, tn = tloss(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-5)
    assert int(tn) == int(jn)


@pytest.mark.parametrize("name", ["adamw", "adam", "sgd"])
@pytest.mark.parametrize("schedule", list(topt.SCHEDULERS))
def test_optimizer_and_schedule_follow_optax(name, schedule):
    rng = np.random.default_rng(len(name) + len(schedule))
    params = {"a": rng.normal(size=(4, 6)).astype(np.float32),
              "b": {"c": rng.normal(size=(5,)).astype(np.float32)}}
    grads = [{"a": rng.normal(size=(4, 6)).astype(np.float32) * s,
              "b": {"c": rng.normal(size=(5,)).astype(np.float32) * s}}
             for s in (0.1, 3.0, 0.5)]  # the middle one is clipped
    kw = dict(weight_decay=0.01, max_grad_norm=1.0)
    jo = jopt.make_optimizer(name, jopt.make_schedule(schedule, 1e-2, 10,
                                                      0.2), **kw)
    to = topt.make_optimizer(name, topt.make_schedule(schedule, 1e-2, 10,
                                                      0.2), **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = topt.tree_map(torch.from_numpy, params)
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        ju, js = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, ju)
        tu, ts = to.update(topt.tree_map(torch.from_numpy, g), ts, tp)
        tp = topt.tree_map(lambda p, u: p + u, tp, tu)
        for a, b in zip(topt.tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-7)
    jsched = jopt.make_schedule(schedule, 1e-2, 10, 0.2)
    tsched = topt.make_schedule(schedule, 1e-2, 10, 0.2)
    for step in range(12):
        np.testing.assert_allclose(tsched(step), float(jsched(step)),
                                   rtol=1e-6, atol=1e-9)


def test_adafactor_and_lion_are_built():
    for name, kind in (("adafactor", "adafactor"), ("lion", "lion")):
        opt = topt.make_optimizer(name, lambda s: 1e-3, weight_decay=0.1)
        assert opt.kind == kind
        state = opt.init({"w": torch.zeros((3, 4))})
        assert state["count"] == 0
    assert topt.factored_dims((2, 160, 130)) == (2, 1)
    assert topt.factored_dims((4096, 127)) is None
    assert topt.factored_dims((512,)) is None


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["adafactor", "lion"])
@pytest.mark.parametrize("schedule", list(topt.SCHEDULERS))
def test_adafactor_and_lion_follow_optax(name, schedule, dtype):
    """Three updates from the same params and grads: a factored leaf
    (160 x 130 over a stacked axis), an unfactored vector and a small
    matrix whose parameter RMS sits under adafactor's 1e-3 floor; in f32
    the middle step is clipped by the global norm. State dtypes stay."""
    rng = np.random.default_rng(len(name) * 7 + len(schedule))
    params = {"a": rng.normal(size=(2, 160, 130)).astype(np.float32),
              "b": {"c": rng.normal(size=(5,)).astype(np.float32),
                    "d": (rng.normal(size=(4, 6)) * 1e-4).astype(
                        np.float32)}}
    # bf16: no step reaches the clip. optax sums a bf16 norm in bf16, in
    # XLA's reduction order; the port sums it in f32, so a clipped bf16
    # step may part by an ulp, which lion's sign turns into lr
    scales = (0.001, 0.004, 0.002) if dtype == "bf16" else (0.01, 3.0, 0.05)
    grads = [{"a": rng.normal(size=(2, 160, 130)).astype(np.float32) * s,
              "b": {"c": rng.normal(size=(5,)).astype(np.float32) * s,
                    "d": rng.normal(size=(4, 6)).astype(np.float32) * s}}
             for s in scales]
    jd, td = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
              else (jnp.float32, torch.float32))
    tol = (dict(rtol=1e-2, atol=2 ** -8) if dtype == "bf16"
           else dict(rtol=1e-5, atol=1e-7))
    kw = dict(weight_decay=0.01, max_grad_norm=1.0)
    jo = jopt.make_optimizer(name, jopt.make_schedule(schedule, 1e-2, 10,
                                                      0.2), **kw)
    to = topt.make_optimizer(name, topt.make_schedule(schedule, 1e-2, 10,
                                                      0.2), **kw)
    jput = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda x: jnp.asarray(x, jd), t)
    tput = lambda t: topt.tree_map(  # noqa: E731
        lambda x: torch.from_numpy(x).to(td), t)
    jp, tp = jput(params), tput(params)
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        ju, js = jo.update(jput(g), js, jp)
        jp = jax.tree_util.tree_map(lambda p, u: (p + u).astype(p.dtype),
                                    jp, ju)
        tu, ts = to.update(tput(g), ts, tp)
        tp = topt.tree_map(lambda p, u: (p + u).to(p.dtype), tp, tu)
        for a, b in zip(topt.tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
            assert a.dtype == td
            np.testing.assert_allclose(a.float().numpy(),
                                       np.asarray(b, np.float32), **tol)
    moments = ts["factored"] if name == "adafactor" else ts["mu"]
    assert all(m.dtype == td for m in topt.tree_leaves(moments))
    assert ts["count"] == 3


def _examples(rng, n, vocab, max_len):
    out = []
    for _ in range(n):
        L = int(rng.integers(8, max_len))
        ids = rng.integers(3, vocab, size=L).tolist()
        p = int(rng.integers(1, L - 2))
        out.append({"input_ids": ids,
                    "labels": [IGNORE_INDEX] * p + ids[p:],
                    "attention_mask": [1] * L})
    return out


def _batch(seed, B, T, vocab, packed, accum):
    rng = np.random.default_rng(seed)
    if packed:
        exs = _examples(rng, 6 * B, vocab, T // 2)
        b = jpack(exs, T, use_native=False)
        b = {k: v[:B] for k, v in b.items()}
        assert b["input_ids"].shape[0] == B
    else:
        b = jpad(_examples(rng, B, vocab, T), T, use_native=False)
    if accum > 1:
        b = {k: v.reshape(accum, -1, T) for k, v in b.items()}
    return b


CASES = [
    # finetuning_type[+base quantization (QLoRA)], attention, packed,
    # grad_accum
    ("lora", "xla", False, 1),
    ("lora", "flash", True, 1),
    ("lora", "xla", True, 2),
    ("freeze", "xla", True, 1),
    ("full", "flash", False, 2),
    ("lora+int4", "flash", True, 1),
    ("lora+int8", "xla", False, 2),
]


@pytest.mark.parametrize("kind,impl,packed,accum", CASES)
def test_train_step_matches_reference(kind, impl, packed, accum):
    T, B = 128, 4
    kind, _, quant = kind.partition("+")
    qcfg = dict(quantization=quant, quant_impl="pallas") if quant else {}
    jcfg = jget_config("debug", attention_impl=impl, remat="full", **qcfg)
    tcfg = tget_config("debug", attention_impl=impl,
                       remat="dots" if impl == "flash" else "full", **qcfg)
    jparams = jinit(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    if quant:  # the frozen base, quantized by the reference and carried over
        jparams = jquantize(jparams, quant)
    common = dict(finetuning_type=kind, lora_dropout=0.1, neftune_alpha=5.0,
                  learning_rate=1e-3,
                  total_steps=10, grad_accum=accum, num_layer_trainable=1,
                  weight_decay=0.01)
    jtr = JTrainer(jcfg, JTrainConfig(compute_dtype=jnp.float32,
                                      lora_targets=("q_proj", "v_proj",
                                                    "down_proj"), **common))
    jstate = jtr.init_state(jparams, jax.random.PRNGKey(1))
    if kind == "lora":  # B starts at 0: give it values so A's grads move
        rng = np.random.default_rng(5)
        lora = jax.device_get(jstate.lora)
        for ab in lora["layers"].values():
            ab["b"] = (rng.normal(size=ab["b"].shape) * 0.05).astype(
                np.float32)
        jstate = jstate.replace(
            lora=jax.tree_util.tree_map(jnp.asarray, lora),
            opt_state=jtr.optimizer.init(
                jax.tree_util.tree_map(jnp.asarray, lora)))
    batch = _batch(11, B, T, jcfg.vocab_size, packed, accum)

    ttr = Trainer(tcfg, TrainConfig(compute_dtype=torch.float32,
                                    lora_targets=("q_proj", "v_proj",
                                                  "down_proj"), **common),
                  device="cpu")
    tparams = params_from_jax(jax.device_get(jparams), tcfg)
    tstate = ttr.init_state(tparams, 1)
    if kind == "lora":
        tlora = lora_from_jax(jax.device_get(jstate.lora), tcfg)
        tstate = dataclasses.replace(tstate, lora=tlora,
                                     opt_state=ttr.optimizer.init(tlora))

    jnew, jm = jtr.train_step(jstate, batch)
    tnew, tm = ttr.train_step(tstate, batch)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    assert int(tm["tokens"]) == int(jm["tokens"])
    np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-6)
    want = jnew.lora if kind == "lora" else jnew.params
    got = tnew.lora if kind == "lora" else tnew.params
    moved = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node.numpy(), np.asarray(leaf),
                                   **LEAF_TOL)
        moved += int(not np.array_equal(node.numpy(), _before(tstate, kind,
                                                              path)))
    assert moved > 0
    assert tnew.step == 1


def _before(state, kind, path):
    node = state.lora if kind == "lora" else state.params
    for key in path:
        node = node[key.key]
    return node.numpy()


def test_lora_dropout_keep_rate_and_scaling():
    """The twin's masks: the keep rate, the 1/(1-p) scaling, the same key
    giving the same mask (a remat recompute), and the mask equal to
    jax.random.bernoulli's under the same key."""
    from datatunerx_tpu_torch.ops import prng

    h = torch.ones((4, 64, 256))
    p = {"kernel": torch.zeros((256, 256))}
    lora = {"a": torch.eye(256), "b": torch.eye(256)}
    key = prng.fold_in(prng.PRNGKey(123), 5)
    out = tllama._proj(h, p, lora, 1.0, drop_key=key, drop_rate=0.25)
    # out = drop(h): kept lanes are 1/(1-p), dropped ones 0
    vals = torch.unique(out)
    assert set(vals.tolist()) <= {0.0, float(torch.tensor(1.0 / 0.75))}
    keep = (out > 0).float().mean().item()
    assert abs(keep - 0.75) < 0.02
    again = tllama._proj(h, p, lora, 1.0, drop_key=key, drop_rate=0.25)
    assert torch.equal(out, again)  # same key, same mask (remat recompute)
    other = tllama._proj(h, p, lora, 1.0, drop_key=prng.fold_in(key, 1),
                         drop_rate=0.25)
    assert not torch.equal(out, other)
    want = np.asarray(jax.random.bernoulli(jnp.asarray(key), 0.75,
                                           (4, 64, 256)))
    np.testing.assert_array_equal((out > 0).numpy(), want)
