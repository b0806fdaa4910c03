"""The port's DPO and RM stages against the JAX package on the CPU at
float32 (``preset:debug``): preference encoding and pair batches (equal
arrays), one ``Trainer.train_step`` from the same params, adapters, value
head and batch with LoRA dropout 0.1 (the twin's masks: equal bits), the
loss ln 2 at init, preference eval over a padded tail, the value head's
init and its export loading into both packages, and twins of the
reference's ``tests/test_dpo.py`` / ``tests/test_rm.py`` properties.

Tolerances: losses rtol 1e-5, grad norms rtol 1e-4, updated leaves atol
1e-5 + rtol 1e-4 (``tests/test_torch_training.py``'s, for the same
reasons); the value head's init rtol 1e-5 (torch's erfinv against XLA's
polynomial: 13 f32 ulps at most over 2048 draws, 2e-7 relative here)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datatunerx_tpu.data.loader import PreferenceBatchIterator as JPrefIt
from datatunerx_tpu.data.preprocess import (
    preprocess_preference_records as jpref,
)
from datatunerx_tpu.data.templates import get_template as jtemplate
from datatunerx_tpu.models.config import get_config as jget_config
from datatunerx_tpu.models.llama import init_params as jinit
from datatunerx_tpu.training.train_lib import TrainConfig as JTrainConfig
from datatunerx_tpu.training.train_lib import Trainer as JTrainer
from datatunerx_tpu_torch.data.loader import PreferenceBatchIterator
from datatunerx_tpu_torch.data.preprocess import (
    preprocess_preference_records,
)
from datatunerx_tpu_torch.data.templates import get_template
from datatunerx_tpu_torch.models.config import get_config
from datatunerx_tpu_torch.models.convert import lora_from_jax, params_from_jax
from datatunerx_tpu_torch.training.loss import IGNORE_INDEX
from datatunerx_tpu_torch.training.train_lib import TrainConfig, Trainer
from tests.fake_tokenizer import FakeTokenizer

LEAF_TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def tok():
    return FakeTokenizer()


def _records(n):
    return [{"instruction": f"question {i}",
             "chosen": f"good answer number {i} " * (1 + i % 3),
             "rejected": f"bad {i}"} for i in range(n)]


def _pairs(tok, n=8, port=True):
    encode = preprocess_preference_records if port else jpref
    template = (get_template if port else jtemplate)("vanilla", tok)
    return encode(_records(n), template, tok, cutoff_len=64)


def test_preference_encoding_matches_reference(tok):
    assert _pairs(tok, 6) == _pairs(tok, 6, port=False)
    template = get_template("vanilla", tok)
    assert preprocess_preference_records(
        [{"instruction": "x", "chosen": "", "rejected": "y"}], template,
        tok) == []


@pytest.mark.parametrize("accum,drop", [(1, True), (2, False)])
def test_preference_batches_match_reference(tok, accum, drop):
    kw = dict(global_batch=4, block_size=64, pad_id=0, grad_accum=accum,
              seed=3, drop_remainder=drop)
    got = list(PreferenceBatchIterator(_pairs(tok, 10), **kw).epoch(1))
    want = list(JPrefIt(_pairs(tok, 10, port=False), **kw).epoch(1))
    assert len(got) == len(want) == (2 if drop else 3)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("stage", ["dpo", "rm"])
def test_stage_requires_lora(stage):
    with pytest.raises(ValueError, match="lora"):
        TrainConfig(stage=stage, finetuning_type="full")


def _trainers(stage, accum=1, impl="xla", dropout=0.1):
    common = dict(stage=stage, finetuning_type="lora", lora_rank=4,
                  lora_dropout=dropout, learning_rate=1e-3, total_steps=10,
                  grad_accum=accum, weight_decay=0.01)
    jcfg = jget_config("debug", attention_impl=impl)
    tcfg = get_config("debug", attention_impl=impl,
                      remat="dots" if impl == "flash" else "none")
    jtr = JTrainer(jcfg, JTrainConfig(compute_dtype=jnp.float32, **common))
    ttr = Trainer(tcfg, TrainConfig(compute_dtype=torch.float32, **common),
                  device="cpu")
    return jcfg, tcfg, jtr, ttr


def _states(jcfg, tcfg, jtr, ttr, b_scale=0.05):
    """The same params, adapters (B made non-zero) and value head in
    both packages, each with a fresh optimizer state."""
    jparams = jinit(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    jstate = jtr.init_state(jparams, jax.random.PRNGKey(1))
    lora = jax.device_get(jstate.lora)
    rng = np.random.default_rng(5)
    for ab in lora["layers"].values():
        ab["b"] = (rng.normal(size=ab["b"].shape) * b_scale).astype(
            np.float32)
    jlora = jax.tree_util.tree_map(jnp.asarray, lora)
    jstate = jstate.replace(lora=jlora, opt_state=jtr.optimizer.init(jlora))
    tstate = ttr.init_state(params_from_jax(jax.device_get(jparams), tcfg), 1)
    tlora = lora_from_jax(lora, tcfg)
    if "v_head" in lora:
        tlora["v_head"] = torch.from_numpy(np.array(lora["v_head"]))
    tstate = dataclasses.replace(tstate, lora=tlora,
                                 opt_state=ttr.optimizer.init(tlora))
    return jstate, tstate


def _batch(tok, accum):
    it = JPrefIt(_pairs(tok, 8, port=False), global_batch=4, block_size=64,
                 pad_id=0, grad_accum=accum, seed=2)
    return next(iter(it))


@pytest.mark.parametrize("stage", ["dpo", "rm"])
@pytest.mark.parametrize("accum,impl", [(1, "xla"), (2, "xla"),
                                        (1, "flash")])
def test_stage_step_matches_reference(tok, stage, accum, impl):
    """Loss, grad norm and every updated adapter leaf (the value head
    too) after one step with LoRA dropout 0.1 from the same key."""
    jcfg, tcfg, jtr, ttr = _trainers(stage, accum, impl)
    jstate, tstate = _states(jcfg, tcfg, jtr, ttr)
    batch = _batch(tok, accum)
    jnew, jm = jtr.train_step(jstate, batch)
    tnew, tm = ttr.train_step(tstate, batch)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    assert int(tm["tokens"]) == int(jm["tokens"]) == 4
    for path, leaf in jax.tree_util.tree_leaves_with_path(jnew.lora):
        node = tnew.lora
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node.numpy(), np.asarray(leaf),
                                   **LEAF_TOL)
    if stage == "rm":
        assert not torch.equal(tnew.lora["v_head"], tstate.lora["v_head"])


def test_dpo_loss_is_log2_at_init(tok):
    """B = 0 at init: the policy is the reference, the margin 0, the loss
    ln 2 (a twin of the reference's test)."""
    _, _, _, ttr = _trainers("dpo", dropout=0.0)
    state = ttr.init_state(
        params_from_jax(jax.device_get(jinit(jget_config("debug"),
                                             jax.random.PRNGKey(0))),
                        ttr.model_cfg), 1)
    m = ttr.eval_step(state, _batch(tok, 1))
    loss = float(m["sum_nll"]) / float(m["tokens"])
    assert abs(loss - np.log(2.0)) < 1e-4, loss


def test_preference_eval_matches_reference(tok):
    """Eval over held-out pairs with the tail padded (5 pairs in batches
    of 2): padding pairs count in neither sum nor count."""
    for stage in ("dpo", "rm"):
        jcfg, tcfg, jtr, ttr = _trainers(stage, dropout=0.0)
        jstate, tstate = _states(jcfg, tcfg, jtr, ttr)
        kw = dict(global_batch=2, block_size=64, pad_id=0, shuffle=False,
                  drop_remainder=False)
        want = jtr.evaluate(jstate, JPrefIt(_pairs(tok, 5, port=False),
                                            **kw).epoch(0))
        got = ttr.evaluate(tstate, PreferenceBatchIterator(
            _pairs(tok, 5), **kw).epoch(0))
        assert got["eval_tokens"] == want["eval_tokens"] == 5
        np.testing.assert_allclose(got["eval_loss"], want["eval_loss"],
                                   rtol=1e-5)


def test_rm_value_head_init_holds_to_reference():
    """``normal(fold_in(key, 0x4EAD), (D,)) / sqrt(D)``: the twin's
    uniform, torch's erfinv; sft states grow no head (the reference's
    ``test_rm_state_has_value_head``)."""
    for name in ("debug", "tinyllama-1.1b"):
        D = get_config(name).hidden_size
        key = jax.random.fold_in(jax.random.PRNGKey(1), 0x4EAD)
        want = np.asarray(jax.random.normal(key, (D,), jnp.float32)
                          / np.sqrt(D))
        _, _, _, ttr = _trainers("rm")
        if name == "debug":
            cfg = ttr.model_cfg
            params = params_from_jax(jax.device_get(jinit(
                jget_config(name), jax.random.PRNGKey(0))), cfg)
            head = ttr.init_state(params, 1).lora["v_head"]
        else:
            from datatunerx_tpu_torch.ops import prng
            from datatunerx_tpu_torch.training.train_lib import normal

            head = normal(prng.fold_in(prng.PRNGKey(1), 0x4EAD), (D,)) / \
                torch.tensor(np.sqrt(D), dtype=torch.float32)
        assert tuple(head.shape) == (D,)
        np.testing.assert_allclose(head.numpy(), want, rtol=1e-5, atol=0)
    _, tcfg, _, _ = _trainers("rm")
    sft = Trainer(tcfg, TrainConfig(lora_rank=4, total_steps=5,
                                    compute_dtype=torch.float32),
                  device="cpu")
    params = params_from_jax(jax.device_get(jinit(
        jget_config("debug"), jax.random.PRNGKey(0))), tcfg)
    assert "v_head" not in sft.init_state(params, 1).lora


def test_v_head_export_loads_into_both_packages(tmp_path, tok):
    """An rm run's merged export holds ``v_head.weight``; both packages'
    loaders read the export (the head beside the HF tree)."""
    from datatunerx_tpu.utils.model_loader import (
        load_model_and_tokenizer as jload)
    from datatunerx_tpu_torch.training.checkpoint import export_merged_model
    from datatunerx_tpu_torch.utils.model_loader import (
        load_model_and_tokenizer as tload)

    jcfg, tcfg, jtr, ttr = _trainers("rm")
    _, tstate = _states(jcfg, tcfg, jtr, ttr)
    out = str(tmp_path / "rm_export")
    export_merged_model(tstate.params, tcfg, out, lora=tstate.lora,
                        scaling=ttr.scaling)
    with np.load(f"{out}/model.npz") as z:
        np.testing.assert_array_equal(z["v_head.weight"],
                                      tstate.lora["v_head"].numpy())
    assert jload(out)[0].hidden_size == tload(out)[0].hidden_size == 64


def test_dpo_training_improves_preference_margin(tok):
    _, _, _, ttr = _trainers("dpo", dropout=0.0)
    ttr = Trainer(ttr.model_cfg, dataclasses.replace(
        ttr.cfg, lora_rank=8, total_steps=30, dpo_beta=0.5,
        learning_rate=5e-3), device="cpu")
    state = ttr.init_state(params_from_jax(jax.device_get(jinit(
        jget_config("debug"), jax.random.PRNGKey(0))), ttr.model_cfg), 1)
    batch = _batch(tok, 1)
    losses = []
    for _ in range(30):
        state, m = ttr.train_step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] < np.log(2.0) + 1e-3, losses
    assert losses[-1] < 0.5


def test_rm_learns_to_rank_and_trains_its_head(tok):
    _, tcfg, _, _ = _trainers("rm", dropout=0.0)
    ttr = Trainer(tcfg, TrainConfig(
        stage="rm", lora_rank=8, lora_dropout=0.0, learning_rate=5e-3,
        total_steps=40, compute_dtype=torch.float32), device="cpu")
    state = ttr.init_state(params_from_jax(jax.device_get(jinit(
        jget_config("debug"), jax.random.PRNGKey(0))), tcfg), 1)
    head0 = state.lora["v_head"].clone()
    batch = _batch(tok, 1)
    losses = []
    for _ in range(40):
        state, m = ttr.train_step(state, batch)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] and losses[-1] < 0.3, losses
    assert (state.lora["v_head"] - head0).abs().max() > 0
    assert IGNORE_INDEX in batch["chosen_labels"]
