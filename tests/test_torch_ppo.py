"""The port's PPO stage against the JAX package on the CPU at float32
(``preset:debug``, the JAX params, policy adapters and reward adapter
carried over by ``models/convert``): GAE on ragged masks, prompt
encoding and left-padded batches (equal arrays), a seeded rollout
(equal tokens and response masks; old log-probs, values, reference
log-probs, scores, advantages and returns within 1e-4), one update from
the same rollout (adapters and value head within ``LEAF_TOL``, the
tolerance ``tests/test_torch_dpo_rm.py`` holds a step to), the lr = 0
alignment of the cached decode and the full-sequence forward under
``xla`` and ``flash``, the adaptive controller's coefficient, and the
rm → ppo CLI against the JAX CLI (first step within 1e-4; resume keeps
``kl_coef``). Twins of ``tests/test_ppo.py``'s properties run on the
port."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datatunerx_tpu.data.loader import PromptBatchIterator as JPromptIt
from datatunerx_tpu.data.preprocess import (
    preprocess_prompt_records as jprompts,
)
from datatunerx_tpu.data.templates import get_template as jtemplate
from datatunerx_tpu.models.config import get_config as jget_config
from datatunerx_tpu.models.llama import forward as jforward
from datatunerx_tpu.models.llama import init_params as jinit
from datatunerx_tpu.models.llama import lm_logits as jlm_logits
from datatunerx_tpu.models.lora import init_lora_params as jinit_lora
from datatunerx_tpu.models.lora import lora_scaling
from datatunerx_tpu.training.ppo import PPOConfig as JPPOConfig
from datatunerx_tpu.training.ppo import PPOTrainer as JPPOTrainer
from datatunerx_tpu.training.ppo import compute_gae as jgae
from datatunerx_tpu.training.train_lib import TrainConfig as JTrainConfig
from datatunerx_tpu_torch.data.loader import PromptBatchIterator
from datatunerx_tpu_torch.data.preprocess import preprocess_prompt_records
from datatunerx_tpu_torch.data.templates import get_template
from datatunerx_tpu_torch.models.config import get_config
from datatunerx_tpu_torch.models.convert import lora_from_jax, params_from_jax
from datatunerx_tpu_torch.models.llama import forward as tforward
from datatunerx_tpu_torch.models.llama import lm_logits as tlm_logits
from datatunerx_tpu_torch.training.ppo import (
    PPOConfig,
    PPOTrainer,
    compute_gae,
    load_controller_state,
)
from datatunerx_tpu_torch.training.train_lib import TrainConfig
from tests.fake_tokenizer import FakeTokenizer

TOL = 1e-4  # rollout values: f32 forwards in another order
LEAF_TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def tok():
    return FakeTokenizer()


def _lora_to_torch(lora, cfg):
    out = lora_from_jax(jax.device_get(lora), cfg)
    out["v_head"] = torch.from_numpy(np.array(lora["v_head"]))
    return out


def _reward_lora(cfg, seed=7, rank=4, b_scale=0.05):
    """A frozen rm adapter with non-zero B and a fixed random value head."""
    lora = jax.device_get(jinit_lora(cfg, jax.random.PRNGKey(seed),
                                     rank=rank))
    rng = np.random.default_rng(seed)
    for ab in lora["layers"].values():
        ab["b"] = (rng.normal(size=ab["b"].shape) * b_scale).astype(
            np.float32)
    lora["v_head"] = np.asarray(jax.random.normal(
        jax.random.PRNGKey(seed + 1), (cfg.hidden_size,), jnp.float32))
    return lora


def _records(n):
    return [{"instruction": f"question {i}" + " more" * (i % 3)}
            for i in range(n)]


def _prompt_batch(tok, n=4, block=32, port=False):
    encode = preprocess_prompt_records if port else jprompts
    it_cls = PromptBatchIterator if port else JPromptIt
    ex = encode(_records(n), (get_template if port else jtemplate)(
        "vanilla", tok), tok, cutoff_len=block)
    assert len(ex) == n
    return next(iter(it_cls(ex, global_batch=n, block_size=block, pad_id=0,
                            shuffle=False)))


def _pair(ppo_kw, lr=1e-3, impl="xla", eos_id=2, b_scale=0.05):
    """A JAX and a port PPOTrainer and state from the same params, policy
    adapters (B made non-zero), value heads, reward adapter and key."""
    common = dict(stage="ppo", finetuning_type="lora", lora_rank=4,
                  lora_dropout=0.0, learning_rate=lr, scheduler="constant",
                  total_steps=100, compute_dtype=None)
    jcfg = jget_config("debug", attention_impl=impl)
    tcfg = get_config("debug", attention_impl=impl,
                      remat="dots" if impl == "flash" else "none")
    reward = _reward_lora(jcfg)
    scaling = lora_scaling(32.0, 4)
    jtr = JPPOTrainer(jcfg, JTrainConfig(**common), JPPOConfig(**ppo_kw),
                      reward_lora=jax.tree_util.tree_map(jnp.asarray, reward),
                      reward_scaling=scaling, eos_id=eos_id, pad_id=0)
    ttr = PPOTrainer(tcfg, TrainConfig(**common), PPOConfig(**ppo_kw),
                     reward_lora=_lora_to_torch(reward, tcfg),
                     reward_scaling=scaling, eos_id=eos_id, pad_id=0,
                     device="cpu")
    jparams = jinit(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    key = jax.random.PRNGKey(1)
    jstate = jtr.init_state(jparams, key)
    lora = jax.device_get(jstate.lora)
    rng = np.random.default_rng(5)
    for ab in lora["layers"].values():
        ab["b"] = (rng.normal(size=ab["b"].shape) * b_scale).astype(
            np.float32)
    jlora = jax.tree_util.tree_map(jnp.asarray, lora)
    jstate = jstate.replace(lora=jlora, opt_state=jtr.optimizer.init(jlora))
    tstate = ttr.init_state(params_from_jax(jax.device_get(jparams), tcfg),
                            np.asarray(key, np.uint32))
    tlora = _lora_to_torch(lora, tcfg)
    tstate = dataclasses.replace(tstate, lora=tlora,
                                 opt_state=ttr.optimizer.init(tlora))
    return jtr, ttr, jstate, tstate


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------------ GAE

def test_gae_hand_computed():
    """Two-token episode, γ = 1, λ = 0.5, against hand math."""
    adv, rets = compute_gae(torch.tensor([[1.0, 2.0, 99.0]]),
                            torch.tensor([[0.5, 1.0, 99.0]]),
                            torch.tensor([[1.0, 1.0, 0.0]]), 1.0, 0.5)
    np.testing.assert_allclose(adv[0].numpy(), [2.0, 1.0, 0.0], atol=1e-6)
    np.testing.assert_allclose(rets[0].numpy(), [2.5, 2.0, 0.0], atol=1e-6)


@pytest.mark.parametrize("gamma,lam", [(1.0, 0.95), (0.9, 0.5)])
def test_compute_gae_matches_reference(gamma, lam):
    """Random [B, G] rewards and values, ragged prefix masks (a row of one
    token, a full row): within 1e-5."""
    rng = np.random.default_rng(3)
    B, G = 6, 12
    r = rng.normal(size=(B, G)).astype(np.float32)
    v = rng.normal(size=(B, G)).astype(np.float32)
    n = np.array([1, G, 5, 7, 2, 11])
    m = (np.arange(G)[None] < n[:, None]).astype(np.float32)
    want = jgae(jnp.asarray(r), jnp.asarray(v), jnp.asarray(m), gamma, lam)
    got = compute_gae(torch.from_numpy(r), torch.from_numpy(v),
                      torch.from_numpy(m), gamma, lam)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)
    assert (got[0].numpy()[m == 0] == 0).all()


# ------------------------------------------------------------- prompts

def test_prompt_batches_match_reference(tok):
    """Prompt encoding (a response column ignored, an empty instruction
    skipped) and left-padded, shuffled batches of two epochs: equal."""
    recs = _records(9) + [{"instruction": "", "response": "x"},
                          {"instruction": "with answer", "response": "y"}]
    ex = preprocess_prompt_records(recs, get_template("vanilla", tok), tok,
                                   cutoff_len=8)
    want = jprompts(recs, jtemplate("vanilla", tok), tok, cutoff_len=8)
    assert ex == want and len(ex) == 10
    assert max(len(e["prompt_ids"]) for e in ex) == 8  # the cutoff bites
    kw = dict(global_batch=4, block_size=12, pad_id=0, seed=3)
    for epoch in (0, 1):
        got = list(PromptBatchIterator(ex, **kw).epoch(epoch))
        ref = list(JPromptIt(want, **kw).epoch(epoch))
        assert len(got) == len(ref) == 2
        for g, w in zip(got, ref):
            assert sorted(g) == sorted(w) == ["prompt_ids", "prompt_mask"]
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
                assert g[k].dtype == w[k].dtype
    first = next(iter(PromptBatchIterator(ex, **kw)))
    assert (first["prompt_mask"][:, -1] == 1).all()  # left-padded


def test_stage_validation():
    with pytest.raises(ValueError, match="lora"):
        TrainConfig(stage="ppo", finetuning_type="full")
    from datatunerx_tpu_torch.tuning.parser import parse_train_args

    with pytest.raises(ValueError, match="reward_model"):
        parse_train_args(["--model_name_or_path", "preset:debug", "--stage",
                          "ppo", "--train_path", "x.jsonl"])


def test_reward_lora_requires_v_head():
    cfg = get_config("debug")
    lora = lora_from_jax(jax.device_get(jinit_lora(
        jget_config("debug"), jax.random.PRNGKey(0))), cfg)
    with pytest.raises(ValueError, match="v_head"):
        PPOTrainer(cfg, TrainConfig(stage="ppo", compute_dtype=None),
                   PPOConfig(gen_len=4), reward_lora=lora, reward_scaling=1.0,
                   eos_id=2, device="cpu")


# ------------------------------------------------------------- rollout

def _ref_logp_and_score(fwd, lm, tr, params, ro, as_array):
    """The reference log-probs and reward scores of a rollout, recomputed
    with a package's forward as ``_rollout`` computes them (neither
    package returns them)."""
    cfg = tr.model_cfg
    seq, mask, pos = (as_array(ro[k]) for k in ("seq", "full_mask",
                                                "positions"))
    G = ro["old_logp"].shape[1]
    Tp = seq.shape[1] - G
    _, _, h = fwd(params, seq, cfg, positions=pos, attention_mask=mask,
                  lora=None, compute_dtype=None, return_hidden=True,
                  skip_logits=True)
    lp = _np(lm(params, h[:, Tp - 1:-1], cfg))
    lp = lp - np.log(np.exp(lp - lp.max(-1, keepdims=True)).sum(
        -1, keepdims=True)) - lp.max(-1, keepdims=True)
    ref = np.take_along_axis(lp, _np(seq)[:, Tp:, None], -1)[..., 0]
    _, _, rh = fwd(params, seq, cfg, positions=pos, attention_mask=mask,
                   lora=(tr.reward_lora, tr.reward_scaling),
                   compute_dtype=None, return_hidden=True, skip_logits=True)
    n = _np(ro["resp_mask"]).sum(1).astype(int)
    h_last = _np(rh)[np.arange(len(n)), Tp + n - 1]
    return ref, h_last @ _np(tr.reward_lora["v_head"])


def test_rollout_matches_reference(tok):
    """A seeded f32 rollout: equal tokens and response masks (one row
    ended early by an EOS the rollout samples), old log-probs, values,
    reference log-probs, scores, advantages and returns within 1e-4."""
    kw = dict(gen_len=8, temperature=1.0, ppo_epochs=1)
    jtr, *_ , jstate, _ = _pair(kw)
    batch = _prompt_batch(tok)
    ro0, _ = jtr._rollout(jstate, jtr._put_batch(batch), jnp.float32(0.1))
    # an EOS that row 1 samples at its third step ends that row early
    eos = int(np.asarray(ro0["seq"])[1, -8 + 2])
    jtr, ttr, jstate, tstate = _pair(kw, eos_id=eos)
    jro, jst = jtr._rollout(jstate, jtr._put_batch(batch), jnp.float32(0.1))
    tro, tst = ttr._rollout(tstate, ttr.put_batch(batch), 0.1)
    np.testing.assert_array_equal(tro["seq"].numpy(), np.asarray(jro["seq"]))
    m = np.asarray(jro["resp_mask"])
    np.testing.assert_array_equal(tro["resp_mask"].numpy(), m)
    assert m[1].sum() <= 3 and m.sum(1).max() == 8
    for k in ("full_mask", "positions"):
        np.testing.assert_array_equal(tro[k].numpy(), np.asarray(jro[k]))
    for k in ("old_logp", "values", "advantages", "returns"):
        np.testing.assert_allclose(tro[k].numpy() * m, np.asarray(jro[k]) * m,
                                   atol=TOL, err_msg=k)
    for k in ("reward_score", "kl", "response_len"):
        np.testing.assert_allclose(float(tst[k]), float(jst[k]), atol=TOL,
                                   err_msg=k)
    jref, jscore = _ref_logp_and_score(jforward, jlm_logits, jtr,
                                       jstate.params, jro, jnp.asarray)
    tref, tscore = _ref_logp_and_score(tforward, tlm_logits, ttr,
                                       tstate.params, tro, lambda x: x)
    np.testing.assert_allclose(tref * m, jref * m, atol=TOL)
    np.testing.assert_allclose(tscore, jscore, atol=TOL)
    # the response is a prefix of the window; post-eos tokens are pads
    toks = tro["seq"].numpy()[:, -8:]
    for r, row in enumerate(m):
        k = int(row.sum())
        assert (row[:k] == 1).all() and (row[k:] == 0).all()
        if k < 8:
            assert toks[r, k - 1] == eos and (toks[r, k:] == 0).all()


def test_update_matches_reference(tok):
    """One PPO pass from the reference's rollout: losses within 1e-5 and
    every adapter leaf and the value head within LEAF_TOL."""
    jtr, ttr, jstate, tstate = _pair(dict(gen_len=8, ppo_epochs=1), lr=1e-2)
    batch = _prompt_batch(tok)
    jro, _ = jtr._rollout(jstate, jtr._put_batch(batch), jnp.float32(0.1))
    tro = {k: torch.from_numpy(np.array(v)) for k, v in jro.items()}
    jnew, jm = jtr._update(jstate, jro)
    tnew, tm = ttr._update(tstate, tro)
    for k in ("loss", "pg_loss", "vf_loss", "approx_kl", "clipfrac",
              "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert tnew.step == int(jnew.step) == 1
    for path, leaf in jax.tree_util.tree_leaves_with_path(jnew.lora):
        node = tnew.lora
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node.numpy(), np.asarray(leaf), **LEAF_TOL)
    assert not torch.equal(tnew.lora["v_head"], tstate.lora["v_head"])


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_lr0_alignment_matches_reference(tok, impl):
    """With lr = 0 the first pass compares the rollout's cached decode with
    the update's full-sequence forward. Left-padded prompts at T = 128
    (block 120 + 8 generated). Under ``xla`` both packages read
    approx_kl ≈ 0 and clipfrac 0. Under ``flash`` the full-sequence
    forward drops the mask in both packages (the reference's
    ``_flash_ok`` path takes no ``kv_valid``), so the pads are attended:
    the port's numbers equal the reference's (ROADMAP Queue 3)."""
    kw = dict(gen_len=8, temperature=1.0, ppo_epochs=1)
    jtr, ttr, jstate, tstate = _pair(kw, lr=0.0, impl=impl)
    batch = _prompt_batch(tok, block=120)
    assert (batch["prompt_mask"] == 0).any(axis=1).all()  # every row padded
    jro, _ = jtr._rollout(jstate, jtr._put_batch(batch), jnp.float32(0.1))
    tro, _ = ttr._rollout(tstate, ttr.put_batch(batch), 0.1)
    np.testing.assert_array_equal(tro["seq"].numpy(), np.asarray(jro["seq"]))
    _, jm = jtr._update(jstate, jro)
    _, tm = ttr._update(tstate, tro)
    for k in ("approx_kl", "clipfrac"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-5,
                                   err_msg=k)
    if impl == "xla":
        assert abs(float(tm["approx_kl"])) < 1e-4
        assert float(tm["clipfrac"]) == 0.0
    else:
        assert abs(float(tm["approx_kl"])) > 1e-3  # the pads were attended


def test_adaptive_kl_controller_matches_reference(tok):
    """One step with a tiny target: the coefficient rises by the clipped
    error in both packages; the metric reports the coefficient used."""
    kw = dict(gen_len=4, ppo_epochs=1, kl_coef=0.5, ppo_target=1e-6,
              kl_horizon=1.0)
    jtr, ttr, jstate, tstate = _pair(kw)
    batch = _prompt_batch(tok)
    _, jm = jtr.step(jstate, batch)
    _, tm = ttr.step(tstate, batch)
    assert tm["kl_coef"] == jm["kl_coef"] == 0.5
    np.testing.assert_allclose(float(tm["kl"]), float(jm["kl"]), atol=TOL)
    assert float(tm["kl"]) > 1e-6  # the non-zero B makes a KL
    assert ttr.kl_coef == pytest.approx(jtr.kl_coef, rel=1e-7)
    assert ttr.kl_coef == pytest.approx(0.6)


def test_ppo_improves_reward(tok):
    """PPO climbs a fixed reward: late scores exceed early ones (the
    reference's property on the port)."""
    _, ttr, _, state = _pair(dict(gen_len=8, temperature=1.0, kl_coef=0.02,
                                  ppo_epochs=2), lr=8e-3, b_scale=0.0)
    batch = _prompt_batch(tok, port=True)
    scores = []
    for _ in range(18):
        state, metrics = ttr.step(state, batch)
        scores.append(float(metrics["reward_score"]))
    assert np.mean(scores[-3:]) > np.mean(scores[:3]), scores


# ----------------------------------------------------------------- CLI

@pytest.fixture(scope="module")
def debug_export(tmp_path_factory):
    """``preset:debug``'s JAX weights as an export: both CLIs start from
    the same base."""
    from datatunerx_tpu.training.checkpoint import export_merged_model
    from datatunerx_tpu.utils.model_loader import load_model_and_tokenizer

    cfg, params, _ = load_model_and_tokenizer("preset:debug")
    d = tmp_path_factory.mktemp("ppo_base")
    export_merged_model(params, cfg, str(d))
    return str(d)


def _write_jsonl(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return str(path)


def _log(out):
    with open(os.path.join(out, "watch", "trainer_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_ppo_cli_matches_the_jax_cli(tmp_path, debug_export):
    """rm → ppo through both CLIs (``tests/test_ppo.py``'s flags) from the
    same base: the first PPO step's reward_score, kl, response_len and
    loss within 1e-4, the manifest's stage and reward model, the saved
    controller state; ``--resume`` restores ``kl_coef``."""
    from datatunerx_tpu.tuning.train import main as jmain
    from datatunerx_tpu_torch.training.checkpoint import saved_steps
    from datatunerx_tpu_torch.tuning.train import main as tmain

    prefs = _write_jsonl(tmp_path / "prefs.jsonl", [
        {"instruction": f"q {i}", "chosen": f"fine answer {i}",
         "rejected": f"bad {i}"} for i in range(40)])
    prompts = _write_jsonl(tmp_path / "prompts.jsonl", [
        {"instruction": f"question {i}"} for i in range(40)])
    # the JAX CLI spreads its batch over every CPU device of the test
    # process: the port's one device takes the whole global batch
    ndev = len(jax.devices())
    runs = {}
    for pkg, main, more in (("jax", jmain, ["--per_device_train_batch_size",
                                            "1"]),
                            ("port", tmain, ["--per_device_train_batch_size",
                                             str(ndev), "--device", "cpu"])):
        store = str(tmp_path / pkg / "storage")
        common = ["--model_name_or_path", debug_export, "--storage_path",
                  store, "--template", "vanilla", "--max_steps", "2",
                  "--bf16", "false", "--lora_dropout", "0.0",
                  "--logging_steps", "1", *more]
        assert main(common + [
            "--stage", "rm", "--train_path", prefs, "--output_dir",
            str(tmp_path / pkg / "rm_out"), "--uid", "rm-run",
            "--block_size", "64"]) == 0
        ppo = common + [
            "--stage", "ppo", "--reward_model", f"{store}/rm-run",
            "--train_path", prompts, "--output_dir",
            str(tmp_path / pkg / "ppo_out"), "--uid", "ppo-run",
            "--block_size", "32", "--ppo_gen_len", "4", "--ppo_epochs", "1"]
        assert main(ppo) == 0
        runs[pkg] = (store, ppo, _log(str(tmp_path / pkg / "ppo_out")))
    (jstore, _, jl), (tstore, targv, tl) = runs["jax"], runs["port"]
    assert len(tl) == len(jl) == 2
    assert sorted(tl[0]) == sorted(jl[0])
    for k in ("reward_score", "kl", "response_len", "loss"):
        np.testing.assert_allclose(tl[0][k], jl[0][k], atol=1e-4, err_msg=k)
    with open(os.path.join(tstore, "ppo-run", "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["stage"] == "ppo"
    assert manifest["reward_model"].endswith("rm-run")
    ckpt_dir = os.path.join(tstore, "ppo-run", "checkpoints")
    assert saved_steps(ckpt_dir) == [2]
    cs = load_controller_state(ckpt_dir)
    with open(os.path.join(jstore, "ppo-run", "checkpoints",
                           "ppo_controller.json")) as f:
        jcs = json.load(f)
    assert cs["step"] == jcs["step"] == 2
    np.testing.assert_allclose(cs["kl_coef"], jcs["kl_coef"], rtol=1e-4)
    # a resumed run starts from the saved coefficient, not --init_kl_coef
    out = str(tmp_path / "port" / "ppo_out")
    argv = [a if a != "2" or targv[i - 1] != "--max_steps" else "3"
            for i, a in enumerate(targv)]
    assert tmain(argv + ["--resume", "true"]) == 0
    resumed = _log(out)[-1]
    assert resumed["current_steps"] == 3
    assert resumed["kl_coef"] == pytest.approx(cs["kl_coef"], rel=1e-12)
    assert resumed["kl_coef"] != 0.1
