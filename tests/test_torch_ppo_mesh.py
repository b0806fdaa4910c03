"""The port's PPO under a mesh, as gloo processes on the CPU, against the
JAX ``PPOTrainer`` on the same mesh over the virtual CPU devices
(``preset:debug`` at float32, the same params, policy and reward adapters
and prompts): 2-rank meshes (2,1,1,1), (1,2,1,1) fsdp, (1,1,2,1) tp and
(1,1,1,2) sp,
two steps with ``score_norm`` and whitening on, a sampled rollout at
temperature 1 and the adaptive KL controller. Each rank's rollout rows
equal the reference's global rollout's rows token for token (the rank
draws its block of the global ``[B, V]`` draw), every step's metrics hold
to ``tests/test_torch_ppo.py``'s tolerances (rollout stats ``TOL``, update
metrics rtol 1e-5 / atol 1e-6), ``kl_coef`` is equal on every rank, and
the trained adapters and value head hold to ``LEAF_TOL``.

Then the rm → ppo CLI as two port processes (``--mesh dp=2``, through
``LocalProcessBackend(num_hosts=2)``) against the JAX CLI on a 2-device
CPU mesh with the same flags and base: the first PPO step within 1e-4, as
``test_torch_ppo.py`` holds the one-device CLIs."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from datatunerx_tpu.models.config import get_config as jget_config
from datatunerx_tpu.models.llama import init_params as jinit
from datatunerx_tpu.models.lora import lora_scaling
from datatunerx_tpu.parallel.mesh import make_mesh as jmake_mesh
from datatunerx_tpu.training.ppo import PPOConfig as JPPOConfig
from datatunerx_tpu.training.ppo import PPOTrainer as JPPOTrainer
from datatunerx_tpu.training.train_lib import TrainConfig as JTrainConfig
from datatunerx_tpu_torch.models.config import get_config as tget_config
from datatunerx_tpu_torch.models.convert import lora_from_jax, params_from_jax
from datatunerx_tpu_torch.operator.backends import (
    LocalProcessBackend,
    _pkg_root,
)
from test_torch_gloo import World
from test_torch_parallel_workers import _to_numpy, ppo_worker
from test_torch_ppo import LEAF_TOL, TOL, _reward_lora

B, TP = 4, 16
PPO = dict(gen_len=6, temperature=1.0, ppo_epochs=2, score_norm=True,
           whiten_advantages=True, kl_coef=0.2, ppo_target=0.01,
           kl_horizon=2.0)
# compute_dtype None: f32 forwards over an f32 cache (a compute dtype
# gives the rollout a bf16 cache)
TRAIN = dict(stage="ppo", finetuning_type="lora", lora_rank=4,
             compute_dtype=None, lora_dropout=0.0, learning_rate=1e-3, scheduler="constant",
             total_steps=100)
ROLLOUT = ("reward_score", "kl", "response_len")
UPDATE = ("loss", "pg_loss", "vf_loss", "approx_kl", "clipfrac",
          "grad_norm")
# sp: the update's sequence chunks each hold part of the response window
MESHES = [("dp", (2, 1, 1, 1), "xla"), ("fsdp", (1, 2, 1, 1), "xla"),
          ("tp", (1, 1, 2, 1), "flash"), ("sp", (1, 1, 1, 2), "xla")]


def _prompts(seed):
    """Left-padded prompts of ragged lengths (every row but one padded)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 500, size=(B, TP)).astype(np.int32)
    mask = np.ones((B, TP), np.int32)
    for r, n in enumerate((TP, 9, 12, 5)):
        mask[r, :TP - n] = 0
        ids[r, :TP - n] = 0
    return {"prompt_ids": ids, "prompt_mask": mask}


def _policy_lora(jstate, seed=5):
    lora = jax.device_get(jstate.lora)
    rng = np.random.default_rng(seed)
    for ab in lora["layers"].values():
        ab["b"] = (rng.normal(size=ab["b"].shape) * 0.05).astype(np.float32)
    return lora


def _port_lora(lora, cfg):
    out = lora_from_jax(lora, cfg)
    import torch

    out["v_head"] = torch.from_numpy(np.array(lora["v_head"]))
    return _to_numpy(out)


def _setup(case):
    name, shape, impl = case
    jcfg = jget_config("debug", attention_impl=impl)
    tcfg = tget_config("debug", attention_impl=impl)
    reward = _reward_lora(jcfg)
    scaling = lora_scaling(32.0, 4)
    mesh = jmake_mesh(shape, devices=jax.devices()[:2])
    jtr = JPPOTrainer(jcfg, JTrainConfig(**TRAIN),
                      JPPOConfig(**PPO),
                      reward_lora=jax.tree_util.tree_map(jnp.asarray, reward),
                      reward_scaling=scaling, eos_id=2, pad_id=0, mesh=mesh)
    host_params = jax.device_get(jinit(jcfg, jax.random.PRNGKey(0),
                                       dtype=jnp.float32))
    jstate = jtr.init_state(jax.tree_util.tree_map(jnp.asarray, host_params),
                            jax.random.PRNGKey(1))
    lora = _policy_lora(jstate)
    jl = jax.tree_util.tree_map(jnp.asarray, lora)
    jstate = jstate.replace(lora=jl, opt_state=jtr.optimizer.init(jl))
    batches = [_prompts(1), _prompts(2)]
    spec = dict(preset="debug", cfg=dict(attention_impl=impl), train=TRAIN,
                ppo=PPO, shape=shape, scaling=scaling, eos_id=2,
                params=_to_numpy(params_from_jax(host_params, tcfg)),
                lora=_port_lora(lora, tcfg), reward=_port_lora(reward, tcfg),
                batches=batches)
    return spec, (jtr, jstate)


def _reference(jax_side, batches):
    """The JAX trainer's rollout of the first batch, two update passes from
    it, and two steps: (the rollout, its stats, the passes' metrics and
    adapters, the steps' metrics and adapters)."""
    jtr, jstate = jax_side
    host = jax.device_get(jstate)  # the update donates its state

    def fresh():
        return jtr.place_state(jax.tree_util.tree_map(jnp.array, host))

    ro, stats = jtr._rollout(fresh(),
                             jtr._put_batch(batches[0]),
                             jnp.float32(jtr.kl_coef))
    ro = jax.device_get(ro)
    st, ms = fresh(), []
    for _ in range(2):
        st, m = jtr._update(st, jax.tree_util.tree_map(jnp.asarray, ro))
        ms.append({k: float(v) for k, v in m.items()})
    update = {"metrics": ms, "lora": jax.device_get(st.lora)}
    st, ms = fresh(), []
    for b in batches:
        st, m = jtr.step(jtr.place_state(st), b)
        ms.append({k: float(v) for k, v in m.items()})
    return (ro, {k: float(v) for k, v in stats.items()}, update,
            {"metrics": ms, "lora": jax.device_get(st.lora)})


def _leaves_close(got, want, msg):
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node, np.asarray(leaf, np.float32),
                                   err_msg=f"{msg} {path}", **LEAF_TOL)


def _metrics_close(got, want, msg, keys=UPDATE, **tol):
    for step, (g, w) in enumerate(zip(got, want)):
        for k in keys:
            np.testing.assert_allclose(g[k], w[k], err_msg=f"{msg} {step} {k}",
                                       **tol)


def test_ppo_under_two_rank_meshes_matches_the_reference(devices8):
    setups = [_setup(c) for c in MESHES]
    refs = [_reference(js, spec["batches"]) for spec, js in setups]
    specs = [dict(spec, ro=ref[0], one_device=True)
             for (spec, _), ref in zip(setups, refs)]
    ranks = World(ppo_worker, 2, specs, timeout=300).result()
    for ci, (name, shape, _) in enumerate(MESHES):
        ro, stats, update, steps = refs[ci]
        b = B // (shape[0] * shape[1])
        for rank, outs in enumerate(ranks):
            got, msg = outs[ci], f"{name} rank {rank}"
            r0 = (rank if shape[0] * shape[1] > 1 else 0) * b
            rows = {k: np.asarray(v)[r0:r0 + b] for k, v in ro.items()}
            # the rollout: the rank's rows of the reference's global draw
            for k in ("seq", "resp_mask", "full_mask", "positions"):
                np.testing.assert_array_equal(got["ro"][k], rows[k],
                                              f"{msg} {k}")
            m = rows["resp_mask"]
            for k in ("old_logp", "values", "advantages", "returns"):
                np.testing.assert_allclose(got["ro"][k] * m, rows[k] * m,
                                           atol=TOL, err_msg=f"{msg} {k}")
            for k in ROLLOUT:  # over the global batch
                np.testing.assert_allclose(got["stats"][k], stats[k],
                                           atol=TOL, err_msg=f"{msg} {k}")
            # two passes from the reference's rollout
            _metrics_close(got["update"]["metrics"], update["metrics"],
                           f"{msg} update", rtol=1e-5, atol=1e-6)
            _leaves_close(got["update"]["lora"], update["lora"],
                          f"{msg} update")
            # two steps against the reference (the second rolls out with
            # the updated adapter), and against the port on one device;
            # the controller moves alike on every rank
            assert len(got["steps"]["metrics"]) == len(steps["metrics"]) == 2
            _metrics_close(got["steps"]["metrics"], steps["metrics"],
                           f"{msg} step", keys=ROLLOUT, atol=TOL)
            _metrics_close(got["steps"]["metrics"], steps["metrics"],
                           f"{msg} step", rtol=1e-5, atol=1e-6)
            _leaves_close(got["steps"]["lora"], steps["lora"], f"{msg} steps")
            one = ranks[0][ci]["one_device"]
            _metrics_close(got["steps"]["metrics"], one["metrics"],
                           f"{msg} one device", keys=UPDATE + ROLLOUT,
                           rtol=1e-5, atol=1e-6)
            _leaves_close(got["steps"]["lora"], one["lora"],
                          f"{msg} one device")
            for g, w in zip(got["steps"]["metrics"], steps["metrics"]):
                assert g["kl_coef"] == pytest.approx(w["kl_coef"], rel=1e-6)
            assert got["steps"]["metrics"][1]["kl_coef"] != PPO["kl_coef"]


# ----------------------------------------------------------------- CLI

def _write_jsonl(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return str(path)


def _log(out):
    with open(os.path.join(out, "watch", "trainer_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_ppo_cli_under_dp2_matches_the_jax_cli(tmp_path):
    """rm (one process each) → ppo under ``--mesh dp=2``: two port
    processes against the JAX CLI on 2 CPU devices."""
    from datatunerx_tpu.training.checkpoint import export_merged_model
    from datatunerx_tpu.tuning.train import main as jmain
    from datatunerx_tpu.utils.model_loader import load_model_and_tokenizer
    from datatunerx_tpu_torch.tuning.train import main as tmain
    from test_torch_multihost import _wait

    cfg, params, _ = load_model_and_tokenizer("preset:debug")
    base = str(tmp_path / "base")
    export_merged_model(params, cfg, base)
    prefs = _write_jsonl(tmp_path / "prefs.jsonl", [
        {"instruction": f"q {i}", "chosen": f"fine answer {i}",
         "rejected": f"bad {i}"} for i in range(40)])
    prompts = _write_jsonl(tmp_path / "prompts.jsonl", [
        {"instruction": f"question {i}" + " more" * (i % 4)}
        for i in range(40)])
    ndev = len(jax.devices())
    common = ["--model_name_or_path", base, "--template", "vanilla",
              "--max_steps", "2", "--bf16", "false", "--lora_dropout", "0.0",
              "--logging_steps", "1"]
    stores = {}
    for pkg, main, more in (("jax", jmain, ["--per_device_train_batch_size",
                                            "1"]),
                            ("port", tmain, ["--per_device_train_batch_size",
                                             str(ndev), "--device", "cpu"])):
        store = stores[pkg] = str(tmp_path / pkg / "storage")
        assert main(common + more + [
            "--storage_path", store, "--stage", "rm", "--train_path", prefs,
            "--output_dir", str(tmp_path / pkg / "rm_out"), "--uid",
            "rm-run", "--block_size", "64"]) == 0

    def ppo(pkg):
        return common + [
            "--storage_path", stores[pkg], "--stage", "ppo",
            "--reward_model", f"{stores[pkg]}/rm-run", "--train_path",
            prompts, "--output_dir", str(tmp_path / pkg / "ppo_out"),
            "--uid", "ppo-run", "--block_size", "32", "--ppo_gen_len", "4",
            "--ppo_epochs", "1", "--ppo_score_norm", "true",
            "--ppo_target", "0.05", "--per_device_train_batch_size", "2",
            "--mesh", "dp=2"]

    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=_pkg_root() + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    with open(tmp_path / "jax.log", "w") as log:
        jax_proc = subprocess.Popen(
            [sys.executable, "-m", "datatunerx_tpu.tuning.train",
             *ppo("jax")], stdout=log, stderr=subprocess.STDOUT, env=env,
            cwd=str(tmp_path))
    backend = LocalProcessBackend(str(tmp_path / "jobs"), device="cpu")
    backend.submit("port", {"args": ppo("port"), "num_hosts": 2})
    _wait(backend, ["port"], [jax_proc])
    assert jax_proc.returncode == 0, (tmp_path / "jax.log").read_text()[-3000:]
    assert backend.status("port") == "Succeeded", backend.log_tail("port")
    jl = _log(str(tmp_path / "jax" / "ppo_out"))
    tl = _log(str(tmp_path / "port" / "ppo_out"))
    assert len(tl) == len(jl) == 2
    for k in ("reward_score", "kl", "response_len", "loss", "approx_kl"):
        np.testing.assert_allclose(tl[0][k], jl[0][k], atol=1e-4, err_msg=k)
    assert tl[0]["kl_coef"] == jl[0]["kl_coef"]
    np.testing.assert_allclose(tl[1]["kl_coef"], jl[1]["kl_coef"], rtol=1e-4)
    with open(os.path.join(stores["port"], "ppo-run", "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["stage"] == "ppo"
    assert manifest["mesh"] == {"dp": 2, "fsdp": 1, "tp": 1, "sp": 1}
    ctrl = os.path.join(stores["port"], "ppo-run", "checkpoints",
                        "ppo_controller.json")
    with open(ctrl) as f:
        assert json.load(f)["step"] == 2


def test_prompt_batches_slice_hosts_as_the_reference():
    """A host's prompt rows are its contiguous block of each global batch,
    as the reference's iterator slices them (the port's iterator once
    handed every host the whole batch)."""
    from datatunerx_tpu.data.loader import PromptBatchIterator as JIt
    from datatunerx_tpu_torch.data.loader import PromptBatchIterator

    ex = [{"prompt_ids": list(range(3, 4 + i % 7))} for i in range(13)]
    kw = dict(global_batch=4, block_size=8, pad_id=0, seed=2)
    for host in (0, 1):
        got = list(PromptBatchIterator(ex, host_id=host, num_hosts=2,
                                       **kw).epoch(1))
        want = list(JIt(ex, host_id=host, num_hosts=2, **kw).epoch(1))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g["prompt_ids"].shape == (2, 8)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
    with pytest.raises(ValueError, match="divisible"):
        PromptBatchIterator(ex, global_batch=3, block_size=8, num_hosts=2)
