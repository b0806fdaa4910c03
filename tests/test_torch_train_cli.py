"""The port's trainer CLI end to end on the CPU (``--device cpu``, the
``preset:debug`` model, a tiny CSV): the manifest carries the reference's
keys and ``trainer_log.jsonl`` the same record keys as a JAX CLI run on the
same CSV; ``--resume`` continues from the saved step; the ``model.npz``
export loads into the JAX package's ``load_model_and_tokenizer`` (logits
equal the port's merged forward at f32: atol 2e-4 / rtol 2e-3, the
tolerance tests/test_model_parity.py uses) and serves from the port's
``BatchedEngine``; so does a QLoRA run's (``--quantization int4|int8``),
whose ``config.json`` records the mode over full kernels."""

import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datatunerx_tpu.models.llama import forward as jforward
from datatunerx_tpu.tuning.train import main as jmain
from datatunerx_tpu.utils.model_loader import load_model_and_tokenizer as jload
from datatunerx_tpu_torch.models.llama import forward as tforward
from datatunerx_tpu_torch.models.lora import merge_lora
from datatunerx_tpu_torch.serving.batched_engine import BatchedEngine
from datatunerx_tpu_torch.tuning.train import main as tmain
from datatunerx_tpu_torch.tuning.train import run as trun
from datatunerx_tpu_torch.tuning.parser import parse_train_args


def _csv(path):
    rows = [(f"add {k}+{k}", f"answer {2 * k}") for k in range(40)]
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["instruction", "response"])
        w.writerows(rows)
    return str(path)


def _argv(tmp, name, **extra):
    flags = dict(model_name_or_path="preset:debug",
                 train_path=_csv(tmp / "train.csv"),
                 evaluation_path=str(tmp / "train.csv"),
                 storage_path=str(tmp / "storage"),
                 output_dir=str(tmp / name), uid=name, template="alpaca",
                 block_size="128", pack_sequences="true",
                 per_device_train_batch_size="2", max_steps="3",
                 logging_steps="1", bf16="false", remat="none",
                 attention="xla", lora_dropout="0.0")
    flags.update(extra)
    return [x for k, v in flags.items() for x in (f"--{k}", v)]


def _log(tmp, name, which="trainer_log.jsonl"):
    with open(tmp / name / "watch" / which) as f:
        return [json.loads(line) for line in f]


def _manifest(tmp, name):
    with open(tmp / "storage" / name / "manifest.json") as f:
        return json.load(f)


def test_manifest_and_log_keys_match_the_jax_cli(tmp_path):
    assert jmain(_argv(tmp_path, "jax")) == 0
    assert tmain(_argv(tmp_path, "port", device="cpu",
                       attention="flash", remat="dots")) == 0
    jm, tm = _manifest(tmp_path, "jax"), _manifest(tmp_path, "port")
    assert sorted(tm) == sorted(jm)
    assert sorted(tm["metrics"]) == sorted(jm["metrics"])
    assert tm["steps"] == jm["steps"] == 3
    assert os.path.exists(os.path.join(tm["checkpoint"], "state.pt"))
    with open(tmp_path / "storage" / "port" / "checkpoint_path") as f:
        assert f.read() == tm["checkpoint"]
    jl, tl = _log(tmp_path, "jax"), _log(tmp_path, "port")
    assert len(tl) == len(jl) == 3
    # which pipe_* means a record holds depends on thread timing in both
    # packages; every record has the fixed keys, and the run the same set
    keys = lambda log: sorted(set().union(*log))  # noqa: E731
    assert keys(tl) == keys(jl)
    fixed = set.intersection(*(set(r) for r in jl))
    assert all(fixed <= set(r) for r in tl)
    assert sorted(_log(tmp_path, "port", "eval_log.jsonl")[-1]) == sorted(
        _log(tmp_path, "jax", "eval_log.jsonl")[-1])
    assert all(np.isfinite(r["loss"]) and r["grad_norm"] > 0 for r in tl)


def test_resume_continues_from_the_saved_step(tmp_path, capsys):
    argv = _argv(tmp_path, "res", device="cpu", max_steps="2",
                 save_steps="1", evaluation_path="")
    assert tmain(argv) == 0
    first = _log(tmp_path, "res")
    argv = _argv(tmp_path, "res", device="cpu", max_steps="4",
                 save_steps="1", evaluation_path="")
    assert tmain(argv) == 0
    assert "[resume] restored step 2" in capsys.readouterr().out
    steps = [r["current_steps"] for r in _log(tmp_path, "res")]
    assert steps == [1, 2, 3, 4]
    assert _manifest(tmp_path, "res")["steps"] == 4
    assert first[1]["loss"] == _log(tmp_path, "res")[1]["loss"]
    ckpts = sorted(os.listdir(tmp_path / "storage" / "res" / "checkpoints"))
    assert ckpts == ["2", "3", "4"]  # max_to_keep 3


def test_resume_reads_a_checkpoint_that_kept_only_the_seed(tmp_path, capsys):
    """A checkpoint written before training drew from the threefry twin
    holds the run seed, not a key: resume rebuilds ``PRNGKey(seed)`` and
    warns that the draws differ."""
    from datatunerx_tpu_torch.ops import prng
    from datatunerx_tpu_torch.training.checkpoint import (
        load_raw_state, save_raw_state)

    argv = _argv(tmp_path, "old", device="cpu", max_steps="2",
                 save_steps="2", evaluation_path="", seed="7")
    assert tmain(argv) == 0
    directory = str(tmp_path / "storage" / "old" / "checkpoints")
    saved = load_raw_state(directory, 2)
    np.testing.assert_array_equal(saved.pop("rng").numpy(),
                                  prng.PRNGKey(7))
    saved["seed"] = 7
    save_raw_state(directory, 2, saved)
    argv = _argv(tmp_path, "old", device="cpu", max_steps="3",
                 save_steps="2", evaluation_path="", seed="7")
    with pytest.warns(UserWarning, match="PRNGKey"):
        assert tmain(argv) == 0
    assert "[resume] restored step 2" in capsys.readouterr().out
    assert [r["current_steps"] for r in _log(tmp_path, "old")] == [1, 2, 3]


def test_export_loads_into_both_packages(tmp_path):
    export = str(tmp_path / "export")
    args = parse_train_args(_argv(tmp_path, "exp", device="cpu",
                                  export_dir=export, evaluation_path=""))
    trun(args)
    # the run's final adapters, merged by hand, against the export
    from datatunerx_tpu_torch.training.checkpoint import CheckpointManager
    from datatunerx_tpu_torch.utils.model_loader import (
        load_model_and_tokenizer as tload)

    cfg, base, _ = tload("preset:debug", seed=args.seed)
    ckpt = CheckpointManager(str(tmp_path / "storage" / "exp" / "checkpoints"))
    saved = torch.load(os.path.join(ckpt.directory, "3", "state.pt"),
                       weights_only=True)
    merged = merge_lora(base, saved["lora"], 32.0 / 8)
    assert saved["lora"]["layers"]["q_proj"]["b"].abs().max() > 0

    jcfg, jparams, _ = jload(export)
    tokens = np.random.default_rng(0).integers(0, 500, (2, 16)).astype(
        np.int32)
    jl, _ = jforward(jparams, jnp.asarray(tokens), jcfg)
    with torch.no_grad():
        tl, _ = tforward(merged, torch.from_numpy(tokens), cfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-4,
                               rtol=2e-3)

    eng = BatchedEngine(export, device="cpu", template="vanilla",
                        max_seq_len=128, slots=2, kv_block_size=16)
    try:
        out = eng.generate(eng.tokenizer.encode("add 2+2"), max_new_tokens=4)
        assert len(out) == 4
    finally:
        eng.close()


def test_unported_options_are_refused_with_their_item(tmp_path):
    nie = NotImplementedError
    for extra, exc, item in (
            # QLoRA's own refusals, as the reference's
            (dict(quantization="int4", quantization_type="fp4"), nie, "fp4"),
            (dict(quantization="int8", finetuning_type="full"), ValueError,
             "requires finetuning_type lora"),
            # PPO under a mesh is ported: like any stage, a mesh above the
            # world's one process is refused by the mesh's own check
            (dict(stage="ppo", reward_model="rm", mesh="dp=2"), ValueError,
             r"mesh shape .* != 1 devices"),
            # the reference's own argument checks, raised by the port too
            (dict(streaming="true"), ValueError, "exclusive"),
            (dict(stage="rm", finetuning_type="full"), ValueError,
             "requires --finetuning_type lora")):
        argv = _argv(tmp_path, "no", device="cpu", **extra)
        with pytest.raises(exc, match=item):
            tmain(argv)


@pytest.mark.parametrize("mode", ["int4", "int8"])
def test_qlora_trains_checkpoints_exports_and_serves(tmp_path, mode):
    """QLoRA through the CLI: the base is quantized after load, the adapters
    train, the checkpoint holds only the adapters, and the export holds
    dequantized kernels under a config.json that records the mode, which
    both packages load and the port serves."""
    export = str(tmp_path / "export")
    args = parse_train_args(_argv(
        tmp_path, "q", device="cpu", quantization=mode, export_dir=export,
        attention="flash", remat="dots", evaluation_path=""))
    assert args.quant_impl == "pallas"
    result = trun(args)
    assert result["steps"] == 3
    manifest = _manifest(tmp_path, "q")
    saved = torch.load(os.path.join(manifest["checkpoint"], "state.pt"),
                       weights_only=True)
    assert "params" not in saved
    assert saved["lora"]["layers"]["q_proj"]["b"].abs().max() > 0
    assert all(np.isfinite(r["loss"]) for r in _log(tmp_path, "q"))
    with open(os.path.join(export, "config.json")) as f:
        assert json.load(f)["quantization"] == mode

    # the export = the re-quantized base, dequantized, plus the adapters
    from datatunerx_tpu_torch.ops.quant import (
        dequantize_model_params, quantize_model_params)
    from datatunerx_tpu_torch.models.lora import target_dims
    from datatunerx_tpu_torch.utils.model_loader import (
        load_model_and_tokenizer as tload)

    cfg, base, _ = tload("preset:debug", seed=args.seed)
    base = dequantize_model_params(quantize_model_params(base, mode), mode,
                                   lambda n: target_dims(cfg, n))
    merged = merge_lora(base, saved["lora"], 32.0 / 8)
    ecfg, eparams, _ = tload(export)
    assert ecfg.quantization == mode
    assert "kernel" in eparams["layers"]["q_proj"]
    jcfg, jparams, _ = jload(export)
    tokens = np.random.default_rng(1).integers(0, 500, (2, 16)).astype(
        np.int32)
    jl, _ = jforward(jparams, jnp.asarray(tokens), jcfg)
    with torch.no_grad():
        tl, _ = tforward(merged, torch.from_numpy(tokens), cfg)
        el, _ = tforward(eparams, torch.from_numpy(tokens), ecfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-4,
                               rtol=2e-3)
    np.testing.assert_allclose(el.numpy(), np.asarray(jl), atol=2e-4,
                               rtol=2e-3)

    eng = BatchedEngine(export, device="cpu", template="vanilla",
                        max_seq_len=128, slots=2, kv_block_size=16)
    try:
        out = eng.generate(eng.tokenizer.encode("add 2+2"), max_new_tokens=4)
        assert len(out) == 4
    finally:
        eng.close()


def test_quant_impl_flag_parses_as_in_the_reference(tmp_path):
    argv = _argv(tmp_path, "p", quantization="int8", quant_impl="xla")
    args = parse_train_args(argv)
    assert (args.quantization, args.quant_impl) == ("int8", "xla")
    assert parse_train_args(_argv(tmp_path, "p")).quant_impl == "pallas"
    with pytest.raises(ValueError, match="quant_impl"):
        parse_train_args(_argv(tmp_path, "p", quant_impl="mosaic"))


def _pref_csv(path):
    rows = [(f"add {k}+{k}", f"answer {2 * k}", f"wrong {k + 1}")
            for k in range(40)]
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["instruction", "chosen", "rejected"])
        w.writerows(rows)
    return str(path)


@pytest.fixture(scope="module")
def debug_export(tmp_path_factory):
    """``preset:debug``'s JAX weights as an export: both CLIs train from
    the same base."""
    from datatunerx_tpu.training.checkpoint import export_merged_model

    cfg, params, _ = jload("preset:debug")
    d = tmp_path_factory.mktemp("cli_base")
    export_merged_model(params, cfg, str(d))
    return str(d)


PATHS = {
    "dpo": dict(stage="dpo", pref=True),
    "rm": dict(stage="rm", pref=True, export=True),
    "adafactor": dict(optim="adafactor", neft_alpha="5"),
    "lion": dict(optim="lion", weight_decay="0.01"),
    "streaming": dict(streaming="true", pack_sequences="false",
                      shuffle_buffer="8"),
    "generate": dict(predict_with_generate="true", generate_examples="2",
                     max_new_tokens="6", generate_eval_steps="1"),
}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_new_paths_match_the_jax_cli(tmp_path, debug_export, path):
    """Each path of the trainer's item 8 through both CLIs on the same CSV,
    base weights and seed, LoRA dropout 0.1: the manifest, trainer log and
    eval log keys are equal, and the first step's loss is equal at f32
    (rtol 1e-5: the twin's LoRA init and masks, the same batch)."""
    extra = dict(PATHS[path])
    if extra.pop("pref", False):
        data = _pref_csv(tmp_path / "pref.csv")
        extra.update(train_path=data, evaluation_path=data)
    export = extra.pop("export", False)
    # the JAX CLI spreads its batch over every CPU device of the test
    # process (global batch = per-device batch x devices): the port's one
    # device takes the whole global batch
    ndev = len(jax.devices())
    runs = {}
    for pkg, main, more in (
            ("jax", jmain, dict(per_device_train_batch_size="2")),
            ("port", tmain, dict(device="cpu",
                                 per_device_train_batch_size=str(2 * ndev)))):
        flags = dict(extra, model_name_or_path=debug_export,
                     lora_dropout="0.1", max_steps="2", **more)
        if export:
            flags["export_dir"] = str(tmp_path / f"export_{pkg}")
        assert main(_argv(tmp_path, pkg, **flags)) == 0
        runs[pkg] = (_manifest(tmp_path, pkg), _log(tmp_path, pkg))
    (jm, jl), (tm, tl) = runs["jax"], runs["port"]
    # which pipe_* means a record holds depends on thread timing in both
    # packages (see test_manifest_and_log_keys_match_the_jax_cli)
    keys = lambda log: sorted(k for k in set().union(*log)  # noqa: E731
                              if not k.startswith("pipe_"))
    assert sorted(tm) == sorted(jm)
    assert keys([tm["metrics"]]) == keys([jm["metrics"]])
    assert tm["stage"] == jm["stage"] and tm["optimizer"] == jm["optimizer"]
    assert keys(tl) == keys(jl) and len(tl) == len(jl) == 2
    assert keys(_log(tmp_path, "port", "eval_log.jsonl")) == keys(
        _log(tmp_path, "jax", "eval_log.jsonl"))
    np.testing.assert_allclose(tl[0]["loss"], jl[0]["loss"], rtol=1e-5)
    if path == "dpo":
        assert abs(tl[0]["loss"] - np.log(2.0)) < 1e-5
    if export:
        with np.load(tmp_path / "export_port" / "model.npz") as z:
            head = z["v_head.weight"]
        with np.load(tmp_path / "export_jax" / "model.npz") as z:
            np.testing.assert_allclose(head, z["v_head.weight"], atol=1e-5,
                                       rtol=1e-4)
    if path == "generate":
        for pkg in ("jax", "port"):
            with open(tmp_path / pkg / "generated_predictions.jsonl") as f:
                assert len(f.readlines()) == 2
