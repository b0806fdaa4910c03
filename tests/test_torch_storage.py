"""The port's object-storage plane (``utils/storage.py``) on ``memory://``
(fsspec's in-process filesystem stands in for gs:// and s3://; the code
path is the same): the reference's ``tests/test_storage.py`` cases
against the port, streaming ingest and checkpoints over a URI, the
trainer CLI (SFT and PPO) with ``--train_path``/``--storage_path`` on
``memory://``, and the manifest it writes read by the reference's
``read_manifest``. A URI whose scheme fsspec cannot open raises; it is
never written as a local path."""

import csv
import dataclasses
import io
import json
import os

import numpy as np
import pytest
import torch

from datatunerx_tpu_torch.data.loader import CsvDataset, StreamingCsvDataset
from datatunerx_tpu_torch.training.checkpoint import (
    CheckpointManager,
    read_manifest,
    saved_steps,
    write_manifest,
)
from datatunerx_tpu_torch.utils import storage


@pytest.fixture(autouse=True)
def clean_memory_fs():
    import fsspec

    fs = fsspec.filesystem("memory")
    yield
    for p in list(fs.store):
        fs.store.pop(p, None)
    fs.pseudo_dirs[:] = [""]


def test_uri_helpers():
    assert storage.is_uri("gs://b/k") and storage.is_uri("memory://x")
    assert not storage.is_uri("/tmp/x")
    assert storage.join("gs://b", "a", "c.json") == "gs://b/a/c.json"
    assert storage.join("/tmp", "a") == "/tmp/a"


def test_read_write_roundtrip_memory():
    storage.write_text("memory://bucket/dir/file.txt", "hello")
    assert storage.exists("memory://bucket/dir/file.txt")
    assert storage.read_text("memory://bucket/dir/file.txt") == "hello"
    assert not storage.exists("memory://bucket/dir/nope.txt")


def test_csv_dataset_from_uri():
    storage.write_text("memory://data/train.csv",
                       "instruction,response\nhello,world\nfoo,bar\n")
    ds = CsvDataset("memory://data/train.csv")
    assert len(ds.records) == 2
    assert ds.records[0]["instruction"] == "hello"


def test_jsonl_dataset_from_uri():
    rows = [{"instruction": "a", "response": "b"},
            {"instruction": "c", "response": "d"}]
    storage.write_text("memory://data/train.jsonl",
                       "\n".join(json.dumps(r) for r in rows))
    ds = CsvDataset("memory://data/train.jsonl")
    assert len(ds.records) == 2 and ds.records[1]["response"] == "d"


def test_dataset_uri_missing_raises():
    with pytest.raises(FileNotFoundError):
        CsvDataset("memory://data/absent.csv")
    with pytest.raises(FileNotFoundError):
        StreamingCsvDataset("memory://data/absent.jsonl")


def test_manifest_roundtrip_over_uri():
    path = write_manifest("memory://runs", "uid-1", "gs://ckpts/uid-1/7",
                          metrics={"loss": 1.25}, extra={"lora_scaling": 2.0})
    assert path == "memory://runs/uid-1/manifest.json"
    m = read_manifest("memory://runs", "uid-1")
    assert m["checkpoint"] == "gs://ckpts/uid-1/7"
    assert m["metrics"]["loss"] == 1.25 and m["lora_scaling"] == 2.0
    # the legacy path file (the reference's contract)
    assert storage.read_text("memory://runs/uid-1/checkpoint_path") == (
        "gs://ckpts/uid-1/7")
    assert read_manifest("memory://runs", "uid-2") is None


@pytest.mark.parametrize("uri", ["s3://bucket/key.csv", "gs://bucket/key.csv",
                                 "memory://x/y"])
def test_s3_storage_options_from_env(monkeypatch, uri):
    """The reference's env surface, and the reference's options for it."""
    from datatunerx_tpu.operator.config import object_store_options

    monkeypatch.setenv("S3_ENDPOINT", "minio.ns.svc:9000")
    monkeypatch.setenv("S3_ACCESSKEYID", "ak")
    monkeypatch.setenv("S3_SECRETACCESSKEY", "sk")
    monkeypatch.setenv("S3_SECURE", "false")
    opts = storage.object_store_options(uri)
    assert opts == object_store_options(uri)
    if uri.startswith("s3://"):
        assert opts["key"] == "ak" and opts["secret"] == "sk"
        assert opts["client_kwargs"]["endpoint_url"] == (
            "http://minio.ns.svc:9000")
        monkeypatch.setenv("S3_SECURE", "true")
        assert storage.object_store_options(uri)["client_kwargs"][
            "endpoint_url"] == "https://minio.ns.svc:9000"
    else:
        assert opts == {}


def test_unknown_scheme_raises_and_stays_off_the_local_disk(tmp_path,
                                                            monkeypatch):
    monkeypatch.chdir(tmp_path)
    for call in (lambda: storage.exists("nosuch://b/k"),
                 lambda: storage.write_text("nosuch://b/k", "x"),
                 lambda: CsvDataset("nosuch://b/t.csv")):
        with pytest.raises(ValueError, match="nosuch"):
            call()
    assert os.listdir(tmp_path) == []


def test_streaming_dataset_reads_a_uri():
    rows = [{"instruction": f"q{i}", "response": f"a{i}"} for i in range(5)]
    storage.write_text("memory://data/s.jsonl",
                       "\n\n" + "\n".join(json.dumps(r) for r in rows))
    assert list(StreamingCsvDataset("memory://data/s.jsonl")) == rows
    buf = io.StringIO()
    w = csv.writer(buf)
    w.writerow(["instruction", "response"])
    w.writerows([(r["instruction"], r["response"]) for r in rows])
    storage.write_text("memory://data/s.csv", buf.getvalue())
    assert list(StreamingCsvDataset("memory://data/s.csv")) == rows


def test_checkpoints_over_a_uri():
    """Saves keep the newest ``max_to_keep``; restore reads the newest or
    a given step back onto the template."""
    from datatunerx_tpu_torch.training.train_lib import TrainState

    mngr = CheckpointManager("memory://ck/run/checkpoints",
                             save_interval_steps=2, max_to_keep=2)
    assert mngr.directory == "memory://ck/run/checkpoints"
    template = TrainState(step=0, params={}, lora={"w": torch.zeros(3)},
                          opt_state=(), rng=np.array([0, 1], np.uint32))
    for step in range(1, 7):
        state = dataclasses.replace(template, step=step,
                                    lora={"w": torch.full((3,), step * 1.0)})
        assert mngr.maybe_save(state, step) == (step % 2 == 0)
    assert mngr.all_steps() == saved_steps(mngr.directory) == [4, 6]
    restored, step = mngr.restore(template)
    assert step == 6 and restored.step == 6
    assert torch.equal(restored.lora["w"], torch.full((3,), 6.0))
    restored, _ = mngr.restore(template, step=4)
    assert torch.equal(restored.lora["w"], torch.full((3,), 4.0))
    assert saved_steps("memory://ck/none") == []


@pytest.mark.parametrize("scheme", ["file", "memory"])
def test_saved_steps_never_lists_a_step_being_written(tmp_path, scheme,
                                                      monkeypatch):
    """While ``state.pt`` is still open for writing, ``saved_steps`` (what
    the experiment loop's watcher and scheduler poll) does not list its
    step; once the save returns it does, and the step loads back."""
    from datatunerx_tpu_torch.training.checkpoint import (
        load_raw_state,
        save_raw_state,
    )

    root = (f"file://{tmp_path}/ck" if scheme == "file"
            else "memory://ck/run")
    save_raw_state(root, 1, {"w": torch.zeros(2)})
    seen = []
    real_save = torch.save

    def save_and_poll(obj, f, *a, **kw):
        f.write(b"partial")
        f.flush()
        seen.append(saved_steps(root))
        f.seek(0)
        f.truncate()
        return real_save(obj, f, *a, **kw)

    monkeypatch.setattr(torch, "save", save_and_poll)
    save_raw_state(root, 2, {"w": torch.ones(2)})
    assert seen == [[1]]
    assert saved_steps(root) == [1, 2]
    assert torch.equal(load_raw_state(root, 2)["w"], torch.ones(2))
    # the temporary object was moved, not left beside state.pt
    assert [os.path.basename(p) for p in storage.glob(
        storage.join(root, "2", "*"))] == ["state.pt"]


def _memory_csv(path, n=40):
    buf = io.StringIO()
    w = csv.writer(buf)
    w.writerow(["instruction", "response"])
    w.writerows((f"add {k}+{k}", f"answer {2 * k}") for k in range(n))
    storage.write_text(path, buf.getvalue())
    return path


def test_cli_sft_on_memory_uris(tmp_path):
    """SFT with the dataset and storage on ``memory://``: the checkpoints
    and manifest land there, the reference reads the manifest, a resume
    reads the checkpoint back."""
    from datatunerx_tpu.training.checkpoint import read_manifest as jread
    from datatunerx_tpu_torch.tuning.train import main

    data = _memory_csv("memory://data/train.csv")
    argv = ["--model_name_or_path", "preset:debug", "--train_path", data,
            "--evaluation_path", data, "--storage_path", "memory://store",
            "--output_dir", str(tmp_path / "out"), "--uid", "run",
            "--template", "alpaca", "--block_size", "64",
            "--per_device_train_batch_size", "4", "--max_steps", "2",
            "--bf16", "false", "--device", "cpu"]
    assert main(argv) == 0
    ckpts = "memory://store/run/checkpoints"
    assert saved_steps(ckpts) == [2]
    assert storage.exists(f"{ckpts}/2/state.pt")
    m = jread("memory://store", "run")
    assert m == read_manifest("memory://store", "run")
    assert m["checkpoint"] == f"{ckpts}/2" and m["stage"] == "sft"
    assert "eval_loss" in m["metrics"]
    assert not os.path.exists("memory:")  # nothing written locally
    # serving reads the checkpoint and its scaling back from the URI
    from datatunerx_tpu_torch.serving.batched_engine import (
        load_checkpoint_state,
    )

    for path in (ckpts, f"{ckpts}/2"):
        state = load_checkpoint_state(path)
        assert sorted(state["lora"]["layers"]) == ["q_proj", "v_proj"]
        assert state["_scaling"] == m["lora_scaling"] == 4.0
    argv[argv.index("--max_steps") + 1] = "3"
    assert main(argv) == 0
    assert saved_steps(ckpts) == [2, 3]
    with open(tmp_path / "out" / "watch" / "trainer_log.jsonl") as f:
        assert json.loads(f.readlines()[-1])["current_steps"] == 3


def test_cli_ppo_on_memory_uris(tmp_path):
    """rm then ppo with prompts, storage and the reward model on
    ``memory://``: the reward adapter is read back from the URI, and the
    controller state is written beside the checkpoints."""
    from datatunerx_tpu_torch.training.ppo import load_controller_state
    from datatunerx_tpu_torch.tuning.train import main

    pairs = "\n".join(json.dumps({"instruction": f"q {i}",
                                  "chosen": f"fine answer {i}",
                                  "rejected": f"bad {i}"})
                      for i in range(8))
    storage.write_text("memory://data/prefs.jsonl", pairs)
    storage.write_text("memory://data/prompts.jsonl", "\n".join(
        json.dumps({"instruction": f"question {i}"}) for i in range(8)))
    common = ["--model_name_or_path", "preset:debug", "--storage_path",
              "memory://store", "--template", "vanilla",
              "--per_device_train_batch_size", "4", "--max_steps", "2",
              "--bf16", "false", "--lora_dropout", "0.0", "--device", "cpu",
              "--logging_steps", "1"]
    assert main(common + ["--stage", "rm", "--train_path",
                          "memory://data/prefs.jsonl", "--output_dir",
                          str(tmp_path / "rm"), "--uid", "rm-run",
                          "--block_size", "64"]) == 0
    assert main(common + ["--stage", "ppo", "--reward_model",
                          "memory://store/rm-run", "--train_path",
                          "memory://data/prompts.jsonl", "--output_dir",
                          str(tmp_path / "ppo"), "--uid", "ppo-run",
                          "--block_size", "32", "--ppo_gen_len", "4",
                          "--ppo_epochs", "1"]) == 0
    ckpts = "memory://store/ppo-run/checkpoints"
    assert saved_steps(ckpts) == [2]
    cs = load_controller_state(ckpts)
    assert cs["step"] == 2 and cs["kl_coef"] > 0
    m = read_manifest("memory://store", "ppo-run")
    assert m["stage"] == "ppo" and m["reward_model"] == "memory://store/rm-run"
    with open(tmp_path / "ppo" / "watch" / "trainer_log.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert len(recs) == 2 and all(np.isfinite(r["loss"]) for r in recs)
