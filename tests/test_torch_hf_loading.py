"""HF checkpoint directories in the port (``utils/hf_weights.py``,
``utils/hf_convert.config_from_hf``, ``utils/model_loader.py``) against the
JAX package and HF's own libraries, on directories ``save_pretrained``
writes here: the safetensors and ``.bin`` readers against
``safetensors.numpy`` / ``torch.load`` (F32, F16, BF16, sharded indexes),
``config_from_hf`` field by field against the reference's, and the port's
``load_model_and_tokenizer`` against the reference's on the same directory
(every leaf bit-equal, the tokenizers' ids equal). Plus the refusals: a
missing tensor, a shape that disagrees with ``config.json``, an unknown
dtype and a directory without a tokenizer raise, naming what they met."""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_hf_dirs import FIXTURES, hf_model, write_hf_dir

from datatunerx_tpu.training.checkpoint import export_merged_model
from datatunerx_tpu.utils.hf_convert import config_from_hf as jconfig_from_hf
from datatunerx_tpu.utils.model_loader import load_model_and_tokenizer as jload
from datatunerx_tpu.utils.model_loader import load_tokenizer as jload_tokenizer
from datatunerx_tpu_torch.models.config import ModelConfig
from datatunerx_tpu_torch.utils import hf_weights
from datatunerx_tpu_torch.utils.hf_convert import config_from_hf
from datatunerx_tpu_torch.utils.hf_tokenizer import HFTokenizer
from datatunerx_tpu_torch.utils.model_loader import load_model_and_tokenizer
from datatunerx_tpu_torch.utils.model_loader import load_tokenizer
from datatunerx_tpu_torch.utils.simple_tokenizer import SimpleTokenizer

TEXTS = ["hello world", "The port reads HF directories.",
         "naïve café → 日本語", "<s>x</s> y", "a\n\n b\r\n\t!"]


def _tensors(rng):
    return {
        "a.f32": rng.normal(size=(3, 5)).astype(np.float32),
        "b.f16": rng.normal(size=(7,)).astype(np.float16),
        "c.bf16": torch.from_numpy(rng.normal(size=(4, 2, 3)).astype(
            np.float32)).to(torch.bfloat16),
        "d.empty": np.zeros((0, 4), np.float32),
    }


def _bits(t) -> np.ndarray:
    t = torch.as_tensor(t)
    return t.contiguous().view(torch.uint8).numpy() if t.numel() else \
        np.zeros(0, np.uint8)


@pytest.mark.parametrize("sharded", [False, True])
def test_safetensors_reader_matches_safetensors(tmp_path, sharded):
    from safetensors.numpy import load_file
    from safetensors.torch import save_file

    tensors = {k: torch.as_tensor(v) for k, v in
               _tensors(np.random.default_rng(0)).items()}
    names = sorted(tensors)
    parts = [names[:2], names[2:]] if sharded else [names]
    weight_map = {}
    for i, part in enumerate(parts):
        file = (f"model-{i + 1:05d}-of-{len(parts):05d}.safetensors"
                if sharded else "model.safetensors")
        save_file({k: tensors[k] for k in part}, str(tmp_path / file),
                  metadata={"format": "pt"})
        weight_map.update({k: file for k in part})
    if sharded:
        with open(tmp_path / "model.safetensors.index.json", "w") as f:
            json.dump({"metadata": {}, "weight_map": weight_map}, f)
    ckpt = hf_weights.HFCheckpoint(str(tmp_path))
    assert sorted(ckpt.where) == names
    for k in names:
        got = ckpt.get(k, tuple(tensors[k].shape))
        assert got.dtype == tensors[k].dtype
        np.testing.assert_array_equal(_bits(got), _bits(tensors[k]))
        if tensors[k].dtype != torch.bfloat16:  # numpy has no bf16
            ref = load_file(str(tmp_path / weight_map[k]))[k]
            np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("sharded", [False, True])
def test_bin_reader_matches_torch_load(tmp_path, sharded):
    tensors = {k: torch.as_tensor(v) for k, v in
               _tensors(np.random.default_rng(1)).items()}
    names = sorted(tensors)
    if sharded:
        weight_map = {}
        for i, k in enumerate(names):
            file = f"pytorch_model-{i + 1:05d}-of-{len(names):05d}.bin"
            torch.save({k: tensors[k]}, tmp_path / file)
            weight_map[k] = file
        with open(tmp_path / "pytorch_model.bin.index.json", "w") as f:
            json.dump({"metadata": {}, "weight_map": weight_map}, f)
    else:
        torch.save(tensors, tmp_path / "pytorch_model.bin")
    ckpt = hf_weights.HFCheckpoint(str(tmp_path))
    for k in names:
        got = ckpt.get(k, tuple(tensors[k].shape))
        file = weight_map[k] if sharded else "pytorch_model.bin"
        ref = torch.load(tmp_path / file, weights_only=True)[k]
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(_bits(got), _bits(ref))


def _parity_config(family):
    """The configs of tests/test_model_parity.py (vocab 256)."""
    from transformers import LlamaConfig, MistralConfig, Qwen2Config

    common = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                  num_hidden_layers=3, num_attention_heads=4,
                  num_key_value_heads=2, max_position_embeddings=128,
                  rms_norm_eps=1e-5, tie_word_embeddings=False)
    return {"llama": lambda: LlamaConfig(**common),
            "mistral": lambda: MistralConfig(**common, sliding_window=16),
            "qwen2": lambda: Qwen2Config(**common)}[family]()


@pytest.mark.parametrize("family", ["llama", "mistral", "qwen2"])
def test_config_from_hf_matches_the_reference(tmp_path, family):
    hf_cfg = _parity_config(family)
    hf_cfg.save_pretrained(tmp_path)
    with open(tmp_path / "config.json") as f:
        raw = json.load(f)
    want = dataclasses.asdict(jconfig_from_hf(hf_cfg))
    for source in (hf_cfg, raw):
        got = dataclasses.asdict(config_from_hf(source))
        assert got == want, source
    assert want["attention_bias"] == (family == "qwen2")
    assert want["sliding_window"] == (16 if family == "mistral" else None)
    # the reference's rules: the window only for mistral, rope_scaling
    # never mapped
    raw.update(model_type="qwen2", sliding_window=64,
               rope_scaling={"type": "linear", "factor": 2.0})
    got = config_from_hf(raw)
    assert got.sliding_window is None and got.attention_bias
    assert got.rope_scaling_type is None and got.rope_scaling_factor == 1.0


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


LOAD_CASES = [
    # family, stored dtype, format, shard size (KB; 0: one file), dtype
    ("llama", "F32", "safetensors", 0, "f32"),
    ("llama", "F16", "safetensors", 40, "f32"),
    ("llama", "F16", "safetensors", 40, "bf16"),
    ("mistral", "BF16", "safetensors", 0, "f32"),
    ("mistral", "BF16", "safetensors", 0, "bf16"),
    ("qwen2", "F32", "bin", 0, "f32"),
    ("qwen2", "F16", "bin", 40, "bf16"),
]


@pytest.mark.parametrize("family,stored,fmt,shard_kb,dtype", LOAD_CASES)
def test_load_matches_the_reference(tmp_path, family, stored, fmt, shard_kb,
                                    dtype):
    d = write_hf_dir(tmp_path / family, family, stored, fmt, shard_kb)
    if shard_kb:
        index = ("model.safetensors.index.json" if fmt == "safetensors"
                 else "pytorch_model.bin.index.json")
        assert os.path.exists(os.path.join(d, index))
    jdtype, tdtype = {"f32": (jnp.float32, torch.float32),
                      "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jcfg, jparams, jtok = jload(d, dtype=jdtype)
    timings = {}
    tcfg, tparams, ttok = load_model_and_tokenizer(d, dtype=tdtype,
                                                   timings=timings)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    want = dict(_leaves(jax.device_get(jparams)))
    got = dict(_leaves(tparams))
    assert sorted(got) == sorted(want)
    for key, leaf in want.items():
        leaf = np.asarray(leaf)
        assert tuple(got[key].shape) == leaf.shape, key
        assert got[key].dtype == tdtype, key
        assert got[key].is_contiguous(), key
        np.testing.assert_array_equal(
            _bits(got[key]).reshape(-1),
            np.ascontiguousarray(leaf).view(np.uint8).reshape(-1),
            err_msg=str(key))
    assert timings["bytes"] == sum(
        t.numel() * {"F32": 4, "F16": 2, "BF16": 2}[stored]
        for t in hf_model(family).state_dict().values())
    assert isinstance(ttok, HFTokenizer)
    for text in TEXTS:
        for special in (True, False):
            ids = jtok.encode(text, add_special_tokens=special)
            assert ttok.encode(text, add_special_tokens=special) == ids
            assert ttok.decode(ids) == jtok.decode(ids)


def _save_tensors(path, tensors):
    from safetensors.torch import save_file

    save_file(tensors, str(path))


def test_missing_tensor_and_bad_shape_raise_naming_the_file(tmp_path):
    d = write_hf_dir(tmp_path / "llama", "llama")
    from safetensors.torch import load_file

    st = os.path.join(d, "model.safetensors")
    tensors = load_file(st)
    name = "model.layers.1.mlp.up_proj.weight"
    _save_tensors(st, {k: v for k, v in tensors.items() if k != name})
    with pytest.raises(KeyError, match=name):
        load_model_and_tokenizer(d)
    tensors[name] = tensors[name][:, :32].contiguous()
    _save_tensors(st, tensors)
    with pytest.raises(ValueError, match="model.safetensors.*up_proj.*"
                       r"\(128, 32\).*\(128, 64\)"):
        load_model_and_tokenizer(d)


def test_unknown_dtype_raises_naming_it(tmp_path):
    d = write_hf_dir(tmp_path / "llama", "llama")
    from safetensors.torch import load_file

    st = os.path.join(d, "model.safetensors")
    tensors = load_file(st)
    tensors["model.norm.weight"] = tensors["model.norm.weight"].double()
    _save_tensors(st, tensors)
    with pytest.raises(ValueError, match="model.norm.weight.*'F64'"):
        load_model_and_tokenizer(d)
    d2 = write_hf_dir(tmp_path / "qwen2", "qwen2", fmt="bin")
    sd = torch.load(os.path.join(d2, "pytorch_model.bin"), weights_only=True)
    sd["model.norm.weight"] = sd["model.norm.weight"].to(torch.int32)
    torch.save(sd, os.path.join(d2, "pytorch_model.bin"))
    with pytest.raises(ValueError, match="pytorch_model.bin.*torch.int32"):
        load_model_and_tokenizer(d2)


def test_directory_without_a_readable_tokenizer_raises(tmp_path):
    d = write_hf_dir(tmp_path / "bare", "llama", tokenizer=False)
    with pytest.raises(FileNotFoundError, match="no tokenizer"):
        load_model_and_tokenizer(d)
    with pytest.raises(FileNotFoundError, match="no tokenizer"):
        jload(d)  # the reference raises too
    open(os.path.join(d, "tokenizer.model"), "wb").close()
    with pytest.raises(NotImplementedError, match="tokenizer.model"):
        load_model_and_tokenizer(d)
    os.remove(os.path.join(d, "tokenizer.model"))
    with open(os.path.join(d, "config.json")) as f:
        raw = json.load(f)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(dict(raw, model_type="gpt2"), f)
    with pytest.raises(NotImplementedError, match="gpt2"):
        load_model_and_tokenizer(d)
    assert not os.path.exists(os.path.join(str(tmp_path), "missing"))
    with pytest.raises(FileNotFoundError, match="holds no model"):
        hf_weights.HFCheckpoint(str(tmp_path))


@pytest.mark.parametrize("with_tokenizer", [True, False])
def test_export_directory_pairs_with_its_tokenizer(tmp_path, with_tokenizer):
    """A ``model.npz`` export with ``tokenizer.json`` beside it gets that
    tokenizer in both packages; without one, the SimpleTokenizer."""
    jcfg, jparams, _ = jload("preset:debug")
    d = tmp_path / "export"
    export_merged_model(jax.device_get(jparams), jcfg, str(d))
    if with_tokenizer:
        for name in os.listdir(os.path.join(FIXTURES, "llama")):
            shutil.copy(os.path.join(FIXTURES, "llama", name), d)
    _, _, jtok = jload(str(d))
    _, _, ttok = load_model_and_tokenizer(str(d))
    if with_tokenizer:
        assert type(jtok).__name__ == "LlamaTokenizerFast"
        assert isinstance(ttok, HFTokenizer)
    else:
        assert isinstance(ttok, SimpleTokenizer)
        assert type(jtok).__name__ == "SimpleTokenizer"
    for text in TEXTS:
        assert ttok.encode(text, add_special_tokens=True) == \
            jtok.encode(text, add_special_tokens=True)
    assert type(load_tokenizer(str(d))) is type(ttok)
    assert type(jload_tokenizer(str(d))).__name__ == type(jtok).__name__


def test_load_tokenizer_matches_the_reference(tmp_path):
    assert isinstance(load_tokenizer("preset:debug"), SimpleTokenizer)
    assert load_tokenizer(str(tmp_path / "missing")) is None
    assert jload_tokenizer(str(tmp_path / "missing")) is None
    assert load_tokenizer(str(tmp_path)) is None  # an empty directory
    assert jload_tokenizer(str(tmp_path)) is None
    d = write_hf_dir(tmp_path / "qwen2", "qwen2")
    tok, jtok = load_tokenizer(d), jload_tokenizer(d)
    assert isinstance(tok, HFTokenizer)
    assert tok.encode(TEXTS[2]) == jtok.encode(TEXTS[2])
    assert (tok.eos_token_id, tok.pad_token_id, tok.bos_token_id) == \
        (jtok.eos_token_id, jtok.pad_token_id, jtok.bos_token_id)


def test_param_tree_matches_the_config_count(tmp_path):
    """The weight tree's element count is the configuration's (the count
    chip_smoke.py holds the served trees to)."""
    d = write_hf_dir(tmp_path / "qwen2", "qwen2")
    cfg, params, _ = load_model_and_tokenizer(d)
    assert isinstance(cfg, ModelConfig)
    n = sum(t.numel() for _, t in _leaves(params))
    assert n == hf_weights.param_count(cfg) == sum(
        t.numel() for t in hf_model("qwen2").state_dict().values())
