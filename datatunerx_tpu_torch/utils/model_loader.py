"""Model + tokenizer resolution: the port of
``datatunerx_tpu/utils/model_loader.py``.

``model_path`` accepts:

- ``preset:<name>`` — random init from a ModelConfig preset (a seeded
  ``torch.Generator``) with the byte-level SimpleTokenizer;
- a directory with a ``model.npz`` + ``config.json`` export (what the JAX
  package's ``training/checkpoint.export_merged_model`` writes), with the
  HF tokenizer in the same directory when one is there, else the
  SimpleTokenizer;
- an HF checkpoint directory (llama, mistral, qwen2): ``config.json``
  through ``config_from_hf``, the weights streamed by
  ``utils/hf_weights.load_hf_params`` (safetensors or ``pytorch_model.bin``,
  sharded or not), the tokenizer read by ``utils/hf_tokenizer`` from
  ``tokenizer.json``. A directory without a readable tokenizer raises.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from datatunerx_tpu_torch.models.config import ModelConfig, get_config
from datatunerx_tpu_torch.models.convert import params_from_jax
from datatunerx_tpu_torch.models.llama import init_params
from datatunerx_tpu_torch.utils.hf_convert import (
    config_from_hf,
    convert_hf_state_dict,
)
from datatunerx_tpu_torch.utils.hf_tokenizer import load_hf_tokenizer
from datatunerx_tpu_torch.utils.hf_weights import load_hf_params
from datatunerx_tpu_torch.utils.simple_tokenizer import SimpleTokenizer


def load_model_and_tokenizer(
    path_or_preset: str,
    dtype=torch.float32,
    seed: int = 0,
    device="cpu",
    config_overrides: Optional[dict] = None,
    timings: Optional[dict] = None,
) -> Tuple[ModelConfig, dict, object]:
    """``config_overrides`` replaces ModelConfig fields (remat, attention
    implementation, rope scaling), as the trainer CLI passes them.
    ``timings`` (HF directories) receives the weights' read and placement
    seconds and bytes (``hf_weights.load_hf_params``)."""
    overrides = config_overrides or {}
    if path_or_preset.startswith("preset:"):
        cfg = get_config(path_or_preset.split(":", 1)[1], **overrides)
        tok = SimpleTokenizer()
        # byte-level tokenizer needs vocab >= 3000+specials
        if cfg.vocab_size < 3100:
            cfg = dataclasses.replace(cfg, vocab_size=3104)
        params = init_params(cfg, seed=seed, dtype=dtype, device=device)
        return cfg, params, tok

    if not os.path.isdir(path_or_preset):
        raise FileNotFoundError(f"model path {path_or_preset!r} does not exist")
    npz = os.path.join(path_or_preset, "model.npz")
    if os.path.exists(npz):
        with open(os.path.join(path_or_preset, "config.json")) as f:
            raw = json.load(f)
        field_names = {f.name for f in dataclasses.fields(ModelConfig)}
        raw = {k: v for k, v in raw.items() if k in field_names}
        for k in ("head_dim", "sliding_window", "rope_scaling_type",
                  "quantization"):
            if raw.get(k) in ("None", ""):
                raw[k] = None
        raw.update(overrides)
        cfg = ModelConfig(**raw)
        with np.load(npz) as data:
            sd = dict(data)
        params = params_from_jax(convert_hf_state_dict(sd, cfg), cfg,
                                 device=device, dtype=dtype)
        tok = _load_hf_tokenizer(path_or_preset) or SimpleTokenizer()
        return cfg, params, tok

    # HF checkpoint directory
    with open(os.path.join(path_or_preset, "config.json")) as f:
        cfg = config_from_hf(json.load(f))
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    params = load_hf_params(path_or_preset, cfg, dtype=dtype, device=device,
                            timings=timings)
    tok = _load_hf_tokenizer(path_or_preset)
    if tok is None:
        raise FileNotFoundError(f"no tokenizer found under {path_or_preset}")
    return cfg, params, tok


def load_tokenizer(path_or_preset: str):
    """Tokenizer WITHOUT the weights — for components that only need token
    counts (e.g. the gateway's admission estimator). Never initializes
    params; returns None when no tokenizer can be found (callers fall back
    to a chars/token heuristic)."""
    if path_or_preset.startswith("preset:"):
        return SimpleTokenizer()
    if not os.path.isdir(path_or_preset):
        return None
    tok = _load_hf_tokenizer(path_or_preset)
    if tok is None and os.path.exists(
            os.path.join(path_or_preset, "model.npz")):
        # an export written without a tokenizer: the byte-level
        # SimpleTokenizer is what serving pairs with it
        return SimpleTokenizer()
    return tok


def _load_hf_tokenizer(path: str):
    """The directory's HF tokenizer (``tokenizer.json``), or None when it
    holds none. Unlike the reference, a tokenizer that is there but cannot
    be read raises instead of reading as absent."""
    return load_hf_tokenizer(path)
