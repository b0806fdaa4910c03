"""Model + tokenizer resolution: the port of
``datatunerx_tpu/utils/model_loader.py``.

``model_path`` accepts:

- ``preset:<name>`` — random init from a ModelConfig preset (a seeded
  ``torch.Generator``) with the byte-level SimpleTokenizer;
- a directory with a ``model.npz`` + ``config.json`` export (what the JAX
  package's ``training/checkpoint.export_merged_model`` writes), served with
  the SimpleTokenizer.

HF checkpoint directories come with a later slice (ROADMAP Queue 1, "HF
loading").
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Tuple

import numpy as np
import torch

from datatunerx_tpu_torch.models.config import ModelConfig, get_config
from datatunerx_tpu_torch.models.convert import params_from_jax
from datatunerx_tpu_torch.models.llama import init_params
from datatunerx_tpu_torch.utils.hf_convert import convert_hf_state_dict
from datatunerx_tpu_torch.utils.simple_tokenizer import SimpleTokenizer


def load_model_and_tokenizer(
    path_or_preset: str,
    dtype=torch.float32,
    seed: int = 0,
    device="cpu",
) -> Tuple[ModelConfig, dict, object]:
    if path_or_preset.startswith("preset:"):
        cfg = get_config(path_or_preset.split(":", 1)[1])
        tok = SimpleTokenizer()
        # byte-level tokenizer needs vocab >= 3000+specials
        if cfg.vocab_size < 3100:
            cfg = dataclasses.replace(cfg, vocab_size=3104)
        params = init_params(cfg, seed=seed, dtype=dtype, device=device)
        return cfg, params, tok

    if not os.path.isdir(path_or_preset):
        raise FileNotFoundError(f"model path {path_or_preset!r} does not exist")
    npz = os.path.join(path_or_preset, "model.npz")
    if not os.path.exists(npz):
        raise NotImplementedError(
            f"{path_or_preset!r} holds no model.npz export; HF checkpoint "
            "directories are not ported yet (ROADMAP Queue 1, 'HF loading')")
    with open(os.path.join(path_or_preset, "config.json")) as f:
        raw = json.load(f)
    field_names = {f.name for f in dataclasses.fields(ModelConfig)}
    raw = {k: v for k, v in raw.items() if k in field_names}
    for k in ("head_dim", "sliding_window", "rope_scaling_type",
              "quantization"):
        if raw.get(k) in ("None", ""):
            raw[k] = None
    cfg = ModelConfig(**raw)
    with np.load(npz) as data:
        sd = dict(data)
    params = params_from_jax(convert_hf_state_dict(sd, cfg), cfg,
                             device=device, dtype=dtype)
    return cfg, params, SimpleTokenizer()
