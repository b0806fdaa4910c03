"""HF-layout state dict → stacked param tree (numpy).

A copy of ``convert_hf_state_dict`` from ``datatunerx_tpu/utils/hf_convert.py``.
It is what reads the ``model.npz`` that the JAX package's
``training/checkpoint.export_merged_model`` writes: per-layer tensors are
stacked along a leading layer axis and torch ``Linear`` ``[out, in]`` weights
are transposed to ``[in, out]``. The result is a nested dict of numpy arrays
with the reference's leaf names; ``models/convert.params_from_jax`` moves it
onto a device.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from datatunerx_tpu_torch.models.config import ModelConfig

_LAYER_KERNELS = [
    ("self_attn.q_proj", "q_proj"),
    ("self_attn.k_proj", "k_proj"),
    ("self_attn.v_proj", "v_proj"),
    ("self_attn.o_proj", "o_proj"),
    ("mlp.gate_proj", "gate_proj"),
    ("mlp.up_proj", "up_proj"),
    ("mlp.down_proj", "down_proj"),
]
_LAYER_NORMS = [
    ("input_layernorm", "input_layernorm"),
    ("post_attention_layernorm", "post_attention_layernorm"),
]


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def convert_hf_state_dict(
    sd: Mapping[str, "np.ndarray"], cfg: ModelConfig, dtype=np.float32
):
    """Convert an HF llama/mistral/qwen2 state_dict to the stacked tree."""
    L = cfg.num_layers
    prefix = "model." if any(k.startswith("model.") for k in sd) else ""

    def get(k):
        return _np(sd[prefix + k])

    layers: dict = {}
    for hf_name, our_name in _LAYER_KERNELS:
        kernels = np.stack(
            [get(f"layers.{i}.{hf_name}.weight").T for i in range(L)]
        ).astype(dtype)
        layers[our_name] = {"kernel": kernels}
        bias_key = f"{prefix}layers.0.{hf_name}.bias"
        if bias_key in sd:
            layers[our_name]["bias"] = np.stack(
                [_np(sd[f"{prefix}layers.{i}.{hf_name}.bias"]) for i in range(L)]
            ).astype(dtype)
    for hf_name, our_name in _LAYER_NORMS:
        layers[our_name] = {
            "scale": np.stack(
                [get(f"layers.{i}.{hf_name}.weight") for i in range(L)]
            ).astype(dtype)
        }

    params = {
        "embed_tokens": {"embedding": get("embed_tokens.weight").astype(dtype)},
        "layers": layers,
        "norm": {"scale": get("norm.weight").astype(dtype)},
    }
    if "lm_head.weight" in sd and not cfg.tie_word_embeddings:
        params["lm_head"] = {"kernel": _np(sd["lm_head.weight"]).T.astype(dtype)}
    return params
