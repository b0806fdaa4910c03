"""HF-layout state dict ⇄ stacked param tree (numpy), and HF configs.

Copies of ``convert_hf_state_dict``, ``export_hf_state_dict`` and
``config_from_hf`` from ``datatunerx_tpu/utils/hf_convert.py``.
``convert_hf_state_dict`` reads the ``model.npz`` that the JAX package's
``training/checkpoint.export_merged_model`` writes: per-layer tensors are
stacked along a leading layer axis and torch ``Linear`` ``[out, in]`` weights
are transposed to ``[in, out]``. The result is a nested dict of numpy arrays
with the reference's leaf names; ``models/convert.params_from_jax`` moves it
onto a device. HF checkpoint directories stream through
``utils/hf_weights.py`` into the same tree.
"""

from __future__ import annotations

from typing import Any, Mapping

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


def _host(x) -> np.ndarray:
    """A tensor (any device/dtype) or array → a float32 numpy array."""
    if hasattr(x, "detach"):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def export_hf_state_dict(params, cfg: ModelConfig) -> dict:
    """Inverse of convert_hf_state_dict (float32 numpy arrays, HF key
    names; a copy of the reference's ``export_hf_state_dict``)."""
    out = {"model.embed_tokens.weight": _host(params["embed_tokens"]["embedding"])}
    layers = params["layers"]
    for hf_name, our_name in _LAYER_KERNELS:
        kern = _host(layers[our_name]["kernel"])
        for i in range(cfg.num_layers):
            out[f"model.layers.{i}.{hf_name}.weight"] = kern[i].T
        if "bias" in layers[our_name]:
            bias = _host(layers[our_name]["bias"])
            for i in range(cfg.num_layers):
                out[f"model.layers.{i}.{hf_name}.bias"] = bias[i]
    for hf_name, our_name in _LAYER_NORMS:
        scale = _host(layers[our_name]["scale"])
        for i in range(cfg.num_layers):
            out[f"model.layers.{i}.{hf_name}.weight"] = scale[i]
    out["model.norm.weight"] = _host(params["norm"]["scale"])
    if "lm_head" in params:
        out["lm_head.weight"] = _host(params["lm_head"]["kernel"]).T
    return out


_REQUIRED = object()


def _hf_field(hf_cfg, name: str, default: Any = _REQUIRED):
    """``hf_cfg.name`` of a transformers config, or ``hf_cfg[name]`` of a
    ``config.json`` dict; ``default`` when absent (required without one)."""
    if isinstance(hf_cfg, Mapping):
        if name in hf_cfg:
            return hf_cfg[name]
    elif hasattr(hf_cfg, name):
        return getattr(hf_cfg, name)
    if default is _REQUIRED:
        raise KeyError(f"HF config has no {name!r}")
    return default


def config_from_hf(hf_cfg) -> ModelConfig:
    """Build a ModelConfig from an HF config (llama/mistral/qwen2): a
    ``PretrainedConfig`` or the plain dict of its ``config.json``. The
    reference's field rules: q/k/v biases for ``qwen2`` or an explicit
    ``attention_bias``; the sliding window only for ``mistral``;
    ``rope_scaling`` is not mapped."""
    model_type = _hf_field(hf_cfg, "model_type", "llama")
    heads = _hf_field(hf_cfg, "num_attention_heads")
    kv_heads = _hf_field(hf_cfg, "num_key_value_heads", heads)
    return ModelConfig(
        name=model_type,
        vocab_size=_hf_field(hf_cfg, "vocab_size"),
        hidden_size=_hf_field(hf_cfg, "hidden_size"),
        intermediate_size=_hf_field(hf_cfg, "intermediate_size"),
        num_layers=_hf_field(hf_cfg, "num_hidden_layers"),
        num_heads=heads,
        num_kv_heads=heads if kv_heads is None else kv_heads,
        max_seq_len=_hf_field(hf_cfg, "max_position_embeddings"),
        rope_theta=_hf_field(hf_cfg, "rope_theta", 10000.0),
        rms_norm_eps=_hf_field(hf_cfg, "rms_norm_eps"),
        tie_word_embeddings=_hf_field(hf_cfg, "tie_word_embeddings", False),
        attention_bias=model_type == "qwen2"
        or _hf_field(hf_cfg, "attention_bias", False),
        sliding_window=_hf_field(hf_cfg, "sliding_window", None)
        if model_type == "mistral"
        else None,
    )
