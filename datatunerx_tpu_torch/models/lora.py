"""LoRA: low-rank adapters as a separate param collection (the port of
``datatunerx_tpu/models/lora.py``).

Adapters live in their own nested dict mirroring ``params["layers"]`` with
stacked ``[L, ...]`` leaves: ``{"layers": {target: {"a": [L, d_in, r],
"b": [L, r, d_out]}}}``, so the optimizer state covers only the adapters and
``forward(..., lora=(lora_params, scaling))`` applies
``h W + (drop(h) A) B * scale`` inside each projection. ``merge_lora`` folds
them into the base kernels for export (PEFT ``merge_and_unload``).

Init matches PEFT: A ~ kaiming-uniform(a=sqrt(5)) over fan_in (bound
1/sqrt(d_in)), B = 0, so the delta starts at zero. A is drawn by the
threefry twin (``ops/prng.py``) as the reference draws it,
``uniform(fold_in(key, i), (L, d_in, r), -bound, bound)`` for the i-th
target in sorted order, so a key gives the reference's adapters bit for
bit.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from datatunerx_tpu_torch.models.config import ModelConfig
from datatunerx_tpu_torch.ops import prng

# Valid llama-family targets (reference cmd/tuning/parser.py:150-160).
LORA_TARGETS = (
    "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj",
)
DEFAULT_TARGETS = ("q_proj", "v_proj")


def target_dims(cfg: ModelConfig, name: str) -> tuple[int, int]:
    D, F = cfg.hidden_size, cfg.intermediate_size
    return {
        "q_proj": (D, cfg.q_dim),
        "k_proj": (D, cfg.kv_dim),
        "v_proj": (D, cfg.kv_dim),
        "o_proj": (cfg.q_dim, D),
        "gate_proj": (D, F),
        "up_proj": (D, F),
        "down_proj": (F, D),
    }[name]


def lora_scaling(alpha: float, rank: int) -> float:
    return float(alpha) / float(rank)


def init_lora_params(
    cfg: ModelConfig,
    key=0,
    rank: int = 8,
    targets: Sequence[str] = DEFAULT_TARGETS,
    dtype=torch.float32,
    device="cpu",
):
    for t in targets:
        if t not in LORA_TARGETS:
            raise ValueError(f"invalid lora target {t!r}; choices: {LORA_TARGETS}")
    if isinstance(key, (int, np.integer)):
        key = prng.PRNGKey(int(key))
    L = cfg.num_layers
    layers = {}
    for i, t in enumerate(sorted(set(targets))):
        d_in, d_out = target_dims(cfg, t)
        bound = 1.0 / math.sqrt(d_in)
        # drawn on the host (a few hundred thousand values), then moved
        a = prng.uniform(prng.fold_in(key, i), (L, d_in, rank), -bound, bound)
        layers[t] = {"a": torch.from_numpy(a).to(device=device, dtype=dtype),
                     "b": torch.zeros((L, rank, d_out), dtype=dtype,
                                      device=device)}
    return {"layers": layers}


def num_lora_params(lora_params) -> int:
    return sum(ab[leaf].numel() for ab in lora_params["layers"].values()
               for leaf in ab)


def merge_lora(params, lora_params, scaling: float):
    """Fold adapters into base kernels: W' = W + A·B·scaling (per layer, in
    f32, rounded once to the kernel's dtype). Returns a new tree; the input
    trees are untouched."""
    layers = dict(params["layers"])
    for t, ab in lora_params["layers"].items():
        delta = torch.einsum("lir,lro->lio", ab["a"].float(),
                             ab["b"].float()) * scaling
        proj = dict(layers[t])
        proj["kernel"] = (proj["kernel"].float() + delta).to(
            layers[t]["kernel"].dtype)
        layers[t] = proj
    out = dict(params)
    out["layers"] = layers
    return out
