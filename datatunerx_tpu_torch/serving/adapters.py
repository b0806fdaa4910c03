"""Adapter-checkpoint utilities for multi-adapter serving (the port of
``datatunerx_tpu/serving/adapters.py``).

``make_adapter_checkpoint`` writes a LoRA adapter checkpoint with random
weights in the layout of the port's trainer (``<path>/1/state.pt`` holding
``{"lora": {"layers": ...}}``, loadable by
``batched_engine.load_checkpoint_state``) without a training run. The
numbers mean nothing; routing, pooling and isolation are what it serves
to check.
"""

from __future__ import annotations

import os

import torch

from datatunerx_tpu_torch.models.config import get_config
from datatunerx_tpu_torch.models.lora import init_lora_params
from datatunerx_tpu_torch.training.checkpoint import save_raw_state


def make_adapter_checkpoint(path: str, model: str, seed: int,
                            rank: int = 4,
                            targets=("q_proj", "v_proj")) -> str:
    """Write a random LoRA adapter checkpoint under ``path`` and return it.
    A is PEFT's init (the threefry twin's draw from ``seed``), B is drawn
    too, from a ``torch.Generator`` (init's zero B would make every adapter
    a no-op)."""
    cfg = get_config(model.split(":")[-1])
    lora = init_lora_params(cfg, seed, rank=rank, targets=tuple(targets))
    gen = torch.Generator().manual_seed(1000 + seed)
    layers = {}
    for t, leaf in sorted(lora["layers"].items()):
        b = 0.05 * torch.randn(leaf["b"].shape, generator=gen,
                               dtype=torch.float32)
        layers[t] = {"a": leaf["a"], "b": b}
    save_raw_state(path, 1, {"step": 1, "lora": {"layers": layers}})
    return path


def make_adapter_sweep(base_path: str, model: str, count: int,
                       ranks=(2, 4, 8), targets=("q_proj", "v_proj"),
                       seed: int = 0) -> dict:
    """``count`` random adapters cycling through ``ranks``: a mixed-rank
    tenant population. Returns {name: checkpoint_path}; names are
    ``ad<i>-r<rank>`` so a failure message states the rank."""
    out = {}
    for i in range(count):
        rank = ranks[i % len(ranks)]
        name = f"ad{i}-r{rank}"
        out[name] = make_adapter_checkpoint(
            os.path.join(base_path, name), model, seed=seed + i,
            rank=rank, targets=targets)
    return out
