"""Admission-time memory check for Finetune jobs (the port of
``datatunerx_tpu/operator/capacity.py``).

Bridges the Hyperparameter CR's string-typed parameters and the Finetune
spec to ``parallel/memory.check_fits``, so a controller can reject a job
whose training state cannot fit its cards at admission, with a byte
breakdown, instead of letting it run out of memory on the card. The
budget is named by card: ``generation="h100-80gb"``.

The model is resolved the way the port's trainer resolves it:
``preset:<name>`` or a local directory with ``config.json``. Remote or
unreadable model paths resolve to None and the check ADMITS: an
unresolvable model is not evidence of oversize, and the trainer's own
loader surfaces real path errors.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Tuple



def _truthy(v) -> bool:
    return str(v).lower() in ("true", "1", "yes")


def is_peft(parameters: dict) -> bool:
    """The PEFT truthiness contract of the reference's job generator
    (default true; an empty string counts as set-true)."""
    return str(parameters.get("PEFT", "true")).lower() in ("true", "1", "")


def resolve_model_config(model_path: str, overrides: Optional[dict] = None):
    """ModelConfig the trainer will build, or None when unresolvable here."""
    from datatunerx_tpu_torch.models.config import ModelConfig, get_config

    overrides = overrides or {}
    try:
        if model_path.startswith("preset:"):
            return get_config(model_path.split(":", 1)[1], **overrides)
        cfg_json = os.path.join(model_path, "config.json")
        if os.path.isdir(model_path) and os.path.exists(cfg_json):
            with open(cfg_json) as f:
                raw = json.load(f)
            field_names = {f.name for f in dataclasses.fields(ModelConfig)}
            raw = {k: v for k, v in raw.items() if k in field_names}
            for k in ("head_dim", "sliding_window"):
                if raw.get(k) in ("None", ""):
                    raw[k] = None
            raw.update(overrides)
            return ModelConfig(**raw)
    except Exception:  # noqa: BLE001 — malformed config: let the trainer err
        return None
    return None


def _mesh_shape_from(parameters: dict, n_chips: int) -> Dict[str, int]:
    """EXACTLY the mesh the trainer builds (``tuning/train.build_mesh``):
    the same dims parsing, the same None-axis absorption via
    ``mesh_shape_for``. Raises ValueError when the shape cannot tile
    ``n_chips``, the error the trainer would hit."""
    from datatunerx_tpu_torch.parallel.mesh import mesh_shape_for

    ms = parameters.get("meshShape")
    dims: Dict[str, int] = {}
    if isinstance(ms, dict):
        dims = {k: int(v) for k, v in ms.items()}
    elif isinstance(ms, str) and ms:
        for part in ms.split(","):
            k, _, v = part.partition("=")
            dims[k.strip()] = int(v)
    dims.pop("dcn", None)
    shape = mesh_shape_for(
        n_chips,
        dp=dims.get("dp"),
        fsdp=dims.get("fsdp", 1 if "dp" in dims else None),
        tp=dims.get("tp", 1),
        sp=dims.get("sp", 1),
    )
    return dict(zip(("dp", "fsdp", "tp", "sp"), shape))


def check_admission(
    model_path: str,
    parameters: dict,
    *,
    n_chips: int,
    generation: str = "h100-80gb",
) -> Optional[Tuple[str, dict]]:
    """→ None to admit, or (reason, footprint_gb) to reject.

    ``parameters`` is the merged Hyperparameter map (string-typed values,
    reference quirk). Only rejects when the model config is resolvable AND
    the exact+analytic estimate exceeds the per-card budget.
    """
    import torch

    overrides: dict = {}
    if _truthy(parameters.get("int8")):
        overrides["quantization"] = "int8"
    elif _truthy(parameters.get("int4")):
        overrides["quantization"] = "int4"
    if parameters.get("attention"):
        overrides["attention_impl"] = str(parameters["attention"])
    cfg = resolve_model_config(model_path, overrides)
    if cfg is None:
        return None

    from datatunerx_tpu_torch.parallel.memory import check_fits
    from datatunerx_tpu_torch.training.train_lib import TrainConfig

    try:
        train_cfg = TrainConfig(
            finetuning_type="lora" if is_peft(parameters) else "full",
            lora_rank=int(float(parameters.get("loRA_R", 8))),
            lora_targets=tuple(
                str(parameters.get("loRATarget", "q_proj,v_proj")).split(",")),
            optimizer=str(parameters.get("optimizer", "adamw")).lower(),
            grad_accum=int(float(parameters.get("gradAccSteps", 1))),
            compute_dtype=torch.bfloat16,
        )
        per_device_batch = int(float(parameters.get("batchSize", 8)))
        seq = int(float(parameters.get("blockSize", 1024)))
    except (TypeError, ValueError):
        # garbled numerics are the webhooks' problem, not admission's
        return None

    try:
        mesh_shape = _mesh_shape_from(parameters, n_chips)
    except ValueError as e:
        # the trainer's mesh_shape_for would raise the same on the cards:
        # surface it at admission instead
        return (f"meshShape cannot tile the assigned {n_chips} devices: {e}",
                {})
    # batchSize is PER-DEVICE (--per_device_train_batch_size); the trainer's
    # global batch is per_device * data_par * grad_accum (tuning/train.py).
    # estimate_footprint takes the GLOBAL batch and
    # divides back by the same factors, so the per-device microbatch it
    # models equals batchSize exactly.
    data_par = mesh_shape.get("dp", 1) * mesh_shape.get("fsdp", 1)
    batch = per_device_batch * data_par * train_cfg.grad_accum

    try:
        fits, fp, budget = check_fits(
            cfg, train_cfg, batch=batch, seq=seq,
            mesh_shape=mesh_shape, generation=generation)
    except Exception:  # noqa: BLE001 — estimator bug must never block jobs
        return None
    if fits:
        return None
    return (
        f"estimated memory footprint {fp.total / 1e9:.1f} GB/card exceeds the "
        f"{generation} budget {budget / 1e9:.1f} GB at "
        f"batch={batch} seq={seq} mesh={mesh_shape} "
        f"(breakdown GB: {fp.gb()}); shard further (meshShape), lower "
        f"batchSize/blockSize, or quantize (int4)", fp.gb())


def serving_replicas_for(
    hint: dict,
    *,
    min_replicas: int = 1,
    max_replicas: int = 8,
    free_slices: Optional[int] = None,
) -> int:
    """Turn the gateway's autoscale hint (gateway/autoscale.py, polled from
    GET /autoscale) into the replica count the controller should apply.

    The gateway only observes (queue depth, shed count, p95); capacity
    policy lives HERE: the spec's min/max bounds and, when a pool of free
    devices is known, that inventory caps scale-up, so the controller never
    asks for replicas the hardware can't place."""
    current = max(1, int(hint.get("replicas", 1)))
    desired = int(hint.get("desiredReplicas", current))
    desired = max(min_replicas, min(max_replicas, desired))
    if free_slices is not None and desired > current:
        desired = min(desired, current + max(0, int(free_slices)))
    return desired
