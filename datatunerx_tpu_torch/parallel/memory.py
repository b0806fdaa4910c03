"""Per-card memory footprint of a training job (the port of
``datatunerx_tpu/parallel/memory.py``).

- ``estimate_footprint`` sums params, LoRA adapters, optimizer state,
  gradients, activation and logit peaks into bytes per card for a model
  config, a train config, a batch geometry and a mesh shape.
- Params, the trainable tree and the optimizer state are counted EXACTLY,
  from the same ``init_params`` / ``quantize_model_params`` /
  ``init_lora_params`` / ``optimizer.init`` calls the trainer makes, on
  the meta device (shapes and dtypes, no storage), then divided per leaf by
  the shard factors of ``parallel/sharding``'s rules.
- Activations and logits are analytic. ``activations="reference"`` gives
  the reference's formulas term for term. The default, ``"port"``, models
  the port's own remat, which keeps more (a divergence by design, measured
  on the H100 by ``chip_smoke.py`` phase 15):
    * ``dots`` saves every 2-D matmul output (``aten.mm``): each unquantized
      projection's output (``q + 2·kv + 2·D + 2·F`` a token, where the
      reference counts ``3·D + 2·F``) and each LoRA ``x·A`` and ``(x·A)·B``;
      a quantized projection runs a custom kernel and is recomputed;
    * a layer's recompute keeps its whole live set at once: the two norms'
      f32 intermediates (``6·D·4`` bytes a token) plus the attention and
      the MLP terms (the reference takes the larger of the last two);
    * the logits are bf16, then an f32 copy, and the loss's backward holds
      two f32 gradients: ``2 + 3·4`` bytes an element (the reference's
      ``cdt + 4 + 4``).
- ``check_fits`` turns the estimate into an admission verdict against a
  card's budget (``hbm_budget``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

from datatunerx_tpu_torch.models.config import ModelConfig
from datatunerx_tpu_torch.parallel.sharding import _spec_for

# Usable memory per device. The TPU rows are the reference's (a budget for
# the operator's admission of a TPU job); the card's row is
# ``torch.cuda.get_device_properties(0).total_memory`` as an NVIDIA H100
# 80GB HBM3 reports it (chip_smoke.py phase 15 holds the value).
HBM_BYTES = {
    "v4": 32e9,
    "v5e": 16e9,
    "v5p": 95e9,
    "v6e": 32e9,
    "h100-80gb": 85_017_493_504,
}
# The reserve, the reference's 6 % for every generation. On the card it
# covers the CUDA context, the cuBLAS and NCCL workspaces (together under
# 1.5 GB) and the caching allocator's fragmentation: 5.1 GB of an 80 GB card.
RESERVE_FRACTION = 0.06
ACTIVATION_MARGIN = 1.10


@dataclasses.dataclass(frozen=True)
class Footprint:
    """Bytes per device, by component."""

    params: int
    lora: int
    opt_state: int
    grads: int
    activations: int
    logits: int
    fsdp_gather: int = 0  # whole-stack weight gathers (fsdp > 1 only)

    @property
    def total(self) -> int:
        return (self.params + self.lora + self.opt_state + self.grads
                + self.activations + self.logits + self.fsdp_gather)

    def gb(self) -> Dict[str, float]:
        d = {f.name: round(getattr(self, f.name) / 1e9, 3)
             for f in dataclasses.fields(self)}
        d["total"] = round(self.total / 1e9, 3)
        return d


def _leaves_with_path(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_path(v, path + (k,))
    elif isinstance(tree, torch.Tensor):
        yield path, tree


def _shard_divisor(path, x, mesh_shape: Dict[str, int]) -> int:
    """Product of the mesh-axis sizes the sharding rules cut this leaf by."""
    div = 1
    for ax in _spec_for(path, x):
        if ax is not None:
            div *= mesh_shape.get(ax, 1)
    return div


def _tree_bytes(tree, mesh_shape: Dict[str, int],
                dtype_override=None) -> int:
    total = 0
    for path, leaf in _leaves_with_path(tree):
        size = math.prod(leaf.shape) if leaf.dim() else 1
        itemsize = (torch.empty((), dtype=dtype_override).element_size()
                    if dtype_override is not None else leaf.element_size())
        total += math.ceil(size / _shard_divisor(path, leaf, mesh_shape)
                           ) * itemsize
    return total


def estimate_footprint(
    model_cfg: ModelConfig,
    train_cfg,
    *,
    batch: int,
    seq: int,
    mesh_shape: Optional[Dict[str, int]] = None,
    compute_dtype=torch.bfloat16,
    activations: str = "port",
) -> Footprint:
    """Bytes per card for one train step of ``Trainer`` at this geometry.

    ``mesh_shape`` maps axis → size ({'dp': 1, 'fsdp': 8, 'tp': 1, 'sp':
    1}); missing axes are 1. ``activations``: ``"port"`` (the port's remat)
    or ``"reference"`` (the reference's formulas)."""
    from datatunerx_tpu_torch.models.llama import init_params
    from datatunerx_tpu_torch.models.lora import init_lora_params, target_dims
    from datatunerx_tpu_torch.training.optimizer import make_optimizer

    if activations not in ("port", "reference"):
        raise ValueError(f"activations must be port or reference, got "
                         f"{activations!r}")
    mesh_shape = dict(mesh_shape or {})
    cdt = torch.empty((), dtype=compute_dtype).element_size()

    # ---- params (exact): the trainer's init (+ quantize), on meta
    params = init_params(model_cfg, dtype=compute_dtype, device="meta")
    if model_cfg.quantization:
        from datatunerx_tpu_torch.ops.quant import quantize_model_params

        params = quantize_model_params(params, model_cfg.quantization)
    params_bytes = _tree_bytes(params, mesh_shape)

    # ---- trainable tree (exact)
    lora_bytes = 0
    lora_targets = ()
    if train_cfg.finetuning_type == "lora":
        lora_targets = tuple(train_cfg.lora_targets)
        trainable = init_lora_params(model_cfg, 0, rank=train_cfg.lora_rank,
                                     targets=lora_targets, device="meta")
        lora_bytes = _tree_bytes(trainable, mesh_shape)
    elif train_cfg.finetuning_type == "none":
        trainable = None
    else:  # full / freeze: the base params are the trainable tree
        trainable = params

    # ---- optimizer state (exact): the trainer's optimizer.init
    opt_bytes = grad_bytes = 0
    if trainable is not None:
        optimizer = make_optimizer(
            train_cfg.optimizer, train_cfg.learning_rate,
            weight_decay=train_cfg.weight_decay,
            max_grad_norm=train_cfg.max_grad_norm)
        opt_bytes = _tree_bytes(optimizer.init(trainable), mesh_shape)
        # gradients: one trainable-shaped tree, f32 accumulation worst case
        grad_bytes = _tree_bytes(trainable, mesh_shape,
                                 dtype_override=torch.float32)

    # ---- activations (analytic): the local batch and sequence
    data_shards = mesh_shape.get("dp", 1) * mesh_shape.get("fsdp", 1)
    tp = mesh_shape.get("tp", 1)
    b = math.ceil(batch / data_shards)
    b = math.ceil(b / max(1, getattr(train_cfg, "grad_accum", 1)))
    t = math.ceil(seq / mesh_shape.get("sp", 1))
    H = model_cfg.hidden_size
    L = model_cfg.num_layers
    I = model_cfg.intermediate_size  # noqa: E741
    V = model_cfg.vocab_size

    # fsdp's gather: the reference models XLA's whole-stack gathers of the
    # two largest fsdp-sharded stacked leaves; the port's trainer gathers
    # every fsdp-sharded leaf whole before the forward (tp shards stay)
    fsdp = mesh_shape.get("fsdp", 1)
    gather_bytes = 0
    if fsdp > 1:
        cut = [(path, leaf) for path, leaf in _leaves_with_path(params)
               if _shard_divisor(path, leaf, {"fsdp": fsdp}) > 1]
        if activations == "reference":
            stacked = [math.prod(leaf.shape) * leaf.element_size()
                       for _, leaf in cut]
            gather_bytes = sum(sorted(stacked, reverse=True)[:2])
        else:
            tp_only = {"tp": tp}
            gather_bytes = sum(
                math.ceil(math.prod(leaf.shape)
                          / _shard_divisor(path, leaf, tp_only))
                * leaf.element_size() for path, leaf in cut)

    attn_xla = 2 * b * model_cfg.num_heads * t * t * 4 // tp  # f32 scores
    attn_flash = 4 * b * t * (model_cfg.q_dim + 2 * model_cfg.kv_dim
                              ) // tp * cdt
    attn = attn_xla if model_cfg.attention_impl == "xla" else attn_flash
    if model_cfg.remat in ("full", "dots"):
        boundaries = 2 * L * b * t * H * cdt
        mlp = 6 * b * t * I // tp * cdt
        if activations == "reference":
            if model_cfg.remat == "dots":
                boundaries += L * b * t * (3 * H + 2 * I) // tp * cdt
            act_bytes = boundaries + max(attn, mlp)
        else:
            if model_cfg.remat == "dots":
                per_token = 0
                if not model_cfg.quantization:
                    per_token += (model_cfg.q_dim + 2 * model_cfg.kv_dim
                                  + 2 * H + 2 * I) // tp
                for name in lora_targets:
                    per_token += (train_cfg.lora_rank
                                  + target_dims(model_cfg, name)[1])
                boundaries += L * b * t * per_token * cdt
            norms = 6 * b * t * H * 4
            act_bytes = boundaries + norms + attn + mlp
    else:  # remat none: every layer's internals stay live for the bwd
        per_layer = (attn + 4 * b * t * H * cdt
                     + 3 * b * t * I // tp * cdt)
        act_bytes = L * per_layer
    act_bytes = int(act_bytes * ACTIVATION_MARGIN)

    # ---- logits: [b, t, V] (V over tp in the reference's rules)
    per_logit = (cdt + 4 + 4) if activations == "reference" else (cdt + 12)
    logits_bytes = b * t * math.ceil(V / tp) * per_logit

    return Footprint(
        params=params_bytes, lora=lora_bytes, opt_state=opt_bytes,
        grads=grad_bytes, activations=act_bytes, logits=logits_bytes,
        fsdp_gather=gather_bytes,
    )


def hbm_budget(generation: str = "h100-80gb") -> int:
    """Admission budget: usable memory a device after the reserve."""
    if generation not in HBM_BYTES:
        raise KeyError(f"unknown device generation {generation!r}; "
                       f"have {sorted(HBM_BYTES)}")
    return int(HBM_BYTES[generation] * (1 - RESERVE_FRACTION))


def check_fits(
    model_cfg: ModelConfig,
    train_cfg,
    *,
    batch: int,
    seq: int,
    mesh_shape: Optional[Dict[str, int]] = None,
    generation: str = "h100-80gb",
) -> tuple:
    """→ (fits: bool, footprint: Footprint, budget_bytes: int)."""
    fp = estimate_footprint(model_cfg, train_cfg, batch=batch, seq=seq,
                            mesh_shape=mesh_shape)
    budget = hbm_budget(generation)
    return fp.total <= budget, fp, budget
