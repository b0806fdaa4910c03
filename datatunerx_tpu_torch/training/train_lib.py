"""The SFT train/eval loop in PyTorch (the port of
``datatunerx_tpu/training/train_lib.py``).

One ``Trainer`` covers the finetuning types:

  lora   — optimizer state over the adapter tree only; base params frozen
  freeze — the last ``num_layer_trainable`` layers of a module group train,
           as a per-layer mask over the group's stacked [L, ...] leaves; the
           optimizer sees only the group (the reference's multi_transform)
  full   — everything trains
  none   — eval only

Gradient accumulation is exact: per-microbatch grads of the *sum* NLL are
accumulated and divided once by the total valid-token count, so the result
equals one big batch whatever the padding imbalance. PyTorch runs eagerly:
there is no step memo and no jit. The update is applied in the update's
dtype and cast back to the param's. DPO/RM/PPO stages are not ported yet
(ROADMAP Queue 1 items 8 and 11).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence

import torch

from datatunerx_tpu_torch.data.prefetch import to_device
from datatunerx_tpu_torch.models.config import ModelConfig
from datatunerx_tpu_torch.models.llama import forward, mix_seed
from datatunerx_tpu_torch.models.lora import (
    DEFAULT_TARGETS,
    init_lora_params,
    lora_scaling,
)
from datatunerx_tpu_torch.training.loss import causal_lm_loss
from datatunerx_tpu_torch.training.optimizer import (
    global_norm,
    make_optimizer,
    make_schedule,
    tree_leaves,
    tree_map,
)

_ATTN_MODULES = ("q_proj", "k_proj", "v_proj", "o_proj")
_MLP_MODULES = ("gate_proj", "up_proj", "down_proj")


def _freeze_selected_modules(train_cfg) -> tuple:
    """The trainable module group for freeze tuning (reference
    ``--name_module_trainable``): the one source for both the optimizer's
    subtree and the gradient mask."""
    return (_MLP_MODULES if train_cfg.name_module_trainable in ("mlp",)
            else _ATTN_MODULES)


@dataclasses.dataclass
class TrainConfig:
    finetuning_type: str = "lora"  # lora | freeze | full | none
    lora_rank: int = 8
    lora_alpha: float = 32.0
    lora_dropout: float = 0.1
    lora_targets: Sequence[str] = DEFAULT_TARGETS
    num_layer_trainable: int = 3
    name_module_trainable: str = "mlp"
    learning_rate: float = 2e-4
    scheduler: str = "cosine"
    optimizer: str = "adamw"
    warmup_ratio: float = 0.0
    weight_decay: float = 0.0
    max_grad_norm: float = 1.0
    total_steps: int = 1000
    grad_accum: int = 1
    neftune_alpha: float = 0.0
    compute_dtype: Any = torch.bfloat16

    def __post_init__(self):
        if self.finetuning_type not in ("lora", "freeze", "full", "none"):
            raise ValueError(
                f"invalid finetuning_type {self.finetuning_type!r}")


@dataclasses.dataclass
class TrainState:
    step: int
    params: Any
    lora: Any  # None unless finetuning_type == "lora"
    opt_state: Any
    seed: int  # dropout/NEFTune streams derive from (seed, step, microbatch)


def resolve_device(device) -> torch.device:
    """CUDA unless the caller asks for the CPU; CUDA without a card raises."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "training runs on CUDA by default and no CUDA device is "
                "visible; pass device='cpu' (--device cpu) to run on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


class Trainer:
    def __init__(self, model_cfg: ModelConfig, train_cfg: TrainConfig,
                 device="cuda"):
        self.model_cfg = model_cfg
        self.cfg = train_cfg
        self.device = resolve_device(device)
        self.schedule = make_schedule(
            train_cfg.scheduler, train_cfg.learning_rate,
            train_cfg.total_steps, train_cfg.warmup_ratio)
        self.optimizer = make_optimizer(
            train_cfg.optimizer, self.schedule,
            weight_decay=train_cfg.weight_decay,
            max_grad_norm=train_cfg.max_grad_norm)
        self.scaling = lora_scaling(train_cfg.lora_alpha, train_cfg.lora_rank)

    # ---------------------------------------------------------------- state
    def init_state(self, params, seed: int) -> TrainState:
        lora = None
        if self.cfg.finetuning_type == "lora":
            lora = init_lora_params(
                self.model_cfg, seed=mix_seed(seed, 0x10AA),
                rank=self.cfg.lora_rank, targets=tuple(self.cfg.lora_targets),
                device=self.device)
        opt_state = ()
        if self.cfg.finetuning_type != "none":
            opt_state = self.optimizer.init(self._trainable(params, lora))
        return TrainState(step=0, params=params, lora=lora,
                          opt_state=opt_state, seed=seed)

    def _trainable(self, params, lora):
        """The tree the optimizer sees."""
        kind = self.cfg.finetuning_type
        if kind == "lora":
            return lora
        if kind == "freeze":
            modules = _freeze_selected_modules(self.cfg)
            return {"layers": {m: params["layers"][m] for m in modules}}
        return params

    def _with_trainable(self, state: TrainState, new) -> dict:
        """(params, lora) with the trainable tree replaced by ``new``."""
        kind = self.cfg.finetuning_type
        if kind == "lora":
            return dict(params=state.params, lora=new)
        if kind == "freeze":
            layers = dict(state.params["layers"])
            layers.update(new["layers"])
            return dict(params=dict(state.params, layers=layers),
                        lora=None)
        return dict(params=new, lora=None)

    def _freeze_mask(self, trainable):
        """Per-leaf [L, 1, ...] masks: only the last num_layer_trainable
        layers of the group move."""
        L = self.model_cfg.num_layers
        n = self.cfg.num_layer_trainable
        ok = (torch.arange(L, device=self.device) >= L - n).float()
        return tree_map(lambda x: ok.reshape((L,) + (1,) * (x.dim() - 1)),
                        trainable)

    # ----------------------------------------------------------------- loss
    def _forward_loss(self, params, lora, batch, seed: Optional[int],
                      train: bool):
        logits, _ = forward(
            params, batch["input_ids"], self.model_cfg,
            attention_mask=batch.get("attention_mask"),
            segment_ids=batch.get("segment_ids"),
            positions=batch.get("positions"),
            lora=(lora, self.scaling) if lora is not None else None,
            compute_dtype=self.cfg.compute_dtype,
            lora_dropout=self.cfg.lora_dropout if train else 0.0,
            dropout_seed=seed if train else None,
            neftune_alpha=self.cfg.neftune_alpha if train else 0.0)
        return causal_lm_loss(logits, batch["labels"])

    # ------------------------------------------------------------ train step
    def train_step(self, state: TrainState, batch):
        """batch leaves: [A, mb, T] when grad_accum > 1 else [B, T] (numpy
        arrays or tensors). Returns (new_state, metrics); the metrics stay
        on the device (``loss``, ``grad_norm``, ``tokens`` tensors and the
        host ``lr``), so the step loop never syncs."""
        cfg = self.cfg
        if cfg.finetuning_type == "none":
            raise ValueError("finetuning_type 'none' is eval-only")
        batch = self.put_batch(batch)
        trainable = self._trainable(state.params, state.lora)
        leaves = tree_leaves(trainable)
        for leaf in leaves:
            leaf.requires_grad_(True)
        model = self._with_trainable(state, trainable)
        A = cfg.grad_accum
        micro = ([batch] if A <= 1 else
                 [{k: v[i] for k, v in batch.items()} for i in range(A)])
        grads, total_nll, total_n = None, 0.0, 0
        try:
            for i, mb in enumerate(micro):
                seed = mix_seed(state.seed, 0x57E9, state.step, i)
                s, n = self._forward_loss(model["params"], model["lora"], mb,
                                          seed, train=True)
                g = torch.autograd.grad(s, leaves, allow_unused=True)
                g = [torch.zeros_like(x) if gi is None else gi
                     for gi, x in zip(g, leaves)]
                grads = g if grads is None else [a + b
                                                 for a, b in zip(grads, g)]
                total_nll = total_nll + s.detach()
                total_n = total_n + n
        finally:
            for leaf in leaves:
                leaf.requires_grad_(False)

        with torch.no_grad():
            denom = torch.clamp(torch.as_tensor(total_n, device=self.device),
                                min=1).float()
            grads = _unflatten(trainable, [g / denom for g in grads])
            if cfg.finetuning_type == "freeze":
                mask = self._freeze_mask(trainable)
                grads = tree_map(torch.mul, grads, mask)
            updates, opt_state = self.optimizer.update(
                grads, state.opt_state, trainable)
            if cfg.finetuning_type == "freeze":
                updates = tree_map(torch.mul, updates, mask)
            new = tree_map(lambda p, u: (p + u).to(p.dtype), trainable,
                           updates)
            metrics = {
                "loss": total_nll / denom,
                "lr": self.schedule(state.step),
                "grad_norm": global_norm(grads),
                "tokens": total_n,
            }
        new_state = TrainState(step=state.step + 1, opt_state=opt_state,
                               seed=state.seed,
                               **self._with_trainable(state, new))
        return new_state, metrics

    def eval_step(self, state: TrainState, batch):
        batch = self.put_batch(batch)
        with torch.no_grad():
            s, n = self._forward_loss(state.params, state.lora, batch, None,
                                      train=False)
        return {"sum_nll": s, "tokens": n}

    def put_batch(self, batch) -> dict:
        """Host batch (numpy or tensors) → tensors on the trainer's device."""
        return to_device(batch, self.device)

    def evaluate(self, state: TrainState, batches) -> dict:
        """Aggregate eval: mean loss and perplexity = exp(loss)."""
        tot_s, tot_n = 0.0, 0
        for b in batches:
            m = self.eval_step(state, b)
            tot_s += float(m["sum_nll"])
            tot_n += int(m["tokens"])
        loss = tot_s / max(tot_n, 1)
        return {"eval_loss": loss, "perplexity": math.exp(min(loss, 80.0)),
                "eval_tokens": tot_n}


def _unflatten(tree, leaves):
    """Leaves in ``tree_leaves`` order → a tree shaped like ``tree``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)
