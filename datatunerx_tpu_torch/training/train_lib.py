"""The train/eval loop in PyTorch (the port of
``datatunerx_tpu/training/train_lib.py``): SFT, DPO and RM, and the state
PPO (``training/ppo.py``) builds on.

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
dtype and cast back to the param's.

Stages (LoRA only, as in the reference): ``dpo`` scores chosen and rejected
responses under the policy (base + adapter) and under the reference policy
(the same base with the adapter off, no grad), ``-log σ(β[(π_c − ref_c) −
(π_r − ref_r)])``; ``rm`` trains the adapter and a scalar value head
``v_head`` [D] on ``-log σ(r_c − r_r)``, with the reward read at each
sequence's last response token. Padding pairs (all labels IGNORE) count in
neither the sum nor the count. ``ppo`` gives the policy the same value
head; ``training/ppo.PPOTrainer`` runs its steps.

Randomness follows the reference's key chain on the threefry twin
(``ops/prng.py``), on the host: the state's key is ``PRNGKey(seed)``, the
LoRA init key ``fold_in(key, 0x10AA)``, the rm value head's
``fold_in(key, 0x4EAD)``, and a step's dropout/NEFTune key
``fold_in(fold_in(key, 0x57E9), step)``, folded once more with the
micro-batch index under gradient accumulation.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from datatunerx_tpu_torch.data.prefetch import to_device
from datatunerx_tpu_torch.models.config import ModelConfig
from datatunerx_tpu_torch.models.llama import forward
from datatunerx_tpu_torch.models.lora import (
    DEFAULT_TARGETS,
    init_lora_params,
    lora_scaling,
)
from datatunerx_tpu_torch.ops import prng
from datatunerx_tpu_torch.training.loss import IGNORE_INDEX, causal_lm_loss
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
    stage: str = "sft"  # sft | dpo | rm | ppo
    dpo_beta: float = 0.1

    def __post_init__(self):
        if self.finetuning_type not in ("lora", "freeze", "full", "none"):
            raise ValueError(
                f"invalid finetuning_type {self.finetuning_type!r}")
        if self.stage not in ("sft", "dpo", "rm", "ppo"):
            raise ValueError(f"invalid stage {self.stage!r}")
        if self.stage != "sft" and self.finetuning_type != "lora":
            raise ValueError(
                f"stage {self.stage} requires finetuning_type lora (the "
                "frozen base serves as the DPO reference policy / keeps the "
                "reward model a cheap adapter; full/freeze would need a "
                "second copy of the weights)")


@dataclasses.dataclass
class TrainState:
    step: int
    params: Any
    lora: Any  # None unless finetuning_type == "lora"
    opt_state: Any
    rng: np.ndarray  # the run's threefry key ([2] uint32, on the host)


def normal(key, shape) -> torch.Tensor:
    """``jax.random.normal`` in float32 on the CPU: ``sqrt(2) ·
    erfinv(u)`` over the twin's ``uniform(nextafter(-1, 0), 1)``. The
    uniform is bit-exact; torch's erfinv is not XLA's polynomial, so the
    values hold to a few ulps, not bit for bit."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = torch.from_numpy(prng.uniform(key, shape, lo, 1.0))
    return torch.erfinv(u) * torch.tensor(np.sqrt(2.0), dtype=torch.float32)


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
    def init_state(self, params, rng) -> TrainState:
        """``rng``: a twin key, or an int seed for ``PRNGKey(seed)``."""
        if isinstance(rng, (int, np.integer)):
            rng = prng.PRNGKey(int(rng))
        rng = np.asarray(rng, dtype=np.uint32)
        lora = None
        if self.cfg.finetuning_type == "lora":
            lora = init_lora_params(
                self.model_cfg, prng.fold_in(rng, 0x10AA),
                rank=self.cfg.lora_rank, targets=tuple(self.cfg.lora_targets),
                device=self.device)
            if self.cfg.stage in ("rm", "ppo"):
                # the scalar value head over the final-norm hidden state
                D = self.model_cfg.hidden_size
                v = normal(prng.fold_in(rng, 0x4EAD), (D,))
                lora["v_head"] = (v / torch.tensor(math.sqrt(D),
                                                   dtype=torch.float32)
                                  ).to(self.device)
        opt_state = ()
        if self.cfg.finetuning_type != "none":
            opt_state = self.optimizer.init(self._trainable(params, lora))
        return TrainState(step=0, params=params, lora=lora,
                          opt_state=opt_state, rng=rng)

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
    def _sequence_logps(self, params, lora, ids, labels, rng, train: bool):
        """Per-sequence sum of response-token log-probs ([B]): response
        positions are where the shifted label is not IGNORE_INDEX."""
        on = train and lora is not None
        logits, _ = forward(
            params, ids, self.model_cfg,
            lora=(lora, self.scaling) if lora is not None else None,
            compute_dtype=self.cfg.compute_dtype,
            lora_dropout=self.cfg.lora_dropout if on else 0.0,
            dropout_rng=rng if on else None)
        logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        tgt = ids[:, 1:].long()
        ll = torch.gather(logp, -1, tgt[..., None])[..., 0]
        mask = (labels[:, 1:] != IGNORE_INDEX).float()
        return torch.sum(ll * mask, dim=-1)

    @staticmethod
    def _pairs(batch):
        ids = torch.cat([batch["chosen_ids"], batch["rejected_ids"]], 0)
        labels = torch.cat([batch["chosen_labels"],
                            batch["rejected_labels"]], 0)
        # padding pairs (all-IGNORE labels, from eval tail padding) would
        # each add ln 2: masked out of the sum and the count
        valid = torch.any(batch["chosen_labels"][:, 1:] != IGNORE_INDEX,
                          dim=-1).float()
        return ids, labels, valid

    def _dpo_loss(self, params, lora, batch, rng, train: bool):
        """DPO: policy = base + adapter, reference = the same base with the
        adapter off and no grad; chosen and rejected in one forward each.
        Returns (sum over valid pairs, pair count)."""
        ids, labels, valid = self._pairs(batch)
        pol = self._sequence_logps(params, lora, ids, labels, rng, train)
        with torch.no_grad():
            ref = self._sequence_logps(params, None, ids, labels, None,
                                       False)
        B = batch["chosen_ids"].shape[0]
        margin = (pol[:B] - ref[:B]) - (pol[B:] - ref[B:])
        loss = -F.logsigmoid(self.cfg.dpo_beta * margin)
        return torch.sum(loss * valid), torch.sum(valid).to(torch.int32)

    def _rm_loss(self, params, lora, batch, rng, train: bool):
        """Pairwise reward loss: reward = v_head · the final hidden state at
        each sequence's last response token; no vocabulary projection."""
        ids, labels, valid = self._pairs(batch)
        _, _, hidden = forward(
            params, ids, self.model_cfg,
            lora=(lora, self.scaling),
            compute_dtype=self.cfg.compute_dtype,
            lora_dropout=self.cfg.lora_dropout if train else 0.0,
            dropout_rng=rng if train else None,
            return_hidden=True, skip_logits=True)
        T = ids.shape[1]
        lanes = torch.arange(T, dtype=torch.int64, device=ids.device)[None]
        last = torch.argmax(torch.where(labels != IGNORE_INDEX, lanes,
                                        torch.full_like(lanes, -1)), dim=1)
        h_last = hidden[torch.arange(ids.shape[0], device=ids.device),
                        last].float()
        rewards = h_last @ lora["v_head"].float()
        B = batch["chosen_ids"].shape[0]
        loss = -F.logsigmoid(rewards[:B] - rewards[B:])
        return torch.sum(loss * valid), torch.sum(valid).to(torch.int32)

    def _forward_loss(self, params, lora, batch, rng, train: bool):
        if self.cfg.stage == "dpo":
            return self._dpo_loss(params, lora, batch, rng, train)
        if self.cfg.stage == "rm":
            return self._rm_loss(params, lora, batch, rng, train)
        logits, _ = forward(
            params, batch["input_ids"], self.model_cfg,
            attention_mask=batch.get("attention_mask"),
            segment_ids=batch.get("segment_ids"),
            positions=batch.get("positions"),
            lora=(lora, self.scaling) if lora is not None else None,
            compute_dtype=self.cfg.compute_dtype,
            lora_dropout=self.cfg.lora_dropout if train else 0.0,
            dropout_rng=rng if train else None,
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
        step_key = prng.fold_in(prng.fold_in(state.rng, 0x57E9), state.step)
        grads, total_nll, total_n = None, 0.0, 0
        try:
            for i, mb in enumerate(micro):
                key = prng.fold_in(step_key, i) if A > 1 else step_key
                s, n = self._forward_loss(model["params"], model["lora"], mb,
                                          key, train=True)
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
                               rng=state.rng,
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
