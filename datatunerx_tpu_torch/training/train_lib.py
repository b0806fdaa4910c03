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

Under a ``mesh`` (``parallel/mesh.py``: one process a card, the reference's
four axes), the state holds this rank's shards (``parallel/sharding``'s
rules over fsdp and tp) of the params, the trainable tree and the
optimizer state, and a step takes the rank's host rows over (dp, fsdp):

- the batch's labels are shifted on the host, then its sequence is cut
  over sp (``place_batch``); the model draws the rank's block of the
  global dropout and NEFTune draws (``LocalSlice``);
- the tree is gathered over fsdp before the forward (and the embedding and
  head over tp); the projections keep their tp shards;
- the nll sum and token count are all-reduced over (dp, fsdp, sp) before
  the divide (pairs over (dp, fsdp): a pair's loss is whole on every sp
  rank); the grads of the gathered leaves are all-reduced over (dp, sp)
  and reduce-scattered over fsdp; a leaf used whole over tp keeps its
  slice (tp ranks compute it alike);
- the clip's global norm is the sum of the shards' squares, reduced once
  over (fsdp, tp), a leaf replicated on an axis counted on its rank 0;
- elementwise optimizers (adamw, sgd, lion) update the shards; adafactor's
  factored statistics need whole leaves, so it updates gathered leaves
  with its state kept whole, and slices the updates.

``gather_state`` / ``place_state`` convert between a sharded state and the
whole one a one-device run holds (checkpoints are written whole).
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
from datatunerx_tpu_torch.parallel.sharding import (
    LocalSlice,
    _cuts,
    _spec_for,
    all_reduce,
    gather_for_use,
    gather_tree,
    place_batch,
    reduce_from_group,
    reduce_scatter_dim,
    shard_tree,
    tree_map_with_path,
    use_axes,
)
from datatunerx_tpu_torch.training.loss import (
    IGNORE_INDEX,
    causal_lm_loss,
    shifted_lm_loss,
)
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
                 device="cuda", mesh=None):
        self.model_cfg = model_cfg
        self.cfg = train_cfg
        self.device = resolve_device(device)
        self.mesh = mesh
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
        state = TrainState(step=0, params=params, lora=lora,
                           opt_state=opt_state, rng=rng)
        return self.place_state(state)

    # --------------------------------------------------------------- mesh
    def _whole_opt(self) -> bool:
        """adafactor keeps whole leaves (its statistics factor over them)."""
        return self.optimizer.kind == "adafactor"

    def place_state(self, state: TrainState) -> TrainState:
        """A whole state (a fresh init or a restored checkpoint) → this
        rank's shards."""
        if self.mesh is None:
            return state
        m = self.mesh
        opt = state.opt_state if self._whole_opt() else shard_tree(
            state.opt_state, m)
        return dataclasses.replace(state, params=shard_tree(state.params, m),
                                   lora=shard_tree(state.lora, m),
                                   opt_state=opt)

    def gather_state(self, state: TrainState) -> TrainState:
        """The whole state from every rank's shards (a collective: every
        rank calls it); a one-device run's state as it is."""
        if self.mesh is None:
            return state
        m = self.mesh
        opt = state.opt_state if self._whole_opt() else gather_tree(
            state.opt_state, m)
        return dataclasses.replace(state,
                                   params=gather_tree(state.params, m),
                                   lora=gather_tree(state.lora, m),
                                   opt_state=opt)

    def _local(self, rows: int, seq_len: int, pairs: bool = False):
        """This rank's block of a [rows · data, seq_len] global batch (for
        pairs, of the chosen + rejected concatenation)."""
        m = self.mesh
        if m is None:
            return None
        r0 = m.data_index * rows
        B = rows * m.data_size
        t = seq_len // m.shape["sp"]
        runs = ((0, rows, r0),) + (((rows, rows, B + r0),) if pairs else ())
        return LocalSlice(rows=runs, batch=2 * B if pairs else B,
                          t0=m.coords["sp"] * t, seq=seq_len)

    def _group(self, axes):
        return None if self.mesh is None else self.mesh.group(axes)

    def _reduce_sums(self, s, n):
        """(nll sum, count) over the data axes: pairs are whole on every
        sp rank, token sums are not."""
        if self.mesh is None:
            return s, n
        axes = (("dp", "fsdp") if self.cfg.stage in ("dpo", "rm")
                else ("dp", "fsdp", "sp"))
        g = self._group(axes)
        s = all_reduce(torch.as_tensor(s, device=self.device).float()
                       .clone(), g)
        n = all_reduce(torch.as_tensor(n, device=self.device).to(
            torch.int64).clone(), g)
        return s, n

    def _shard_grad(self, path, g):
        """A gathered leaf's local gradient → this rank's shard of the
        summed gradient."""
        m = self.mesh
        fsdp_cut = _cuts(path, g, m, ("fsdp",))
        if fsdp_cut:
            g = all_reduce(g.contiguous(), m.group(("dp", "sp")))
            g = reduce_scatter_dim(g, fsdp_cut[0][0], m.group(("fsdp",)),
                                   m.shape["fsdp"], m.coords["fsdp"])
        else:
            g = all_reduce(g.contiguous(), m.group(("dp", "fsdp", "sp")))
        if "tp" in use_axes(path):
            for dim, _ in _cuts(path, g, m, ("tp",)):
                w = g.shape[dim] // m.shape["tp"]
                g = g.narrow(dim, m.coords["tp"] * w, w).contiguous()
        return g

    def _sharded_norm(self, grads) -> torch.Tensor:
        """The global gradient's norm from this rank's shards: each leaf's
        squares counted on the ranks holding a distinct shard of it, summed
        once over (fsdp, tp)."""
        m = self.mesh
        sq = torch.zeros((), dtype=torch.float32, device=self.device)

        def add(path, g):
            nonlocal sq
            cut = {a for a in _spec_for(path, g) if a}
            if all(m.coords[a] == 0 for a in ("fsdp", "tp")
                   if a not in cut):
                sq = sq + torch.sum(torch.square(g.float()))
            return g

        tree_map_with_path(add, grads)
        return torch.sqrt(all_reduce(sq, m.group(("fsdp", "tp"))))

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
    def _sequence_logps(self, params, lora, ids, labels, rng, train: bool,
                        ids_next=None, local=None):
        """Per-sequence sum of response-token log-probs ([B]): response
        positions are where the shifted label is not IGNORE_INDEX."""
        on = train and lora is not None
        logits, _ = forward(
            params, ids, self.model_cfg,
            lora=(lora, self.scaling) if lora is not None else None,
            compute_dtype=self.cfg.compute_dtype,
            lora_dropout=self.cfg.lora_dropout if on else 0.0,
            dropout_rng=rng if on else None, mesh=self.mesh, local=local)
        if self.mesh is not None:
            # targets and labels shifted on the host (this chunk's last
            # position reads the next chunk's first); the chunk's partial
            # sums add over sp
            logp = torch.log_softmax(logits.float(), dim=-1)
            tgt, nxt = ids_next
            ll = torch.gather(logp, -1, tgt.long()[..., None])[..., 0]
            mask = (nxt != IGNORE_INDEX).float()
            return reduce_from_group(torch.sum(ll * mask, dim=-1),
                                     self._group(("sp",)))
        logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        tgt = ids[:, 1:].long()
        ll = torch.gather(logp, -1, tgt[..., None])[..., 0]
        mask = (labels[:, 1:] != IGNORE_INDEX).float()
        return torch.sum(ll * mask, dim=-1)

    def _pairs(self, batch):
        ids = torch.cat([batch["chosen_ids"], batch["rejected_ids"]], 0)
        labels = torch.cat([batch["chosen_labels"],
                            batch["rejected_labels"]], 0)
        # padding pairs (all-IGNORE labels, from eval tail padding) would
        # each add ln 2: masked out of the sum and the count
        if self.mesh is None:
            valid = torch.any(batch["chosen_labels"][:, 1:] != IGNORE_INDEX,
                              dim=-1).float()
        else:  # a row's labels span the sp ranks
            valid = torch.any(batch["chosen_labels_next"] != IGNORE_INDEX,
                              dim=-1).float()
            valid = all_reduce(valid, self._group(("sp",))).clamp(max=1.0)
        return ids, labels, valid

    def _pair_local(self, batch):
        """(this rank's LocalSlice, shifted (targets, labels)) of a pair
        batch under a mesh."""
        if self.mesh is None:
            return None, None
        b = batch["chosen_ids"].shape[0]
        local = self._local(b, int(batch["seq_len"]), pairs=True)
        nxt = (torch.cat([batch["chosen_ids_next"],
                          batch["rejected_ids_next"]], 0),
               torch.cat([batch["chosen_labels_next"],
                          batch["rejected_labels_next"]], 0))
        return local, nxt

    def _dpo_loss(self, params, lora, batch, rng, train: bool):
        """DPO: policy = base + adapter, reference = the same base with the
        adapter off and no grad; chosen and rejected in one forward each.
        Returns (sum over valid pairs, pair count)."""
        ids, labels, valid = self._pairs(batch)
        local, nxt = self._pair_local(batch)
        pol = self._sequence_logps(params, lora, ids, labels, rng, train,
                                   nxt, local)
        with torch.no_grad():
            ref = self._sequence_logps(params, None, ids, labels, None,
                                       False, nxt, local)
        B = batch["chosen_ids"].shape[0]
        margin = (pol[:B] - ref[:B]) - (pol[B:] - ref[B:])
        loss = -F.logsigmoid(self.cfg.dpo_beta * margin)
        return torch.sum(loss * valid), torch.sum(valid).to(torch.int32)

    def _rm_loss(self, params, lora, batch, rng, train: bool):
        """Pairwise reward loss: reward = v_head · the final hidden state at
        each sequence's last response token; no vocabulary projection."""
        ids, labels, valid = self._pairs(batch)
        local, _ = self._pair_local(batch)
        _, _, hidden = forward(
            params, ids, self.model_cfg,
            lora=(lora, self.scaling),
            compute_dtype=self.cfg.compute_dtype,
            lora_dropout=self.cfg.lora_dropout if train else 0.0,
            dropout_rng=rng if train else None,
            return_hidden=True, skip_logits=True, mesh=self.mesh,
            local=local)
        T = ids.shape[1]
        rows = torch.arange(ids.shape[0], device=ids.device)
        if self.mesh is None:
            lanes = torch.arange(T, dtype=torch.int64,
                                 device=ids.device)[None]
            last = torch.argmax(torch.where(labels != IGNORE_INDEX, lanes,
                                            torch.full_like(lanes, -1)),
                                dim=1)
            h_last = hidden[rows, last].float()
            rewards = h_last @ lora["v_head"].float()
        else:
            # the last response token (a global index from the host) lives
            # on one sp rank: the others add zero
            last = torch.cat([batch["chosen_last"], batch["rejected_last"]])
            at = last - local.t0
            mine = ((at >= 0) & (at < T)).float()
            h_last = hidden[rows, at.clamp(0, T - 1)].float()
            rewards = reduce_from_group(
                (h_last @ lora["v_head"].float()) * mine,
                self._group(("sp",)))
        B = batch["chosen_ids"].shape[0]
        loss = -F.logsigmoid(rewards[:B] - rewards[B:])
        return torch.sum(loss * valid), torch.sum(valid).to(torch.int32)

    def _forward_loss(self, params, lora, batch, rng, train: bool):
        if self.cfg.stage == "dpo":
            return self._dpo_loss(params, lora, batch, rng, train)
        if self.cfg.stage == "rm":
            return self._rm_loss(params, lora, batch, rng, train)
        local = None
        if self.mesh is not None:
            local = self._local(batch["input_ids"].shape[0],
                                int(batch["seq_len"]))
        logits, _ = forward(
            params, batch["input_ids"], self.model_cfg,
            attention_mask=batch.get("attention_mask"),
            segment_ids=batch.get("segment_ids"),
            positions=batch.get("positions"),
            lora=(lora, self.scaling) if lora is not None else None,
            compute_dtype=self.cfg.compute_dtype,
            lora_dropout=self.cfg.lora_dropout if train else 0.0,
            dropout_rng=rng if train else None,
            neftune_alpha=self.cfg.neftune_alpha if train else 0.0,
            mesh=self.mesh, local=local)
        if self.mesh is not None:
            return shifted_lm_loss(logits, batch["labels_next"])
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
        A = cfg.grad_accum
        m = self.mesh
        batch = self.put_batch(batch, accum=A > 1)
        shards = self._trainable(state.params, state.lora)
        if m is None:
            trainable = shards
            model = self._with_trainable(state, trainable)
        else:
            model = dict(params=gather_for_use(state.params, m),
                         lora=gather_for_use(state.lora, m))
            trainable = self._trainable(model["params"], model["lora"])
        leaves = tree_leaves(trainable)
        for leaf in leaves:
            leaf.requires_grad_(True)
        micro = ([batch] if A <= 1 else
                 [{k: v if k == "seq_len" else v[i]
                   for k, v in batch.items()} for i in range(A)])
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
            total_nll, total_n = self._reduce_sums(total_nll, total_n)
            denom = torch.clamp(torch.as_tensor(total_n, device=self.device),
                                min=1).float()
            new, opt_state, norm = self._apply_grads(state, shards,
                                                     trainable, grads, denom)
            metrics = {
                "loss": total_nll / denom,
                "lr": self.schedule(state.step),
                "grad_norm": norm,
                "tokens": total_n,
            }
        new_state = TrainState(step=state.step + 1, opt_state=opt_state,
                               rng=state.rng,
                               **self._with_trainable(state, new))
        return new_state, metrics

    def _apply_grads(self, state: TrainState, shards, trainable, grads,
                     denom):
        """One optimizer update from this rank's local gradients of the
        ``trainable`` leaves the forward used (``tree_leaves`` order):
        reduced to this rank's shards under a mesh, divided by ``denom``,
        masked for freeze, clipped by the global norm. Returns (the new
        trainable shards, the optimizer state, the gradient norm)."""
        m = self.mesh
        if m is not None:
            paths = []
            tree_map_with_path(lambda p, x: paths.append(p), trainable)
            grads = [self._shard_grad(p, g) for p, g in zip(paths, grads)]
        grads = _unflatten(shards, [g / denom for g in grads])
        freeze = self.cfg.finetuning_type == "freeze"
        if freeze:
            mask = self._freeze_mask(shards)
            grads = tree_map(torch.mul, grads, mask)
        if m is None:
            norm = global_norm(grads)
            updates, opt_state = self.optimizer.update(
                grads, state.opt_state, shards)
        elif self._whole_opt():
            whole = gather_tree(grads, m)
            norm = global_norm(whole)
            updates, opt_state = self.optimizer.update(
                whole, state.opt_state, gather_tree(shards, m))
            updates = shard_tree(updates, m)
        else:
            norm = self._sharded_norm(grads)
            updates, opt_state = self.optimizer.update(
                grads, state.opt_state, shards, norm=norm)
        if freeze:
            updates = tree_map(torch.mul, updates, mask)
        new = tree_map(lambda p, u: (p + u).to(p.dtype), shards, updates)
        return new, opt_state, norm

    def eval_step(self, state: TrainState, batch):
        batch = self.put_batch(batch)
        with torch.no_grad():
            params = gather_for_use(state.params, self.mesh)
            lora = gather_for_use(state.lora, self.mesh)
            s, n = self._forward_loss(params, lora, batch, None, train=False)
            s, n = self._reduce_sums(s, n)
        return {"sum_nll": s, "tokens": n}

    def put_batch(self, batch, accum: bool = False) -> dict:
        """Host batch (numpy or tensors) → tensors on the trainer's device;
        under a mesh, this rank's host rows are cut to its sequence chunk
        first (``place_batch``) unless that was done (``seq_len`` set)."""
        if self.mesh is not None and "seq_len" not in batch:
            batch = place_batch(
                {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
                 for k, v in batch.items()}, self.mesh, accum=accum)
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
