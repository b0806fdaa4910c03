"""PPO stage: RLHF policy optimization against a trained reward model (the
port of ``datatunerx_tpu/training/ppo.py``).

- **One frozen base, three roles.** Policy = base + trainable LoRA + a
  value head on the final-norm hidden state; reference policy = the same
  base with the adapter off; reward model = the same base + the frozen
  adapter and ``v_head`` of an ``--stage rm`` run. One copy of the weights
  serves all three.
- **Rollout**: a prefill of the left-padded prompts into a dense KV cache,
  then ``gen_len`` sampled decode steps; each step's log-prob of the
  sampled token and value are recorded in the loop (the policy is never
  re-run for them). Then the reference log-probs and the reward score
  over the full sequences, per-token KL-shaped rewards and GAE. No host
  sync inside a rollout: the sampling keys are made on the host up front.
- **Token-level PPO**: the reward at the last response token from the rm
  value head, a per-token penalty ``-kl_coef * (log π(a) - log π_ref(a))``,
  GAE(γ, λ) advantages, the clipped surrogate and clipped value loss over
  ``ppo_epochs`` full-batch passes. No dropout: the ratio compares the
  same deterministic policy the rollout sampled from.
- The adaptive KL controller (``ppo_target`` > 0) runs on the host
  between steps.

Randomness follows the reference's key chain on the threefry twin: a
step's key is ``fold_in(fold_in(rng, 0x990), step)``, split once a decode
step, and each draw is ``jax.random.categorical`` over the ``[B, V]``
logits from one key (``ops/prng.categorical``; its bits computed on the
logits' device), so a seeded rollout gives the JAX package's tokens.

Under a ``mesh`` (``parallel/mesh.py``, one process a card) a step takes
the rank's rows over (dp, fsdp) of the global prompt batch:

- the rollout decodes them on a dense cache with the whole params and
  adapters (the cache runs on one device: the tree is gathered over fsdp
  and tp), and each draw is the rank's block of the global ``[B, V]``
  draw (the offset threefry twin), so every row gets the reference's
  token; tp and sp ranks of one data rank decode alike;
- every statistic the reference takes over the batch is taken over the
  global batch: the scores' mean and std for ``score_norm`` (the scores
  gathered over (dp, fsdp)), the rollout stats, the advantages'
  whitening, and the update's masked means (sums over (dp, fsdp, sp)
  before the divide, ``Trainer._reduce_sums``), so every rank feeds the
  adaptive controller the same KL;
- the update's forward runs on the rank's rows and sequence chunk
  through the sharded ``Trainer`` machinery (the fsdp gather, tp shards,
  the sp gather; the reduce-scatter and the sharded clip norm of
  ``Trainer._apply_grads``): each per-token array is laid at the
  position that predicts its token, so a chunk scores the part of the
  response window it holds.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional

import numpy as np
import torch

from datatunerx_tpu_torch.data.prefetch import to_device
from datatunerx_tpu_torch.models.config import ModelConfig
from datatunerx_tpu_torch.models.llama import forward, init_cache, lm_logits
from datatunerx_tpu_torch.ops import prng
from datatunerx_tpu_torch.parallel.sharding import (
    LocalSlice,
    all_gather_dim,
    all_reduce,
    gather_for_use,
    gather_tree,
    shard_tree,
)
from datatunerx_tpu_torch.training.optimizer import tree_leaves, tree_map
from datatunerx_tpu_torch.training.train_lib import (
    TrainConfig,
    Trainer,
    TrainState,
)
from datatunerx_tpu_torch.utils import storage


@dataclasses.dataclass
class PPOConfig:
    gen_len: int = 64          # response tokens sampled per rollout
    temperature: float = 1.0   # 0 = greedy
    top_k: int = 0             # 0 = sample the full softmax
    kl_coef: float = 0.1       # initial per-token KL penalty coefficient
    ppo_target: float = 0.0    # target |KL|; > 0 turns the controller on
    kl_horizon: float = 10.0   # adaptation speed (steps to close the error)
    ppo_epochs: int = 2        # optimization passes per rollout batch
    clip_ratio: float = 0.2
    vf_coef: float = 0.1
    vf_clip: float = 0.2
    gamma: float = 1.0
    gae_lambda: float = 0.95
    score_norm: bool = False   # whiten rm scores across the batch
    whiten_advantages: bool = True

    def __post_init__(self):
        assert self.gen_len > 0
        assert self.ppo_epochs >= 1
        assert 0.0 < self.clip_ratio < 1.0


def compute_gae(rewards, values, mask, gamma: float, lam: float):
    """GAE over [B, G] response windows. ``mask`` is 1 on response tokens
    (a contiguous prefix of the window); the episode ends at the last
    masked token, with no bootstrap value beyond it. A reverse loop over
    G. Returns (advantages, returns)."""
    rewards = rewards * mask
    values = values * mask
    zero = torch.zeros_like(values[:, :1])
    v_next = torch.cat([values[:, 1:], zero], 1)
    m_next = torch.cat([mask[:, 1:], zero], 1)
    carry = torch.zeros_like(values[:, 0])
    adv = torch.empty_like(values)
    for t in range(values.shape[1] - 1, -1, -1):
        delta = rewards[:, t] + gamma * v_next[:, t] * m_next[:, t] \
            - values[:, t]
        carry = (delta + gamma * lam * carry) * mask[:, t]
        adv[:, t] = carry
    return adv, adv + values


def _masked_mean(x, m, eps=1e-8):
    return torch.sum(x * m) / torch.clamp(torch.sum(m), min=eps)


def _gather(logp, ids):
    return torch.gather(logp, -1, ids.long()[..., None])[..., 0]


class PPOTrainer(Trainer):
    """The base Trainer's state and optimizer with rollout and PPO update
    steps. ``train_cfg.stage`` must be "ppo" (LoRA; the policy's value
    head rides in the adapter tree, as the rm stage's)."""

    def __init__(self, model_cfg: ModelConfig, train_cfg: TrainConfig,
                 ppo_cfg: PPOConfig, *, reward_lora: Any,
                 reward_scaling: float, eos_id: int, pad_id: int = 0,
                 device="cuda", mesh=None):
        assert train_cfg.stage == "ppo", "PPOTrainer requires stage='ppo'"
        if "v_head" not in reward_lora:
            raise ValueError(
                "reward_lora must come from an --stage rm run (no v_head "
                "found)")
        super().__init__(model_cfg, train_cfg, device=device, mesh=mesh)
        self.ppo_cfg = ppo_cfg
        if eos_id is None:
            raise ValueError(
                "PPO requires a tokenizer with an EOS token "
                "(tokenizer.eos_token_id is None): rollouts could never "
                "terminate early without one")
        self.eos_id = int(eos_id)
        self.pad_id = int(pad_id)
        self.kl_coef = float(ppo_cfg.kl_coef)  # host-side, adaptively tuned
        # sharded as the reference shards it; the rollout gathers it whole
        self.reward_lora = shard_tree(tree_map(
            lambda x: x.detach().to(self.device), reward_lora), mesh)
        self.reward_scaling = float(reward_scaling)

    # --------------------------------------------------------------- mesh
    def _data_group(self):
        return self._group(("dp", "fsdp"))

    def _row_sum(self, x):
        """The sum of ``x`` over the global batch's rows (the data axes)."""
        return all_reduce(torch.sum(x).float().clone(), self._data_group())

    def _row_mean(self, x, m=None, eps=1e-8):
        """``_masked_mean`` over the global batch (``torch.mean`` without
        a mask)."""
        if self.mesh is None:
            return torch.mean(x) if m is None else _masked_mean(x, m, eps)
        if m is None:
            return self._row_sum(x) / (x.numel() * self.mesh.data_size)
        return self._row_sum(x * m) / torch.clamp(self._row_sum(m), min=eps)

    def _whiten(self, x, m):
        mean = self._row_mean(x, m)
        var = self._row_mean(torch.square(x - mean), m)
        return (x - mean) * torch.rsqrt(var + 1e-8) * m

    # ------------------------------------------------------------ rollout
    def _sample(self, logits, key, index=None):
        """One token a row from f32 ``logits`` [B, V] and one device key
        (``index``: the rows' block of the global draw)."""
        p = self.ppo_cfg
        if p.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        # a true division by a device scalar, as the reference divides
        logits = logits / torch.tensor(p.temperature, dtype=torch.float32,
                                       device=logits.device)
        if p.top_k > 0:
            kth = torch.topk(logits, p.top_k, dim=-1).values[..., -1:]
            logits = torch.where(logits < kth,
                                 torch.full_like(logits, -torch.inf), logits)
        return prng.categorical(key, logits, index=index)

    @torch.no_grad()
    def _rollout(self, state: TrainState, batch, kl_coef: float):
        """Sample ``gen_len`` tokens a prompt and score them (under a mesh,
        the rank's rows). Returns (the rollout tensors, stats)."""
        cfg, p = self.model_cfg, self.ppo_cfg
        cdt = self.cfg.compute_dtype
        dev = self.device
        mesh = self.mesh
        prompt_ids = batch["prompt_ids"].to(torch.int32)
        pmask = batch["prompt_mask"].to(torch.int32)
        B, Tp = prompt_ids.shape
        G = p.gen_len
        # the cache runs on one device: whole trees (no-ops without a mesh)
        params = gather_tree(state.params, mesh)
        policy = gather_tree(state.lora, mesh)
        reward_lora = gather_tree(self.reward_lora, mesh)
        lora = (policy, self.scaling)
        v_head = policy["v_head"].float()
        index = None
        if mesh is not None:  # the rows' block of the global [B, V] draw
            index = prng.slice_index(
                (B * mesh.data_size, cfg.vocab_size),
                (B * mesh.data_index, 0))
        # the step's key chain on the host; every decode step's key goes to
        # the device in one copy
        r = prng.fold_in(prng.fold_in(state.rng, 0x990), state.step)
        step_keys = []
        for _ in range(G):
            r, r_step = prng.split(r)
            step_keys.append(r_step)
        step_keys = prng.to_device(np.stack(step_keys), dev)

        # left-padded prompts: real tokens at the end, rope positions 0..n-1
        positions = torch.clamp(torch.cumsum(pmask, 1) - 1, min=0).to(
            torch.int32)
        n_prompt = torch.sum(pmask, 1).to(torch.int32)
        cache = init_cache(
            cfg, B, Tp + G,
            dtype=torch.bfloat16 if cdt is not None else torch.float32,
            device=dev)
        logits, cache, hidden = forward(
            params, prompt_ids, cfg, positions=positions,
            attention_mask=pmask, cache=cache, lora=lora, compute_dtype=cdt,
            return_hidden=True)
        lg_prev, h_prev = logits[:, -1], hidden[:, -1]
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        toks, old_logp, values, resp_mask = [], [], [], []
        for i in range(G):
            lg_prev = lg_prev.float()
            a = self._sample(lg_prev, step_keys[i], index)
            lp_a = _gather(torch.log_softmax(lg_prev, -1), a)
            values.append(h_prev.float() @ v_head)              # V(s_t)
            m = (~done).to(torch.int32)  # token i is part of the response
            tok = torch.where(done, torch.full_like(a, self.pad_id), a)
            done = done | (a == self.eos_id)
            toks.append(tok)
            old_logp.append(lp_a)
            resp_mask.append(m)
            if i == G - 1:
                break  # the last token's successor state is never read
            lg, cache, h = forward(
                params, tok.to(torch.int32)[:, None], cfg,
                positions=(n_prompt + i)[:, None],
                attention_mask=m[:, None],  # post-eos lanes: pos sentinel
                cache=cache, lora=lora, compute_dtype=cdt,
                return_hidden=True)
            lg_prev, h_prev = lg[:, -1], h[:, -1]
        toks = torch.stack(toks, 1).to(torch.int32)              # [B, G]
        old_logp = torch.stack(old_logp, 1)
        values = torch.stack(values, 1)
        resp_mask = torch.stack(resp_mask, 1).float()

        # ---- full sequences for the reference and reward forwards ------
        seq = torch.cat([prompt_ids, toks], 1)                   # [B, Tp+G]
        full_mask = torch.cat([pmask, resp_mask.to(torch.int32)], 1)
        full_pos = torch.clamp(torch.cumsum(full_mask, 1) - 1, min=0).to(
            torch.int32)

        # hidden-only forward + the vocabulary projection over just the G
        # predicting positions
        _, _, h = forward(params, seq, cfg, positions=full_pos,
                          attention_mask=full_mask, lora=None,
                          compute_dtype=cdt, return_hidden=True,
                          skip_logits=True)
        lg = lm_logits(params, h[:, Tp - 1:-1], cfg)             # [B, G, V]
        ref_logp = _gather(torch.log_softmax(lg, -1), seq[:, Tp:])

        _, _, rh = forward(params, seq, cfg, positions=full_pos,
                           attention_mask=full_mask,
                           lora=(reward_lora, self.reward_scaling),
                           compute_dtype=cdt, return_hidden=True,
                           skip_logits=True)
        n_resp = torch.sum(resp_mask, 1).to(torch.int64)         # >= 1
        h_last = rh[torch.arange(B, device=dev), Tp + n_resp - 1].float()
        score = h_last @ reward_lora["v_head"].float()           # [B]
        raw_score = score
        if p.score_norm:
            every = score if mesh is None else all_gather_dim(
                score, 0, self._data_group(), mesh.data_size)
            score = (score - torch.mean(every)) / (
                torch.std(every, unbiased=False) + 1e-6)

        kl = (old_logp - ref_logp) * resp_mask                   # [B, G]
        last = (torch.arange(G, device=dev)[None, :]
                == (n_resp - 1)[:, None]).float()
        kl_coef = torch.tensor(kl_coef, dtype=torch.float32, device=dev)
        rewards = -kl_coef * kl + last * score[:, None]
        adv, rets = compute_gae(rewards, values, resp_mask, p.gamma,
                                p.gae_lambda)
        stats = {
            "reward_score": self._row_mean(raw_score),
            "kl": self._row_mean(kl, resp_mask),
            "response_len": self._row_mean(n_resp.float()),
        }
        ro = {"seq": seq, "full_mask": full_mask, "positions": full_pos,
              "resp_mask": resp_mask, "old_logp": old_logp,
              "values": values, "advantages": adv, "returns": rets}
        return ro, stats

    # ------------------------------------------------------------- update
    def _update(self, state: TrainState, ro):
        """One full-batch PPO pass over the rollout ``ro`` (under a mesh,
        the rank's rows): returns (the new state, metrics). The forward
        takes the rank's sequence chunk (the whole sequence without a
        mesh), and the masked means are sums over the data axes before
        the divide."""
        cfg, p, m = self.model_cfg, self.ppo_cfg, self.mesh
        cdt = self.cfg.compute_dtype
        seq = ro["seq"]
        b, T = seq.shape
        G = ro["old_logp"].shape[1]
        Tp = T - G
        adv = self._whiten(ro["advantages"], ro["resp_mask"]) \
            if p.whiten_advantages else ro["advantages"]
        sp, j = (1, 0) if m is None else (m.shape["sp"], m.coords["sp"])
        if T % sp:
            raise ValueError(f"sequence {T} does not divide over sp={sp}")
        t = T // sp
        t0 = j * t
        # the response window: position Tp - 1 + g predicts token g; this
        # chunk holds positions [lo, hi) of it (maybe none)
        lo = max(t0, Tp - 1)
        hi = max(min(t0 + t, T - 1), lo)
        g0, g1 = lo - (Tp - 1), hi - (Tp - 1)
        win = {k: ro[k][:, g0:g1] for k in ("old_logp", "values", "returns",
                                            "resp_mask")}
        win["advantages"] = adv[:, g0:g1]
        local = None if m is None else LocalSlice(
            rows=((0, b, m.data_index * b),), batch=b * m.data_size, t0=t0,
            seq=T)
        params = gather_for_use(state.params, m)
        lora_tr = gather_for_use(state.lora, m)
        leaves = tree_leaves(lora_tr)
        for leaf in leaves:
            leaf.requires_grad_(True)
        try:
            _, _, hid = forward(
                params, seq[:, t0:t0 + t], cfg,
                positions=ro["positions"][:, t0:t0 + t],
                attention_mask=ro["full_mask"][:, t0:t0 + t],
                lora=(lora_tr, self.scaling), compute_dtype=cdt,
                return_hidden=True, skip_logits=True, mesh=m, local=local)
            h_pred = hid[:, lo - t0:hi - t0]
            lg = lm_logits(params, h_pred, cfg)
            new_logp = _gather(torch.log_softmax(lg, -1),
                               seq[:, lo + 1:hi + 1])
            new_v = h_pred.float() @ lora_tr["v_head"].float()
            mask = win["resp_mask"]
            # clamp before exp: at post-eos lanes old_logp is the sampled
            # token's and new_logp the pad's; adv 0 cancels the term, but
            # an unclamped exp could overflow to inf and inf * 0 is NaN
            ratio = torch.exp(torch.clamp(new_logp - win["old_logp"], -20.0,
                                          20.0))
            clipped = torch.clamp(ratio, 1.0 - p.clip_ratio,
                                  1.0 + p.clip_ratio)
            a = win["advantages"]
            pg = torch.sum(-torch.minimum(ratio * a, clipped * a) * mask)
            v_clip = win["values"] + torch.clamp(new_v - win["values"],
                                                 -p.vf_clip, p.vf_clip)
            vf = torch.sum(0.5 * torch.maximum(
                torch.square(new_v - win["returns"]),
                torch.square(v_clip - win["returns"])) * mask)
            g = torch.autograd.grad(pg + p.vf_coef * vf, leaves,
                                    allow_unused=True)
        finally:
            for leaf in leaves:
                leaf.requires_grad_(False)
        with torch.no_grad():
            sums = torch.stack([
                pg.detach(), vf.detach(),
                torch.sum((win["old_logp"] - new_logp) * mask),
                torch.sum((torch.abs(ratio - 1.0) > p.clip_ratio).float()
                          * mask)])
            sums, n = self._reduce_sums(sums, torch.sum(mask))
            denom = torch.clamp(n.float(), min=1e-8)
            pg_loss, vf_loss, approx_kl, clipfrac = sums / denom
            grads = [torch.zeros_like(x) if gi is None else gi
                     for gi, x in zip(g, leaves)]
            new_lora, opt_state, norm = self._apply_grads(
                state, state.lora, lora_tr, grads, denom)
            metrics = {
                "pg_loss": pg_loss, "vf_loss": vf_loss,
                "approx_kl": approx_kl, "clipfrac": clipfrac,
                "loss": pg_loss + p.vf_coef * vf_loss,
                "lr": self.schedule(state.step), "grad_norm": norm,
            }
        return dataclasses.replace(state, step=state.step + 1, lora=new_lora,
                                   opt_state=opt_state), metrics

    # --------------------------------------------------------- public API
    def put_batch(self, batch, accum: bool = False) -> dict:
        """A prompt batch (under a mesh, the rank's rows) on the device: the
        rollout takes whole prompts, so no sequence cut."""
        return to_device({k: v for k, v in batch.items() if v is not None},
                         self.device)

    def step(self, state: TrainState, batch):
        """One PPO iteration: a rollout, then ``ppo_epochs`` update passes.
        Returns (state, metrics): the rollout stats (reward_score, kl,
        response_len) with the last pass's losses. Under a mesh ``batch``
        is the rank's rows over (dp, fsdp) and the metrics are global."""
        p = self.ppo_cfg
        batch = self.put_batch(batch)
        ro, stats = self._rollout(state, batch, self.kl_coef)
        metrics = {}
        for _ in range(p.ppo_epochs):
            state, metrics = self._update(state, ro)
        metrics.update(stats)
        metrics["kl_coef"] = self.kl_coef
        if p.ppo_target > 0.0:
            # proportional controller (TRL AdaptiveKLController), with the
            # reference's f32 clip of the error
            err = float(np.clip(np.float32(float(stats["kl"]) / p.ppo_target
                                           - 1.0),
                                np.float32(-0.2), np.float32(0.2)))
            self.kl_coef = max(self.kl_coef * (1.0 + err / p.kl_horizon),
                               1e-4)
        return state, metrics

    def train_step(self, state, batch):  # pragma: no cover
        raise NotImplementedError("use PPOTrainer.step(state, prompt_batch)")

    def eval_step(self, state, batch):  # pragma: no cover
        raise NotImplementedError("use PPOTrainer.step(state, prompt_batch)")


CONTROLLER_STATE = "ppo_controller.json"


def save_controller_state(ckpt_dir: str, step: int, kl_coef: float) -> None:
    """Keep the adaptive KL controller's coefficient beside the
    checkpoints: the train state does not carry it, and a resume that
    reset it to ``--init_kl_coef`` would change the reward shaping."""
    storage.write_text(
        storage.join(ckpt_dir, CONTROLLER_STATE),
        json.dumps({"step": int(step), "kl_coef": float(kl_coef)}))


def load_controller_state(ckpt_dir: str) -> Optional[dict]:
    path = storage.join(ckpt_dir, CONTROLLER_STATE)
    if not storage.exists(path):
        return None
    return json.loads(storage.read_text(path))


def load_reward_model(model_cfg: ModelConfig, params, reward_dir: str,
                      device="cuda"):
    """The frozen reward adapter of an ``--stage rm`` run directory
    (``<storage_path>/<run>``, holding manifest.json and checkpoints/):
    the manifest's rank, targets and scaling, and the adapter and
    ``v_head`` restored through an rm-stage state template over the SAME
    base params (the base is never copied). Returns (reward_lora,
    reward_scaling)."""
    from datatunerx_tpu_torch.models.lora import DEFAULT_TARGETS, lora_scaling
    from datatunerx_tpu_torch.training.checkpoint import (
        MANIFEST_NAME,
        CheckpointManager,
    )

    mpath = storage.join(reward_dir, MANIFEST_NAME)
    if not storage.exists(mpath):
        raise FileNotFoundError(
            f"--reward_model {reward_dir!r}: no {MANIFEST_NAME} — point it "
            "at an --stage rm run directory (<storage_path>/<uid>)")
    manifest = json.loads(storage.read_text(mpath))
    rank = int(manifest.get("lora_rank") or 8)
    targets = tuple(manifest.get("lora_targets") or DEFAULT_TARGETS)
    scaling = float(manifest.get("lora_scaling")
                    or lora_scaling(float(manifest.get("lora_alpha")
                                          or 32.0), rank))
    ckpt_uri = manifest.get("checkpoint")
    if not ckpt_uri:
        raise ValueError(f"manifest {mpath} has no checkpoint URI")
    ckpt_dir = os.path.dirname(str(ckpt_uri).rstrip("/"))
    step = int(os.path.basename(str(ckpt_uri).rstrip("/")))

    rm_trainer = Trainer(
        model_cfg,
        TrainConfig(stage="rm", finetuning_type="lora", lora_rank=rank,
                    lora_targets=targets, compute_dtype=None,
                    # the template's optimizer state must match the saved
                    # one; its structure depends only on the family
                    optimizer=str(manifest.get("optimizer") or "adamw")),
        device=device)
    template = rm_trainer.init_state(params, 0)
    restored, _ = CheckpointManager(ckpt_dir).restore(template, step=step)
    if restored is None:
        raise FileNotFoundError(f"no checkpoint at {ckpt_uri}")
    return restored.lora, scaling
