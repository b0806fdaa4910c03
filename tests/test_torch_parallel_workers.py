"""Rank functions for the port's gloo tests (run by
``tests/test_torch_gloo.World``; no test is collected here). They
import torch and the port only (no JAX): each spawned rank builds the
port's mesh, trainer or ring from numpy inputs and returns numpy
results."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def train_worker(rank, n, spec):
    """``spec``: cfg (get_config kwargs), train (TrainConfig kwargs), shape
    (dp, fsdp, tp, sp), dcn, params (port-layout numpy tree), lora (numpy
    tree or None), batches (GLOBAL host batches), steps. Returns the step
    metrics and the whole trainable tree after the steps; from rank 0 it
    writes the whole state's checkpoint (``checkpoint``) and, with
    ``one_device``, adds the same steps on one device (no mesh) under
    ``"one_device"``."""
    from datatunerx_tpu_torch.parallel.mesh import make_mesh

    out = _train(spec, make_mesh(spec["shape"], dcn_dp=spec.get("dcn", 1)),
                 rank)
    if spec.get("one_device") and rank == 0:
        out["one_device"] = _train(dict(spec, checkpoint=None), None, rank)
    return out


def _train(spec, mesh, rank):
    from datatunerx_tpu_torch.models.config import get_config
    from datatunerx_tpu_torch.parallel.sharding import host_rows
    from datatunerx_tpu_torch.training.train_lib import TrainConfig, Trainer

    cfg = get_config(spec["preset"], **spec["cfg"])
    tcfg = TrainConfig(compute_dtype=torch.float32, **spec["train"])
    tr = Trainer(cfg, tcfg, device="cpu", mesh=mesh)
    params = _to_torch(spec["params"])
    state = tr.init_state(params, spec.get("seed", 1))
    if spec.get("lora") is not None:
        whole = tr.gather_state(state)
        lora = _to_torch(spec["lora"])
        whole = dataclasses.replace(whole, lora=lora,
                                    opt_state=tr.optimizer.init(lora))
        state = tr.place_state(whole)
    out = {"loss": [], "grad_norm": [], "tokens": []}
    accum = tcfg.grad_accum > 1
    for batch in spec["batches"][:spec.get("steps", 1)]:
        state, m = tr.train_step(state, host_rows(batch, mesh, accum=accum))
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["tokens"].append(int(m["tokens"]))
    whole = tr.gather_state(state)
    out["trainable"] = _to_numpy(whole.lora if whole.lora is not None
                                 else whole.params)
    if spec.get("checkpoint") and rank == 0:
        from datatunerx_tpu_torch.training.checkpoint import (
            CheckpointManager,
        )

        CheckpointManager(spec["checkpoint"]).maybe_save(whole, whole.step,
                                                          force=True)
    return out


def ring_worker(rank, n, spec):
    """The gloo ring on this rank's chunk of ``spec``'s global q/k/v [B, T,
    ...] (sp = n): the output chunk and the chunk's q/k/v grads under the
    cotangent ``do``, for the flash ring and the einsum ring; with
    ``schedule``, also the in-process schedule over all chunks."""
    from datatunerx_tpu_torch.ops import ring_attention as ra
    from datatunerx_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh((1, 1, 1, n))
    T = spec["q"].shape[1]
    t = T // n

    def chunk(a):
        return torch.from_numpy(np.array(a[:, rank * t:(rank + 1) * t]))

    res = {}
    for impl in ("flash", "xla"):
        q, k, v = (chunk(spec[x]).requires_grad_(True) for x in "qkv")
        fn = ra.ring_flash_attention if impl == "flash" else ra.ring_attention
        out = fn(q, k, v, mesh.group(("sp",)), n, rank)
        out.backward(chunk(spec["do"]))
        res[impl] = {"out": out.detach().numpy(), "dq": q.grad.numpy(),
                     "dk": k.grad.numpy(), "dv": v.grad.numpy()}
    return res


def train_many(rank, n, specs):
    """``train_worker`` over several specs in one process group."""
    return [train_worker(rank, n, spec) for spec in specs]


def ppo_worker(rank, n, specs):
    """The port's ``PPOTrainer`` under a mesh, per spec: cfg, train
    (TrainConfig kwargs, the compute dtype included), ppo (PPOConfig kwargs), shape, params, lora and
    reward (numpy trees with ``v_head``), scaling, eos_id, batches (GLOBAL
    prompt batches) and ``ro`` (a GLOBAL rollout). Returns the rank's
    rollout of the first batch and its stats, two update passes from its
    rows of ``ro`` (metrics and the adapters after), and two steps
    (metrics and the adapters after); from rank 0 with ``one_device``,
    the same steps on one device (no mesh)."""
    from datatunerx_tpu_torch.parallel.mesh import make_mesh
    from datatunerx_tpu_torch.parallel.sharding import host_rows

    outs = []
    for spec in specs:
        mesh = make_mesh(spec["shape"])
        tr, state = _ppo_trainer(spec, mesh)
        rows = [host_rows(b, mesh) for b in spec["batches"]]
        ro, stats = tr._rollout(state, tr.put_batch(rows[0]), tr.kl_coef)
        out = {"ro": {k: v.numpy() for k, v in ro.items()},
               "stats": {k: float(v) for k, v in stats.items()}}
        ro_rows = {k: torch.from_numpy(np.array(v))
                   for k, v in host_rows(spec["ro"], mesh).items()}
        st, ms = state, []
        for _ in range(2):
            st, m = tr._update(st, ro_rows)
            ms.append({k: float(v) for k, v in m.items()})
        out["update"] = {"metrics": ms,
                         "lora": _to_numpy(tr.gather_state(st).lora)}
        out["steps"] = _ppo_steps(tr, state, rows)
        if spec.get("one_device") and rank == 0:
            out["one_device"] = _ppo_steps(*_ppo_trainer(spec, None),
                                           spec["batches"])
        outs.append(out)
    return outs


def _ppo_trainer(spec, mesh):
    from datatunerx_tpu_torch.models.config import get_config
    from datatunerx_tpu_torch.training.ppo import PPOConfig, PPOTrainer
    from datatunerx_tpu_torch.training.train_lib import TrainConfig

    tr = PPOTrainer(get_config(spec["preset"], **spec["cfg"]),
                    TrainConfig(**spec["train"]),
                    PPOConfig(**spec["ppo"]),
                    reward_lora=_to_torch(spec["reward"]),
                    reward_scaling=spec["scaling"], eos_id=spec["eos_id"],
                    pad_id=0, device="cpu", mesh=mesh)
    state = tr.gather_state(tr.init_state(_to_torch(spec["params"]), 1))
    lora = _to_torch(spec["lora"])
    return tr, tr.place_state(dataclasses.replace(
        state, lora=lora, opt_state=tr.optimizer.init(lora)))


def _ppo_steps(tr, state, batches):
    ms = []
    for b in batches:
        state, m = tr.step(state, b)
        ms.append({k: float(v) for k, v in m.items()})
    return {"metrics": ms, "lora": _to_numpy(tr.gather_state(state).lora)}
