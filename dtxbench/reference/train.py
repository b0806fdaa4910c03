"""The reference's first steps of a LoRA SFT job, and the numbers that
compare the program with it.

It makes the adapters as the job states them (A drawn by the threefry
chain ``fold_in(fold_in(PRNGKey(seed), 0x10AA), i)`` for the i-th target
in sorted order, uniform in ±1/sqrt(in); B zero), then runs each step:
the summed NLL over the step's labelled tokens, its gradient divided by
their count, clipped by the global norm, AdamW (b1 0.9, b2 0.999, eps
1e-8 outside the root, no weight decay) at the cosine schedule's rate.

Compared, per leaf (one target's A or B in one layer):
- ``loss_gap``: the worst step's |program − reference| / reference loss;
- ``grad_gap``: the first step's clipped gradient as the optimizer got it
  (the program's first moment after one step, over 1 − b1), the gap of
  the norms over the larger of this leaf's and the median leaf's
  reference norm, worst leaf; leaves whose reference gradient is under a
  thousandth of the median leaf's are left out (A, whose gradient is zero
  while B is);
- ``change_gap``: the same of each leaf's change over the steps compared.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from dtxbench.reference import model, threefry

B1, B2, EPS = 0.9, 0.999, 1e-8
LORA_SALT, STEP_SALT = 0x10AA, 0x57E9


def init_lora(c: dict, seed: int, targets, rank: int, device) -> dict:
    from dtxbench.harness.weights import dims

    key = threefry.fold_in(threefry.PRNGKey(seed), LORA_SALT)
    L = c["num_hidden_layers"]
    out = {}
    for i, t in enumerate(sorted(targets)):
        a_in, a_out = dims(c)[t]
        bound = 1.0 / math.sqrt(a_in)
        a = threefry.uniform(threefry.fold_in(key, i), (L, a_in, rank),
                             -bound, bound, device)
        out[t] = [a, torch.zeros((L, rank, a_out), dtype=torch.float32,
                                 device=device)]
    return out


def cosine(lr: float, total: int, count: int) -> float:
    count = min(count, total)
    return lr * 0.5 * (1 + math.cos(math.pi * count / total))


def run(W, batches, job: dict, seed: int, steps: int, prec: str = "f32"):
    """``batches``: host dicts with ``input_ids``, ``labels``,
    ``positions``, ``segment_ids`` [B, T]. Returns (losses, first clipped
    gradient, lora after ``steps``, lora at init): trees
    {target: [A, B]} of [L, ...] float32."""
    dev = W.embed.device
    lora = init_lora(W.c, seed, job["lora_targets"], job["lora_rank"], dev)
    init = {t: [x.clone() for x in ab] for t, ab in lora.items()}
    mu = {t: [torch.zeros_like(x) for x in ab] for t, ab in lora.items()}
    nu = {t: [torch.zeros_like(x) for x in ab] for t, ab in lora.items()}
    scale = job["lora_alpha"] / job["lora_rank"]
    rng = threefry.PRNGKey(seed)
    losses, first, gmax = [], None, None
    for step in range(steps):
        b = {k: torch.as_tensor(np.asarray(v), device=dev)
             for k, v in batches[step].items()}
        key = threefry.fold_in(threefry.fold_in(rng, STEP_SALT), step)
        leaves = [x for ab in lora.values() for x in ab]
        for x in leaves:
            x.requires_grad_(True)
        s, n = model.train_loss(W, b["input_ids"], b["positions"],
                                b["segment_ids"], b["labels"], lora, scale,
                                job["lora_dropout"], key, prec)
        grads = torch.autograd.grad(s, leaves)
        for x in leaves:
            x.requires_grad_(False)
        n = float(n)
        grads = [g / n for g in grads]
        losses.append(float(s.detach()) / n)
        norm = math.sqrt(sum(float((g * g).sum()) for g in grads))
        if norm >= job["max_grad_norm"]:
            grads = [g / norm * job["max_grad_norm"] for g in grads]
        it = iter(grads)
        g_tree = {t: [next(it), next(it)] for t in lora}
        if step == 0:
            first = g_tree
        gn = leaf_norms(g_tree)
        gmax = gn if gmax is None else np.maximum(gmax, gn)
        lr = cosine(job["learning_rate"], job["total_steps"], step)
        c1 = 1.0 - B1 ** (step + 1)
        c2 = 1.0 - B2 ** (step + 1)
        it = iter(grads)
        with torch.no_grad():
            for t in lora:
                for j in range(2):
                    g = next(it)
                    mu[t][j] = B1 * mu[t][j] + (1 - B1) * g
                    nu[t][j] = B2 * nu[t][j] + (1 - B2) * g * g
                    u = (mu[t][j] / c1) / (torch.sqrt(nu[t][j] / c2) + EPS)
                    lora[t][j] = lora[t][j] - lr * u
    return losses, first, lora, init, gmax


def leaf_norms(tree) -> np.ndarray:
    """Norms of every (target, A or B, layer) leaf, in a fixed order."""
    out = []
    for t in sorted(tree):
        for x in tree[t]:
            out.extend(torch.linalg.vector_norm(
                x.float().reshape(x.shape[0], -1), dim=1).tolist())
    return np.asarray(out, dtype=np.float64)


def leaf_gap(prog: np.ndarray, ref: np.ndarray, gate: np.ndarray):
    """The worst leaf's |‖prog‖ − ‖ref‖| over max(‖ref‖, median ‖ref‖),
    over leaves whose reference gradient (``gate``) is at least a
    thousandth of the median leaf's."""
    keep = gate >= 1e-3 * float(np.median(gate))
    if not keep.any():
        return None
    denom = np.maximum(ref, float(np.median(ref)))
    return float(np.max(np.abs(prog - ref)[keep] / denom[keep]))


def numbers(prog: dict, ref: dict) -> dict:
    """The three compared numbers from the two sides' readings: each a
    dict with ``losses``, ``first`` (norms), ``change`` (norms)."""
    losses = max(abs(a - b) / abs(b)
                 for a, b in zip(prog["losses"], ref["losses"]))
    out = {"loss_gap": losses,
           "grad_gap": leaf_gap(prog["first"], ref["first"], ref["first"]),
           "change_gap": leaf_gap(prog["change"], ref["change"],
                                  ref["gmax"])}
    return {k: v for k, v in out.items() if v is not None}


def readings(losses, first, lora, init, gmax=None) -> dict:
    change = {t: [a - b for a, b in zip(lora[t], init[t])] for t in lora}
    return {"losses": list(losses), "first": leaf_norms(first),
            "change": leaf_norms(change), "gmax": gmax}
