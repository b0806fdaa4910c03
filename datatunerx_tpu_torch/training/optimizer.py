"""Optimizer and LR-schedule factories keyed by the Hyperparameter CR enums
(the port of ``datatunerx_tpu/training/optimizer.py``).

The reference maps the HF ``lr_scheduler_type`` / ``optim`` names to optax;
this module writes the same update rules out in PyTorch so that they follow
optax step for step: ``clip_by_global_norm`` (select between the update and
``t / norm * max_norm``), then Adam's moments with bias correction by
``1 - b**count`` and ``eps`` outside the square root, decoupled weight decay
added to the update before the learning rate (``adamw``), or heavy-ball
momentum (``sgd``); the learning rate is the schedule at the pre-step count,
with the sign flipped. Optimizer state stays in each trainable leaf's dtype
(the reference's ``_dtype_stable``). Trees are nested dicts of tensors.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch

SCHEDULERS = (
    "linear", "cosine", "cosine_with_restarts", "polynomial",
    "constant", "constant_with_warmup",
)
OPTIMIZERS = ("adamw", "adamw_torch", "adamw_hf", "adam", "sgd", "adafactor",
              "lion")
SGD_MOMENTUM = 0.9  # the reference's optax.sgd(schedule, momentum=0.9)


def tree_map(fn, tree, *rest):
    """Map over the leaves of nested dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


# ---------------------------------------------------------------- schedules
def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    if steps <= 0:
        return lambda count: init

    def schedule(count):
        frac = 1 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    return schedule


def _cosine(init: float, steps: int) -> Callable[[int], float]:
    def schedule(count):
        count = min(count, steps)
        return init * 0.5 * (1 + math.cos(math.pi * count / steps))

    return schedule


def _join(schedules, boundaries):
    def schedule(count):
        out = schedules[0](count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = sched(count - boundary)
        return out

    return schedule


def make_schedule(
    name: str,
    learning_rate: float,
    total_steps: int,
    warmup_ratio: float = 0.0,
    warmup_steps: int | None = None,
) -> Callable[[int], float]:
    """step (int) → learning rate (float), as the reference's optax
    schedule of the same name."""
    name = (name or "linear").lower()
    if warmup_steps is None:
        warmup_steps = int(total_steps * warmup_ratio)
    decay_steps = max(total_steps - warmup_steps, 1)

    if name == "constant" and warmup_steps == 0:
        return lambda count: learning_rate
    if name in ("constant", "constant_with_warmup"):
        body = lambda count: learning_rate  # noqa: E731
    elif name == "linear":
        body = _linear(learning_rate, 0.0, decay_steps)
    elif name == "cosine":
        body = _cosine(learning_rate, decay_steps)
    elif name == "cosine_with_restarts":
        # a 2-cycle sawtooth, as the reference keeps for "restarts"
        cycle = max(decay_steps // 2, 1)
        body = _join([_cosine(learning_rate, cycle),
                      _cosine(learning_rate, cycle)], [cycle])
    elif name == "polynomial":
        body = _linear(learning_rate, 0.0, decay_steps)  # power 1.0
    else:
        raise ValueError(f"unknown scheduler {name!r}; choices {SCHEDULERS}")

    if warmup_steps > 0:
        return _join([_linear(0.0, learning_rate, warmup_steps), body],
                     [warmup_steps])
    return body


# ---------------------------------------------------------------- optimizer
class Optimizer:
    """``init(params) -> state`` and ``update(grads, state, params) ->
    (updates, state)``, the optax contract; ``kind`` is ``adam`` (with
    ``weight_decay`` for adamw) or ``sgd``. The state is a dict with the
    step ``count`` (a host int: the schedule and the bias correction read
    it without a device sync) and the moments."""

    def __init__(self, kind: str, schedule, weight_decay: float = 0.0,
                 max_grad_norm: float = 1.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.kind = kind
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params) -> Dict:
        zeros = lambda p: torch.zeros_like(p)  # noqa: E731
        if self.kind == "sgd":
            return {"count": 0, "trace": tree_map(zeros, params)}
        return {"count": 0, "mu": tree_map(zeros, params),
                "nu": tree_map(zeros, params)}

    def _clip(self, grads):
        if not self.max_grad_norm or self.max_grad_norm <= 0:
            return grads
        norm = global_norm(grads)
        keep = norm < self.max_grad_norm
        return tree_map(
            lambda t: torch.where(keep, t,
                                  (t / norm.to(t.dtype)) * self.max_grad_norm),
            grads)

    def update(self, grads, state, params):
        count = state["count"]
        g = self._clip(grads)
        lr = self.schedule(count)
        if self.kind == "sgd":
            trace = tree_map(lambda g_, t: g_ + SGD_MOMENTUM * t, g,
                             state["trace"])
            new_state = {"count": count + 1,
                         "trace": tree_map(lambda n, o: n.to(o.dtype), trace,
                                           state["trace"])}
            return tree_map(lambda t: t * -lr, trace), new_state
        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda g_, m: (1 - b1) * g_ + b1 * m, g, state["mu"])
        nu = tree_map(lambda g_, n: (1 - b2) * (g_ * g_) + b2 * n, g,
                      state["nu"])
        c1 = float(torch.tensor(1.0) - torch.tensor(b1) ** (count + 1))
        c2 = float(torch.tensor(1.0) - torch.tensor(b2) ** (count + 1))

        def step(m, n, p):
            u = (m / c1) / (torch.sqrt(n / c2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p
            return u * -lr

        updates = tree_map(step, mu, nu, params)
        cast = lambda n, o: n.to(o.dtype)  # noqa: E731
        return updates, {"count": count + 1,
                         "mu": tree_map(cast, mu, state["mu"]),
                         "nu": tree_map(cast, nu, state["nu"])}


def make_optimizer(
    name: str,
    schedule,
    weight_decay: float = 0.0,
    max_grad_norm: float = 1.0,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> Optimizer:
    name = (name or "adamw").lower()
    if name in ("adamw", "adamw_torch", "adamw_hf"):
        return Optimizer("adam", schedule, weight_decay, max_grad_norm,
                         b1, b2, eps)
    if name == "adam":
        return Optimizer("adam", schedule, 0.0, max_grad_norm, b1, b2, eps)
    if name == "sgd":
        return Optimizer("sgd", schedule, 0.0, max_grad_norm)
    if name in ("adafactor", "lion"):
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet (ROADMAP Queue 1 item 8, "
            "trainer: adafactor and lion)")
    raise ValueError(f"unknown optimizer {name!r}; choices {OPTIMIZERS}")
