"""Optimizer and LR-schedule factories keyed by the Hyperparameter CR enums
(the port of ``datatunerx_tpu/training/optimizer.py``).

The reference maps the HF ``lr_scheduler_type`` / ``optim`` names to optax;
this module writes the same update rules out in PyTorch so that they follow
optax step for step: ``clip_by_global_norm`` (select between the update and
``t / norm * max_norm``), then Adam's moments with bias correction by
``1 - b**count`` and ``eps`` outside the square root, decoupled weight decay
added to the update before the learning rate (``adamw``), or heavy-ball
momentum (``sgd``); the learning rate is the schedule at the pre-step count,
with the sign flipped. ``adafactor`` is ``optax.adafactor(schedule)`` with
optax 0.2.6's defaults (a factored second moment over the two largest dims
of a leaf when both are at least 128, decay ``1 - (t+1)^-0.8``, eps 1e-30,
update clipping at block RMS 1.0, then the learning rate times the leaf's
parameter RMS floored at 1e-3); ``lion`` is ``optax.lion(schedule,
weight_decay)`` (b1 0.9, b2 0.99: the sign of the interpolated momentum,
weight decay added, times the learning rate). Both sit behind the
global-norm clip. Optimizer state stays in each trainable leaf's dtype
(the reference's ``_dtype_stable``). Trees are nested dicts of tensors.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

SCHEDULERS = (
    "linear", "cosine", "cosine_with_restarts", "polynomial",
    "constant", "constant_with_warmup",
)
OPTIMIZERS = ("adamw", "adamw_torch", "adamw_hf", "adam", "sgd", "adafactor",
              "lion")
SGD_MOMENTUM = 0.9  # the reference's optax.sgd(schedule, momentum=0.9)
# optax.adafactor's defaults (optax 0.2.6)
ADAFACTOR_MIN_DIM = 128
ADAFACTOR_DECAY = 0.8
ADAFACTOR_EPS = 1e-30
ADAFACTOR_CLIP = 1.0
ADAFACTOR_MIN_SCALE = 1e-3
LION_B1, LION_B2 = 0.9, 0.99


def tree_map(fn, tree, *rest):
    """Map over the leaves of nested dicts of the same structure (a node of
    ``rest`` at a leaf of ``tree`` is handed over whole)."""
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
def factored_dims(shape) -> Optional[Tuple[int, int]]:
    """optax's ``_factored_dims``: the (second largest, largest) axes when
    both are at least ``ADAFACTOR_MIN_DIM``, else None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < ADAFACTOR_MIN_DIM:
        return None
    return int(order[-2]), int(order[-1])


def _adafactor_init(p):
    one = lambda: torch.zeros((1,), dtype=p.dtype, device=p.device)  # noqa: E731
    dims = factored_dims(tuple(p.shape))
    if dims is None:
        return {"v_row": one(), "v_col": one(), "v": torch.zeros_like(p)}
    d1, d0 = dims
    row = [n for i, n in enumerate(p.shape) if i != d0]
    col = [n for i, n in enumerate(p.shape) if i != d1]
    return {"v_row": torch.zeros(row, dtype=p.dtype, device=p.device),
            "v_col": torch.zeros(col, dtype=p.dtype, device=p.device),
            "v": one()}


def _adafactor_leaf(g, st, p, decay: float, lr: float):
    """One leaf of optax.adafactor's chain after the global clip: factored
    rms scaling, block-rms clipping, learning rate, parameter scale, sign.
    The decay is an f32 array in optax, so the moment sums run in f32."""
    keep = float(np.float32(1.0) - np.float32(decay))
    sq = g * g + ADAFACTOR_EPS
    dims = factored_dims(tuple(p.shape))
    if dims is not None:
        d1, d0 = dims
        v_row = (decay * st["v_row"].float()
                 + keep * torch.mean(sq, dim=d0).float()).to(p.dtype)
        v_col = (decay * st["v_col"].float()
                 + keep * torch.mean(sq, dim=d1).float()).to(p.dtype)
        red = d1 - 1 if d1 > d0 else d1
        row_factor = (v_row / torch.mean(v_row, dim=red, keepdim=True)) ** -0.5
        col_factor = v_col ** -0.5
        u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
        new = {"v_row": v_row, "v_col": v_col, "v": st["v"]}
    else:
        v = (decay * st["v"].float() + keep * sq.float()).to(p.dtype)
        u = g * v ** -0.5
        new = {"v_row": st["v_row"], "v_col": st["v_col"], "v": v}
    u = u / torch.clamp(torch.sqrt(torch.mean(u * u)) / ADAFACTOR_CLIP,
                        min=1.0)
    u = torch.tensor(lr, dtype=u.dtype, device=u.device) * u
    rms = torch.sqrt(torch.mean(p * p))
    scale = torch.where(rms <= ADAFACTOR_MIN_SCALE,
                        torch.full_like(rms, ADAFACTOR_MIN_SCALE), rms)
    return -(u * scale), new


class Optimizer:
    """``init(params) -> state`` and ``update(grads, state, params) ->
    (updates, state)``, the optax contract; ``kind`` is ``adam`` (with
    ``weight_decay`` for adamw), ``sgd``, ``adafactor`` or ``lion``. The
    state is a dict with the step ``count`` (a host int: the schedule, the
    bias correction and adafactor's decay read it without a device sync)
    and the moments."""

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
        if self.kind == "lion":
            return {"count": 0, "mu": tree_map(zeros, params)}
        if self.kind == "adafactor":
            return {"count": 0, "factored": tree_map(_adafactor_init, params)}
        return {"count": 0, "mu": tree_map(zeros, params),
                "nu": tree_map(zeros, params)}

    def _clip(self, grads, norm=None):
        if not self.max_grad_norm or self.max_grad_norm <= 0:
            return grads
        norm = global_norm(grads) if norm is None else norm
        keep = norm < self.max_grad_norm
        return tree_map(
            lambda t: torch.where(keep, t,
                                  (t / norm.to(t.dtype)) * self.max_grad_norm),
            grads)

    def update(self, grads, state, params, norm=None):
        """``norm``: the global norm the clip divides by, when ``grads`` are
        one rank's shards of a sharded gradient (else computed here)."""
        count = state["count"]
        g = self._clip(grads, norm)
        lr = self.schedule(count)
        if self.kind == "sgd":
            trace = tree_map(lambda g_, t: g_ + SGD_MOMENTUM * t, g,
                             state["trace"])
            new_state = {"count": count + 1,
                         "trace": tree_map(lambda n, o: n.to(o.dtype), trace,
                                           state["trace"])}
            return tree_map(lambda t: t * -lr, trace), new_state
        if self.kind == "lion":
            return self._lion(g, state, params, lr)
        if self.kind == "adafactor":
            t = torch.tensor(float(count + 1), dtype=torch.float32)
            decay = float(1.0 - t ** -ADAFACTOR_DECAY)
            pairs = tree_map(
                lambda g_, st, p: _adafactor_leaf(g_, st, p, decay, lr), g,
                state["factored"], params)
            updates = tree_map(lambda pr: pr[0], pairs)
            factored = tree_map(lambda pr: pr[1], pairs)
            return updates, {"count": count + 1, "factored": factored}
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

    def _lion(self, g, state, params, lr):
        def c(x, like):
            # a Python scalar meets an array in the array's dtype in JAX
            return torch.tensor(x, dtype=like.dtype, device=like.device)

        def step(g_, m, p):
            u = torch.sign(c(1.0 - LION_B1, g_) * g_ + c(LION_B1, m) * m)
            if self.weight_decay:
                u = u + c(self.weight_decay, p) * p
            return c(-lr, u) * u

        updates = tree_map(step, g, state["mu"], params)
        mu = tree_map(lambda g_, m: (c(1.0 - LION_B2, g_) * g_
                                     + c(LION_B2, m) * m).to(m.dtype), g,
                      state["mu"])
        return updates, {"count": state["count"] + 1, "mu": mu}


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
    if name == "adafactor":
        return Optimizer("adafactor", schedule, 0.0, max_grad_norm)
    if name == "lion":
        return Optimizer("lion", schedule, weight_decay, max_grad_norm)
    raise ValueError(f"unknown optimizer {name!r}; choices {OPTIMIZERS}")
