"""AdapterStore: a fixed-geometry device pool of LoRA adapter weights (the
port of ``datatunerx_tpu/adapters/store.py``).

Adapter weights are DATA, not engine config. Per LoRA target the store owns
a stacked pool buffer

    a: [L, P + 1, d_in, rank_max]      b: [L, P + 1, rank_max, d_out]

(P usable pool slots plus the reserved all-zero base slot 0) and a scale
vector ``[P + 1]`` (f32). The layout is the stacked-adapter tree that
``models/llama.forward(..., lora_adapter_idx=...)`` consumes, so each batch
row gathers its own slot and loading an adapter changes no shape.

The pool is held in the engine's compute dtype (bf16 on the card): the
reference keeps f32 and casts to bf16 inside the projection, which rounds
the same values the same way.

Adapters of rank < rank_max are zero-padded: zero columns of A and zero
rows of B add nothing to h·A·B, so the padding is numerically invisible.
A rank above rank_max, or a target outside the pool's set, is refused with
a typed error.

Writes never touch a buffer a reader may hold: ``insert``/``clear`` clone
the target's buffers, write the slot, wait for the copies on the current
stream, and only then swap ``self.tree``. A decode step that read the
previous snapshot keeps reading consistent buffers, and a slot that a live
row indexes is never written (the registry pins it).
"""

from __future__ import annotations

import threading
from typing import Dict, Sequence, Tuple

import torch

from datatunerx_tpu_torch.models.config import ModelConfig
from datatunerx_tpu_torch.models.lora import (
    DEFAULT_TARGETS,
    LORA_TARGETS,
    target_dims,
)


class AdapterRankError(ValueError):
    """Adapter rank exceeds the pool's rank_max."""


class AdapterTargetError(ValueError):
    """Adapter trains a target projection the pool does not carry."""


def adapter_rank(layers: dict) -> int:
    """The (max, across targets) rank of a loaded adapter layer tree."""
    return max(int(leaf["a"].shape[-1]) for leaf in layers.values())


def validate_adapter(layers: dict, rank_max: int,
                     targets: Sequence[str], name: str = "") -> int:
    """Check a loaded adapter tree against the pool geometry; returns its
    rank. Raises AdapterRankError / AdapterTargetError with the numbers an
    operator needs to fix the mismatch."""
    label = f"adapter {name!r}" if name else "adapter"
    if not layers:
        raise ValueError(f"{label}: empty lora layer tree")
    extra = sorted(set(layers) - set(targets))
    if extra:
        raise AdapterTargetError(
            f"{label}: targets {extra} not in the pool's target set "
            f"{sorted(targets)}; restart the server with --adapter_targets "
            "covering them")
    rank = adapter_rank(layers)
    if rank > rank_max:
        raise AdapterRankError(
            f"{label}: rank {rank} exceeds the pool's rank_max {rank_max}; "
            "re-train at a lower rank or restart with a larger "
            "--adapter_rank_max")
    return rank


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


class AdapterStore:
    """Device pool buffers and slot bookkeeping. ``self.tree`` is one
    attribute holding a consistent ``(tree, scales)`` snapshot; mutations
    publish a new one."""

    def __init__(self, cfg: ModelConfig, pool_slots: int, rank_max: int,
                 targets: Sequence[str] = DEFAULT_TARGETS,
                 dtype=torch.bfloat16, device="cpu"):
        if pool_slots < 1:
            raise ValueError(f"pool_slots must be >= 1, got {pool_slots}")
        if rank_max < 1:
            raise ValueError(f"rank_max must be >= 1, got {rank_max}")
        targets = tuple(sorted(set(targets)))
        bad = [t for t in targets if t not in LORA_TARGETS]
        if bad:
            raise ValueError(
                f"invalid lora targets {bad}; choices: {LORA_TARGETS}")
        self.cfg = cfg
        self.pool_slots = int(pool_slots)  # usable slots, device idx 1..P
        self.rank_max = int(rank_max)
        self.targets = targets
        self.dtype = dtype
        self.device = torch.device(device)
        L, E = cfg.num_layers, self.pool_slots + 1  # + base zero slot 0
        self._buffers: Dict[str, Dict[str, torch.Tensor]] = {}
        for t in targets:
            d_in, d_out = target_dims(cfg, t)
            self._buffers[t] = {
                "a": torch.zeros((L, E, d_in, rank_max), dtype=dtype,
                                 device=self.device),
                "b": torch.zeros((L, E, rank_max, d_out), dtype=dtype,
                                 device=self.device),
            }
        self._scales = torch.zeros((E,), dtype=torch.float32,
                                   device=self.device)
        # serialises writers (the registry's loaders already hold its lock)
        self._lock = threading.Lock()
        self.tree: Tuple[dict, torch.Tensor] = self._republish()

    def nbytes(self) -> int:
        """Device bytes the pool holds."""
        total = sum(buf["a"].nbytes + buf["b"].nbytes
                    for buf in self._buffers.values())
        return int(total + self._scales.nbytes)

    # ------------------------------------------------------------ mutations
    def _republish(self):
        layers = {t: dict(buf) for t, buf in self._buffers.items()}
        self.tree = ({"layers": layers}, self._scales)
        return self.tree

    def _write(self, slot: int, rows: Dict[str, tuple], scaling: float):
        """Clone every target's buffers, write ``slot``'s rows, order the
        copies before any later reader, then publish the new snapshot."""
        with torch.no_grad():
            for t, (a_row, b_row) in rows.items():
                buf = self._buffers[t]
                a, b = buf["a"].clone(), buf["b"].clone()
                a[:, slot] = a_row
                b[:, slot] = b_row
                buf["a"], buf["b"] = a, b
            scales = self._scales.clone()
            scales[slot] = float(scaling)
            self._scales = scales
            _sync(self.device)
        self._republish()

    def insert(self, slot: int, layers: dict, scaling: float,
               name: str = "") -> int:
        """Pad and write one adapter into pool ``slot`` (device idx 1..P).
        Validates geometry first; a rejected adapter leaves the pool
        untouched. Returns the adapter's rank."""
        self._check_slot(slot)
        rank = validate_adapter(layers, self.rank_max, self.targets,
                                name=name)
        L = self.cfg.num_layers
        rows = {}
        for t in self.targets:
            buf = self._buffers[t]
            a_row = torch.zeros((L,) + tuple(buf["a"].shape[2:]),
                                dtype=torch.float32)
            b_row = torch.zeros((L,) + tuple(buf["b"].shape[2:]),
                                dtype=torch.float32)
            if t in layers:  # an absent target keeps a zero delta
                ar = torch.as_tensor(layers[t]["a"]).float().cpu()
                br = torch.as_tensor(layers[t]["b"]).float().cpu()
                if ar.shape[0] != L:
                    raise ValueError(
                        f"adapter {name!r}: {t} has {ar.shape[0]} layers, "
                        f"model has {L}")
                r = ar.shape[-1]
                a_row[:, :, :r] = ar
                b_row[:, :r, :] = br
            rows[t] = (a_row.to(self.dtype).to(self.device),
                       b_row.to(self.dtype).to(self.device))
        with self._lock:
            self._write(slot, rows, scaling)  # dtxlint: disable=DTX009 — bounded copy wait; the lock serialises pool writers only (ROADMAP Queue 3)
        return rank

    def clear(self, slot: int):
        """Zero a slot: a stale adapter never leaks into a request that
        lands on a recycled slot before its insert."""
        self._check_slot(slot)
        with self._lock:
            rows = {t: (torch.zeros_like(buf["a"][:, slot]),
                        torch.zeros_like(buf["b"][:, slot]))
                    for t, buf in self._buffers.items()}
            self._write(slot, rows, 0.0)  # dtxlint: disable=DTX009 — bounded copy wait; the lock serialises pool writers only (ROADMAP Queue 3)

    def _check_slot(self, slot: int):
        if not 1 <= slot <= self.pool_slots:
            raise ValueError(
                f"pool slot {slot} out of range 1..{self.pool_slots} "
                "(slot 0 is the reserved base adapter)")


def hbm_bytes(cfg: ModelConfig, pool_slots: int, rank_max: int,
              targets: Sequence[str] = DEFAULT_TARGETS,
              dtype=torch.bfloat16) -> int:
    """Device bytes of a pool geometry without building it."""
    L, E = cfg.num_layers, pool_slots + 1
    item = torch.empty((), dtype=dtype).element_size()
    total = E * 4  # scales, f32
    for t in sorted(set(targets)):
        d_in, d_out = target_dims(cfg, t)
        total += item * L * E * rank_max * (d_in + d_out)
    return total
