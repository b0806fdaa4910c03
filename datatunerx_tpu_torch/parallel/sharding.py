"""Sharding rules for the stacked-param tree and the collectives the
trainer and the model run over a ``parallel/mesh.Mesh`` (the port of
``datatunerx_tpu/parallel/sharding.py``).

The reference writes GSPMD partition specs; here each spec is a plain
tuple (one entry per dim: an axis name or None) read as a per-leaf
placement: which dim is cut over ``fsdp`` and which over ``tp``.

- ``fsdp`` cuts the contraction dim of every kernel (params, grads and
  optimizer state sharded; the trainer gathers the tree before the forward
  and reduce-scatters the grads).
- ``tp`` cuts the output dim of column-parallel kernels (q/k/v/gate/up)
  and the input dim of row-parallel kernels (o/down): megatron layout.
- A batch's rows go over (dp, fsdp) and its sequence over sp
  (``place_batch``).

The rules are path-based over the HF-style leaf names, so they apply to the
base params, LoRA adapters, gradients and optimizer-state mirrors alike.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

_COLUMN = {"q_proj", "k_proj", "v_proj", "gate_proj", "up_proj"}
_ROW = {"o_proj", "down_proj"}
_MODULES = _COLUMN | _ROW | {"lm_head", "embed_tokens"}

IGNORE_INDEX = -100


def _spec_for(path: tuple, x: Any) -> tuple:
    """The reference's ``_spec_for`` leaf for leaf, as a tuple."""
    names = [p for p in path if isinstance(p, str)]
    leaf = names[-1] if names else ""
    # the owning module may sit deeper than names[-2] (e.g.
    # layers/<proj>/quant/<leaf>): search the path for a known module name
    module = next((n for n in names if n in _MODULES), "")
    rank = getattr(x, "ndim", len(getattr(x, "shape", ())))

    if leaf == "embedding":  # [V, D]
        return ("tp", "fsdp")
    if module == "lm_head":  # [D, V]
        return ("fsdp", "tp")
    if leaf == "a" and rank == 3:  # LoRA A [L, in, r]
        return (None, "fsdp" if module in _COLUMN else "tp", None)
    if leaf == "b" and rank == 3:  # LoRA B [L, r, out]
        return (None, None, "tp" if module in _COLUMN else "fsdp")
    if leaf == "kernel" and rank == 3:  # [L, in, out]
        if module in _ROW:
            return (None, "tp", "fsdp")
        return (None, "fsdp", "tp")
    if leaf == "q" and rank == 3:  # int8 kernel [L, in, out] (ops/quant.py)
        if module in _ROW:
            return (None, "tp", "fsdp")
        return (None, "fsdp", "tp")
    if leaf == "bias" and rank == 2:  # [L, out]
        return (None, "tp" if module in _COLUMN else "fsdp")
    if leaf == "scale" and rank == 2 and (module in _COLUMN or module in _ROW):
        # int8 per-channel scales [L, out]
        return (None, "tp" if module in _COLUMN else "fsdp")
    if leaf in ("packed", "scale_q") and rank >= 2:
        # nf4 blocks are output-channel-contiguous: shard the block axis
        return (None, "fsdp", *([None] * (rank - 2)))
    # norms (tiny), optimizer-state scalars and anything unrecognized:
    # replicated
    return ()


def tree_map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    return fn(path, tree)


def param_pspecs(tree) -> Any:
    """The spec tuple of every leaf of ``tree`` (params / lora / grads /
    optimizer state)."""
    return tree_map_with_path(_spec_for, tree)


def _cuts(path, x, mesh, axes=("fsdp", "tp")) -> list:
    """[(dim, axis)] of the spec's cuts over ``axes`` with size > 1."""
    spec = _spec_for(path, x)
    return [(d, a) for d, a in enumerate(spec)
            if a in axes and mesh.shape[a] > 1]


def _slice(x, path, mesh, axes=("fsdp", "tp")):
    for dim, ax in _cuts(path, x, mesh, axes):
        n = mesh.shape[ax]
        if x.shape[dim] % n:
            raise ValueError(
                f"{'/'.join(map(str, path))} {tuple(x.shape)}: dim {dim} "
                f"does not divide over {ax}={n}")
        w = x.shape[dim] // n
        x = x.narrow(dim, mesh.coords[ax] * w, w)
    return x.contiguous()


def shard_tree(tree, mesh, axes=("fsdp", "tp")):
    """This rank's shard of every leaf of a whole (replicated) tree."""
    if mesh is None or tree is None:
        return tree
    return tree_map_with_path(lambda p, x: _slice(x, p, mesh, axes)
                              if isinstance(x, torch.Tensor) else x, tree)


def all_gather_dim(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """Concatenate the group's shards of ``x`` along ``dim`` (no grad)."""
    if group is None or n == 1:
        return x
    import torch.distributed as dist

    flag = x.dtype == torch.bool  # gloo moves no bool tensors
    x = x.to(torch.uint8) if flag else x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(torch.bool) if flag else out


def gather_leaf(x, path, mesh, axes=("fsdp", "tp")):
    for dim, ax in reversed(_cuts(path, x, mesh, axes)):
        x = all_gather_dim(x, dim, mesh.group((ax,)), mesh.shape[ax])
    return x


def use_axes(path) -> tuple:
    """The axes a leaf is gathered over before the forward uses it: fsdp
    for every leaf; tp too for the embedding and the head, which the model
    uses whole (the projections keep their tp shards)."""
    names = [p for p in path if isinstance(p, str)]
    whole = "embedding" in names or "lm_head" in names
    return ("fsdp", "tp") if whole else ("fsdp",)


def gather_for_use(tree, mesh):
    """The tree as the model reads it on this rank (``use_axes``)."""
    if mesh is None or tree is None:
        return tree
    return tree_map_with_path(
        lambda p, x: gather_leaf(x, p, mesh, use_axes(p))
        if isinstance(x, torch.Tensor) else x, tree)


def gather_tree(tree, mesh, axes=("fsdp", "tp")):
    """Whole leaves from this rank's shards (every rank takes part)."""
    if mesh is None or tree is None:
        return tree
    return tree_map_with_path(lambda p, x: gather_leaf(x, p, mesh, axes)
                              if isinstance(x, torch.Tensor) else x, tree)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group`` in place (a no-op for a one-rank group)."""
    if group is not None:
        import torch.distributed as dist

        dist.all_reduce(x, group=group)
    return x


def reduce_scatter_dim(x: torch.Tensor, dim: int, group, n: int,
                       index: int) -> torch.Tensor:
    """Sum ``x`` over ``group`` and keep shard ``index`` along ``dim``: an
    all-reduce and a narrow on every backend."""
    if group is None or n == 1:
        return x
    w = x.shape[dim] // n
    x = all_reduce(x.contiguous(), group)
    return x.narrow(dim, index * w, w).contiguous()


# ------------------------------------------------- autograd collectives
class _CopyToGroup(torch.autograd.Function):
    """Identity forward, all-reduce backward: a column-parallel input."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """All-reduce forward, identity backward: a row-parallel output."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x, group):
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x, group):
    return x if group is None else _ReduceFromGroup.apply(x, group)


class _GatherDim(torch.autograd.Function):
    """All-gather along ``dim`` forward; the backward keeps this rank's
    slice of the summed gradient (every rank's copy of the gathered tensor
    feeds its own graph)."""

    @staticmethod
    def forward(ctx, x, dim, group, n, index):
        ctx.args = (dim, group, n, index)
        return all_gather_dim(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        dim, group, n, index = ctx.args
        return (reduce_scatter_dim(g.contiguous(), dim, group, n, index),
                None, None, None, None)


def gather_dim(x, dim, mesh, axis):
    """Differentiable all-gather of ``x`` along ``dim`` over ``axis``."""
    n = mesh.shape[axis]
    if n == 1:
        return x
    return _GatherDim.apply(x, dim, mesh.group((axis,)), n,
                            mesh.coords[axis])


# ------------------------------------------------------------ batches
@dataclasses.dataclass(frozen=True)
class LocalSlice:
    """Where a rank's [b, t] block sits in the global [batch, seq] array:
    ``rows`` are ``(local_start, count, global_start)`` runs (one for a
    token batch, two for a chosen/rejected concatenation), ``t0`` the
    chunk's first position. The model draws dropout and NEFTune bits at
    these global counters and gives rope the global positions."""

    rows: tuple
    batch: int
    t0: int
    seq: int


def shift_labels(labels: np.ndarray, fill: int = IGNORE_INDEX) -> np.ndarray:
    """labels[:, 1:] with a ``fill`` column appended: position t's target is
    label t+1 on the global sequence, so a sequence chunk's last position
    reads the next chunk's first label."""
    labels = np.asarray(labels)
    pad = np.full(labels.shape[:-1] + (1,), fill, labels.dtype)
    return np.concatenate([labels[..., 1:], pad], axis=-1)


def host_rows(batch: dict, mesh, accum: bool = False) -> dict:
    """This rank's rows over (dp, fsdp) of a GLOBAL host batch: the slice
    the input pipeline hands a rank (``BatchIterator(host_id, num_hosts)``
    with the data-parallel index and size)."""
    if mesh is None:
        return batch
    n, i = mesh.data_size, mesh.data_index
    ax = 1 if accum else 0
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        w = v.shape[ax] // n
        out[k] = v.take(range(i * w, (i + 1) * w), axis=ax)
    return out


def place_batch(batch: dict, mesh, accum: bool = False) -> dict:
    """A rank's host batch (its rows over (dp, fsdp), whole sequences) →
    its sequence chunk over sp, labels shifted on the host before the cut.

    Adds ``labels_next`` (SFT: the shifted labels) or
    ``{chosen,rejected}_{ids,labels}_next`` (preference pairs: the shifted
    target ids and labels) and ``{chosen,rejected}_last`` (the global
    index of a row's last response token, for the reward head), then keeps
    positions ``[t0, t0 + t)`` of every [.., T] leaf. ``seq_len`` records
    the global T."""
    flat = {k: np.asarray(v) for k, v in batch.items() if v is not None}  # dtxlint: disable=DTX001 -- host numpy, no sync
    if mesh is None:
        return flat
    seq_ax = 2 if accum else 1
    if "labels" in flat:
        flat["labels_next"] = shift_labels(flat["labels"])
    for side in ("chosen", "rejected"):
        if f"{side}_ids" in flat:
            lab = flat[f"{side}_labels"]
            # the last position's target is masked by its label: any id
            flat[f"{side}_ids_next"] = shift_labels(flat[f"{side}_ids"],
                                                    fill=0)
            flat[f"{side}_labels_next"] = shift_labels(lab)
            T = lab.shape[-1]
            lanes = np.where(lab != IGNORE_INDEX, np.arange(T), -1)
            flat[f"{side}_last"] = np.maximum(lanes.max(axis=-1), 0).astype(
                np.int64)
    T = next(v.shape[seq_ax] for k, v in flat.items()
             if not k.endswith("_last"))
    sp, j = mesh.shape["sp"], mesh.coords["sp"]
    if T % sp:
        raise ValueError(f"sequence {T} does not divide over sp={sp}")
    t = T // sp
    out = {}
    for k, v in flat.items():
        out[k] = v if k.endswith("_last") else v.take(
            range(j * t, (j + 1) * t), axis=seq_ax)
    out["seq_len"] = np.asarray(T)
    return out
