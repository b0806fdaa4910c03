"""The four-axis device mesh over ``torch.distributed`` process groups (the
port of ``datatunerx_tpu/parallel/mesh.py``).

One process drives one card, so the mesh is a layout of process ranks:

  dp   — pure data parallelism (params replicated)
  fsdp — data parallelism with params, grads and optimizer state sharded
  tp   — tensor parallelism (megatron column/row splits)
  sp   — sequence parallelism (ring attention)

Ranks are laid out row-major over ``(dp, fsdp, tp, sp)``: rank = ((dp ·
F + fsdp) · TP + tp) · SP + sp, the order ``jax.make_mesh`` gives a flat
device list. ``Mesh`` holds this rank's coordinates and one process group
for each combination of axes the trainer and the model reduce over
(fsdp, tp and sp alone; the data axes (dp, fsdp); the batch axes (dp,
fsdp, sp); (dp, sp); the sharding axes (fsdp, tp)). A group of one rank
is ``None``: collectives over it are skipped.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Sequence

MESH_AXES = ("dp", "fsdp", "tp", "sp")

# the axis combinations the trainer and the model reduce over
GROUP_AXES = (("fsdp",), ("tp",), ("sp",), ("dp", "fsdp"),
              ("dp", "fsdp", "sp"), ("dp", "sp"), ("fsdp", "tp"))


def mesh_shape_for(
    n_devices: int,
    *,
    dp: Optional[int] = None,
    fsdp: Optional[int] = None,
    tp: int = 1,
    sp: int = 1,
) -> tuple[int, int, int, int]:
    """Resolve a (dp, fsdp, tp, sp) shape filling the unspecified data axis.

    Exactly one of dp/fsdp may be None; it absorbs the remaining devices.
    """
    fixed = tp * sp
    if dp is None and fsdp is None:
        dp, fsdp = n_devices // fixed, 1
    elif dp is None:
        dp = n_devices // (fsdp * fixed)
    elif fsdp is None:
        fsdp = n_devices // (dp * fixed)
    shape = (dp, fsdp, tp, sp)
    if math.prod(shape) != n_devices:
        raise ValueError(
            f"mesh shape {dict(zip(MESH_AXES, shape))} != {n_devices} devices"
        )
    return shape


class Mesh:
    """This rank's place on a (dp, fsdp, tp, sp) layout of process ranks.

    ``shape`` maps axis → size, ``coords`` axis → this rank's index;
    ``group(axes)`` is the process group over ``axes`` holding this rank
    (None when it holds one rank); ``ranks(axes)`` its global ranks in
    axis order."""

    def __init__(self, shape: Sequence[int], rank: int):
        self.shape: Dict[str, int] = dict(zip(MESH_AXES, shape))
        self.rank = rank
        coords, rest = {}, rank
        for ax in reversed(MESH_AXES):
            coords[ax] = rest % self.shape[ax]
            rest //= self.shape[ax]
        self.coords: Dict[str, int] = {ax: coords[ax] for ax in MESH_AXES}
        self._groups: Dict[tuple, object] = {}

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def rank_of(self, coords: Dict[str, int]) -> int:
        r = 0
        for ax in MESH_AXES:
            r = r * self.shape[ax] + coords[ax]
        return r

    def ranks(self, axes: Sequence[str]) -> list:
        """Global ranks of this rank's group over ``axes``, in axis order
        (the first axis major)."""
        out = []
        for idx in itertools.product(*(range(self.shape[a]) for a in axes)):
            c = dict(self.coords)
            c.update(zip(axes, idx))
            out.append(self.rank_of(c))
        return out

    def index(self, axes: Sequence[str]) -> int:
        """This rank's position in its group over ``axes``."""
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coords[a]
        return i

    def extent(self, axes: Sequence[str]) -> int:
        return math.prod(self.shape[a] for a in axes)

    def group(self, axes: Sequence[str]):
        return self._groups[tuple(axes)]

    @property
    def data_index(self) -> int:
        """The rank's data-parallel coordinate over (dp, fsdp): which rows
        of the global batch it feeds (tp and sp ranks share rows)."""
        return self.index(("dp", "fsdp"))

    @property
    def data_size(self) -> int:
        return self.extent(("dp", "fsdp"))

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank}, coords={self.coords})"


def _build_groups(mesh: Mesh) -> None:
    """Create every group of ``GROUP_AXES`` collectively: each rank of the
    world calls ``new_group`` for every group, in the same order, and keeps
    its own."""
    import torch.distributed as dist

    for axes in GROUP_AXES:
        others = [a for a in MESH_AXES if a not in axes]
        mine = None
        for fixed in itertools.product(*(range(mesh.shape[a])
                                         for a in others)):
            c = dict(zip(others, fixed))
            members = []
            for idx in itertools.product(*(range(mesh.shape[a])
                                           for a in axes)):
                c.update(zip(axes, idx))
                members.append(mesh.rank_of(c))
            if len(members) == 1:
                continue
            g = dist.new_group(members)
            if mesh.rank in members:
                mine = g
        mesh._groups[axes] = mine


def make_mesh(
    shape: Optional[Sequence[int]] = None,
    *,
    dp: Optional[int] = None,
    fsdp: Optional[int] = None,
    tp: int = 1,
    sp: int = 1,
    dcn_dp: int = 1,
) -> Optional[Mesh]:
    """The 4-axis mesh over the default process group's ranks, or None when
    no process group is initialised (the reference's all-ones mesh: one
    device, nothing to shard).

    ``dcn_dp`` > 1 splits the dp axis hierarchically (its major dimension
    crosses slices or hosts): the rank order stays dp-major, so the slices
    are contiguous rank ranges, as the reference's CPU emulation reshapes
    the flat device list. dp must divide by it."""
    import torch.distributed as dist

    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    if shape is None:
        shape = mesh_shape_for(world, dp=dp, fsdp=fsdp, tp=tp, sp=sp)
    shape = tuple(int(s) for s in shape)
    if len(shape) != 4:
        raise ValueError(f"expected 4-axis shape {MESH_AXES}, got {shape}")
    if dcn_dp > 1 and shape[0] % dcn_dp != 0:
        raise ValueError(
            f"dp={shape[0]} must be divisible by dcn_dp={dcn_dp} "
            "(cross-slice parallelism rides the dp axis)")
    if not initialized:
        if math.prod(shape) != 1:
            raise ValueError(
                f"mesh shape {dict(zip(MESH_AXES, shape))} needs "
                f"{math.prod(shape)} processes and no process group is "
                "initialised (parallel/distributed.py)")
        return None
    if math.prod(shape) != world:
        raise ValueError(
            f"mesh shape {dict(zip(MESH_AXES, shape))} != world size {world}")
    mesh = Mesh(shape, dist.get_rank())
    _build_groups(mesh)
    return mesh
