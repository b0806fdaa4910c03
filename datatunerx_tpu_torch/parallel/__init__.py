"""Multi-GPU training: the process group (``distributed``), the 4-axis
mesh of process ranks (``mesh``), the sharding rules and collectives
(``sharding``) and the per-card memory model (``memory``)."""

from datatunerx_tpu_torch.parallel.mesh import (
    MESH_AXES,
    Mesh,
    make_mesh,
    mesh_shape_for,
)
from datatunerx_tpu_torch.parallel.sharding import (
    param_pspecs,
    place_batch,
    shard_tree,
)

__all__ = [
    "MESH_AXES",
    "Mesh",
    "make_mesh",
    "mesh_shape_for",
    "param_pspecs",
    "place_batch",
    "shard_tree",
]
