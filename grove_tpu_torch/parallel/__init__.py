"""Multi-process sharding of the placement engine on `torch.distributed`.

The counterpart of grove_tpu/parallel/. `sharded_score` is the mesh
program itself (the reference's `sharded_score_fn` builds a jitted
function; PyTorch runs it eagerly, so the port exports the function)."""

from .multihost import initialize_multihost
from .sharded import (
    ShardedPlacementEngine,
    make_solver_mesh,
    mesh_shape,
    sharded_score,
)

__all__ = [
    "ShardedPlacementEngine",
    "initialize_multihost",
    "make_solver_mesh",
    "mesh_shape",
    "sharded_score",
]
