"""grove_tpu_torch: the grove placement solve in PyTorch, with hand-written
CUDA kernels for an NVIDIA H100 (sm_90a).

The port of grove_tpu (JAX on a TPU), which stays beside it as the
reference. This package imports torch and numpy, never jax and nothing of
grove_tpu. It covers the flat single-device placement solve,
`solver.PlacementEngine(snapshot).solve(gangs)`, and the host modules it
needs (topology encoding, exact fit primitives, unsat diagnosis). Its
entry points run on the card unless the caller passes device="cpu".
"""

from .solver import PlacementEngine, SolveResult, SolverGang
from .topology import TopologySnapshot, default_cluster_topology, encode_topology

__all__ = [
    "PlacementEngine",
    "SolveResult",
    "SolverGang",
    "TopologySnapshot",
    "default_cluster_topology",
    "encode_topology",
]
