"""grove_tpu_torch: the grove placement solve in PyTorch, with hand-written
CUDA kernels for an NVIDIA H100 (sm_90a).

The port of grove_tpu (JAX on a TPU), which stays beside it as the
reference. This package imports torch and numpy, never jax and nothing of
grove_tpu. It covers the flat single-device placement solve,
`solver.PlacementEngine(snapshot).solve(gangs)` in both value-kernel
precisions (`pallas_precision="fp32"` or `"bf16"`), and the host modules
it needs (topology encoding, exact fit primitives, unsat diagnosis, and
the native C++ serial solve and exact repair, built with g++ at first
use). Its entry points run on the card unless the caller passes
device="cpu".
"""

# .solver before .native: the engine imports native, which imports solver
# modules back
from .solver import PlacementEngine, SolveResult, SolverGang
from .native import repair_native, solve_serial_native
from .topology import TopologySnapshot, default_cluster_topology, encode_topology

__all__ = [
    "PlacementEngine",
    "SolveResult",
    "SolverGang",
    "TopologySnapshot",
    "default_cluster_topology",
    "encode_topology",
    "repair_native",
    "solve_serial_native",
]
