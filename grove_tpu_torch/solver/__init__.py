"""The gang placement engine, on a CUDA device.

  serial.py       -- the serial baseline scorer and the engine's
                     exactness net (pure-Python loops with exact checks).
  engine.py       -- the batched path: every pending gang scored against
                     every topology domain at once on the device, then
                     committed exactly on host by the shared fit.py
                     primitives.
  kernel_core.py  -- the hand-written CUDA kernels of the device phase
                     and their plain PyTorch twins.
"""

from .engine import PlacementEngine
from .fit import place_gang_in_domain, placement_score_for_nodes
from .kernel_core import (
    device_commit_scan_plain,
    kernel_commit_scan,
    kernel_value,
    value_plain,
)
from .problem import SolverGang
from .result import GangPlacement, SolveResult
from .serial import solve_serial

__all__ = [
    "GangPlacement",
    "PlacementEngine",
    "SolveResult",
    "SolverGang",
    "device_commit_scan_plain",
    "kernel_commit_scan",
    "kernel_value",
    "place_gang_in_domain",
    "placement_score_for_nodes",
    "solve_serial",
    "value_plain",
]
