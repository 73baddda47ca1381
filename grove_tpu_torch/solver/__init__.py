"""The gang placement engine, on a CUDA device.

  serial.py       -- the serial baseline scorer and the engine's
                     exactness net (pure-Python loops with exact checks).
  engine.py       -- the batched path: every pending gang scored against
                     every topology domain at once on the device, then
                     committed exactly on host, in C++ by default
                     (grove_tpu_torch/native) or by the fit.py primitives.
  kernel_core.py  -- the hand-written CUDA kernels of the device phase
                     and their plain PyTorch twins.
  problem.py      -- PodGangs (the scheduler contract) encoded into the
                     dense gang structs every solve path takes.
"""

from .engine import PlacementEngine
from .fit import place_gang_in_domain, placement_score_for_nodes
from .kernel_core import (
    commit_topk_plain,
    device_commit_scan_plain,
    kernel_commit_scan,
    kernel_commit_topk,
    kernel_value,
    kernel_value_sig,
    launch_counts,
    reset_launches,
    value_plain,
    value_plain_bf16,
    value_sig_plain,
    value_sig_plain_bf16,
)
from .problem import SolverGang, encode_podgangs
from .result import GangPlacement, SolveResult
from .serial import solve_serial

__all__ = [
    "GangPlacement",
    "PlacementEngine",
    "SolveResult",
    "SolverGang",
    "commit_topk_plain",
    "device_commit_scan_plain",
    "encode_podgangs",
    "kernel_commit_scan",
    "kernel_commit_topk",
    "kernel_value",
    "kernel_value_sig",
    "launch_counts",
    "place_gang_in_domain",
    "placement_score_for_nodes",
    "reset_launches",
    "solve_serial",
    "value_plain",
    "value_plain_bf16",
    "value_sig_plain",
    "value_sig_plain_bf16",
]
