"""Reconcilers + controller runtime (the operator's control plane).

The counterpart of grove_tpu/controller/__init__.py, with `GangScheduler`
exported beside `Harness`: a `Harness` with no `device` solves on the CUDA
card, `device="cpu"` runs the kernels' plain versions.
"""

from .runtime import ControllerManager, Reconciler, Request, Result
from .scheduler import GangScheduler
from .harness import Harness

__all__ = ["ControllerManager", "GangScheduler", "Harness", "Reconciler",
           "Request", "Result"]
