"""Controller runtime and the gang scheduler.

The counterpart of grove_tpu/controller/__init__.py, less the `Harness`
and the workload controllers it builds (ROADMAP item 6b-ii): PodGangs
and their ungated Pods go in, and `GangScheduler` hands back bindings,
conditions, events, metrics and decisions.
"""

from .runtime import ControllerManager, Reconciler, Request, Result
from .scheduler import GangScheduler

__all__ = ["ControllerManager", "GangScheduler", "Reconciler", "Request", "Result"]
