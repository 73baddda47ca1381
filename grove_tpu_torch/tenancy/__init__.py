"""Multi-tenant scheduling: hierarchical queues, quota, DRF fairness.

See queues.py for the model; api.config.TenancyConfig for the knobs.
The counterpart of grove_tpu/tenancy/: `Cluster` always builds the
TenancyManager, and the GangScheduler reads its admission decisions and
DRF fairness weights.
"""

from .queues import (
    ADMIT,
    QUEUE,
    SHED,
    DisruptionLedger,
    TenancyManager,
    TenantQueue,
)

__all__ = [
    "ADMIT",
    "QUEUE",
    "SHED",
    "DisruptionLedger",
    "TenancyManager",
    "TenantQueue",
]
