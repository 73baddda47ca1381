"""Federation: multi-cluster scheduling with whole-cluster failover.

The global layer above ROADMAP item 3's hierarchy — member clusters as
super-domains routed by the same over-admitting coarse cuts the
hierarchical pruner uses, each member a full self-contained control
plane, with lease-lag outage detection, term-fenced whole-cluster
failover, and budget-paced draining into survivors. See
coordinator.py's module docstring for the architecture and
docs/operations.md for the runbook.

The counterpart of grove_tpu/federation/.
"""

from .coordinator import (
    FEDERATION_GAUGES,
    ClusterCell,
    FederationCoordinator,
)
from .health import ClusterHealthMonitor
from .journal import (
    FEDERATION_NAMESPACE,
    FederationClusterState,
    FederationJournal,
    FederationRoute,
)

__all__ = [
    "FEDERATION_GAUGES",
    "FEDERATION_NAMESPACE",
    "ClusterCell",
    "ClusterHealthMonitor",
    "FederationClusterState",
    "FederationCoordinator",
    "FederationJournal",
    "FederationRoute",
]
