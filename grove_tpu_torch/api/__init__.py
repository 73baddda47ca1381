"""API objects the placement solve reads: node inventory and topology."""

from .meta import ObjectMeta
from .types import (
    ClusterTopology,
    ClusterTopologySpec,
    Node,
    NodeStatus,
    TopologyLevel,
    sort_topology_levels,
)
from .validation import ValidationError, validate_cluster_topology

__all__ = [
    "ClusterTopology",
    "ClusterTopologySpec",
    "Node",
    "NodeStatus",
    "ObjectMeta",
    "TopologyLevel",
    "ValidationError",
    "sort_topology_levels",
    "validate_cluster_topology",
]
