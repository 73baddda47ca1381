"""Workload API types the placement solve reads.

The counterpart of grove_tpu/api/types.py, trimmed to what
`topology.encode_topology` consumes: the node inventory and the
ClusterTopology levels. The workload objects (PodCliqueSet, PodClique,
...) arrive with the control plane.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .meta import ObjectMeta

# --------------------------------------------------------------------------
# ClusterTopology
# --------------------------------------------------------------------------

#: Hierarchical order, broadest -> narrowest (clustertopology.go:123-131).
TOPOLOGY_DOMAIN_ORDER: dict[str, int] = {
    "region": 0,
    "zone": 1,
    "datacenter": 2,
    "block": 3,
    "rack": 4,
    "host": 5,
    "numa": 6,
}

#: Fixed singleton name (clustertopology.go:29).
CLUSTER_TOPOLOGY_NAME = "grove-topology"

MAX_TOPOLOGY_LEVELS = 7


@dataclass(slots=True)
class TopologyLevel:
    """Maps a provider-agnostic domain to a node label key
    (clustertopology.go:72-87)."""

    domain: str
    key: str


@dataclass(slots=True)
class ClusterTopologySpec:
    levels: list[TopologyLevel] = field(default_factory=list)


@dataclass(slots=True)
class ClusterTopology:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ClusterTopologySpec = field(default_factory=ClusterTopologySpec)

    KIND = "ClusterTopology"


def sort_topology_levels(levels: list[TopologyLevel]) -> list[TopologyLevel]:
    """Order levels broadest -> narrowest (clustertopology.go:134).

    Raises ValueError on a domain outside the fixed seven-domain hierarchy
    (the reference enforces this via a CRD enum)."""
    unknown = [lv.domain for lv in levels if lv.domain not in TOPOLOGY_DOMAIN_ORDER]
    if unknown:
        raise ValueError(
            f"unknown topology domain(s) {unknown}; "
            f"supported: {sorted(TOPOLOGY_DOMAIN_ORDER)}"
        )
    return sorted(levels, key=lambda lv: TOPOLOGY_DOMAIN_ORDER[lv.domain])


# --------------------------------------------------------------------------
# Node (simulated kwok-style inventory; stands in for corev1.Node)
# --------------------------------------------------------------------------

#: corev1.NodeConditionType Ready. status "True" = healthy; "False" =
#: NotReady. An ABSENT condition counts as ready.
NODE_CONDITION_READY = "Ready"


@dataclass(slots=True)
class NodeStatus:
    """Node status subresource: lifecycle conditions, each an object with
    `.type` and `.status` (corev1.NodeStatus.conditions analog)."""

    conditions: list = field(default_factory=list)


def node_ready(node: "Node") -> bool:
    """True unless the Ready condition is explicitly non-True (see
    NODE_CONDITION_READY)."""
    for c in node.status.conditions:
        if c.type == NODE_CONDITION_READY:
            return c.status == "True"
    return True


@dataclass(slots=True)
class Node:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    # allocatable resource name -> capacity
    allocatable: dict[str, float] = field(default_factory=dict)
    unschedulable: bool = False  # cordon
    # Taint keys (NoSchedule semantics): a pod may only land here if every
    # key appears in its tolerations.
    taints: list[str] = field(default_factory=list)
    status: NodeStatus = field(default_factory=NodeStatus)

    KIND = "Node"
