"""Simulated cluster: object store (apiserver), clock, nodes, kubelet,
node-lifecycle heartbeats.

The counterpart of grove_tpu/cluster/__init__.py, less the replication
names (`PromotionRefused`, `ReplicationLink`, `StandbyReplica`), which
arrive with ROADMAP item 8.
"""

from .clock import SimClock
from .store import Event, ObjectStore, StoreError
from .inventory import make_nodes
from .kubelet import SimKubelet
from .cluster import Cluster
from .nodehealth import NODE_LEASE_NAMESPACE, NodeLease

__all__ = [
    "Cluster",
    "Event",
    "NODE_LEASE_NAMESPACE",
    "NodeLease",
    "ObjectStore",
    "SimClock",
    "SimKubelet",
    "StoreError",
    "make_nodes",
]
