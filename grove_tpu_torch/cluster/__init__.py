"""Simulated cluster: object store (apiserver), clock, nodes, kubelet,
node-lifecycle heartbeats.

The counterpart of grove_tpu/cluster/__init__.py.
"""

from .clock import SimClock
from .store import Event, ObjectStore, StoreError
from .inventory import make_nodes
from .kubelet import SimKubelet
from .cluster import Cluster
from .nodehealth import NODE_LEASE_NAMESPACE, NodeLease
from .replication import PromotionRefused, ReplicationLink, StandbyReplica

__all__ = [
    "Cluster",
    "Event",
    "NODE_LEASE_NAMESPACE",
    "NodeLease",
    "ObjectStore",
    "PromotionRefused",
    "ReplicationLink",
    "SimClock",
    "SimKubelet",
    "StandbyReplica",
    "StoreError",
    "make_nodes",
]
