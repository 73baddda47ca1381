"""Topology encoding: ClusterTopology + node inventory -> dense solver inputs."""

from .encoding import (
    HOST_LABEL_KEY,
    TopologySnapshot,
    default_cluster_topology,
    encode_topology,
)

__all__ = [
    "TopologySnapshot",
    "default_cluster_topology",
    "encode_topology",
    "HOST_LABEL_KEY",
]
