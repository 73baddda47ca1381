"""Encode the cluster topology tree + node inventory as dense arrays.

The counterpart of grove_tpu/topology/encoding.py, copied whole. It
imports nothing of grove_tpu, so the two packages' objects compare field
by field.

The reference hands topology to the external KAI scheduler as an ordered list
of node-label keys (operator/internal/clustertopology/clustertopology.go:
141-175, KAI Topology CR). grove_tpu instead consumes the same information
directly: the ordered levels plus each node's labels are flattened into a
(levels x nodes) integer matrix of *hierarchical* domain ids, which is the
native input format for a vectorized placement solver (one-hot membership
matrices, segment sums over domains) on TPU.

Hierarchy is encoded by path, not by raw label value: the domain id of node n
at level l is the dense id of the tuple (label_0(n), ..., label_l(n)), so two
racks both labelled "rack-0" under different blocks get distinct ids —
matching the semantic strictness the reference's topology design doc requires
(docs/designs/topology.md:530-541).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..api.types import (
    CLUSTER_TOPOLOGY_NAME,
    ClusterTopology,
    ClusterTopologySpec,
    Node,
    TopologyLevel,
    node_ready,
    sort_topology_levels,
)
from ..api.meta import ObjectMeta
from ..api.validation import validate_cluster_topology

#: Label key for the auto-added narrowest level, mirroring the reference's
#: auto-added `host` level -> kubernetes.io/hostname
#: (clustertopology.go:109-121).
HOST_LABEL_KEY = "kubernetes.io/hostname"

#: Default resource vector ordering when callers don't pin one.
DEFAULT_RESOURCES = ("cpu", "memory", "tpu")


def default_cluster_topology(
    levels: list[TopologyLevel] | None = None,
) -> ClusterTopology:
    """Build the singleton ClusterTopology, sorted broadest->narrowest, with
    the `host` level auto-appended when absent (clustertopology.go:77-121)."""
    levels = list(levels or [])
    if not any(lv.domain == "host" for lv in levels):
        levels.append(TopologyLevel(domain="host", key=HOST_LABEL_KEY))
    return ClusterTopology(
        metadata=ObjectMeta(name=CLUSTER_TOPOLOGY_NAME, namespace=""),
        spec=ClusterTopologySpec(levels=sort_topology_levels(levels)),
    )


@dataclass
class TopologySnapshot:
    """Dense, solver-ready view of the cluster at one instant.

    Shapes: L = topology levels (broadest->narrowest, last level is
    per-node), N = nodes, R = resource kinds.
    """

    level_keys: list[str]                 # node-label key per level
    level_domains: list[list[tuple]]      # per level: domain path-tuple per id
    domain_ids: np.ndarray                # int32 [L, N]
    num_domains: np.ndarray               # int32 [L]
    node_names: list[str]
    node_index: dict[str, int]
    resource_names: list[str]
    capacity: np.ndarray                  # float32 [N, R] allocatable
    free: np.ndarray                      # float32 [N, R] allocatable - used
    schedulable: np.ndarray               # bool [N]
    #: monotonic free-content stamp (Cluster.topology_snapshot bumps it
    #: whenever the usage underlying `free` changed since the previous
    #: snapshot refresh). An unchanged stamp proves the cluster's
    #: free-delta journal gained no rows, letting the scheduler skip the
    #: journal drain before a solve (GangScheduler._feed_free_journal —
    #: the cluster-side half of the solver's device-resident state
    #: discipline in solver/engine.py _sync_free).
    free_epoch: int = 0
    node_labels: list[dict] = field(default_factory=list, repr=False)
    node_taints: list[list] = field(default_factory=list, repr=False)
    _memberships: dict[int, np.ndarray] = field(default_factory=dict, repr=False)
    _elig_cache: dict = field(default_factory=dict, repr=False)

    @property
    def num_levels(self) -> int:
        return int(self.domain_ids.shape[0])

    @property
    def has_taints(self) -> bool:
        """True when any node carries a taint — then even selector-less pods
        are constrained (they must avoid tainted nodes they don't tolerate)."""
        return any(self.node_taints)

    def eligibility(
        self, node_selector: dict[str, str], tolerations: list[str]
    ) -> np.ndarray:
        """bool [N] mask: node i is eligible iff its labels satisfy every
        node_selector entry and every taint key on it is tolerated.

        The reference embeds full corev1.PodSpec whose selectors/taints the
        delegated scheduler honors (operator/api/core/v1alpha1/podclique.go:
        60-63); grove_tpu owns the scheduler, so this mask is the hard
        filter both solve paths enforce. Masks are cached per (selector,
        tolerations) signature — pods come from few templates, so the cache
        stays tiny and shared references keep per-gang memory O(1).
        """
        key = (
            tuple(sorted(node_selector.items())),
            tuple(sorted(set(tolerations))),
        )
        mask = self._elig_cache.get(key)
        if mask is None:
            tol = set(tolerations)
            mask = np.ones(self.num_nodes, dtype=bool)
            sel = node_selector.items()
            for i in range(self.num_nodes):
                labels = self.node_labels[i] if i < len(self.node_labels) else {}
                taints = self.node_taints[i] if i < len(self.node_taints) else ()
                if any(labels.get(k) != v for k, v in sel) or any(
                    t not in tol for t in taints
                ):
                    mask[i] = False
            mask.setflags(write=False)  # shared across gangs
            self._elig_cache[key] = mask
        return mask

    @property
    def num_nodes(self) -> int:
        return int(self.domain_ids.shape[1])

    def membership(self, level: int) -> np.ndarray:
        """One-hot [N, D_level] float32 domain-membership matrix (cached).

        The solver's segment sums over domains are `M.T @ x`; on TPU these
        become MXU matmuls, which is exactly why the topology is encoded
        this way rather than as the reference's label-selector tree walk.
        """
        if level not in self._memberships:
            d = int(self.num_domains[level])
            m = np.zeros((self.num_nodes, d), dtype=np.float32)
            m[np.arange(self.num_nodes), self.domain_ids[level]] = 1.0
            self._memberships[level] = m
        return self._memberships[level]

    def level_index(self, key_or_domain: str, topology: ClusterTopology | None = None) -> int:
        """Resolve a node-label key (scheduler contract) to a level index."""
        if key_or_domain in self.level_keys:
            return self.level_keys.index(key_or_domain)
        if topology is not None:
            for i, lv in enumerate(topology.spec.levels):
                if lv.domain == key_or_domain and lv.key in self.level_keys:
                    return self.level_keys.index(lv.key)
        raise KeyError(f"unknown topology level {key_or_domain!r}")

    def domains_at(self, level: int) -> int:
        return int(self.num_domains[level])


def encode_topology(
    topology: ClusterTopology,
    nodes: list[Node],
    usage: dict[str, dict[str, float]] | None = None,
    resource_names: list[str] | None = None,
) -> TopologySnapshot:
    """Flatten topology levels + node labels + capacity into a snapshot.

    usage: node name -> {resource: amount consumed by bound pods}. Nodes
    missing a level label are placed in a per-node singleton domain at that
    level (conservative: they never pack with anything).

    The topology is validated on entry (unknown/duplicate domains or keys
    raise ValidationError) so every snapshot downstream of here — and
    therefore every solve — works on a well-formed hierarchy.
    """
    validate_cluster_topology(topology)
    levels = list(topology.spec.levels)
    if not any(lv.key == HOST_LABEL_KEY or lv.domain == "host" for lv in levels):
        # Append before sorting so host lands in hierarchy order (above numa),
        # matching default_cluster_topology.
        levels.append(TopologyLevel(domain="host", key=HOST_LABEL_KEY))
    levels = sort_topology_levels(levels)
    level_keys = [lv.key for lv in levels]
    n = len(nodes)
    l = len(level_keys)
    usage = usage or {}

    if resource_names is None:
        seen = set(DEFAULT_RESOURCES)
        resource_names = list(DEFAULT_RESOURCES)
        for node in nodes:
            for r in node.allocatable:
                if r not in seen:
                    seen.add(r)
                    resource_names.append(r)

    domain_ids = np.zeros((l, n), dtype=np.int32)
    num_domains = np.zeros((l,), dtype=np.int32)
    level_domains: list[list[tuple]] = []
    # Path-prefix encoding: id at level l keyed by the tuple of labels 0..l.
    prefixes: list[tuple] = [() for _ in range(n)]
    for li, key in enumerate(level_keys):
        ids: dict[tuple, int] = {}
        domains: list[tuple] = []
        for ni, node in enumerate(nodes):
            value = node.metadata.labels.get(key)
            if value is None and (key == HOST_LABEL_KEY or li == l - 1):
                value = node.metadata.name  # host level defaults to node name
            if value is None:
                value = f"\x00missing/{node.metadata.name}"  # singleton domain
            prefixes[ni] = prefixes[ni] + (value,)
            did = ids.get(prefixes[ni])
            if did is None:
                did = len(ids)
                ids[prefixes[ni]] = did
                domains.append(prefixes[ni])
            domain_ids[li, ni] = did
        num_domains[li] = len(ids)
        level_domains.append(domains)

    capacity = np.zeros((n, len(resource_names)), dtype=np.float32)
    free = np.zeros_like(capacity)
    schedulable = np.ones((n,), dtype=bool)
    for ni, node in enumerate(nodes):
        for ri, r in enumerate(resource_names):
            capacity[ni, ri] = float(node.allocatable.get(r, 0.0))
        # Candidate-set membership: cordons, deletion marks AND the
        # lifecycle Ready condition. NotReady nodes (heartbeat lost,
        # domain outage, stabilizing after a flap) are excluded here, and
        # `schedulable` is what every solve path keys its node candidates
        # on — so displaced gangs can only repair onto healthy domains.
        schedulable[ni] = (
            not node.unschedulable
            and node.metadata.deletion_timestamp is None
            and node_ready(node)
        )

    snapshot = TopologySnapshot(
        level_keys=level_keys,
        level_domains=level_domains,
        domain_ids=domain_ids,
        num_domains=num_domains,
        node_names=[node.metadata.name for node in nodes],
        node_index={node.metadata.name: i for i, node in enumerate(nodes)},
        resource_names=list(resource_names),
        capacity=capacity,
        free=free,
        schedulable=schedulable,
        node_labels=[node.metadata.labels for node in nodes],
        node_taints=[list(node.taints) for node in nodes],
    )
    apply_usage(snapshot, usage)
    return snapshot


def apply_usage(
    snapshot: TopologySnapshot, usage: dict[str, dict[str, float]]
) -> None:
    """Refresh snapshot.free = capacity - usage in place. The ONE home of
    the free-capacity accounting: the fresh encode above and the cluster's
    cached-snapshot refresh (cluster.py topology_snapshot) both call it,
    so usage semantics cannot silently diverge between cache hit and
    miss. Also bounds the snapshot's eligibility-mask cache, which lives
    as long as the (cached) snapshot does."""
    np.copyto(snapshot.free, snapshot.capacity)
    if usage:
        res_index = {r: i for i, r in enumerate(snapshot.resource_names)}
        for node_name, used in usage.items():
            ni = snapshot.node_index.get(node_name)
            if ni is None:
                continue
            for r, amount in used.items():
                ri = res_index.get(r)
                if ri is not None:
                    snapshot.free[ni, ri] -= amount
    if len(snapshot._elig_cache) > 1024:
        snapshot._elig_cache.clear()
