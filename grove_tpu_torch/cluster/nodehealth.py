"""Node heartbeat leases + Ready-condition bookkeeping.

The reference leaves node health entirely to Kubernetes: its E2E fault
model is cordons + pod kills, and a node is either schedulable or deleted.
Real TPU fleets fail in between — slices flap NotReady and come back,
maintenance drains whole hosts, an ICI/rack outage takes out a topology
domain at once. grove_tpu models the k8s machinery that detects and
absorbs those disruptions:

  - SimKubelet renews one coordination Lease per node (namespace
    `kube-node-lease`, like the real node-lease controller) against the
    virtual clock.
  - The NodeMonitor (controller/nodemonitor.py) compares each node's
    lease against the FRESHEST heartbeat in the cluster: a node lagging
    by more than `cluster.node_lease_duration_seconds` goes NotReady
    (Ready condition, api.types.NODE_CONDITION_READY). Comparing against
    the freshest heartbeat instead of wall-now makes the detector immune
    to virtual clock jumps — a test advancing four hours must not
    NotReady the whole fleet before the kubelet's next tick renews.
  - Pods on a NotReady node are swept to Failed only after
    `pod_eviction_grace_seconds` (the pod-eviction-timeout analog), and a
    recovered node re-enters the candidate set only after
    `node_stable_ready_seconds` of continuous renewal (flap damping).

This module is the shared vocabulary: the lease object + naming, the
renewal write, and the condition mutators. The policy lives in the
monitor; the heartbeat source lives in the kubelet.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..api.meta import ObjectMeta, set_condition
from ..api.types import NODE_CONDITION_READY, Node

#: Where node heartbeat leases live (the kube-node-lease namespace). The
#: leader-election lease shares the KIND but lives in its own namespace,
#: so the monitor's scans never see it.
NODE_LEASE_NAMESPACE = "kube-node-lease"


@dataclass(slots=True)
class NodeLease:
    """coordination.k8s.io/v1 Lease, as the node-lease controller uses it:
    one per node, named after the node, renewed every kubelet tick. KIND
    deliberately matches the leader-election Lease — both are exempt from
    chaos write faults (a faulted heartbeat write would model apiserver
    failure as node failure, which the heartbeat_loss fault models
    honestly instead)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    holder_identity: str = ""
    renew_time: float = 0.0

    KIND = "Lease"


def renew_node_lease(store, node_name: str, now: float) -> str:
    """Upsert the node's heartbeat lease to `now`. No-op when already
    renewed at this instant (the settle loop runs many rounds per clock
    instant; only the first tick writes). Returns "created", "renewed" or
    "" for the no-op."""
    lease = store.peek(NodeLease.KIND, NODE_LEASE_NAMESPACE, node_name)
    if lease is None:
        store.create(
            NodeLease(
                metadata=ObjectMeta(
                    name=node_name, namespace=NODE_LEASE_NAMESPACE
                ),
                holder_identity=node_name,
                renew_time=now,
            ),
            owned=True,
        )
        return "created"
    if lease.renew_time != now:
        fresh = store.get(NodeLease.KIND, NODE_LEASE_NAMESPACE, node_name)
        fresh.renew_time = now
        store.update(fresh)
        return "renewed"
    return ""


def node_lease_renew_times(store) -> dict[str, float]:
    """node name -> last heartbeat renew time (the monitor's one read)."""
    return {
        lease.metadata.name: lease.renew_time
        for lease in store.scan(
            NodeLease.KIND, namespace=NODE_LEASE_NAMESPACE
        )
    }


def set_node_ready(
    store, name: str, ready: bool, reason: str, message: str, now: float
) -> bool:
    """Flip the node's Ready condition through the status subresource
    (change-detected: a no-op flip writes nothing). Returns True when a
    write happened."""

    def mutate(status):
        set_condition(
            status.conditions,
            NODE_CONDITION_READY,
            "True" if ready else "False",
            reason=reason,
            message=message,
            now=now,
        )

    return store.patch_status(Node.KIND, "default", name, mutate)
