"""Lease-based leader election for the controller manager.

The reference runs HA operator replicas behind controller-runtime leader
election (manager.go:98-104: LeaderElectionID/ResourceLock/LeaseDuration;
coordination.k8s.io Lease under the hood): one active manager, standbys
acquire the lease when the holder stops renewing. The same contract here
as a store object: a named Lease with holder + renew deadline against the
virtual clock; managers gate their reconcile loop on holding it.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..api.meta import ObjectMeta
from ..cluster.store import ObjectStore


@dataclass
class Lease:
    """coordination.k8s.io/v1 Lease equivalent."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    holder_identity: str = ""
    lease_duration_seconds: float = 15.0
    renew_time: float = 0.0

    KIND = "Lease"


def lease_fresh(lease: Lease, now: float) -> bool:
    """A lease is FRESH while its holder has renewed within the lease
    duration of `now` — the one freshness predicate leader-election
    takeover, shard-worker liveness (controller/sharding.py) and
    standby-promotion fencing (cluster/replication.py) all share, so
    "who may act" can never drift between the three."""
    return bool(lease.holder_identity) and (
        now - lease.renew_time <= lease.lease_duration_seconds
    )


class LeaderElector:
    """Acquire/renew/yield one named lease.

    Deterministic single-threaded analog of the client-go leaderelection
    loop: try_acquire() is called at the top of every manager round —
    it renews when held, takes over when the current holder's lease
    expired, and reports False (stand by) otherwise."""

    def __init__(self, store: ObjectStore, identity: str,
                 lease_name: str = "grove-operator",
                 namespace: str = "grove-system",
                 lease_duration_seconds: float = 15.0):
        self.store = store
        self.identity = identity
        self.lease_name = lease_name
        self.namespace = namespace
        self.lease_duration_seconds = lease_duration_seconds

    def _lease(self) -> Lease | None:
        return self.store.get(Lease.KIND, self.namespace, self.lease_name)

    def is_leader(self) -> bool:
        lease = self._lease()
        return lease is not None and lease.holder_identity == self.identity

    def try_acquire(self) -> bool:
        """Renew/acquire; returns True when this identity holds the lease
        after the call."""
        now = self.store.clock.now()
        lease = self._lease()
        if lease is None:
            self.store.create(Lease(
                metadata=ObjectMeta(name=self.lease_name,
                                    namespace=self.namespace),
                holder_identity=self.identity,
                lease_duration_seconds=self.lease_duration_seconds,
                renew_time=now,
            ))
            return True
        if lease.holder_identity == self.identity:
            if lease.renew_time != now:  # skip no-op renew writes (the
                lease.renew_time = now   # settle loop runs many rounds
                self.store.update(lease)  # per clock instant)
            return True
        if not lease_fresh(lease, now):
            # released (immediately acquirable) or the holder stopped
            # renewing (crashed): take over
            lease.holder_identity = self.identity
            lease.renew_time = now
            self.store.update(lease)
            return True
        return False

    def release(self) -> None:
        """ReleaseOnCancel analog: a cleanly stopping leader hands off
        immediately instead of making standbys wait out the lease."""
        lease = self._lease()
        if lease is not None and lease.holder_identity == self.identity:
            lease.holder_identity = ""
            lease.renew_time = 0.0
            self.store.update(lease)
