"""The federation coordinator's durable journal (the global-layer
store).

The coordinator's routing table and cluster fencing decisions are
control-plane state with the same durability obligation as any member
cluster's objects: losing them on a coordinator crash would forget
which cluster owns which gang — the exact amnesia whole-cluster
failover exists to prevent, one level up. Rather than invent a second
persistence mechanism, the journal IS an ObjectStore with a DurableLog
attached (the durable store's machinery end to end): records are plain
dataclass objects journaled through the normal commit path, recovery
is `load_durable_state`, and the log carries the same term/fence
discipline every cluster log does — so a deposed coordinator replica
could itself be fenced with `replication.fence_deposed`.

Two record kinds:

  FederationRoute          one per gang ever routed: home cluster +
                           verdict ("Routed" or "NoFeasibleCluster")
                           + detail (e.g. "drained from c1")
  FederationClusterState   one per member cluster: lifecycle state
                           ("ready"/"fenced"/"drained") + fencing term

`FederationCoordinator.crash_recover()` rebuilds every in-memory
routing structure from these records alone (the coordinator_crash
chaos fault drives it).

The counterpart of grove_tpu/federation/journal.py.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

from ..api.config import DurabilityConfig
from ..api.meta import ObjectMeta
from ..cluster.clock import SimClock
from ..cluster.durability import DurableLog
from ..cluster.store import ObjectStore

#: FederationClusterState records live in this namespace (routes keep
#: the routed workload's own namespace so the (ns, name) key matches).
FEDERATION_NAMESPACE = "grove-federation"


@dataclasses.dataclass
class FederationRoute:
    """Where one gang lives: journaled at admission and at every drain
    re-placement, so the routing table is exactly a scan of this kind."""

    metadata: ObjectMeta = dataclasses.field(default_factory=ObjectMeta)
    cluster: str = ""
    verdict: str = "Routed"
    detail: str = ""

    KIND = "FederationRoute"


@dataclasses.dataclass
class FederationClusterState:
    """One member cluster's lifecycle state + fencing term."""

    metadata: ObjectMeta = dataclasses.field(default_factory=ObjectMeta)
    state: str = "ready"
    term: int = 0

    KIND = "FederationClusterState"


class FederationJournal:
    """A durable micro-store for coordinator state. Fresh directories
    start a new history; populated ones are recovered and resumed (the
    Cluster.from_durable boot shape, minus everything cluster-specific).
    All writes ride `ObjectStore.create`/`delete`, so every record is
    WAL-committed before the coordinator acts on it being durable."""

    def __init__(self, wal_dir: str, template: DurabilityConfig,
                 clock: SimClock | None = None, metrics=None):
        """template: the operator's DurabilityConfig — fsync and
        snapshot cadence are inherited; wal_dir/partitioning are the
        journal's own (routing state is tiny; one partition always)."""
        cfg = dataclasses.replace(
            template, wal_dir=wal_dir, partitions=1, partition_map={}
        )
        self.wal_dir = wal_dir
        self.config = cfg
        fresh = not os.path.isdir(wal_dir) or not os.listdir(wal_dir)
        if fresh:
            self.store = ObjectStore(clock or SimClock())
            self.log = DurableLog(
                cfg, clock=self.store.clock, metrics=metrics
            )
            self.store.attach_durability(self.log)
        else:
            self.store = ObjectStore.recover(wal_dir, clock=clock)
            self.log = DurableLog(
                cfg, clock=self.store.clock, metrics=metrics, resume=True
            )
            self.store.attach_durability(self.log)
            self.log.term = self.store.recovery_stats.get("term", 0)
            self.log.checkpoint(self.store)

    # -- writes --------------------------------------------------------------
    def _upsert(self, obj) -> None:
        key = (obj.KIND, obj.metadata.namespace, obj.metadata.name)
        if self.store.peek(*key) is not None:
            self.store.delete(*key)
        self.store.create(obj)

    def record_route(self, namespace: str, name: str, cluster: str,
                     verdict: str = "Routed", detail: str = "") -> None:
        self._upsert(FederationRoute(
            metadata=ObjectMeta(name=name, namespace=namespace),
            cluster=cluster, verdict=verdict, detail=detail,
        ))

    def record_cluster(self, name: str, state: str, term: int = 0) -> None:
        self._upsert(FederationClusterState(
            metadata=ObjectMeta(name=name, namespace=FEDERATION_NAMESPACE),
            state=state, term=term,
        ))

    # -- reads ---------------------------------------------------------------
    def routes(self) -> dict[tuple[str, str], FederationRoute]:
        return {
            (r.metadata.namespace, r.metadata.name): r
            for r in self.store.scan(FederationRoute.KIND)
        }

    def cluster_states(self) -> dict[str, FederationClusterState]:
        return {
            c.metadata.name: c
            for c in self.store.scan(FederationClusterState.KIND)
        }

    # -- lifecycle -----------------------------------------------------------
    def crash_recover(self) -> dict[str, Any]:
        """Coordinator process-crash model: drop the in-memory image and
        rebuild it from disk (`recover_in_place` — same wiring-preserving
        recovery the cluster store uses for the process_crash fault).
        The caller then re-derives its routing structures by scanning."""
        return self.store.recover_in_place(self.wal_dir)

    def close(self) -> None:
        self.log.close()
