"""Federation: multi-cluster scheduling with whole-cluster failover.

A third level above the hierarchical solve's two: the topology
tree tops out at *region*, so everything above it is a FEDERATION of
self-contained durable cells — each member cluster runs its own full
control plane (`controller.Harness`: store, partitioned WAL, optional
standby, scheduler, kubelet), and this coordinator owns only what is
genuinely global:

  ROUTING    Each arriving PodCliqueSet is routed to one member using
             the hierarchical pruner's own over-admitting coarse cut
             predicates lifted one level (solver/hierarchy.
             cluster_level_aggregates: clusters as super-domains,
             observability/explain.classify_domain_cuts as the shared
             cut expression, plus the max-node-free fit bound). Routing
             may only OVER-admit — a cluster whose own control plane
             would place the gang is never cut; an in-cluster miss
             surfaces through that cluster's explain funnel as usual.
             Unroutable gangs get a structured
             UnsatCode.NO_FEASIBLE_CLUSTER diagnosis and are retried
             against refreshed aggregates every round.

  HEALTH     Members heartbeat into the coordinator each round; the
             ClusterHealthMonitor (federation/health.py — the
             nodemonitor newest-peer discipline lifted to clusters)
             declares a member dead when its beat lags the newest PEER
             beat by more than the outage window.

  FAILOVER   A dead cluster is FENCED first (replication.fence_deposed:
             the shared link term rises above its log term, so a zombie
             control plane returning from a partition fails FencedAppend
             before a byte moves — it can never double-place a gang the
             survivors adopted, and its directory stays byte-unchanged).
             The committed gang set is then read OUT of the fenced
             directory (durability.read_only_state — a pure read) and
             drained into survivors through the existing adoption/
             rebind path (Harness.adopt_workloads), paced by
             drain_max_gangs_per_round and bounded by the per-tenant
             DisruptionLedger budgets preemption and defrag share
             (consumer "federation-drain"; a cluster failover cannot
             launder a tenant's disruption budget). The whole drain must
             complete within drain_window_seconds of declaration — a
             DECLARED bound, enforced loudly.

  DURABILITY The coordinator's own routing table and fencing decisions
             are journaled through federation/journal.py (an
             ObjectStore + DurableLog of its own), so a coordinator
             crash recovers its global state from disk
             (`crash_recover`) exactly like a member recovers its
             objects.

See docs/operations.md "Federation & cluster failover (runbook)".

The counterpart of grove_tpu/federation/coordinator.py. The coordinator
takes the port's `device` and builds every member's Harness with it, so
each member's engines solve on the CUDA card unless the caller asks for
the CPU; a member declared dead has its engines released once it is
fenced (it never settles again).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import numpy as np

from ..api.config import OperatorConfig, load_operator_config
from ..api.types import PodCliqueSet
from ..cluster.clock import SimClock
from ..cluster.durability import read_only_state
from ..cluster.replication import ReplicationLink, fence_deposed
from ..controller.harness import Harness
from ..observability.explain import (
    UnsatCode,
    UnsatDiagnosis,
    classify_domain_cuts,
)
from ..observability.metrics import MetricsRegistry
from ..observability.tracing import accepts_kwarg
from ..solver.hierarchy import cluster_level_aggregates
from .health import ClusterHealthMonitor
from .journal import FederationJournal

_EPS = 1e-6

#: the per-cluster gauge families this module owns; labeled by cluster
#: (free also by resource) and reconciled via Gauge.label_sets/remove
#: so a failed/removed cluster's series leave /metrics (the shard,
#: partition and standby series-hygiene pattern).
FEDERATION_GAUGES = (
    "grove_federation_cluster_state",
    "grove_federation_cluster_gangs",
    "grove_federation_cluster_free",
)

_STATE_VALUES = {"ready": 0.0, "failed": 1.0, "draining": 2.0,
                 "drained": 3.0}


class ClusterCell:
    """One member cluster: its full control plane plus the coordinator's
    per-member bookkeeping (lifecycle state, heartbeat, fence term,
    drain progress). `harness.federation` points back here so a cell's
    `debug_dump()` carries the federation block."""

    def __init__(self, name: str, harness: Harness, wal_dir: str,
                 coordinator: "FederationCoordinator"):
        self.name = name
        self.harness = harness
        self.wal_dir = wal_dir
        self.coordinator = coordinator
        self.state = "ready"
        self.last_heartbeat = coordinator.clock.now()
        #: chaos: True suppresses heartbeat renewal (the cluster is
        #: unreachable — crashed, or on the wrong side of a partition)
        self.partitioned = False
        self.fence_term: Optional[int] = None
        self.declared_at: Optional[float] = None
        self.deadline: Optional[float] = None
        self.drained_at: Optional[float] = None
        self.drain_queue: list[PodCliqueSet] = []
        self.drain_total = 0
        #: (ns, name) -> destination cell name, for gangs this cell's
        #: drain re-homed (re-verified each tick: a survivor's standby
        #: promotion mid-drain may rewind its store past an adoption)
        self.drained_keys: dict[tuple[str, str], str] = {}
        #: (ns, name) -> the recovered PodCliqueSet (re-adoption source)
        self.drain_objs: dict[tuple[str, str], PodCliqueSet] = {}
        self.outage_stats: Optional[dict] = None

    @property
    def cluster(self):
        return self.harness.cluster

    @property
    def clock(self):
        return self.harness.clock

    def debug_state(self) -> dict[str, Any]:
        """The harness debug_dump()['federation'] block: this cell's
        identity + lifecycle, and every wedged gang's home cluster and
        routing verdict."""
        out: dict[str, Any] = {
            "cluster": self.name,
            "state": self.state,
            "fence_term": self.fence_term,
            "wedged": self.coordinator.wedged_for_cell(self),
        }
        if self.fence_term is not None:
            out["drain"] = {
                "queued": len(self.drain_queue),
                "total": self.drain_total,
                "declared_at": self.declared_at,
                "deadline": self.deadline,
                "drained_at": self.drained_at,
            }
        return out


class FederationCoordinator:
    """The global control plane over `config.federation.clusters`
    member cells. Drive it like a Harness: `apply()` routes + delegates,
    `settle()`/`advance()` run every live member and then the global
    round (heartbeats, health check, drain pacing, unroutable retries,
    metric export)."""

    def __init__(self, config: OperatorConfig | dict,
                 nodes: list[list], engine_cls=None, audit: bool = False,
                 device=None):
        """nodes: one node list PER member cluster (distinct Node
        objects per list — each member's store adopts its own). audit:
        arm the disruption-budget audit after every drain round (the
        defrag _audit_budgets shape: overspend raises loudly). device:
        where every member's engines solve (None = the CUDA card, "cpu"
        the kernels' plain versions)."""
        if isinstance(config, dict):
            config = load_operator_config(config)
        fe = config.federation
        if not fe.enabled:
            raise ValueError(
                "FederationCoordinator requires config.federation.enabled"
            )
        if len(nodes) != fe.clusters:
            raise ValueError(
                f"federation declares {fe.clusters} clusters but "
                f"{len(nodes)} node lists were given"
            )
        self.config = config
        self.audit = audit
        self.device = device
        self.clock = SimClock()
        self.metrics = MetricsRegistry()
        cluster_dirs, coordinator_dir = self._derive_dirs(config)
        self.journal = FederationJournal(
            coordinator_dir, config.durability, clock=self.clock,
            metrics=self.metrics,
        )
        self.monitor = ClusterHealthMonitor(
            fe.outage_detection_window_seconds
        )
        self.cells: list[ClusterCell] = []
        for i, cell_nodes in enumerate(nodes):
            name = f"c{i}"
            cell_cfg = self._cell_config(config, cluster_dirs[i], i)
            kwargs: dict[str, Any] = {}
            if engine_cls is not None:
                kwargs["engine_cls"] = engine_cls
            # accepts_kwarg gating (the scheduler's optional-capability
            # pattern): a Harness subclass with a strict signature keeps
            # working, just without the cell identity stamped on it
            if accepts_kwarg(Harness, "cell_name"):
                kwargs["cell_name"] = name
            harness = Harness(nodes=cell_nodes, config=cell_cfg,
                              device=device, **kwargs)
            cell = ClusterCell(name, harness, cluster_dirs[i], self)
            self._install_fence_link(cell)
            harness.federation = cell
            self.cells.append(cell)
            self.journal.record_cluster(
                name, "ready", cell.cluster.durability.term
            )
        self.by_name = {c.name: c for c in self.cells}
        #: (ns, name) -> home cell name, for every routed gang
        self._routes: dict[tuple[str, str], str] = {}
        #: (ns, name) -> (pcs, diagnosis): cut by every cluster, retried
        #: against refreshed aggregates each round
        self._unroutable: dict[tuple[str, str], tuple] = {}
        self._agg: Optional[dict] = None
        self._export_metrics()

    # -- construction --------------------------------------------------------
    @staticmethod
    def _derive_dirs(config: OperatorConfig) -> tuple[list[str], str]:
        fe = config.federation
        root = config.durability.wal_dir
        if fe.cluster_wal_dirs:
            dirs = list(fe.cluster_wal_dirs)
        else:
            dirs = [
                os.path.join(root, f"cluster-{i:02d}")
                for i in range(fe.clusters)
            ]
        coord = fe.coordinator_wal_dir or os.path.join(root, "coordinator")
        return dirs, coord

    @staticmethod
    def _cell_config(config: OperatorConfig, wal_dir: str,
                     index: int) -> OperatorConfig:
        """One member's OperatorConfig: the template with durability
        re-pointed at the member's own directory, the standby (when
        replication is enabled) at a sibling directory, and federation
        disabled — a cell is a plain single-cluster control plane."""
        du = dataclasses.replace(config.durability, wal_dir=wal_dir)
        rp = config.replication
        if rp.enabled:
            rp = dataclasses.replace(
                rp, standby_wal_dir=wal_dir.rstrip("/") + "-standby"
            )
        fe = dataclasses.replace(config.federation, enabled=False)
        return dataclasses.replace(
            config, durability=du, replication=rp, federation=fe
        )

    @staticmethod
    def _install_fence_link(cell: ClusterCell) -> None:
        """Every member must be fence-able whether or not it runs its
        own standby: when replication is off the cluster has no
        ReplicationLink, so the coordinator installs one on its durable
        log (DurableLog.check_fence consults it per append)."""
        cluster = cell.cluster
        if cluster.durability is None:
            raise ValueError(
                "federation members must be durable "
                "(config.durability.wal_dir)"
            )
        if cluster.replication_link is None:
            link = ReplicationLink(term=cluster.durability.term)
            cluster.replication_link = link
            cluster.durability.link = link

    # -- routing -------------------------------------------------------------
    def _ready_cells(self) -> list[ClusterCell]:
        return [c for c in self.cells if c.state == "ready"]

    def _refresh_aggregates(self) -> None:
        cells = self._ready_cells()
        snaps = [c.cluster.topology_snapshot() for c in cells]
        sched_cnt, free, max_free, axis = cluster_level_aggregates(snaps)
        self._agg = {
            "names": [c.name for c in cells],
            "sched_cnt": sched_cnt,
            #: residual: decremented per routed gang between refreshes
            #: (coarse_assign's residual-tracking shape) so a burst of
            #: arrivals spreads instead of dogpiling the loosest member
            "resid": free,
            "max_free": max_free,
            "axis": axis,
        }

    @staticmethod
    def _demand_of(pcs: PodCliqueSet,
                   axis: list[str]) -> tuple[np.ndarray, np.ndarray]:
        """(total demand, max single-pod demand) on the federation
        resource axis. Scaling-group multiplication is deliberately NOT
        applied — under-counting total demand can only OVER-admit,
        which the routing contract allows; the member's own exact solve
        is the authority."""
        td = np.zeros(len(axis), dtype=np.float64)
        sig = np.zeros(len(axis), dtype=np.float64)
        col = {r: i for i, r in enumerate(axis)}
        for ct in pcs.spec.template.cliques:
            vec = np.zeros(len(axis), dtype=np.float64)
            for res, amount in ct.spec.pod_spec.total_requests().items():
                i = col.get(res)
                if i is not None:
                    vec[i] += float(amount)
            td += vec * max(1, int(ct.spec.replicas))
            sig = np.maximum(sig, vec)
        td *= max(1, int(pcs.spec.replicas))
        return td, sig

    def _route(self, pcs: PodCliqueSet) -> tuple[
        Optional[ClusterCell], Optional[UnsatDiagnosis]
    ]:
        """One routing decision: the shared cut predicates over the
        per-cluster aggregates, then LEAST-LOADED among survivors with
        residual tracking. Spread — not the solver's bin-packing
        best-fit — is deliberate at this level: members solve in
        parallel, so spreading arrivals is what buys near-linear
        federation throughput, and it keeps per-member headroom for
        absorbing a peer's drain. A miss against stale residuals
        retries once against fresh aggregates before the
        NoFeasibleCluster verdict — the over-admit contract is against
        CURRENT capacity, not against what earlier routings this round
        already spent."""
        for attempt in (0, 1):
            if self._agg is None:
                self._refresh_aggregates()
            agg = self._agg
            names = agg["names"]
            if names:
                td, sig = self._demand_of(pcs, agg["axis"])
                cordoned, agg_cut, remaining = classify_domain_cuts(
                    td, agg["resid"], agg["sched_cnt"]
                )
                fit_ok = (agg["max_free"] + _EPS >= sig).all(axis=-1)
                admissible = remaining & fit_ok
                if admissible.any():
                    resid = agg["resid"]
                    scale = np.maximum(resid.max(axis=0), _EPS)
                    slack = ((resid - td) / scale).sum(axis=1)
                    slack[~admissible] = -np.inf
                    i = int(np.argmax(slack))
                    resid[i] = np.maximum(resid[i] - td, 0.0)
                    return self.by_name[names[i]], None
            if attempt == 0:
                self._agg = None  # retry against fresh aggregates
        funnel = {
            "level": "federation",
            "clusters": len(names),
            "cut_cordoned": int(cordoned.sum()) if names else 0,
            "cut_capacity": int(agg_cut.sum()) if names else 0,
            "cut_fit": int((remaining & ~fit_ok).sum()) if names else 0,
        }
        diag = UnsatDiagnosis(
            f"no feasible cluster: all {len(names)} member clusters "
            f"eliminated (cordoned={funnel['cut_cordoned']}, "
            f"capacity={funnel['cut_capacity']}, "
            f"fit={funnel['cut_fit']})",
            code=UnsatCode.NO_FEASIBLE_CLUSTER,
            funnel=funnel,
        )
        return None, diag

    def apply(self, pcs: PodCliqueSet) -> Optional[str]:
        """Route + delegate one arriving PodCliqueSet. Returns the home
        cluster name, or None when every member was cut — the gang is
        held with its NO_FEASIBLE_CLUSTER diagnosis (journaled, on
        /metrics, in wedged_summary) and retried every round."""
        key = (pcs.metadata.namespace, pcs.metadata.name)
        cell, diag = self._route(pcs)
        if cell is None:
            self._unroutable[key] = (pcs, diag)
            self.journal.record_route(
                key[0], key[1], "", "NoFeasibleCluster", str(diag)
            )
            self.metrics.counter(
                "grove_federation_unroutable_total",
                "gangs every member cluster's coarse cuts eliminated",
            ).inc()
            return None
        self._trace_route(cell, pcs)
        cell.harness.apply(pcs)
        self._routes[key] = cell.name
        self._unroutable.pop(key, None)
        self.journal.record_route(key[0], key[1], cell.name, "Routed")
        return cell.name

    def _trace_route(self, cell, pcs) -> None:
        """Causal head of a routed workload's flow DAG
        (observability/causal.py): emit the PCS token into the MEMBER
        cluster's ledger before delegating, so the member's
        pcs.gang_create points link back to this routing decision and
        the merged trace renders the federation hop as a flow arrow."""
        tracer = getattr(cell.harness.cluster, "tracer", None)
        if tracer is None or not tracer.enabled:
            return
        ns, name = pcs.metadata.namespace, pcs.metadata.name
        causal = {}
        ledger = getattr(cell.harness.cluster.store, "causal", None)
        if ledger is not None:
            causal["causal_emit"] = ledger.emit(("pcs", ns, name))
        tracer.point(
            "federation.route", pcs=f"{ns}/{name}", cluster=cell.name,
            **causal,
        )

    def _retry_unroutable(self) -> None:
        for key in sorted(self._unroutable):
            pcs, _diag = self._unroutable[key]
            cell, diag = self._route(pcs)
            if cell is None:
                self._unroutable[key] = (pcs, diag)
                self.journal.record_route(
                    key[0], key[1], "", "NoFeasibleCluster", str(diag)
                )
                continue
            self._trace_route(cell, pcs)
            cell.harness.apply(pcs)
            self._routes[key] = cell.name
            del self._unroutable[key]
            self.journal.record_route(key[0], key[1], cell.name, "Routed")

    # -- the global round ----------------------------------------------------
    def settle(self) -> None:
        """Every live member to its fixpoint, then the global round."""
        for cell in self._ready_cells():
            cell.harness.settle()
            if not cell.partitioned:
                cell.last_heartbeat = self.clock.now()
        self._global_round()

    def advance(self, seconds: float) -> None:
        """Advance virtual time in lockstep (coordinator clock + every
        live member's), then the global round — including the health
        check, since only time passing can make a heartbeat stale."""
        self.clock.advance(seconds)
        for cell in self._ready_cells():
            cell.harness.advance(seconds)
            if not cell.partitioned:
                cell.last_heartbeat = self.clock.now()
        self.check_health()
        self._global_round()

    def _global_round(self) -> None:
        self._agg = None  # routing reads post-settle capacity
        self._retry_unroutable()
        self._drain_tick()
        self._export_metrics()

    # -- health + failover ---------------------------------------------------
    def fail_cluster(self, name: str) -> None:
        """Chaos entry: the named member becomes unreachable (crashed
        host, or the losing side of a partition) — its heartbeats stop;
        detection, fencing and draining follow the normal path."""
        self.by_name[name].partitioned = True

    def heal_cluster(self, name: str) -> None:
        """Chaos entry: the partition heals. If the member was already
        declared dead it stays fenced — a zombie's appends refuse with
        FencedAppend; only its heartbeat suppression is lifted."""
        self.by_name[name].partitioned = False

    def check_health(self) -> list[str]:
        """Declare an outage for every ready member whose heartbeat
        lags the newest peer beat past the window. Returns the names
        declared dead this check."""
        beats = {
            c.name: c.last_heartbeat for c in self.cells
            if c.state == "ready"
        }
        dead = self.monitor.dead(beats)
        for name in dead:
            self.declare_outage(name)
        return dead

    def declare_outage(self, name: str) -> dict:
        """Fence + begin draining one member. Idempotent."""
        cell = self.by_name[name]
        if cell.state != "ready":
            return cell.outage_stats or {}
        now = self.clock.now()
        fe = self.config.federation
        # 1. FENCE before reading anything: from this point the dead
        # cluster's control plane cannot extend its durable history, so
        # the committed set we read next is final.
        term = fence_deposed(
            cell.cluster.durability, cell.cluster.replication_link
        )
        cell.fence_term = term
        cell.partitioned = True
        # a fenced member never settles again: its engines' device state
        # goes now (a released scheduler builds a new engine if asked)
        cell.harness.release_engines()
        self.journal.record_cluster(name, "fenced", term)
        # 2. READ the committed gang set out of the fenced directory —
        # a pure read (not one byte written under the fenced dir).
        shadow, stats = read_only_state(cell.wal_dir)
        queue = sorted(
            shadow.scan(PodCliqueSet.KIND),
            key=lambda o: (o.metadata.namespace, o.metadata.name),
        )
        cell.drain_objs = {
            (p.metadata.namespace, p.metadata.name): p for p in queue
        }
        # skip sets already re-homed (journal replay after a coordinator
        # crash that interleaved with this outage)
        cell.drain_queue = [
            p for p in queue
            if self._routes.get(
                (p.metadata.namespace, p.metadata.name), name
            ) == name
        ]
        cell.drain_total = len(cell.drain_queue)
        cell.drained_keys = {}
        cell.state = "draining"
        cell.declared_at = now
        cell.deadline = now + fe.drain_window_seconds
        cell.outage_stats = {
            "declared_at": now,
            "fence_term": term,
            "committed_last_seq": stats["recovered_last_seq"],
            "recovery_outcome": stats["outcome"],
            "gangs": cell.drain_total,
        }
        self.metrics.counter(
            "grove_federation_outages_total",
            "whole-cluster outages declared by the health monitor",
        ).inc(cluster=name)
        self._agg = None
        self._drain_tick()
        return cell.outage_stats

    def _drain_tick(self) -> None:
        """One paced drain round per draining member: re-verify earlier
        re-placements, then move at most drain_max_gangs_per_round gangs
        into survivors under the shared disruption-budget discipline."""
        fe = self.config.federation
        for cell in self.cells:
            if cell.state != "draining":
                continue
            # a survivor's standby promotion mid-drain may have rewound
            # its store past an adoption (async lag): any vanished gang
            # goes back on the queue instead of stranding
            for key, dest_name in sorted(cell.drained_keys.items()):
                dest = self.by_name[dest_name]
                if dest.state == "ready" and dest.cluster.store.peek(
                    PodCliqueSet.KIND, key[0], key[1]
                ) is None:
                    del cell.drained_keys[key]
                    cell.drain_queue.append(cell.drain_objs[key])
            moved, deferred, touched = 0, [], set()
            while cell.drain_queue and moved < fe.drain_max_gangs_per_round:
                pcs = cell.drain_queue.pop(0)
                key = (pcs.metadata.namespace, pcs.metadata.name)
                # idempotence under crash/replay: already committed on a
                # live member -> repair the route, never double-place
                existing = next(
                    (c for c in self._ready_cells()
                     if c.cluster.store.peek(
                         PodCliqueSet.KIND, key[0], key[1]) is not None),
                    None,
                )
                if existing is not None:
                    self._note_drained(cell, key, existing)
                    continue
                dest, diag = self._route(pcs)
                if dest is None:
                    self.journal.record_route(
                        key[0], key[1], "", "NoFeasibleCluster", str(diag)
                    )
                    deferred.append(pcs)
                    continue
                tenancy = dest.cluster.tenancy
                tenant = (
                    tenancy.tenant_of(key[0], pcs.metadata.labels)
                    if tenancy.enabled else None
                )
                remaining = dest.harness.scheduler.drain_budget_remaining(
                    tenant
                )
                if remaining is not None and remaining <= 0:
                    deferred.append(pcs)  # window must roll first
                    continue
                dest.harness.adopt_workloads([pcs], source=cell.name)
                if tenant is not None:
                    tenancy.ledger.charge(
                        tenant, "federation-drain", dest.clock.now()
                    )
                self._note_drained(cell, key, dest)
                touched.add(dest.name)
                moved += 1
                self.metrics.counter(
                    "grove_federation_drained_gangs_total",
                    "gangs re-placed off failed clusters into survivors",
                ).inc(cluster=cell.name)
            cell.drain_queue = deferred + cell.drain_queue
            for name in sorted(touched):
                self.by_name[name].harness.settle()
            if touched:
                self._agg = None
            if not cell.drain_queue:
                cell.state = "drained"
                cell.drained_at = self.clock.now()
                self.journal.record_cluster(
                    cell.name, "drained", cell.fence_term or 0
                )
            elif self.clock.now() > (cell.deadline or 0.0):
                raise RuntimeError(
                    f"federation drain of cluster {cell.name!r} exceeded "
                    f"drain_window_seconds="
                    f"{fe.drain_window_seconds}: "
                    f"{len(cell.drain_queue)}/{cell.drain_total} gangs "
                    "still queued (budget-deferred gangs wait for the "
                    "DisruptionLedger window to roll — widen the drain "
                    "window or the tenants' budgets)"
                )
            if self.audit:
                self._audit_budgets()

    def _note_drained(self, cell: ClusterCell, key: tuple[str, str],
                      dest: ClusterCell) -> None:
        cell.drained_keys[key] = dest.name
        self._routes[key] = dest.name
        self.journal.record_route(
            key[0], key[1], dest.name, "Routed",
            f"drained from {cell.name}",
        )

    def _audit_budgets(self) -> None:
        """Armed audit (the defrag _audit_budgets shape): after a drain
        round, no tenant's window spend may exceed its budget across
        EVERY consumer — preemption, defrag AND federation-drain share
        one ledger per member. A violation is a ledger-sharing bug;
        raise loudly."""
        for cell in self._ready_cells():
            tenancy = cell.cluster.tenancy
            if not tenancy.enabled:
                continue
            now = cell.clock.now()
            for tenant in sorted(tenancy.queues):
                budget = tenancy.disruption_budget(tenant)
                if budget is None:
                    continue
                spent = tenancy.ledger.spent(tenant, now)
                if spent > budget:
                    raise RuntimeError(
                        f"disruption-budget audit: tenant {tenant!r} "
                        f"spent {spent} on cluster {cell.name!r} (by "
                        f"consumer: "
                        f"{tenancy.ledger.breakdown(tenant, now)}) over "
                        f"budget {budget} in one window"
                    )

    # -- coordinator crash ---------------------------------------------------
    def crash_recover(self) -> dict:
        """The coordinator_crash fault: drop EVERY in-memory routing
        structure and rebuild from the durable journal alone — routes
        from FederationRoute records, member lifecycle (including a
        mid-drain fence) from FederationClusterState records, and a
        fenced-but-undrained member's remaining queue re-derived from
        its directory minus the routes already journaled elsewhere."""
        stats = self.journal.crash_recover()
        self._routes = {}
        self._unroutable = {}
        self._agg = None
        routes = self.journal.routes()
        for key, rec in routes.items():
            if rec.verdict == "Routed" and rec.cluster:
                self._routes[key] = rec.cluster
        fe = self.config.federation
        for cell in self.cells:
            rec = self.journal.cluster_states().get(cell.name)
            if rec is None or rec.state == "ready":
                continue
            cell.fence_term = rec.term
            cell.partitioned = True
            if rec.state == "drained":
                cell.state = "drained"
                continue
            # fenced mid-drain: resume from evidence
            cell.state = "draining"
            if cell.declared_at is None:
                cell.declared_at = self.clock.now()
            cell.deadline = cell.declared_at + fe.drain_window_seconds
            shadow, _ = read_only_state(cell.wal_dir)
            queue = sorted(
                shadow.scan(PodCliqueSet.KIND),
                key=lambda o: (o.metadata.namespace, o.metadata.name),
            )
            cell.drain_objs = {
                (p.metadata.namespace, p.metadata.name): p for p in queue
            }
            cell.drained_keys = {}
            cell.drain_queue = []
            for pcs in queue:
                key = (pcs.metadata.namespace, pcs.metadata.name)
                routed = routes.get(key)
                if (routed is not None and routed.cluster
                        and routed.cluster != cell.name):
                    cell.drained_keys[key] = routed.cluster
                else:
                    cell.drain_queue.append(pcs)
            cell.drain_total = len(cell.drain_objs)
        return stats

    # -- observability -------------------------------------------------------
    def wedged_for_cell(self, cell: ClusterCell) -> list[dict]:
        """Wedged gangs homed on one member: PodGangs that never
        reached Scheduled, each named with its home cluster and routing
        verdict (the federation half of the wedged postmortem; the
        member's own wedged_summary/explain names the in-cluster why)."""
        from ..api.meta import get_condition
        from ..api.podgang import PodGang, PodGangConditionType

        if cell.state not in ("ready",):
            return []
        out = []
        for g in cell.cluster.store.scan(PodGang.KIND):
            cond = get_condition(
                g.status.conditions, PodGangConditionType.SCHEDULED.value
            )
            if cond is not None and cond.status == "True":
                continue
            anns = g.metadata.annotations or {}
            out.append({
                "name": f"{g.metadata.namespace}/{g.metadata.name}",
                "home_cluster": cell.name,
                "routing_verdict": "Routed",
                "drained_from": anns.get("grove.io/drained-from"),
                "phase": g.status.phase.value,
            })
        return out

    def wedged_summary(self) -> dict[str, Any]:
        """The federation block of the chaos postmortem: per-member
        lifecycle + every wedged gang's home cluster and routing
        verdict, including gangs no cluster would admit at all."""
        wedged: list[dict] = []
        for cell in self.cells:
            wedged.extend(self.wedged_for_cell(cell))
        for key in sorted(self._unroutable):
            _pcs, diag = self._unroutable[key]
            wedged.append({
                "name": f"{key[0]}/{key[1]}",
                "home_cluster": None,
                "routing_verdict": UnsatCode.NO_FEASIBLE_CLUSTER.value,
                "explain": diag.to_dict() if diag is not None else None,
            })
        return {
            "clusters": {c.name: c.state for c in self.cells},
            "routes": len(self._routes),
            "unroutable": len(self._unroutable),
            "wedged": wedged,
        }

    def _export_metrics(self) -> None:
        """Per-cluster gauges + series hygiene: free series exist only
        for ready members (a fenced cluster's capacity is not capacity),
        state/gangs series persist through the drain and leave /metrics
        once the member is drained/removed."""
        g_state = self.metrics.gauge(
            "grove_federation_cluster_state",
            "member cluster lifecycle "
            "(0=ready 1=failed 2=draining 3=drained)",
        )
        g_gangs = self.metrics.gauge(
            "grove_federation_cluster_gangs",
            "gangs currently routed to each member cluster",
        )
        g_free = self.metrics.gauge(
            "grove_federation_cluster_free",
            "aggregate schedulable free capacity per member cluster "
            "and resource",
        )
        counts: dict[str, int] = {}
        for home in self._routes.values():
            counts[home] = counts.get(home, 0) + 1
        present = {c.name for c in self.cells if c.state != "drained"}
        ready = set()
        for cell in self.cells:
            if cell.state == "drained":
                continue
            g_state.set(_STATE_VALUES[cell.state], cluster=cell.name)
            g_gangs.set(float(counts.get(cell.name, 0)), cluster=cell.name)
            if cell.state != "ready":
                continue
            ready.add(cell.name)
            snap = cell.cluster.topology_snapshot()
            fm = np.where(snap.schedulable[:, None], snap.free, 0.0)
            total = fm.sum(axis=0)
            for i, res in enumerate(snap.resource_names):
                g_free.set(float(total[i]), cluster=cell.name, resource=res)
        for family, keep in (
            ("grove_federation_cluster_state", present),
            ("grove_federation_cluster_gangs", present),
            ("grove_federation_cluster_free", ready),
        ):
            metric = self.metrics.get(family)
            if metric is None:
                continue
            for labels in metric.label_sets():
                if labels.get("cluster") not in keep:
                    metric.remove(**labels)

    def debug_state(self) -> dict[str, Any]:
        return {
            "clusters": {
                c.name: {
                    "state": c.state,
                    "fence_term": c.fence_term,
                    "last_heartbeat": c.last_heartbeat,
                    "gangs": sum(
                        1 for home in self._routes.values()
                        if home == c.name
                    ),
                }
                for c in self.cells
            },
            "routes": len(self._routes),
            "unroutable": sorted(
                f"{k[0]}/{k[1]}" for k in self._unroutable
            ),
            "journal": {
                "wal_dir": self.journal.wal_dir,
                "last_seq": self.journal.store.last_seq,
            },
        }

    def close(self) -> None:
        self.journal.close()
