"""Cluster facade: store + clock + nodes + kubelet + topology snapshots.

The one-stop test/user entry point: register admission for the Grove kinds,
load node inventory, apply workloads, and produce solver-ready
TopologySnapshots with live usage accounting (what the scheduler loop feeds
the placement engine).

The counterpart of grove_tpu/cluster/cluster.py, with the SLO engine
(`config.slo`) and HA replication (`config.replication`: the standby,
`promote_standby`, `rebuild_standby`). Nothing here touches the card: the
engines that solve there belong to the harness's managers.
"""

from __future__ import annotations

import numpy as np

from ..api import (
    default_podcliqueset,
    default_podgang,
    validate_cluster_topology,
    validate_hpa,
    validate_podcliqueset,
    validate_podcliqueset_update,
    validate_podgang,
)
from ..api.auxiliary import HorizontalPodAutoscaler, PriorityClass
from ..api.config import OperatorConfig
from ..api.meta import ObjectMeta
from ..api.podgang import PodGang
from ..api.types import ClusterTopology, Node, Pod, PodPhase, TopologyLevel
from ..observability import Logger, MetricsRegistry
from ..observability.explain import DecisionLog
from ..observability.tracing import NOOP_TRACER
from ..topology.encoding import TopologySnapshot, default_cluster_topology, encode_topology
from .clock import SimClock
from .kubelet import SimKubelet
from .store import Admission, ObjectStore


class Cluster:
    @classmethod
    def from_durable(cls, config: OperatorConfig) -> "Cluster":
        """Boot a GENUINELY NEW process from the durable state on disk
        (the crashed predecessor's Python objects are gone — unlike
        cold_restart, which recovers in place): recover the store from
        `config.durability.wal_dir`, adopt the journal in resume mode,
        and skip the bootstrap creates (topology, priority classes,
        nodes) — they are IN the recovered history. The usual entry
        point is Harness.recover(config), which also expires the dead
        process's coordination leases."""
        if not config.durability.wal_dir:
            raise ValueError(
                "Cluster.from_durable requires config.durability.wal_dir"
            )
        store = ObjectStore.recover(config.durability.wal_dir)
        return cls(config=config, recovered_store=store)

    def __init__(self, nodes: list[Node] | None = None,
                 topology: ClusterTopology | None = None,
                 config: OperatorConfig | None = None,
                 recovered_store: ObjectStore | None = None):
        if recovered_store is not None and (nodes or topology):
            raise ValueError(
                "a recovered store already carries its nodes and "
                "topology; pass neither (see Cluster.from_durable)"
            )
        self.config = config or OperatorConfig()
        self.clock = (
            recovered_store.clock if recovered_store is not None
            else SimClock()
        )
        # One registry per cluster: scheduler + engine feed it, bench.py and
        # the /metrics text exposition read it (SURVEY §5: the reference has
        # no custom scheduler metrics; the north-star numbers live here).
        # Built before the store so the durability layer can count into it.
        self.metrics = MetricsRegistry()
        self.store = recovered_store or ObjectStore(self.clock)
        # Durable state store (cluster/durability.py): attach the WAL
        # BEFORE the first write so the journal covers the whole history —
        # the bootstrap objects below (topology, priority classes, nodes)
        # replay on recovery like everything else. A recovered store
        # RESUMES the populated dir instead (no wipe, no refuse), and the
        # boot checkpoint seals the pre-crash tail behind a fresh
        # generation before any append.
        self.durability = None
        if self.config.durability.wal_dir:
            from .durability import DurableLog, PartitionedLog

            # partitions > 1: the write path splits by (namespace, kind)
            # into K independent WAL/snapshot chains behind the same
            # facade (cluster/durability.PartitionedLog)
            log_cls = (
                PartitionedLog
                if self.config.durability.partitions > 1
                else DurableLog
            )
            self.durability = log_cls(
                self.config.durability, clock=self.clock,
                metrics=self.metrics,
                resume=recovered_store is not None,
            )
            self.store.attach_durability(self.durability)
            if recovered_store is not None:
                # the recovered history's leadership term resumes with
                # the journal (promotion fencing, cluster/replication.py)
                self.durability.term = self.store.recovery_stats.get(
                    "term", 0
                )
                self.durability.checkpoint(self.store)
                self.metrics.counter(
                    "grove_store_recoveries_total",
                    "store recoveries from durable state by outcome",
                ).inc(outcome=self.store.recovery_stats["outcome"])
        self.kubelet = SimKubelet(self.store)
        # The serving metrics pipeline (serving/): the aggregator
        # is cluster-owned like the DecisionLog — samples are
        # infrastructure truth reported by the node agents, so they
        # survive manager crash-restarts and the rebuilt autoscaler
        # resumes from the same window. Built unconditionally (cheap,
        # and Autoscaler.observe() feeds it even without a traffic
        # engine); the TrafficEngine itself only exists when
        # config.serving.enabled, and wires the kubelet's per-tick
        # reporting hook.
        from ..serving import PodMetrics

        self.pod_metrics = PodMetrics(
            self.config.autoscaler.metrics_max_age_seconds
        )
        self.serving = None
        if self.config.serving.enabled:
            from ..serving import TrafficEngine

            self.serving = TrafficEngine(
                self.config.serving, self.pod_metrics, metrics=self.metrics
            )
            self.kubelet.reporter = self.serving
        # Placement-decision audit ring (observability/explain.py):
        # cluster-owned — like the metrics registry — so explanations
        # survive scheduler engine rebuilds and manager crash-restarts.
        # The scheduler injects it into every engine it builds; bounded,
        # so always on.
        self.decisions = DecisionLog()
        # Multi-tenant arbitration (tenancy/): cluster-owned for
        # the same reason — tenant accounting and quota state survive
        # scheduler rebuilds. Built unconditionally (cheap); a disabled
        # config makes every hook a no-op.
        from ..tenancy import TenancyManager

        self.tenancy = TenancyManager(self.config.tenancy, metrics=self.metrics)
        # Continuous SLO evaluation (observability/slo.py): cluster-owned
        # soft state like the DecisionLog — sample rings, alert states
        # and history survive manager rebuilds, cold_restart() and
        # promote_standby(); a genuinely new process re-warms from its
        # first sweep. Gated on config (an absent engine means
        # Harness.maybe_slo_sweep and the chaos hook are no-ops, which
        # is also what keeps pre-existing chaos seeds bit-identical).
        self.slo = None
        if self.config.slo.enabled:
            from ..observability.slo import SLOEngine

            self.slo = SLOEngine(
                self.config.slo, metrics=self.metrics, clock=self.clock
            )
        self.logger = Logger(
            level=self.config.log.level, format=self.config.log.format
        )
        # Span tracer + chaos flight recorder (observability/tracing.py):
        # off by default — the no-op singleton keeps every instrumented
        # hot path at ~zero cost until config.tracing.enabled (or
        # enable_tracing()) turns it on.
        self.tracer = NOOP_TRACER
        self.flight = None
        if self.config.tracing.enabled:
            self.enable_tracing()
        defaults = self.config.workload_defaults
        self.store.register_admission(
            "PodCliqueSet",
            Admission(
                default=lambda pcs: default_podcliqueset(pcs, defaults),
                validate=validate_podcliqueset,
                validate_update=validate_podcliqueset_update,
            ),
        )
        self.store.register_admission(
            "ClusterTopology", Admission(validate=validate_cluster_topology)
        )
        # HPA admission is unconditional (no tenancy gate): a min>max HPA
        # used to be accepted and clamp nonsensically in the controller
        self.store.register_admission(
            HorizontalPodAutoscaler.KIND, Admission(validate=validate_hpa)
        )
        if self.tenancy.enabled:
            # PodGang admission under tenancy: an empty priority class
            # defaults to the gang's tenant tier, and a set one must name
            # a configured tier or a known PriorityClass — before this,
            # any string silently round-tripped and resolved to priority
            # 0 at solve time. The allowed set is computed at admission
            # time so user-created PriorityClasses count.
            self.store.register_admission(
                PodGang.KIND,
                Admission(
                    default=lambda pg: default_podgang(
                        pg,
                        tier_of=self.tenancy.tier_of_gang,
                        default_tier=self.config.tenancy.default_tier,
                    ),
                    validate=lambda pg: validate_podgang(
                        pg, allowed_priorities=self._allowed_priorities()
                    ),
                ),
            )
        if self.config.authorization.enabled:
            from ..api.authorization import make_authorizer

            self.store.authorizer = make_authorizer(
                self.config.authorization, store=self.store
            )
        if recovered_store is not None:
            # every bootstrap object is IN the recovered history — adopt
            # the stored singleton instead of re-creating (AlreadyExists)
            from .store import clone

            stored = self.store.scan(ClusterTopology.KIND)
            self.topology = (
                clone(stored[0]) if stored
                else default_cluster_topology([])
            )
            self._init_caches()
            self._init_replication()
            return
        # Topology sync at startup (clustertopology.go:41): ensure the
        # singleton ClusterTopology exists before any controller runs.
        # Precedence: explicit topology arg > config levels > inventory
        # label inference.
        cfg_levels = [
            TopologyLevel(domain=lv["domain"], key=lv["key"])
            for lv in self.config.topology_aware_scheduling.levels
        ]
        self.topology = topology or default_cluster_topology(
            cfg_levels
            if cfg_levels
            else ([] if nodes is None else _infer_levels(nodes))
        )
        self.store.create(self.topology)
        # Built-in PriorityClasses (k8s seeds the system-* pair the same
        # way); user-defined classes are created like any other object.
        for pc_name, value in (
            ("system-cluster-critical", 2_000_000_000.0),
            ("system-node-critical", 2_000_001_000.0),
        ):
            self.store.create(
                PriorityClass(
                    metadata=ObjectMeta(name=pc_name, namespace=""), value=value
                )
            )
        if self.tenancy.enabled:
            # the configured tenancy tiers ARE PriorityClasses: seeding
            # them here makes tier names resolve through the scheduler's
            # existing _priority_of path and drive the existing
            # preemption machinery with zero new priority plumbing. The
            # default tier is the global default so even pre-tenancy
            # gangs with an empty name land on it.
            for tier in self.config.tenancy.tiers:
                self.store.create(
                    PriorityClass(
                        metadata=ObjectMeta(name=tier["name"], namespace=""),
                        value=float(tier["value"]),
                        global_default=(
                            tier["name"] == self.config.tenancy.default_tier
                        ),
                        description="tenancy priority tier",
                    )
                )
        for node in nodes or []:
            self.store.create(node)
        self._init_caches()
        self._init_replication()

    def _init_caches(self) -> None:
        """Derived-state caches, all rebuilt lazily from the store."""
        #: topology_snapshot static-encoding cache (see topology_snapshot)
        self._snapshot_key: tuple | None = None
        self._snapshot_cache: TopologySnapshot | None = None
        #: incremental usage accounting (see usage())
        self._usage: dict[str, dict[str, float]] | None = None
        self._usage_cursor = 0
        self._req_cache: dict[int, tuple] = {}
        #: free-delta journal for the solver's device-resident state:
        #: node names whose usage changed since the last
        #: consume_free_dirty() drain. None = unknown (nobody consumed
        #: yet, or a full usage rebuild crossed a compaction horizon) —
        #: consumers must fall back to a full content diff.
        self._free_dirty: set[str] | None = None
        #: monotonic free-content epoch stamped onto snapshots (bumped
        #: whenever usage() observed any capacity-moving pod transition)
        self._free_epoch = 0

    def _allowed_priorities(self) -> set[str]:
        """PodGang admission vocabulary under tenancy: the configured
        tier names plus every PriorityClass in the store (system-* and
        user-created classes stay legal). Computed per admission — the
        class population is tiny and user classes may arrive any time."""
        allowed = self.tenancy.tier_names()
        for pc in self.store.scan(PriorityClass.KIND):
            allowed.add(pc.metadata.name)
        return allowed

    # -- tracing ------------------------------------------------------------
    def enable_tracing(self, max_spans: int | None = None,
                       flight_capacity: int | None = None,
                       mode: str | None = None):
        """Build and wire the span tracer + flight recorder (idempotent).
        Called from __init__ when config.tracing.enabled, and by harnesses
        that upgrade after construction (ChaosHarness always records a
        flight so a wedged seed leaves a postmortem). Must run BEFORE the
        controllers are built — they capture cluster.tracer at
        construction (Harness._build_manager re-reads it on restart).

        mode "full" retains spans in the ring and charges the store's
        calls to the open span (ObjectStore.charge_calls); "aggregate"
        folds finished spans straight into bounded critical-path sketches
        (the always-on observatory, observability/causal.py)."""
        if self.tracer.enabled:
            return self.tracer
        from ..observability.causal import CausalLedger
        from ..observability.tracing import (
            AggregateTracer, FlightRecorder, Tracer,
        )

        tcfg = self.config.tracing
        self.flight = FlightRecorder(
            capacity=flight_capacity or tcfg.flight_recorder_capacity
        )
        if (mode or tcfg.mode) == "aggregate":
            self.tracer = AggregateTracer(
                clock=self.clock, metrics=self.metrics,
                flight=self.flight, top_k=tcfg.critical_path_top_k,
            )
        else:
            self.tracer = Tracer(
                clock=self.clock,
                max_spans=max_spans or tcfg.max_spans,
                flight=self.flight,
            )
            self.tracer.critical.top_k = tcfg.critical_path_top_k
            # the store's time, charged to the span that asked for it
            self.store.charge_calls(self.tracer)
        self.kubelet.tracer = self.tracer
        # EventRecorder hook: recorders hold the store (possibly via the
        # chaos proxy, whose __getattr__ delegates), so the flight ring
        # rides as a store attribute rather than N constructor params
        self.store.flight_recorder = self.flight
        # the causal token ledger + tracer ride the store the same way:
        # every layer that already holds the store (controllers, shard
        # workers, kubelet, federation members) can hand a token from
        # the previous hop to the next span without new plumbing
        self.store.causal = CausalLedger()
        self.store.tracer = self.tracer
        if self.slo is not None:
            # a firing bind-latency SLO attaches its worst offenders'
            # critical paths to the scorecard (observability/slo.py)
            self.slo.path_source = self.tracer
        return self.tracer

    # -- HA replication (cluster/replication.py) -----------------------------
    def _init_replication(self) -> None:
        """Build the log-shipping standby when config.replication is
        enabled: the shared fencing link on the leader's log, a standby
        store bootstrapped from the leader's durable directory, and the
        per-commit ship hook (semi-sync appends before the commit
        returns; async ships on lag-bound backpressure)."""
        self.standby = None
        self.replication_link = None
        if not (self.config.replication.enabled and
                self.durability is not None):
            return
        from .replication import ReplicationLink

        self.replication_link = ReplicationLink(term=self.durability.term)
        self.durability.link = self.replication_link
        self._build_standby()

    def _build_standby(self) -> None:
        from .replication import StandbyReplica, next_generation

        self.standby = StandbyReplica(
            self.config, self.durability, self.store,
            self.replication_link, metrics=self.metrics,
            generation=next_generation(
                self.config.replication.standby_wal_dir
            ),
        )
        self.durability.post_commit = self.standby.on_leader_commit

    def rebuild_standby(self) -> None:
        """Standby replacement (the standby_crash chaos fault, or
        re-arming HA after a promotion): the old replica's in-memory
        state and journal generation are abandoned — its metric series
        reconciled away — and a fresh standby bootstraps from the
        CURRENT leader's snapshots + WAL into the next gen-NNNN
        directory."""
        if self.replication_link is None:
            raise RuntimeError(
                "rebuild_standby requires replication "
                "(config.replication.enabled)"
            )
        if self.standby is not None:
            self.standby.remove_metric_series()
            self.standby.log.close()
        self._build_standby()

    def promote_standby(self, catch_up: bool = True) -> dict:
        """Failover, store layer: seal + fence the standby
        (StandbyReplica.promote), transplant its applied state into the
        live store object in place (every runtime wiring — admission,
        authorizer, chaos proxy, kubelet references — survives, the
        recover_in_place discipline), re-home its journal onto the live
        clock as the cluster's durability, and invalidate all derived
        soft state. Control-plane re-derivation (lease fencing check,
        manager rebuild, kubelet relist) is the harness's job: use
        Harness.promote_standby, which calls this. The deposed leader's
        log stays fenced — any append it attempts raises FencedAppend."""
        if self.standby is None:
            raise RuntimeError(
                "promote_standby requires a live standby "
                "(config.replication.enabled; a promoted cluster must "
                "rebuild_standby() to re-arm HA)"
            )
        replica = self.standby
        old_log = self.durability
        old_log.post_commit = None
        stats = replica.promote(catch_up=catch_up)
        old_log.close()
        self.store.adopt_state(replica.store, stats)
        self.durability = replica.log
        self.durability.adopt_clock(self.clock)
        self.durability.adopt_metrics(self.metrics)
        self.store.attach_durability(self.durability)
        replica.remove_metric_series()
        self.standby = None
        self.invalidate_soft_state()
        self.metrics.counter(
            "grove_store_recoveries_total",
            "store recoveries from durable state by outcome",
        ).inc(outcome="promoted")
        self.metrics.counter(
            "grove_store_promotions_total",
            "standby promotions by outcome",
        ).inc(outcome="promoted")
        return stats

    # -- durability / cold restart ------------------------------------------
    def invalidate_soft_state(self) -> None:
        """Drop every derived in-memory cache so the next read rebuilds
        from the (recovered) store: the topology-snapshot static encoding,
        the incremental usage accounting and its event cursor, the
        request-shape memo, and the free-delta journal (set to unknown —
        consumers fall back to a full content diff, the same contract as
        crossing a compaction horizon; the solver side is
        engine.invalidate_device_state, which the rebuilt scheduler's
        fresh engine implies)."""
        self._snapshot_key = None
        self._snapshot_cache = None
        self._usage = None
        self._usage_cursor = 0
        self._req_cache.clear()
        self._free_dirty = None
        self._free_epoch += 1

    def cold_restart(self) -> dict:
        """Whole-process crash-restart of the STORE layer: replace the
        live store state with what the durable log can prove (newest
        valid snapshot + WAL replay, torn-tail tolerant), cut a recovery
        checkpoint so the old — possibly torn — segment tail is never
        appended over, and invalidate all derived soft state. Control
        plane re-derivation (manager rebuild, lease expiry, kubelet
        relist) is the harness's job: use Harness.cold_restart, which
        calls this. Returns the recovery stats."""
        if self.durability is None:
            raise RuntimeError(
                "cold_restart requires durability "
                "(config.durability.wal_dir)"
            )
        stats = self.store.recover_in_place(self.durability.dir)
        self.durability.term = max(
            self.durability.term, stats.get("term", 0)
        )
        self.durability.checkpoint(self.store)
        self.invalidate_soft_state()
        self.metrics.counter(
            "grove_store_recoveries_total",
            "store recoveries from durable state by outcome",
        ).inc(outcome=stats["outcome"])
        return stats

    # -- node ops ----------------------------------------------------------
    #: read-modify-write attempts for node mutations before giving up (a
    #: conflict storm at the store boundary must not silently lose a
    #: cordon — each retry re-reads, so the loop is idempotent)
    NODE_UPDATE_RETRIES = 8

    def _update_node(self, name: str, mutate) -> Node:
        """Conflict-retrying node update (the same retry discipline the
        controllers get from the manager's backoff): re-read + mutate +
        write, retrying transient store failures. Unknown nodes raise
        NotFound with a clear message instead of an AttributeError deep in
        the mutator."""
        from .store import AlreadyExists, Forbidden, NotFound, StoreError

        last: StoreError | None = None
        for _ in range(self.NODE_UPDATE_RETRIES):
            node = self.store.get(Node.KIND, "default", name)
            if node is None:
                raise NotFound(f"node {name!r} not found")
            mutate(node)
            try:
                return self.store.update(node)
            except (NotFound, AlreadyExists, Forbidden):
                raise  # terminal: retrying cannot help
            except StoreError as exc:  # transient conflict/write fault
                last = exc
        raise last  # type: ignore[misc]  # loop ran: last is set

    def cordon(self, name: str) -> None:
        def mutate(node):
            node.unschedulable = True

        self._update_node(name, mutate)

    def uncordon(self, name: str) -> None:
        """Clears the cordon AND any drain mark — returning a node to
        service is the inverse of both."""
        from ..api.constants import ANNOTATION_DRAIN

        def mutate(node):
            node.unschedulable = False
            node.metadata.annotations.pop(ANNOTATION_DRAIN, None)

        self._update_node(name, mutate)

    def drain(self, name: str) -> None:
        """Begin a gang-aware graceful drain (the kubectl-drain analog):
        cordon the node and stamp the drain annotation; the NodeMonitor
        then evicts its pods no faster than replacements become Ready
        elsewhere, honoring each clique's MinAvailable, and falls back to
        whole-gang termination only when a gang cannot be rebuilt on the
        remaining capacity. Drive the control plane (settle/advance) until
        node_drained(name) reports True."""
        from ..api.constants import ANNOTATION_DRAIN

        def mutate(node):
            node.unschedulable = True
            node.metadata.annotations[ANNOTATION_DRAIN] = "true"

        self._update_node(name, mutate)

    def node_drained(self, name: str) -> bool:
        """True when no active pod remains bound to the node."""
        for pod in self.store.scan(Pod.KIND):
            if (
                pod.node_name == name
                and pod.metadata.deletion_timestamp is None
                and pod.status.phase
                not in (PodPhase.SUCCEEDED, PodPhase.FAILED)
            ):
                return False
        return True

    def fail_node(self, name: str) -> None:
        """Infrastructure node failure: heartbeats stop AND the Ready
        condition flips immediately (the monitor would reach the same
        state one lease-lag later; stamping it directly gives outage
        injection its one-tick semantics). Recovery goes through
        recover_node — the node re-enters the candidate set only after
        the monitor's stable-ready window."""
        from .nodehealth import set_node_ready
        from .store import NotFound

        if self.store.peek(Node.KIND, "default", name) is None:
            raise NotFound(f"node {name!r} not found")
        self.kubelet.fail_heartbeat(name)
        set_node_ready(
            self.store, name, False, reason="NodeFailed",
            message="injected node failure", now=self.clock.now(),
        )

    def recover_node(self, name: str) -> None:
        """Heartbeats resume; the NodeMonitor flips Ready back after
        node_stable_ready_seconds of continuous renewal."""
        self.kubelet.restore_heartbeat(name)

    def fail_domain(self, label_key: str, value: str) -> list[str]:
        """Failure-domain outage (rack/slice/ICI-domain loss): every node
        labelled `label_key=value` goes NotReady in one tick and stops
        heartbeating. Returns the failed node names. The scheduler's
        candidate set drops the whole domain at the next snapshot, so
        displaced gangs repair onto healthy domains after the eviction
        grace."""
        from .store import NotFound

        names = [
            n.metadata.name
            for n in self.store.scan(Node.KIND)
            if n.metadata.labels.get(label_key) == value
        ]
        if not names:
            raise NotFound(f"no node carries {label_key}={value!r}")
        for name in names:
            self.fail_node(name)
        return names

    def recover_domain(self, label_key: str, value: str) -> list[str]:
        """Heartbeats resume for every member node (each still waits out
        the stable-ready window before rejoining the candidate set)."""
        names = [
            n.metadata.name
            for n in self.store.scan(Node.KIND)
            if n.metadata.labels.get(label_key) == value
        ]
        for name in names:
            self.recover_node(name)
        return names

    # -- solver input ------------------------------------------------------
    @staticmethod
    def _counted(pod) -> bool:
        """A pod holds node capacity iff bound, non-terminal and not
        marked deleting (kube-scheduler's accounting)."""
        return bool(
            pod.node_name
            and pod.status.phase not in (PodPhase.SUCCEEDED, PodPhase.FAILED)
            and pod.metadata.deletion_timestamp is None
        )

    def _pod_requests(self, pod) -> dict[str, float]:
        """total_requests() memoized by the CONTAINER LIST identity: the
        MVCC store shares container lists across pod versions (and the
        frozen template shares them across a whole clique's pods), so one
        entry serves thousands of pods. Entries hold the keyed object so
        its id cannot be recycled while cached."""
        key = id(pod.spec.containers)
        hit = self._req_cache.get(key)
        if hit is not None and hit[0] is pod.spec.containers:
            return hit[1]
        req = pod.spec.total_requests()
        if len(self._req_cache) > 65536:
            self._req_cache.clear()
        self._req_cache[key] = (pod.spec.containers, req)
        return req

    @property
    def usage_cursor(self) -> int:
        """Last store event seq the incremental usage accounting has
        drained (public: feeds the harness's safe compaction horizon)."""
        return self._usage_cursor

    def usage(self) -> dict[str, dict[str, float]]:
        """Per-node resource usage from bound, non-terminal pods (terminal
        Succeeded/Failed pods release their requests). INCREMENTAL: an
        informer-style cursor over the store's event log adjusts the
        accounting per pod transition instead of re-scanning every pod per
        scheduler reconcile (O(pods) per solve round at stress scale);
        falls back to a full rebuild past a compaction horizon. Returned
        dict is the live cache — callers read, never mutate."""
        from .store import StoreError

        try:
            events = self.store.events_since(self._usage_cursor)
        except StoreError:
            events = None  # compacted past the cursor: rebuild below
        if events is None or self._usage is None:
            self._usage_cursor = self.store.last_seq
            # full rebuild: per-row change tracking is lost — consumers
            # of the free journal must fall back to a full diff
            self._free_dirty = None
            self._free_epoch += 1
            self._usage = out = {}
            for pod in self.store.scan(Pod.KIND):
                if self._counted(pod):
                    per_node = out.setdefault(pod.node_name, {})
                    for res, amount in self._pod_requests(pod).items():
                        per_node[res] = per_node.get(res, 0.0) + amount
            return self._usage
        if events:
            self._usage_cursor = events[-1].seq
        out = self._usage
        moved = False
        for ev in events:
            if ev.kind != Pod.KIND:
                continue
            was = (
                ev.type != "Added"
                and ev.old is not None
                and self._counted(ev.old)
            )
            if ev.type == "Deleted":
                now_ = False
                # Deleted events carry no old; the final snapshot IS it
                was = self._counted(ev.obj)
            else:
                now_ = self._counted(ev.obj)
            if was == now_:
                continue
            pod = ev.obj if now_ else (ev.old if ev.old is not None else ev.obj)
            per_node = out.setdefault(pod.node_name, {})
            sign = 1.0 if now_ else -1.0
            for res, amount in self._pod_requests(pod).items():
                per_node[res] = per_node.get(res, 0.0) + sign * amount
            moved = True
            if self._free_dirty is not None:
                self._free_dirty.add(pod.node_name)
        if moved:
            self._free_epoch += 1
        return out

    def live_topology(self) -> ClusterTopology:
        """The stored singleton ClusterTopology when present, else the
        bootstrap object. Scheduling must follow topology UPDATES made
        through the store — the PCS reconciler already reads the store for
        constraint translation, and the solver snapshot has to agree with it
        or unknown keys silently weaken to unconstrained."""
        ct = self.store.get(
            ClusterTopology.KIND,
            self.topology.metadata.namespace,
            self.topology.metadata.name,
        )
        return ct if ct is not None else self.topology

    def topology_snapshot(self) -> TopologySnapshot:
        """Solver-ready snapshot. The STATIC encoding (domain ids, node
        index, capacity, schedulability, eligibility-mask cache) is cached
        against the Node + ClusterTopology write serials — at stress scale
        re-walking 5k nodes' labels per reconcile dominated the scheduler's
        non-solve time. On a hit only `free` is refreshed in place from
        live pod usage; returning the SAME snapshot object also lets the
        scheduler reuse its engine (and the engine its DomainSpace)."""
        key = (
            self.store.kind_serial(Node.KIND),
            self.store.kind_serial(ClusterTopology.KIND),
        )
        snap = self._snapshot_cache if key == self._snapshot_key else None
        if snap is None:
            snap = encode_topology(
                self.live_topology(), self.store.scan(Node.KIND),
                usage=self.usage(),
            )
            self._snapshot_key, self._snapshot_cache = key, snap
            snap.free_epoch = self._free_epoch
            return snap
        from ..topology.encoding import apply_usage

        apply_usage(snap, self.usage())
        snap.free_epoch = self._free_epoch
        return snap

    def consume_free_dirty(self, snapshot: TopologySnapshot) -> list[int] | None:
        """Drain the free-delta journal: row indices (into `snapshot`)
        whose free capacity MAY have changed since the previous drain, or
        None when the set is unknowable (first drain, or a usage rebuild
        crossed a compaction horizon). Superset contract, same as
        PlacementEngine.note_free_rows — the scheduler feeds the result
        straight through so a warm solve's device-state sync checks a
        handful of rows instead of running the full O(N*R) diff. Call
        AFTER topology_snapshot() so the journal reflects every event the
        usage accounting has drained."""
        dirty, self._free_dirty = self._free_dirty, set()
        if dirty is None:
            return None
        index = snapshot.node_index
        return [index[n] for n in dirty if n in index]

    def pod_demand_fn(self, resource_names: list[str]):
        """pod_demand callable for solver.problem.encode_podgangs.

        Demand vectors are memoized by REQUEST CONTENT for the life of
        the returned callable: a stress backlog's pods overwhelmingly
        share a handful of request shapes, and the per-pod
        np.asarray(list) was the top host cost of the encode at
        10^3-gang scale (20k asarray calls per solve round). The cached
        vectors are frozen read-only — callers compare/subtract against
        them but must never write into them."""
        names = tuple(resource_names)

        def fn(namespace: str, name: str, _cache={}):
            pod = self.store.peek(Pod.KIND, namespace, name)  # read-only
            if pod is None:
                return None
            req = pod.spec.total_requests()
            key = tuple(sorted(req.items()))
            vec = _cache.get(key)
            if vec is None:
                vec = np.asarray(
                    [req.get(r, 0.0) for r in names], dtype=np.float32
                )
                vec.flags.writeable = False
                _cache[key] = vec
            return vec

        return fn

    def pod_scheduling_fn(self):
        """pod_scheduling callable for encode_podgangs: the pod's hard node
        filters (node_selector, tolerations). The reference embeds full
        corev1.PodSpec whose selectors/taints the delegated scheduler honors
        (operator/api/core/v1alpha1/podclique.go:60-63); grove_tpu owns the
        scheduler, so these flow into the solve paths as eligibility masks."""

        def fn(namespace: str, name: str):
            pod = self.store.peek(Pod.KIND, namespace, name)  # read-only
            if pod is None:
                return None
            return pod.spec.node_selector, pod.spec.tolerations

        return fn


def _infer_levels(nodes: list[Node]):
    """Derive topology levels from the label keys the inventory carries."""
    from ..api.types import TopologyLevel
    from .inventory import BLOCK_KEY, RACK_KEY

    keys = set()
    for n in nodes:
        keys.update(n.metadata.labels)
    levels = []
    if BLOCK_KEY in keys:
        levels.append(TopologyLevel(domain="block", key=BLOCK_KEY))
    if RACK_KEY in keys:
        levels.append(TopologyLevel(domain="rack", key=RACK_KEY))
    return levels
