"""ChaosHarness: drive a control plane to convergence THROUGH a fault plan.

Builds a normal `controller.Harness` whose manager, reconcilers and
scheduler all see the store through a `ChaosStore` (the kubelet and the
test driver keep the raw store — chaos models the operator's apiserver
view). `run_chaos()` then interleaves manager rounds, kubelet ticks and
plan-scheduled infrastructure faults — manager crash-restarts (including
mid-reconcile, via the ManagerCrash signal raised from inside a committed
write), kubelet tick stalls, clock jumps and forced event-log compaction —
for `plan.chaos_steps` steps, disarms, and settles to the recovered
fixpoint.

The convergence contract (tests/test_chaos.py): after faults stop, the
workload-level fingerprint — which objects exist, which pods are bound and
ready, per-clique ready counts, per-PCS availability, every status error
cleared — must be IDENTICAL to a fault-free run of the same workload, and
the capacity/orphan invariants the fuzz suite checks must hold. Node
assignment is deliberately outside the fingerprint: a fault-displaced
solve may legally pick a different (equally valid) placement.

The counterpart of grove_tpu/chaos/harness.py. `ChaosHarness(...,
device=)` passes the device to its `Harness` (None = the CUDA card,
"cpu" the kernels' plain versions), so every engine a crash rebuilds
solves there too.
"""

from __future__ import annotations

import os
from typing import Any

from ..api.types import Node, Pod, PodClique, PodCliqueSet
from ..cluster.cluster import Cluster
from ..controller import Harness
from .plan import FaultPlan
from .store import ChaosStore, ManagerCrash

_TERMINAL = ("Failed", "Succeeded")


def settled_fingerprint(store) -> dict[str, Any]:
    """Workload-level convergence fingerprint of a settled store. Chaos
    and fault-free runs of the same workload must produce EQUAL
    fingerprints; placement (node names) and bookkeeping that legitimately
    differs under faults (event counts, leases, resource versions) are
    excluded."""
    pods = {}
    for p in store.scan(Pod.KIND):
        pods[(p.metadata.namespace, p.metadata.name)] = (
            bool(p.node_name),
            p.status.phase.value,
            p.status.ready,
            len(p.spec.scheduling_gates),
            p.metadata.deletion_timestamp is not None,
        )
    cliques = {}
    for c in store.scan(PodClique.KIND):
        cliques[(c.metadata.namespace, c.metadata.name)] = (
            c.status.replicas,
            c.status.ready_replicas,
            c.status.scheduled_replicas,
            len(c.status.last_errors),
        )
    sets = {}
    for s in store.scan(PodCliqueSet.KIND):
        sets[(s.metadata.namespace, s.metadata.name)] = (
            s.status.replicas,
            s.status.available_replicas,
            len(s.status.last_errors),
            s.status.last_operation.state
            if s.status.last_operation is not None
            else None,
        )
    counts = {
        kind: n
        for kind, n in store.object_counts().items()
        # coordination objects are bookkeeping, not workload state: a
        # sharded run carries a ShardMap (and worker Leases) a
        # single-replica fault-free baseline never has
        if kind not in ("Event", "Lease", "ShardMap")
    }
    return {"pods": pods, "cliques": cliques, "sets": sets, "counts": counts}


def check_invariants(store) -> list[str]:
    """The fuzz suite's global invariants, returned as violations instead
    of asserted (shared by tests and scripts/chaos_sweep.py): no ACTIVE
    pod bound to a missing node, no node over capacity."""
    violations: list[str] = []
    nodes = {n.metadata.name: n for n in store.scan(Node.KIND)}
    usage: dict[str, dict[str, float]] = {}
    for p in store.scan(Pod.KIND):
        active = (
            p.metadata.deletion_timestamp is None
            and p.status.phase.value not in _TERMINAL
        )
        if not (p.node_name and active):
            continue
        if p.node_name not in nodes:
            violations.append(
                f"active pod {p.metadata.name} bound to lost node "
                f"{p.node_name}"
            )
            continue
        u = usage.setdefault(p.node_name, {})
        for res, amt in p.spec.total_requests().items():
            u[res] = u.get(res, 0.0) + amt
    for name, node in nodes.items():
        for res, used in usage.get(name, {}).items():
            if used > node.allocatable.get(res, 0.0) + 1e-6:
                violations.append(
                    f"node {name} over-committed on {res}: {used}"
                )
    return violations


class ChaosHarness:
    """A `Harness` with a ChaosStore spliced between the cluster and
    every controller, plus the driver loop that schedules manager/kubelet/
    clock faults. The underlying harness is `self.harness`; `store` /
    `clock` / `manager` / `apply` / `settle` / `advance` delegate so
    existing workload builders work unchanged. The raw (fault-free) store
    stays reachable as `self.raw_store` for assertions and fixtures."""

    def __init__(self, plan: FaultPlan, nodes: list[Node] | None = None,
                 config=None, engine_cls=None,
                 trace_path: str | None = None, device=None):
        from ..api.config import load_operator_config

        if isinstance(config, dict):
            config = load_operator_config(config)
        cluster = Cluster(nodes=nodes, config=config)
        self.raw_store = cluster.store
        self.chaos_store = ChaosStore(
            cluster.store, plan, metrics=cluster.metrics
        )
        # every consumer wired AFTER this point (manager, reconcilers,
        # scheduler, incremental usage accounting) reads through chaos;
        # the kubelet was bound to the raw store in Cluster.__init__
        cluster.store = self.chaos_store
        # chaos ALWAYS records spans + errors + events into the bounded
        # flight-recorder ring (observability/tracing.py): a seed that
        # wedges or diverges leaves a postmortem (dump_flight) instead of
        # demanding a re-run under print statements. enable_tracing runs
        # BEFORE Harness so the manager/reconcilers capture the recording
        # tracer at construction.
        cluster.enable_tracing()
        self.flight = cluster.flight
        #: when set, a failed post-chaos settle auto-dumps the flight
        #: recorder here (scripts/chaos_sweep.py --trace-dir wires it)
        self.trace_path = trace_path
        self.harness = Harness(cluster=cluster, engine_cls=engine_cls,
                               device=device)
        self.plan = plan
        self.manager_restarts = 0
        #: node-fault bookkeeping (all repaired at disarm so the
        #: recovered fixpoint is measured against restored infrastructure)
        self._flapping: dict[str, int] = {}  # node -> steps until recovery
        self._hb_lost: set[str] = set()
        self._outage_domains: list[str] = []
        self._drained_nodes: list[str] = []
        #: tenant-skew workloads injected this run ((namespace, name)
        #: PCS keys; all deleted at disarm so the recovered fixpoint
        #: matches the fault-free run)
        self._skew_workloads: list[tuple[str, str]] = []
        #: burst-storm workloads injected this run (same lifecycle as
        #: the skew workloads: deleted at disarm so the recovered
        #: fixpoint matches the fault-free run)
        self._storm_workloads: list[tuple[str, str]] = []
        #: shard-fault bookkeeping: crashed worker indices (revived at
        #: disarm; shards fail over meanwhile via orphaned-lease
        #: detection)
        self._crashed_workers: set[int] = set()
        #: whole-process crash-recoveries this run (the durable-store
        #: fault axis; see process_crash) + their recovery stats
        self.process_restarts = 0
        self.recovery_stats: list[dict[str, Any]] = []
        #: standby failovers this run (the HA-replication fault axis;
        #: see standby_promotion) — promotion stats ride recovery_stats
        self.standby_promotions = 0
        sharded = self._sharded
        if sharded is not None:
            # the ownership audit rides every chaos round: a key
            # reconciled by two live workers in one round fails the seed
            # loudly instead of converging by luck
            sharded.audit = True
        # defrag's disruption-budget audit rides every chaos sweep the
        # same way: an overspent tenant budget fails the seed loudly
        self._arm_defrag_audit()

    #: drain storms are capped per run: an unbounded storm could cordon
    #: the whole inventory out from under the workload, and a drained
    #: node stays cordoned until disarm
    DRAIN_STORM_MAX = 2

    # -- harness delegation ------------------------------------------------
    @property
    def store(self):
        return self.harness.store

    @property
    def clock(self):
        return self.harness.clock

    @property
    def manager(self):
        return self.harness.manager

    @property
    def kubelet(self):
        return self.harness.kubelet

    @property
    def config(self):
        return self.harness.config

    def apply(self, pcs):
        return self.harness.apply(pcs)

    def settle(self, max_rounds: int | None = None) -> None:
        self.harness.settle(max_rounds)

    def advance(self, seconds: float) -> None:
        self.harness.advance(seconds)

    # -- the chaotic loop --------------------------------------------------
    def _record(self, fault_type: str) -> None:
        """Driver-level fault bookkeeping: same plan count + metrics
        counter the ChaosStore uses for store-level faults, so
        grove_chaos_faults_injected_total totals the WHOLE fault log."""
        self.plan.record(fault_type)
        self.harness.cluster.metrics.counter(
            "grove_chaos_faults_injected_total",
            "chaos faults injected by type",
        ).inc(type=fault_type)

    @property
    def _sharded(self):
        """The ShardedManager when the config runs shards > 1, else
        None (shard faults are skipped on a single-replica manager)."""
        manager = self.harness.manager
        return manager if hasattr(manager, "workers") else None

    def restart_manager(self) -> None:
        """Operator process crash-restart: a brand-new manager (event
        cursor 0 — it replays the log, or relists past a compaction
        horizon) and brand-new reconcilers (every in-memory cache —
        scheduler reservations, expectation marks — rebuilt from the
        store), over the same chaos-wrapped store. Under a sharded
        control plane this models the whole fleet process restarting:
        fresh workers adopt the persisted ShardMap and replay."""
        self.manager_restarts += 1
        if self.harness.cluster.metrics is not None:
            self.harness.cluster.metrics.counter(
                "grove_chaos_manager_restarts_total",
                "chaos-injected manager crash-restarts",
            ).inc()
        self.harness._build_manager()
        sharded = self._sharded
        if sharded is not None:
            sharded.audit = True
            self._crashed_workers.clear()  # the rebuild revived everyone
        self._arm_defrag_audit()  # the rebuilt controller starts unarmed

    # -- node-lifecycle faults ---------------------------------------------
    def _live_node_names(self) -> list[str]:
        return sorted(
            n.metadata.name
            for n in self.raw_store.scan(Node.KIND)
            if n.metadata.deletion_timestamp is None
        )

    def _inject_node_faults(self) -> None:
        """Per-step node-lifecycle fault draws (see FaultPlan): flap,
        silent heartbeat loss, whole-domain outage, drain storm. Targets
        are drawn from the plan RNG over the sorted live inventory, so a
        seed replays the same nodes failing in the same order."""
        from ..cluster.inventory import RACK_KEY

        plan = self.plan
        cluster = self.harness.cluster
        names = self._live_node_names()
        # nodes already under a standing heartbeat-level fault: a flap
        # expiring on one would restore its heartbeat (recover_node) and
        # silently heal the heartbeat-loss/outage mid-chaos, breaking
        # their until-disarm semantics — so neither draw may target them.
        # The flip+pick RNG draws still run unconditionally: only the
        # injection is skipped, keeping every seed's draw sequence intact.
        standing = set(self._flapping) | self._hb_lost
        if self._outage_domains:
            outage = set(self._outage_domains)
            standing |= {
                n.metadata.name
                for n in self.raw_store.scan(Node.KIND)
                if n.metadata.labels.get(RACK_KEY) in outage
            }
        if names and plan.flip(plan.node_flap_rate):
            name = names[plan.pick(len(names))]
            if name not in standing:
                self._record("node_flap")
                cluster.fail_node(name)
                self._flapping[name] = 1 + plan.pick(3)
        if names and plan.flip(plan.heartbeat_loss_rate):
            name = names[plan.pick(len(names))]
            if name not in standing:
                self._record("heartbeat_loss")
                self.kubelet.fail_heartbeat(name)
                self._hb_lost.add(name)
        if plan.flip(plan.domain_outage_rate):
            racks = sorted(
                {
                    n.metadata.labels.get(RACK_KEY)
                    for n in self.raw_store.scan(Node.KIND)
                    if n.metadata.labels.get(RACK_KEY)
                }
                - set(self._outage_domains)
            )
            if racks:
                dom = racks[plan.pick(len(racks))]
                self._record("domain_outage")
                cluster.fail_domain(RACK_KEY, dom)
                self._outage_domains.append(dom)
        if (
            plan.flip(plan.drain_storm_rate)
            and len(self._drained_nodes) < self.DRAIN_STORM_MAX
        ):
            candidates = [
                n for n in names
                if n not in self._drained_nodes
                and n not in self._flapping
                and n not in self._hb_lost
            ]
            if candidates:
                name = candidates[plan.pick(len(candidates))]
                self._record("drain_storm")
                cluster.drain(name)
                self._drained_nodes.append(name)

    #: tenant namespaces the skew fault targets when the cluster has no
    #: tenancy configured (load skew is meaningful either way; with
    #: tenancy enabled the configured tenant set is used instead)
    SKEW_TENANTS = ("skew-a", "skew-b")

    def _skew_tenant_names(self) -> list[str]:
        tenancy = getattr(self.harness.cluster, "tenancy", None)
        if tenancy is not None and tenancy.enabled and tenancy.queues:
            return sorted(tenancy.queues)
        return list(self.SKEW_TENANTS)

    def _inject_tenant_skew(self) -> None:
        """Tenant-skew load fault: a burst of single-replica gangs lands
        in ONE seeded tenant's namespace — the skewed-offered-load shape
        quota admission and DRF fairness must absorb. With tenancy
        enabled the burst exercises the real admission bands (some of it
        sheds with QuotaExceeded); without it the burst is plain load
        skew. Injected PCS are tracked and deleted at disarm (see
        _repair_infrastructure), so the post-chaos fixpoint equals the
        fault-free one."""
        plan = self.plan
        tenants = self._skew_tenant_names()
        ns = tenants[plan.pick(len(tenants))]
        for _ in range(max(1, plan.tenant_skew_burst)):
            name = f"skew-{len(self._skew_workloads)}"
            # injected via the RAW store: the fault driver must not fault
            # its own injections (the chaos proxy would raise transient
            # write failures / ManagerCrash at the driver level)
            self.raw_store.create(self._burst_pcs(ns, name))
            self._skew_workloads.append((ns, name))

    @staticmethod
    def _burst_pcs(ns: str, name: str):
        """One single-replica two-pod PCS — the unit of injected load for
        the tenant-skew and burst-storm fault axes."""
        from ..api.meta import ObjectMeta
        from ..api.types import (
            Container,
            PodCliqueSet,
            PodCliqueSetSpec,
            PodCliqueSetTemplateSpec,
            PodCliqueSpec,
            PodCliqueTemplateSpec,
            PodSpec,
        )

        return PodCliqueSet(
            metadata=ObjectMeta(name=name, namespace=ns),
            spec=PodCliqueSetSpec(
                replicas=1,
                template=PodCliqueSetTemplateSpec(
                    cliques=[
                        PodCliqueTemplateSpec(
                            name="w",
                            spec=PodCliqueSpec(
                                replicas=2,
                                pod_spec=PodSpec(
                                    containers=[
                                        Container(
                                            name="m",
                                            resources={"cpu": 1.0},
                                        )
                                    ]
                                ),
                            ),
                        )
                    ]
                ),
            ),
        )

    # -- streaming-admission faults ------------------------------------------
    @property
    def _stream(self):
        """The scheduler's StreamFront when config.stream.enabled, else
        None (stream faults are skipped entirely — rate-guarded AND
        capability-guarded, so pre-existing seeds replay identically
        either way). Read through the harness each time: a manager
        crash-restart rebuilds the scheduler and its front."""
        return getattr(self.harness.scheduler, "stream", None)

    def _inject_stream_faults(self) -> None:
        """Per-step streaming-admission fault draws (see FaultPlan):
        burst storms and arrival stalls. Every draw is guarded on
        rate > 0 AND on the streaming front being configured.

        burst_storm lands `plan.burst_storm_gangs` single-replica gangs
        in ONE seeded tenant's namespace at a single instant — the ~10x
        overload spike the front must absorb by shedding with structured
        DeadlineExceeded rather than wedging. Injected PCS are tracked
        and deleted at disarm (see _repair_infrastructure), so the
        recovered fixpoint equals the fault-free one.

        arrival_stall holds admission for a few chaos steps via the
        front's stall hook; deadline budgets keep burning through the
        stall, so it resolves into either a batched admit or a deadline
        shed — never a wedged queue. Cleared at disarm."""
        plan = self.plan
        stream = self._stream
        if stream is None:
            return
        if plan.burst_storm_rate > 0 and plan.flip(plan.burst_storm_rate):
            self._record("burst_storm")
            tenants = self._skew_tenant_names()
            ns = tenants[plan.pick(len(tenants))]
            for _ in range(max(1, plan.burst_storm_gangs)):
                name = f"storm-{len(self._storm_workloads)}"
                self.raw_store.create(self._burst_pcs(ns, name))
                self._storm_workloads.append((ns, name))
        if plan.arrival_stall_rate > 0 and plan.flip(
            plan.arrival_stall_rate
        ):
            self._record("arrival_stall")
            stream.stall(
                self.clock.now()
                + max(1, plan.arrival_stall_steps) * plan.step_seconds
            )

    def _inject_shard_faults(self) -> None:
        """Per-step sharded-control-plane fault draws (see FaultPlan):
        worker crash, frozen shard-map view, handoff storm. Guarded on
        rate > 0 BEFORE any draw — pre-existing seeds keep their exact
        sequences — and skipped entirely on a single-replica manager."""
        plan = self.plan
        sharded = self._sharded
        if sharded is None:
            return
        if plan.shard_crash_rate > 0 and plan.flip(plan.shard_crash_rate):
            live = [w.index for w in sharded.workers if w.alive]
            if len(live) > 1:
                idx = live[plan.pick(len(live))]
                if sharded.kill_worker(idx):
                    self._record("shard_crash")
                    self._crashed_workers.add(idx)
        if plan.shard_map_stale_rate > 0 and plan.flip(
            plan.shard_map_stale_rate
        ):
            live = [w for w in sharded.workers if w.alive]
            if live:
                w = live[plan.pick(len(live))]
                self._record("shard_map_stale")
                # a few steps of frozen map view: within one lease
                # duration the worker keeps serving its cached shards
                # (safe: pending moves wait for ITS release), past it
                # the worker defers until the hold expires
                w.stale_map_hold += 2 + plan.pick(4)
        if plan.handoff_storm_rate > 0 and plan.flip(
            plan.handoff_storm_rate
        ):
            live = [w.index for w in sharded.workers if w.alive]
            if len(live) > 1:
                idx = live[plan.pick(len(live))]
                if sharded.chaos_revoke_worker(idx):
                    self._record("handoff_storm")

    # -- elastic-serving faults ----------------------------------------------
    @property
    def _serving(self):
        """The cluster's TrafficEngine when config.serving.enabled, else
        None (serving faults and the chaotic HPA sync loop are skipped
        entirely — rate-guarded AND capability-guarded, so pre-existing
        seeds replay identically either way)."""
        return getattr(self.harness.cluster, "serving", None)

    def _inject_serving_faults(self) -> None:
        """Per-step elastic-serving fault draws (see FaultPlan): transient
        traffic spikes onto the trace, metrics-pipeline dropouts. Every
        draw is guarded on rate > 0 AND on serving being configured."""
        plan = self.plan
        serving = self._serving
        if serving is None:
            return
        if plan.traffic_spike_rate > 0 and plan.flip(
            plan.traffic_spike_rate
        ):
            self._record("traffic_spike")
            duration = plan.step_seconds * (2 + plan.pick(6))
            # the configured multiplier is a CEILING the draw must
            # honor (a seed tuned to stay under a tier's max_replicas
            # must not be blown past it by a hidden floor); the draw
            # floor is 1.5 only when the ceiling allows it
            hi = max(plan.traffic_spike_multiplier, 1.0)
            multiplier = plan.uniform(min(1.5, hi), hi)
            serving.inject_spike(
                self.clock.now(), duration, multiplier
            )
        if plan.metrics_dropout_rate > 0 and plan.flip(
            plan.metrics_dropout_rate
        ):
            self._record("metrics_dropout")
            pm = self.harness.cluster.pod_metrics
            pm.dropout_steps += 2 + plan.pick(4)

    # -- continuous-defragmentation faults ------------------------------------
    @property
    def _defrag(self):
        """The harness's DefragController when config.defrag.enabled,
        else None (defrag faults and the chaotic sweep cadence are
        skipped entirely — rate-guarded AND capability-guarded, so
        pre-existing seeds replay identically either way)."""
        h = self.harness
        return h.defrag if h.config.defrag.enabled else None

    def _arm_defrag_audit(self) -> None:
        """Arm the defragmenter's disruption-budget audit (the shape of
        the sharded plane's ownership audit): a sweep that overspends any tenant's
        budget raises instead of passing. Re-armed after every manager
        restart — the rebuilt controller starts with the flag off."""
        d = self._defrag
        if d is not None:
            d.audit = True

    def _inject_defrag_faults(self) -> None:
        """Per-step defrag fault draws (see FaultPlan): a forced
        migration storm, composed with a crash mid-migration (tickets
        are soft state) and/or a destination-node fault before the
        re-bind. Every draw is guarded on rate > 0 AND on defrag being
        configured."""
        from ..cluster.inventory import RACK_KEY

        plan = self.plan
        d = self._defrag
        if d is None:
            return
        if plan.migration_storm_rate > 0 and plan.flip(
            plan.migration_storm_rate
        ):
            self._record("migration_storm")
            try:
                self.harness.defrag_sweep(storm=True)
            except ManagerCrash:
                self.restart_manager()
            if plan.migration_crash_rate > 0 and plan.flip(
                plan.migration_crash_rate
            ):
                # crash mid-migration: the staged tickets die with the
                # scheduler's soft state; the evicted gangs re-place
                # through the general solve (at worst onto their own
                # just-vacated capacity)
                self._record("migration_crash")
                self.restart_manager()
            dests = sorted(set(d.last_move_destinations))
            if dests and plan.migration_node_fault_rate > 0 and plan.flip(
                plan.migration_node_fault_rate
            ):
                # node fault during a move: a held destination dies
                # before the re-bind. Same standing-fault guard as
                # _inject_node_faults: never re-fail a node already
                # under a heartbeat-level fault.
                standing = set(self._flapping) | self._hb_lost
                if self._outage_domains:
                    outage = set(self._outage_domains)
                    standing |= {
                        n.metadata.name
                        for n in self.raw_store.scan(Node.KIND)
                        if n.metadata.labels.get(RACK_KEY) in outage
                    }
                name = dests[plan.pick(len(dests))]
                if name not in standing and name in set(
                    self._live_node_names()
                ):
                    self._record("migration_node_fault")
                    self.harness.cluster.fail_node(name)
                    self._flapping[name] = 1 + plan.pick(3)

    def _chaos_defrag(self) -> None:
        """The defrag sync loop keeps its config cadence THROUGH the
        storm (defrag-enabled runs only): maybe_defrag without settling
        — convergence is the interleaved manager rounds' job."""
        try:
            self.harness.maybe_defrag(settle=False)
        except ManagerCrash:
            self.restart_manager()

    def _chaos_autoscale(self) -> None:
        """The HPA sync loop keeps its config cadence THROUGH the storm
        (serving runs only): maybe_autoscale without settling —
        convergence is the interleaved manager rounds' job — and treat a
        mid-sweep ManagerCrash like any other (the chaos store raises it
        from committed writes)."""
        try:
            self.harness.maybe_autoscale(settle=False)
        except ManagerCrash:
            self.restart_manager()

    # -- SLO evaluation through the storm --------------------------------------
    @property
    def _slo(self):
        """The cluster's SLOEngine when config.slo.enabled, else None
        (the sweep cadence is skipped entirely — capability-guarded
        like defrag, so pre-existing seeds replay identically)."""
        return getattr(self.harness.cluster, "slo", None)

    def _chaos_slo(self) -> None:
        """The SLO evaluation loop keeps its cadence through the storm
        (slo-enabled runs only): this is where burst_storm/tenant_skew/
        promote_standby faults must drive alerts pending->firing. The
        sweep's only store writes are advisory Events, routed through
        the RAW store so evaluation consumes ZERO fault-plan draws —
        a seed replays bit-identically with SLO evaluation on or off."""
        try:
            self.harness.maybe_slo_sweep(store=self.raw_store)
        except ManagerCrash:  # defensive parity with the other sweeps
            self.restart_manager()

    def _drain_serving(self) -> None:
        """Post-disarm serving drain: let every stabilization-window
        entry from the spike era expire, then sweep on the sync cadence
        until the HPAs stop moving — the recovered fixpoint must carry
        the same replica counts a fault-free run holds (the injected
        spikes are gone; the trace demand is whatever it is at the
        current virtual time, which the convergence suites pin by using
        a FLAT trace)."""
        h = self.harness
        if self._serving is None:
            return
        cfg = h.config.autoscaler
        h.advance(
            cfg.scale_down_stabilization_seconds
            + cfg.sync_interval_seconds + 1.0
        )
        ctr = h.cluster.metrics.counter(
            "grove_autoscaler_scale_events_total",
            "applied HPA scale events by direction",
        )
        for _ in range(8):
            before = ctr.total()
            h.autoscale()
            if ctr.total() == before:
                return
            h.advance(cfg.sync_interval_seconds + 1.0)

    # -- durable-store faults -----------------------------------------------
    @property
    def _durable(self):
        """The cluster's DurableLog when durability is configured, else
        None (the durable-fault draws are skipped entirely — rate-guarded
        AND capability-guarded, so seeds replay identically either way)."""
        return self.harness.cluster.durability

    def process_crash(self, tear_tail: bool = False,
                      corrupt_snapshot: bool = False,
                      tear_partition: int | None = None) -> dict:
        """The whole-process crash: optionally tear the WAL tail / corrupt
        the newest snapshot first (what a dying disk leaves behind), then
        drop the live store and recover from disk mid-plan —
        Harness.cold_restart re-derives every piece of soft state. The
        chaos proxy is disarmed for the recovery sequence itself (a store
        being REBUILT has no flaky-apiserver view to model; faults resume
        with the next step) and its stale-read memory is cleared: the
        informer caches died with the process.

        tear_partition (partitioned durability only) tears ONE specific
        partition's tail — the partition_wal_divergence fault: that
        partition rewinds its unacknowledged record while the others
        keep their possibly-later committed history, and recovery must
        merge the diverged streams back consistently."""
        if tear_partition is not None:
            if getattr(self._durable, "num_partitions", 1) <= 1:
                raise ValueError(
                    "tear_partition requires a partitioned durable log "
                    "(config.durability.partitions > 1)"
                )
            self._record("partition_wal_divergence")
            self._durable.tear_partition(tear_partition)
        if tear_tail:
            self._record("wal_torn_write")
            self._durable.tear_tail()
        if corrupt_snapshot and self._durable.snapshot_seqs() and (
            self._durable.can_survive_snapshot_corruption()
        ):
            # gated on survivability: the fault's contract is FALLBACK
            # (recovery anchors on an older generation or a full
            # segment chain), and a sole-anchor journal — a freshly
            # promoted standby's bootstrap checkpoint — has nothing to
            # fall back to; corrupting it would be injected data loss,
            # not a recoverable fault. Leader directories always pass
            # (their segment chains reach seq 0 until a full retention
            # window exists), so pre-existing seeds are unchanged.
            self._record("snapshot_corruption")
            self._durable.corrupt_latest_snapshot()
        armed = self.chaos_store.armed
        self.chaos_store.armed = False
        try:
            stats = self.harness.cold_restart()
        finally:
            self.chaos_store.armed = armed
        self.chaos_store.reset_for_recovery()
        self.process_restarts += 1
        self.recovery_stats.append(stats)
        if self._sharded is not None:
            self._sharded.audit = True
            self._crashed_workers.clear()  # the whole fleet restarted
        return stats

    def _inject_durability_faults(self) -> None:
        """Per-step durable-store fault draws (see FaultPlan). Every draw
        is guarded on rate > 0 AND on durability being configured, so
        pre-existing seeds (and durability-less runs) keep their exact
        draw sequences. The torn-tail / corrupted-snapshot draws are
        CONDITIONAL on a process crash firing — they are properties of
        the crash, not independent events."""
        plan = self.plan
        if self._durable is None:
            return
        if plan.process_crash_rate > 0 and plan.flip(
            plan.process_crash_rate
        ):
            self._record("process_crash")
            tear = plan.wal_torn_write_rate > 0 and plan.flip(
                plan.wal_torn_write_rate
            )
            corrupt = plan.snapshot_corruption_rate > 0 and plan.flip(
                plan.snapshot_corruption_rate
            )
            self.process_crash(tear_tail=tear, corrupt_snapshot=corrupt)
        if plan.disk_stall_rate > 0 and plan.flip(plan.disk_stall_rate):
            self._record("disk_stall")
            self._durable.stall(2 + plan.pick(4))
        # partition-scoped faults: rate-guarded AND capability-guarded
        # on the log actually being partitioned, so pre-existing seeds
        # (and single-WAL durability runs) keep their exact sequences
        num_parts = getattr(self._durable, "num_partitions", 1)
        if (
            plan.partition_divergence_rate > 0 and num_parts > 1
            and plan.flip(plan.partition_divergence_rate)
        ):
            # the crash IS the fault: divergence only matters when the
            # process dies with one partition's tail torn (recorded
            # inside process_crash)
            self.process_crash(tear_partition=plan.pick(num_parts))
        if (
            plan.partition_stall_rate > 0 and num_parts > 1
            and plan.flip(plan.partition_stall_rate)
        ):
            self._record("partition_disk_stall")
            self._durable.stall_partition(
                plan.pick(num_parts), 2 + plan.pick(4)
            )

    # -- HA-replication faults -------------------------------------------------
    @property
    def _standby(self):
        """The cluster's StandbyReplica when replication is configured
        and live, else None (replication faults and the per-step poll
        cadence are skipped entirely — rate-guarded AND
        capability-guarded, so pre-existing seeds replay identically
        either way)."""
        return getattr(self.harness.cluster, "standby", None)

    def standby_promotion(self, dual_leader: bool = False) -> dict:
        """Failover mid-plan: the leader process dies and the standby is
        promoted — manager rebuilt over the promoted store, kubelet
        relisted, a FRESH standby re-armed for the new leader (so later
        replication draws keep firing), the chaos proxy's informer
        memory cleared, exactly the process_crash re-derivation shape
        but through the replication path instead of a disk replay.

        dual_leader=True keeps the deposed leader's log ALIVE through
        the promotion and PROVES the fence: its next append must raise
        FencedAppend and its directory must be byte-unchanged — any
        other outcome fails the seed loudly (the acceptance criterion:
        a stale leader can never diverge the history)."""
        from ..cluster.durability import FencedAppend

        cluster = self.harness.cluster
        old_log = cluster.durability
        old_dirs = None
        if dual_leader:
            parts = getattr(old_log, "partitions", None) or [old_log]
            old_dirs = {
                p.dir: sorted(
                    (n, os.path.getsize(os.path.join(p.dir, n)))
                    for n in os.listdir(p.dir)
                )
                for p in parts
            }
        armed = self.chaos_store.armed
        self.chaos_store.armed = False
        try:
            # force: chaos models the leader plane being dead — the
            # coordination leases in the applied state are the DEAD
            # fleet's and would otherwise hold promotion hostage for a
            # lease duration of virtual time mid-storm (the honest
            # lease-expiry wait is pinned by tests/test_replication.py)
            stats = self.harness.promote_standby(force=True)
            cluster.rebuild_standby()
        finally:
            self.chaos_store.armed = armed
        self.chaos_store.reset_for_recovery()
        self.standby_promotions += 1
        self.recovery_stats.append(stats)
        if self._sharded is not None:
            self._sharded.audit = True
            self._crashed_workers.clear()  # the fleet restarted
        self._arm_defrag_audit()
        if dual_leader:
            # the deposed leader wakes up and tries to append: the term
            # fence must refuse before a byte moves
            ev = self.raw_store._events[-1] if self.raw_store._events \
                else None
            fenced = False
            if ev is not None:
                try:
                    old_log.commit(self.raw_store, ev)
                except FencedAppend:
                    fenced = True
                except Exception as exc:
                    # any other failure shape means the fence did NOT
                    # fire first (e.g. the append fell through to the
                    # closed segment) — report it as the fence breach
                    # it is, not an unrelated traceback
                    raise RuntimeError(
                        "dual-leader fence violated: the deposed "
                        "leader's append did not raise FencedAppend "
                        f"(got {type(exc).__name__}: {exc})"
                    ) from exc
            parts = getattr(old_log, "partitions", None) or [old_log]
            now_dirs = {
                p.dir: sorted(
                    (n, os.path.getsize(os.path.join(p.dir, n)))
                    for n in os.listdir(p.dir)
                )
                for p in parts
            }
            if ev is not None and not fenced:
                raise RuntimeError(
                    "dual-leader fence violated: the deposed leader's "
                    "append was NOT refused"
                )
            if now_dirs != old_dirs:
                raise RuntimeError(
                    "dual-leader fence violated: the deposed leader's "
                    "WAL directory changed after promotion"
                )
        return stats

    def _inject_replication_faults(self) -> None:
        """Per-step HA-replication fault draws (see FaultPlan): tailer
        stalls, mid-plan failover, the dual-leader fence proof, standby
        crash + re-seed. Every draw is guarded on rate > 0 AND on a
        live standby being configured."""
        plan = self.plan
        if self._standby is None:
            return
        if plan.replication_stall_rate > 0 and plan.flip(
            plan.replication_stall_rate
        ):
            self._record("replication_stall")
            self._standby.stall_steps += 2 + plan.pick(4)
        if plan.standby_crash_rate > 0 and plan.flip(
            plan.standby_crash_rate
        ):
            self._record("standby_crash")
            self.harness.cluster.rebuild_standby()
        if plan.dual_leader_rate > 0 and plan.flip(plan.dual_leader_rate):
            self._record("dual_leader")
            self.standby_promotion(dual_leader=True)
        if plan.standby_promotion_rate > 0 and plan.flip(
            plan.standby_promotion_rate
        ):
            self._record("standby_promotion")
            self.standby_promotion()

    def _repair_shards(self) -> None:
        """Disarm-time repair: crashed workers revive (fresh process,
        replay + relist) and frozen map views thaw — the recovered
        fixpoint is measured against a whole fleet, like every other
        fault class."""
        sharded = self._sharded
        if sharded is None:
            return
        for idx in sorted(self._crashed_workers):
            sharded.revive_worker(idx)
        self._crashed_workers.clear()
        for w in sharded.workers:
            w.stale_map_hold = 0

    def _tick_node_faults(self) -> None:
        """End-of-step flap timers: expired flaps resume heartbeating
        (the node then rides the monitor's stable-ready window back in)."""
        for name in sorted(self._flapping):
            self._flapping[name] -= 1
            if self._flapping[name] <= 0:
                del self._flapping[name]
                self.harness.cluster.recover_node(name)

    def _repair_infrastructure(self) -> None:
        """Disarm-time repair: every injected node fault heals (flaps
        recover, heartbeats resume, outage domains return, drained nodes
        uncordon) — the convergence contract measures the recovered
        fixpoint against restored infrastructure, exactly like the store
        faults stopping."""
        from ..cluster.inventory import RACK_KEY

        cluster = self.harness.cluster
        for name in sorted(self._flapping):
            cluster.recover_node(name)
        self._flapping.clear()
        for name in sorted(self._hb_lost):
            self.kubelet.restore_heartbeat(name)
        self._hb_lost.clear()
        for dom in self._outage_domains:
            cluster.recover_domain(RACK_KEY, dom)
        self._outage_domains = []
        for name in self._drained_nodes:
            cluster.uncordon(name)
        self._drained_nodes = []
        for ns, name in self._skew_workloads:
            # the skew load leaves with the faults: the convergence
            # contract measures the recovered fixpoint against the
            # fault-free workload, and the injected PCS cascade-delete
            # (finalizers -> pods -> gangs) during the recovery settle
            if self.raw_store.peek(PodCliqueSet.KIND, ns, name) is not None:
                self.raw_store.delete(PodCliqueSet.KIND, ns, name)
        self._skew_workloads = []
        for ns, name in self._storm_workloads:
            # storm load leaves with the faults, exactly like skew load
            if self.raw_store.peek(PodCliqueSet.KIND, ns, name) is not None:
                self.raw_store.delete(PodCliqueSet.KIND, ns, name)
        self._storm_workloads = []
        stream = self._stream
        if stream is not None:
            # any in-flight arrival stall clears with the faults;
            # parked waiters admit (or deadline-shed) on the next rounds
            stream.clear_stall()

    def run_chaos(self) -> None:
        """The chaos phase: `plan.chaos_steps` driver steps of manager
        rounds + kubelet ticks with faults arriving, then disarm, repair
        the infrastructure, and settle to the recovered fixpoint
        (`settle_recovered`)."""
        plan = self.plan
        h = self.harness
        self.chaos_store.armed = True
        try:
            for _ in range(plan.chaos_steps):
                if plan.flip(plan.manager_crash_rate):
                    self._record("manager_crash")
                    self.restart_manager()
                if plan.flip(plan.clock_jump_rate):
                    self._record("clock_jump")
                    h.clock.advance(
                        plan.uniform(1.0, plan.clock_jump_max_seconds)
                    )
                if plan.flip(plan.compaction_rate):
                    self.chaos_store.force_compaction()
                self._inject_node_faults()
                # guarded on rate > 0 BEFORE any draw: pre-existing seeds
                # (rate 0 by default) keep their exact draw sequence and
                # verified convergence
                if plan.tenant_skew_rate > 0 and plan.flip(
                    plan.tenant_skew_rate
                ):
                    self._record("tenant_skew")
                    self._inject_tenant_skew()
                self._inject_shard_faults()
                self._inject_durability_faults()
                self._inject_replication_faults()
                self._inject_serving_faults()
                self._inject_defrag_faults()
                self._inject_stream_faults()
                stalled = plan.flip(plan.kubelet_stall_rate)
                if stalled:
                    self._record("kubelet_stall")
                try:
                    h.manager.run_once()
                except ManagerCrash:
                    self.restart_manager()
                if not stalled:
                    h.kubelet.tick()
                if self._serving is not None:
                    # the HPA sync loop runs through the storm on its
                    # config cadence (no-op without serving, so
                    # pre-existing seeds' sequences are untouched)
                    self._chaos_autoscale()
                if self._defrag is not None:
                    # the defrag sync loop likewise keeps its cadence
                    # through the storm (no-op without defrag)
                    self._chaos_defrag()
                if self._slo is not None:
                    # SLO evaluation likewise sweeps through the storm —
                    # alerts must FIRE during the fault, not at the
                    # postmortem (no-op without config.slo)
                    self._chaos_slo()
                self._tick_node_faults()
                if self._durable is not None:
                    self._durable.tick_stall()
                standby = self._standby
                if standby is not None:
                    # the async tailing cadence runs through the storm
                    # (a semi-sync standby is already shipped per
                    # commit; the poll is then a no-op) — no RNG draws,
                    # so pre-existing seeds' sequences are untouched
                    standby.poll()
                    standby.tick_stall()
                if self._serving is not None:
                    self.harness.cluster.pod_metrics.tick_dropout()
                # give backoff requeues a chance to fire mid-chaos
                h.clock.advance(plan.step_seconds)
        finally:
            self.chaos_store.armed = False
            self._repair_infrastructure()
            self._repair_shards()
            if self._durable is not None:
                # disarm-time repair, like every other fault class: the
                # disk recovers, deferred snapshot work may resume
                self._durable.stalled_steps = 0
            if self._standby is not None:
                # the standby's stall clears with the faults and it
                # catches up to the leader's committed head — a settled
                # chaos run leaves replication converged, not lagging
                self._standby.stall_steps = 0
                self._standby.poll()
            if self._serving is not None:
                # injected spikes leave with the faults; the metrics
                # pipeline resumes reporting immediately
                self._serving.clear_injected()
                self.harness.cluster.pod_metrics.dropout_steps = 0
        self.settle_recovered()

    def settle_recovered(self, max_iters: int = 64) -> None:
        """Post-fault convergence: settle, then fire every near-term
        requeue (error backoff chains, breaker cool-downs, scheduler
        retries) by advancing the virtual clock requeue-by-requeue.
        Long-range timers (gang termination hours out) are left pending —
        a fault-free run leaves the identical timers.

        A failed settle (wedged seed) auto-dumps the flight recorder to
        `trace_path` when one was configured, then re-raises — the
        postmortem artifact survives the crash."""
        try:
            self._settle_recovered(max_iters)
        except Exception:
            if self.trace_path:
                self.dump_flight(self.trace_path)
            raise

    def _settle_recovered(self, max_iters: int) -> None:
        h = self.harness
        horizon = h.config.controllers.error_backoff_max_seconds * 2 + 1
        h.settle()
        self._drain_serving()
        for _ in range(max_iters):
            nxt = h.manager.next_requeue_at()
            if nxt is None or nxt - h.clock.now() > horizon:
                return
            h.advance(nxt - h.clock.now() + 1e-3)
        raise RuntimeError(
            "chaos recovery did not drain its retry timers in "
            f"{max_iters} hops (errors: {h.manager.errors[-3:]})"
        )

    # -- postmortem artifact -------------------------------------------------
    def wedged_summary(self) -> dict[str, Any]:
        """Name what is stuck RIGHT NOW, from the raw (fault-free) store:
        gangs that never reached Scheduled, pods that never bound or never
        went ready, cliques below their replica count — plus the manager's
        recorded errors, pending work, and the seed's fault log. This is
        the `wedged` section of the flight-recorder dump: a postmortem
        opens with the stuck object's name, not a span soup."""
        from ..api.meta import get_condition
        from ..api.podgang import PodGang, PodGangConditionType

        decisions = self.harness.cluster.decisions
        tracer = self.harness.cluster.tracer
        sharded = self._sharded
        unscheduled = []
        for g in self.raw_store.scan(PodGang.KIND):
            cond = get_condition(
                g.status.conditions, PodGangConditionType.SCHEDULED.value
            )
            if cond is None or cond.status != "True":
                entry = {
                    "kind": g.KIND,
                    "name": f"{g.metadata.namespace}/{g.metadata.name}",
                    "phase": g.status.phase.value,
                    "reason": cond.reason if cond is not None else None,
                    "message": cond.message if cond is not None else None,
                    # the decision audit of the wedged gang (reason code,
                    # elimination funnel, preemption attempts) rides next
                    # to the flight-recorder spans — the postmortem names
                    # WHY, not just WHO (observability/explain.py)
                    "explain": decisions.explain(
                        g.metadata.namespace, g.metadata.name
                    ),
                }
                if tracer.enabled:
                    # the wedged gang's reconstructed (partial) critical
                    # path next to its explain record: how long it has
                    # been held/queued and behind which hop
                    # (observability/causal.py)
                    entry["critical_path"] = tracer.gang_path(
                        f"{g.metadata.namespace}/{g.metadata.name}",
                        created_at=g.metadata.creation_timestamp,
                        now=self.clock.now(),
                    )
                if sharded is not None:
                    # the postmortem names the SHARD, not just the gang:
                    # its own key's owner plus the scheduler singleton's
                    # (the gang binds wherever "schedule" is owned)
                    s, owner = sharded.shard_owner(
                        g.metadata.namespace, g.metadata.name
                    )
                    entry["shard"] = s
                    entry["shard_owner"] = owner
                unscheduled.append(entry)
        stuck_pods = []
        for p in self.raw_store.scan(Pod.KIND):
            if p.metadata.deletion_timestamp is not None:
                continue
            if p.status.phase.value in _TERMINAL:
                continue
            if not p.node_name or not p.status.ready:
                stuck_pods.append({
                    "kind": p.KIND,
                    "name": f"{p.metadata.namespace}/{p.metadata.name}",
                    "bound": bool(p.node_name),
                    "phase": p.status.phase.value,
                    "gates": list(p.spec.scheduling_gates),
                })
        lagging_cliques = []
        for c in self.raw_store.scan(PodClique.KIND):
            if c.status.ready_replicas < c.spec.replicas:
                lagging_cliques.append({
                    "kind": c.KIND,
                    "name": f"{c.metadata.namespace}/{c.metadata.name}",
                    "replicas": c.spec.replicas,
                    "ready": c.status.ready_replicas,
                    "errors": list(c.status.last_errors),
                })
        manager = self.harness.manager
        sharding = None
        if sharded is not None:
            sharding = sharded.debug_state()
            sharding["scheduler_owner"] = sharded.shard_owner(
                "", "schedule"
            )[1]
        return {
            "seed": self.plan.seed,
            "virtual_clock": self.clock.now(),
            **({"sharding": sharding} if sharding is not None else {}),
            "unscheduled_gangs": unscheduled,
            "stuck_pods": stuck_pods,
            "lagging_cliques": lagging_cliques,
            "workqueue": manager.workqueue_snapshot(),
            "manager_errors": [
                {"controller": c, "namespace": r.namespace, "name": r.name,
                 "error": msg}
                for c, r, msg in manager.errors[-32:]
            ],
            "manager_restarts": self.manager_restarts,
            "process_restarts": self.process_restarts,
            "standby_promotions": self.standby_promotions,
            # the durable-recovery audit trail: per crash, the snapshot
            # it recovered from, the WAL replay position it stopped at
            # (recovered_last_seq), torn/fallback outcomes — a failed
            # seed's postmortem names WHERE replay landed, not just that
            # a recovery happened
            "recoveries": list(self.recovery_stats),
            "faults_injected": dict(sorted(self.plan.counts.items())),
            # the SLO scorecard rides every wedged postmortem when the
            # engine is on: which budgets the fault burned and which
            # alerts were live when the run wedged
            **({"slo_scorecard": self.harness.slo_scorecard()}
               if self._slo is not None else {}),
        }

    def dump_flight(self, path: str | None = None) -> dict[str, Any]:
        """The chaos postmortem: flight-recorder ring (recent spans +
        reconcile errors + events) with the wedged-object summary on top.
        Writes JSON to `path` when given; always returns the dict. Convert
        to a Perfetto-loadable Chrome trace with
        `python -m grove_tpu_torch.observability.trace <path>`."""
        import json

        dump = self.flight.dump(wedged=self.wedged_summary())
        if path:
            with open(path, "w") as fh:
                json.dump(dump, fh)
                fh.write("\n")
        return dump

    def dump_explain(self, path: str | None = None) -> dict[str, Any] | None:
        """Decision records of every gang UNSCHEDULED at settle, or None
        when all gangs scheduled. Written by scripts/chaos_sweep.py
        --explain-dir alongside the flight postmortems; render with
        `python -m grove_tpu_torch.observability.explain <path>`."""
        import json

        from ..api.meta import get_condition
        from ..api.podgang import PodGang, PodGangConditionType

        decisions = self.harness.cluster.decisions
        out: dict[str, Any] = {}
        for g in self.raw_store.scan(PodGang.KIND):
            cond = get_condition(
                g.status.conditions, PodGangConditionType.SCHEDULED.value
            )
            if cond is not None and cond.status == "True":
                continue
            key = f"{g.metadata.namespace}/{g.metadata.name}"
            out[key] = decisions.explain(
                g.metadata.namespace, g.metadata.name
            ) or {"gang": key, "records": []}
        if not out:
            return None
        if path:
            with open(path, "w") as fh:
                json.dump(out, fh)
                fh.write("\n")
        return out
