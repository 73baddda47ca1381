"""Harness: cluster + all controllers + kubelet wired into one loop.

The user/test entry point equivalent to running the operator binary against
a cluster (operator/cmd/main.go): register the three reconcilers + the gang
scheduler on the manager, then settle() drives controllers and kubelet to a
fixpoint. advance() moves the virtual clock (firing requeues like the gang
termination timer) and re-settles.

The counterpart of grove_tpu/controller/harness.py. The gang scheduler's
engine solves on the CUDA card unless the harness is built with
device="cpu". The sharded control plane (`config.controllers.shards > 1`)
builds one `GangScheduler` a worker, each on that device; recovery from
durable state (`recover`, `cold_restart`) and the standby failover
(`promote_standby`) rebuild every manager, and with them every engine,
there too, after releasing the old ones. A federation member
(`adopt_workloads`) is such a harness, and the SLO engine (`slo_sweep`,
`maybe_slo_sweep`, `slo_scorecard`) reads the cluster's metrics on the
host.
"""

from __future__ import annotations

from itertools import count as _count

from ..api.config import OperatorConfig, load_operator_config
from ..api.types import Node, PodCliqueSet
from ..cluster.cluster import Cluster
from .podclique import PodCliqueReconciler
from .podcliqueset import PodCliqueSetReconciler
from .podcliquescalinggroup import PCSGReconciler
from .runtime import ControllerManager
from .scheduler import GangScheduler

_replica_counter = _count()


def _expire_coordination_objects(store, config) -> None:
    """Delete a crashed process's coordination objects: every Lease
    outside kube-node-lease (leader election, shard workers, shard
    coordinator) plus the ShardMap. Node heartbeat leases survive — the
    kubelet fleet did not crash. The deletions go through the store like
    any write — journaled, so a second crash during recovery replays
    them too. Module-level (not a Harness method) because Harness.recover
    must run it BEFORE the managers are built."""
    from ..cluster.nodehealth import NODE_LEASE_NAMESPACE
    from .leaderelection import Lease
    from .sharding import ShardMap

    doomed = [
        (Lease.KIND, o.metadata.namespace, o.metadata.name)
        for o in store.scan(Lease.KIND)
        if o.metadata.namespace != NODE_LEASE_NAMESPACE
    ] + [
        (ShardMap.KIND, o.metadata.namespace, o.metadata.name)
        for o in store.scan(ShardMap.KIND)
    ]
    with store.impersonate(config.authorization.operator_identity):
        for kind, ns, name in doomed:
            store.delete(kind, ns, name)


class Harness:
    def __init__(self, nodes: list[Node] | None = None,
                 cluster: Cluster | None = None, engine_cls=None,
                 config: OperatorConfig | dict | None = None,
                 cell_name: str | None = None, device=None):
        """config: an OperatorConfig, or a plain dict decoded+validated
        through api.config.load_operator_config (the --config YAML analog,
        cmd/cli/cli.go:89-106). Ignored when an existing cluster (which owns
        its config) is passed.

        cell_name: the member-cluster identity when this harness is one
        cell of a federation (federation/). Passed only by the
        coordinator, gated through `accepts_kwarg` so single-cluster
        callers and older harness subclasses stay untouched.

        device: where the gang scheduler's engine solves. None is the CUDA
        card (the scheduler raises where there is none, so the harness is
        never built); "cpu" runs the kernels' plain versions."""
        if isinstance(config, dict):
            config = load_operator_config(config)
        self.cell_name = cell_name
        self.device = device
        self.cluster = cluster or Cluster(nodes=nodes, config=config)
        self.config = self.cluster.config
        self.store = self.cluster.store
        self.clock = self.cluster.clock
        self.kubelet = self.cluster.kubelet
        elector = None
        if self.config.leader_election.enabled:
            from .leaderelection import LeaderElector

            le = self.config.leader_election
            # each manager instance is its own replica identity
            elector = LeaderElector(
                self.store,
                identity=(
                    f"{self.config.authorization.operator_identity}"
                    f"#{next(_replica_counter)}"
                ),
                lease_name=le.lease_name,
                namespace=le.lease_namespace,
                lease_duration_seconds=le.lease_duration_seconds,
            )
        self.elector = elector
        self._engine_cls = engine_cls
        self._build_manager()

    def _make_manager(self, name: str, elector=None):
        """Build ONE fully registered ControllerManager + reconciler set
        over the shared store — the single-replica manager and every
        sharded worker replica are each one of these. Returns
        (manager, components) with the named reconciler instances."""
        cc = self.config.controllers
        manager = ControllerManager(
            self.store,
            identity=self.config.authorization.operator_identity,
            error_backoff_base_seconds=cc.error_backoff_base_seconds,
            error_backoff_max_seconds=cc.error_backoff_max_seconds,
            error_retry_budget=cc.error_retry_budget,
            logger=self.cluster.logger.with_name(name),
            metrics=self.cluster.metrics,
            elector=elector,
            # re-read on every (re)build: the chaos harness enables
            # tracing after Cluster construction, and a crash-restarted
            # manager must keep feeding the same flight recorder
            tracer=self.cluster.tracer,
            round_write_batching=cc.round_write_batching,
        )
        manager.register(
            PodCliqueSetReconciler(self.store, config=self.config)
        )
        manager.register(PCSGReconciler(self.store))
        manager.register(
            PodCliqueReconciler(
                self.store, retry_seconds=cc.sync_retry_interval_seconds
            )
        )
        kwargs = {"engine_cls": self._engine_cls} if self._engine_cls else {}
        scheduler = GangScheduler(self.cluster, device=self.device, **kwargs)
        manager.register(scheduler)
        from .autoscaler import Autoscaler

        autoscaler = Autoscaler(self.cluster)
        manager.register(autoscaler)
        # the defragmenter is timer-driven (Harness.maybe_defrag), not
        # watch-driven, so it is not registered with the manager; it is
        # built next to the scheduler because the what-ifs ride that
        # scheduler's engine (device-resident state) and migrations
        # execute through its ticket/eviction machinery
        from .defrag import DefragController

        defrag = DefragController(self.cluster, scheduler)
        # node lifecycle last: its writes (Ready flips, eviction sweeps,
        # drain evictions) land as events for the next round's workload
        # controllers, and a crash-restart rebuilds its stabilization
        # state conservatively like every other in-memory cache
        node_monitor = None
        if self.config.controllers.node_monitor_enabled:
            from .nodemonitor import NodeMonitor

            node_monitor = NodeMonitor(self.cluster)
            manager.register(node_monitor)
        return manager, {
            "scheduler": scheduler,
            "autoscaler": autoscaler,
            "defrag": defrag,
            "node_monitor": node_monitor,
        }

    def _build_manager(self) -> None:
        """(Re)build the manager + a fresh set of reconcilers over the
        SAME store. Called once from __init__ — and again by the chaos
        harness to model an operator process crash-restart: a new manager
        starts with event cursor 0 (replaying, or relisting past a
        compaction horizon) and reconcilers rebuild every in-memory cache
        from the store, exactly like a restarted operator binary.

        With controllers.shards > 1 this builds the horizontally sharded
        control plane instead (controller/sharding.py): N full worker
        replicas behind a leader-owned shard map; the harness-facing
        `manager` surface stays the same. The named component attributes
        (`scheduler`/`autoscaler`/`node_monitor`) then point at the
        worker that owns each singleton's shard at bootstrap — good for
        dumps and drivers; per-worker instances live on
        `manager.workers[i].components`.

        The managers this replaces are released first: their engines'
        resident state, pinned buffers and graphs go with them, so a
        crash-restart holds one set of engines on the card, not two."""
        self.release_engines()
        cc = self.config.controllers
        if cc.shards <= 1:
            self.manager, comps = self._make_manager(
                "manager", elector=self.elector
            )
            self.scheduler = comps["scheduler"]
            self.autoscaler = comps["autoscaler"]
            self.defrag = comps["defrag"]
            self.node_monitor = comps["node_monitor"]
            return
        from .sharding import ShardedManager

        def build_worker(worker):
            return self._make_manager(f"manager.{worker.identity}")

        self.manager = ShardedManager(
            self.store,
            num_workers=cc.shards,
            lease_duration_seconds=cc.shard_lease_duration_seconds,
            build_worker=build_worker,
            identity=self.config.authorization.operator_identity,
            metrics=self.cluster.metrics,
            logger=self.cluster.logger.with_name("sharded-manager"),
            tracer=self.cluster.tracer,
            error_backoff_base_seconds=cc.error_backoff_base_seconds,
            error_backoff_max_seconds=cc.error_backoff_max_seconds,
            error_retry_budget=cc.error_retry_budget,
        )
        # shared-cache prefetch (see ShardedManager.prefetch): the
        # cluster's incremental usage accounting + topology snapshot are
        # informer-style watch state; warming them between the workload
        # passes and the scheduler's step keeps the shared-cache rebuild
        # off the solve's critical path without changing what the
        # scheduler reads (the cache is keyed on store state)
        self.manager.prefetch = self.cluster.topology_snapshot
        # the scheduler singleton's bootstrap owner (ownership can move
        # on failover; the sharding debug section tracks the live map)
        _shard, owner_id = self.manager.shard_owner("", "schedule")
        owner = next(
            (w for w in self.manager.workers if w.identity == owner_id),
            self.manager.workers[0],
        )
        self.scheduler = owner.components["scheduler"]
        self.autoscaler = owner.components["autoscaler"]
        # the defragmenter rides the scheduler-owning worker's engine
        self.defrag = owner.components["defrag"]
        self.node_monitor = owner.components["node_monitor"]

    def schedulers(self) -> list:
        """Every GangScheduler of the live manager(s): one, or one per
        sharded worker (each with its own engine on the device)."""
        manager = getattr(self, "manager", None)
        if manager is None:
            return []
        workers = getattr(manager, "workers", None)
        if workers is None:
            return [self.scheduler]
        return [w.components["scheduler"] for w in workers]

    def release_engines(self) -> None:
        """Release the engines of this harness's managers: before a
        crash-restart, a cold restart or a recovery replaces them, and
        when a process is shut down. The old schedulers are dropped with
        their managers, and their engines' device state must not outlive
        them (each engine keeps a resident free state, pinned staging
        buffers and a graph pool on the card). A released scheduler solves
        again only by building a new engine."""
        for scheduler in self.schedulers():
            scheduler.release()

    @classmethod
    def recover(cls, config: OperatorConfig | dict, engine_cls=None,
                device=None) -> "Harness":
        """Boot a GENUINELY NEW process from the durable state at
        `config.durability.wal_dir` — the disaster-recovery path when
        the crashed predecessor's process is gone (cold_restart covers
        the in-process crash model). The store is rebuilt bit-identical
        from disk (latest valid snapshot + WAL replay, torn-tail
        tolerant), a boot checkpoint seals the pre-crash tail, the dead
        process's coordination leases and ShardMap are expired, and the
        fresh manager/scheduler/kubelet derive their soft state exactly
        like any cold restart; settle() then reaches the pre-crash
        fixpoint. Journaling RESUMES into the same wal_dir. `device` is
        where the new process's engines solve (None = the CUDA card)."""
        if isinstance(config, dict):
            config = load_operator_config(config)
        cluster = Cluster.from_durable(config)
        # expire BEFORE the managers are built, mirroring cold_restart's
        # expire -> rebuild order: a ShardedManager constructed against
        # the dead fleet's ShardMap would adopt its shard width instead
        # of the (possibly changed) config's
        _expire_coordination_objects(cluster.store, cluster.config)
        return cls(cluster=cluster, engine_cls=engine_cls, device=device)

    def cold_restart(self) -> dict:
        """Whole-process crash-restart from durable state (requires
        config.durability.wal_dir): the live store is dropped and
        recovered from disk (latest valid snapshot + WAL replay —
        Cluster.cold_restart), then every piece of soft state is
        re-derived the way a genuinely fresh process would derive it:

          - control-plane coordination EXPIRES: the dead process's
            leader-election lease, shard worker/coordinator leases and
            the ShardMap are deleted, so the rebuilt manager re-elects
            and rebuilds the shard map from scratch (node heartbeat
            leases in kube-node-lease are infrastructure state and
            survive — the kubelet fleet did not crash);
          - a brand-new manager + reconciler set (cursor 0: replay, or
            relist past the compaction horizon), fresh scheduler with
            reservations reconstructed from bound pods, fresh engine on
            the harness's device (the old engines released; device state
            rebuilt — the free-delta journal was reset by
            Cluster.invalidate_soft_state);
          - the kubelet relists against the recovered store.

        After settle() the control plane reaches the same fixpoint a
        never-crashed run holds. Returns the recovery stats dict."""
        stats = self.cluster.cold_restart()
        self._expire_coordination()
        self._build_manager()
        self.kubelet.reset_for_recovery()
        return stats

    def _expire_coordination(self) -> None:
        _expire_coordination_objects(self.store, self.config)

    def promote_standby(self, catch_up: bool = True,
                        force: bool = False) -> dict:
        """Failover to the log-shipping standby (requires
        config.replication.enabled) — the seconds-scale alternative to
        cold_restart()'s history-proportional disk replay:

          - the LEASE FENCE runs first (the sharded plane's leases): a fresh
            coordination lease in the standby's applied state — leader
            election, shard workers, the coordinator — means the leader
            plane is still renewing, and promotion refuses with
            PromotionRefused (`grove_store_promotions_total{outcome=
            "fence-refused"}`) rather than opening a dual-leader window
            on purpose. force=True overrides when the operator knows the
            leader is gone (the term fence still guarantees a surviving
            stale leader cannot diverge the history);
          - the standby seals its applied prefix behind a fresh
            checkpoint, bumps the leadership term (stamped into every
            subsequent WAL record) and becomes the store — transplanted
            in place so every runtime reference survives
            (Cluster.promote_standby);
          - the dead leader's coordination leases and ShardMap expire,
            the manager/scheduler rebuild (the sharded control plane
            re-points at the promoted store), and the kubelet relists —
            exactly the cold_restart re-derivation. The deposed
            managers' engines are released first and the new ones built
            on the harness's device (`_build_manager`).

        catch_up=False models TOTAL leader loss (host and disk): the
        standby serves only its already-applied prefix — zero loss under
        semi-sync, at most the lag window under async. After settle()
        the control plane reaches the same fixpoint (tests/
        test_torch_replication.py holds it in lockstep with the
        reference; chaos arms it as the standby_promotion fault).
        Returns the promotion stats."""
        cluster = self.cluster
        if cluster.standby is None:
            raise RuntimeError(
                "promote_standby requires a live standby "
                "(config.replication.enabled)"
            )
        if not force:
            from ..cluster.replication import PromotionRefused

            reason = cluster.standby.leader_lease_blocks(self.clock.now())
            if reason is not None:
                cluster.metrics.counter(
                    "grove_store_promotions_total",
                    "standby promotions by outcome",
                ).inc(outcome="fence-refused")
                cluster.metrics.counter(
                    "grove_store_recoveries_total",
                    "store recoveries from durable state by outcome",
                ).inc(outcome="fence-refused")
                raise PromotionRefused(reason)
        stats = cluster.promote_standby(catch_up=catch_up)
        self._expire_coordination()
        self._build_manager()
        self.kubelet.reset_for_recovery()
        return stats

    def autoscale_sweep(self) -> bool:
        """The HPA sweep ALONE, no settle — the chaos loop interleaves
        it with faulted manager rounds (a settle mid-storm could blow the
        round budget on transient faults). The sweep mutates managed
        scale targets, so it runs as the operator identity like any
        reconcile — and, under HA, only on the replica holding the lease
        (a standby sweeping would be split-brain). Returns whether the
        sweep ran."""
        if self.elector is not None:
            with self.store.impersonate(
                self.manager.identity or self.store.actor
            ):
                if not self.elector.try_acquire():
                    return False  # standing by: the leader sweeps
        with self.store.impersonate(self.manager.identity or self.store.actor):
            self.autoscaler.run_all()
        return True

    def autoscale(self) -> None:
        """One periodic HPA sweep + settle (the HPA sync interval)."""
        self.autoscale_sweep()
        self.settle()

    def maybe_autoscale(self, settle: bool = True) -> bool:
        """The periodic HPA sync: sweep (+ settle) when at least
        `autoscaler.sync_interval_seconds` of virtual time passed since
        the last sweep. Serving loops (bench.py --diurnal, the chaos
        loop) call this every step so the HPA cadence is governed by the
        validated config, not by the loop's step size. Returns whether
        a sweep ran — an HA standby's skipped sweep returns False and
        pays no settle. settle=False leaves convergence to the caller's
        own manager rounds (the chaos storm's posture)."""
        if (
            self.clock.now() - self.autoscaler.last_sync
            < self.config.autoscaler.sync_interval_seconds
        ):
            return False
        if not self.autoscale_sweep():
            return False  # standing by: the leader sweeps
        if settle:
            self.settle()
        return True

    def defrag_sweep(self, storm: bool = False):
        """One defragmentation sweep, no settle (the chaos loop
        interleaves it with faulted manager rounds). Runs as the
        operator identity like any reconcile and, under HA, only on the
        leader. Returns the sweep stats dict, or None when defrag is
        disabled or this replica is standing by."""
        if not self.config.defrag.enabled:
            return None
        if self.elector is not None:
            with self.store.impersonate(
                self.manager.identity or self.store.actor
            ):
                if not self.elector.try_acquire():
                    return None  # standing by: the leader sweeps
        with self.store.impersonate(
            self.manager.identity or self.store.actor
        ):
            return self.defrag.sweep(storm=storm)

    def maybe_defrag(self, settle: bool = True) -> bool:
        """The periodic defrag sync: sweep (+ settle, which re-places
        evicted gangs onto their held destinations) when at least
        `defrag.sync_interval_seconds` of virtual time passed since the
        last sweep. Long-run loops (bench.py --defrag, the chaos
        loop) call this every step so the cadence is governed by the
        validated config, not the loop's step size."""
        cfg = self.config.defrag
        if not cfg.enabled:
            return False
        stream = getattr(self.scheduler, "stream", None)
        if stream is not None and stream.defrag_suspended:
            # brownout L2 (the streaming front): defrag evictions feed
            # the very backlog the stream is shedding — hold sweeps (and
            # their cadence clock) until the queue drains below the
            # ladder
            return False
        if (
            self.clock.now() - self.defrag.last_sync
            < cfg.sync_interval_seconds
        ):
            return False
        if self.defrag_sweep() is None:
            return False
        if settle:
            self.settle()
        return True

    def slo_sweep(self, store=None):
        """One SLO evaluation sweep, no settle (evaluation-only: the
        only store writes are advisory alert Events). Runs as the
        operator identity and, under HA, only on the leader. `store`
        lets the chaos driver route Events through the raw store so
        sweeps consume zero fault-plan draws (seed replay stays
        bit-identical with SLO evaluation on or off). Returns the sweep
        stats dict, or None when disabled or standing by."""
        engine = getattr(self.cluster, "slo", None)
        if engine is None:
            return None
        if self.elector is not None:
            with self.store.impersonate(
                self.manager.identity or self.store.actor
            ):
                if not self.elector.try_acquire():
                    return None  # standing by: the leader sweeps
        with self.store.impersonate(
            self.manager.identity or self.store.actor
        ):
            return engine.sweep(
                store if store is not None else self.store,
                tenancy=self.cluster.tenancy,
            )

    def maybe_slo_sweep(self, store=None) -> bool:
        """The periodic SLO sync (the maybe_autoscale/maybe_defrag
        cadence shape): sweep when at least `slo.sync_interval_seconds`
        of virtual time passed since the last one. Long-run drivers
        (bench, the chaos loop) call this every step so the cadence is
        governed by the validated config, not the driver's step size."""
        engine = getattr(self.cluster, "slo", None)
        if engine is None:
            return False
        if (
            self.clock.now() - engine.last_sync
            < self.config.slo.sync_interval_seconds
        ):
            return False
        return self.slo_sweep(store=store) is not None

    def slo_scorecard(self) -> dict:
        """The per-tenant SLO scorecard JSON (ROADMAP item 3's artifact;
        also surfaced via debug_dump()["slo"], the gRPC Debug service,
        and chaos wedged postmortems)."""
        engine = getattr(self.cluster, "slo", None)
        if engine is None:
            return {"enabled": False}
        return engine.scorecard()

    def apply(self, pcs: PodCliqueSet):
        return self.store.create(pcs)

    def adopt_workloads(self, sets: list[PodCliqueSet],
                        source: str | None = None) -> list[PodCliqueSet]:
        """Federation drain entry point: adopt PodCliqueSets recovered
        from ANOTHER cluster's durable history. Each set is re-created
        here with a fresh ObjectMeta carrying only the portable identity
        (name/namespace/labels/annotations) — uid, resource_version and
        timestamps belong to the dead store's history, and its
        deletion_timestamp/finalizers/owner_references must not leak
        into a store that never saw the owners. The create rides the
        normal admission + journal path, so an adopted gang is committed
        here exactly like a user-applied one; the next settle() places
        it through the ordinary scheduler/eviction machinery."""
        from ..api.meta import ObjectMeta
        from ..cluster.store import clone

        out = []
        for pcs in sets:
            annotations = dict(pcs.metadata.annotations or {})
            if source:
                annotations["grove.io/drained-from"] = source
            fresh = PodCliqueSet(
                metadata=ObjectMeta(
                    name=pcs.metadata.name,
                    namespace=pcs.metadata.namespace,
                    labels=dict(pcs.metadata.labels or {}),
                    annotations=annotations,
                ),
                spec=clone(pcs.spec),
            )
            out.append(self.store.create(fresh))
        return out

    def settle(self, max_rounds: int | None = None) -> None:
        """Controllers + kubelet to fixpoint: reconcile until quiescent,
        tick the kubelet, repeat until neither produces changes."""
        max_rounds = max_rounds or self.config.controllers.harness_max_rounds
        inner = self.config.controllers.settle_max_rounds
        with self.cluster.tracer.span("harness.settle"):
            for _ in range(max_rounds):
                self.manager.settle(inner)
                if self.kubelet.tick() == 0:
                    # one more manager pass in case final kubelet writes
                    # queued
                    self.manager.settle(inner)
                    if self.kubelet.tick() == 0:
                        return
            raise RuntimeError("harness did not settle")

    def compact_events(self) -> int:
        """Long-run hygiene: drop store events every live consumer has
        already drained — the manager, the kubelet, and the cluster's
        incremental usage accounting each keep a watch cursor, and the
        safe horizon is the MINIMUM of them (compacting past any one
        would force it into a relist). Steady-state simulations (the
        churn benchmark, long soaks) call this periodically so the
        append-only log stays bounded; one-shot tests that inspect
        history simply don't. Returns the number of events dropped."""
        horizon = min(
            self.manager.event_cursor,
            self.kubelet.event_cursor,
            self.cluster.usage_cursor,
        )
        return self.store.compact_events(horizon)

    def debug_dump(self) -> dict:
        """Runtime introspection (the pprof-dump analog; SURVEY §5):
        per-controller reconcile stats + queue depths + store counts +
        scheduler/engine cache state as one JSON-able dict. See
        observability/debug.py and docs/operations.md."""
        from ..observability.debug import harness_dump

        return harness_dump(self)

    def advance(self, seconds: float) -> None:
        """Advance the virtual clock past timers (gang termination,
        scheduler retries) and settle."""
        self.clock.advance(seconds)
        self.settle()
