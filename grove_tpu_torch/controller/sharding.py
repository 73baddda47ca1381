"""Horizontally sharded control plane: N manager replicas, one store.

The control plane's bottleneck is the HOST, not the solver: nearly all
of a settle's wall is single-replica Python reconcile work — and one
manager replica is also a single point of failure. The reference scales the same layer with HA
operator replicas and per-controller ``ConcurrentSyncs`` behind
controller-runtime leader election (SURVEY §2b/§5); this package owns its
runtime, so it shards it directly:

  * Reconcile keys (namespace/name) partition across ``shards`` worker
    replicas by CONSISTENT HASHING into a fixed virtual-shard space
    (``shard_of``; ``VIRTUAL_SHARDS_PER_WORKER`` slots per configured
    worker, so rebalancing moves ~1/N of the keys, never reshuffles the
    world). Every worker is a full ``ControllerManager`` + reconciler
    set over the same store — it drains every event (its own informer)
    but enqueues/executes only requests whose shard it owns
    (``ControllerManager.request_filter``).

  * Ownership is published through a leader-owned ``ShardMap`` store
    object plus per-worker heartbeat ``Lease``s (the existing lease
    machinery). The coordinator role is itself lease-elected among the
    workers (``grove-shard-coordinator``), so the map survives any
    single replica.

  * Failover is deterministic: a crashed worker stops renewing, the
    leader detects the ORPHANED lease after one lease duration and
    force-reassigns its shards, and the new owner RELISTS the gained
    shards (synthetic Added events through its own watch mappings) and
    resumes — level-triggered reconcilers regenerate any work the dead
    worker's queue lost.

  * Live-to-live moves (rebalance, clean shutdown) are TWO-PHASE: the
    leader stamps the move into ``ShardMap.pending`` and the CURRENT
    owner releases (rewrites the assignment) when it next refreshes the
    map. Until the owner acks, the designated successor does not serve —
    so a worker holding a stale map can delay a handoff but never fight
    the new owner, and no key is ever owned by two live workers in the
    same round (pinned by the ownership audit + tests/test_sharding.py).

A worker whose map view goes stale past one lease duration DEFERS (owns
nothing, writes nothing) until a fresh read succeeds; recovery relists
its shards back in. Deterministic single-threaded scheduling: workers
step sequentially inside ``ShardedManager.run_once``, and per-worker
wall clocks are accumulated separately so the bench can report the
per-shard settle skew and the modeled parallel wall of a real N-process
deployment.

The counterpart of grove_tpu/controller/sharding.py. Every worker builds
its own `GangScheduler` (and engine) on the harness's device; the worker
that owns the reserved scheduler shard is the one whose engine solves.
"""

from __future__ import annotations

import time
import zlib
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..api.meta import ObjectMeta
from ..observability.tracing import NOOP_TRACER
from .leaderelection import Lease, LeaderElector, lease_fresh
from .runtime import ControllerManager, Request

#: namespace holding the coordination objects (same as leader election)
SHARD_NAMESPACE = "grove-system"
SHARD_MAP_NAME = "grove-shard-map"
COORDINATOR_LEASE = "grove-shard-coordinator"
WORKER_LEASE_PREFIX = "grove-shard-worker-"
#: virtual shards per CONFIGURED worker: the hash space stays fixed for
#: the cluster's life (hash % V must be stable), and 16 slots per
#: worker keeps rebalancing granular — and the per-worker KEY load even
#: (hash imbalance shrinks with slot count) — without exploding the
#: shard map
VIRTUAL_SHARDS_PER_WORKER = 16

# handoff reasons (grove_manager_shard_handoffs_total{shard,reason})
REASON_BOOTSTRAP = "bootstrap"
REASON_ORPHANED = "orphaned"
REASON_REBALANCE = "rebalance"
REASON_RELEASE = "release"


def shard_of(namespace: str, name: str, num_shards: int) -> int:
    """Stable reconcile-key -> shard hash (crc32: process- and
    run-independent, unlike hash() under PYTHONHASHSEED). All kinds
    sharing one (namespace, name) co-shard; singleton requests (the node
    monitor's "" / "nodes") hash to fixed shards like any key — EXCEPT
    the gang scheduler's singleton, which maps to the RESERVED shard
    `num_shards` (one past the hash range): the solver's host path is
    the plane's critical path, and its shard must carry no co-hashed
    workload keys so the coordinator can keep its owner fully dedicated
    (the kube-scheduler-as-its-own-process shape)."""
    if not namespace and name == "schedule":
        return num_shards
    return zlib.crc32(f"{namespace}/{name}".encode()) % num_shards


@dataclass
class ShardMap:
    """The leader-owned shard assignment, as a store object (readable by
    every worker, survives manager restarts, versioned like any object).

    assignments  shard id -> owning worker identity ("" = unassigned)
    pending      shard id -> designated NEXT owner; the move completes
                 when the CURRENT owner releases (or its lease expires)
    epoch        bumped on every change — workers detect staleness and
                 the delta (gained/lost shards) against their cached view
    """

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    epoch: int = 0
    num_shards: int = 0
    assignments: dict = field(default_factory=dict)
    pending: dict = field(default_factory=dict)

    KIND = "ShardMap"


def _release_scheduler(components: dict) -> None:
    """Release the engine of a worker's GangScheduler (the port's card
    memory: resident state, pinned buffers, graphs), where it has one."""
    scheduler = (components or {}).get("scheduler")
    release = getattr(scheduler, "release", None)
    if release is not None:
        release()


class ShardWorker:
    """One manager replica of the sharded control plane: a full
    ControllerManager + reconciler set (built by the harness factory)
    plus the ownership protocol — heartbeat lease, shard-map refresh,
    two-phase release, relist-on-gain."""

    def __init__(self, sharded: "ShardedManager", index: int):
        self.sharded = sharded
        self.index = index
        #: stable identity: the ShardMap references it, and a rebuilt
        #: control plane (crash-restart) must adopt the existing map
        self.identity = f"worker-{index}"
        self.lease_name = f"{WORKER_LEASE_PREFIX}{index}"
        self.alive = True
        #: accumulated wall seconds of this worker's steps (bench: the
        #: per-shard settle skew + modeled parallel wall read these)
        self.wall_seconds = 0.0
        #: rounds this worker deferred (could not renew/refresh and
        #: therefore served nothing)
        self.deferred_rounds = 0
        #: chaos hook (shard_map_stale): rounds to SKIP the map refresh,
        #: serving from the cached view (and deferring entirely once the
        #: view ages past one lease duration)
        self.stale_map_hold = 0
        #: shards served last round (the request_filter reads this live)
        self.owned: set[int] = set()
        #: (namespace, name) -> shard id memo for the request filter
        self._shard_cache: dict[tuple[str, str], int] = {}
        self._map_view: Optional[ShardMap] = None
        self._map_fresh_at: float = float("-inf")
        #: coordinator-role elector: whichever worker holds this lease
        #: runs the shard-map reconciliation at the top of its step
        self.elector = LeaderElector(
            sharded.store,
            identity=self.identity,
            lease_name=COORDINATOR_LEASE,
            namespace=SHARD_NAMESPACE,
            lease_duration_seconds=sharded.lease_duration,
        )
        self.manager: ControllerManager | None = None
        self.components: dict = {}
        self.rebuild()

    def rebuild(self) -> None:
        """(Re)build this worker's manager + reconcilers — worker birth
        and chaos crash-revival both land here: a fresh manager starts at
        event cursor 0 (replays the log, or relists past a compaction
        horizon), reconcilers rebuild every in-memory cache from the
        store, and the cached shard-map view is dropped (a revived
        process must confirm ownership before serving anything). A
        revived worker's old scheduler is released first: its engine's
        card memory goes with the process it belonged to."""
        _release_scheduler(self.components)
        self.manager, self.components = self.sharded.build_worker(self)
        self.manager.request_filter = self._owns_request
        # manager-scoped gauges (workqueue depth, is_leader) export one
        # series PER WORKER — N replicas over one registry must not
        # last-writer-wins a single unlabeled gauge
        self.manager.gauge_labels = {"worker": self.identity}
        self._map_view = None
        self._map_fresh_at = float("-inf")
        self.owned = set()

    # -- ownership ---------------------------------------------------------
    def _owns_request(self, _cname: str, req: Request) -> bool:
        """The manager's request_filter: runs per enqueue attempt on the
        drain hot path, so the (pure, stable) key->shard hash is memoized
        per worker (bounded: cleared at 200k keys — a cap only long churn
        runs ever reach)."""
        cache = self._shard_cache
        key = (req.namespace, req.name)
        s = cache.get(key)
        if s is None:
            if len(cache) > 200_000:
                cache.clear()
            s = cache[key] = shard_of(
                req.namespace, req.name, self.sharded.num_shards
            )
        return s in self.owned

    def _renew_lease(self, now: float) -> bool:
        """Heartbeat: renew (or create / re-acquire) this worker's lease.
        Returns False — defer the round — when the write faults."""
        store = self.sharded.store
        try:
            lease = store.get(Lease.KIND, SHARD_NAMESPACE, self.lease_name)
            if lease is None:
                store.create(Lease(
                    metadata=ObjectMeta(
                        name=self.lease_name, namespace=SHARD_NAMESPACE
                    ),
                    holder_identity=self.identity,
                    lease_duration_seconds=self.sharded.lease_duration,
                    renew_time=now,
                ))
            elif (
                lease.holder_identity != self.identity
                or lease.renew_time != now  # skip no-op renew writes
            ):
                lease.holder_identity = self.identity
                lease.renew_time = now
                store.update(lease)
            return True
        except Exception:
            return False  # transient store fault: defer, retry next round

    def _refresh_map(self, now: float, first: bool = True) -> None:
        """Refresh the cached shard-map view — unless a chaos hold is
        pinning it stale (the lagging-informer model; the hold ages once
        per CONTROL-PLANE ROUND, not per workload pass)."""
        if self.stale_map_hold > 0:
            if first:
                self.stale_map_hold -= 1
            return
        try:
            view = self.sharded.store.get(
                ShardMap.KIND, SHARD_NAMESPACE, SHARD_MAP_NAME
            )
        except Exception:
            return  # stale view ages; past one lease duration we defer
        if view is not None:
            self._map_view = view
            self._map_fresh_at = now

    def _release_pending(self) -> None:
        """Two-phase handoff, owner side: shards of OURS the leader marked
        pending are released — assignment rewritten to the successor in
        one map update — and leave our owned set before this round serves
        anything. Requires the view we just refreshed; a write fault
        simply retries next round (we keep serving meanwhile, which is
        safe: the successor only serves after this write lands)."""
        view = self._map_view
        if view is None or not view.pending:
            return
        mine = [
            s for s, _t in view.pending.items()
            if view.assignments.get(s) == self.identity
        ]
        if not mine:
            return
        store = self.sharded.store
        try:
            m = store.get(ShardMap.KIND, SHARD_NAMESPACE, SHARD_MAP_NAME)
            if m is None:
                return
            changed = False
            for s in sorted(mine):
                if (
                    m.assignments.get(s) == self.identity
                    and s in m.pending
                ):
                    target = m.pending.pop(s)
                    m.assignments[s] = target
                    self.sharded.count_handoff(target, REASON_RELEASE)
                    changed = True
            if changed:
                m.epoch += 1
                store.update(m)
                self._map_view = m
        except Exception:
            return  # retry on the next refresh

    def _map_scope(self) -> frozenset | None:
        """Which controllers' watch mappings this worker must run, given
        its owned shards. The DEDICATED scheduler worker (reserved shard
        only — which contains exactly the scheduler's singleton key)
        skips every workload mapper; workload workers skip the
        scheduler's. Safe either way: any ownership gain relists through
        the FULL mapping set, rebuilding whatever a scoped drain skipped
        (same conservative-rebuild contract as a crash-restart)."""
        sched = self.sharded.scheduler_shard
        if self.owned == {sched}:
            return frozenset(("scheduler",))
        if sched not in self.owned:
            return frozenset(
                c.name for c in self.manager.controllers
                if c.name != "scheduler"
            )
        return None  # mixed ownership (failover transition): map all

    # -- the step ----------------------------------------------------------
    def step(self, first: bool = True) -> int:
        """One worker pass: heartbeat, refresh + release, derive owned
        shards (relisting gains), then run the inner manager round over
        owned work only. `first` is True on the first pass of a
        control-plane round (chaos holds age once per round)."""
        sharded = self.sharded
        now = sharded.store.clock.now()
        with sharded.tracer.span(
            "manager.shard_step", worker=self.identity
        ) as sp:
            if not self._renew_lease(now):
                self.deferred_rounds += 1
                # the ownership audit reads last_batch per pass: a
                # deferred pass executed nothing
                self.manager.last_batch = []
                sp.set(outcome="defer-lease")
                return 0
            try:
                # keep/contest the coordinator role; the COORDINATION
                # itself runs at the END of the sharded round (after every
                # live worker renewed its heartbeat), so a virtual clock
                # jump can never make the leader orphan a healthy fleet
                # whose renewals simply hadn't run yet this round
                self.elector.try_acquire()
            except Exception:
                pass  # transient fault: coordinate next round
            self._refresh_map(now, first=first)
            self._release_pending()
            view = self._map_view
            if (
                view is None
                or now - self._map_fresh_at > sharded.lease_duration
            ):
                # stale past one lease duration (or never seen): DEFER —
                # serve nothing rather than fight whoever the leader may
                # have handed our shards to. Recovery relists them back.
                if self.owned:
                    self.owned.clear()
                self.deferred_rounds += 1
                sp.set(outcome="defer-stale-map")
                # still run the round: the manager drains (cursor keeps
                # up) but the ownership filter drops everything
                self.manager.map_scope = None
                return self.manager.run_once()
            owned = {
                s for s, w in view.assignments.items()
                if w == self.identity and s not in view.pending
            }
            gained = owned - self.owned
            self.owned.clear()
            self.owned.update(owned)
            if gained and sharded.tracer.enabled:
                # shard-handoff causal edge (observability/causal.py):
                # link the tokens the previous owner's gain emitted and
                # emit fresh ones, so a failover's ownership transfer
                # renders as a flow arrow between the two workers'
                # shard_step spans
                ledger = getattr(sharded.store, "causal", None)
                if ledger is not None:
                    links = [
                        t for t in (
                            ledger.follow(("shard", s))
                            for s in sorted(gained)
                        ) if t is not None
                    ]
                    if links:
                        sp.set(causal_link=links)
                    sp.set(causal_emit=[
                        ledger.emit(("shard", s)) for s in sorted(gained)
                    ])
            if gained and self.manager.event_cursor > 0:
                # new owner relists the gained shards (a cursor-0 manager
                # is about to replay the whole log anyway) — through the
                # FULL mapper set, so state a scoped drain skipped
                # rebuilds here
                events, _ = sharded.store.relist()
                self.manager.inject_events(
                    events,
                    accept=lambda _c, r: shard_of(
                        r.namespace, r.name, sharded.num_shards
                    ) in gained,
                )
            self.manager.map_scope = self._map_scope()
            executed = self.manager.run_once()
            sp.set(outcome="ok", owned=len(owned), executed=executed)
            return executed


class ShardedManager:
    """N ShardWorkers over one store, presenting (most of) the
    ControllerManager surface the Harness/debug/chaos layers consume.
    Workers step sequentially (deterministic single-threaded simulation);
    per-worker wall clocks accumulate separately so horizontal scaling is
    measurable as the max-worker critical path."""

    def __init__(self, store, num_workers: int,
                 lease_duration_seconds: float,
                 build_worker: Callable[[ShardWorker],
                                        tuple[ControllerManager, dict]],
                 identity: str | None = None, metrics=None, logger=None,
                 tracer=None,
                 error_backoff_base_seconds: float = 1.0,
                 error_backoff_max_seconds: float = 60.0,
                 error_retry_budget: int = 8):
        self.store = store
        self.num_workers = num_workers
        self.lease_duration = lease_duration_seconds
        self.build_worker = build_worker
        self.identity = identity
        self.metrics = metrics
        self.logger = logger
        self.tracer = tracer or NOOP_TRACER
        self.elector = None  # manager-surface parity (always "leader")
        self.error_backoff_base_seconds = error_backoff_base_seconds
        self.error_backoff_max_seconds = error_backoff_max_seconds
        self.error_retry_budget = error_retry_budget
        #: fixed virtual-shard space (stable hash domain for the
        #: cluster's life; an existing map's width wins over config so a
        #: rebuilt control plane adopts rather than reshuffles)
        self.num_shards = num_workers * VIRTUAL_SHARDS_PER_WORKER
        existing = store.get(ShardMap.KIND, SHARD_NAMESPACE, SHARD_MAP_NAME)
        if existing is not None and existing.num_shards:
            self.num_shards = existing.num_shards
        #: when True, every round audits that no (controller, request)
        #: key executed on two workers (tests + chaos sweeps arm this;
        #: the bench leaves it off the hot path)
        self.audit = False
        #: optional () -> None cache prefetch run after the workload
        #: passes quiesce and before the scheduler worker steps (the
        #: harness wires the cluster's topology/usage snapshot here).
        #: The usage accounting is WATCH-DRIVEN informer state every
        #: replica maintains concurrently with reconciling; in the
        #: single-threaded simulation it must run somewhere, so its wall
        #: is charged to the least-loaded live worker (which, in a real
        #: fleet, overlaps it entirely) instead of serializing in front
        #: of the solve.
        self.prefetch = None
        #: the gang scheduler's singleton request maps to the RESERVED
        #: shard one past the hash range (see shard_of). It is DEDICATED:
        #: the coordinator keeps its owner free of workload shards (the
        #: kube-scheduler-as-its-own-process shape) — the solver's host
        #: path is the whole plane's critical path and must not queue
        #: behind clique reconciles on one replica.
        self.scheduler_shard = shard_of("", "schedule", self.num_shards)
        #: every shard id the coordinator manages: the hash range plus
        #: the reserved scheduler shard
        self.all_shards = tuple(range(self.num_shards)) + (
            self.scheduler_shard,
        )
        self.workers = [ShardWorker(self, i) for i in range(num_workers)]
        self._bootstrap(existing)

    # -- bootstrap ---------------------------------------------------------
    def _bootstrap(self, existing: ShardMap | None) -> None:
        """Publish the initial leases + a balanced map in one shot (the
        fleet starting together), so the first settle doesn't churn
        through a bootstrap rebalance. A rebuilt control plane over a
        store that already carries a map ADOPTS it unchanged."""
        now = self.store.clock.now()
        for w in self.workers:
            w._renew_lease(now)
        if existing is not None:
            return
        # the reserved scheduler shard goes to the LAST worker alone;
        # the hash-range shards round-robin over the rest (everyone,
        # when N == 1)
        workload = self.workers[:-1] if self.num_workers > 1 \
            else self.workers
        assignments = {}
        nxt = 0
        for s in self.all_shards:
            if s == self.scheduler_shard and self.num_workers > 1:
                assignments[s] = self.workers[-1].identity
            else:
                assignments[s] = workload[nxt % len(workload)].identity
                nxt += 1
        m = ShardMap(
            metadata=ObjectMeta(
                name=SHARD_MAP_NAME, namespace=SHARD_NAMESPACE
            ),
            epoch=1,
            num_shards=self.num_shards,
            assignments=assignments,
        )
        try:
            self.store.create(m)
        except Exception:
            return  # raced another replica set's bootstrap: adopt theirs
        for w in self.workers:
            self.count_handoff(
                w.identity, REASON_BOOTSTRAP,
                n=sum(
                    1 for t in m.assignments.values() if t == w.identity
                ),
            )
        self._export_assignment_metrics(m)

    # -- coordination (leader side) ----------------------------------------
    def _fresh_identities(self, now: float) -> set[str]:
        fresh: set[str] = set()
        for lease in self.store.scan(Lease.KIND, namespace=SHARD_NAMESPACE):
            name = lease.metadata.name
            if not name.startswith(WORKER_LEASE_PREFIX):
                continue
            if lease_fresh(lease, now):
                fresh.add(lease.holder_identity)
        return fresh

    def _loads(self, m: ShardMap, fresh: set[str]) -> dict[str, int]:
        """Projected per-worker WORKLOAD shard counts (the dedicated
        scheduler shard is excluded — it is placement, not load, and its
        owner is kept out of workload balancing). Pending moves count
        toward their TARGET (already decided), so the rebalance loop
        converges instead of re-deciding the same moves."""
        loads = {w: 0 for w in fresh}
        for s, owner in m.assignments.items():
            if s == self.scheduler_shard:
                continue
            target = m.pending.get(s, owner)
            if target in loads:
                loads[target] += 1
        return loads

    @staticmethod
    def _least_loaded(loads: dict[str, int]) -> str | None:
        if not loads:
            return None
        return min(sorted(loads), key=lambda w: loads[w])

    def coordinate(self, now: float) -> None:
        """The leader's shard-map reconciliation: force-complete moves
        whose owner died, reassign orphaned shards (owner lease expired —
        the failover path, bounded by one lease duration), assign
        unowned shards, keep the scheduler shard's owner DEDICATED
        (workload shards migrate off it), and schedule two-phase
        rebalance moves toward an even workload spread. Exactly one
        epoch bump per changed round."""
        store = self.store
        try:
            m = store.get(ShardMap.KIND, SHARD_NAMESPACE, SHARD_MAP_NAME)
        except Exception:
            return
        if m is None:
            return
        fresh = self._fresh_identities(now)
        loads = self._loads(m, fresh)
        sched = self.scheduler_shard
        changed = False
        sched_owner = m.assignments.get(sched, "")
        for s in sorted(set(m.assignments) | set(self.all_shards)):
            owner = m.assignments.get(s, "")
            if owner and owner in fresh:
                if s in m.pending and m.pending[s] not in fresh:
                    # cancel a decided move whose successor died before
                    # the owner released — the owner just keeps the shard
                    del m.pending[s]
                    changed = True
                continue
            # owner dead/absent: force-complete a decided move, else
            # reassign to the least-loaded live worker
            target = m.pending.pop(s, None)
            reason = REASON_ORPHANED if owner else REASON_BOOTSTRAP
            if target is None or target not in fresh:
                if s == sched:
                    # the scheduler shard prefers the least workload-
                    # loaded survivor (it will shed the rest anyway)
                    target = self._least_loaded(loads)
                else:
                    # workload shards avoid the scheduler's owner while
                    # any other live worker exists (dedication)
                    pool = {
                        w: n for w, n in loads.items() if w != sched_owner
                    } or loads
                    target = self._least_loaded(pool)
            if target is None:
                # no live worker at all: leave unassigned (served by
                # nobody until the fleet returns)
                if m.assignments.get(s, "") != "":
                    m.assignments[s] = ""
                    changed = True
                continue
            m.assignments[s] = target
            if s == sched:
                sched_owner = target
            else:
                loads[target] = loads.get(target, 0) + 1
            self.count_handoff(target, reason)
            changed = True
        # dedication: migrate workload shards OFF the scheduler shard's
        # owner (two-phase) while another live worker can take them
        if (
            sched_owner
            and sched_owner in fresh
            and len(fresh) > 1
        ):
            others = {w: n for w, n in loads.items() if w != sched_owner}
            for s in sorted(m.assignments):
                if (
                    s != sched
                    and m.assignments[s] == sched_owner
                    and s not in m.pending
                ):
                    target = self._least_loaded(others)
                    m.pending[s] = target
                    others[target] += 1
                    self.count_handoff(target, REASON_REBALANCE)
                    changed = True
        # two-phase rebalance live -> live among the WORKLOAD workers:
        # move shards from the most to the least loaded until the spread
        # is <= 1 (the scheduler owner is not a candidate either way)
        pool = {w: n for w, n in self._loads(m, fresh).items()
                if w != sched_owner}
        if len(pool) > 1:
            for _ in range(m.num_shards):
                hi = max(sorted(pool), key=lambda w: pool[w])
                lo = min(sorted(pool), key=lambda w: pool[w])
                if pool[hi] - pool[lo] < 2:
                    break
                movable = sorted(
                    s for s, owner in m.assignments.items()
                    if owner == hi and s not in m.pending and s != sched
                )
                if not movable:
                    break
                m.pending[movable[0]] = lo
                self.count_handoff(lo, REASON_REBALANCE)
                pool[hi] -= 1
                pool[lo] += 1
                changed = True
        if changed:
            m.epoch += 1
            try:
                store.update(m)
            except Exception:
                return  # transient fault: re-coordinate next round
        self._export_assignment_metrics(m, fresh)

    # -- metrics -----------------------------------------------------------
    def count_handoff(self, target: str, reason: str, n: int = 1) -> None:
        if self.metrics is not None and target:
            self.metrics.counter(
                "grove_manager_shard_handoffs_total",
                "shard ownership handoffs by gaining worker and reason",
            ).inc(n, shard=target, reason=reason)

    def _export_assignment_metrics(
        self, m: ShardMap, fresh: set[str] | None = None
    ) -> None:
        """grove_manager_shard_assignments{shard=<worker>} = owned-shard
        count, reconciled via Gauge.label_sets/remove so a worker that
        LEFT the fleet (released lease, no assignments) stops exporting —
        series hygiene, same pattern as the per-node lifecycle gauges."""
        if self.metrics is None:
            return
        counts: dict[str, int] = {}
        for owner in m.assignments.values():
            if owner:
                counts[owner] = counts.get(owner, 0) + 1
        gauge = self.metrics.gauge(
            "grove_manager_shard_assignments",
            "virtual shards owned per worker replica",
        )
        keep = set(counts)
        if fresh is not None:
            keep |= fresh
        for labels in gauge.label_sets():
            ident = labels.get("shard")
            if ident not in keep:
                gauge.remove(**labels)
        for ident, n in counts.items():
            gauge.set(float(n), shard=ident)

    def drop_worker_series(self, identity: str) -> None:
        """Remove a departed worker's metric series (clean shutdown):
        both the assignments gauge and the handoffs counter stop
        exporting for an identity that left the fleet."""
        if self.metrics is None:
            return
        gauge = self.metrics.gauge("grove_manager_shard_assignments")
        for labels in gauge.label_sets():
            if labels.get("shard") == identity:
                gauge.remove(**labels)
        counter = self.metrics.counter("grove_manager_shard_handoffs_total")
        for labels in counter.label_sets():
            if labels.get("shard") == identity:
                counter.remove(**labels)

    # -- lifecycle (bench + chaos drive these) -----------------------------
    def kill_worker(self, index: int) -> bool:
        """Model a worker process crash: it stops stepping and stops
        renewing; its shards orphan after one lease duration and fail
        over. Refuses to kill the LAST live worker (the fleet must keep
        a survivor to fail over to). Returns whether it killed."""
        alive = [w for w in self.workers if w.alive]
        w = self.workers[index]
        if not w.alive or len(alive) <= 1:
            return False
        w.alive = False
        # the crashed process's engine leaves the card with it
        _release_scheduler(w.components)
        return True

    def revive_worker(self, index: int) -> None:
        """Crash-recovery: a fresh process under the same identity — new
        manager (cursor 0: replay/relist), fresh reconciler caches, no
        cached shard map. It re-joins by renewing its lease; the
        coordinator rebalances shards back over the following rounds."""
        w = self.workers[index]
        if w.alive:
            return
        w.rebuild()
        w.alive = True
        w.deferred_rounds = 0
        w.stale_map_hold = 0

    def stop_worker(self, index: int) -> None:
        """Clean shutdown (the release-on-cancel analog): the departing
        worker hands its shards DIRECTLY to the least-loaded survivors in
        one map write, releases its heartbeat lease, and its metric
        series leave /metrics — standbys never wait out the lease."""
        w = self.workers[index]
        if not w.alive:
            return
        store = self.store
        now = store.clock.now()
        m = store.get(ShardMap.KIND, SHARD_NAMESPACE, SHARD_MAP_NAME)
        if m is not None:
            fresh = self._fresh_identities(now) - {w.identity}
            loads = self._loads(m, fresh)
            changed = False
            for s in sorted(m.assignments):
                if m.assignments[s] != w.identity:
                    continue
                m.pending.pop(s, None)
                target = self._least_loaded(loads)
                m.assignments[s] = target or ""
                if target is not None:
                    loads[target] += 1
                    self.count_handoff(target, REASON_RELEASE)
                changed = True
            for s, t in list(m.pending.items()):
                if t == w.identity:  # a move headed AT us re-routes
                    del m.pending[s]
                    changed = True
            if changed:
                m.epoch += 1
                store.update(m)
            self._export_assignment_metrics(m)
        lease = store.get(Lease.KIND, SHARD_NAMESPACE, w.lease_name)
        if lease is not None and lease.holder_identity == w.identity:
            lease.holder_identity = ""
            lease.renew_time = 0.0
            store.update(lease)
        try:
            w.elector.release()  # hand off the coordinator role too
        except Exception:
            pass
        w.alive = False
        w.owned.clear()
        self.drop_worker_series(w.identity)

    def chaos_revoke_worker(self, index: int) -> int:
        """Chaos handoff storm: revoke every shard of one LIVE worker via
        two-phase pending moves (as the leader would), forcing a wave of
        release handoffs + relists through the normal protocol. Returns
        the number of moves scheduled."""
        w = self.workers[index]
        store = self.store
        now = store.clock.now()
        try:
            m = store.get(ShardMap.KIND, SHARD_NAMESPACE, SHARD_MAP_NAME)
        except Exception:
            return 0
        if m is None:
            return 0
        fresh = self._fresh_identities(now) - {w.identity}
        if not fresh:
            return 0
        loads = self._loads(m, fresh)
        moves = 0
        for s in sorted(m.assignments):
            if m.assignments[s] != w.identity or s in m.pending:
                continue
            target = self._least_loaded(loads)
            m.pending[s] = target
            loads[target] += 1
            self.count_handoff(target, REASON_REBALANCE)
            moves += 1
        if moves:
            m.epoch += 1
            try:
                store.update(m)
            except Exception:
                return 0
        return moves

    # -- the loop ----------------------------------------------------------
    #: workload-pass cap per control-plane round (a deep producer chain
    #: that still has cross-worker work after this many passes simply
    #: continues next round; settle() loops run_once anyway)
    MAX_WORKLOAD_PASSES = 8

    def _step_worker(self, w: ShardWorker, seen: dict | None,
                     first: bool) -> int:
        t0 = time.perf_counter()
        n = w.step(first=first)
        w.wall_seconds += time.perf_counter() - t0
        if seen is not None:
            for cname, req in w.manager.last_batch:
                key = (cname, req)
                other = seen.get(key)
                if other is not None and other != w.index:
                    raise RuntimeError(
                        "shard ownership invariant violated: "
                        f"{cname} {req.namespace}/{req.name} "
                        f"reconciled by workers {other} and {w.index} "
                        "in one pass"
                    )
                seen[key] = w.index
        return n

    def run_once(self) -> int:
        """One control-plane round. The single manager runs each round
        grouped by controller REGISTRATION order so producers' writes
        land before consumers run (PCS -> cliques -> scheduler). Across
        workers the same discipline becomes a two-stage round: the
        WORKLOAD workers pass over their shards repeatedly (index order,
        deterministic) until they are mutually quiescent — the
        cross-worker producer/consumer hops (PCS on one worker, its
        cliques on another) drain inside the round — and only then does
        the scheduler's dedicated worker step, seeing the whole
        arrival-batched backlog instead of solving wave slivers (an
        extra full-device round + re-encode per sliver at stress scale;
        the real-world analog is a gang scheduler's arrival-batching
        window). Per-worker wall time accrues on the worker; the audit
        (when armed) asserts no request key executed on two workers
        within one pass."""
        total = 0
        sched_shard = self.scheduler_shard
        workload = [
            w for w in self.workers
            if w.alive and sched_shard not in w.owned
        ]
        schedulers = [
            w for w in self.workers
            if w.alive and sched_shard in w.owned
        ]
        for p in range(self.MAX_WORKLOAD_PASSES):
            seen: dict | None = {} if self.audit else None
            ran = 0
            for w in workload:
                ran += self._step_worker(w, seen, first=(p == 0))
            total += ran
            if ran == 0:
                break
        if self.prefetch is not None and schedulers:
            # warm the shared topology/usage caches off the scheduler's
            # critical path (see the prefetch attribute); charged to the
            # least-loaded live worker
            t0 = time.perf_counter()
            try:
                self.prefetch()
            except Exception:
                pass  # advisory: the scheduler recomputes authoritatively
            dt = time.perf_counter() - t0
            alive = [w for w in self.workers if w.alive]
            if alive:
                min(alive, key=lambda w: w.wall_seconds).wall_seconds += dt
        seen = {} if self.audit else None
        for w in schedulers:
            # scheduler workers step once per round: their chaos holds
            # age here
            total += self._step_worker(w, seen, first=True)
        # coordination runs AFTER every live worker's step: each renewed
        # its heartbeat at the current clock, so lease freshness reflects
        # actual liveness — a clock jump between rounds can never read as
        # a fleet-wide orphaning
        leader = None
        for w in self.workers:
            if not w.alive:
                continue
            try:
                if w.elector.is_leader():
                    leader = w
                    break
            except Exception:
                continue
        if leader is not None:
            t0 = time.perf_counter()
            self.coordinate(self.store.clock.now())
            leader.wall_seconds += time.perf_counter() - t0
        return total

    def settle(self, max_rounds: int = 256) -> None:
        for _ in range(max_rounds):
            if self.run_once() == 0:
                busy = False
                for w in self.workers:
                    if not w.alive:
                        continue
                    w.manager._drain_events()
                    w.manager._pop_due_requeues()
                    if w.manager._queue:
                        busy = True
                if not busy:
                    return
        errors = self.errors
        raise RuntimeError(
            f"sharded controllers did not settle in {max_rounds} rounds "
            f"(errors: {errors[-3:]})"
        )

    # -- ControllerManager-surface parity ----------------------------------
    @property
    def controllers(self):
        """Worker 0's controller list (names/shape for dumps; reconcile
        metrics are shared across workers via the one registry)."""
        return self.workers[0].manager.controllers

    @property
    def errors(self) -> list:
        out: list = []
        for w in self.workers:
            out.extend(w.manager.errors)
        return out

    @property
    def workqueue_depth(self) -> int:
        return sum(
            w.manager.workqueue_depth for w in self.workers if w.alive
        )

    @property
    def pending_requeue_count(self) -> int:
        return sum(
            w.manager.pending_requeue_count for w in self.workers if w.alive
        )

    def workqueue_snapshot(self) -> list[dict]:
        out: list[dict] = []
        for w in self.workers:
            if not w.alive:
                continue
            for entry in w.manager.workqueue_snapshot():
                entry["worker"] = w.identity
                out.append(entry)
        return out

    def next_requeue_at(self) -> Optional[float]:
        ats = [
            w.manager.next_requeue_at()
            for w in self.workers if w.alive
        ]
        ats = [a for a in ats if a is not None]
        return min(ats) if ats else None

    @property
    def event_cursor(self) -> int:
        """The SLOWEST live worker's cursor: the safe compaction horizon
        (compacting past any worker forces it into a relist)."""
        cursors = [
            w.manager.event_cursor for w in self.workers if w.alive
        ]
        return min(cursors) if cursors else 0

    def compact_processed_events(self) -> int:
        return self.store.compact_events(self.event_cursor)

    def breaker_state(self, cname: str) -> str:
        """Worst breaker state across workers (open > half-open > closed):
        the surface answers "is this controller degraded anywhere"."""
        from .runtime import (
            BREAKER_CLOSED, BREAKER_HALF_OPEN, BREAKER_OPEN,
        )

        rank = {BREAKER_CLOSED: 0, BREAKER_HALF_OPEN: 1, BREAKER_OPEN: 2}
        worst = BREAKER_CLOSED
        for w in self.workers:
            st = w.manager.breaker_state(cname)
            if rank[st] > rank[worst]:
                worst = st
        return worst

    def resilience_snapshot(self) -> dict:
        """Merged per-controller retry/breaker view across workers (sum
        the chains, keep the deepest, surface the worst breaker)."""
        merged: dict[str, dict] = {}
        for w in self.workers:
            for cname, entry in w.manager.resilience_snapshot().items():
                if cname == "standing_by":
                    continue
                agg = merged.setdefault(
                    cname,
                    {"retrying_requests": 0, "max_attempts": 0,
                     "breaker": "closed"},
                )
                agg["retrying_requests"] += entry["retrying_requests"]
                agg["max_attempts"] = max(
                    agg["max_attempts"], entry["max_attempts"]
                )
        for cname in merged:
            merged[cname]["breaker"] = self.breaker_state(cname)
        return merged

    # -- introspection -----------------------------------------------------
    def shard_owner(self, namespace: str, name: str) -> tuple[int, str]:
        """(shard id, owning worker identity) of one reconcile key —
        the flight recorder's wedged section names the shard with this."""
        s = shard_of(namespace, name, self.num_shards)
        m = self.store.peek(ShardMap.KIND, SHARD_NAMESPACE, SHARD_MAP_NAME)
        owner = m.assignments.get(s, "") if m is not None else ""
        return s, owner

    def map_epoch(self) -> int:
        m = self.store.peek(ShardMap.KIND, SHARD_NAMESPACE, SHARD_MAP_NAME)
        return m.epoch if m is not None else 0

    def reset_walls(self) -> None:
        for w in self.workers:
            w.wall_seconds = 0.0

    def worker_walls(self) -> dict[str, float]:
        return {w.identity: w.wall_seconds for w in self.workers}

    def debug_state(self) -> dict:
        """The `sharding` section of debug dumps: map epoch + per-worker
        liveness, ownership, wall clocks and defer counts."""
        m = self.store.peek(ShardMap.KIND, SHARD_NAMESPACE, SHARD_MAP_NAME)
        return {
            "num_shards": self.num_shards,
            "map_epoch": m.epoch if m is not None else 0,
            "pending_moves": dict(m.pending) if m is not None else {},
            "coordinator": next(
                (
                    w.identity for w in self.workers
                    if w.alive and w.elector.is_leader()
                ),
                None,
            ),
            "workers": [
                {
                    "identity": w.identity,
                    "alive": w.alive,
                    "owned_shards": sorted(w.owned),
                    "wall_seconds": round(w.wall_seconds, 4),
                    "deferred_rounds": w.deferred_rounds,
                    "workqueue_depth": w.manager.workqueue_depth,
                    "event_cursor": w.manager.event_cursor,
                }
                for w in self.workers
            ],
        }
