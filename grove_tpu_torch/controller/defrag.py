"""Continuous defragmentation: a background re-pack optimizer.

Churn permanently fragments the fleet — scale cycles, preemption and
node faults leave gangs spanning broader topology domains than a fresh
solve would give them, and at fleet scale fragmentation IS capacity
loss. The reference defines the scheduler-side vocabulary for "this
gang should move" (`DisruptionTarget`/`Unhealthy` PodGang conditions,
podgang.go:156-169) but never drives it; this controller drives it
continuously and cheaply:

  1. CANDIDATES — scheduled gangs ranked worst placement score first
     (status.placement_score is exact while a gang stays placed),
     bounded by `defrag.candidates_per_sweep`.
  2. WHAT-IF — one `PlacementEngine.whatif_scores` call ranks candidate
     destinations against the solver's DEVICE-RESIDENT free state: a
     dirty-row what-if riding the incremental tier's transport
     discipline, counted under its own dispatch kind — never a full
     backlog re-encode (the controller samples the engine's dispatch
     counters around every call so the bench can gate on exactly that).
     Engines without a resident what-if (mesh-sharded, custom) fall
     back to exact host-side scoring.
  3. ADMISSION — a move's net gain (candidate score - current score -
     `migration_cost_score`) must clear `min_score_gain`; admitted
     moves are further bounded by `max_moves_per_sweep`, the rolling
     `max_evictions_per_hour` ceiling, and the tenant's disruption
     budget drawn from the SAME DisruptionLedger preemption spends
     (a window can never double-spend a budget across consumers).
  4. EXECUTION — make-before-break through the existing drain/eviction
     path: the destination is verified to fit in CURRENTLY-free
     capacity and held as a migration ticket
     (GangScheduler.stage_migration) BEFORE the source is evicted
     (GangScheduler.evict_for_migration), so a migration can never
     strand a gang unplaced — even a lost ticket (crash mid-migration,
     destination node fault) leaves the general solve at least the
     gang's own former capacity to re-place into.
  5. AUDIT — every candidate, admitted or rejected, lands in the
     DecisionLog as a migration record (gain, cost, budget state,
     verdict); with `audit` armed (chaos, tests) an overspent budget
     raises instead of passing silently.

Driven on the `defrag.sync_interval_seconds` cadence by
Harness.maybe_defrag (the autoscaler's shape); off by default — see
docs/operations.md "Continuous defragmentation".
"""

from __future__ import annotations

import collections

import numpy as np

from ..api.meta import get_condition
from ..api.podgang import PodGang, PodGangConditionType
from ..api.types import Pod
from ..cluster.cluster import Cluster
from ..solver import encode_podgangs
from ..solver.engine import _NEG
from ..solver.fit import place_gang_in_domain, placement_score_for_nodes
from ..solver.serial import _place_one

#: score-space epsilon: two placements this close are the same quality
_EPS = 1e-9


class DefragController:
    name = "defrag"

    def __init__(self, cluster: Cluster, scheduler):
        self.cluster = cluster
        self.store = cluster.store
        self.cfg = cluster.config.defrag
        self.metrics = cluster.metrics
        self.log = cluster.logger.with_name("defrag")
        #: the gang scheduler whose ENGINE (device-resident state,
        #: incremental caches) the what-ifs ride, and whose migration
        #: tickets / eviction path execute admitted moves
        self.scheduler = scheduler
        self.tenancy = getattr(cluster, "tenancy", None)
        #: virtual time of the last sweep (Harness.maybe_defrag cadence)
        self.last_sync = float("-inf")
        #: virtual timestamps of defrag evictions within the rolling
        #: hour — what max_evictions_per_hour bounds. CLUSTER-owned
        #: (like the DecisionLog and the disruption ledger) so a manager
        #: crash-restart cannot launder a fresh hourly allowance: the
        #: rebuilt controller adopts the same window
        ev = getattr(cluster, "defrag_evictions", None)
        if ev is None:
            ev = cluster.defrag_evictions = collections.deque()
        self._evictions: collections.deque[float] = ev
        #: cumulative engine launch/upload deltas observed across THIS
        #: controller's engine calls — the attribution behind the
        #: bench's "zero full re-encodes from defrag" gate
        self.dispatch_kinds: dict[str, int] = {}
        #: destination node names of the last sweep's admitted moves
        #: (the chaos node-fault-during-a-move target set)
        self.last_move_destinations: list[str] = []
        #: armed audit (chaos + tests, the ownership-audit shape):
        #: a sweep that leaves any tenant's window spend above its
        #: budget raises instead of returning
        self.audit = False
        self.sweeps_total = 0
        self.moves_total = 0

    # -- bookkeeping ---------------------------------------------------------
    def _count_move(self, verdict: str) -> None:
        self.metrics.counter(
            "grove_defrag_moves_total",
            "defrag candidate verdicts (admitted moves vs rejections "
            "by reason)",
        ).inc(verdict=verdict)

    def _gc_evictions(self, now: float) -> None:
        while self._evictions and now - self._evictions[0] > 3600.0:
            self._evictions.popleft()

    def _attribute(self, engine, before: dict | None) -> None:
        """Fold the engine's launch/upload counter deltas since `before`
        into this controller's attribution dict."""
        counts = getattr(engine, "dispatch_counts", None)
        if counts is None or before is None:
            return
        after = counts()
        for kind, n in after.items():
            d = n - before.get(kind, 0)
            if d:
                self.dispatch_kinds[kind] = (
                    self.dispatch_kinds.get(kind, 0) + d
                )
                self.metrics.counter(
                    "grove_defrag_solver_dispatches_total",
                    "engine launches/uploads attributable to defrag "
                    "sweeps, by kind (full/fused/split must stay 0 in "
                    "steady state — the what-if contract)",
                ).inc(d, kind=kind)

    # -- candidate collection ------------------------------------------------
    def _candidates(self, snapshot):
        """Scheduled, fully-bound, non-migrating gangs whose placement
        score has room to improve — worst first, bounded. Candidates
        are dicts carrying the PodGang, its current node indices and
        score."""
        node_index = snapshot.node_index
        # live kind bucket (read-only): the scan peeks every referenced
        # pod of every scheduled gang, and per-peek call overhead is
        # measurable at fleet scale (the scheduler phase sweep's
        # discipline)
        pod_bucket = self.store.kind_bucket(Pod.KIND)
        out = []
        for gang in self.store.scan(PodGang.KIND):
            if gang.metadata.deletion_timestamp is not None:
                continue
            cond = get_condition(
                gang.status.conditions,
                PodGangConditionType.SCHEDULED.value,
            )
            if cond is None or cond.status != "True":
                continue
            key = (gang.metadata.namespace, gang.metadata.name)
            score = gang.status.placement_score
            if key in self.scheduler._migrations:
                continue  # a staged move is already in flight
            # the gang's defining pods (refs up to each group's
            # min_replicas — what the solve placed as one unit); a gang
            # with any unbound/missing member is mid-repair and not a
            # move candidate
            nodes: list[int] = []
            whole = True
            for group in gang.spec.pod_groups:
                for ref in group.pod_references[: group.min_replicas]:
                    pod = pod_bucket.get((ref.namespace, ref.name))
                    if (
                        pod is None
                        or not pod.node_name
                        or pod.metadata.deletion_timestamp is not None
                    ):
                        whole = False
                        break
                    i = node_index.get(pod.node_name)
                    if i is None:
                        whole = False
                        break
                    nodes.append(i)
                if not whole:
                    break
            if not whole or not nodes:
                continue
            idx = np.asarray(nodes, dtype=np.int64)
            cur = (
                float(score)
                if score is not None
                else placement_score_for_nodes(snapshot, idx)
            )
            if cur >= 1.0 - _EPS:
                continue  # already optimally packed
            out.append({"gang": gang, "nodes": idx, "score": cur})
        out.sort(
            key=lambda c: (
                c["score"],
                c["gang"].metadata.namespace,
                c["gang"].metadata.name,
            )
        )
        return out[: self.cfg.candidates_per_sweep]

    # -- the sweep -----------------------------------------------------------
    def sweep(self, storm: bool = False) -> dict:
        """One defragmentation pass. `storm` (chaos only) relaxes the
        gain threshold to "any strict improvement" — a migration storm
        mid-fault-plan — while keeping budgets, rate bounds and
        make-before-break fully armed. Returns the sweep stats dict
        (also the debug surface's last_sweep)."""
        cfg = self.cfg
        now = self.store.clock.now()
        self.last_sync = now
        self.sweeps_total += 1
        self.metrics.counter(
            "grove_defrag_sweeps_total", "defragmentation sweeps run"
        ).inc()
        tracer = self.cluster.tracer
        stats = {
            "at": now,
            "candidates": 0,
            "admitted": 0,
            "rejected": {},
            "whatif": None,
            "storm": bool(storm),
        }
        with tracer.span("defrag.sweep", storm=bool(storm)) as sp:
            snapshot = self.cluster.topology_snapshot()
            sched = self.scheduler
            engine = sched._engine_for(snapshot)
            sched._feed_free_journal(engine, snapshot)
            free = snapshot.free.copy()
            candidates = self._candidates(snapshot)
            # fleet quality gauge: standing between scheduler rounds
            # too (ONE definition — the scheduler's; an empty fleet
            # exports nothing, scores live in (0, 1])
            fleet = sched.placement_scores()
            if fleet:
                sched.export_placement_score(
                    sum(fleet.values()) / len(fleet)
                )
            stats["candidates"] = len(candidates)
            if not candidates:
                sp.set(candidates=0, admitted=0)
                if self.audit:
                    self._audit_budgets(now)
                self._last_sweep = stats
                return stats
            demand_fn = self.cluster.pod_demand_fn(snapshot.resource_names)
            encoded = encode_podgangs(
                [c["gang"] for c in candidates], snapshot, demand_fn,
                priority_of=sched._priority_of,
                pod_scheduling=self.cluster.pod_scheduling_fn(),
            )
            by_name = {
                (g.namespace, g.name): g
                for g in encoded
                if not g.unschedulable_reason
            }
            # ONE device what-if for the whole candidate wave, against
            # the resident state (dirty-row transport; its own dispatch
            # kind). The engine's counter deltas are sampled around the
            # call: full re-encodes attributable to defrag must be zero
            # in steady state, and now they are measured, not assumed.
            whatif = getattr(engine, "whatif_scores", None)
            counts_fn = getattr(engine, "dispatch_counts", None)
            before = counts_fn() if counts_fn is not None else None
            res = whatif(
                list(by_name.values()), free=free
            ) if whatif is not None and by_name else None
            self._attribute(engine, before)
            row_of = {}
            if res is not None:
                top_val, top_dom, order = res
                row_of = {
                    (g.namespace, g.name): i for i, g in enumerate(order)
                }
                stats["whatif"] = "device"
            else:
                stats["whatif"] = "host"
            sched_nodes = np.flatnonzero(snapshot.schedulable)
            self.last_move_destinations = []
            admitted = 0
            min_gain = _EPS if storm else cfg.min_score_gain
            cost = 0.0 if storm else cfg.migration_cost_score
            self._gc_evictions(now)
            for cand in candidates:
                if admitted >= cfg.max_moves_per_sweep:
                    break
                gang = cand["gang"]
                ns = gang.metadata.namespace
                name = gang.metadata.name
                sg = by_name.get((ns, name))
                if sg is None:
                    # the encoding carries an unresolvable constraint
                    # (unschedulable_reason): never move it — but the
                    # audit contract still holds: every examined
                    # candidate gets a verdict + DecisionLog record
                    verdict = "rejected-unschedulable"
                    self._count_move(verdict)
                    self.cluster.decisions.attach_migration(ns, name, {
                        "consumer": "defrag",
                        "verdict": verdict,
                        "current_score": round(cand["score"], 4),
                        "from": sorted({
                            snapshot.node_names[i]
                            for i in cand["nodes"]
                        }),
                        "note": "encoding carries an unresolvable "
                                "constraint; a defrag move would weaken "
                                "a hard hold",
                    })
                    stats["rejected"][verdict] = (
                        stats["rejected"].get(verdict, 0) + 1
                    )
                    continue
                verdict, info = self._evaluate(
                    cand, sg, snapshot, free, sched_nodes,
                    row_of.get((ns, name)),
                    res, min_gain, cost, now,
                )
                self._count_move(verdict)
                self.cluster.decisions.attach_migration(ns, name, info)
                if verdict != "admitted":
                    stats["rejected"][verdict] = (
                        stats["rejected"].get(verdict, 0) + 1
                    )
                    continue
                dest = info["to"]
                pod_keys = [
                    (ref.namespace, ref.name)
                    for group in gang.spec.pod_groups
                    for ref in group.pod_references
                ]
                try:
                    # make-before-break: the destination ticket is held
                    # BEFORE the source eviction frees anything
                    sched.stage_migration(ns, name, dest, pod_keys)
                    sched.evict_for_migration(gang, dest)
                except Exception:
                    # a transient store fault mid-eviction (chaos write
                    # failure, conflict) must not abort the sweep: the
                    # control plane self-heals either half-state — a
                    # lost Scheduled write repairs from bound-pod state,
                    # partially-deleted pods are recreated by the clique
                    # — and the remaining candidates still get their
                    # pass. The staged ticket is rolled back: a gang
                    # that kept its Scheduled condition would otherwise
                    # hold the ticket forever (never in the backlog to
                    # consume it, never a candidate again because a
                    # pending ticket excludes it) instead of retrying
                    # next sweep. ManagerCrash is a BaseException and
                    # still propagates to the chaos loop.
                    sched.unstage_migration(ns, name, pod_keys)
                    self.metrics.counter(
                        "grove_defrag_sweep_errors_total",
                        "per-move execution failures skipped until the "
                        "next sweep",
                    ).inc()
                    stats["rejected"]["error"] = (
                        stats["rejected"].get("error", 0) + 1
                    )
                    continue
                admitted += 1
                self.moves_total += 1
                self._evictions.append(now)
                self.last_move_destinations.extend(dest)
                if info.get("tenant") is not None:
                    self.tenancy.ledger.charge(
                        info["tenant"], "defrag", now
                    )
                self.log.info(
                    "admitted defrag move", namespace=ns, gang=name,
                    gain=info["net_gain"], to=",".join(dest),
                )
            stats["admitted"] = admitted
            sp.set(
                candidates=len(candidates), admitted=admitted,
                whatif=stats["whatif"],
            )
        if self.audit:
            self._audit_budgets(now)
        self._last_sweep = stats
        return stats

    def _evaluate(self, cand, sg, snapshot, free, sched_nodes, row,
                  res, min_gain, cost, now):
        """Score one candidate's best reachable destination and apply
        the admission arithmetic. Trials run against `free` with exact
        row save/restore, so nothing commits until the move is admitted
        (the admit-time re-place is deterministic and commits the
        destination into the sweep's working free). Returns (verdict,
        audit info)."""
        gang = cand["gang"]
        cur = cand["score"]
        info = {
            "consumer": "defrag",
            "current_score": round(cur, 4),
            "migration_cost": cost,
            "threshold": min_gain,
            "from": sorted(
                {snapshot.node_names[i] for i in cand["nodes"]}
            ),
        }
        tenant = (
            self.tenancy.tenant_of_gang(gang)
            if self.tenancy is not None and self.tenancy.enabled
            else None
        )
        if tenant is not None:
            info["tenant"] = tenant
        best_score, best_dom, best_level = -1.0, None, -1
        if row is not None:
            top_val, top_dom, _order = res
            engine = self.scheduler._engine
            for k in range(top_dom.shape[1]):
                if top_val[row, k] <= _NEG / 2:
                    break
                node_idx, level = engine.space.nodes_of(
                    int(top_dom[row, k]), sched_nodes
                )
                score, assign = self._trial(
                    sg, snapshot, free, node_idx, level
                )
                if assign is not None and score > best_score:
                    best_score, best_dom, best_level = (
                        score, node_idx, level
                    )
        else:
            # host fallback (mesh-sharded/custom engines): the exact
            # serial search against a scratch copy — first feasible
            # domain at the narrowest level IS the best reachable score
            scratch = free.copy()
            placed = _place_one(sg, snapshot, scratch, sched_nodes)
            if placed is not None:
                best_score = placed.placement_score
                best_dom = placed.node_indices
                best_level = -2  # marker: assignment already exact
        if best_dom is None:
            info["verdict"] = "rejected-unplaceable"
            info["note"] = (
                "no feasible destination in currently-free capacity "
                "(make-before-break requires the hold to fit now)"
            )
            return "rejected-unplaceable", info
        gain = best_score - cur
        net = gain - cost
        info["candidate_score"] = round(best_score, 4)
        info["gain"] = round(gain, 4)
        info["net_gain"] = round(net, 4)
        if net < min_gain:
            info["verdict"] = "rejected-gain"
            return "rejected-gain", info
        if (
            len(self._evictions) + 1
            > self.cfg.max_evictions_per_hour
        ):
            info["verdict"] = "rejected-rate"
            info["note"] = (
                f"eviction rate bound: {len(self._evictions)} in the "
                f"trailing hour vs {self.cfg.max_evictions_per_hour:g}"
            )
            return "rejected-rate", info
        if tenant is not None:
            budget = self.tenancy.disruption_budget(tenant)
            spent = self.tenancy.ledger.spent(tenant, now)
            if budget is not None:
                info["budget"] = {
                    "limit": budget,
                    "spent_by": self.tenancy.ledger.breakdown(
                        tenant, now
                    ),
                }
                if spent >= budget:
                    info["verdict"] = "rejected-budget"
                    return "rejected-budget", info
        # admit: commit the destination into the sweep's working free so
        # later candidates see the held capacity as taken
        if best_level == -2:
            assign = place_gang_in_domain(
                sg, snapshot, free,
                np.unique(best_dom), -1,
            )
        else:
            assign = place_gang_in_domain(
                sg, snapshot, free, best_dom, best_level
            )
        if assign is None:  # pragma: no cover - trial just succeeded
            info["verdict"] = "rejected-unplaceable"
            return "rejected-unplaceable", info
        info["to"] = sorted({snapshot.node_names[i] for i in assign})
        info["verdict"] = "admitted"
        return "admitted", info

    @staticmethod
    def _trial(sg, snapshot, free, node_idx, level):
        """Exact trial placement with bitwise row restore (no float
        round-trip drift across trials)."""
        if len(node_idx) == 0:
            return -1.0, None
        save = free[node_idx].copy()
        assign = place_gang_in_domain(sg, snapshot, free, node_idx, level)
        if assign is None:
            return -1.0, None
        free[node_idx] = save
        return placement_score_for_nodes(snapshot, assign), assign

    def _audit_budgets(self, now: float) -> None:
        """Armed audit (the ownership-audit shape): after a sweep, no
        tenant's window spend may exceed its budget — across EVERY
        consumer. A violation is a ledger-sharing bug; raise loudly."""
        if self.tenancy is None or not self.tenancy.enabled:
            return
        for tenant in sorted(self.tenancy.queues):
            budget = self.tenancy.disruption_budget(tenant)
            if budget is None:
                continue
            spent = self.tenancy.ledger.spent(tenant, now)
            if spent > budget:
                raise RuntimeError(
                    f"disruption-budget audit: tenant {tenant!r} spent "
                    f"{spent} (by consumer: "
                    f"{self.tenancy.ledger.breakdown(tenant, now)}) "
                    f"over budget {budget} in one window"
                )

    def debug_state(self) -> dict:
        """The debug_dump()['defrag'] block."""
        return {
            "enabled": bool(self.cfg.enabled),
            "sweeps_total": self.sweeps_total,
            "moves_total": self.moves_total,
            "evictions_last_hour": len(self._evictions),
            "pending_migrations": len(self.scheduler._migrations),
            "dispatch_kinds": dict(self.dispatch_kinds),
            "last_sweep": getattr(self, "_last_sweep", None),
        }
