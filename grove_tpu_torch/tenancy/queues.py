"""Multi-tenant scheduling: hierarchical tenant queues, quota admission,
and dominant-resource fairness.

The reference delegates all multi-tenant arbitration to the external KAI
scheduler — its e2e applies `queues.yaml` and PodGang merely carries
`PriorityClassName` (SURVEY §4, scheduler/api/core/v1alpha1/podgang.go).
grove_tpu owns the scheduler, so it owns tenant arbitration, TPU-native:

  TenantQueue     one node of the configured queue hierarchy
                  (api.config.TenancyConfig.tenants): guaranteed/burst
                  quota per resource, DRF weight, priority tier, optional
                  parent (an ancestor's quota binds every descendant) and
                  per-round disruption budget.
  TenancyManager  the runtime: attributes PodGangs to tenants (label ->
                  namespace -> default), refreshes per-queue committed
                  usage from SCHEDULED gangs' bound pods, classifies each
                  arriving gang into ADMIT / QUEUE / SHED, computes
                  dominant-resource shares + entitlements, and stamps a
                  per-gang fairness weight consumed by the solver
                  (SolverGang.fairness -> gang_sort_key ordering + a
                  weighted column in the batched cost tensor).

Admission bands, checked up the whole ancestor chain:

  ADMIT  usage + demand within `guaranteed` on every resource it names —
         the tenant is inside its floor; its gangs sort ahead of every
         burst-band gang of the same priority tier.
  QUEUE  within `burst` (absent resource = unlimited) but beyond the
         guarantee — burst-eligible; DRF deficit orders these gangs
         against each other, so under-served tenants win contention.
  SHED   `burst` would be exceeded on some resource — the gang is held
         with a structured `UnsatCode.QuotaExceeded` diagnosis (metrics,
         conditions, decision log and the explain funnel all attribute
         it); preemption never runs for it (evicting OTHER tenants
         cannot lower THIS tenant's usage).

Fairness (DRF): a tenant's dominant share is max_r usage_r / capacity_r;
its entitlement is the weight-proportional slice of the dominant capacity
the burst-eligible set actually consumes. The signed, normalized deficit
(entitlement - share) scales into the per-gang fairness weight:

  fairness = w * (2 + clip(deficit))   for ADMIT   (always in [w, 3w])
  fairness = w * clip(deficit)         for QUEUE   (always in [-w, w])

so guarantee-band gangs strictly outrank burst-band gangs at equal
priority, and within the burst band under-share tenants go first. The
weights ride into the solver as `SolverGang.fairness`: `gang_sort_key`
orders the commit scan's rows by (priority, fairness), and the value
tensor carries the weight as an extra per-gang column (solver/engine.py)
— fairness is columns in the solve, not a host-side sorter bolted on in
front of it.

Everything here is host-side numpy over state the scheduler already
reads; nothing rides the device path.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..api.config import TenancyConfig
from ..observability.explain import UnsatCode, UnsatDiagnosis

_EPS = 1e-9

#: admission decisions (classify() return vocabulary)
ADMIT = "admit"
QUEUE = "queue"
SHED = "shed"


class TenantQueue:
    """One runtime node of the tenant-queue hierarchy: the validated
    config entry plus this round's accounting (committed usage vector,
    dominant share, entitlement, deficit, burst eligibility)."""

    __slots__ = (
        "name", "guaranteed", "burst", "weight", "tier", "parent",
        "disruption_budget", "children", "usage", "dominant_share",
        "entitlement", "deficit", "burst_eligible", "active",
        "conditions",
    )

    def __init__(self, spec: dict, default_tier: str):
        self.name: str = spec["name"]
        self.guaranteed: dict[str, float] = {
            r: float(v) for r, v in spec.get("guaranteed", {}).items()
        }
        self.burst: dict[str, float] = {
            r: float(v) for r, v in spec.get("burst", {}).items()
        }
        self.weight: float = float(spec.get("weight", 1.0))
        self.tier: str = spec.get("tier") or default_tier
        self.parent: str = spec.get("parent", "")
        budget = spec.get("disruption_budget")
        self.disruption_budget: Optional[int] = (
            None if budget is None else int(budget)
        )
        self.children: list[str] = []
        # per-refresh accounting (resource axis = snapshot.resource_names)
        self.usage: np.ndarray = np.zeros(0, np.float64)
        self.dominant_share: float = 0.0
        self.entitlement: float = 0.0
        self.deficit: float = 0.0
        #: the tenant competed beyond its guarantee this round (usage or
        #: classified-QUEUE demand above the floor) — the set fairness
        #: error is measured over
        self.burst_eligible: bool = False
        #: usage > 0 or pending gangs this round
        self.active: bool = False
        #: DisruptionTarget-style conditions stamped by external
        #: observers (the SLO engine's `SLOViolation`, api/meta
        #: Condition objects) — in-memory, surfaced via debug_state
        self.conditions: list = []


class DisruptionLedger:
    """Shared per-tenant disruption spend across EVERY consumer.

    A tenant's `disruption_budget` used to bound one preemption pass in
    isolation; with the defragmenter also evicting gangs, the budget
    must bound the SUM — a preemption round followed by a defrag sweep
    (or vice versa) can never double-spend it. Charges are
    (virtual timestamp, consumer) entries in a rolling window
    (`tenancy.disruption_budget_window_seconds`); `spent()` counts the
    live window and `breakdown()` attributes it per consumer, so every
    budget audit names WHO spent WHAT. Virtual-clock timestamps keep
    the ledger deterministic under the chaos replayer.

    Owned by the TenancyManager (cluster-owned), so spends survive
    manager crash-restarts within the window — a restart cannot be used
    to launder a fresh budget."""

    def __init__(self, window_seconds: float = 60.0):
        self.window = float(window_seconds)
        #: tenant -> list[(virtual ts, consumer)] — pruned on access
        self._spends: dict[str, list[tuple[float, str]]] = {}

    def _live(self, tenant: str, now: float) -> list[tuple[float, str]]:
        entries = self._spends.get(tenant)
        if not entries:
            return []
        horizon = now - self.window
        live = [e for e in entries if e[0] > horizon]
        if live:
            self._spends[tenant] = live
        else:
            del self._spends[tenant]
        return live

    def charge(self, tenant: str, consumer: str, now: float,
               n: int = 1) -> None:
        # prune on WRITE too: tenants without a configured budget are
        # charged (preemption charges every victim tenant) but never
        # read, and read-side-only pruning would grow their entry lists
        # without bound across weeks of eviction churn
        entries = self._spends.setdefault(tenant, [])
        horizon = now - self.window
        if entries and entries[0][0] <= horizon:
            entries[:] = [e for e in entries if e[0] > horizon]
        entries.extend((now, consumer) for _ in range(n))

    def spent(self, tenant: str, now: float) -> int:
        return len(self._live(tenant, now))

    def breakdown(self, tenant: str, now: float) -> dict[str, int]:
        """Window spend per consumer — the audit payload."""
        out: dict[str, int] = {}
        for _, consumer in self._live(tenant, now):
            out[consumer] = out.get(consumer, 0) + 1
        return out


class TenancyManager:
    """Runtime tenant arbitration bound to one validated TenancyConfig.

    Owned by the Cluster (like the metrics registry and decision log) so
    tenant accounting survives scheduler engine rebuilds and manager
    crash-restarts; the GangScheduler drives `annotate()` once per
    backlog encode. All methods are cheap host-side passes; `annotate`
    additionally walks the PodGang kind bucket once to rebuild committed
    usage (only when tenancy is enabled and a backlog exists)."""

    def __init__(self, cfg: TenancyConfig, metrics=None):
        self.cfg = cfg
        self.metrics = metrics
        self.queues: dict[str, TenantQueue] = {}
        self.tier_values: dict[str, float] = {}
        #: resource axis of the last refresh (usage vectors align to it)
        self._last_resource_names: Optional[list[str]] = None
        #: the shared disruption-budget ledger (preemption + defrag draw
        #: from it); created once so spends survive configure() reloads
        self.ledger = DisruptionLedger(cfg.disruption_budget_window_seconds)
        self.configure(cfg)

    # -- configuration -------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return bool(self.cfg.enabled)

    def configure(self, cfg: TenancyConfig) -> None:
        """(Re)build the queue hierarchy from a validated config. Metrics
        series of tenants that no longer exist are reconciled away on the
        next export (see _export_metrics — the Gauge.label_sets/remove
        pattern the per-node lifecycle gauges use)."""
        self.cfg = cfg
        self.ledger.window = float(cfg.disruption_budget_window_seconds)
        self.queues = {
            t["name"]: TenantQueue(t, cfg.default_tier) for t in cfg.tenants
        }
        for q in self.queues.values():
            if q.parent:
                self.queues[q.parent].children.append(q.name)
        self.tier_values = {
            t["name"]: float(t["value"]) for t in cfg.tiers
        }

    def tier_value(self, tier: str) -> float:
        return self.tier_values.get(tier, 0.0)

    def tier_names(self) -> set[str]:
        return set(self.tier_values)

    def disruption_budget(self, tenant: str) -> Optional[int]:
        q = self.queues.get(tenant)
        return q.disruption_budget if q is not None else None

    # -- attribution ---------------------------------------------------------
    def tenant_of(self, namespace: str, labels: dict | None) -> Optional[str]:
        """PodGang -> tenant name: the tenant label wins, namespace ==
        tenant name is the fallback, then the configured default tenant;
        None = exempt (unknown workload with no default — admitted
        untracked with zero fairness weight)."""
        if labels:
            t = labels.get(self.cfg.tenant_label)
            if t and t in self.queues:
                return t
        if namespace in self.queues:
            return namespace
        return self.cfg.default_tenant or None

    def tenant_of_gang(self, gang) -> Optional[str]:
        return self.tenant_of(gang.metadata.namespace, gang.metadata.labels)

    def stream_band(self, tenant: Optional[str]) -> str:
        """Shed-ordering band for the streaming brownout ladder (L3):
        "best-effort" (no tenant attribution) sheds first, then "burst"
        — queues currently demanding above their guaranteed floor
        (burst_eligible, the same flag the fairness error measures over)
        — and "guaranteed" work sheds last."""
        q = self.queues.get(tenant) if tenant is not None else None
        if q is None:
            return "best-effort"
        return "burst" if q.burst_eligible else "guaranteed"

    def tier_of_gang(self, gang) -> str:
        """The tier defaulted onto a gang with an empty
        priority_class_name: its tenant's tier, else the config default."""
        t = self.tenant_of_gang(gang)
        q = self.queues.get(t) if t is not None else None
        return q.tier if q is not None else self.cfg.default_tier

    def _chain(self, tenant: str):
        """The queue and its ancestors, leaf first (validated acyclic)."""
        q = self.queues.get(tenant)
        while q is not None:
            yield q
            q = self.queues.get(q.parent) if q.parent else None

    # -- accounting ----------------------------------------------------------
    def refresh(self, store, snapshot, demand_fn) -> None:
        """Rebuild per-queue committed usage from SCHEDULED gangs' bound
        referenced pods (the DRF input: what each tenant actually holds),
        then aggregate leaf usage up the hierarchy and recompute dominant
        shares. One pass over the PodGang kind bucket + pod peeks; runs
        once per solve round."""
        from ..api.meta import get_condition
        from ..api.podgang import PodGang, PodGangConditionType
        from ..api.types import Pod

        nres = len(snapshot.resource_names)
        self._last_resource_names = list(snapshot.resource_names)
        for q in self.queues.values():
            q.usage = np.zeros(nres, np.float64)
            q.active = False
            q.burst_eligible = False
        pods = store.kind_bucket(Pod.KIND)
        for gang in store.kind_bucket(PodGang.KIND).values():
            if gang.metadata.deletion_timestamp is not None:
                continue
            cond = get_condition(
                gang.status.conditions, PodGangConditionType.SCHEDULED.value
            )
            if cond is None or cond.status != "True":
                continue
            tenant = self.tenant_of_gang(gang)
            q = self.queues.get(tenant) if tenant is not None else None
            if q is None:
                continue
            for group in gang.spec.pod_groups:
                for ref in group.pod_references:
                    pod = pods.get((ref.namespace, ref.name))
                    if (
                        pod is None
                        or not pod.node_name
                        or pod.metadata.deletion_timestamp is not None
                    ):
                        continue
                    d = demand_fn(ref.namespace, ref.name)
                    if d is not None:
                        q.usage += d
        # leaf usage propagates up: an ancestor queue's quota binds the
        # subtree's TOTAL consumption. Own (pre-aggregation) usage is
        # snapshotted first — propagating live totals would double-count
        # a grandchild at the root once its parent's turn came.
        own_usage = {name: q.usage.copy() for name, q in self.queues.items()}
        for name, q in self.queues.items():
            if not q.parent:
                continue
            for anc in self._chain(q.parent):
                anc.usage += own_usage[name]
        cap = np.maximum(snapshot.capacity.sum(axis=0), _EPS)
        for name, q in self.queues.items():
            # DRF shares/activity come from OWN consumption: the
            # aggregated q.usage mirrors descendants onto ancestors (the
            # quota view), and summing both a child's and its parent's
            # mirrored share would double-count real consumption in the
            # entitlement denominator
            q.dominant_share = (
                float((own_usage[name] / cap).max()) if nres else 0.0
            )
            q.active = bool(own_usage[name].any())
            # SUBTREE usage already beyond the floor keeps a tenant in
            # the fairness-error population even with nothing pending
            if any(
                q.usage[i] > q.guaranteed.get(r, 0.0) + 1e-6
                for i, r in enumerate(snapshot.resource_names)
            ):
                q.burst_eligible = True

    def _update_entitlements(self) -> None:
        """Weight-proportional entitlement over the dominant capacity the
        ACTIVE set consumes: each active tenant is entitled to
        weight/sum(weights) of the active tenants' total dominant share,
        so |share - entitlement| is the redistribution DRF still owes.
        Deficit is normalized by the entitlement and clipped to [-1, 1]
        before it scales into fairness weights."""
        active = [q for q in self.queues.values() if q.active]
        total_w = sum(q.weight for q in active)
        total_s = sum(q.dominant_share for q in active)
        for q in self.queues.values():
            if q.active and total_w > 0:
                q.entitlement = q.weight / total_w * total_s
            else:
                # an inactive tenant is owed nothing yet; its first gang
                # still gets the full positive deficit below
                q.entitlement = 0.0
            base = max(q.entitlement, 1e-6)
            raw = (q.entitlement - q.dominant_share) / base
            if not q.active:
                raw = 1.0  # nothing held yet: maximal claim on fairness
            q.deficit = float(np.clip(raw, -1.0, 1.0))

    def fairness_error(self) -> float:
        """max |dominant share - entitlement| over the burst-eligible
        tenants — the bench's bounded-fairness number. Tenants inside
        their guarantee are excluded: the guarantee, not DRF, sets their
        share."""
        errs = [
            abs(q.dominant_share - q.entitlement)
            for q in self.queues.values()
            if q.burst_eligible
        ]
        return max(errs) if errs else 0.0

    # -- admission -----------------------------------------------------------
    def classify(
        self, tenant: Optional[str], demand: np.ndarray,
        resource_names: list[str],
    ) -> tuple[str, Optional[dict]]:
        """One gang's admission decision against the tenant's whole
        ancestor chain: SHED when any queue's burst ceiling would be
        crossed (detail names the binding queue/resource arithmetic),
        QUEUE when any guarantee is exceeded but every ceiling holds,
        ADMIT when the chain stays inside its floors."""
        if tenant is None:
            return ADMIT, None
        decision = ADMIT
        for q in self._chain(tenant):
            for i, res in enumerate(resource_names):
                projected = float(q.usage[i]) + float(demand[i])
                ceiling = q.burst.get(res)
                if ceiling is not None and projected > ceiling + 1e-6:
                    return SHED, {
                        "tenant": tenant,
                        "queue": q.name,
                        "band": "burst",
                        "resource": res,
                        "usage": round(float(q.usage[i]), 6),
                        "demand": round(float(demand[i]), 6),
                        "limit": ceiling,
                    }
                if projected > q.guaranteed.get(res, 0.0) + 1e-6:
                    decision = QUEUE
        return decision, None

    # -- the per-round annotation pass ---------------------------------------
    def annotate(self, podgangs, encoded, snapshot, store,
                 demand_fn, count: bool = True) -> dict[str, float]:
        """The scheduler's one call per backlog encode: refresh committed
        usage + DRF shares, classify every encoded gang (stamping
        `SolverGang.fairness`, and an `UnsatCode.QuotaExceeded` hold on
        shed gangs), export per-tenant metrics, and return the
        {gang name: fairness weight} vector the scheduler threads into
        `PlacementEngine.solve(..., fairness=...)`.

        Admission is capacity-cumulative within the round: an admitted/
        queued gang's demand counts against its queue chain for the NEXT
        gang's classification (first-come within the backlog's priority
        order), so one round cannot admit 2x the ceiling in one burst.
        Holds already on a gang (unresolved topology level) are never
        overwritten — they are harder than quota.

        Decisions are STAMPED (`sg.tenant_decision`), not counted: a
        round may run annotate twice (pre_round speculation + the
        reconcile fallback when the dispatch is not adopted) but
        consumes exactly one pass's stamps — the scheduler calls
        count_decisions() on the consumed gang list so the admission
        counters stay once-per-solve. Direct users (`count=True`,
        the default) count inline."""
        self.refresh(store, snapshot, demand_fn)
        self._update_entitlements()
        # gauges reflect COMMITTED state: exported before the in-round
        # projected-demand charging below mutates q.usage, so
        # grove_tenant_usage and grove_tenant_dominant_share agree
        # within one scrape
        self._export_metrics()
        by_key = {
            (pg.metadata.namespace, pg.metadata.name): pg
            for pg in podgangs
        }
        res_names = snapshot.resource_names
        w = float(self.cfg.fairness_weight)
        fairness: dict[str, float] = {}

        def stamp(sg, tenant, decision, fair):
            sg.fairness = float(fair)
            sg.tenant_decision = (
                None if decision is None else (tenant, decision)
            )
            # namespace-qualified key (same-named gangs in two tenants'
            # namespaces must not share a weight); stamp_fairness
            # resolves this form first
            fairness[f"{sg.namespace}/{sg.name}"] = float(fair)

        for sg in encoded:
            pg = by_key.get((sg.namespace, sg.name))
            tenant = self.tenant_of_gang(pg) if pg is not None else None
            if tenant is None:
                stamp(sg, None, None, 0.0)
                continue
            q = self.queues[tenant]
            q.active = True
            if sg.unschedulable_reason:
                # a topology hold: no admission decision, no quota charge
                stamp(sg, tenant, None, 0.0)
                continue
            demand = np.asarray(sg.total_demand(), np.float64)
            decision, detail = self.classify(tenant, demand, res_names)
            if decision == SHED:
                sg.unschedulable_reason = UnsatDiagnosis(
                    f"tenant {tenant} over quota: queue {detail['queue']} "
                    f"would exceed its burst ceiling on "
                    f"{detail['resource']} (usage {detail['usage']:g} + "
                    f"demand {detail['demand']:g} > {detail['limit']:g})",
                    code=UnsatCode.QUOTA,
                    funnel={"quota": detail},
                )
                stamp(sg, tenant, SHED, 0.0)
                continue
            if decision == QUEUE:
                fair = w * q.deficit
                for anc in self._chain(tenant):
                    anc.burst_eligible = True
            else:
                fair = w * (2.0 + q.deficit)
            stamp(sg, tenant, decision, fair)
            # charge the chain so the NEXT gang of this round sees the
            # projected usage, not the stale committed floor
            for anc in self._chain(tenant):
                anc.usage += demand
        if count:
            self.count_decisions(encoded)
        return fairness

    def count_decisions(self, encoded) -> None:
        """Feed the admission counters from one CONSUMED annotate pass's
        stamps (see annotate — once per solve, not per speculation)."""
        for sg in encoded:
            stamped = getattr(sg, "tenant_decision", None)
            if stamped is None:
                continue
            tenant, decision = stamped
            self._count_decision(tenant, decision)
            if decision == SHED:
                self._count_shed(tenant)

    # -- metrics -------------------------------------------------------------
    def _count_decision(self, tenant: str, decision: str) -> None:
        if self.metrics is None:
            return
        self.metrics.counter(
            "grove_tenant_admissions_total",
            "tenant admission decisions (admit / queue / shed)",
        ).inc(tenant=tenant, decision=decision)

    def _count_shed(self, tenant: str) -> None:
        if self.metrics is None:
            return
        self.metrics.counter(
            "grove_tenant_gangs_shed_total",
            "gangs shed by quota admission (UnsatCode.QuotaExceeded)",
        ).inc(tenant=tenant)

    def _export_metrics(self) -> None:
        """Per-tenant gauge series (dominant share, DRF deficit,
        per-resource usage), reconciled against the live tenant set via
        the Gauge.label_sets/remove API so a removed tenant's series do
        not linger on /metrics forever — the same hygiene pattern as the
        per-node lifecycle gauges."""
        if self.metrics is None:
            return
        share_g = self.metrics.gauge(
            "grove_tenant_dominant_share",
            "per-tenant dominant-resource share of cluster capacity",
        )
        deficit_g = self.metrics.gauge(
            "grove_tenant_fairness_deficit",
            "per-tenant normalized DRF deficit (entitlement - share)",
        )
        usage_g = self.metrics.gauge(
            "grove_tenant_usage",
            "per-tenant committed resource usage",
        )
        live = set(self.queues)
        for g in (share_g, deficit_g, usage_g):
            for labels in g.label_sets():
                if labels.get("tenant") not in live:
                    g.remove(**labels)
        # same hygiene for the scheduler's per-tenant bind-latency
        # histogram: a torn-down tenant's latency series (and its
        # quantile lines) must leave the exposition with the tenant
        latency_h = self.metrics.get(
            "grove_scheduler_tenant_bind_latency_seconds"
        )
        if latency_h is not None:
            for labels in latency_h.label_sets():
                if labels.get("tenant") not in live:
                    latency_h.remove(**labels)
        for name, q in self.queues.items():
            share_g.set(q.dominant_share, tenant=name)
            deficit_g.set(q.deficit, tenant=name)
            # usage gauges only for resources the quota names (bounded
            # series count; the full vector lives in debug_state)
            for res in set(q.guaranteed) | set(q.burst):
                # resource axis may not carry the quota'd resource on
                # exotic snapshots; report 0 rather than invent series
                usage_g.set(
                    self._usage_of(q, res), tenant=name, resource=res
                )

    def _usage_of(self, q: TenantQueue, res: str) -> float:
        names = self._last_resource_names
        if names is None or res not in names:
            return 0.0
        return float(q.usage[names.index(res)])

    def refresh_and_export(self, store, snapshot, demand_fn) -> None:
        """Accounting + metrics without an admission pass (bench/report
        sampling between solve rounds)."""
        self.refresh(store, snapshot, demand_fn)
        self._update_entitlements()
        self._export_metrics()

    # -- introspection -------------------------------------------------------
    def debug_state(self) -> dict:
        """debug_dump()["tenancy"] payload: the queue tree with this
        round's arithmetic."""
        return {
            "enabled": self.enabled,
            "fairness_error": round(self.fairness_error(), 6),
            "tenants": {
                name: {
                    "tier": q.tier,
                    "weight": q.weight,
                    "parent": q.parent or None,
                    "dominant_share": round(q.dominant_share, 6),
                    "entitlement": round(q.entitlement, 6),
                    "deficit": round(q.deficit, 6),
                    "burst_eligible": q.burst_eligible,
                    "disruption_budget": q.disruption_budget,
                    "usage": [round(float(v), 4) for v in q.usage],
                    "conditions": [
                        {
                            "type": c.type,
                            "status": c.status,
                            "reason": c.reason,
                            "message": c.message,
                            "last_transition_time": c.last_transition_time,
                        }
                        for c in q.conditions
                    ],
                }
                for name, q in sorted(self.queues.items())
            },
        }
