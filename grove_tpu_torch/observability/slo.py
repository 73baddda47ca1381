"""Continuous SLO evaluation: windowed sampling, burn-rate alerts, scorecard.

The system declares SLOs in three places — streaming deadline budgets
(streaming/front.py), tenant starvation/fairness bounds (tenancy/), and
failover walls (cluster/replication.py) — but until this module every
verdict lived in a bench exit code. `SLOEngine` closes the loop inside
the running control plane:

  sampler    each sweep snapshots selected registry metrics into bounded
             per-series rings keyed by VIRTUAL time — counters as
             interval rates, gauges as last value, histograms as
             windowed percentiles (widened when the reservoir says the
             percentile is an estimate, see Histogram.is_estimated).
  SLIs       each declarative objective (SLOConfig.objectives) scores
             the interval since the last sweep as (bad, total) units:
             ratio objectives count real events (binds over threshold /
             binds), probe objectives count sweeps (starved-too-long /
             sweeps). good + bad == total by construction, so the
             error-budget arithmetic sums exactly.
  alerting   multi-window multi-burn-rate (the SRE-workbook shape): a
             "page" pair of short windows with a high burn threshold
             catches a 10x burst within seconds, a "ticket" pair of
             long windows with a low threshold catches a slow leak
             before the budget exhausts. An alert trips only when BOTH
             windows of its pair burn over the pair's threshold
             (pending -> firing after a confirming sweep), and resolves
             once the SHORT window recovers — the state machine emits
             Events, bumps `grove_slo_alerts_total{slo,severity}`,
             exports `grove_slo_{error_budget_remaining,burn_rate}`
             gauges, and stamps a DisruptionTarget-style
             `SLOViolation` condition on the offending tenant's queue.
  scorecard  `scorecard()` is the ROADMAP-item-3 JSON (per-tenant SLO
             table, budget spent, alert history), surfaced through
             `Harness.slo_scorecard()`, `debug_dump()["slo"]`, the gRPC
             Debug service, chaos wedged postmortems, and the
             `python -m grove_tpu_torch.observability.slo` CLI.

The engine is cluster-owned SOFT state (like DecisionLog/PodMetrics):
nothing here is persisted, it survives `cold_restart()` and
`promote_standby()` with the cluster object, and a genuinely new
process simply re-warms — the first sweep baselines every cumulative
counter at its current value, so restarts never manufacture alerts.
All of its store writes are Events (advisory, excluded from the chaos
settled fingerprint); ChaosHarness routes them through the RAW store so
SLO sweeps consume zero fault-plan draws and pre-existing seeds replay
bit-identically with SLO evaluation on or off.

The counterpart of grove_tpu/observability/slo.py. It reads the
cluster's metrics registry on the host; nothing here touches the card.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import deque
from typing import Any, Optional

from ..api.meta import ObjectMeta, set_condition
from .events import EventRecorder

# ---------------------------------------------------------------------------
# Shared verdict vocabulary (bench.py re-asserts through these — one
# vocabulary across the live engine, the stream bench, and CI gates).

VERDICT_OK = "ok"
VERDICT_BURNING = "burning"
VERDICT_BREACH = "breach"

_VERDICT_RANK = {VERDICT_OK: 0, VERDICT_BURNING: 1, VERDICT_BREACH: 2}

#: alert severities = the two window pairs
SEVERITY_PAGE = "page"
SEVERITY_TICKET = "ticket"

#: alert state machine states
ALERT_INACTIVE = "inactive"
ALERT_PENDING = "pending"
ALERT_FIRING = "firing"
ALERT_RESOLVED = "resolved"

#: condition type stamped on the offending tenant's queue (the
#: DisruptionTarget analog: downstream controllers/debug readers see
#: WHY a tenant is degraded without reading alert internals)
SLO_VIOLATION_CONDITION = "SLOViolation"

#: evaluated when SLOConfig.objectives is empty — one objective per SLO
#: the system already declares elsewhere
DEFAULT_OBJECTIVES: tuple[dict, ...] = (
    {"name": "bind-latency-p99", "kind": "bind_latency_p99",
     "target": 0.99, "threshold_seconds": 30.0, "per_tenant": True},
    {"name": "starvation", "kind": "starvation",
     "target": 0.99, "max_starved_seconds": 60.0},
    {"name": "shed-rate", "kind": "shed_rate",
     "target": 0.99, "ceiling_per_second": 0.5},
    {"name": "placement-drift", "kind": "placement_drift",
     "target": 0.95, "band": 0.2},
    {"name": "failover-wall", "kind": "failover_wall",
     "target": 0.999, "max_failovers": 0},
)

#: per-kind threshold parameter and its default (mirrors
#: api/config._SLO_OBJECTIVE_KINDS, which validates at load time)
_KIND_PARAMS = {
    "bind_latency_p99": ("threshold_seconds", 30.0),
    "starvation": ("max_starved_seconds", 60.0),
    "shed_rate": ("ceiling_per_second", 0.5),
    "placement_drift": ("band", 0.2),
    "failover_wall": ("max_failovers", 0),
}


def worst_verdict(verdicts) -> str:
    worst = VERDICT_OK
    for v in verdicts:
        if _VERDICT_RANK.get(v, 0) > _VERDICT_RANK[worst]:
            worst = v
    return worst


def static_entry(
    name: str,
    kind: str,
    observed: float,
    threshold: Optional[float] = None,
    unit: str = "",
    tenant: Optional[str] = None,
    higher_is_better: bool = False,
    **params: Any,
) -> dict:
    """One scorecard row from a point measurement (no windows, no
    alerting) — how bench.py re-asserts its verdicts through the same
    schema and vocabulary the live engine exports. `threshold=None`
    makes the row informational (always `ok`)."""
    verdict = VERDICT_OK
    if threshold is not None:
        breached = (
            observed < threshold if higher_is_better else observed > threshold
        )
        verdict = VERDICT_BREACH if breached else VERDICT_OK
    return {
        "slo": name,
        "kind": kind,
        "tenant": tenant,
        "observed": observed,
        "threshold": threshold,
        "higher_is_better": higher_is_better,
        "unit": unit,
        "params": dict(params),
        "verdict": verdict,
    }


def compose_scorecard(entries: list[dict], virtual_clock: float = 0.0) -> dict:
    """Assemble static entries into the scorecard envelope (same shape
    as SLOEngine.scorecard(), with `source: "static"`)."""
    return {
        "enabled": True,
        "source": "static",
        "virtual_clock": virtual_clock,
        "slos": list(entries),
        "alerts_firing": 0,
        "alert_history": [],
        "verdict": worst_verdict(e.get("verdict", VERDICT_OK) for e in entries),
    }


class _SLORef:
    """Synthetic involved-object for alert Events (EventRecorder only
    reads KIND + metadata.name/namespace)."""

    KIND = "SLO"

    def __init__(self, name: str):
        self.metadata = ObjectMeta(name=name, namespace="grove-slo")


class _Objective:
    """One normalized declarative SLO object."""

    __slots__ = ("name", "kind", "target", "per_tenant", "param", "params")

    def __init__(self, spec: dict):
        self.name: str = spec["name"]
        self.kind: str = spec["kind"]
        self.target: float = float(spec.get("target", 0.99))
        self.per_tenant: bool = bool(spec.get("per_tenant", False))
        pname, pdefault = _KIND_PARAMS[self.kind]
        self.param = spec.get(pname, pdefault)
        self.params = {pname: self.param}


class SLOEngine:
    """The windowed sampler + burn-rate evaluator (module docstring has
    the shape). One instance per Cluster when `config.slo.enabled`."""

    def __init__(self, cfg, metrics, clock):
        self.cfg = cfg
        self.metrics = metrics
        self.clock = clock
        specs = cfg.objectives or [dict(o) for o in DEFAULT_OBJECTIVES]
        self.objectives = [_Objective(s) for s in specs]
        #: sweep-cadence gate read by Harness.maybe_slo_sweep (the
        #: autoscaler/defrag last_sync shape)
        self.last_sync = float("-inf")
        self.sweeps = 0
        self._last_sweep_at: Optional[float] = None
        #: sampler rings: (instance key, field) -> deque[(t, value)]
        self._rings: dict[tuple, deque] = {}
        #: SLI rings: instance key -> deque[(t, bad, total)]
        self._sli: dict[tuple, deque] = {}
        #: cumulative-counter baselines, (instance key, field) -> value
        self._prev: dict[tuple, float] = {}
        #: starvation continuity: instance key -> starved-since time
        self._starved_since: dict[tuple, float] = {}
        #: alert state: (slo, tenant, severity) -> state dict
        self._alerts: dict[tuple, dict] = {}
        #: bounded alert-transition history (scorecard + chaos gate)
        self.history: deque = deque(maxlen=cfg.history_limit)
        self._last_eval: dict[tuple, dict] = {}
        self._rec: Optional[tuple] = None
        #: critical-path provider (a Tracer; set by
        #: Cluster.enable_tracing): a firing bind-latency objective
        #: attaches its worst offenders' reconstructed critical paths to
        #: the scorecard so the alert names the dominating segment
        self.path_source = None

    # -- sweep ------------------------------------------------------------

    def sweep(self, store=None, tenancy=None) -> dict:
        """One evaluation pass at the current virtual time: sample, score
        SLIs, run the alert machines, export gauges. Evaluation-only —
        the only store writes are advisory Events (best-effort)."""
        now = self.clock.now()
        dt = 0.0 if self._last_sweep_at is None else now - self._last_sweep_at
        transitions = 0
        live: set[tuple] = set()
        for obj, tenant in self._instances(tenancy):
            key = (obj.name, tenant)
            live.add(key)
            bad, total, current = self._score(obj, tenant, key, now, dt, store)
            ring = self._sli.get(key)
            if ring is None:
                ring = self._sli[key] = deque(
                    maxlen=self.cfg.max_samples_per_series
                )
            ring.append((now, bad, total))
            self._prune(ring, now)
            burns = {
                "page_short": self._burn(ring, now, self.cfg.page_short_seconds, obj.target),
                "page_long": self._burn(ring, now, self.cfg.page_long_seconds, obj.target),
                "ticket_short": self._burn(ring, now, self.cfg.ticket_short_seconds, obj.target),
                "ticket_long": self._burn(ring, now, self.cfg.ticket_long_seconds, obj.target),
            }
            for sev, long_w, short_w, thresh in (
                (SEVERITY_PAGE, "page_long", "page_short",
                 self.cfg.page_burn_threshold),
                (SEVERITY_TICKET, "ticket_long", "ticket_short",
                 self.cfg.ticket_burn_threshold),
            ):
                transitions += self._alert_update(
                    obj, tenant, sev, burns[long_w], burns[short_w],
                    thresh, now, store, tenancy,
                )
            self._last_eval[key] = self._entry(
                obj, tenant, key, now, burns, current
            )
        self._reconcile(live)
        self.sweeps += 1
        self._last_sweep_at = now
        self.last_sync = now
        firing = self.firing()
        return {
            "now": now,
            "instances": len(live),
            "transitions": transitions,
            "firing": len(firing),
        }

    def firing(self) -> list[dict]:
        """Currently-firing alerts (chaos gates assert this drains)."""
        return [
            {"slo": slo, "tenant": tenant, "severity": sev,
             "since": st["since"]}
            for (slo, tenant, sev), st in sorted(
                self._alerts.items(), key=lambda kv: (kv[0][0], kv[0][1] or "", kv[0][2])
            )
            if st["state"] == ALERT_FIRING
        ]

    # -- instance expansion & scoring ------------------------------------

    def _instances(self, tenancy):
        out = []
        for obj in self.objectives:
            if (
                obj.per_tenant
                and tenancy is not None
                and getattr(tenancy, "enabled", False)
                and tenancy.queues
            ):
                for tenant in sorted(tenancy.queues):
                    out.append((obj, tenant))
            else:
                out.append((obj, None))
        return out

    def _score(self, obj, tenant, key, now, dt, store):
        """Score the interval since the last sweep as (bad, total) SLI
        units plus the current-signal snapshot for the scorecard."""
        if obj.kind == "bind_latency_p99":
            return self._score_bind_latency(obj, tenant, key, now)
        if obj.kind == "starvation":
            return self._score_starvation(obj, key, now, store)
        if obj.kind == "shed_rate":
            return self._score_shed_rate(obj, key, now, dt)
        if obj.kind == "placement_drift":
            return self._score_drift(obj, key, now)
        return self._score_failover(obj, key, now)

    def _score_bind_latency(self, obj, tenant, key, now):
        # ratio SLI on real events: binds over threshold / binds, from
        # the exact cumulative count plus count_over on the retained
        # samples. Past the reservoir cap count_over is an estimate —
        # widen the violation threshold by 10% so a sampled tail must
        # clear a wider band before it burns budget.
        if tenant is not None:
            h = self.metrics.get("grove_scheduler_tenant_bind_latency_seconds")
            kw = {"tenant": tenant}
        else:
            h = self.metrics.get("grove_scheduler_gang_bind_latency_seconds")
            kw = {}
        count = h.series_count(**kw) if h is not None else 0
        estimated = h.is_estimated(**kw) if h is not None else False
        threshold = float(obj.param) * (1.1 if estimated else 1.0)
        over = h.count_over(threshold, **kw) if h is not None else 0
        prev_count = self._baseline(key, "count", count)
        prev_over = self._baseline(key, "over", over)
        total = max(0, count - prev_count)
        bad = min(max(0, over - prev_over), total)
        self._prev[(key, "count")] = count
        self._prev[(key, "over")] = over
        p99 = h.percentile(99, **kw) if h is not None else 0.0
        self._sample(key, "p99", now, p99)
        return bad, total, {
            "p99_seconds": round(p99, 6),
            "estimated": estimated,
            "binds_in_interval": total,
            "over_threshold_in_interval": bad,
        }

    def _score_starvation(self, obj, key, now, store):
        # two starvation faces, one objective: SCHEDULED gangs stuck with
        # unbound pods (the starved set, aged by this engine's own timer)
        # and pending gangs that never placed at all — aged by scanning
        # the store directly rather than trusting a scheduler gauge. The
        # distinction matters under fault: a wedged scheduler stops
        # exporting fresh gauges exactly when starvation is worst, and an
        # SLO evaluator that only reads the wedged component's self-report
        # would sleep through the page. The scan is read-only; on the
        # chaos path it runs against the raw store (zero fault draws).
        g = self.metrics.get("grove_scheduler_starved_gangs")
        starved = g.value() if g is not None else 0.0
        if starved > 0:
            since = self._starved_since.setdefault(key, now)
            starved_for = now - since
        else:
            self._starved_since.pop(key, None)
            starved_for = 0.0
        pending_age = self._oldest_pending(store, now)
        p = self.metrics.get("grove_scheduler_oldest_pending_seconds")
        if p is not None:
            pending_age = max(pending_age, p.value())
        worst = max(starved_for, pending_age)
        bad = 1 if worst >= float(obj.param) else 0
        self._sample(key, "starved_gangs", now, starved)
        return bad, 1, {
            "starved_gangs": starved,
            "starved_for_seconds": round(starved_for, 6),
            "oldest_pending_seconds": round(pending_age, 6),
        }

    @staticmethod
    def _oldest_pending(store, now: float) -> float:
        """Age of the oldest live workload still waiting to run, measured
        from the store (0.0 without a store or with an empty backlog).
        Two depths of waiting count: a PodGang not yet Scheduled (the
        scheduler backlog), and a PodCliqueSet the controllers have NEVER
        processed (observed_generation still 0 — under a severe fault the
        workload piles up before gangs even exist, and a starvation
        signal that starts at the gang misses it entirely)."""
        if store is None:
            return 0.0
        oldest = None
        for gang in store.scan("PodGang"):
            if gang.metadata.deletion_timestamp is not None:
                continue
            if any(
                c.type == "Scheduled" and c.status == "True"
                for c in (gang.status.conditions or ())
            ):
                continue
            created = gang.metadata.creation_timestamp
            if oldest is None or created < oldest:
                oldest = created
        for pcs in store.scan("PodCliqueSet"):
            if pcs.metadata.deletion_timestamp is not None:
                continue
            if pcs.status.observed_generation != 0:
                continue
            created = pcs.metadata.creation_timestamp
            if oldest is None or created < oldest:
                oldest = created
        return max(0.0, now - oldest) if oldest is not None else 0.0

    def _score_shed_rate(self, obj, key, now, dt):
        # counters -> interval rate: stream sheds + tenant-quota sheds
        # spend one ceiling (they are the same user-visible refusal)
        cum = 0.0
        for name in ("grove_stream_shed_total", "grove_tenant_gangs_shed_total"):
            c = self.metrics.get(name)
            if c is not None:
                cum += c.total()
        prev = self._baseline(key, "sheds", cum)
        self._prev[(key, "sheds")] = cum
        delta = max(0.0, cum - prev)
        rate = delta / dt if dt > 0 else 0.0
        self._sample(key, "shed_rate", now, rate)
        bad = 1 if rate > float(obj.param) else 0
        return bad, 1, {
            "shed_rate_per_second": round(rate, 6),
            "sheds_in_interval": delta,
        }

    def _score_drift(self, obj, key, now):
        # gauge -> last value; drift = spread of the sampled ring over
        # the slow page window (degradation over time, not one dip)
        g = self.metrics.get("grove_scheduler_placement_score")
        if g is None or not g.label_sets():
            # score never exported: vacuous sample (0 units) rather
            # than treating "no data" as a violation
            return 0, 0, {"placement_score": None, "spread": 0.0}
        score = g.value()
        ring = self._sample(key, "placement_score", now, score)
        window = [v for t, v in ring if t > now - self.cfg.page_long_seconds]
        spread = (max(window) - min(window)) if len(window) >= 2 else 0.0
        bad = 1 if spread > float(obj.param) else 0
        return bad, 1, {
            "placement_score": round(score, 6),
            "spread": round(spread, 6),
        }

    def _score_failover(self, obj, key, now):
        # counter -> interval delta on store recoveries (cold restarts +
        # promotions land here; a refused promotion is fencing WORKING,
        # not a failover, so fence-refused is excluded)
        c = self.metrics.get("grove_store_recoveries_total")
        cum = 0.0
        if c is not None:
            for labels in c.label_sets():
                if labels.get("outcome") != "fence-refused":
                    cum += c.value(**labels)
        prev = self._baseline(key, "recoveries", cum)
        self._prev[(key, "recoveries")] = cum
        delta = max(0.0, cum - prev)
        self._sample(key, "recoveries", now, cum)
        bad = 1 if delta > float(obj.param) else 0
        return bad, 1, {"recoveries_in_interval": delta}

    # -- ring plumbing ----------------------------------------------------

    def _baseline(self, key, field, current):
        """First sight of a cumulative counter baselines it at its
        current value (delta 0) — re-warm after restart, never a
        manufactured alert."""
        return self._prev.setdefault((key, field), current)

    def _sample(self, key, field, now, value) -> deque:
        ring = self._rings.get((key, field))
        if ring is None:
            ring = self._rings[(key, field)] = deque(
                maxlen=self.cfg.max_samples_per_series
            )
        ring.append((now, value))
        self._prune(ring, now)
        return ring

    def _prune(self, ring: deque, now: float) -> None:
        horizon = now - self.cfg.budget_window_seconds
        while ring and ring[0][0] <= horizon:
            ring.popleft()

    def _window(self, ring, now, window_seconds):
        """(bad, total) sums over SLI samples inside one window."""
        bad = 0.0
        total = 0.0
        for t, b, n in reversed(ring):
            if t <= now - window_seconds:
                break
            bad += b
            total += n
        return bad, total

    def _burn(self, ring, now, window_seconds, target) -> float:
        """burn rate = (bad fraction in window) / (allowed bad fraction).
        1.0 means burning exactly at budget; 0 when the window has no
        units (no traffic is not a violation)."""
        bad, total = self._window(ring, now, window_seconds)
        if total <= 0:
            return 0.0
        return (bad / total) / (1.0 - target)

    # -- alert state machine ----------------------------------------------

    def _alert_update(
        self, obj, tenant, severity, burn_long, burn_short,
        threshold, now, store, tenancy,
    ) -> int:
        akey = (obj.name, tenant, severity)
        st = self._alerts.get(akey)
        if st is None:
            st = self._alerts[akey] = {
                "state": ALERT_INACTIVE, "since": now, "pending_since": None,
            }
        tripped = burn_long >= threshold and burn_short >= threshold
        state = st["state"]
        new = None
        if state in (ALERT_INACTIVE, ALERT_RESOLVED):
            if tripped:
                new = ALERT_PENDING
                st["pending_since"] = now
        elif state == ALERT_PENDING:
            if not tripped:
                new = ALERT_INACTIVE
            elif now - st["pending_since"] >= max(
                self.cfg.pending_for_seconds, 1e-9
            ):
                # pending_for 0 still demands one strictly-later
                # confirming sweep — a one-sample spike never pages
                new = ALERT_FIRING
        elif state == ALERT_FIRING:
            if burn_short < threshold:
                # the short window is the resolver: it forgets the
                # fault fastest once the signal actually recovers
                new = ALERT_RESOLVED
        if new is None:
            return 0
        self.history.append({
            "at": now,
            "slo": obj.name,
            "tenant": tenant,
            "severity": severity,
            "from": state,
            "to": new,
            "burn_short": round(burn_short, 4),
            "burn_long": round(burn_long, 4),
        })
        st["state"] = new
        st["since"] = now
        detail = (
            f"burn {burn_long:.1f}x(long)/{burn_short:.1f}x(short) vs "
            f"{threshold}x {severity} threshold"
        )
        if new == ALERT_FIRING:
            self.metrics.counter(
                "grove_slo_alerts_total",
                "alert firings by SLO and severity",
            ).inc(slo=obj.name, severity=severity)
            self._emit(store, "warning", obj, tenant, "SLOBurnRate",
                       f"{obj.name} firing: {detail}")
            self._stamp(tenancy, tenant, now, "True",
                        reason=f"{severity.capitalize()}Burn",
                        message=f"{obj.name}: {detail}")
        elif new == ALERT_RESOLVED:
            self._emit(store, "normal", obj, tenant, "SLORecovered",
                       f"{obj.name} resolved: {detail}")
            if tenant is not None and not any(
                s["state"] == ALERT_FIRING
                for (slo, t, sev), s in self._alerts.items()
                if t == tenant
            ):
                self._stamp(tenancy, tenant, now, "False",
                            reason="Recovered",
                            message=f"{obj.name} recovered")
        return 1

    def _emit(self, store, kind, obj, tenant, reason, message) -> None:
        """Best-effort Event emission: events are advisory, so a chaos
        TransientFault/ConflictStorm must not abort the sweep.
        (ManagerCrash subclasses BaseException and still escapes to the
        chaos wrapper, like every other sweep.)"""
        if store is None:
            return
        rec = self._recorder(store)
        ref = _SLORef(obj.name if tenant is None else f"{obj.name}.{tenant}")
        try:
            if kind == "warning":
                rec.warning(ref, reason, message)
            else:
                rec.normal(ref, reason, message)
        except Exception:
            pass

    def _recorder(self, store) -> EventRecorder:
        if self._rec is None or self._rec[0] is not store:
            # stores are replaced wholesale on cold_restart/promotion;
            # rebind rather than write through a dead store
            self._rec = (store, EventRecorder(store, controller="slo-engine"))
        return self._rec[1]

    def _stamp(self, tenancy, tenant, now, status, reason, message) -> None:
        """DisruptionTarget-style condition on the offending tenant's
        queue (in-memory, surfaced via tenancy debug_state)."""
        if tenancy is None or tenant is None:
            return
        queue = tenancy.queues.get(tenant)
        conditions = getattr(queue, "conditions", None)
        if conditions is None:
            return
        set_condition(conditions, SLO_VIOLATION_CONDITION, status,
                      reason=reason, message=message, now=now)

    # -- scorecard --------------------------------------------------------

    def _entry(self, obj, tenant, key, now, burns, current) -> dict:
        ring = self._sli.get(key, ())
        bad, total = self._window(ring, now, self.cfg.budget_window_seconds)
        good = total - bad
        allowed = (1.0 - obj.target) * total
        spent_fraction = (bad / allowed) if allowed > 0 else 0.0
        remaining = 1.0 - spent_fraction
        alerts = {}
        for sev in (SEVERITY_PAGE, SEVERITY_TICKET):
            st = self._alerts.get((obj.name, tenant, sev))
            alerts[sev] = {
                "state": st["state"] if st else ALERT_INACTIVE,
                "since": st["since"] if st else None,
            }
        if allowed > 0 and bad > allowed:
            verdict = VERDICT_BREACH
        elif any(a["state"] in (ALERT_PENDING, ALERT_FIRING)
                 for a in alerts.values()):
            verdict = VERDICT_BURNING
        else:
            verdict = VERDICT_OK
        lab = {"slo": obj.name}
        if tenant is not None:
            lab["tenant"] = tenant
        self.metrics.gauge(
            "grove_slo_error_budget_remaining",
            "error budget remaining over the budget window "
            "(1 = untouched, <= 0 = exhausted)",
        ).set(round(remaining, 6), **lab)
        burn_gauge = self.metrics.gauge(
            "grove_slo_burn_rate",
            "burn rate by alert window (1.0 = burning exactly at budget)",
        )
        for window, value in burns.items():
            burn_gauge.set(round(value, 6), window=window, **lab)
        entry = {
            "slo": obj.name,
            "kind": obj.kind,
            "tenant": tenant,
            "target": obj.target,
            "params": dict(obj.params),
            "samples": {"good": good, "bad": bad, "total": total},
            "error_budget": {
                "allowed_bad": allowed,
                "spent_bad": bad,
                "spent_fraction": round(spent_fraction, 6),
                "remaining_fraction": round(remaining, 6),
                "remaining_clamped": max(0.0, min(1.0, round(remaining, 6))),
            },
            "burn": {w: round(v, 6) for w, v in burns.items()},
            "alerts": alerts,
            "current": current,
            "verdict": verdict,
        }
        if (
            obj.kind == "bind_latency_p99"
            and verdict != VERDICT_OK
            and self.path_source is not None
            and getattr(self.path_source, "enabled", False)
        ):
            # the alert answers "where did the latency go": the fleet's
            # dominating segment + the slowest gangs' decomposed paths
            # (observability/causal.py; same surface debug_dump shows)
            report = self.path_source.flush_critical_paths(self.metrics)
            entry["critical_path"] = {
                "dominant_segment": report.get("dominant_segment"),
                "worst_offenders": list(report.get("top", ()))[:5],
            }
        return entry

    def _reconcile(self, live: set[tuple]) -> None:
        """Series hygiene: drop engine state and exported gauge series
        for instances that no longer exist (a torn-down tenant), the
        Gauge.label_sets/remove pattern tenancy uses."""
        for key in list(self._last_eval):
            if key not in live:
                del self._last_eval[key]
        for key in list(self._sli):
            if key not in live:
                del self._sli[key]
        for key, field in list(self._rings):
            if key not in live:
                del self._rings[(key, field)]
        for key, field in list(self._prev):
            if key not in live:
                del self._prev[(key, field)]
        for key in list(self._starved_since):
            if key not in live:
                del self._starved_since[key]
        for akey in list(self._alerts):
            if (akey[0], akey[1]) not in live:
                del self._alerts[akey]
        for name in ("grove_slo_error_budget_remaining", "grove_slo_burn_rate"):
            g = self.metrics.get(name)
            if g is None:
                continue
            for labels in g.label_sets():
                if (labels.get("slo"), labels.get("tenant")) not in live:
                    g.remove(**labels)

    def scorecard(self) -> dict:
        """The ROADMAP-item-3 JSON: per-tenant SLO table, budget spent,
        alert history. JSON-safe (no inf/nan)."""
        entries = [
            self._last_eval[key]
            for key in sorted(
                self._last_eval, key=lambda k: (k[0], k[1] or "")
            )
        ]
        return {
            "enabled": True,
            "source": "engine",
            "virtual_clock": self.clock.now(),
            "sweeps": self.sweeps,
            "last_sweep_at": self._last_sweep_at,
            "config": {
                "sync_interval_seconds": self.cfg.sync_interval_seconds,
                "budget_window_seconds": self.cfg.budget_window_seconds,
                "page": {
                    "short_seconds": self.cfg.page_short_seconds,
                    "long_seconds": self.cfg.page_long_seconds,
                    "burn_threshold": self.cfg.page_burn_threshold,
                },
                "ticket": {
                    "short_seconds": self.cfg.ticket_short_seconds,
                    "long_seconds": self.cfg.ticket_long_seconds,
                    "burn_threshold": self.cfg.ticket_burn_threshold,
                },
            },
            "slos": entries,
            "alerts_firing": len(self.firing()),
            "alert_history": list(self.history),
            "verdict": worst_verdict(
                e["verdict"] for e in entries
            ) if entries else VERDICT_OK,
        }


# ---------------------------------------------------------------------------
# CLI: render a scorecard JSON (or run a self-contained demo).


def render_scorecard(card: dict) -> str:
    """Human-readable scorecard table (engine and static cards)."""
    if not card or not card.get("enabled", False):
        return "SLO evaluation disabled (config.slo.enabled: false)\n"
    out = [
        f"SLO scorecard @ t={card.get('virtual_clock') or 0.0:.1f}s  "
        f"sweeps={card.get('sweeps', 0)}  "
        f"firing={card.get('alerts_firing', 0)}  "
        f"verdict={card.get('verdict', VERDICT_OK).upper()}",
        "",
        f"{'SLO':<24} {'TENANT':<12} {'VERDICT':<8} {'BUDGET':>7} "
        f"{'PAGE':<9} {'TICKET':<9} CURRENT",
    ]
    for e in card.get("slos", []):
        budget = e.get("error_budget", {}).get("remaining_clamped")
        if isinstance(budget, (int, float)):
            budget_s = f"{budget * 100:6.1f}%"
        elif e.get("threshold") is not None:
            budget_s = f"{e['observed']:.3g}/{e['threshold']:.3g}"
        else:
            budget_s = "-"
        alerts = e.get("alerts", {})
        page = alerts.get(SEVERITY_PAGE, {}).get("state", "-")
        ticket = alerts.get(SEVERITY_TICKET, {}).get("state", "-")
        current = e.get("current")
        if current is None:
            unit = f" {e['unit']}" if e.get("unit") else ""
            current = f"observed={e.get('observed')}{unit}"
        else:
            current = " ".join(f"{k}={v}" for k, v in current.items())
        out.append(
            f"{e['slo']:<24} {e.get('tenant') or '-':<12} "
            f"{e['verdict']:<8} {budget_s:>7} {page:<9} {ticket:<9} {current}"
        )
    history = card.get("alert_history", [])
    if history:
        out += ["", f"alert history (last {min(len(history), 12)}):"]
        for h in history[-12:]:
            tenant = f"[{h['tenant']}]" if h.get("tenant") else ""
            out.append(
                f"  t={h['at']:>8.1f}s  {h['slo']}{tenant} "
                f"{h['severity']}: {h['from']} -> {h['to']} "
                f"(burn long={h['burn_long']}x short={h['burn_short']}x)"
            )
    return "\n".join(out) + "\n"


def _demo_scorecard() -> dict:
    """Seeded, self-contained demo: healthy traffic, a latency+shed
    fault, recovery — shows the full pending->firing->resolved
    lifecycle without needing a harness."""
    from ..api.config import SLOConfig
    from .metrics import MetricsRegistry

    class _Clock:
        def __init__(self):
            self.t = 0.0

        def now(self):
            return self.t

    cfg = SLOConfig(
        enabled=True,
        sync_interval_seconds=5.0,
        budget_window_seconds=600.0,
        page_short_seconds=10.0,
        page_long_seconds=30.0,
        page_burn_threshold=5.0,
        ticket_short_seconds=30.0,
        ticket_long_seconds=120.0,
        ticket_burn_threshold=2.0,
        objectives=[
            {"name": "demo-bind-p99", "kind": "bind_latency_p99",
             "target": 0.9, "threshold_seconds": 2.0},
            {"name": "demo-shed-rate", "kind": "shed_rate",
             "target": 0.9, "ceiling_per_second": 1.0},
        ],
    )
    clock = _Clock()
    metrics = MetricsRegistry()
    engine = SLOEngine(cfg, metrics, clock)
    hist = metrics.histogram("grove_scheduler_gang_bind_latency_seconds")
    sheds = metrics.counter("grove_stream_shed_total")
    for phase, rounds, latency, shed_per_round in (
        ("healthy", 6, 0.2, 0),
        ("fault", 5, 9.0, 12),
        ("recovery", 10, 0.2, 0),
    ):
        for _ in range(rounds):
            for _ in range(8):
                hist.observe(latency)
            if shed_per_round:
                sheds.inc(shed_per_round, tenant="demo", band="burst")
            clock.t += cfg.sync_interval_seconds
            engine.sweep()
    return engine.scorecard()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m grove_tpu_torch.observability.slo",
        description="Render an SLO scorecard (harness.slo_scorecard() / "
        "chaos_sweep --scorecard output), or run a seeded demo.",
    )
    parser.add_argument(
        "scorecard", nargs="?",
        help="scorecard JSON file (a bare card, or the chaos_sweep "
        "--scorecard {'seeds': ...} envelope)",
    )
    parser.add_argument("--demo", action="store_true",
                        help="run the built-in seeded fault/recovery demo")
    parser.add_argument("--json", action="store_true",
                        help="emit JSON instead of the table")
    args = parser.parse_args(argv)
    if args.demo:
        cards = {"demo": _demo_scorecard()}
    elif args.scorecard:
        with open(args.scorecard) as fh:
            data = json.load(fh)
        cards = data["seeds"] if "seeds" in data else {"": data}
        cards = {str(k): v for k, v in cards.items() if v}
    else:
        parser.error("need a scorecard JSON path or --demo")
    if args.json:
        payload = (
            next(iter(cards.values())) if len(cards) == 1 else cards
        )
        print(json.dumps(payload, indent=2, sort_keys=True))
        return 0
    for label, card in cards.items():
        if label:
            print(f"== {label} ==")
        sys.stdout.write(render_scorecard(card))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
