"""The streaming admission→solve front: SLO-aware micro-batches over the
gang scheduler's backlog.

Round-draining solves whatever is pending as one batch — under a burst
storm the round either wedges on an enormous solve or the backlog queues
unboundedly with no deadline semantics. The StreamFront replaces that
with a continuous admission pipeline in front of the existing solve
machinery:

  deadline budgets   every gang entering the stream gets
                     `StreamConfig.slo_seconds` of budget, measured on
                     the virtual clock from stream arrival;
  batching windows   a micro-batch closes when the OLDEST waiter has
                     waited out the current window, when its remaining
                     budget says "admit now or miss the SLO", or when
                     `max_batch_gangs` arrivals are queued — arrivals
                     inside an open window coalesce into one solve;
  pipelining         consecutive micro-batches ride the scheduler's
                     pre_round dispatch/collect split unchanged: batch
                     N+1 encodes and stages deltas (pre_round) while
                     batch N's bind writes flow through the round's host
                     work — the front only decides WHICH keys each round
                     solves, never HOW;
  backpressure       the admission queue is bounded (`queue_cap_gangs`);
                     overflow, an exhausted budget, or a projected wait
                     beyond the SLO sheds the gang with a structured
                     `UnsatCode.DeadlineExceeded` riding the existing
                     explain funnel / condition / unplaced-metric paths;
  brownout ladder    measured queue depth drives graceful degradation:
                     L1 widens the window to `window_max_seconds`
                     (amortize solves), L2 additionally suspends defrag
                     sweeps (`defrag_suspended`, read by
                     Harness.maybe_defrag), L3 sheds waiting gangs
                     band-ordered — best-effort first, then burst-band
                     tenants, guaranteed-band last;
  re-admission       shed gangs stay in the store (Unschedulable, like
                     quota sheds) and park in a shed registry; when
                     depth recovers below `readmit_depth_fraction` they
                     re-enter the stream automatically with FRESH
                     deadlines (the hysteresis gap below
                     `brownout_depth_fraction` prevents oscillation).

Determinism contract (the pre_round adoption guard depends on it):
`plan_round` may mutate front-internal soft state, but calling it twice
at the same virtual instant with the same key set yields the identical
admitted/deferred/shed partition — pre_round's speculative call and the
reconcile's authoritative call must agree or the dispatched solve is
discarded. The admitted subset preserves the caller's key order
(store-scan order), it is filtered, never reordered.

All state here is SOFT: a manager crash-restart rebuilds the front
empty, and every still-pending gang re-registers on the next scan with a
fresh deadline — conservative (more budget once), never a lost gang.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from ..api.config import StreamConfig

Key = tuple  # (namespace, gang name)

#: brownout rungs (see StreamFront.plan_round): the ladder the measured
#: queue-depth fraction climbs. Window widening starts at L1; defrag
#: sweeps stop at L2; band-ordered shedding of waiters starts at L3.
BROWNOUT_WIDEN_LEVEL = 1
BROWNOUT_DEFRAG_LEVEL = 2
BROWNOUT_SHED_LEVEL = 3

#: shed order of the L3 ladder rung: lower rank sheds first. Gangs with
#: no tenant attribution shed before any tenant's work; tenants
#: currently demanding above their guaranteed floor (burst band) shed
#: before tenants inside it.
BAND_SHED_RANK = {"best-effort": 0, "burst": 1, "guaranteed": 2}


@dataclass
class StreamShed:
    """One gang shed this round, pending its Unschedulable stamp."""

    key: Key
    detail: str
    tenant: Optional[str]
    band: str


@dataclass
class StreamPlan:
    """The admitted/deferred/shed partition of one round's backlog."""

    #: keys to solve this round, in the caller's (store-scan) order
    admitted: list = field(default_factory=list)
    #: queue wait (virtual seconds) of each admitted key
    waits: dict = field(default_factory=dict)
    #: sheds needing their DeadlineExceeded stamp (every un-acked shed is
    #: re-reported until ack_shed confirms the stamp landed)
    shed: list = field(default_factory=list)
    #: keys left waiting for their window
    deferred: int = 0
    #: when the scheduler should wake absent any event (None = no timer)
    requeue_after: Optional[float] = None
    #: batching window in effect this round (widened under brownout)
    window_seconds: float = 0.0
    brownout_level: int = 0
    #: shed-registry keys re-entered this round (fresh deadlines)
    readmitted: int = 0


class StreamFront:
    """Soft-state admission front owned by one GangScheduler instance."""

    def __init__(self, cfg: StreamConfig, clock, metrics=None,
                 tenancy=None):
        self.cfg = cfg
        self.clock = clock
        self.metrics = metrics
        #: TenancyManager (or None): band attribution for L3 shed order,
        #: the per-tenant shed counters, and the shared disruption ledger
        self.tenancy = tenancy
        #: key -> stream-arrival virtual time (the deadline budget anchor)
        self._waiting: dict[Key, float] = {}
        #: shed registry: key -> shed virtual time; excluded from
        #: admission until depth recovers, then re-admitted fresh
        self._shed: dict[Key, float] = {}
        #: sheds whose Unschedulable stamp has not been confirmed yet
        #: (reported in every plan until ack_shed)
        self._unacked: dict[Key, StreamShed] = {}
        #: arrival_stall chaos fault: no admissions before this instant
        #: (deadline sheds still run — a stall must shed, not wedge)
        self._stall_until: Optional[float] = None
        self.brownout_level = 0

    # -- capability surface read by the harness / chaos ----------------------
    @property
    def defrag_suspended(self) -> bool:
        """Brownout L2+: Harness.maybe_defrag skips sweeps while set —
        defrag evictions would feed the very backlog we are shedding."""
        return self.brownout_level >= BROWNOUT_DEFRAG_LEVEL

    def queue_depth(self) -> int:
        return len(self._waiting)

    def shed_registry_size(self) -> int:
        return len(self._shed)

    def stall(self, until: float) -> None:
        """Chaos `arrival_stall`: suspend admissions until `until`."""
        cur = self._stall_until
        self._stall_until = until if cur is None else max(cur, until)

    def clear_stall(self) -> None:
        self._stall_until = None

    def debug_state(self) -> dict:
        return {
            "queue_depth": len(self._waiting),
            "shed_registry": len(self._shed),
            "unacked_sheds": len(self._unacked),
            "brownout_level": self.brownout_level,
            "defrag_suspended": self.defrag_suspended,
            "stalled_until": self._stall_until,
        }

    # -- the per-round partition ---------------------------------------------
    def plan_round(
        self, keys, now: float,
        band_of: Optional[Callable[[Key], tuple]] = None,
    ) -> StreamPlan:
        """Partition this round's backlog keys into admitted / deferred /
        shed. Idempotent at one virtual instant (see module docstring):
        registration uses setdefault, sheds move keys out of the waiting
        set exactly once and stay reported until acked, and the window
        decision derives from the post-shed depth so a second call sees
        the same state the first call partitioned."""
        cfg = self.cfg
        keyset = set(keys)
        # prune keys that left the backlog (scheduled or deleted): their
        # soft state must not hold depth hostage
        for book in (self._waiting, self._shed, self._unacked):
            for key in [k for k in book if k not in keyset]:
                del book[key]
        plan = StreamPlan()
        # re-admission: depth recovered below the hysteresis floor ->
        # every ACKED shed re-enters with a fresh deadline (un-acked
        # sheds wait for their stamp first, so a shed is never silently
        # retracted before it was ever visible)
        depth_frac = len(self._waiting) / cfg.queue_cap_gangs
        if self._shed and depth_frac <= cfg.readmit_depth_fraction:
            # bounded re-fill, oldest shed first: dumping the whole
            # registry back would re-overflow the queue and churn
            # shed<->readmit. The fill target sits strictly ABOVE the
            # re-admit floor (so one plan's re-fill ends the condition —
            # the idempotency contract) and below the brownout rung
            fill_to = max(
                int(cfg.readmit_depth_fraction * cfg.queue_cap_gangs) + 1,
                int(cfg.brownout_depth_fraction * cfg.queue_cap_gangs) - 1,
            )
            room = max(0, fill_to - len(self._waiting))
            acked = sorted(
                (t, k) for k, t in self._shed.items()
                if k not in self._unacked
            )
            for _, key in acked[:room]:
                del self._shed[key]
                self._waiting[key] = now
                plan.readmitted += 1
            if plan.readmitted:
                self._count("grove_stream_readmitted_total",
                            "shed gangs re-admitted after depth recovery",
                            plan.readmitted)
        # register new arrivals (idempotent: an existing waiter keeps its
        # original arrival time — the budget anchor never resets here)
        for key in keys:
            if key not in self._shed:
                self._waiting.setdefault(key, now)
        # measured depth BEFORE this round's sheds: what the brownout
        # ladder and the shed decisions react to
        depth = len(self._waiting)
        level_pre = self._level(depth)
        self._plan_sheds(now, depth, level_pre, band_of)
        # window from POST-shed depth: a second plan_round at this same
        # instant starts from exactly this state, so both calls pick the
        # same window and the same admitted batch
        self.brownout_level = self._level(len(self._waiting))
        window = (
            cfg.window_max_seconds
            if self.brownout_level >= BROWNOUT_WIDEN_LEVEL
            else cfg.window_min_seconds
        )
        plan.window_seconds = window
        plan.brownout_level = self.brownout_level
        plan.shed = list(self._unacked.values())
        self._plan_admission(plan, keys, now, window)
        plan.deferred = len(self._waiting) - len(plan.admitted)
        if self.metrics is not None:
            self.metrics.gauge(
                "grove_stream_queue_depth",
                "gangs waiting in the streaming admission queue",
            ).set(len(self._waiting))
            self.metrics.gauge(
                "grove_stream_brownout_level",
                "streaming brownout ladder rung (0 = normal; 1 widened "
                "window; 2 defrag suspended; 3 shedding waiters)",
            ).set(self.brownout_level)
        return plan

    def _level(self, depth: int) -> int:
        """Brownout rung from a measured depth — purely depth-derived
        (no path dependence), so repeated evaluation is stable."""
        cfg = self.cfg
        frac = depth / cfg.queue_cap_gangs
        b = cfg.brownout_depth_fraction
        if frac < b:
            return 0
        step = (1.0 - b) / 3.0
        if step <= 0:  # brownout at the cap itself: any breach is L3
            return BROWNOUT_SHED_LEVEL
        return min(
            BROWNOUT_SHED_LEVEL, 1 + int((frac - b) / step)
        )

    def _plan_sheds(self, now: float, depth: int,
                    level: int, band_of) -> None:
        """Move this round's sheds out of the waiting set (oldest-first
        order is PRESERVED for survivors). Four cuts, each structured
        into the shed detail: queue overflow, exhausted budget, projected
        wait beyond the SLO, and the brownout L3 band ladder."""
        cfg = self.cfg
        if not self._waiting:
            return
        by_age = sorted(
            self._waiting.items(), key=lambda kv: (kv[1], kv[0])
        )
        survivors = []
        # stalled admissions (chaos arrival_stall) shed ONLY on exhausted
        # budgets: projected waits are unknowable mid-stall, and overflow
        # still applies below
        stalled = self._stall_until is not None and now < self._stall_until
        for key, arrival in by_age:
            waited = now - arrival
            if waited >= cfg.slo_seconds:
                self._shed_one(key, now, band_of, (
                    f"deadline exceeded: waited {waited:.3f}s of the "
                    f"{cfg.slo_seconds:g}s stream SLO budget"
                ))
                continue
            survivors.append((key, arrival))
        if len(survivors) > cfg.queue_cap_gangs:
            # bounded queue: the NEWEST arrivals beyond the cap shed
            # (backpressure at the door; the oldest keep their place)
            for key, _ in survivors[cfg.queue_cap_gangs:]:
                self._shed_one(key, now, band_of, (
                    f"queue overflow: admission queue at "
                    f"{len(survivors)} gangs exceeds the "
                    f"{cfg.queue_cap_gangs}-gang cap"
                ))
            survivors = survivors[:cfg.queue_cap_gangs]
        if not stalled:
            window = (
                cfg.window_max_seconds
                if level >= BROWNOUT_WIDEN_LEVEL
                else cfg.window_min_seconds
            )
            kept = []
            for pos, (key, arrival) in enumerate(survivors):
                # projected wait: full windows for the whole batches
                # queued ahead of this position
                projected = (pos // cfg.max_batch_gangs) * window
                remaining = cfg.slo_seconds - (now - arrival)
                if projected > remaining:
                    self._shed_one(key, now, band_of, (
                        f"projected wait beyond SLO: "
                        f"{projected:.3f}s of queued batches ahead "
                        f"exceeds the {remaining:.3f}s remaining budget"
                    ))
                else:
                    kept.append((key, arrival))
            survivors = kept
        if level >= BROWNOUT_SHED_LEVEL:
            # L3: shed down to below the L3 rung, cheapest band first
            # (best-effort, then burst-band tenants, guaranteed last);
            # within a band the newest arrival sheds first
            cfg_b = cfg.brownout_depth_fraction
            target = max(
                cfg.max_batch_gangs,
                int((cfg_b + 2.0 * (1.0 - cfg_b) / 3.0)
                    * cfg.queue_cap_gangs) - 1,
            )
            if len(survivors) > target:
                ranked = sorted(
                    survivors,
                    key=lambda kv: (
                        BAND_SHED_RANK.get(
                            self._band(kv[0], band_of)[1], 0
                        ),
                        -kv[1], kv[0],
                    ),
                )
                doomed = set(
                    k for k, _ in ranked[: len(survivors) - target]
                )
                for key, arrival in survivors:
                    if key in doomed:
                        band = self._band(key, band_of)[1]
                        self._shed_one(key, now, band_of, (
                            f"brownout shed: queue depth {depth} at "
                            f"ladder level {level}; {band}-band work "
                            "shed to protect guaranteed tenants"
                        ))
                survivors = [
                    kv for kv in survivors if kv[0] not in doomed
                ]

    def _band(self, key: Key, band_of) -> tuple:
        if band_of is None:
            return None, "best-effort"
        return band_of(key)

    def _shed_one(self, key: Key, now: float, band_of,
                  detail: str) -> None:
        tenant, band = self._band(key, band_of)
        self._waiting.pop(key, None)
        self._shed[key] = now
        self._unacked[key] = StreamShed(
            key=key, detail=detail, tenant=tenant, band=band
        )

    def _plan_admission(self, plan: StreamPlan, keys, now: float,
                        window: float) -> None:
        """Close (or hold) the batching window over the post-shed waiting
        set. Admission never mutates the waiting set — the reconcile's
        `consumed()` call does, after the solve actually ran — so the
        speculative and authoritative plans of one instant agree."""
        cfg = self.cfg
        if not self._waiting:
            if self._shed:
                # an idle front with a populated shed registry must wake
                # to re-admit once depth has recovered
                plan.requeue_after = cfg.window_min_seconds
            return
        if self._stall_until is not None and now < self._stall_until:
            plan.requeue_after = max(
                self._stall_until - now, cfg.window_min_seconds
            )
            return
        by_age = sorted(
            self._waiting.items(), key=lambda kv: (kv[1], kv[0])
        )
        oldest_wait = now - by_age[0][1]
        budget_left = cfg.slo_seconds - oldest_wait
        closed = (
            oldest_wait >= window
            or budget_left <= window
            or len(by_age) >= cfg.max_batch_gangs
        )
        if not closed:
            plan.requeue_after = max(window - oldest_wait, 1e-3)
            return
        batch = {k for k, _ in by_age[: cfg.max_batch_gangs]}
        plan.admitted = [k for k in keys if k in batch]
        plan.waits = {
            k: now - a for k, a in by_age[: cfg.max_batch_gangs]
        }
        if len(by_age) > cfg.max_batch_gangs:
            # more full-or-partial batches queued: wake for the next
            # window even if no event arrives in between
            next_wait = now - by_age[cfg.max_batch_gangs][1]
            plan.requeue_after = max(window - next_wait, 1e-3)

    # -- consume-time hooks (reconcile only) ---------------------------------
    def consumed(self, admitted, waits: dict, now: float) -> None:
        """The reconcile solved this batch: record queue waits ONCE (the
        speculative plan must not double-count) and refresh the budget of
        every admitted key — a gang the solver left unplaced stays in the
        backlog on the capacity/retry path with a fresh stream budget
        (its wait-to-first-solve was served; what remains is a capacity
        fact, not a queueing fact). Placed gangs leave the scan and are
        pruned on the next plan."""
        hist = None
        if self.metrics is not None and admitted:
            hist = self.metrics.histogram(
                "grove_stream_queue_wait_seconds",
                "stream admission queue wait (arrival -> solve batch)",
            )
            self._count("grove_stream_admitted_total",
                        "gangs admitted into stream micro-batches",
                        len(admitted))
        for key in admitted:
            if hist is not None:
                hist.observe(float(waits.get(key, 0.0)))
            if key in self._waiting:
                self._waiting[key] = now

    def ack_shed(self, keys, now: float) -> None:
        """The reconcile stamped these sheds: stop re-reporting them,
        count them per tenant/band, and charge the tenant's shared
        disruption ledger (preemption, defrag and stream sheds draw from
        ONE budget window — see tenancy.DisruptionLedger)."""
        for key in keys:
            shed = self._unacked.pop(key, None)
            if shed is None:
                continue
            if self.metrics is not None:
                self.metrics.counter(
                    "grove_stream_shed_total",
                    "gangs shed by the streaming admission front "
                    "(UnsatCode.DeadlineExceeded) by tenant and band",
                ).inc(tenant=shed.tenant or "", band=shed.band)
            if (
                shed.tenant is not None
                and self.tenancy is not None
                and getattr(self.tenancy, "enabled", False)
            ):
                self.tenancy.ledger.charge(
                    shed.tenant, "stream-shed", now
                )

    def _count(self, name: str, help_text: str, n: int) -> None:
        if self.metrics is not None and n:
            self.metrics.counter(name, help_text).inc(float(n))
