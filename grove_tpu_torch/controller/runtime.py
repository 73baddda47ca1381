"""Controller runtime: the controller-runtime Manager equivalent.

The reference hosts three reconcilers on controller-runtime with watch
predicates and per-controller workqueues
(operator/internal/controller/{manager,register}.go). Here the runtime is a
deterministic single-threaded loop over the store's event log:

  events -> per-controller map_event() (the watch predicate + handler
  mapping) -> dedup'd work queue -> Reconcile(ns, name) -> store writes ->
  more events ... until fixpoint.

Requeue-after (the reference's ERR_REQUEUE_AFTER flow control,
internal/errors/) is a time-heap against the virtual clock; tests advance
the clock and re-settle. Determinism is the point: the reference's E2E
suites fight eventual consistency with Eventually() polling; here a settled
state is exactly reproducible.
"""

from __future__ import annotations

import heapq
import itertools
import time
import zlib
from dataclasses import dataclass
from typing import Optional, Protocol

from ..cluster.store import Event, ObjectStore, StoreError
from ..observability.tracing import NOOP_TRACER

#: circuit-breaker states (exposed via breaker_state()/metrics: the gauge
#: reads 0.0 closed, 0.5 half-open, 1.0 open)
BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half-open"
_BREAKER_GAUGE = {BREAKER_CLOSED: 0.0, BREAKER_HALF_OPEN: 0.5,
                  BREAKER_OPEN: 1.0}


@dataclass(frozen=True, slots=True)
class Request:
    namespace: str
    name: str


@dataclass(slots=True)
class Result:
    """Reconcile outcome. requeue_after: seconds (virtual) until the same
    request should be retried even without new events."""

    requeue_after: Optional[float] = None
    error: Optional[str] = None


class Reconciler(Protocol):
    name: str
    #: kinds this controller watches (None = every kind). The manager
    #: routes events by kind (the controller-runtime Watches() registration
    #: analog) so a pod status write is not offered to controllers that
    #: could never care — per-event map_event fan-out across all
    #: controllers was measurable at 10^5-event settle scale.
    watch_kinds: Optional[frozenset[str]]

    def map_event(self, event: Event) -> list[Request]:
        """Watch predicate + event-to-primary mapping. Return the primary
        requests this event should enqueue ([] to ignore)."""
        ...

    def reconcile(self, request: Request) -> Result: ...


class ControllerManager:
    def __init__(self, store: ObjectStore, identity: str | None = None,
                 error_backoff_base_seconds: float = 1.0,
                 error_backoff_max_seconds: float = 60.0,
                 error_retry_budget: int = 8, logger=None,
                 metrics=None, elector=None, tracer=None,
                 round_write_batching: bool = True):
        self.store = store
        #: observability.tracing span tracer; the no-op singleton unless
        #: tracing is enabled (one span per reconcile, tagged
        #: controller/request/outcome/attempt; reconcile errors feed the
        #: flight recorder)
        self.tracer = tracer or NOOP_TRACER
        #: optional LeaderElector (manager.go:98-104): a manager that does
        #: not hold the lease runs NOTHING — it neither drains events nor
        #: reconciles, so its cursor stays put and takeover replays (or
        #: relists past a compaction horizon) to catch up
        self.elector = elector
        #: observability.MetricsRegistry; the controller-runtime metrics
        #: analog (workqueue depth, reconcile totals/errors/duration per
        #: controller — manager.go exposes these via its metrics server)
        self.metrics = metrics
        #: the operator's service-account identity: reconciles run
        #: impersonating it so the store's authorization hook can gate
        #: managed-resource mutation to the operator (+ exempt actors).
        self.identity = identity
        #: error-retry flow control (replaces the old fixed error interval,
        #: the reference's default-rate-limiter exponential backoff): a
        #: failing (controller, request) requeues at
        #: min(max, base * 2^(attempt-1)) scaled by deterministic jitter,
        #: and a request that exhausts the retry budget trips the
        #: controller's circuit breaker (degraded state: work parks for a
        #: cool-down of error_backoff_max_seconds, then one half-open
        #: probe decides recovery vs re-open)
        self.error_backoff_base_seconds = error_backoff_base_seconds
        self.error_backoff_max_seconds = error_backoff_max_seconds
        self.error_retry_budget = error_retry_budget
        #: consecutive-failure count per (controller, request); success
        #: resets its entry, so the dict stays bounded by live failures
        self._attempts: dict[tuple[str, Request], int] = {}
        #: controller name -> {"state", "opened_at"} (absent = closed)
        self._breakers: dict[str, dict] = {}
        #: observability.Logger (config.log); None = silent
        self.logger = logger
        self.controllers: list[Reconciler] = []
        #: kind -> controllers watching it (rebuilt on register)
        self._dispatch: dict[str, list[Reconciler]] = {}
        #: controllers with a batched map_events (rebuilt on register)
        self._batched: list[Reconciler] | None = None
        self._cursor = 0  # event-log position
        self._queue: list[tuple[str, Request]] = []
        self._queued: set[tuple[str, Request]] = set()
        self._requeues: list[tuple[float, int, str, Request]] = []
        self._tiebreak = itertools.count()
        #: optional (controller_name, Request) -> bool ownership predicate
        #: (controller/sharding.py): when set, requests failing it are
        #: DROPPED — at enqueue AND again at execution (the shard map can
        #: move between the two) — because another worker replica owns
        #: them; its relist-on-gain regenerates the work. None = this
        #: manager owns everything (the classic single-replica shape).
        self.request_filter = None
        #: optional frozenset of controller names whose watch mappings
        #: _drain_events runs; None = all (the classic shape). A sharded
        #: worker scopes this to the controllers that can actually
        #: produce requests it owns (a dedicated scheduler replica skips
        #: the workload mappers entirely) — safe because any ownership
        #: GAIN relists through the FULL mapping set (inject_events
        #: ignores the scope), rebuilding the skipped mappers' state.
        self.map_scope: frozenset[str] | None = None
        #: the request batch the last run_once executed (a list alias,
        #: O(1) to publish): the sharded manager's ownership audit reads
        #: it to assert no key ran on two workers in one round
        self.last_batch: list[tuple[str, Request]] = []
        #: round-scoped write coalescing (concurrency.WriteBatch), wired
        #: into each registered controller's EventRecorder (and offered
        #: via bind_round_batch) and flushed once per run_once
        if round_write_batching:
            from .concurrency import WriteBatch

            self.round_batch = WriteBatch()
        else:
            self.round_batch = None
        #: True when the elector reported standby on the last run_once —
        #: surfaced via resilience_snapshot()["standing_by"] and the
        #: grove_manager_is_leader gauge so a healthy standby is
        #: distinguishable from a wedged manager from outside
        self._standing_by = False
        #: extra labels stamped on this manager's MANAGER-SCOPED gauges
        #: (workqueue depth, is_leader). Empty for the classic single
        #: manager; a sharded worker sets {"worker": identity} so N
        #: replicas sharing one registry export N series instead of
        #: last-writer-wins on one unlabeled gauge.
        self.gauge_labels: dict[str, str] = {}
        #: bounded per (controller, request): a permanently failing
        #: reconciler retries forever on the error interval, and unbounded
        #: growth here would leak across a long simulation
        self.errors: list[tuple[str, Request, str]] = []
        self.max_errors_per_key = 5
        self._errors_next_compact = 64

    def register(self, controller: Reconciler) -> None:
        self.controllers.append(controller)
        self._dispatch: dict[str, list[Reconciler]] = {}
        self._batched: list[Reconciler] | None = None
        if self.round_batch is not None:
            # round write batching: the controller's EventRecorder (if it
            # has one) defers its store writes to the end-of-round flush,
            # and controllers with coalescable status sweeps opt in via
            # bind_round_batch (the GangScheduler's phase sweep rides it)
            recorder = getattr(controller, "recorder", None)
            if recorder is not None and hasattr(recorder, "batch"):
                recorder.batch = self.round_batch
            bind = getattr(controller, "bind_round_batch", None)
            if bind is not None:
                bind(self.round_batch)

    def _record_error_entry(self, cname: str, req: Request, msg: str) -> None:
        """Append to self.errors, keeping at most max_errors_per_key entries
        per (controller, request) — newest win. Eviction runs as a periodic
        O(n) compaction (amortized O(1) per append), so a permanently
        failing reconciler can't grow the list without bound."""
        self.errors.append((cname, req, msg))
        if len(self.errors) >= self._errors_next_compact:
            kept_counts: dict[tuple[str, Request], int] = {}
            kept: list[tuple[str, Request, str]] = []
            for entry in reversed(self.errors):
                key = (entry[0], entry[1])
                if kept_counts.get(key, 0) < self.max_errors_per_key:
                    kept_counts[key] = kept_counts.get(key, 0) + 1
                    kept.append(entry)
            kept.reverse()
            self.errors = kept
            self._errors_next_compact = max(64, 2 * len(kept))

    # -- queue plumbing ----------------------------------------------------
    def _enqueue(self, controller_name: str, request: Request) -> None:
        if self.request_filter is not None and not self.request_filter(
            controller_name, request
        ):
            return  # another shard worker owns this key
        key = (controller_name, request)
        if key not in self._queued:
            self._queued.add(key)
            self._queue.append(key)

    def _drain_events(self) -> None:
        self._drain()

    def _drain(self) -> int:
        """Map the store's new events into the queue; returns how many."""
        try:
            events = self.store.events_since(self._cursor)
        except StoreError:
            # cursor fell behind the compaction horizon (a fresh manager
            # over a long-lived compacted store): relist like an informer
            # after 410 Gone — synthetic Added events for every live
            # object, then watch from the head
            events, self._cursor = self.store.relist()
        else:
            if events:
                self._cursor = events[-1].seq
        if not events:
            return 0
        self._map_events(events, self._enqueue, scope=self.map_scope)
        return len(events)

    def _map_events(self, events, enqueue, scope=None) -> None:
        """Route events through every controller's watch mapping into
        `enqueue` (the _drain_events body, shared with inject_events).
        `scope` (a frozenset of controller names) narrows which mappers
        run — see map_scope."""
        # Controllers implementing the BATCHED watch predicate map_events
        # (one call per drain round) are excluded from the per-event
        # dispatch — at 10^4-event settle scale the per-event Python call
        # + return-list overhead of map_event was measurable.
        batched = self._batched
        if batched is None:
            batched = self._batched = [
                c for c in self.controllers
                if getattr(c, "map_events", None) is not None
            ]
        dispatch = self._dispatch
        # bucket the batch by kind ONCE: batched mappers receive only
        # the kinds they watch (in-kind order preserved; the mappers'
        # store reads see final state, so cross-kind interleaving is not
        # load-bearing) — without this every batched controller iterated
        # every event in Python, and at 10^4-event drains × N shard
        # workers that WAS the drain cost
        by_kind: dict[str, list] = {}
        for event in events:
            bucket = by_kind.get(event.kind)
            if bucket is None:
                bucket = by_kind[event.kind] = []
            bucket.append(event)
        for kind, kind_events in by_kind.items():
            ctrls = dispatch.get(kind)
            if ctrls is None:
                ctrls = dispatch[kind] = [
                    c for c in self.controllers
                    if c not in batched
                    and (
                        getattr(c, "watch_kinds", None) is None
                        or kind in c.watch_kinds
                    )
                ]
            for controller in ctrls:
                if scope is not None and controller.name not in scope:
                    continue
                for event in kind_events:
                    for req in controller.map_event(event):
                        enqueue(controller.name, req)
        for controller in batched:
            if scope is not None and controller.name not in scope:
                continue
            kinds = getattr(controller, "watch_kinds", None)
            if kinds is None:
                controller.map_events(events, enqueue)
                continue
            # watched buckets concatenated in sorted-kind order (stable
            # under hash randomization); within a kind the event order
            # is the log order
            relevant: list = []
            for k in sorted(kinds):
                bucket = by_kind.get(k)
                if bucket:
                    relevant.extend(bucket)
            if relevant:
                controller.map_events(relevant, enqueue)

    def inject_events(self, events, accept=None) -> int:
        """Feed externally synthesized events (a shard-gain relist)
        through the watch mappings WITHOUT touching the event cursor.
        `accept(cname, request) -> bool` narrows what actually enqueues
        (on top of request_filter); returns the number of requests
        enqueued."""
        injected = 0

        def enqueue(cname: str, req: Request) -> None:
            nonlocal injected
            if accept is not None and not accept(cname, req):
                return
            before = len(self._queue)
            self._enqueue(cname, req)
            injected += len(self._queue) - before

        self._map_events(events, enqueue)
        return injected

    def _pop_due_requeues(self) -> None:
        now = self.store.clock.now()
        while self._requeues and self._requeues[0][0] <= now:
            _, _, cname, req = heapq.heappop(self._requeues)
            self._enqueue(cname, req)

    def next_requeue_at(self) -> Optional[float]:
        return self._requeues[0][0] if self._requeues else None

    def _push_requeue(self, at: float, cname: str, req: Request) -> None:
        heapq.heappush(
            self._requeues, (at, next(self._tiebreak), cname, req)
        )

    # -- error backoff + circuit breaker -----------------------------------
    def _backoff_delay(self, cname: str, req: Request, attempts: int) -> float:
        """min(cap, base * 2^(attempt-1)) scaled by DETERMINISTIC jitter in
        [0.75, 1.0): a stable hash of (controller, request, attempt), so a
        replayed simulation requeues at identical virtual times while
        distinct requests still de-synchronize (no thundering herd on one
        shared retry tick). Jitter >= 0.75 keeps the gap sequence strictly
        growing (2 * 0.75 > 1) until it pins at the cap."""
        # exponent clamped: attempts grows without bound on a permanent
        # failure, and 2.0**~1075 overflows float — the min() with the cap
        # makes anything past 2^63 indistinguishable anyway
        nominal = self.error_backoff_base_seconds * (
            2.0 ** min(attempts - 1, 63)
        )
        crc = zlib.crc32(
            f"{cname}/{req.namespace}/{req.name}/{attempts}".encode()
        )
        return min(
            self.error_backoff_max_seconds,
            nominal * (0.75 + 0.25 * crc / 0xFFFFFFFF),
        )

    def breaker_state(self, cname: str) -> str:
        """BREAKER_CLOSED / BREAKER_OPEN / BREAKER_HALF_OPEN for a
        controller (public: debug dumps + tests read this, not the
        internal dict)."""
        br = self._breakers.get(cname)
        return br["state"] if br is not None else BREAKER_CLOSED

    def _controller_max_attempts(self, cname: str) -> float:
        """Deepest live retry chain for a controller (the
        grove_manager_backoff_depth gauge's documented meaning — one
        request's success must not zero the gauge while another request's
        chain is still deep)."""
        return float(max(
            (a for (c, _r), a in self._attempts.items() if c == cname),
            default=0,
        ))

    def _set_breaker(self, cname: str, state: str, opened_at: float) -> None:
        if state == BREAKER_CLOSED:
            self._breakers.pop(cname, None)
        else:
            self._breakers[cname] = {"state": state, "opened_at": opened_at}
        if self.metrics is not None:
            self.metrics.gauge(
                "grove_manager_breaker_state",
                "per-controller circuit breaker (0 closed, 0.5 half-open, "
                "1 open)",
            ).set(_BREAKER_GAUGE[state], controller=cname)

    def resilience_snapshot(self) -> dict:
        """Retry/breaker introspection for observability.debug: per
        controller the breaker state plus how many requests are in a
        retry chain and the deepest chain's attempt count — plus the
        reserved "standing_by" key (True when the last run_once yielded
        to the leader lease), so operators can tell a healthy standby
        from a wedged manager without reading the lease object."""
        per: dict[str, dict] = {}
        for (cname, _req), attempts in self._attempts.items():
            entry = per.setdefault(
                cname, {"retrying_requests": 0, "max_attempts": 0}
            )
            entry["retrying_requests"] += 1
            entry["max_attempts"] = max(entry["max_attempts"], attempts)
        for cname in self._breakers:
            per.setdefault(
                cname, {"retrying_requests": 0, "max_attempts": 0}
            )
        for cname, entry in per.items():
            entry["breaker"] = self.breaker_state(cname)
        if self.elector is not None:
            # only standby-CAPABLE managers carry the flag (a manager
            # without election can never stand by, and its empty snapshot
            # stays the documented "nothing retrying" shape)
            per["standing_by"] = self._standing_by
        return per

    # -- public introspection (consumed by observability.debug; the
    # controller-runtime workqueue-metrics analog). Keep debug surfaces on
    # these, not on _-prefixed internals, so a runtime refactor can't
    # silently break (or falsify) the dumps. -------------------------------
    @property
    def workqueue_depth(self) -> int:
        """Requests currently queued for the next round."""
        return len(self._queue)

    @property
    def pending_requeue_count(self) -> int:
        """Timer-held requests waiting on the requeue heap."""
        return len(self._requeues)

    def workqueue_snapshot(self) -> list[dict]:
        """Queued + timer-parked requests, as JSON-able dicts (the chaos
        flight recorder's wedged section names stuck work with this)."""
        out = [
            {"controller": cname, "namespace": req.namespace,
             "name": req.name, "state": "queued"}
            for cname, req in self._queue
        ]
        out.extend(
            {"controller": cname, "namespace": req.namespace,
             "name": req.name, "state": "requeue", "at": at}
            for at, _tb, cname, req in sorted(self._requeues)
        )
        return out

    @property
    def event_cursor(self) -> int:
        """Last store event seq this manager has drained."""
        return self._cursor

    def compact_processed_events(self) -> int:
        """Drop store events this manager has already drained. Safe when
        the manager is the only event consumer (the production shape);
        long-running simulations call this periodically to bound the
        event log. Tests that inspect historical events simply don't."""
        return self.store.compact_events(self._cursor)

    # -- the loop ----------------------------------------------------------
    def run_once(self) -> int:
        """Drain events + due requeues, run every queued reconcile once.
        Returns the number of reconciles executed."""
        if self.elector is not None:
            acquire = self.elector.try_acquire
            if self.identity is not None:
                with self.store.impersonate(self.identity):
                    held = acquire()
            else:
                held = acquire()
            if not held:
                self._standing_by = True
                if self.metrics is not None:
                    # a standby has no queue of its own to report — and
                    # must be tellable from a wedged manager from outside:
                    # the is_leader gauge + the standing_by resilience
                    # flag are the operator's "healthy standby" signal
                    self.metrics.gauge(
                        "grove_manager_workqueue_depth",
                        "requests drained into the current reconcile round",
                    ).set(0.0, **self.gauge_labels)
                    self.metrics.gauge(
                        "grove_manager_is_leader",
                        "1 when this manager holds the leader lease (or "
                        "runs without election), 0 standing by",
                    ).set(0.0, **self.gauge_labels)
                return 0  # standing by
        self._standing_by = False
        if self.metrics is not None:
            self.metrics.gauge(
                "grove_manager_is_leader",
                "1 when this manager holds the leader lease (or runs "
                "without election), 0 standing by",
            ).set(1.0, **self.gauge_labels)
        with self.tracer.span("manager.round") as rsp:
            ran = self._round()
            rsp.set(batch=ran)
        return ran

    def _round(self) -> int:
        """One round as leader: drain events and due requeues, run the
        batch, flush the round's coalesced writes (spans
        manager.drain_events and manager.flush_writes, the reconciles
        between them). Returns the number of reconciles executed."""
        tracer = self.tracer
        with tracer.span("manager.drain_events") as dsp:
            queued = len(self._queue)
            events = self._drain()
            self._pop_due_requeues()
            dsp.set(events=events, enqueued=len(self._queue) - queued)
        batch, self._queue = self._queue, []
        self._queued -= set(batch)
        if self.request_filter is not None:
            # re-check ownership at execution time: the shard map may have
            # moved a key between enqueue and this round — dropped keys
            # belong to their new owner, whose relist regenerates them
            flt = self.request_filter
            batch = [cr for cr in batch if flt(cr[0], cr[1])]
        self.last_batch = batch
        by_name = {c.name: c for c in self.controllers}
        # Run the round grouped by controller REGISTRATION order (stable
        # within a controller). Controllers register parents before
        # consumers (PCS -> cliques -> scheduler), so a round's writes
        # land before the consumer runs — interleaving by event-arrival
        # order let the scheduler see a 1-gang sliver of a backlog whose
        # other 999 ungates were still queued behind it (an extra
        # full-device solve round at stress scale).
        rank = {c.name: i for i, c in enumerate(self.controllers)}
        batch.sort(key=lambda cr: rank[cr[0]])
        # Advisory pre_round hook: a controller with work queued THIS round
        # may begin read-only asynchronous preparation (the gang scheduler
        # dispatches its accelerator solve here) that overlaps with the
        # reconciles running ahead of it in the batch. Contract: pre_round
        # must not write to the store, and the controller must re-validate
        # whatever it prepared when its reconcile runs — earlier reconciles
        # in the same round may invalidate it. Failures are recorded but
        # never fail the round (reconcile does the authoritative work).
        if batch:
            in_batch = {cname for cname, _ in batch}
            for c in self.controllers:
                hook = getattr(c, "pre_round", None)
                if hook is None or c.name not in in_batch:
                    continue
                try:
                    if self.identity is not None:
                        with self.store.impersonate(self.identity):
                            hook()
                    else:
                        hook()
                except Exception as exc:  # advisory: reconcile still runs
                    self._record_error_entry(
                        c.name, Request("", "pre_round"), str(exc)
                    )
                    if self.logger is not None:
                        self.logger.error(
                            "pre_round failed", controller=c.name,
                            error=str(exc),
                        )
        m = self.metrics
        if m is not None:
            # set unconditionally: an idle round must read 0, not the last
            # busy round's stale depth
            m.gauge(
                "grove_manager_workqueue_depth",
                "requests drained into the current reconcile round",
            ).set(float(len(batch)), **self.gauge_labels)
        for cname, req in batch:
            controller = by_name[cname]
            # Circuit breaker: an OPEN controller runs nothing — its work
            # parks on the requeue heap until the cool-down elapses, then
            # the first request through is the half-open probe (success
            # closes the breaker, failure re-opens it for another
            # cool-down). Degraded state, not abandonment: parked requests
            # always re-fire.
            br = self._breakers.get(cname)
            if br is not None and br["state"] == BREAKER_OPEN:
                reopen = br["opened_at"] + self.error_backoff_max_seconds
                if self.store.clock.now() >= reopen:
                    self._set_breaker(cname, BREAKER_HALF_OPEN,
                                      br["opened_at"])
                else:
                    self._push_requeue(reopen, cname, req)
                    continue
            t0 = time.perf_counter() if m is not None else 0.0
            failed = False
            # one span per reconcile; a finished span's attrs stay
            # mutable, so the outcome/attempt tags land after the fact
            span = tracer.span(
                "manager.reconcile", controller=cname,
                namespace=req.namespace, name=req.name,
            )
            try:
                with span:
                    if self.identity is not None:
                        with self.store.impersonate(self.identity):
                            result = controller.reconcile(req)
                    else:
                        result = controller.reconcile(req)
            except Exception as exc:
                # A reconcile panic never kills the manager (the reference
                # sets RecoverPanic, manager.go:105-107): record it, let the
                # controller surface it to the owning object's status, and
                # retry on the error interval.
                from .errors import to_grove_error

                err = to_grove_error(exc, f"{cname}:{req.namespace}/{req.name}")
                self._record_error_entry(cname, req, str(err))
                if self.logger is not None:
                    self.logger.error(
                        "reconcile failed", controller=cname,
                        namespace=req.namespace, name=req.name,
                        code=err.code, error=err.message,
                    )
                recorder = getattr(controller, "record_error", None)
                if recorder is not None:
                    # status recording is best-effort: a store that is
                    # ALSO failing (transient apiserver fault) must not
                    # escalate a retryable reconcile error into a manager
                    # crash — the retry will re-record
                    try:
                        if self.identity is not None:
                            with self.store.impersonate(self.identity):
                                recorder(req, err)
                        else:
                            recorder(req, err)
                    except Exception as rec_exc:
                        if self.logger is not None:
                            self.logger.error(
                                "error recording failed", controller=cname,
                                namespace=req.namespace, name=req.name,
                                error=str(rec_exc),
                            )
                key = (cname, req)
                attempts = self._attempts.get(key, 0) + 1
                self._attempts[key] = attempts
                span.set(outcome="error", attempt=attempts)
                self.tracer.record_error(
                    cname, req.namespace, req.name, str(err),
                    self.store.clock.now(),
                )
                if m is not None:
                    m.counter(
                        "grove_manager_reconcile_retries_total",
                        "error-retry requeues per controller",
                    ).inc(controller=cname)
                    m.gauge(
                        "grove_manager_backoff_depth",
                        "consecutive-failure depth of the controller's "
                        "deepest live retry chain",
                    ).set(self._controller_max_attempts(cname),
                          controller=cname)
                state = self.breaker_state(cname)
                if state == BREAKER_HALF_OPEN or (
                    attempts >= self.error_retry_budget
                    and state != BREAKER_OPEN
                ):
                    # budget exhausted — or ANY failure while half-open
                    # (the probe request need not be the one that tripped
                    # the breaker; a fresh request's first failure must
                    # re-open it just the same): open the breaker — the
                    # controller is degraded
                    self._set_breaker(
                        cname, BREAKER_OPEN, self.store.clock.now()
                    )
                    if m is not None:
                        m.counter(
                            "grove_manager_breaker_opens_total",
                            "circuit-breaker opens per controller",
                        ).inc(controller=cname)
                    if self.logger is not None:
                        self.logger.error(
                            "circuit breaker opened", controller=cname,
                            attempts=attempts,
                            cooldown_seconds=self.error_backoff_max_seconds,
                        )
                result = Result(
                    requeue_after=self._backoff_delay(cname, req, attempts)
                )
                failed = True
            if not failed:
                span.set(
                    outcome="soft-error" if result.error
                    else ("requeue" if result.requeue_after is not None
                          else "ok")
                )
                key = (cname, req)
                if self._attempts.pop(key, None) is not None and m is not None:
                    # re-derive, don't zero: another request's chain may
                    # still be live and deeper
                    m.gauge(
                        "grove_manager_backoff_depth",
                        "consecutive-failure depth of the controller's "
                        "deepest live retry chain",
                    ).set(self._controller_max_attempts(cname),
                          controller=cname)
                if self.breaker_state(cname) != BREAKER_CLOSED:
                    # the half-open probe (or any reconcile racing it)
                    # succeeded: the controller recovered
                    self._set_breaker(cname, BREAKER_CLOSED, 0.0)
                    if self.logger is not None:
                        self.logger.info(
                            "circuit breaker closed", controller=cname,
                        )
            if m is not None:
                m.counter(
                    "grove_manager_reconcile_total",
                    "reconciles executed per controller",
                ).inc(controller=cname)
                if failed or result.error:
                    m.counter(
                        "grove_manager_reconcile_errors_total",
                        "failed reconciles per controller",
                    ).inc(controller=cname)
                m.histogram(
                    "grove_manager_reconcile_duration_seconds",
                    "wall seconds per reconcile",
                ).observe(time.perf_counter() - t0, controller=cname)
            if result.error:
                self._record_error_entry(cname, req, result.error)
            if self.logger is not None:
                self.logger.debug(
                    "reconciled", controller=cname,
                    namespace=req.namespace, name=req.name,
                    requeue_after=result.requeue_after,
                )
            if result.requeue_after is not None:
                heapq.heappush(
                    self._requeues,
                    (
                        self.store.clock.now() + result.requeue_after,
                        next(self._tiebreak),
                        cname,
                        req,
                    ),
                )
        with tracer.span("manager.flush_writes") as fsp:
            fsp.set(writes=self._flush_round_writes())
        return len(batch)

    def _flush_round_writes(self) -> int:
        """End-of-round flush of the coalesced status/event writes
        (concurrency.WriteBatch) through the slow-start batcher. Flush
        errors degrade like reconcile soft-errors: recorded, surfaced to
        the log, never fatal — the deferred writes are idempotent
        re-derivations, and the next round's enqueue retries them.
        Returns the number of writes flushed."""
        batch = self.round_batch
        if batch is None or not len(batch):
            return 0
        # partitioned durable write path: group the flush by WAL
        # partition so one partition's failure never halts another's
        # writes (cluster/durability.PartitionedLog.partition_of; None
        # on the classic single-WAL or memory-only store)
        partition_of = getattr(
            getattr(self.store, "durability", None), "partition_of", None
        )
        try:
            if self.identity is not None:
                with self.store.impersonate(self.identity):
                    result = batch.flush(partition_of=partition_of)
            else:
                result = batch.flush(partition_of=partition_of)
        except Exception as exc:  # defensive: flush itself must not kill
            self._record_error_entry(
                "round-writes", Request("", "flush"), str(exc)
            )
            return 0
        if self.metrics is not None:
            m = self.metrics.counter(
                "grove_manager_round_writes_total",
                "end-of-round batched write flushes by outcome",
            )
            m.inc(len(result.succeeded), outcome="flushed")
            if result.errors:
                m.inc(len(result.errors), outcome="failed")
            if result.skipped:
                m.inc(len(result.skipped), outcome="skipped")
        for name, err in result.errors:
            self._record_error_entry(
                "round-writes", Request("", name), str(err)
            )
            if self.logger is not None:
                self.logger.error(
                    "round write flush failed", task=name, error=str(err),
                )
        return len(result.succeeded)

    def settle(self, max_rounds: int = 256) -> None:
        """Run until no events are pending and the queue is empty (due
        requeues included; future requeues are left on the heap). A
        manager standing by for the lease is quiescent by definition —
        work waits for the leader, not for this replica."""
        for _ in range(max_rounds):
            if self.run_once() == 0:
                if self.elector is not None and not self.elector.is_leader():
                    return  # standing by: nothing is ours to run
                self._drain_events()
                self._pop_due_requeues()
                if not self._queue:
                    return
        raise RuntimeError(
            f"controllers did not settle in {max_rounds} rounds "
            f"(errors: {self.errors[-3:]})"
        )
