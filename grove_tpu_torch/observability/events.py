"""Kubernetes-Event-style records for controller actions.

The reference emits a k8s Event for every significant create/delete/fail
(reasons enumerated in internal/constants/constants.go:36-98, recorded via
controller-runtime's EventRecorder). ClusterEvent is the store-object
analog: controllers record against the involved object; identical
(object, reason) pairs dedup with a count bump, exactly like the k8s
events compaction."""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

from ..api.meta import ObjectMeta

TYPE_NORMAL = "Normal"
TYPE_WARNING = "Warning"

# Reasons (constants.go:36-98 flavor).
REASON_CREATE_SUCCESSFUL = "CreateSuccessful"
REASON_DELETE_SUCCESSFUL = "DeleteSuccessful"
REASON_PODGANG_SCHEDULED = "PodGangScheduled"
REASON_PODGANG_UNSCHEDULABLE = "PodGangUnschedulable"
REASON_GANG_TERMINATED = "PodGangTerminated"
REASON_RECONCILE_ERROR = "ReconcileError"
REASON_INVALID_STARTUP_BARRIER = "InvalidStartupBarrier"
# Node lifecycle (the node-lifecycle controller's event vocabulary).
REASON_NODE_NOT_READY = "NodeNotReady"
REASON_NODE_READY = "NodeReady"
REASON_NODE_PODS_EVICTED = "NodePodsEvicted"
REASON_NODE_DRAINED = "NodeDrained"
REASON_DRAIN_GANG_TERMINATED = "DrainGangTerminated"


@dataclass
class ClusterEvent:
    """corev1.Event equivalent (involvedObject + reason + message + count)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    type: str = TYPE_NORMAL
    reason: str = ""
    message: str = ""
    involved_kind: str = ""
    involved_name: str = ""
    reporting_controller: str = ""
    count: int = 1
    first_timestamp: float = 0.0
    last_timestamp: float = 0.0

    KIND = "Event"


class EventRecorder:
    """Store-backed recorder; dedup key is (namespace, involved kind+name,
    reason) with count/last_timestamp compaction.

    Retention (the kube-apiserver --event-ttl analog): recording
    opportunistically garbage-collects ClusterEvents not touched for
    TTL_SECONDS — and enforces the MAX_EVENTS hard cap, oldest-first —
    so long chaos runs and the 10^5-gang bench never accumulate events
    without bound. The sweep runs at most once per SWEEP_INTERVAL of
    virtual time, its cursor shared across every recorder instance via
    the store (same pattern as the flight-recorder hook), and its stats
    surface as debug_dump()["store"]["events"]."""

    #: events untouched (no dedup bump) this long are dropped
    TTL_SECONDS = 3600.0
    #: hard retained-count cap, enforced oldest-last_timestamp-first
    MAX_EVENTS = 10_000
    #: minimum virtual seconds between sweeps (amortizes the scan)
    SWEEP_INTERVAL = 300.0

    def __init__(self, store, controller: str = ""):
        self.store = store
        self.controller = controller
        #: optional round-scoped controller.concurrency.WriteBatch: when
        #: the owning manager installs one (ControllerManager.register),
        #: the STORE write of each record defers to the end-of-round
        #: flush — identical (object, reason) records within a round
        #: compact into ONE store op (count += n) instead of n
        #: read-modify-writes. The flight-recorder copy stays at record
        #: time (chronology is the point of the flight ring).
        self.batch = None

    @staticmethod
    def dedup_name(kind: str, name: str, reason: str) -> str:
        """Collision-free event object name for one (kind, involved name,
        reason) triple. The readable prefix joins the fields with "-",
        which is ambiguous on its own (name "pod-a-b" + reason "c" and
        name "pod-a" + reason "b-c" both read "pod-a-b-c"); the appended
        digest hashes the fields with a separator that cannot appear in
        them, so overlapping prefixes can never share a dedup key."""
        digest = hashlib.sha1(
            "\x00".join((kind, name, reason)).encode()
        ).hexdigest()[:8]
        return f"{kind.lower()}-{name}-{reason.lower()}-{digest}"

    def event(self, involved, type_: str, reason: str, message: str) -> None:
        ns = involved.metadata.namespace or "default"
        name = self.dedup_name(
            involved.KIND, involved.metadata.name, reason
        )
        now = self.store.clock.now()
        flight = getattr(self.store, "flight_recorder", None)
        if flight is not None:
            # chaos flight recorder (observability/tracing.py): events
            # ride in the postmortem ring alongside spans + errors
            flight.add_event(
                type_, reason, involved.KIND, involved.metadata.name,
                ns, message, virtual_time=now,
            )
        record = (
            type_, reason, message, involved.KIND,
            involved.metadata.name, now,
        )
        if self.batch is not None:
            self.batch.append(
                ("event", ns, name), f"event/{name}",
                lambda records, ns=ns, name=name: self._commit(
                    ns, name, records
                ),
                record,
                # the flush writes a ClusterEvent in ns: the partition
                # key a partitioned durable store groups the flush by
                partition_key=(ns, ClusterEvent.KIND),
            )
            return
        self._commit(ns, name, [record])

    def _commit(self, ns: str, name: str, records: list[tuple]) -> None:
        """Land `records` (all sharing one dedup key) as ONE store write:
        an existing event bumps count by len(records); a fresh one is
        created with that count. Runs inline when unbatched, or at the
        round flush when a WriteBatch is installed."""
        type_, reason, message, kind, involved_name, first = records[0]
        type_, reason, message, _k, _n, now = records[-1]
        existing = self.store.get(ClusterEvent.KIND, ns, name)
        if existing is not None:
            existing.count += len(records)
            existing.message = message
            existing.last_timestamp = now
            self.store.update(existing)
            self._maybe_gc(now)
            return
        self.store.create(
            ClusterEvent(
                metadata=ObjectMeta(name=name, namespace=ns),
                type=type_,
                reason=reason,
                message=message,
                involved_kind=kind,
                involved_name=involved_name,
                reporting_controller=self.controller,
                first_timestamp=first,
                last_timestamp=now,
                count=len(records),
            ),
            owned=True,
        )
        self._maybe_gc(now)

    def _maybe_gc(self, now: float) -> None:
        """Rate-limited retention sweep (see class docstring). The
        next-sweep cursor lives on the STORE so every recorder over it
        shares one cadence; best-effort — a transient store fault (chaos)
        on one delete never fails the record that triggered the sweep."""
        due = getattr(self.store, "event_gc_at", None)
        if due is not None and now < due:
            return
        self.store.event_gc_at = now + self.SWEEP_INTERVAL
        swept = sweep_events(
            self.store, ttl=self.TTL_SECONDS, max_events=self.MAX_EVENTS,
            now=now,
        )
        stats = getattr(
            self.store, "event_gc_stats", None
        ) or {"swept_total": 0, "last_sweep_at": None}
        stats = {
            "swept_total": stats["swept_total"] + swept,
            "last_sweep_at": now,
        }
        self.store.event_gc_stats = stats

    def normal(self, involved, reason: str, message: str) -> None:
        self.event(involved, TYPE_NORMAL, reason, message)

    def warning(self, involved, reason: str, message: str) -> None:
        self.event(involved, TYPE_WARNING, reason, message)


def sweep_events(store, ttl: float, max_events: int, now: float) -> int:
    """One ClusterEvent retention pass: drop events whose last activity
    is older than `ttl`, then enforce the `max_events` cap oldest-first.
    Returns the number deleted. Best-effort per event — a failed delete
    (chaos write fault, a concurrent deletion) skips that event; the
    next sweep retries it."""
    live: list[tuple[float, str, str]] = []
    expired: list[tuple[str, str]] = []
    for ev in store.scan(ClusterEvent.KIND):
        key = (ev.metadata.namespace, ev.metadata.name)
        if now - ev.last_timestamp > ttl:
            expired.append(key)
        else:
            live.append((ev.last_timestamp, key[0], key[1]))
    if len(live) > max_events:
        live.sort()
        expired.extend(
            (ns, name) for _, ns, name in live[: len(live) - max_events]
        )
    swept = 0
    for ns, name in expired:
        try:
            store.delete(ClusterEvent.KIND, ns, name)
            swept += 1
        except Exception:
            continue
    return swept
