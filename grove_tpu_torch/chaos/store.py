"""ChaosStore: a fault-injecting proxy at the store (apiserver) boundary.

Wraps an `ObjectStore` and presents the identical API; the controller
manager, the reconcilers and the scheduler read and write through it while
the kubelet and the test driver keep the inner store (chaos models the
OPERATOR's view of a flaky apiserver — node agents and the human at the
kubectl boundary are out of scope, which also keeps test fixtures
deterministic to author).

Faults injected (all drawn from the plan's seeded RNG, all only while
`armed` and only for operator-identity ops):

  write faults      — create/update/delete/... raises TransientFault
                      BEFORE the write lands (nothing committed)
  conflict storms   — a burst of consecutive writes all fail with
                      ConflictStorm (an optimistic-concurrency stampede)
  mid-flight crash  — the write COMMITS, then ManagerCrash is raised: the
                      manager died between the write and its ack, the
                      classic partial-reconcile window (ManagerCrash is a
                      BaseException so the manager's RecoverPanic guard
                      cannot swallow it; the chaos driver restarts the
                      manager)
  stale reads       — get/peek/scan/list/kind_bucket may HIDE objects
                      created within the last `stale_lag_events` store
                      events: an informer cache that has not seen the
                      create yet. Staleness is only ever absence of a
                      recent create — a lagging cache never shows an
                      object as deleted — so the controller's AlreadyExists
                      retry path is what gets exercised.
  delayed events    — events_since temporarily truncates delivery at a
                      held watermark; the consumer's cursor advances only
                      past what it saw, so delivery resumes with no gap.

Exemptions: ops by the DEFAULT (user) actor and the GC actor, and every
op touching the Lease kind — a faulted lease write would deadlock the
whole manager loop inside try_acquire, and that failure mode is modeled
honestly by the manager-crash fault instead.
"""

from __future__ import annotations

from typing import Any

from ..cluster.store import DEFAULT_ACTOR, GC_ACTOR, ObjectStore, StoreError
from .plan import FaultPlan


class TransientFault(StoreError):
    """A retryable infrastructure failure (maps to ERR_STORE_CONFLICT
    through controller.errors.to_grove_error, like any StoreError)."""


class ConflictStorm(TransientFault):
    """Optimistic-concurrency conflict burst."""


class ManagerCrash(BaseException):
    """The simulated operator process dying mid-reconcile. Deliberately a
    BaseException: the manager's RecoverPanic guard (`except Exception`)
    must NOT catch it — a dead process records nothing, requeues nothing.
    Only the chaos driver handles it, by building a fresh manager."""


#: kinds exempt from every fault (see module docstring)
_EXEMPT_KINDS = frozenset({"Lease"})


class ChaosStore:
    """Transparent ObjectStore proxy; unlisted attributes delegate to the
    wrapped store, so the full read/write/introspection surface stays
    available (and future store methods are chaos-transparent by
    default — new WRITE paths must be added to the intercept list here
    to be fault-covered)."""

    def __init__(self, inner: ObjectStore, plan: FaultPlan, metrics=None):
        self._inner = inner
        self.plan = plan
        self.metrics = metrics
        #: faults fire only while armed (the chaos phase); a disarmed
        #: ChaosStore is byte-for-byte the inner store's behavior
        self.armed = False
        self._conflict_burst_left = 0
        #: (watermark_seq, remaining_reads) while an event-delivery hold
        #: is active
        self._event_hold: tuple[int, int] | None = None
        #: (kind, namespace, name) -> seq of the create this proxy passed
        #: through; lets stale reads hide ONLY recently-created objects
        self._created_at: dict[tuple[str, str, str], int] = {}

    # -- plumbing ----------------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        return getattr(self._inner, name)

    def _record(self, fault_type: str) -> None:
        self.plan.record(fault_type)
        if self.metrics is not None:
            self.metrics.counter(
                "grove_chaos_faults_injected_total",
                "chaos faults injected by type",
            ).inc(type=fault_type)

    def _faultable(self, kind: str) -> bool:
        return (
            self.armed
            and kind not in _EXEMPT_KINDS
            and self._inner.actor not in (DEFAULT_ACTOR, GC_ACTOR)
        )

    # -- write faults ------------------------------------------------------
    def _pre_write(self, op: str, kind: str) -> None:
        if not self._faultable(kind):
            return
        plan = self.plan
        if self._conflict_burst_left > 0:
            self._conflict_burst_left -= 1
            self._record("conflict_storm")
            raise ConflictStorm(f"chaos: write conflict on {op} {kind}")
        if plan.flip(plan.conflict_burst_rate):
            self._conflict_burst_left = max(0, plan.conflict_burst_length - 1)
            self._record("conflict_storm")
            raise ConflictStorm(f"chaos: write conflict on {op} {kind}")
        if plan.flip(plan.write_fault_rate):
            self._record("write_fault")
            raise TransientFault(f"chaos: transient {op} failure on {kind}")

    def _post_write(self, op: str, kind: str) -> None:
        if not self._faultable(kind):
            return
        if self.plan.flip(self.plan.midflight_crash_rate):
            self._record("midflight_crash")
            raise ManagerCrash(
                f"chaos: manager killed after committed {op} on {kind}"
            )

    def create(self, obj: Any, owned: bool = False) -> Any:
        self._pre_write("create", obj.KIND)
        out = self._inner.create(obj, owned=owned)
        self._created_at[
            (obj.KIND, out.metadata.namespace, out.metadata.name)
        ] = self._inner.last_seq
        self._post_write("create", obj.KIND)
        return out

    def update(self, obj: Any) -> Any:
        self._pre_write("update", obj.KIND)
        out = self._inner.update(obj)
        self._post_write("update", obj.KIND)
        return out

    def update_status(self, obj: Any) -> None:
        self._pre_write("update_status", obj.KIND)
        self._inner.update_status(obj)
        self._post_write("update_status", obj.KIND)

    def patch_status(self, kind: str, namespace: str, name: str,
                     mutate) -> bool:
        self._pre_write("patch_status", kind)
        out = self._inner.patch_status(kind, namespace, name, mutate)
        if out:
            self._post_write("patch_status", kind)
        return out

    def bind_pod(self, namespace: str, name: str, node_name: str) -> bool:
        self._pre_write("bind_pod", "Pod")
        out = self._inner.bind_pod(namespace, name, node_name)
        if out:
            self._post_write("bind_pod", "Pod")
        return out

    def ungate_pod(self, namespace: str, name: str) -> bool:
        self._pre_write("ungate_pod", "Pod")
        out = self._inner.ungate_pod(namespace, name)
        if out:
            self._post_write("ungate_pod", "Pod")
        return out

    def delete(self, kind: str, namespace: str, name: str) -> None:
        self._pre_write("delete", kind)
        self._inner.delete(kind, namespace, name)
        self._post_write("delete", kind)

    def add_finalizer(self, kind: str, namespace: str, name: str,
                      finalizer: str) -> None:
        self._pre_write("add_finalizer", kind)
        self._inner.add_finalizer(kind, namespace, name, finalizer)
        self._post_write("add_finalizer", kind)

    def remove_finalizer(self, kind: str, namespace: str, name: str,
                         finalizer: str) -> None:
        self._pre_write("remove_finalizer", kind)
        self._inner.remove_finalizer(kind, namespace, name, finalizer)
        self._post_write("remove_finalizer", kind)

    # -- stale reads -------------------------------------------------------
    def _stale_hidden(self, kind: str, namespace: str, name: str) -> bool:
        """True when THIS read should pretend the object does not exist
        yet: the read drew a staleness flip and the object's create is
        within the lag window. Ages out as the event log moves on — a
        cache only lags so far."""
        created = self._created_at.get((kind, namespace, name))
        if created is None:
            return False
        if created <= self._inner.last_seq - self.plan.stale_lag_events:
            del self._created_at[(kind, namespace, name)]  # aged out
            return False
        self._record("stale_read")
        return True

    def _reads_stale(self, kind: str) -> bool:
        return self._faultable(kind) and self.plan.flip(
            self.plan.stale_read_rate
        )

    def get(self, kind: str, namespace: str, name: str) -> Any | None:
        if self._reads_stale(kind) and self._stale_hidden(
            kind, namespace, name
        ):
            return None
        return self._inner.get(kind, namespace, name)

    def peek(self, kind: str, namespace: str, name: str) -> Any | None:
        if self._reads_stale(kind) and self._stale_hidden(
            kind, namespace, name
        ):
            return None
        return self._inner.peek(kind, namespace, name)

    def _filter_stale(self, kind: str, objs: list[Any]) -> list[Any]:
        return [
            o
            for o in objs
            if not self._stale_hidden(
                kind, o.metadata.namespace, o.metadata.name
            )
        ]

    def scan(self, kind: str, namespace: str | None = None,
             labels: dict[str, str] | None = None, predicate=None) -> list[Any]:
        out = self._inner.scan(kind, namespace, labels, predicate)
        if out and self._reads_stale(kind):
            out = self._filter_stale(kind, out)
        return out

    def list(self, kind: str, namespace: str | None = None,
             labels: dict[str, str] | None = None, predicate=None) -> list[Any]:
        out = self._inner.list(kind, namespace, labels, predicate)
        if out and self._reads_stale(kind):
            out = self._filter_stale(kind, out)
        return out

    def list_owned(self, kind: str, owner_uid: str) -> list[Any]:
        out = self._inner.list_owned(kind, owner_uid)
        if out and self._reads_stale(kind):
            out = self._filter_stale(kind, out)
        return out

    def kind_bucket(self, kind: str) -> dict[tuple[str, str], Any]:
        bucket = self._inner.kind_bucket(kind)
        if bucket and self._reads_stale(kind):
            filtered = {
                key: o
                for key, o in bucket.items()
                if not self._stale_hidden(kind, key[0], key[1])
            }
            if len(filtered) != len(bucket):
                return filtered  # one lagging snapshot; callers re-read
        return bucket

    # -- event-delivery delay ----------------------------------------------
    def events_since(self, seq: int):
        events = self._inner.events_since(seq)
        if not self.armed:
            return events
        plan = self.plan
        if self._event_hold is None and events and plan.flip(
            plan.event_delay_rate
        ):
            # hold delivery at a watermark strictly BEHIND the head so the
            # hold visibly delays something
            watermark = events[len(events) // 2].seq if len(events) > 1 else seq
            self._event_hold = (watermark, plan.event_delay_reads)
            self._record("event_delay")
        if self._event_hold is not None:
            watermark, reads_left = self._event_hold
            self._event_hold = (
                (watermark, reads_left - 1) if reads_left > 1 else None
            )
            return [e for e in events if e.seq <= watermark]
        return events

    # -- chaos driver hooks ------------------------------------------------
    def reset_for_recovery(self) -> None:
        """Drop every piece of per-run fault state keyed to store seqs —
        the stale-read memory, a live event-delivery hold, a mid-burst
        conflict storm. Called by the driver after a process_crash
        recovery: the informer caches died with the process, and a torn
        tail REWINDS (then reuses) seqs, so stale bookkeeping could
        collide with post-recovery objects. Owned here, next to the
        state, so new per-run fields can't be missed at the call site
        (the SimKubelet.reset_for_recovery pattern)."""
        self._created_at.clear()
        self._event_hold = None
        self._conflict_burst_left = 0

    def force_compaction(self) -> int:
        """Compact the inner event log up to the head — deliberately past
        every consumer cursor, forcing the manager/kubelet/usage informers
        through their 410-Gone relist recovery."""
        dropped = self._inner.compact_events(self._inner.last_seq)
        if dropped:
            self._record("forced_compaction")
        return dropped
