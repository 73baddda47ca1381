"""Slow-start task batching (utils/concurrent.go:72-105).

The reference protects the kube-apiserver from write storms by running
create/delete tasks in exponentially growing batches (1 -> 2 -> 4 -> ...),
halting at the first batch that errors and skipping the remainder — a
failing apiserver (or webhook) sees one probe, not N simultaneous writes.
The store here is in-process and strongly consistent, so the protection is
about *pacing semantics*, not thread safety: a reconcile that hits a
failing admission/authorization hook attempts one write, not its whole
diff, and the manager's retry finds the remainder via the normal
idempotent diff computation (hole-filling indices for creates, recomputed
excess for deletes).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

#: First batch size, like the reference's slow-start callers.
INITIAL_BATCH_SIZE = 1


@dataclass
class RunResult:
    """Aggregated outcome of a slow-start run."""

    succeeded: list[str] = field(default_factory=list)
    #: (task name, exception) for every task of the failing batch that
    #: raised; tasks after that batch are skipped, not attempted
    errors: list[tuple[str, Exception]] = field(default_factory=list)
    skipped: list[str] = field(default_factory=list)

    @property
    def has_errors(self) -> bool:
        return bool(self.errors)

    def raise_if_errors(self, code: str, verb: str,
                        operation: str = "Sync") -> None:
        """Aggregate every error of the failing batch into one GroveError
        (first exception attached as cause) and raise it."""
        if not self.errors:
            return
        from .errors import GroveError

        detail = "; ".join(f"{n}: {e}" for n, e in self.errors)
        raise GroveError(
            code=code,
            operation=operation,
            message=(
                f"{len(self.errors)} {verb}(s) failed ({detail}); "
                f"{len(self.skipped)} skipped by slow start"
            ),
            cause=self.errors[0][1],
        )


class WriteBatch:
    """Round-scoped write coalescing, flushed through the slow-start
    batcher.

    The settle hot path was dominated by per-object status/event store
    writes (BENCH_r05: ~95% of control-plane settle is host-side Python,
    and the tracer names the write machinery inside the reconcile spans).
    Controllers that can tolerate end-of-round visibility enqueue their
    writes here instead of landing them inline; the manager flushes ONCE
    per reconcile round via `run_with_slow_start`, so a failing store
    (admission hook, chaos write fault) sees one probe write, not the
    whole round's worth — and repeated writes to the same key within a
    round collapse to one store op.

    Two enqueue shapes:

      put(key, name, fn)          last-wins: a later put for the same key
                                  REPLACES the earlier one. fn must be a
                                  full idempotent write that re-derives
                                  its content from live store state at
                                  flush time (deferral legally shifts the
                                  read later).
      append(key, name, fn, item) accumulate: items for one key collect
                                  into a list; at flush fn(items) runs
                                  once (event-count compaction rides
                                  this).

    Both take an optional `partition_key=(namespace, kind)` naming the
    store object the task will write. When the store's durable write
    path is partitioned (cluster/durability.PartitionedLog), the flush
    keeps ONE global write order but tracks slow-start state PER
    PARTITION: a failing write halts only its own partition's remainder
    (failed + skipped re-queue as before), while every other partition's
    tasks keep flushing in their original slots — partitions fail
    independently, the way their WALs commit independently, and the
    success-path write order (and therefore the journaled seq history)
    is IDENTICAL to the unpartitioned plane's.

    Ordering: first-enqueue order per key (a replaced put keeps its
    original slot), so flush-time write order is deterministic.
    """

    __slots__ = ("_tasks",)

    def __init__(self) -> None:
        #: key -> [name, fn, items-or-None, partition_key-or-None]; dict
        #: insertion order is the flush order (within a partition group)
        self._tasks: dict = {}

    def __len__(self) -> int:
        return len(self._tasks)

    def put(self, key, name: str, fn: Callable[[], None],
            partition_key: tuple[str, str] | None = None) -> bool:
        """Enqueue a last-wins write task. Returns True when it coalesced
        over (replaced) an earlier task for the same key."""
        existed = key in self._tasks
        if existed:
            entry = self._tasks[key]
            entry[1] = fn
            entry[3] = partition_key  # last-wins covers the routing too
        else:
            self._tasks[key] = [name, fn, None, partition_key]
        return existed

    def append(self, key, name: str, fn, item,
               partition_key: tuple[str, str] | None = None) -> bool:
        """Enqueue an accumulating task: at flush, `fn(items)` runs once
        with every item appended for this key. Returns True when the item
        joined an existing task (coalesced)."""
        entry = self._tasks.get(key)
        if entry is not None:
            entry[2].append(item)
            return True
        self._tasks[key] = [name, fn, [item], partition_key]
        return False

    def flush(self, partition_of: Callable[[str, str], int] | None = None,
              ) -> RunResult:
        """Run every pending task through the slow-start batcher and
        clear. Tasks enqueued DURING the flush (a write handler recording
        a follow-on event) land in the next round's batch. Failed and
        slow-start-skipped tasks are RE-QUEUED for the next flush (their
        fns re-derive from live state, so a late retry stays correct) —
        a transient store fault costs one probe write and a round of
        latency, never a lost status.

        `partition_of(namespace, kind) -> int` (the durable layer's
        router) runs the slow-start pacing PER write-path partition
        while keeping the single global enqueue order: one partition's
        failure halts only that partition's remaining tasks, and the
        writes that do land commit in exactly the order the
        unpartitioned plane would have used (bit-identical journaled
        history). Tasks without a partition_key share one residual
        pacing group."""
        tasks, self._tasks = self._tasks, {}
        if not tasks:
            return RunResult()
        if partition_of is None:
            result = run_with_slow_start([
                (name, fn if items is None else (lambda f=fn, it=items: f(it)))
                for name, fn, items, _pk in tasks.values()
            ])
        else:
            result = self._flush_partitioned(tasks, partition_of)
        if result.errors or result.skipped:
            retry = {n for n, _ in result.errors}
            retry.update(result.skipped)
            for key, entry in tasks.items():
                if entry[0] in retry and key not in self._tasks:
                    self._tasks[key] = entry
        return result

    @staticmethod
    def _flush_partitioned(tasks: dict, partition_of) -> RunResult:
        """Global enqueue order, per-partition slow start: each
        partition grows its own exponential batch window (1 -> 2 -> 4);
        a batch containing an error finishes, then that partition alone
        halts — a failing store sees one probe write per partition, and
        healthy partitions' writes land in their original slots."""
        result = RunResult()
        state: dict = {}
        for name, fn, items, pk in tasks.values():
            part = partition_of(*pk) if pk is not None else None
            st = state.get(part)
            if st is None:
                st = state[part] = {
                    "batch": max(1, INITIAL_BATCH_SIZE),
                    "run": 0, "failed": False, "halted": False,
                }
            if st["halted"]:
                result.skipped.append(name)
                continue
            try:
                if items is None:
                    fn()
                else:
                    fn(items)
            except Exception as err:  # collected, the batch finishes
                result.errors.append((name, err))
                st["failed"] = True
            else:
                result.succeeded.append(name)
            st["run"] += 1
            if st["run"] >= st["batch"]:
                if st["failed"]:
                    st["halted"] = True
                else:
                    st["batch"] *= 2
                    st["run"] = 0
        return result


def run_with_slow_start(
    tasks: list[tuple[str, Callable[[], None]]],
    initial_batch_size: int = INITIAL_BATCH_SIZE,
) -> RunResult:
    """Run (name, fn) tasks in exponentially growing batches; halt after
    the first batch containing an error and mark the rest skipped."""
    result = RunResult()
    i = 0
    batch = max(1, min(initial_batch_size, len(tasks)))
    while i < len(tasks):
        failed = False
        for name, fn in tasks[i : i + batch]:
            try:
                fn()
            except Exception as err:  # collected, batch finishes
                result.errors.append((name, err))
                failed = True
            else:
                result.succeeded.append(name)
        i += batch
        if failed:
            result.skipped.extend(name for name, _ in tasks[i:])
            return result
        batch = min(batch * 2, len(tasks) - i) or 1
    return result
