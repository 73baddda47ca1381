"""Durable state store: write-ahead log, snapshots, cold-restart recovery.

The reference operator is stateless because etcd gives it durable,
linearizable state for free — a crashed controller-runtime manager relists
from the apiserver and resumes (SURVEY §2b). This package owns its apiserver
(`cluster/store.py`), so it owns the durability story too: without this
module a whole-process crash loses the cluster, and every resilience
result (chaos crash-restarts, shard failover) only covers partial
failures where the store itself survives.

Design — the classic WAL + checkpoint pair, one fsync policy knob:

  WAL        Every committed store mutation ends in exactly one emitted
             watch event (`ObjectStore._emit`), so the event IS the
             mutation record: `DurableLog.commit` appends it as one
             checksummed, length-prefixed record carrying the event seq,
             the post-write object (resourceVersion included) and the
             prior version. In-memory event-log compaction is journaled
             as its own record type so replay reproduces the retained
             watch window exactly, not just the object table.

  Snapshots  A full pickled store image (objects, retained events,
             counters, compaction horizon, virtual-clock time), written
             via tmp+rename with its own checksum, cut on a virtual-time
             interval or when the live WAL segment exceeds
             `wal_max_bytes`. Each snapshot rotates the WAL to a fresh
             segment named by the snapshot seq.

  Truncation Segments are pruned only once every record they hold is ≤
             the OLDEST retained snapshot's seq (`keep_snapshots` ≥ 2 by
             default) — the invariant tests/test_durability.py pins:
             WAL truncation may never outrun the snapshots that still
             need those records for corruption fallback, and the
             in-memory compaction horizon never constrains recovery
             because compaction is itself a WAL record.

  Recovery   `ObjectStore.recover(dir)` / `recover_in_place`: newest
             snapshot that checksums clean (falling back to older ones —
             a corrupted snapshot costs replay length, never data), then
             WAL replay in seq order. A torn tail — a crash mid-append —
             stops replay at the first short/corrupt record; with
             `fsync: commit` nothing acknowledged is ever behind the
             torn record, so recovery is exact.

File layout under `wal_dir`:

    snapshot-<seq:020d>.bin    checksummed store image at seq
    wal-<seq:020d>.log         records with seq > <seq>, append-only

  Partitioned layout (`DurabilityConfig.partitions` > 1, see
  `PartitionedLog`): the write path splits by (namespace, kind) into K
  independent partitions, each a full DurableLog in its own `pNNN/`
  subdirectory with its own segment chain, snapshot generations and
  retention horizon; a `layout.json` marker pins the partition scheme.
  The store keeps ONE logical seq/event-log (watch semantics are
  untouched); recovery merges the per-partition replay streams by
  global seq back into a bit-identical store.

Fault-injection hooks (`tear_tail`, `corrupt_latest_snapshot`, `stall`)
are driven by the chaos harness (`chaos/harness.py`: `process_crash`,
`wal_torn_write`, `snapshot_corruption`, `disk_stall` faults, plus the
partition-scoped `partition_wal_divergence` / `partition_disk_stall`) —
the sim never actually kills the interpreter, so crash-consistency
failure modes are injected deterministically instead of left to the OS.

The counterpart of grove_tpu/cluster/durability.py. The records and
snapshots are pickles of this package's objects, so they name its own
modules: the decoded record stream and a recovered store equal the
reference's, the bytes (and so a size-triggered snapshot cut,
`wal_max_bytes`) do not. Nothing on the card is journaled: the store
holds plain host objects only.
"""

from __future__ import annotations

import heapq
import itertools
import json
import operator
import os
import pickle
import re
import struct
import time
import zlib
from typing import TYPE_CHECKING, Any, BinaryIO, Callable

if TYPE_CHECKING:  # pragma: no cover - import cycle guard (store imports us)
    from .store import ObjectStore

#: per-file magic headers: a WAL segment opened as a snapshot (or any
#: foreign file dropped into the dir) is rejected up front, not half-read
WAL_MAGIC = b"GRVWAL1\n"
SNAP_MAGIC = b"GRVSNP1\n"

#: record header: <u32 payload length><u32 crc32(payload)>
_HDR = struct.Struct("<II")

#: record payload types (pickled tuples)
#: event records grow a 5th element — the writer's TERM — once the log
#: has ever been promoted (term > 0); 4-tuple records from pre-HA
#: histories replay as term 0, so old WALs stay readable
_REC_EVENT = "event"      # ("event", seq, clock_now, Event[, term])
_REC_COMPACT = "compact"  # ("compact", lsn, before_seq)
_REC_TERM = "term"        # ("term", lsn, new_term) — a promotion fence

_EVENT_SEQ_KEY = operator.attrgetter("seq")

_SNAP_RE = re.compile(r"^snapshot-(\d{20})\.bin$")
_SEG_RE = re.compile(r"^wal-(\d{20})\.log$")
_UID_RE = re.compile(r"^uid-(\d+)$")
_PART_RE = re.compile(r"^p(\d{3})$")

#: partition-layout marker written at the top of a partitioned wal_dir;
#: pins (partitions, partition_map) so a resume under a different scheme
#: is refused instead of silently stranding history (see PartitionedLog)
LAYOUT_NAME = "layout.json"


class DurabilityError(Exception):
    pass


class FencedAppend(DurabilityError):
    """A deposed leader tried to append into a history that has moved to
    a higher term (a standby was promoted). Raised BEFORE anything is
    written — in memory or on disk — so a stale leader can delay nothing
    and diverge nothing (cluster/replication.py, the dual-leader chaos
    fault)."""


class ReplicaGap(DurabilityError):
    """A WAL tailer fell behind the leader's retention window (a needed
    segment was pruned before it was shipped): the standby cannot catch
    up incrementally and must RE-SEED from the leader's snapshots
    (StandbyReplica handles this by bootstrapping a fresh generation)."""


def _crc(payload: bytes) -> int:
    return zlib.crc32(payload) & 0xFFFFFFFF


def _write_record(fh: BinaryIO, payload: bytes) -> int:
    fh.write(_HDR.pack(len(payload), _crc(payload)))
    fh.write(payload)
    return _HDR.size + len(payload)


def _read_records(path: str):
    """Yield unpickled records until EOF or the first torn/corrupt record
    (short header, short payload, or checksum mismatch — all the shapes a
    crash mid-append leaves). Yields ("__torn__",) as a final sentinel
    when the tail was torn, so callers can report it."""
    with open(path, "rb") as fh:
        if fh.read(len(WAL_MAGIC)) != WAL_MAGIC:
            yield ("__torn__",)
            return
        while True:
            hdr = fh.read(_HDR.size)
            if not hdr:
                return  # clean EOF
            if len(hdr) < _HDR.size:
                yield ("__torn__",)
                return
            length, crc = _HDR.unpack(hdr)
            payload = fh.read(length)
            if len(payload) < length or _crc(payload) != crc:
                yield ("__torn__",)
                return
            try:
                yield pickle.loads(payload)
            except Exception:
                yield ("__torn__",)
                return


class DurableLog:
    """The write-ahead log + snapshot engine attached to one ObjectStore
    (`store.attach_durability`). Single-threaded like the store itself;
    every public method is driven either by the store's commit path or by
    the recovery/chaos drivers."""

    def __init__(self, config, clock, metrics=None, resume=False, *,
                 wal_dir: str | None = None, partition: int | None = None,
                 capture: Callable[["ObjectStore"], dict] | None = None):
        """config: api.config.DurabilityConfig (validated); clock: the
        SimClock snapshots are paced by; metrics: optional
        MetricsRegistry for the grove_store_wal_* families.

        resume=False (a fresh store's log) refuses a wal_dir that
        already holds durable state — journaling a new history over an
        old one would interleave colliding seqs. resume=True adopts the
        populated dir WITHOUT touching it: the caller has already
        recovered the store from it and MUST cut `checkpoint(store)`
        before any append (no live segment is opened until then) — the
        Cluster.from_durable / Harness.recover boot path.

        The keyword-only trio makes one instance a PARTITION of a
        PartitionedLog: `wal_dir` overrides config.wal_dir (the pNNN
        subdirectory), `partition` labels the grove_store_wal_* series,
        and `capture` replaces the full-store snapshot image with the
        partition's slice. Classic single-WAL behavior is the default."""
        if not (wal_dir or config.wal_dir):
            raise DurabilityError("DurableLog requires config.wal_dir")
        self.dir = wal_dir or config.wal_dir
        self.config = config
        self.clock = clock
        self.metrics = metrics
        self.partition = partition
        self._capture = capture
        #: seq of the last record THIS log appended (== store.last_seq
        #: for the classic log; the partition's own position otherwise —
        #: what the partition snapshot dedup guard keys on)
        self._applied_seq = 0
        #: wall seconds spent inside the commit path (append + cadence
        #: snapshot work) — the store-bench reads the per-partition
        #: split to model parallel commit (bench.py --store-bench)
        self.wall_seconds = 0.0
        #: HA replication (cluster/replication.py): the leadership TERM
        #: this log writes under (0 = never promoted; stamped into every
        #: record once > 0), the shared ReplicationLink carrying the
        #: fleet's current term (None = no replication configured), the
        #: per-commit ship hook semi-sync/bounded-lag replication
        #: installs, and the fenced-append counter
        self.term = 0
        self.link = None
        self.post_commit: Callable | None = None
        self.fenced_appends_total = 0
        os.makedirs(self.dir, exist_ok=True)
        #: disk-stall fault state: while > 0, snapshot cuts are deferred
        #: (the disk is busy; appends still buffer) — chaos ticks it down
        self.stalled_steps = 0
        self.snapshots_deferred_total = 0
        self._stall_deferred = False
        #: lifetime counters (debug_dump()["store"]["durability"])
        self.wal_records_total = 0
        self.wal_bytes_total = 0
        self.snapshots_total = 0
        self.last_snapshot_seq = 0
        self._last_snapshot_time = clock.now()
        self._segment: BinaryIO | None = None
        self._segment_bytes = 0
        if self.partition is None and (
            os.path.exists(os.path.join(self.dir, LAYOUT_NAME))
            or any(_PART_RE.match(n) for n in os.listdir(self.dir))
        ):
            # a single-WAL log over a PARTITIONED dir (fresh or resume)
            # would append a second, top-level history next to the pNNN
            # chains — recovery would then see two interleaved layouts
            raise DurabilityError(
                f"{self.dir!r} holds a partitioned WAL layout; set "
                "config.durability.partitions to match it (or use a "
                "fresh directory)"
            )
        if resume:
            return  # no live segment until the caller's checkpoint()
        if any(
            _SNAP_RE.match(n) or _SEG_RE.match(n)
            for n in os.listdir(self.dir)
        ):
            # a fresh store journaling over a previous run's state would
            # interleave two histories with colliding seqs — refuse.
            # Boot from the old state with Harness.recover(config) /
            # Cluster.from_durable, inspect it with
            # ObjectStore.recover(dir), or point wal_dir at an empty
            # directory.
            raise DurabilityError(
                f"{self.dir!r} already holds durable state; boot from it "
                "with Harness.recover(config) (or inspect with "
                "ObjectStore.recover(dir)), or use an empty directory"
            )
        self._open_segment(base_seq=0)

    # -- segment plumbing ---------------------------------------------------
    def _segment_path(self, base_seq: int) -> str:
        return os.path.join(self.dir, f"wal-{base_seq:020d}.log")

    def _snapshot_path(self, seq: int) -> str:
        return os.path.join(self.dir, f"snapshot-{seq:020d}.bin")

    def _open_segment(self, base_seq: int) -> None:
        """Truncate-create the segment for records with seq > base_seq.
        Truncation over an existing file is deliberate: segments open only
        at init (guarded: the dir must be empty of durable state) and at
        snapshot/checkpoint cuts, where any same-named leftover — e.g. the
        torn tail of the very segment a crash-after-snapshot recovery
        rewound to — holds nothing recovery could reach (a readable record
        would have advanced the recovered seq past base_seq)."""
        if self._segment is not None:
            self._segment.close()
        self._segment = open(self._segment_path(base_seq), "wb")
        self._segment.write(WAL_MAGIC)
        self._segment.flush()
        self._segment_bytes = self._segment.tell()

    def _fsync(self, fh: BinaryIO, at_snapshot: bool = False) -> None:
        policy = self.config.fsync
        if policy == "commit" or (policy == "snapshot" and at_snapshot):
            os.fsync(fh.fileno())

    def close(self) -> None:
        if self._segment is not None:
            self._segment.flush()
            self._segment.close()
            self._segment = None

    # -- fencing (HA replication) -------------------------------------------
    def check_fence(self) -> None:
        """Refuse to extend a history that moved to a higher term: a
        promoted standby bumped the shared ReplicationLink's term, and a
        deposed leader waking up must fail its append — BEFORE any state,
        in memory or on disk, changes (ObjectStore._emit calls this ahead
        of the event-list append). Models the channel-level refusal a
        real standby gives a lower-term shipper (and the epoch check a
        fencing-aware WAL store performs per append)."""
        if self.link is not None and self.link.term > self.term:
            self.fenced_appends_total += 1
            if self.metrics is not None:
                self.metrics.counter(
                    "grove_store_fenced_appends_total",
                    "appends refused because the history moved to a "
                    "higher term (a standby was promoted)",
                ).inc(**self._labels())
            raise FencedAppend(
                f"append fenced: this log writes term {self.term} but "
                f"the store history is at term {self.link.term} (a "
                "standby was promoted); a deposed leader must not "
                "diverge the history"
            )

    def bump_term(self, term: int) -> None:
        """Promotion: adopt a new leadership term — journaled as its own
        record so recovery reproduces the fence point, and stamped into
        every subsequent event record. The caller (StandbyReplica.promote)
        bumps the shared link too, which is what actually deposes the old
        leader."""
        if term <= self.term:
            raise DurabilityError(
                f"term must increase (have {self.term}, got {term})"
            )
        self.term = term
        if self._segment is not None:
            self._append((_REC_TERM, self._applied_seq, term))

    # -- the commit path ----------------------------------------------------
    def commit(self, store: "ObjectStore", event) -> None:
        """Called by ObjectStore._emit for every committed mutation: append
        the event record, then cut a snapshot when the cadence says so.
        Records are flushed to the OS per append (in-process recovery must
        see them); fsync is governed by the policy — `commit` makes every
        acknowledged write crash-durable, `snapshot`/`never` trade the
        tail since the last fsync for throughput."""
        self.check_fence()
        t0 = time.perf_counter()
        self._applied_seq = event.seq
        # the clock stamp lets a new-process boot resume virtual time at
        # the last committed write, not the (older) last snapshot
        rec = (_REC_EVENT, event.seq, self.clock.now(), event)
        self._append(rec + (self.term,) if self.term else rec)
        self._maybe_snapshot(store)
        self.wall_seconds += time.perf_counter() - t0
        if self.post_commit is not None:
            # replication ship hook (outside wall_seconds: the standby
            # keeps its own ship accounting) — semi-sync appends to the
            # standby's journal before the commit returns
            self.post_commit(store, event)

    def log_compaction(self, store: "ObjectStore", before_seq: int) -> None:
        """Journal an in-memory event-log compaction (compact_events) so
        replay reproduces the retained watch window bit-identically. The
        WAL itself is NOT truncated here — WAL truncation is tied to
        snapshots alone (see prune in _snapshot), which is the invariant
        that keeps the compaction horizon from ever outrunning what
        recovery needs."""
        self._append((_REC_COMPACT, store.last_seq, before_seq))

    def _append(self, rec: tuple) -> None:
        payload = pickle.dumps(rec, protocol=pickle.HIGHEST_PROTOCOL)
        n = _write_record(self._segment, payload)
        self._segment.flush()
        self._fsync(self._segment)
        self._segment_bytes += n
        self.wal_records_total += 1
        self.wal_bytes_total += n
        if self.metrics is not None:
            labels = self._labels()
            self.metrics.counter(
                "grove_store_wal_records_total",
                "WAL records appended",
            ).inc(**labels)
            self.metrics.counter(
                "grove_store_wal_bytes_total",
                "WAL bytes appended",
            ).inc(n, **labels)

    def _labels(self) -> dict[str, str]:
        """Metric labels: the partition series when this log is one
        partition of a PartitionedLog, the unlabeled classic series
        otherwise (pre-partitioning dashboards keep working; total()
        sums either way)."""
        if self.partition is None:
            return {}
        return {"partition": str(self.partition)}

    # -- snapshots ----------------------------------------------------------
    def _maybe_snapshot(self, store: "ObjectStore") -> None:
        cfg = self.config
        due = (
            self.clock.now() - self._last_snapshot_time
            >= cfg.snapshot_interval_seconds
            or self._segment_bytes >= cfg.wal_max_bytes
        )
        if not due:
            return
        if self.stalled_steps > 0:
            # disk_stall fault: the device is busy — appends buffer, but
            # checkpoint work defers (recovery replay just gets longer).
            # Counted once per DEFERRED CUT (reset when one lands), not
            # once per commit while the stall holds the cut back.
            if not self._stall_deferred:
                self._stall_deferred = True
                self.snapshots_deferred_total += 1
            return
        self.snapshot(store)

    def checkpoint(self, store: "ObjectStore") -> int:
        """Post-recovery checkpoint: clear any armed disk stall and force
        a snapshot + segment rotation at the recovered seq, so the old —
        possibly torn — tail is sealed behind a fresh generation and is
        never appended over. os.replace also heals a corrupted snapshot
        file at the same seq."""
        self.stalled_steps = 0
        return self.snapshot(store, force=True)

    def snapshot(self, store: "ObjectStore", force: bool = False,
                 state: dict | None = None) -> int | None:
        """Cut a checksummed snapshot of the full store state at
        store.last_seq, rotate the WAL to a fresh segment, and prune
        snapshots/segments past the retention window. Returns the
        snapshot seq, or None when nothing changed since the last cut.
        `state` is a precomputed image (PartitionedLog's one-pass
        checkpoint slicing) — it replaces the capture, nothing else."""
        seq = store.last_seq
        # the nothing-changed dedup: the classic log keys on the global
        # seq; a partition keys on ITS OWN applied position (the global
        # seq moves on every other partition's traffic, but re-pickling
        # an unchanged slice buys nothing)
        unchanged = (
            self._applied_seq <= self.last_snapshot_seq
            if self.partition is not None
            else seq == self.last_snapshot_seq
        )
        if unchanged and self.snapshots_total and not force:
            self._last_snapshot_time = self.clock.now()
            return None
        if state is not None:
            pass
        elif self._capture is not None:
            state = self._capture(store)
        else:
            state = {
                "format": 1,
                "last_seq": seq,
                "uid": store._uid,
                "compacted_seq": store._compacted_seq,
                "kind_serial": dict(store._kind_serial),
                "objs": {k: dict(b) for k, b in store._objs.items() if b},
                "events": list(store._events),
                "clock": store.clock.now(),
            }
        # the term rides every snapshot image (default 0 pre-HA; old
        # snapshots without the key recover as term 0)
        state.setdefault("term", self.term)
        payload = pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL)
        path = self._snapshot_path(seq)
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(SNAP_MAGIC)
            fh.write(_HDR.pack(len(payload), _crc(payload)))
            fh.write(payload)
            fh.flush()
            self._fsync(fh, at_snapshot=True)
        os.replace(tmp, path)
        self.snapshots_total += 1
        self._stall_deferred = False
        self.last_snapshot_seq = seq
        self._last_snapshot_time = self.clock.now()
        if self.metrics is not None:
            self.metrics.counter(
                "grove_store_snapshots_total", "durable snapshots cut"
            ).inc(**self._labels())
        self._open_segment(base_seq=seq)
        self._prune()
        return seq

    def _prune(self) -> None:
        """Retention: keep the newest `keep_snapshots` snapshots; drop WAL
        segments whose every record is ≤ the oldest retained snapshot seq
        (a segment covers (base, next_base]; it is disposable only when
        the NEXT segment's base is within the retained horizon)."""
        snaps = self.snapshot_seqs()
        keep = max(1, self.config.keep_snapshots)
        for seq in snaps[:-keep]:
            os.unlink(self._snapshot_path(seq))
        retained = snaps[-keep:] if snaps else []
        # the pruning horizon is the oldest retained snapshot — but only
        # once a FULL retention window exists: with fewer generations the
        # deepest corruption fallback is the empty store + full replay,
        # which needs every segment (the invariant a one-snapshot prune
        # would break: corrupt that snapshot and the history is gone)
        horizon = retained[0] if len(retained) == keep else 0
        bases = self.segment_bases()
        for base, next_base in zip(bases, bases[1:]):
            if next_base <= horizon:
                os.unlink(self._segment_path(base))

    # -- directory introspection -------------------------------------------
    def snapshot_seqs(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            m = _SNAP_RE.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def segment_bases(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            m = _SEG_RE.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def wal_floor(self) -> int:
        """Oldest seq the retained WAL can replay from (the first
        segment's base). The pinned truncation invariant:
        wal_floor() <= oldest retained snapshot seq, always."""
        bases = self.segment_bases()
        return bases[0] if bases else 0

    def adopt_clock(self, clock) -> None:
        """Re-home the log onto another clock (promotion: the standby's
        journal joins the live cluster's virtual time; the snapshot
        cadence restarts from now)."""
        self.clock = clock
        self._last_snapshot_time = clock.now()

    def adopt_metrics(self, metrics) -> None:
        """Promotion: the standby's journal (built metric-less — its
        appends must not count into the LEADER's WAL series) starts
        exporting as the cluster's durability."""
        self.metrics = metrics

    def debug_state(self) -> dict[str, Any]:
        snaps = self.snapshot_seqs()
        return {
            "wal_dir": self.dir,
            "fsync": self.config.fsync,
            "term": self.term,
            "fenced_appends_total": self.fenced_appends_total,
            "wal_records_total": self.wal_records_total,
            "wal_bytes_total": self.wal_bytes_total,
            "segment_bytes": self._segment_bytes,
            "segments": len(self.segment_bases()),
            "snapshots_total": self.snapshots_total,
            "snapshots_retained": len(snaps),
            "last_snapshot_seq": self.last_snapshot_seq,
            "snapshots_deferred_total": self.snapshots_deferred_total,
            "stalled_steps": self.stalled_steps,
        }

    # -- chaos fault hooks --------------------------------------------------
    def tear_tail(self) -> None:
        """Simulate a crash mid-append: a record header claiming more
        bytes than follow lands at the segment tail — exactly what a torn
        write leaves. The record was never acknowledged, so recovery
        stopping at it loses nothing committed."""
        if self._segment is None:
            return  # resume mode before the boot checkpoint: no tail yet
        self._segment.write(_HDR.pack(1 << 20, 0))
        self._segment.write(b"torn-in-flight-append")
        self._segment.flush()

    def seal_bootstrap(self) -> None:
        """A bootstrap-SEEDED journal (a standby generation): the empty
        genesis segment opened at construction implies history from
        seq 0 this directory never actually held — records at or below
        the bootstrap image exist only as the checkpoint snapshot. Drop
        it so recovery's gap check (and the corruption-survivability
        gate) see the journal's true floor instead of a phantom full
        chain. No-op when the journal genuinely starts at seq 0."""
        if self.last_snapshot_seq <= 0:
            return
        path = self._segment_path(0)
        try:
            if os.path.getsize(path) <= len(WAL_MAGIC):
                os.unlink(path)
        except FileNotFoundError:
            pass

    def can_survive_snapshot_corruption(self) -> bool:
        """Whether losing the NEWEST snapshot still leaves an anchored
        recovery: another retained snapshot to fall back to, or a
        segment chain reaching seq 0 (full replay). False for a young
        standby journal — its bootstrap checkpoint is the sole anchor
        and no WAL exists below it (seal_bootstrap), so a corruption
        there is unrecoverable by construction (the chaos corruption
        draw is gated on this: its contract is fallback, not data
        loss)."""
        if len(self.snapshot_seqs()) >= 2:
            return True
        bases = self.segment_bases()
        return bool(bases) and bases[0] == 0

    def corrupt_latest_snapshot(self) -> str | None:
        """Flip bytes in the middle of the newest snapshot (bit-rot /
        partial page write): recovery must detect the checksum mismatch
        and fall back to the previous retained snapshot."""
        snaps = self.snapshot_seqs()
        if not snaps:
            return None
        path = self._snapshot_path(snaps[-1])
        size = os.path.getsize(path)
        with open(path, "r+b") as fh:
            fh.seek(max(len(SNAP_MAGIC) + _HDR.size, size // 2))
            fh.write(b"\xde\xad\xbe\xef")
        return path

    def stall(self, steps: int) -> None:
        """Arm a disk stall for `steps` chaos steps: snapshot cuts defer
        until the stall clears (tick_stall)."""
        self.stalled_steps = max(self.stalled_steps, int(steps))

    def tick_stall(self) -> None:
        if self.stalled_steps > 0:
            self.stalled_steps -= 1


class PartitionedLog:
    """K independent DurableLog partitions behind the DurableLog facade
    (`DurabilityConfig.partitions` > 1): every committed mutation routes
    by (namespace, kind) to ONE partition's WAL segment chain, snapshot
    generation and retention horizon, so durable commits, fsyncs and
    snapshot cuts run per partition — in a real deployment concurrently,
    one appender per partition — while the store keeps its single
    logical seq/event-log for watch semantics. Recovery merges the
    partition replay streams by global seq (`load_durable_state`
    detects the layout from the pNNN subdirs), rebuilding a store
    bit-identical to what a single WAL of the same write history
    recovers.

    On-disk layout under `wal_dir`:

        layout.json    {"partitions": K, "partition_map": {...}}
        p000/..pNNN/   one classic DurableLog directory each

    The marker PINS the partition scheme: resuming a wal_dir under a
    different partition count or map is refused loudly — a remapped
    kind's history would live in a partition the new scheme never
    snapshots again, and a later corruption fallback in the new home
    partition could then silently lose it. Re-partitioning means
    recovering into a fresh wal_dir (docs/operations.md "Partitioned
    WAL layout")."""

    #: per-partition metric families this log owns; reconciled at
    #: construction so a smaller layout leaves no stale partition series
    #: on /metrics (the sharded plane's shard-series hygiene pattern)
    METRIC_FAMILIES = (
        "grove_store_wal_records_total",
        "grove_store_wal_bytes_total",
        "grove_store_snapshots_total",
    )

    def __init__(self, config, clock, metrics=None, resume=False):
        if not config.wal_dir:
            raise DurabilityError("PartitionedLog requires config.wal_dir")
        if config.partitions < 2:
            raise DurabilityError(
                "PartitionedLog requires config.partitions > 1 "
                "(use DurableLog for the classic single WAL)"
            )
        self.dir = config.wal_dir
        self.config = config
        self.clock = clock
        self.metrics = metrics
        self.num_partitions = int(config.partitions)
        self._map = {k: int(v) for k, v in config.partition_map.items()}
        os.makedirs(self.dir, exist_ok=True)
        names = os.listdir(self.dir)
        if any(_SNAP_RE.match(n) or _SEG_RE.match(n) for n in names):
            raise DurabilityError(
                f"{self.dir!r} holds single-WAL durable state; a "
                "partitioned layout cannot adopt it in place — boot it "
                "with partitions: 1, or point wal_dir at a fresh "
                "directory"
            )
        marker = os.path.join(self.dir, LAYOUT_NAME)
        layout = {
            "format": 1,
            "partitions": self.num_partitions,
            "partition_map": dict(sorted(self._map.items())),
        }
        #: replication facade state (see DurableLog): the shared link +
        #: ship hook live on the FACADE — partitions never fence or ship
        #: individually (one check, one ship, per logical commit)
        self.link = None
        self.post_commit = None
        self._fenced_appends = 0
        if resume:
            on_disk = self._read_layout(marker)
            # the promotion term rides the marker but is NOT part of the
            # pinned partition scheme — strip it before comparing
            on_disk = {k: v for k, v in on_disk.items() if k != "term"}
            if on_disk != layout:
                raise DurabilityError(
                    f"{self.dir!r} was written under partition layout "
                    f"{on_disk}; config says {layout}. Re-partitioning "
                    "in place would strand history in partitions the "
                    "new scheme never snapshots — recover into a fresh "
                    "wal_dir instead"
                )
        else:
            if os.path.exists(marker) or any(
                _PART_RE.match(n) for n in names
            ):
                raise DurabilityError(
                    f"{self.dir!r} already holds partitioned durable "
                    "state; boot from it with Harness.recover(config) "
                    "(or inspect with ObjectStore.recover(dir)), or "
                    "use an empty directory"
                )
            tmp = marker + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(layout, fh)
                fh.write("\n")
            os.replace(tmp, marker)
        self.partitions = [
            DurableLog(
                config, clock, metrics=metrics, resume=resume,
                wal_dir=os.path.join(self.dir, f"p{i:03d}"),
                partition=i, capture=self._capture_partition(i),
            )
            for i in range(self.num_partitions)
        ]
        #: partition of the most recent commit — where an in-flight
        #: append would be, so the chaos tear_tail facade lands there
        self._last_commit_partition = 0
        #: (namespace, kind) -> partition memo: the route is computed
        #: once per distinct pair instead of per commit and per scanned
        #: object during snapshot capture (bounded by the live
        #: namespace x kind population, like the store's label index)
        self._route: dict[tuple[str, str], int] = {}
        if metrics is not None:
            metrics.gauge(
                "grove_store_partitions",
                "configured durable write-path partitions",
            ).set(self.num_partitions)
        self._reconcile_metric_series()

    @staticmethod
    def _read_layout(marker: str) -> dict:
        try:
            with open(marker) as fh:
                return json.load(fh)
        except FileNotFoundError:
            raise DurabilityError(
                f"{marker!r} missing: the wal_dir holds no partition "
                "layout marker — not a partitioned durable dir"
            ) from None
        except Exception as exc:
            raise DurabilityError(
                f"unreadable partition layout marker {marker!r}: {exc}"
            ) from exc

    # -- routing -------------------------------------------------------------
    def partition_of(self, namespace: str, kind: str) -> int:
        """(namespace, kind) -> partition index: the partition_map pins
        win ("namespace/Kind" over bare "Kind"), unlisted keys hash —
        same stable-hash discipline as controller/sharding.shard_of."""
        idx = self._route.get((namespace, kind))
        if idx is not None:
            return idx
        pinned = self._map.get(f"{namespace}/{kind}")
        if pinned is None:
            pinned = self._map.get(kind)
        if pinned is not None:
            idx = pinned % self.num_partitions
        else:
            idx = (
                zlib.crc32(f"{namespace}/{kind}".encode())
                % self.num_partitions
            )
        self._route[(namespace, kind)] = idx
        return idx

    def _capture_partition(self, idx: int):
        """Snapshot image of partition `idx`: the store's global
        counters (exact-at-cut; recovery max-merges them) plus ONLY this
        partition's slice of the object table and retained event log —
        the per-cut pickle cost drops from O(store) to O(slice)."""

        def capture(store: "ObjectStore") -> dict:
            part_of = self.partition_of
            objs = {}
            for kind, bucket in store._objs.items():
                if not bucket:
                    continue
                sliced = {
                    key: obj
                    for key, obj in bucket.items()
                    if part_of(key[0], kind) == idx
                }
                if sliced:
                    objs[kind] = sliced
            return {
                "format": 1,
                "last_seq": store.last_seq,
                "uid": store._uid,
                "compacted_seq": store._compacted_seq,
                "kind_serial": dict(store._kind_serial),
                "objs": objs,
                "events": [
                    e for e in store._events
                    if part_of(e.namespace, e.kind) == idx
                ],
                "clock": store.clock.now(),
            }

        return capture

    # -- fencing / terms (HA replication; see DurableLog) --------------------
    @property
    def term(self) -> int:
        return self.partitions[0].term

    @term.setter
    def term(self, value: int) -> None:
        for p in self.partitions:
            p.term = value

    @property
    def fenced_appends_total(self) -> int:
        return self._fenced_appends

    def check_fence(self) -> None:
        if self.link is not None and self.link.term > self.term:
            self._fenced_appends += 1
            if self.metrics is not None:
                self.metrics.counter(
                    "grove_store_fenced_appends_total",
                    "appends refused because the history moved to a "
                    "higher term (a standby was promoted)",
                ).inc()
            raise FencedAppend(
                f"append fenced: this log writes term {self.term} but "
                f"the store history is at term {self.link.term} (a "
                "standby was promoted); a deposed leader must not "
                "diverge the history"
            )

    def bump_term(self, term: int) -> None:
        """Promotion: journal the term record to EVERY partition (the
        merge applies the K copies idempotently, like compactions) and
        pin the new term into the layout marker."""
        for p in self.partitions:
            p.bump_term(term)
        marker = os.path.join(self.dir, LAYOUT_NAME)
        layout = self._read_layout(marker)
        layout["term"] = term
        tmp = marker + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(layout, fh)
            fh.write("\n")
        os.replace(tmp, marker)

    def seal_bootstrap(self) -> None:
        for p in self.partitions:
            p.seal_bootstrap()

    def adopt_clock(self, clock) -> None:
        self.clock = clock
        for p in self.partitions:
            p.adopt_clock(clock)

    def adopt_metrics(self, metrics) -> None:
        self.metrics = metrics
        for p in self.partitions:
            p.adopt_metrics(metrics)
        if metrics is not None:
            metrics.gauge(
                "grove_store_partitions",
                "configured durable write-path partitions",
            ).set(self.num_partitions)
            self._reconcile_metric_series()

    # -- the DurableLog facade ----------------------------------------------
    def commit(self, store: "ObjectStore", event) -> None:
        self.check_fence()
        idx = self.partition_of(event.namespace, event.kind)
        self._last_commit_partition = idx
        self.partitions[idx].commit(store, event)
        if self.post_commit is not None:
            self.post_commit(store, event)

    def log_compaction(self, store: "ObjectStore", before_seq: int) -> None:
        """Journaled to EVERY partition: each partition's replay must
        trim its own retained slice of the watch window. The merge
        applies the K copies idempotently (one horizon, max-kept)."""
        for p in self.partitions:
            p.log_compaction(store, before_seq)

    def checkpoint(self, store: "ObjectStore") -> int | None:
        for p in self.partitions:
            p.stalled_steps = 0
        return self.snapshot(store, force=True)

    def snapshot(self, store: "ObjectStore", force: bool = False) -> int | None:
        """Cut every partition at the same global seq, slicing the
        store ONCE (K independent captures would each scan the whole
        object table and event log — O(K x store) per checkpoint)."""
        states = self._capture_all(store)
        cuts = [
            s for p, st in zip(self.partitions, states)
            if (s := p.snapshot(store, force=force, state=st)) is not None
        ]
        return max(cuts) if cuts else None

    def _capture_all(self, store: "ObjectStore") -> list[dict]:
        """One pass over the store producing all K partition images
        (same per-image shape as _capture_partition). The global
        counters are exact-at-cut and shared read-only; each image is
        pickled before anything can mutate."""
        base = {
            "format": 1,
            "last_seq": store.last_seq,
            "uid": store._uid,
            "compacted_seq": store._compacted_seq,
            "kind_serial": dict(store._kind_serial),
            "clock": store.clock.now(),
        }
        part_of = self.partition_of
        objs: list[dict] = [{} for _ in range(self.num_partitions)]
        for kind, bucket in store._objs.items():
            if not bucket:
                continue
            for key, obj in bucket.items():
                objs[part_of(key[0], kind)].setdefault(kind, {})[key] = obj
        events: list[list] = [[] for _ in range(self.num_partitions)]
        for e in store._events:
            events[part_of(e.namespace, e.kind)].append(e)
        return [
            {**base, "objs": objs[i], "events": events[i]}
            for i in range(self.num_partitions)
        ]

    def close(self) -> None:
        for p in self.partitions:
            p.close()

    # -- aggregate counters (debug_dump / bench read these) ------------------
    @property
    def wal_records_total(self) -> int:
        return sum(p.wal_records_total for p in self.partitions)

    @property
    def wal_bytes_total(self) -> int:
        return sum(p.wal_bytes_total for p in self.partitions)

    @property
    def snapshots_total(self) -> int:
        return sum(p.snapshots_total for p in self.partitions)

    @property
    def snapshots_deferred_total(self) -> int:
        return sum(p.snapshots_deferred_total for p in self.partitions)

    @property
    def last_snapshot_seq(self) -> int:
        return max(p.last_snapshot_seq for p in self.partitions)

    @property
    def wall_seconds(self) -> float:
        """In-process commit wall summed over partitions; the modeled
        parallel wall is max(partition_walls()) — bench.py --store-bench
        reports both."""
        return sum(p.wall_seconds for p in self.partitions)

    def partition_walls(self) -> list[float]:
        return [p.wall_seconds for p in self.partitions]

    def snapshot_seqs(self) -> list[int]:
        return sorted({s for p in self.partitions for s in p.snapshot_seqs()})

    def debug_state(self) -> dict[str, Any]:
        return {
            "wal_dir": self.dir,
            "fsync": self.config.fsync,
            "partitions": self.num_partitions,
            "term": self.term,
            "fenced_appends_total": self.fenced_appends_total,
            "wal_records_total": self.wal_records_total,
            "wal_bytes_total": self.wal_bytes_total,
            "segments": sum(len(p.segment_bases()) for p in self.partitions),
            "snapshots_total": self.snapshots_total,
            "snapshots_retained": sum(
                len(p.snapshot_seqs()) for p in self.partitions
            ),
            "last_snapshot_seq": self.last_snapshot_seq,
            "snapshots_deferred_total": self.snapshots_deferred_total,
            "stalled_steps": self.stalled_steps,
            "per_partition": {
                f"p{i:03d}": p.debug_state()
                for i, p in enumerate(self.partitions)
            },
        }

    # -- metric-series hygiene ------------------------------------------------
    def _reconcile_metric_series(self) -> None:
        """Remove partition-labeled series outside the live layout: a
        registry that outlives a wider layout (a re-boot with fewer
        partitions, an A/B bench loop) must not export dead pNNN series
        forever — the same shape as the sharded plane's shard series."""
        if self.metrics is None:
            return
        live = {str(i) for i in range(self.num_partitions)}
        for family in self.METRIC_FAMILIES:
            metric = self.metrics.get(family)
            if metric is None:
                continue
            for labels in metric.label_sets():
                part = labels.get("partition")
                if part is not None and part not in live:
                    metric.remove(**labels)

    # -- chaos fault hooks ----------------------------------------------------
    @property
    def stalled_steps(self) -> int:
        return max(p.stalled_steps for p in self.partitions)

    @stalled_steps.setter
    def stalled_steps(self, value: int) -> None:
        for p in self.partitions:
            p.stalled_steps = value

    def stall(self, steps: int) -> None:
        for p in self.partitions:
            p.stall(steps)

    def stall_partition(self, idx: int, steps: int) -> int:
        """Per-partition disk stall (the partition_disk_stall fault):
        ONE partition's snapshot cuts defer while the others keep their
        cadence. Returns the stalled partition index."""
        idx %= self.num_partitions
        self.partitions[idx].stall(steps)
        return idx

    def tick_stall(self) -> None:
        for p in self.partitions:
            p.tick_stall()

    def tear_tail(self) -> None:
        """Facade of the in-flight-append tear: lands on the partition
        that committed most recently — where an in-flight append would
        be."""
        self.tear_partition(self._last_commit_partition)

    def tear_partition(self, idx: int) -> int:
        """Partition-WAL divergence: ONE partition's tail is torn while
        the others keep their (possibly later) committed records —
        recovery rewinds only the unacknowledged record. Returns the
        torn partition index."""
        idx %= self.num_partitions
        self.partitions[idx].tear_tail()
        return idx

    def _newest_snapshot_partition(self):
        best = None
        best_seq = -1
        for p in self.partitions:
            seqs = p.snapshot_seqs()
            if seqs and seqs[-1] > best_seq:
                best, best_seq = p, seqs[-1]
        return best

    def can_survive_snapshot_corruption(self) -> bool:
        """The corruption facade lands on the partition holding the
        globally newest snapshot — survivability is that partition's."""
        best = self._newest_snapshot_partition()
        return best is not None and best.can_survive_snapshot_corruption()

    def corrupt_latest_snapshot(self) -> str | None:
        """Corrupt the globally newest snapshot across partitions (the
        chaos snapshot_corruption facade)."""
        best = self._newest_snapshot_partition()
        return best.corrupt_latest_snapshot() if best is not None else None

    def corrupt_partition_snapshot(self, idx: int) -> str | None:
        return self.partitions[idx % self.num_partitions].corrupt_latest_snapshot()


def _try_load_snapshot(path: str) -> dict | None:
    """The snapshot image when magic + checksum + unpickle all pass,
    else None (corruption falls back, never crashes recovery)."""
    try:
        with open(path, "rb") as fh:
            if fh.read(len(SNAP_MAGIC)) != SNAP_MAGIC:
                return None
            hdr = fh.read(_HDR.size)
            if len(hdr) < _HDR.size:
                return None
            length, crc = _HDR.unpack(hdr)
            payload = fh.read(length)
        if len(payload) < length or _crc(payload) != crc:
            return None
        state = pickle.loads(payload)
        if not isinstance(state, dict) or state.get("format") != 1:
            return None
        return state
    except Exception:
        return None


def _replay_event(store: "ObjectStore", ev) -> None:
    """Re-apply one journaled mutation to the store internals (bypassing
    _emit — replay must not re-journal). The event carries the complete
    post-write MVCC version, so application is a straight install."""
    key = (ev.namespace, ev.name)
    bucket = store._objs.setdefault(ev.kind, {})
    if ev.type == "Deleted":
        old = bucket.pop(key, None)
        if old is not None:
            store._index_remove(ev.kind, key, old)
    else:
        old = bucket.get(key)
        if old is not None:
            store._index_remove(ev.kind, key, old)
        bucket[key] = ev.obj
        store._index_add(ev.kind, key, ev.obj)
    store._kind_serial[ev.kind] = ev.seq
    store._events.append(ev)


def _newest_valid_snapshot(dirpath: str, names: list[str]) -> tuple[dict | None, int]:
    """(state, skipped): the newest snapshot image in `dirpath` that
    checksums clean, falling back to older ones. Corrupt images are
    QUARANTINED (renamed .corrupt — kept for forensics, excluded from
    the snapshot namespace): a corrupt file must never count as a
    retained generation again — the retention window that prunes WAL
    segments assumes every retained snapshot can actually anchor a
    fallback, and a corrupt one silently breaking that assumption is
    how history gets lost on the SECOND corruption."""
    snap_seqs = sorted(
        int(m.group(1)) for m in map(_SNAP_RE.match, names) if m
    )
    skipped = 0
    for seq in reversed(snap_seqs):
        path = os.path.join(dirpath, f"snapshot-{seq:020d}.bin")
        state = _try_load_snapshot(path)
        if state is not None:
            return state, skipped
        skipped += 1
        os.replace(path, path + ".corrupt")
    return None, skipped


class _ReplayStream:
    """Seq-ordered WAL records of ONE directory (the classic log, or one
    partition) past its recovered snapshot: segment skipping, the
    history-gap fail-loud, snapshot-covered-record suppression and
    torn-tail handling in one place — shared by the classic and
    partitioned recovery paths."""

    def __init__(self, dirpath: str, snapshot_seq: int,
                 sparse: bool = False):
        self.dir = dirpath
        self.snapshot_seq = snapshot_seq
        self.applied_seq = snapshot_seq
        #: sparse=True (a partition of a PartitionedLog): segment names
        #: are GLOBAL seqs but the directory holds only the partition's
        #: records, so contiguity is tracked by rotation points (a fully
        #: read segment covers up to the next base even when the last
        #: partition record sits far below it), and a torn record is by
        #: construction a tail tear sealed by the recovery checkpoint
        #: that rotated the segment — the stream continues into the next
        #: generation instead of stopping
        self.sparse = sparse
        self.torn = False
        self.replayed = 0

    def records(self):
        names = os.listdir(self.dir)
        bases = sorted(
            int(m.group(1)) for m in map(_SEG_RE.match, names) if m
        )
        # sparse-only contiguity watermark: how far the chain is KNOWN
        # covered — the snapshot, then each fully read segment's
        # rotation point. (applied_seq alone false-gaps a sparse
        # partition: a segment rotated at global seq S can end with its
        # last partition record far below S.) A CLASSIC stream must NOT
        # use rotation points: its records are dense, so a segment
        # whose tail records are missing (clean truncation under fsync
        # snapshot/never, lost rotation snapshot) leaves applied_seq
        # below the next base — the genuine history gap the check below
        # exists to refuse.
        covered = self.snapshot_seq
        for i, base in enumerate(bases):
            # a segment is skippable when the NEXT segment starts at or
            # below the snapshot (every record in it predates it)
            if i + 1 < len(bases) and bases[i + 1] <= self.snapshot_seq:
                continue
            if base > max(covered, self.applied_seq):
                # the chain has a hole: this segment's records start past
                # the recovered position (every anchoring snapshot AND
                # the bridging segments are gone — e.g. more corrupted
                # snapshots than keep_snapshots covers). Splicing
                # disjoint histories would hand back a silently
                # inconsistent store; fail loud.
                raise DurabilityError(
                    f"unrecoverable durable state in {self.dir!r}: no "
                    f"valid snapshot anchors seq {base} (recovered up "
                    f"to {max(covered, self.applied_seq)}); retained "
                    "history has a gap"
                )
            seg_torn = False
            for rec in _read_records(
                os.path.join(self.dir, f"wal-{base:020d}.log")
            ):
                if rec[0] == "__torn__":
                    self.torn = seg_torn = True
                    break
                if rec[0] == _REC_EVENT:
                    if rec[1] <= self.applied_seq:
                        continue  # covered by the snapshot (or duplicate)
                    self.applied_seq = rec[1]
                    self.replayed += 1
                yield rec
            if seg_torn and not self.sparse and not (
                i + 1 < len(bases) and bases[i + 1] <= self.applied_seq
            ):
                # a torn record ends the classic stream UNLESS the next
                # segment resumes at or below the replay position (the
                # layout a post-recovery checkpoint leaves: the sealed
                # torn tail is fully covered by the next generation) —
                # replaying past a genuine gap would splice disjoint
                # histories. A sparse partition continues instead: a
                # tear only ever lands at a live tail and the segment is
                # rotated before any further append (the crash recovery
                # checkpoints first), so the next generation IS the
                # partition's committed continuation.
                break
            if self.sparse and i + 1 < len(bases):
                covered = max(covered, bases[i + 1])


class WalTailer:
    """Incremental byte-offset reader of one DurableLog directory's
    segment chain — the stream-tail half of the replay implementation
    (HA replication rides it; recovery uses the one-shot _ReplayStream).
    Each poll() yields only the records appended since the previous
    poll, following segment rotations. A torn record at the live tail
    HOLDS the position (it is either an in-flight append or an
    unacknowledged injected tear — retry next poll) unless a newer
    segment exists, in which case the rotation sealed the tear (the
    recovery-checkpoint contract) and the tailer skips into the next
    generation. A segment vanishing under the tailer (pruned past the
    retention window while the standby lagged) raises ReplicaGap — the
    caller must re-seed from snapshots."""

    def __init__(self, dirpath: str, applied_seq: int = 0):
        self.dir = dirpath
        #: event-seq dedup filter: records at or below it are skipped
        #: (how a freshly bootstrapped tailer fast-forwards through the
        #: retained chain to its recovery point)
        self.applied_seq = applied_seq
        self._base: int | None = None
        self._offset = 0

    def _bases(self) -> list[int]:
        try:
            names = os.listdir(self.dir)
        except FileNotFoundError:
            return []
        return sorted(
            int(m.group(1)) for m in map(_SEG_RE.match, names) if m
        )

    def _path(self, base: int) -> str:
        return os.path.join(self.dir, f"wal-{base:020d}.log")

    def poll(self):
        """Yield every record appended since the last poll (events past
        `applied_seq` only; compaction/term records always). Generator —
        the caller must drain it for the position to advance."""
        bases = self._bases()
        if self._base is None:
            if not bases:
                return  # nothing journaled yet; retry later
            # first poll: skip segments the bootstrap recovery already
            # covered (a segment is skippable when the NEXT base is at
            # or below the applied position — _ReplayStream's rule), so
            # the first poll is O(new records), not a second CRC pass
            # over the whole retained chain. Term/compaction records in
            # skipped segments are already folded into the bootstrap
            # image (log.term, _compacted_seq) and re-apply
            # idempotently anyway; the seq filter dedups the rest.
            start = 0
            for i in range(len(bases) - 1):
                if bases[i + 1] <= self.applied_seq:
                    start = i + 1
            self._base, self._offset = bases[start], 0
        while True:
            try:
                with open(self._path(self._base), "rb") as fh:
                    if self._offset == 0:
                        magic = fh.read(len(WAL_MAGIC))
                        if len(magic) < len(WAL_MAGIC):
                            return  # header still in flight
                        if magic != WAL_MAGIC:
                            raise ReplicaGap(
                                f"{self._path(self._base)!r}: bad WAL "
                                "magic while tailing"
                            )
                        self._offset = len(WAL_MAGIC)
                    else:
                        fh.seek(self._offset)
                    while True:
                        hdr = fh.read(_HDR.size)
                        if not hdr:
                            break  # clean EOF: caught up in this segment
                        if len(hdr) < _HDR.size:
                            break  # torn/in-flight: hold position
                        length, crc = _HDR.unpack(hdr)
                        payload = fh.read(length)
                        if len(payload) < length or _crc(payload) != crc:
                            break  # torn/in-flight: hold position
                        try:
                            rec = pickle.loads(payload)
                        except Exception:
                            break  # torn/in-flight: hold position
                        self._offset += _HDR.size + length
                        if rec[0] == _REC_EVENT:
                            if rec[1] <= self.applied_seq:
                                continue
                            self.applied_seq = rec[1]
                        yield rec
            except FileNotFoundError:
                # the segment we pointed at was pruned: the leader's
                # retention window moved past us — whether we had read
                # it fully is unknowable from here, so the standby must
                # re-anchor on a snapshot
                raise ReplicaGap(
                    f"segment wal-{self._base:020d}.log vanished under "
                    f"the tailer in {self.dir!r} (retention outran "
                    "replication); re-seed from snapshots"
                ) from None
            newer = [b for b in self._bases() if b > self._base]
            if not newer:
                # live tail: a torn record here is an unacknowledged
                # in-flight append — hold position, retry next poll
                return
            # rotation happened: the current segment is complete (a torn
            # tail was sealed unacknowledged — recovery checkpointed past
            # it); continue into the next generation
            self._base, self._offset = min(newer), 0


def load_durable_state(wal_dir: str, store: "ObjectStore") -> dict[str, Any]:
    """Rebuild `store` (whose state containers must be empty) from the
    durable dir: newest valid snapshot, then WAL replay in seq order,
    torn-tail tolerant. Auto-detects the layout — a partitioned dir
    (pNNN subdirs, see PartitionedLog) merges the per-partition replay
    streams by global seq. Returns the recovery stats dict (also stashed
    on the store as `recovery_stats` by the callers)."""
    if not os.path.isdir(wal_dir):
        raise DurabilityError(f"no durable state at {wal_dir!r}")
    names = os.listdir(wal_dir)
    pdirs = sorted(
        n for n in names
        if _PART_RE.match(n) and os.path.isdir(os.path.join(wal_dir, n))
    )
    classic = any(_SNAP_RE.match(n) or _SEG_RE.match(n) for n in names)
    if pdirs and classic:
        raise DurabilityError(
            f"{wal_dir!r} holds BOTH single-WAL files and partition "
            "subdirectories — two interleaved histories cannot be "
            "recovered; keep whichever layout is authoritative"
        )
    if pdirs:
        return _load_partitioned_state(wal_dir, pdirs, store)
    if not classic:
        # an existing-but-empty (or mistyped) directory must fail LOUD:
        # "recovering" an empty store from the wrong path would read as
        # the whole cluster history silently vanishing — on the exact
        # code path whose job is disaster recovery. (A legitimately
        # fresh deployment starts through Cluster/DurableLog, which
        # writes the genesis segment before any recovery can run.)
        raise DurabilityError(
            f"{wal_dir!r} holds no durable state (no snapshot or WAL "
            "segment) — wrong directory?"
        )
    state, snapshots_skipped = _newest_valid_snapshot(wal_dir, names)
    snapshot_seq = 0
    if state is not None:
        snapshot_seq = state["last_seq"]
        store._uid = state["uid"]
        store._compacted_seq = state["compacted_seq"]
        store._kind_serial = dict(state["kind_serial"])
        store._objs = {k: dict(b) for k, b in state["objs"].items()}
        store._events = list(state["events"])
        for kind, bucket in store._objs.items():
            for key, obj in bucket.items():
                store._index_add(kind, key, obj)
        if hasattr(store.clock, "_now"):
            # recovery never rewinds a live clock (in-place recovery on a
            # running harness); a fresh clock adopts the snapshot time
            store.clock._now = max(store.clock._now, state["clock"])

    max_uid = store._uid
    term = state.get("term", 0) if state is not None else 0
    stream = _ReplayStream(wal_dir, snapshot_seq)
    for rec in stream.records():
        if rec[0] == _REC_EVENT:
            stamp, ev = rec[2], rec[3]
            if len(rec) > 4:
                term = max(term, rec[4])
            _replay_event(store, ev)
            if hasattr(store.clock, "_now"):
                store.clock._now = max(store.clock._now, stamp)
            if ev.type == "Added":
                m = _UID_RE.match(ev.obj.metadata.uid or "")
                if m:
                    max_uid = max(max_uid, int(m.group(1)) + 1)
        elif rec[0] == _REC_TERM:
            term = max(term, rec[2])
        elif rec[0] == _REC_COMPACT:
            # journaled with the post-clamp horizon; idempotent, so a
            # compaction already reflected in the snapshot re-applies
            # as a no-op (events ≤ horizon are long gone, max() keeps
            # the newer _compacted_seq)
            _, _lsn, before_seq = rec
            store._events = [
                e for e in store._events if e.seq > before_seq
            ]
            store._compacted_seq = max(store._compacted_seq, before_seq)
    store._uid = max_uid
    last = store._events[-1].seq if store._events else store._compacted_seq
    store._seq = itertools.count(last + 1)
    outcome = "clean"
    if snapshots_skipped:
        outcome = "snapshot_fallback"
    elif stream.torn:
        outcome = "torn_tail"
    return {
        "outcome": outcome,
        "snapshot_seq": snapshot_seq,
        "snapshots_skipped": snapshots_skipped,
        "wal_records_replayed": stream.replayed,
        "torn_tail": stream.torn,
        "recovered_last_seq": last,
        "term": term,
    }


def _load_partitioned_state(
    wal_dir: str, pdirs: list[str], store: "ObjectStore"
) -> dict[str, Any]:
    """Partitioned recovery: per-partition snapshot selection (each with
    its own corruption fallback and quarantine), then ONE globally
    seq-ordered replay merged across the partition streams — so object
    installs, kind serials, uid tracking and compaction trims apply in
    the exact order the crashed store committed them, and the rebuilt
    store is bit-identical to what a single WAL of the same write
    history recovers."""
    # the layout marker is the completeness witness: PartitionedLog
    # always writes it at genesis, so a partitioned dir without a
    # readable one is DAMAGED — and recovering around a vanished pNNN
    # directory would hand back a silently holey store. Fail loud on
    # every shape (missing, unreadable, mismatched), like the rest of
    # the disaster-recovery path.
    layout = PartitionedLog._read_layout(os.path.join(wal_dir, LAYOUT_NAME))
    expected = layout.get("partitions")
    if expected != len(pdirs):
        raise DurabilityError(
            f"{wal_dir!r} layout marker says {expected} partitions "
            f"but {len(pdirs)} partition directories exist — a "
            "vanished partition directory is lost history; refusing "
            "to recover an incomplete partition set"
        )
    events: list = []
    snapshots_skipped = 0
    max_uid = store._uid
    # the layout marker is a term floor, not just bookkeeping: the
    # promotion checkpoint TRUNCATES the segment that held the term
    # record, so a post-promotion snapshot falling to corruption could
    # otherwise recover a pre-promotion term — the marker survives
    term = layout.get("term", 0)
    streams: list[tuple[str, _ReplayStream]] = []
    snapshot_seqs: dict[str, int] = {}
    for name in pdirs:
        pdir = os.path.join(wal_dir, name)
        state, skipped = _newest_valid_snapshot(pdir, os.listdir(pdir))
        snapshots_skipped += skipped
        snap_seq = 0
        if state is not None:
            snap_seq = state["last_seq"]
            term = max(term, state.get("term", 0))
            max_uid = max(max_uid, state["uid"])
            store._compacted_seq = max(
                store._compacted_seq, state["compacted_seq"]
            )
            # kind serials are a full store-wide copy at each cut: the
            # per-kind MAX across partition cuts is exact (every later
            # write to the kind lives in some partition's replay suffix)
            for kind, serial in state["kind_serial"].items():
                if serial > store._kind_serial.get(kind, 0):
                    store._kind_serial[kind] = serial
            for kind, bucket in state["objs"].items():
                # slices are disjoint across partitions (the layout
                # marker pins the mapping), so plain update is a merge
                store._objs.setdefault(kind, {}).update(bucket)
            events.extend(state["events"])
            if hasattr(store.clock, "_now"):
                store.clock._now = max(store.clock._now, state["clock"])
        streams.append((name, _ReplayStream(pdir, snap_seq, sparse=True)))
        snapshot_seqs[name] = snap_seq
    for kind, bucket in store._objs.items():
        for key, obj in bucket.items():
            store._index_add(kind, key, obj)

    def apply_event(ev) -> None:
        """_replay_event, partition-merge flavored: the retained event
        list is finalized by one global sort below, and kind serials
        max-merge — a kind written in two partitions can have its
        NEWEST write covered by one partition's snapshot while an older
        write replays from another."""
        key = (ev.namespace, ev.name)
        bucket = store._objs.setdefault(ev.kind, {})
        if ev.type == "Deleted":
            old = bucket.pop(key, None)
            if old is not None:
                store._index_remove(ev.kind, key, old)
        else:
            old = bucket.get(key)
            if old is not None:
                store._index_remove(ev.kind, key, old)
            bucket[key] = ev.obj
            store._index_add(ev.kind, key, ev.obj)
        if ev.seq > store._kind_serial.get(ev.kind, 0):
            store._kind_serial[ev.kind] = ev.seq
        events.append(ev)

    def keyed(idx: int, stream: _ReplayStream):
        for rec in stream.records():
            # events order by their seq; a compaction orders at the seq
            # position it was cut at (rec[1] = store.last_seq then),
            # AFTER any event carrying that seq
            yield ((rec[1], 0 if rec[0] == _REC_EVENT else 1, idx), rec)

    replayed = 0
    merged = heapq.merge(
        *(keyed(i, s) for i, (_n, s) in enumerate(streams)),
        key=lambda item: item[0],
    )
    for _key, rec in merged:
        if rec[0] == _REC_EVENT:
            stamp, ev = rec[2], rec[3]
            if len(rec) > 4:
                term = max(term, rec[4])
            apply_event(ev)
            replayed += 1
            if hasattr(store.clock, "_now"):
                store.clock._now = max(store.clock._now, stamp)
            if ev.type == "Added":
                m = _UID_RE.match(ev.obj.metadata.uid or "")
                if m:
                    max_uid = max(max_uid, int(m.group(1)) + 1)
        elif rec[0] == _REC_TERM:
            term = max(term, rec[2])
        elif rec[0] == _REC_COMPACT:
            # K journaled copies (one per partition) apply idempotently
            _, _lsn, before_seq = rec
            events[:] = [e for e in events if e.seq > before_seq]
            store._compacted_seq = max(store._compacted_seq, before_seq)
    events.sort(key=_EVENT_SEQ_KEY)
    store._events = events
    store._uid = max_uid
    last = events[-1].seq if events else store._compacted_seq
    store._seq = itertools.count(last + 1)
    torn = any(s.torn for _n, s in streams)
    outcome = "clean"
    if snapshots_skipped:
        outcome = "snapshot_fallback"
    elif torn:
        outcome = "torn_tail"
    return {
        "outcome": outcome,
        "snapshot_seq": max(snapshot_seqs.values(), default=0),
        "snapshots_skipped": snapshots_skipped,
        "wal_records_replayed": replayed,
        "torn_tail": torn,
        "recovered_last_seq": last,
        "term": term,
        "partitions": {
            name: {
                "snapshot_seq": snapshot_seqs[name],
                "wal_records_replayed": stream.replayed,
                "torn_tail": stream.torn,
            }
            for name, stream in streams
        },
    }


def read_only_state(wal_dir: str) -> tuple["ObjectStore", dict[str, Any]]:
    """Rebuild a durable directory's committed state into a SCRATCH
    store without attaching durability to it — a pure read: no
    checkpoint, no genesis segment, not one byte written under
    `wal_dir`. This is the federation coordinator's failover evidence
    path (federation/coordinator.py): after fencing a dead cluster it reads
    the committed gang set OUT of the fenced directory to drain into
    survivors, and the byte-unchanged directory is what proves the
    fence held. Returns (store, recovery stats) — the stats carry
    `recovered_last_seq`, so the caller can assert the drained set
    covers the full committed history (zero-loss accounting)."""
    from .clock import SimClock
    from .store import ObjectStore

    store = ObjectStore(SimClock())
    stats = load_durable_state(wal_dir, store)
    store.recovery_stats = stats
    return store, stats
