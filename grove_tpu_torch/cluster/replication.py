"""HA object store: a log-shipping standby with lease-fenced promotion.

The reference leans on etcd for control-plane storage availability (the
API server is the bus — SURVEY §2c; Grove itself never solves it).
This package owns its store, so it owns the HA story too: the durable
store survives crashes via WAL recovery over a partitioned write path,
but a leader loss alone would mean a full cold restart from disk — an
outage window proportional to history length. This module adds a
SECOND ObjectStore instance that
continuously tails the leader's WAL stream and is promotable in
seconds, losing zero committed writes in semi-sync mode.

Replication IS replay. The standby rides the exact recovery machinery:
it bootstraps through `load_durable_state` (newest valid snapshot + WAL
replay), then follows the live stream with one `WalTailer` per
partition, heap-merged by global seq — the same merge discipline
`_load_partitioned_state` uses, so a record stream that recovers
bit-identically also replicates bit-identically (the promotion-
equivalence gate in tests/test_replication.py pins this for 10 seeds,
and tests/test_torch_replication.py holds this copy to it in lockstep).

Ack modes (`ReplicationConfig.ack_mode`):

  async      The leader's commit never waits. The standby applies on
             its poll cadence (the harness/chaos/bench drivers poll per
             step), and the leader forces a synchronous catch-up only
             when the lag would exceed `max_lag_{records,seconds}` —
             classic bounded-lag asynchronous replication. A failover
             that loses the leader's disk loses at most the lag window.

  semi-sync  A commit completes only once the standby has applied the
             record AND durably appended it to its OWN journal — the
             zero-loss mode (`bench.py --replication` measures both the
             commit-throughput tax and the zero-loss failover). A
             stalled standby degrades to async for the stall window
             (the MySQL-semisync timeout posture) and catches up at
             stall end.

Promotion is lease-fenced and term-fenced:

  * `Harness.promote_standby()` first checks the LEASE machinery (the sharded plane's)
    against the standby's applied state: any fresh coordination lease —
    the leader-election lease, shard worker/coordinator leases — means
    the leader plane is still renewing, and promotion refuses
    (PromotionRefused, `grove_store_promotions_total{outcome=
    "fence-refused"}`). Node heartbeat leases are kubelet-owned
    infrastructure and don't count.
  * `StandbyReplica.promote()` then seals the applied prefix behind a
    fresh checkpoint in the standby's own wal_dir, bumps the leadership
    TERM (journaled as its own record, stamped into every subsequent
    WAL record, and pinned into the partitioned layout marker), and
    raises the shared `ReplicationLink` term — which DEPOSES the old
    leader: any append it still attempts fails `FencedAppend` before a
    byte moves (the dual-leader chaos fault proves a stale leader can
    never diverge the history).

The standby's own journal (`ReplicationConfig.standby_wal_dir`, one
`gen-NNNN` subdirectory per standby generation) holds a bootstrap
snapshot plus every applied record, so a promoted store serves durably
from its first write and a re-seeded standby (crash, or a tailer that
fell behind the leader's retention window — ReplicaGap) simply starts
the next generation.

The counterpart of grove_tpu/cluster/replication.py. It runs on the host
alone: the standby is a store of plain objects, and promotion hands the
harness a store from which it rebuilds its managers and their engines.
"""

from __future__ import annotations

import dataclasses
import heapq
import os
import time
from typing import Any

from .clock import SimClock
from .durability import (
    _REC_COMPACT,
    _REC_EVENT,
    _REC_TERM,
    _UID_RE,
    DurableLog,
    PartitionedLog,
    ReplicaGap,
    WalTailer,
    _replay_event,
    load_durable_state,
)
from .store import ObjectStore


def next_generation(standby_root: str) -> int:
    """First unused gen-NNNN index under the standby root. Scanning the
    directory (instead of counting in memory) keeps every path safe: a
    re-booted process, a promoted cluster re-arming HA (whose ACTIVE
    journal still lives in an earlier generation of the same root), and
    an in-place re-seed all land on a fresh directory."""
    try:
        names = os.listdir(standby_root)
    except FileNotFoundError:
        return 0
    gens = [
        int(n[4:]) for n in names if n.startswith("gen-") and n[4:].isdigit()
    ]
    return max(gens) + 1 if gens else 0


class PromotionRefused(Exception):
    """Promotion blocked by the lease fence: the leader plane still
    holds a fresh coordination lease in the standby's applied state —
    promoting now would open a dual-leader window on purpose. Wait out
    the lease (the leader is alive, or just died and the lease has not
    expired yet) or pass force=True when the operator knows better."""


class ReplicationLink:
    """The replication channel's shared fencing state: the fleet's
    current leadership term. Promotion raises it; every leader-side
    append checks it (DurableLog.check_fence) — the simulation's stand-in
    for the channel-level refusal a real standby gives a lower-term
    shipper, and for the epoch check a fencing-aware WAL store performs
    per append."""

    def __init__(self, term: int = 0):
        self.term = term


def fence_deposed(log, link: ReplicationLink) -> int:
    """Depose a leader WITHOUT promoting a standby — the federation
    coordinator's fence primitive for a whole-cluster outage
    (federation/). Raising the shared link term above the
    (possibly still running) cluster's own log term makes every
    subsequent append from that control plane fail `FencedAppend`
    before a byte moves (DurableLog.check_fence): a zombie cluster
    returning from a partition may keep computing, but it can never
    again extend its durable history — so it can never double-place a
    gang the survivors adopted. The fenced directory is left
    byte-untouched, which is exactly what lets the coordinator read
    the committed set out of it as failover evidence
    (durability.read_only_state). Returns the fencing term."""
    new_term = max(link.term, log.term) + 1
    link.term = new_term
    return new_term


#: the standby gauges this module owns; labeled by standby generation
#: and reconciled away on promotion/re-seed (the shard and partition
#: series-hygiene pattern) so a dead standby's series never linger on /metrics
STANDBY_GAUGES = (
    "grove_store_replication_lag_records",
    "grove_store_replication_lag_seconds",
    "grove_store_standby_applied_seq",
)


class StandbyReplica:
    """One log-shipping standby: a second ObjectStore built from the
    leader's durable directory and kept behind it by at most the
    configured lag, plus its own durable journal, promotable via
    `promote()` (drive it through Harness.promote_standby, which also
    re-points the control plane)."""

    def __init__(self, config, leader_log, leader_store: ObjectStore,
                 link: ReplicationLink, metrics=None, generation: int = 0):
        """config: the full OperatorConfig (replication + durability
        blocks validated); leader_log: the leader's DurableLog or
        PartitionedLog facade; leader_store: read-only handle for lag
        accounting (last_seq + clock); link: the shared fencing state."""
        self.config = config
        self.leader_log = leader_log
        self.leader_store = leader_store
        self.link = link
        self.metrics = metrics
        self.generation = generation
        self.gen_label = f"gen-{generation:04d}"
        self.ack_mode = config.replication.ack_mode
        #: chaos replication_stall state: while > 0 every poll no-ops
        #: (semi-sync degrades to async for the window) — ticked down
        #: once per chaos step, cleared at disarm and at promotion
        self.stall_steps = 0
        self.promoted = False
        #: lifetime counters (debug_state / tests)
        self.records_applied_total = 0
        self.polls_total = 0
        self.forced_catchups_total = 0
        self.degraded_ships_total = 0
        #: wall seconds spent applying + re-journaling (the replication
        #: half of the semi-sync commit tax; the leader-side half is the
        #: per-commit poll plumbing itself)
        self.ship_seconds = 0.0
        self._bootstrap()

    # -- bootstrap -----------------------------------------------------------
    def _gen_dir(self) -> str:
        return os.path.join(
            self.config.replication.standby_wal_dir, self.gen_label
        )

    def _bootstrap(self) -> None:
        """Seed the standby through the RECOVERY implementation: newest
        valid snapshot + full WAL replay of the leader's directory, then
        cut the bootstrap checkpoint into this generation's own journal
        and anchor one tailer per leader partition at the recovered
        position."""
        self.store = ObjectStore(SimClock())
        stats = load_durable_state(self.leader_log.dir, self.store)
        self.applied_seq = stats["recovered_last_seq"]
        self._last_applied_stamp = self.store.clock.now()
        du = dataclasses.replace(
            self.config.durability, wal_dir=self._gen_dir()
        )
        if du.partitions > 1:
            self.log = PartitionedLog(
                du, clock=self.store.clock, metrics=None
            )
        else:
            self.log = DurableLog(du, clock=self.store.clock, metrics=None)
        self.log.term = stats.get("term", 0)
        self.log.link = self.link
        self.log.checkpoint(self.store)
        # this journal's history starts AT the bootstrap image — drop
        # the empty genesis segment so nothing mistakes it for a chain
        # covering seq 0 (see DurableLog.seal_bootstrap)
        self.log.seal_bootstrap()
        if getattr(self.leader_log, "num_partitions", 1) > 1:
            self.tailers = [
                WalTailer(
                    os.path.join(self.leader_log.dir, f"p{i:03d}"),
                    applied_seq=self.applied_seq,
                )
                for i in range(self.leader_log.num_partitions)
            ]
        else:
            self.tailers = [
                WalTailer(self.leader_log.dir, applied_seq=self.applied_seq)
            ]
        self._export_gauges()

    # -- the ship hook (leader commit path) -----------------------------------
    def on_leader_commit(self, store, event) -> None:
        """Installed as the leader log's post_commit hook. semi-sync:
        apply + durably append THIS record before the commit returns
        (unless stalled — the degrade window). async: fire-and-forget
        until the lag bounds would be exceeded, then force a catch-up
        (bounded-lag backpressure)."""
        if self.stall_steps > 0:
            self.degraded_ships_total += 1
            return
        if self.ack_mode == "semi-sync":
            self.poll()
            return
        lag_records = store.last_seq - self.applied_seq
        rp = self.config.replication
        if (
            lag_records > rp.max_lag_records
            or store.clock.now() - self._last_applied_stamp
            > rp.max_lag_seconds
        ):
            self.forced_catchups_total += 1
            self.poll()

    # -- tailing ---------------------------------------------------------------
    def _merged_records(self):
        """This poll's new records across every partition tailer, in
        global seq order — the same (seq, type-order) merge key the
        partitioned recovery uses, so replication and recovery apply one
        ordering."""
        if len(self.tailers) == 1:
            yield from self.tailers[0].poll()
            return

        def keyed(idx: int, tailer: WalTailer):
            for rec in tailer.poll():
                yield ((rec[1], 0 if rec[0] == _REC_EVENT else 1, idx),
                       rec)

        merged = heapq.merge(
            *(keyed(i, t) for i, t in enumerate(self.tailers)),
            key=lambda item: item[0],
        )
        for _key, rec in merged:
            yield rec

    def poll(self) -> int:
        """Apply every record the leader has flushed since the last
        poll: install into the standby store (the recovery replay
        discipline), mirror the leader clock stamp, and durably append
        to the standby's own journal. Returns records applied. A tailer
        that fell behind the retention window re-seeds this replica in
        place (fresh generation) and reports the full re-seed as one
        catch-up."""
        if self.stall_steps > 0 or self.promoted:
            return 0
        t0 = time.perf_counter()
        self.polls_total += 1
        applied = 0
        try:
            for rec in self._merged_records():
                self._apply(rec)
                applied += 1
        except ReplicaGap:
            self._reseed()
            applied += 1  # the re-seed consumed the backlog wholesale
        self.ship_seconds += time.perf_counter() - t0
        self._export_gauges()
        return applied

    def _apply(self, rec: tuple) -> None:
        store = self.store
        if rec[0] == _REC_EVENT:
            stamp, ev = rec[2], rec[3]
            if len(rec) > 4 and rec[4] > self.log.term:
                self.log.term = rec[4]
            _replay_event(store, ev)
            store.clock._now = max(store.clock._now, stamp)
            self._last_applied_stamp = stamp
            if ev.type == "Added":
                m = _UID_RE.match(ev.obj.metadata.uid or "")
                if m:
                    store._uid = max(store._uid, int(m.group(1)) + 1)
            self.applied_seq = ev.seq
            self.records_applied_total += 1
            self.log.commit(store, ev)
        elif rec[0] == _REC_COMPACT:
            before_seq = rec[2]
            if before_seq > store._compacted_seq:
                store._events = [
                    e for e in store._events if e.seq > before_seq
                ]
                store._compacted_seq = before_seq
                self.log.log_compaction(store, before_seq)
        elif rec[0] == _REC_TERM:
            if rec[2] > self.log.term:
                self.log.term = rec[2]

    def _reseed(self) -> None:
        """The tailer lost the stream (leader retention outran a stalled
        standby): throw the generation away and bootstrap a fresh one
        from the leader's snapshots — the operational re-seed, counted
        and metric-reconciled like a standby replacement."""
        self.remove_metric_series()
        self.log.close()
        self.generation = next_generation(
            self.config.replication.standby_wal_dir
        )
        self.gen_label = f"gen-{self.generation:04d}"
        self._bootstrap()

    def tick_stall(self) -> None:
        if self.stall_steps > 0:
            self.stall_steps -= 1

    # -- lag accounting ---------------------------------------------------------
    def lag_records(self) -> int:
        return max(0, self.leader_store.last_seq - self.applied_seq)

    def lag_seconds(self) -> float:
        if self.lag_records() == 0:
            return 0.0
        return max(
            0.0, self.leader_store.clock.now() - self._last_applied_stamp
        )

    def _export_gauges(self) -> None:
        if self.metrics is None:
            return
        labels = {"standby": self.gen_label}
        self.metrics.gauge(
            "grove_store_replication_lag_records",
            "committed records the standby has not applied yet",
        ).set(float(self.lag_records()), **labels)
        self.metrics.gauge(
            "grove_store_replication_lag_seconds",
            "leader-clock seconds behind the last applied record",
        ).set(self.lag_seconds(), **labels)
        self.metrics.gauge(
            "grove_store_standby_applied_seq",
            "last store seq the standby has applied",
        ).set(float(self.applied_seq), **labels)

    def remove_metric_series(self) -> None:
        """Series hygiene (the Gauge.label_sets/remove pattern):
        a promoted or replaced standby's gauges must leave /metrics —
        stale lag series from a dead generation would read as a standby
        that silently stopped catching up."""
        if self.metrics is None:
            return
        for family in STANDBY_GAUGES:
            metric = self.metrics.get(family)
            if metric is None:
                continue
            for labels in metric.label_sets():
                if labels.get("standby") == self.gen_label:
                    metric.remove(**labels)

    # -- promotion ----------------------------------------------------------------
    def leader_lease_blocks(self, now: float) -> str | None:
        """The lease fence, evaluated on the standby's APPLIED state: a
        fresh coordination lease — leader election, shard workers, the
        shard coordinator — means the leader plane was still renewing as
        of the replicated history, and promotion must wait it out. Node
        heartbeat leases are kubelet infrastructure and never block.
        Returns the blocking reason, or None when promotion may
        proceed."""
        from ..controller.leaderelection import Lease, lease_fresh
        from .nodehealth import NODE_LEASE_NAMESPACE

        for lease in self.store.scan(Lease.KIND):
            if lease.metadata.namespace == NODE_LEASE_NAMESPACE:
                continue
            if lease_fresh(lease, now):
                return (
                    f"lease {lease.metadata.namespace}/"
                    f"{lease.metadata.name} held by "
                    f"{lease.holder_identity!r} is still fresh "
                    f"(renewed {now - lease.renew_time:.1f}s ago, "
                    f"duration {lease.lease_duration_seconds:.0f}s)"
                )
        return None

    def promote(self, catch_up: bool = True) -> dict[str, Any]:
        """Seal and fence: final catch-up (catch_up=False models total
        leader loss — host AND disk — where only the applied prefix
        survives), bump the leadership term into this journal, raise the
        shared link term (deposing the old leader), and checkpoint the
        applied prefix behind a fresh snapshot generation. Returns the
        promotion stats; the caller re-points the control plane
        (Cluster.promote_standby / Harness.promote_standby)."""
        self.stall_steps = 0
        lag_before = self.lag_records()
        if catch_up:
            self.poll()
        lost = self.lag_records()
        new_term = max(self.link.term, self.log.term) + 1
        # journal the term BEFORE raising the link: the bump record must
        # append under the old link term or it would fence itself
        self.log.bump_term(new_term)
        self.link.term = new_term
        self.log.checkpoint(self.store)
        self.promoted = True
        return {
            "outcome": "promoted",
            "term": new_term,
            "applied_seq": self.applied_seq,
            "lag_records_at_failure": lag_before,
            "lost_records": lost,
            "caught_up": bool(catch_up),
            "standby_wal_dir": self._gen_dir(),
        }

    # -- introspection ---------------------------------------------------------------
    def debug_state(self) -> dict[str, Any]:
        return {
            "generation": self.gen_label,
            "ack_mode": self.ack_mode,
            "applied_seq": self.applied_seq,
            "lag_records": self.lag_records(),
            "lag_seconds": round(self.lag_seconds(), 3),
            "term": self.log.term,
            "link_term": self.link.term,
            "stall_steps": self.stall_steps,
            "promoted": self.promoted,
            "records_applied_total": self.records_applied_total,
            "polls_total": self.polls_total,
            "forced_catchups_total": self.forced_catchups_total,
            "degraded_ships_total": self.degraded_ships_total,
            "ship_seconds": round(self.ship_seconds, 4),
            "standby_wal_dir": self._gen_dir(),
            "journal": self.log.debug_state(),
        }
