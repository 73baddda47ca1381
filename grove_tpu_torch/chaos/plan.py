"""Seeded, fully deterministic fault schedules.

The reference delegates fault tolerance to Kubernetes machinery (workqueue
rate limiters, `ERR_REQUEUE_AFTER` flow control) and its E2E suites fight
eventual consistency with `Eventually()` polling. This package's control
plane is deterministic, so infrastructure failure can be swept the same
way workload interleavings are: a `FaultPlan` is one seeded RNG plus a set
of per-fault rates, every fault decision is a draw from that RNG against
the single-threaded op sequence, and the whole chaotic run — every
transient write failure, conflict storm, stale read, delayed event batch,
forced compaction, manager crash, kubelet stall and clock jump — replays
bit-identically from the seed.

`FaultPlan.from_seed(seed)` derives a per-seed MIX: each rate is scaled by
an independent draw so different seeds emphasize different failure classes
(one seed is a conflict storm, another is mostly crash-restarts), which is
what makes a seed sweep a real search instead of the same storm repeated.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field


@dataclass
class FaultPlan:
    """One deterministic chaos schedule. Rates are probabilities per
    intercepted store op (write/read/event faults) or per driver step
    (manager crash, kubelet stall, clock jump, compaction). `counts`
    records every injected fault by type — the run's reproducible fault
    log, and the assertion hook for "chaos actually did something"."""

    seed: int = 0
    #: virtual seconds the driver advances per chaos step (lets backoff
    #: requeues fire WHILE faults are still arriving)
    step_seconds: float = 2.0
    #: driver steps in the chaos phase
    chaos_steps: int = 40

    # store-level faults (per intercepted op, operator-identity writes)
    write_fault_rate: float = 0.08
    conflict_burst_rate: float = 0.01
    conflict_burst_length: int = 4
    stale_read_rate: float = 0.05
    #: events newer than this many seqs behind the head may be hidden
    #: from a stale read (how far an informer cache can lag)
    stale_lag_events: int = 50
    event_delay_rate: float = 0.05
    #: how many events_since calls a delivery hold lasts
    event_delay_reads: int = 3

    # driver-level faults (per chaos step)
    manager_crash_rate: float = 0.05
    #: per-write probability that the manager dies right AFTER the write
    #: commits (the classic crash-between-write-and-ack window)
    midflight_crash_rate: float = 0.01
    kubelet_stall_rate: float = 0.1
    clock_jump_rate: float = 0.05
    clock_jump_max_seconds: float = 120.0
    compaction_rate: float = 0.05

    # node-lifecycle faults (per chaos step; the infrastructure axis the
    # store faults cannot model — see cluster/nodehealth.py):
    #   node_flap      — a node fails (NotReady + heartbeats stop) and
    #                    recovers within a few steps
    #   heartbeat_loss — a node's lease silently stops renewing until the
    #                    chaos phase disarms (partition/kubelet death)
    #   domain_outage  — a whole rack goes NotReady in one tick
    #   drain_storm    — a maintenance drain starts mid-churn (capped at
    #                    DRAIN_STORM_MAX nodes per run so the workload
    #                    always keeps enough capacity to converge)
    node_flap_rate: float = 0.04
    heartbeat_loss_rate: float = 0.03
    domain_outage_rate: float = 0.015
    drain_storm_rate: float = 0.015

    # multi-tenant load faults (per chaos step): tenant_skew applies a
    # burst of extra workload in one (seeded) tenant's namespace —
    # skewed offered load mid-chaos, the thing quota admission + DRF
    # fairness must absorb without starving anyone. Injected workload is
    # deleted at disarm so the convergence contract's fixpoint is
    # unchanged. DEFAULT 0: the runtime draw is guarded on rate > 0 (see
    # ChaosHarness), so every pre-existing seed's draw sequence — and
    # therefore its verified convergence — is bit-identical.
    tenant_skew_rate: float = 0.0
    #: gangs per injected skew burst
    tenant_skew_burst: int = 3

    # sharded-control-plane faults (per chaos step; meaningful only when
    # the harness runs controllers.shards > 1 — the driver skips them on
    # a single-replica manager). DEFAULT 0 with the runtime draws guarded
    # on rate > 0 (same contract as tenant_skew), so every pre-existing
    # seed's draw sequence — and its verified convergence — is
    # bit-identical.
    #   shard_crash     — one worker replica dies (stops stepping, stops
    #                     renewing); its shards must fail over to the
    #                     survivors within one shard-lease duration, and
    #                     the worker revives at disarm
    #   shard_map_stale — one worker's shard-map refresh freezes for a
    #                     few steps (the lagging-informer model): it may
    #                     keep serving its cached shards but must DEFER
    #                     once the view ages past one lease duration,
    #                     never fighting a handed-off successor
    #   handoff_storm   — every shard of one live worker is revoked via
    #                     two-phase pending moves, driving a wave of
    #                     release handoffs + relists through the normal
    #                     protocol mid-fault-storm
    shard_crash_rate: float = 0.0
    shard_map_stale_rate: float = 0.0
    handoff_storm_rate: float = 0.0

    # durable-store faults (per chaos step; meaningful only when the
    # harness runs with durability configured — skipped entirely
    # otherwise). DEFAULT 0 with runtime draws guarded on rate > 0 (the
    # tenant_skew/shard contract), so every pre-existing seed's draw
    # sequence — and its verified convergence — is bit-identical.
    #   process_crash       — the WHOLE control-plane process dies: the
    #                         live store is dropped and recovered from
    #                         disk (snapshot + WAL replay), coordination
    #                         leases expire, the manager/scheduler/
    #                         kubelet caches rebuild (Harness.cold_restart)
    #   wal_torn_write      — conditional on a process_crash: the crash
    #                         tears an in-flight WAL append off the tail
    #                         (recovery must stop cleanly at it)
    #   snapshot_corruption — conditional on a process_crash: the newest
    #                         snapshot is corrupted; recovery must fall
    #                         back to the previous retained one and
    #                         replay the longer WAL suffix
    #   disk_stall          — the WAL device stalls for a few steps:
    #                         snapshot cuts defer (appends buffer), so a
    #                         crash during the stall replays more WAL
    process_crash_rate: float = 0.0
    wal_torn_write_rate: float = 0.0
    snapshot_corruption_rate: float = 0.0
    disk_stall_rate: float = 0.0

    # partitioned-WAL faults (per chaos step; meaningful only when the
    # durable store runs config.durability.partitions > 1 — skipped
    # entirely otherwise, and DEFAULT 0 with runtime draws guarded on
    # rate > 0, so every pre-existing seed's draw sequence — and its
    # verified convergence — is bit-identical).
    #   partition_wal_divergence — the process crashes with ONE seeded
    #                              partition's WAL tail torn while the
    #                              other partitions keep their (possibly
    #                              later) committed records: recovery
    #                              must rewind only the unacknowledged
    #                              record and merge the diverged streams
    #                              back to a consistent store
    #   partition_disk_stall     — ONE seeded partition's disk stalls
    #                              for a few steps: its snapshot cuts
    #                              defer (its replay grows) while every
    #                              other partition keeps its cadence
    partition_divergence_rate: float = 0.0
    partition_stall_rate: float = 0.0

    # elastic-serving faults (per chaos step; meaningful only when the
    # harness runs with config.serving.enabled — skipped entirely
    # otherwise). DEFAULT 0 with runtime draws guarded on rate > 0 (the
    # tenant_skew/shard/durability contract), so every pre-existing
    # seed's draw sequence — and its verified convergence — is
    # bit-identical.
    #   traffic_spike   — a transient demand spike (seeded duration and
    #                     multiplier up to traffic_spike_multiplier)
    #                     lands on the traffic trace; the HPA sync loop
    #                     must absorb it (scale up, then stabilize back
    #                     down) — injected spikes are removed at disarm
    #                     so the recovered fixpoint matches fault-free
    #   metrics_dropout — the metrics pipeline drops every report for a
    #                     few steps (metrics-server outage): samples go
    #                     stale and the HPA must HOLD, never scale down
    #                     on missing metrics — cleared at disarm
    traffic_spike_rate: float = 0.0
    #: upper bound of the seeded spike multiplier draw (>= 1)
    traffic_spike_multiplier: float = 4.0
    metrics_dropout_rate: float = 0.0

    # continuous-defragmentation faults (per chaos step; meaningful only
    # when the harness runs config.defrag.enabled — skipped entirely
    # otherwise). DEFAULT 0 with runtime draws guarded on rate > 0 (the
    # tenant_skew/shard/durability/serving contract), so every
    # pre-existing seed's draw sequence — and its verified convergence —
    # is bit-identical.
    #   migration_storm      — a forced defrag sweep mid-storm with the
    #                          gain threshold relaxed to "any strict
    #                          improvement": a wave of admitted moves
    #                          (stage + evict) lands between faulted
    #                          manager rounds, under full budget/rate
    #                          arming and the budget audit
    #   migration_crash      — conditional on a storm: the manager
    #                          crash-restarts right after the sweep —
    #                          migration tickets are soft state and die
    #                          with it, and the evicted gangs must still
    #                          re-place through the general solve (the
    #                          make-before-break fallback contract)
    #   migration_node_fault — conditional on a storm: one of the
    #                          sweep's held DESTINATION nodes fails
    #                          before the re-bind; the ticket trial must
    #                          skip the dead node and the gang re-places
    #                          elsewhere (its own vacated capacity at
    #                          worst)
    migration_storm_rate: float = 0.0
    migration_crash_rate: float = 0.0
    migration_node_fault_rate: float = 0.0

    # HA-replication faults (per chaos step; meaningful only when the
    # harness runs config.replication.enabled — skipped entirely
    # otherwise). DEFAULT 0 with runtime draws guarded on rate > 0 (the
    # standing contract), so every pre-existing seed's draw sequence —
    # and its verified convergence — is bit-identical.
    #   replication_stall — the standby's tailing stalls for a few
    #                       steps (network partition / slow standby):
    #                       lag grows, semi-sync degrades to async for
    #                       the window, and the standby must catch up
    #                       at stall end — or RE-SEED if the leader's
    #                       retention outran it
    #   standby_promotion — the leader process dies mid-plan and the
    #                       control plane fails over to the standby
    #                       (promote + manager rebuild + kubelet
    #                       relist); a fresh standby re-arms HA for the
    #                       promoted leader so later draws keep firing
    #   dual_leader       — a spurious promotion while the old leader
    #                       is still live: the fault PROVES the fence —
    #                       the deposed log's next append must raise
    #                       FencedAppend and its directory must be
    #                       byte-unchanged, else the seed fails loudly
    #   standby_crash     — the standby process dies; a replacement
    #                       re-seeds from the leader's snapshots into a
    #                       fresh journal generation and resumes tailing
    replication_stall_rate: float = 0.0
    standby_promotion_rate: float = 0.0
    dual_leader_rate: float = 0.0
    standby_crash_rate: float = 0.0

    # -- federation faults (chaos/federation.py; multi-cluster runs only).
    # All default 0.0 and every draw is guarded (`rate > 0 and flip(...)`),
    # so single-cluster plans — and therefore every pre-existing seed's
    # draw sequence and verified convergence — are bit-identical. None of
    # these join the from_seed mix tuple for the same reason.
    #   cluster_outage     — one member cluster's heartbeats stop for
    #                        good: the monitor must declare it, the
    #                        coordinator must fence it (directory
    #                        byte-unchanged, zombie appends refuse) and
    #                        drain its whole committed gang set into
    #                        survivors within the declared window
    #   cluster_partition  — heartbeats suppressed for a few steps, then
    #                        healed: a short blip must NOT trigger
    #                        failover; one that outlives the window is a
    #                        real outage and the healed member comes back
    #                        as a fenced zombie, proving the fence
    #   coordinator_crash  — the global layer loses every in-memory
    #                        routing structure and must rebuild them from
    #                        its durable journal alone
    cluster_outage_rate: float = 0.0
    cluster_partition_rate: float = 0.0
    coordinator_crash_rate: float = 0.0

    # streaming-admission faults (per chaos step; meaningful only when
    # the harness runs config.stream.enabled — skipped entirely
    # otherwise). DEFAULT 0 with runtime draws guarded on rate > 0 (the
    # standing contract), so every pre-existing seed's draw sequence —
    # and its verified convergence — is bit-identical. Not in the
    # from_seed mix tuple for the same reason.
    #   burst_storm   — a ~10x Poisson burst of gangs lands in one step:
    #                   the streaming front must shed with structured
    #                   DeadlineExceeded rather than wedge, and once the
    #                   storm workload is deleted at disarm the run must
    #                   converge back to the fault-free fixpoint
    #   arrival_stall — admission stalls for a few steps (the front holds
    #                   every waiter); budgets keep burning, so the stall
    #                   ends in either a clean batched admit or a
    #                   deadline shed — never a wedged queue
    burst_storm_rate: float = 0.0
    #: multiplier on the plan's step-sized arrival expectation — how many
    #: gangs one injected storm creates (the "10x" in a 10x burst)
    burst_storm_gangs: int = 20
    arrival_stall_rate: float = 0.0
    #: how many chaos steps one injected stall holds admission
    arrival_stall_steps: int = 3

    counts: dict[str, int] = field(default_factory=dict)

    def __post_init__(self) -> None:
        self.rng = random.Random(self.seed)

    @classmethod
    def from_seed(cls, seed: int, **overrides) -> "FaultPlan":
        """Derive a per-seed fault mix: every rate scaled by an
        independent draw in [0.25, 1.75] from a dedicated mix RNG (so the
        runtime draw sequence stays aligned across plans regardless of the
        mix). Explicit keyword overrides win."""
        # a str seed hashes via sha512 (process-independent); a tuple
        # would go through hash() and PYTHONHASHSEED-randomize
        mix = random.Random(f"grove-chaos-mix-{seed}")
        scaled = {
            name: getattr(cls, "__dataclass_fields__")[name].default
            * (0.25 + 1.5 * mix.random())
            # NOTE: names appended at the END only — the mix draws run in
            # tuple order, so appending keeps every pre-existing seed's
            # rates (and therefore its verified convergence) unchanged
            for name in (
                "write_fault_rate", "conflict_burst_rate",
                "stale_read_rate", "event_delay_rate",
                "manager_crash_rate", "midflight_crash_rate",
                "kubelet_stall_rate", "clock_jump_rate", "compaction_rate",
                "node_flap_rate", "heartbeat_loss_rate",
                "domain_outage_rate", "drain_storm_rate",
            )
        }
        scaled.update(overrides)
        return cls(seed=seed, **scaled)

    # -- decision draws ----------------------------------------------------
    def flip(self, rate: float) -> bool:
        return self.rng.random() < rate

    def uniform(self, lo: float, hi: float) -> float:
        return lo + (hi - lo) * self.rng.random()

    def pick(self, n: int) -> int:
        """Deterministic index draw in [0, n) (fault-target selection)."""
        return self.rng.randrange(n)

    def record(self, fault_type: str) -> int:
        """Count an injected fault; returns the new per-type count."""
        n = self.counts.get(fault_type, 0) + 1
        self.counts[fault_type] = n
        return n

    @property
    def total_injected(self) -> int:
        return sum(self.counts.values())
