"""Versioned operator configuration.

The reference drives the whole operator from one validated, versioned
`OperatorConfiguration` YAML (client QPS, per-controller concurrency,
servers, logging, authorizer, topology-aware scheduling —
operator/api/config/v1alpha1/types.go:57-202, decoded through the k8s
scheme machinery in cmd/cli/cli.go:89-106 and validated in
api/config/validation/validation.go). This package mirrors that contract:
every knob the framework tunes lives here — nothing is a hard-coded
constant in a controller — and configs load from plain dicts (the YAML
decode analog) with strict unknown-field rejection and aggregated
validation errors.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

from .validation import ValidationError

API_VERSION = "config.grove.io/v1alpha1"
KIND = "OperatorConfiguration"

_LOG_LEVELS = ("debug", "info", "error")
_LOG_FORMATS = ("text", "json")
_DURABILITY_FSYNC = ("commit", "snapshot", "never")


@dataclass
class WorkloadDefaultsConfig:
    """Defaulting-webhook tunables (defaulting/podcliqueset.go:30-117)."""

    termination_delay_seconds: float = 4 * 60 * 60.0
    replicas: int = 1


@dataclass
class ControllerConfig:
    """Reconcile-loop tuning — the ConcurrentSyncs/flow-control analog
    (types.go:151-174). The deterministic manager has no thread pool, so
    concurrency maps to round budgets + retry pacing."""

    sync_retry_interval_seconds: float = 5.0
    settle_max_rounds: int = 256
    harness_max_rounds: int = 64
    # Error-retry flow control (replaces the old fixed error interval):
    # a failing (controller, request) requeues on exponential backoff with
    # deterministic jitter; when one request burns through its retry
    # budget, the controller's circuit breaker opens and its work parks
    # for a cool-down of error_backoff_max_seconds (degraded state) before
    # a half-open probe.
    error_backoff_base_seconds: float = 1.0
    error_backoff_max_seconds: float = 60.0
    error_retry_budget: int = 8
    # Node lifecycle controller (heartbeat-driven NotReady, eviction
    # sweeps, gang-aware drain). Disable for pure placement benchmarks
    # that want zero per-node control-plane overhead.
    node_monitor_enabled: bool = True
    # Horizontally sharded control plane (controller/sharding.py): 1 = the
    # classic single ControllerManager; N > 1 runs N worker replicas, each
    # a full manager + reconciler set over the same store, with reconcile
    # keys partitioned across them by consistent hashing and ownership
    # published through a leader-owned ShardMap + per-worker Leases. A
    # crashed worker's shards hand off to survivors after its lease
    # expires (orphaned-lease detection), bounding failover by one lease
    # duration.
    shards: int = 1
    # Worker heartbeat-lease lifetime: the leader declares a worker dead —
    # and force-reassigns its shards — once its lease lags the virtual
    # clock by more than this. The failover-recovery bound.
    shard_lease_duration_seconds: float = 10.0
    # Per-round write batching (controller/concurrency.WriteBatch): defer
    # coalescable status/event writes to one end-of-round flush through
    # the slow-start batcher, cutting per-object write overhead on the
    # settle hot path. Off = every write lands inline (pre-sharding
    # behavior), kept for A/B benches.
    round_write_batching: bool = True


@dataclass
class ClusterConfig:
    """Node-lifecycle tuning — the kube-controller-manager node-lifecycle
    flag set (--node-monitor-grace-period / --pod-eviction-timeout) plus
    the kubelet's nodeLeaseDurationSeconds, re-homed onto the simulated
    cluster. Consumed by SimKubelet (lease renewal) and the NodeMonitor
    (NotReady detection, eviction grace, flap damping)."""

    # Heartbeat lease lifetime: a node whose lease lags the freshest
    # cluster heartbeat by more than this goes NotReady.
    node_lease_duration_seconds: float = 40.0
    # NotReady -> pod sweep grace: pods on a NotReady node are only marked
    # Failed (and replaced elsewhere) after this long, so a flapping node
    # never causes evictions.
    pod_eviction_grace_seconds: float = 300.0
    # A recovered node must renew continuously for this long before it
    # re-enters the scheduler's candidate set (flap damping). Keep it
    # above node_lease_duration_seconds: the Ready flip requires a lease
    # renewed within the lease duration of *now*, so a dead node can
    # never ride a stale-but-recent lease back to Ready.
    node_stable_ready_seconds: float = 60.0


@dataclass
class SolverConfig:
    """Placement-engine tuning (the part the reference delegates to KAI)."""

    top_k: int = 8                 # exact-repair candidates per gang
    commit_chunk: int = 32         # gangs per commit-scan step
    gang_bucket_minimum: int = 8   # smallest padded backlog bucket
    native_repair: bool = True     # use the C++ exact-commit path
    # Priority preemption (the reclaim the reference outsources to KAI):
    # capacity-starved higher-priority gangs may evict lower-priority
    # SCALED gangs (never base gangs) and re-solve.
    preemption_enabled: bool = True
    # Device-resident cluster state (solver/engine.py): the free-capacity
    # matrix lives on the accelerator across solves behind an epoch
    # counter; warm solves ship row deltas (or nothing) instead of the
    # full [N, R] re-encode, and dispatch-adoption staleness becomes an
    # O(1) epoch compare. Off = the pre-delta behavior (full re-encode
    # per solve + content-compare guard), kept for A/B benches and the
    # CI equivalence smoke.
    device_state_cache: bool = True
    # Debug assert: re-run the O(N*R) content compare next to every epoch
    # decision and raise on disagreement (a note_free_rows superset-
    # contract breach). Costs exactly the compare the cache exists to
    # avoid — tests and chaos sweeps only.
    device_state_verify: bool = False
    # Fused single-dispatch solve (solver/engine.py): the staged
    # free-state delta, gang inputs and signature tables ride ONE io
    # buffer into ONE device program launch (delta apply -> score ->
    # commit scan, free buffer donated off-CPU), so a warm solve is one
    # small H2D + one launch + one D2H. Off = the split (pre-PR7)
    # dispatch discipline, kept for A/B benches (`bench.py --engine`).
    fused_solve: bool = True
    # Incremental dirty-row re-solve: the fused program's value matrix
    # and per-gang demand stay device-resident; while the free-state
    # epoch is unchanged, a re-solve re-scores only DIRTY gangs
    # (new/changed content fingerprints) against the resident state and
    # a fully-unchanged backlog reuses the previous packed results with
    # zero dispatches. Falls back to the full fused solve on epoch
    # divergence, rebind, engine rebuild, or unknown-scope free
    # declarations (e.g. journal compaction-horizon rebuilds). Requires
    # fused_solve AND device_state_cache — the engine degrades to the
    # full fused path when either is off.
    incremental_resolve: bool = True
    # Gang-level reservation reuse (scheduler pre-pass, podgang.go:66-72):
    # a gang naming a predecessor in reuse_reservation_ref is trial-placed
    # onto that predecessor's remembered nodes before general search —
    # near-free, topology-stable scale-up/rebuild re-placement. Off = the
    # pre-pass is skipped wholesale (every gang takes the general solve),
    # kept for the diurnal bench's reuse-on/off A/B.
    reservation_reuse: bool = True
    # Hierarchical two-level solve (solver/hierarchy.py): a coarse
    # domain-level pass over prune-level domains as super-nodes
    # (aggregated free capacity, admissible by construction — aggregation
    # may only over-admit, never cut a domain the flat solve would place
    # into) assigns each gang its surviving domains, then exact
    # node-level solves run only inside survivors through per-domain
    # sub-engines — which keep their own device-resident state and
    # incremental caches, so incrementality is SHARD-LOCAL and composes
    # with the mesh-sharded engine. Falls back to the flat solve when the
    # backlog is not confined (any gang's required pack level is broader
    # than the prune level), the cluster is below
    # hierarchical_min_nodes, or the prune level has fewer than two
    # domains (docs/scheduling.md "Hierarchical solve").
    hierarchical_solve: bool = True
    # Prune level of the coarse pass: a topology level INDEX
    # (broadest = 0). None = auto — the broadest level every backlog
    # gang is confined to (the minimum required pack level across the
    # backlog). A configured level narrower than some gang's required
    # level is clamped down to keep confinement sound.
    hierarchical_prune_level: int | None = None
    # Forced-flat threshold: below this many nodes the flat cost tensor
    # is small enough that the two-level restructure only adds overhead
    # — the solve runs flat. 0 forces the hierarchy on any cluster
    # (tests, chaos smokes).
    hierarchical_min_nodes: int = 4096
    # Wave parallelism of the hierarchical fine phase (solver/engine.py
    # _run_wave): within one attempt wave, every surviving domain's
    # dispatch half (host encode + staged-delta sync + device launch)
    # runs through a bounded thread pool and ALL launches are enqueued
    # before any result is awaited — domain A's host repair overlaps
    # domain B's device compute, and the mesh engine's round-robined
    # devices run concurrently. Collection and free-row commits stay in
    # deterministic domain order, so placements are BIT-equal to the
    # serial path (gated by bench.py --equivalence's wave scenario).
    # None = auto (host core count, widened to the mesh's local device
    # fan-out on sharded engines); 0 = the serial one-domain-at-a-time
    # fine phase.
    hier_parallel_workers: int | None = None
    # The hand-kernel tier of the scoring core (solver/kernel_core.py),
    # under the reference's knob names. pallas_core: the [G, D] value
    # tensor from the value kernel. None = auto: always on CUDA (False
    # raises there: nothing on the card runs a plain version), off on
    # the CPU; True on the CPU runs the kernels' plain versions.
    pallas_core: bool | None = None
    # On-device greedy commit over the packed top-k: the D2H ships one
    # committed (value, domain) pair per gang instead of the [G, 2K]
    # candidate list, and host repair does conflict-only work
    # (aggregate-infeasible candidates are provably exact-infeasible, so
    # the skip is sound; node-granularity conflicts still fall to the
    # serial exactness net). None = auto: on with CUDA, off on the CPU.
    device_commit: bool | None = None
    # Score accumulation dtype of the value kernel: "fp32" is bit-equal
    # to the plain version; "bf16" accumulates the slack/value arithmetic
    # in bfloat16 — coarser quanta that may merge near-ties WITHIN a
    # level band (cross-level ordering is preserved), held to the tie
    # policy, not to bits.
    pallas_precision: str = "fp32"


#: built-in priority-tier ladder seeded as PriorityClass objects when
#: tenancy is enabled (highest first; `value` feeds the scheduler's
#: backlog ordering and preemption exactly like any PriorityClass)
DEFAULT_TENANCY_TIERS = (
    {"name": "system", "value": 10000.0},
    {"name": "high", "value": 1000.0},
    {"name": "standard", "value": 100.0},
    {"name": "low", "value": 0.0},
)


@dataclass
class TenancyConfig:
    """Multi-tenant scheduling (tenancy/): hierarchical tenant
    queues with guaranteed/burst quota per resource, dominant-resource
    fairness weighted into the solver's cost tensor, priority tiers, and
    admission control that sheds over-quota gangs with a structured
    `UnsatCode.QuotaExceeded` instead of queueing them silently.

    The reference delegates all of this to the external KAI scheduler
    (its e2e applies queues.yaml; PodGang merely carries
    PriorityClassName — SURVEY §4); grove_tpu owns the scheduler, so it
    owns tenant arbitration.

    `tenants` entries are mappings (like topology_aware_scheduling.levels):
      name               tenant id; gangs map to it by the grove.io/tenant
                         label or by namespace == name
      guaranteed         {resource: amount} always-admitted quota
                         (absent resource = 0: anything is burst)
      burst              {resource: amount} hard ceiling; admission sheds
                         above it (absent resource = unlimited)
      weight             DRF weight (> 0, default 1.0)
      tier               priority tier name (default `default_tier`)
      parent             parent queue name ("" = top level); ancestors'
                         quota applies to every descendant's admission
      disruption_budget  max gangs of this tenant evictable per
                         preemption round (absent = unbounded)
    """

    enabled: bool = False
    #: PodGang/PodCliqueSet label naming the owning tenant; namespace ==
    #: tenant name is the fallback attribution
    tenant_label: str = "grove.io/tenant"
    #: rolling virtual-time window over which a tenant's
    #: disruption_budget is shared across EVERY disruption consumer
    #: (preemption and the defragmenter draw from one ledger — see
    #: tenancy.DisruptionLedger): evictions charged within the window
    #: count against the budget no matter who spent them, so a
    #: preemption round followed by a defrag sweep can never
    #: double-spend it
    disruption_budget_window_seconds: float = 60.0
    #: tenant for gangs that match no configured tenant ("" = exempt:
    #: admitted untracked with zero fairness weight)
    default_tenant: str = ""
    #: tier assumed for tenants (and defaulted onto PodGangs with an
    #: empty priority_class_name) that don't name one
    default_tier: str = "standard"
    #: scale of the DRF fairness term stamped onto solver gangs (0
    #: disables fairness ordering while keeping quota admission)
    fairness_weight: float = 0.5
    #: priority-tier ladder, each {name, value}; seeded as PriorityClass
    #: objects at cluster construction when tenancy is enabled, and the
    #: allowed vocabulary for PodGang.spec.priority_class_name admission
    tiers: list[dict] = field(
        default_factory=lambda: [dict(t) for t in DEFAULT_TENANCY_TIERS]
    )
    tenants: list[dict] = field(default_factory=list)


@dataclass
class DefragConfig:
    """Continuous defragmentation (controller/defrag.py): a background
    re-pack optimizer that closes the gap between the live placement and
    a fresh solve. Each sweep scores candidate gangs (worst placement
    score first) as dirty-row WHAT-IFs against the solver's
    device-resident state (PlacementEngine.whatif_scores — never a full
    re-encode), admits moves whose score gain net of migration cost
    clears `min_score_gain`, and executes them make-before-break through
    the drain/eviction path: the destination is verified to fit in
    CURRENTLY-free capacity and held as a migration ticket before the
    source is evicted, so a migration can never strand a gang unplaced.
    Every admitted AND rejected candidate lands in the DecisionLog as a
    migration audit (gain, cost, budget state, verdict).

      enabled                   off by default — defrag evicts running
                                gangs; opting in is deliberate
      sync_interval_seconds     sweep cadence (Harness.maybe_defrag)
      min_score_gain            a move's NET gain (new score - current
                                score - migration_cost_score) must clear
                                this threshold to be admitted
      migration_cost_score      flat score-unit cost charged per move
                                (models the disruption of restarting the
                                gang's pods)
      max_moves_per_sweep       admitted moves per sweep (bounds burst
                                disruption)
      max_evictions_per_hour    rolling virtual-hour ceiling on defrag
                                evictions fleet-wide (the migration-cost
                                bound the long-churn bench gates on)
      candidates_per_sweep      worst-scored gangs examined per sweep
    """

    enabled: bool = False
    sync_interval_seconds: float = 120.0
    min_score_gain: float = 0.05
    migration_cost_score: float = 0.02
    max_moves_per_sweep: int = 4
    max_evictions_per_hour: float = 60.0
    candidates_per_sweep: int = 32


@dataclass
class StreamConfig:
    """Streaming admission→solve front (streaming/): replaces
    round-draining with SLO-aware micro-batches. Each arriving gang gets
    a deadline budget of `slo_seconds`; a batching window closes when the
    oldest waiter's remaining budget says so (or `max_batch_gangs` hits),
    consecutive micro-batches pipeline through the dispatch/collect
    split, and overload degrades by SHEDDING with a structured
    `UnsatCode.DeadlineExceeded` — never by wedging or unbounded queueing.

      enabled                   off by default — streaming changes the
                                backlog-draining contract; opting in is
                                deliberate
      slo_seconds               per-gang deadline budget from stream
                                arrival to admission into a solve batch;
                                a projected wait beyond it sheds the gang
      window_min_seconds        normal batching window: a micro-batch
                                closes once its oldest waiter has waited
                                this long (arrivals inside the window
                                coalesce into one solve)
      window_max_seconds        widened window under brownout level >= 1
                                (amortizes solves when the queue is deep)
      max_batch_gangs           size cap that closes a window early
      queue_cap_gangs           bounded admission queue: arrivals beyond
                                it shed immediately (backpressure floor)
      brownout_depth_fraction   queue depth / queue_cap_gangs at which
                                the brownout ladder starts climbing
                                (L1 widen window, L2 suspend defrag
                                sweeps, L3 shed burst-band waiters)
      readmit_depth_fraction    depth fraction below which shed gangs
                                re-enter the stream with fresh deadlines
                                (must be < brownout_depth_fraction so
                                re-admit and shed never oscillate)
    """

    enabled: bool = False
    slo_seconds: float = 30.0
    window_min_seconds: float = 0.25
    window_max_seconds: float = 2.0
    max_batch_gangs: int = 64
    queue_cap_gangs: int = 512
    brownout_depth_fraction: float = 0.5
    readmit_depth_fraction: float = 0.25


@dataclass
class SLOConfig:
    """Continuous SLO evaluation (observability/slo.py): a windowed
    sampler over the metrics registry plus multi-window multi-burn-rate
    alerting, swept on the autoscaler/defrag cadence by
    `Harness.maybe_slo_sweep`. Two window pairs per objective: the
    "page" pair (short fast windows, high burn threshold) catches a 10x
    burst in seconds; the "ticket" pair (long windows, low threshold)
    catches a slow leak before the error budget exhausts. An alert
    trips when BOTH windows of a pair burn over the pair's threshold,
    and resolves once the short window recovers.

      enabled                  off by default — evaluation-only, but the
                               sweep cadence and alert Events are a
                               deliberate opt-in
      sync_interval_seconds    sweep cadence on the virtual clock
                               (Harness.maybe_slo_sweep early-returns
                               inside it, like maybe_autoscale)
      budget_window_seconds    the error-budget accounting window; must
                               cover the longest alert window
      max_samples_per_series   bound on every per-series sample ring
                               (virtual-time keyed; oldest evicted)
      pending_for_seconds      a tripped alert sits `pending` this long
                               before `firing` (0 still requires one
                               confirming sweep)
      page_short_seconds       page pair: short window
      page_long_seconds        page pair: long window
      page_burn_threshold      page pair: burn-rate trip point (14.4 =
                               2% of a 30-day budget in one hour,
                               scaled to whatever budget window)
      ticket_short_seconds     ticket pair: short window
      ticket_long_seconds      ticket pair: long window
      ticket_burn_threshold    ticket pair: burn-rate trip point
      history_limit            bounded alert-transition history kept
                               for the scorecard
      objectives               declarative SLO objects; empty means the
                               built-in defaults (per-tenant bind p99,
                               starvation, shed rate, placement drift,
                               failover wall). Each entry is a mapping
                               with `name`, `kind`, `target` in (0,1),
                               plus the kind's parameter:
                               bind_latency_p99→threshold_seconds
                               (+per_tenant), starvation→
                               max_starved_seconds, shed_rate→
                               ceiling_per_second, placement_drift→
                               band, failover_wall→max_failovers
    """

    enabled: bool = False
    sync_interval_seconds: float = 15.0
    budget_window_seconds: float = 3600.0
    max_samples_per_series: int = 512
    pending_for_seconds: float = 0.0
    page_short_seconds: float = 60.0
    page_long_seconds: float = 300.0
    page_burn_threshold: float = 14.4
    ticket_short_seconds: float = 300.0
    ticket_long_seconds: float = 1800.0
    ticket_burn_threshold: float = 3.0
    history_limit: int = 256
    objectives: list[dict] = field(default_factory=list)


@dataclass
class AutoscalerConfig:
    """k8s HPA controller knobs (controller/autoscaler.py).

      tolerance                         no scale while |ratio - 1| <=
                                        tolerance (k8s HPA default 0.1)
      sync_interval_seconds             periodic HPA sweep cadence
                                        (Harness.maybe_autoscale; the
                                        kube-controller-manager
                                        --horizontal-pod-autoscaler-
                                        sync-period analog)
      scale_down_stabilization_seconds  desired-on-scale-down is the MAX
                                        recommendation over this window
                                        (k8s stabilizationWindowSeconds)
                                        so a noisy signal never flaps the
                                        replica count; 0 = immediate
      metrics_max_age_seconds           utilization samples older than
                                        this read as MISSING (and missing
                                        metrics never drive scale-down)
    """

    tolerance: float = 0.1  # no scale while |ratio - 1| <= tolerance
    sync_interval_seconds: float = 15.0
    scale_down_stabilization_seconds: float = 300.0
    metrics_max_age_seconds: float = 120.0


@dataclass
class ServingConfig:
    """Elastic-serving traffic model (serving/): a deterministic
    virtual-time TrafficTrace mapped through per-clique workload shapes
    onto the per-pod utilization samples SimKubelet reports each tick —
    the metrics pipeline that feeds the autoscaler. Off by default; when
    enabled the kubelet reports and the diurnal bench / chaos traffic
    faults have a demand stream to drive.

      trace      TrafficTrace fields: base_rps, peak_rps, period_seconds,
                 peak_at_fraction, noise, seed, sample_seconds, spikes
                 (list of {at_seconds, duration_seconds, multiplier})
      workloads  serving tiers, each {clique: <clique template name>,
                 shape: prefill|decode|router, rps_per_replica?,
                 demand_fraction?} — the reference's disaggregated
                 serving roles (README.md:38-44); fractions/capacities
                 default per shape (serving/traffic.py DEFAULT_SHAPES)
    """

    enabled: bool = False
    trace: dict = field(default_factory=dict)
    workloads: list[dict] = field(default_factory=list)


@dataclass
class AuthorizationConfig:
    """Store-mutation authorization — the authorization webhook analog
    (webhook/admission/pcs/authorization/; types.go authorizer config).
    When enabled, only the operator identity (+ exempt actors) may mutate
    Grove-managed resources."""

    enabled: bool = False
    operator_identity: str = "system:serviceaccount:grove-system:grove-operator"
    exempt_actors: list[str] = field(default_factory=list)


@dataclass
class TopologyAwareSchedulingConfig:
    """TopologyAwareScheduling{Enabled, Levels} (types.go:190-202). Levels
    seed the bootstrap ClusterTopology: list of {domain, key} pairs,
    broadest first; empty = infer from node inventory labels."""

    enabled: bool = True
    levels: list[dict[str, str]] = field(default_factory=list)


@dataclass
class LeaderElectionConfig:
    """HA leader election (types.go LeaderElection block; manager.go:98-104
    wires it into controller-runtime). One active manager per lease;
    standbys take over when the holder stops renewing."""

    enabled: bool = False
    lease_name: str = "grove-operator"
    lease_namespace: str = "grove-system"
    lease_duration_seconds: float = 15.0


@dataclass
class LogConfig:
    level: str = "info"
    format: str = "text"


@dataclass
class TracingConfig:
    """Span tracing + flight recorder (observability/tracing.py,
    docs/observability.md). Off by default: the disabled path is a no-op
    tracer singleton that allocates nothing, so production/bench hot
    paths pay ~nothing. When enabled, finished spans land in a bounded
    ring (max_spans) and a copy of every span + reconcile error + event
    feeds the flight recorder's postmortem ring
    (flight_recorder_capacity) — both fixed-memory at any run length."""

    enabled: bool = False
    #: "full" retains spans in the ring (dumps, Chrome export, flight
    #: feed); "aggregate" skips the ring and folds finished spans
    #: straight into bounded critical-path sketches (O(1) memory — the
    #: always-on production mode, observability/causal.py)
    mode: str = "full"
    max_spans: int = 65536
    flight_recorder_capacity: int = 4096
    #: slowest-gangs table size in the critical-path observatory
    critical_path_top_k: int = 10


@dataclass
class DurabilityConfig:
    """Durable state store (cluster/durability.py): write-ahead log +
    periodic snapshots under the ObjectStore, enabling cold-restart
    recovery (`Harness.cold_restart`, `ObjectStore.recover`). Off by
    default (`wal_dir: null`) — the in-memory-only store is unchanged and
    the commit hot path pays one untaken branch.

      wal_dir                    directory for WAL segments + snapshots
                                 (None = durability off)
      fsync                      "commit"   — fsync every appended record:
                                              every acknowledged write is
                                              crash-durable (default)
                                 "snapshot" — fsync only at snapshot cuts
                                 "never"    — leave flushing to the OS
                                 (records are always flushed to the OS
                                 per append; the policy governs physical
                                 durability, i.e. what a REAL host crash
                                 could tear off the tail)
      snapshot_interval_seconds  virtual-clock cadence between snapshots
      wal_max_bytes              cut a snapshot early once the live WAL
                                 segment exceeds this (bounds replay)
      keep_snapshots             retained snapshot generations; >= 2 so a
                                 corrupted newest snapshot can fall back
                                 (WAL segments are pruned only once every
                                 record is covered by the OLDEST retained
                                 snapshot)
      partitions                 1 (default) = the classic single WAL;
                                 K > 1 partitions the durable write path
                                 by (namespace, kind) into K independent
                                 WAL segment chains + snapshot
                                 generations under wal_dir/pNNN
                                 (cluster/durability.PartitionedLog) —
                                 commits, fsyncs and snapshot cuts run
                                 per partition, recovery merges the
                                 partition streams by global seq back to
                                 a bit-identical store. The layout is
                                 recorded on disk; resuming a wal_dir
                                 with a different partition layout is
                                 refused (docs/operations.md
                                 "Partitioned WAL layout")
      partition_map              explicit partition pinning on top of the
                                 default hash routing: "Kind" or
                                 "namespace/Kind" -> partition index in
                                 [0, partitions). The qualified form
                                 wins; unlisted keys hash
    """

    wal_dir: str | None = None
    fsync: str = "commit"
    snapshot_interval_seconds: float = 300.0
    wal_max_bytes: int = 64 * 1024 * 1024
    keep_snapshots: int = 2
    partitions: int = 1
    partition_map: dict[str, int] = field(default_factory=dict)


_REPLICATION_ACK_MODES = ("async", "semi-sync")


@dataclass
class ReplicationConfig:
    """HA object store: a log-shipping standby (cluster/replication.py)
    continuously tails the leader's WAL stream — one tailer per
    partition, heap-merged by global seq, the same replay implementation
    recovery uses — and applies records into a second, promotable
    ObjectStore behind a bounded replication lag. Requires durability
    (`durability.wal_dir`); off by default.

      enabled           arm the standby (built at cluster construction,
                        re-seedable after a standby crash)
      standby_wal_dir   the standby's OWN durable directory (its
                        bootstrap snapshot + every applied record are
                        re-journaled here, so a promoted standby serves
                        durably from the first write). Generations live
                        under gen-NNNN subdirectories — a re-seeded
                        standby starts a fresh one. Must differ from
                        durability.wal_dir
      ack_mode          "async"     — commits never wait; the standby
                                      applies on its poll cadence, and
                                      the leader forces a catch-up only
                                      when the lag bounds are exceeded.
                                      A failover that loses the leader's
                                      disk loses at most the lag window
                        "semi-sync" — a commit completes only once the
                                      standby has durably appended the
                                      record: the ZERO-LOSS mode the
                                      failover bench measures (a stalled
                                      standby degrades to async for the
                                      stall, MySQL-semisync style, and
                                      catches up at stall end)
      max_lag_records   async backpressure: a commit that would leave the
                        standby more than this many records behind
                        triggers a synchronous catch-up poll
      max_lag_seconds   same bound in leader-clock seconds
    """

    enabled: bool = False
    standby_wal_dir: str | None = None
    ack_mode: str = "async"
    max_lag_records: int = 256
    max_lag_seconds: float = 5.0


@dataclass
class FederationConfig:
    """Multi-cluster federation (federation/): a global
    coordinator routes each arriving gang to one member cluster using
    the hierarchical pruner's over-admitting coarse cut predicates
    (clusters as super-domains), delegates to that cluster's full
    control plane, and survives whole-cluster loss by fencing the dead
    cluster's durable log and draining its committed gang set into
    survivors under per-tenant disruption budgets. Requires durability:
    every member cluster journals under its own directory and the
    coordinator keeps its routing/fencing state in its own durable
    journal. Off by default.

      enabled                           arm the federation layer
      clusters                          member cluster count (>= 2)
      cluster_wal_dirs                  explicit per-cluster durable
                                        directories (len == clusters,
                                        all distinct). Empty = derive
                                        cluster-NN subdirectories under
                                        durability.wal_dir
      coordinator_wal_dir               the coordinator's OWN durable
                                        journal directory (routes +
                                        cluster state records). None =
                                        derive coordinator/ under
                                        durability.wal_dir. Must differ
                                        from every cluster directory
      heartbeat_interval_seconds        member heartbeat cadence the
                                        health monitor samples
      outage_detection_window_seconds   a cluster whose newest heartbeat
                                        lags the newest PEER heartbeat
                                        by more than this is declared
                                        dead (must exceed the heartbeat
                                        interval, or healthy members
                                        false-trigger between beats)
      drain_window_seconds              declared bound on a whole-cluster
                                        drain: fence time + this window
                                        must cover the last re-placed
                                        gang (asserted by tests/chaos)
      drain_max_gangs_per_round         drain pacing: at most this many
                                        gangs re-placed per coordinator
                                        round (per-tenant DisruptionLedger
                                        budgets bound it further)
    """

    enabled: bool = False
    clusters: int = 3
    cluster_wal_dirs: list[str] = field(default_factory=list)
    coordinator_wal_dir: str | None = None
    heartbeat_interval_seconds: float = 10.0
    outage_detection_window_seconds: float = 45.0
    drain_window_seconds: float = 600.0
    drain_max_gangs_per_round: int = 8


@dataclass
class OperatorConfig:
    api_version: str = API_VERSION
    kind: str = KIND
    workload_defaults: WorkloadDefaultsConfig = field(
        default_factory=WorkloadDefaultsConfig
    )
    controllers: ControllerConfig = field(default_factory=ControllerConfig)
    cluster: ClusterConfig = field(default_factory=ClusterConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)
    tenancy: TenancyConfig = field(default_factory=TenancyConfig)
    defrag: DefragConfig = field(default_factory=DefragConfig)
    stream: StreamConfig = field(default_factory=StreamConfig)
    slo: SLOConfig = field(default_factory=SLOConfig)
    autoscaler: AutoscalerConfig = field(default_factory=AutoscalerConfig)
    serving: ServingConfig = field(default_factory=ServingConfig)
    authorization: AuthorizationConfig = field(default_factory=AuthorizationConfig)
    topology_aware_scheduling: TopologyAwareSchedulingConfig = field(
        default_factory=TopologyAwareSchedulingConfig
    )
    leader_election: LeaderElectionConfig = field(
        default_factory=LeaderElectionConfig
    )
    log: LogConfig = field(default_factory=LogConfig)
    tracing: TracingConfig = field(default_factory=TracingConfig)
    durability: DurabilityConfig = field(default_factory=DurabilityConfig)
    replication: ReplicationConfig = field(default_factory=ReplicationConfig)
    federation: FederationConfig = field(default_factory=FederationConfig)


def _build(cls, data: Any, path: str, errs: list[str]):
    """Strict recursive dataclass decode: unknown fields are errors (the
    reference's scheme decode rejects unknown YAML keys the same way)."""
    if not isinstance(data, dict):
        errs.append(f"{path}: expected mapping, got {type(data).__name__}")
        return cls()
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in data.items():
        if key not in fields:
            errs.append(f"{path}.{key}: unknown field")
            continue
        ftype = fields[key].type
        if dataclasses.is_dataclass(_resolve(ftype)):
            kwargs[key] = _build(_resolve(ftype), value, f"{path}.{key}", errs)
        else:
            kwargs[key] = value
    try:
        return cls(**kwargs)
    except TypeError as e:  # wrong primitive shape (e.g. list for float)
        errs.append(f"{path}: {e}")
        return cls()


_TYPES = {
    "WorkloadDefaultsConfig": WorkloadDefaultsConfig,
    "LeaderElectionConfig": LeaderElectionConfig,
    "ControllerConfig": ControllerConfig,
    "ClusterConfig": ClusterConfig,
    "SolverConfig": SolverConfig,
    "TenancyConfig": TenancyConfig,
    "DefragConfig": DefragConfig,
    "StreamConfig": StreamConfig,
    "SLOConfig": SLOConfig,
    "AutoscalerConfig": AutoscalerConfig,
    "ServingConfig": ServingConfig,
    "AuthorizationConfig": AuthorizationConfig,
    "TopologyAwareSchedulingConfig": TopologyAwareSchedulingConfig,
    "LogConfig": LogConfig,
    "TracingConfig": TracingConfig,
    "DurabilityConfig": DurabilityConfig,
    "ReplicationConfig": ReplicationConfig,
    "FederationConfig": FederationConfig,
    "OperatorConfig": OperatorConfig,
}


def _resolve(ftype):
    """Dataclass field types are strings under `from __future__ import
    annotations`; map them back to classes."""
    if isinstance(ftype, str):
        return _TYPES.get(ftype, ftype)
    return ftype


def load_operator_config(data: dict | None) -> OperatorConfig:
    """Decode + validate. Raises ValidationError with ALL problems at once
    (validation.go aggregates the same way)."""
    errs: list[str] = []
    cfg = _build(OperatorConfig, data or {}, "config", errs)
    errs += validate_operator_config(cfg)  # aggregate decode + semantic errors
    if errs:
        raise ValidationError(errs)
    return cfg


def validate_operator_config(cfg: OperatorConfig) -> list[str]:
    errs: list[str] = []
    if cfg.api_version != API_VERSION:
        errs.append(
            f"config.api_version: unsupported {cfg.api_version!r} "
            f"(want {API_VERSION!r})"
        )
    if cfg.kind != KIND:
        errs.append(f"config.kind: unsupported {cfg.kind!r} (want {KIND!r})")

    wd = cfg.workload_defaults
    if not _num(wd.termination_delay_seconds) or wd.termination_delay_seconds <= 0:
        errs.append(
            "config.workload_defaults.termination_delay_seconds: must be > 0"
        )
    if not _int(wd.replicas) or wd.replicas < 1:
        errs.append("config.workload_defaults.replicas: must be an int >= 1")

    cc = cfg.controllers
    if not _num(cc.sync_retry_interval_seconds) or cc.sync_retry_interval_seconds <= 0:
        errs.append(
            "config.controllers.sync_retry_interval_seconds: must be > 0"
        )
    for f in ("settle_max_rounds", "harness_max_rounds"):
        v = getattr(cc, f)
        if not _int(v) or v < 1:
            errs.append(f"config.controllers.{f}: must be an int >= 1")
    if not _num(cc.error_backoff_base_seconds) or cc.error_backoff_base_seconds <= 0:
        errs.append(
            "config.controllers.error_backoff_base_seconds: must be > 0"
        )
    if not _num(cc.error_backoff_max_seconds) or (
        _num(cc.error_backoff_base_seconds)
        and cc.error_backoff_base_seconds > 0
        and cc.error_backoff_max_seconds < cc.error_backoff_base_seconds
    ):
        errs.append(
            "config.controllers.error_backoff_max_seconds: must be >= "
            "error_backoff_base_seconds"
        )
    if not _int(cc.error_retry_budget) or cc.error_retry_budget < 1:
        errs.append(
            "config.controllers.error_retry_budget: must be an int >= 1"
        )
    if not isinstance(cc.node_monitor_enabled, bool):
        errs.append("config.controllers.node_monitor_enabled: must be a bool")
    if not _int(cc.shards) or cc.shards < 1:
        errs.append("config.controllers.shards: must be an int >= 1")
    if not _num(cc.shard_lease_duration_seconds) or (
        cc.shard_lease_duration_seconds <= 0
    ):
        errs.append(
            "config.controllers.shard_lease_duration_seconds: must be > 0"
        )
    if not isinstance(cc.round_write_batching, bool):
        errs.append("config.controllers.round_write_batching: must be a bool")

    cl = cfg.cluster
    if not _num(cl.node_lease_duration_seconds) or cl.node_lease_duration_seconds <= 0:
        errs.append(
            "config.cluster.node_lease_duration_seconds: must be > 0"
        )
    if not _num(cl.pod_eviction_grace_seconds) or cl.pod_eviction_grace_seconds < 0:
        errs.append(
            "config.cluster.pod_eviction_grace_seconds: must be >= 0"
        )
    if not _num(cl.node_stable_ready_seconds) or cl.node_stable_ready_seconds <= 0:
        errs.append(
            "config.cluster.node_stable_ready_seconds: must be > 0"
        )
    elif (
        _num(cl.node_lease_duration_seconds)
        and 0 < cl.node_lease_duration_seconds
        and cl.node_stable_ready_seconds < cl.node_lease_duration_seconds
    ):
        errs.append(
            "config.cluster.node_stable_ready_seconds: must be >= "
            "node_lease_duration_seconds (the Ready flip requires a lease "
            "renewed within the lease duration of now; a shorter stable "
            "window would let a dead node ride a stale lease back to Ready)"
        )

    sv = cfg.solver
    for f in ("top_k", "commit_chunk", "gang_bucket_minimum"):
        v = getattr(sv, f)
        if not _int(v) or v < 1:
            errs.append(f"config.solver.{f}: must be an int >= 1")
    if _int(sv.gang_bucket_minimum) and sv.gang_bucket_minimum >= 1:
        if sv.gang_bucket_minimum & (sv.gang_bucket_minimum - 1):
            errs.append(
                "config.solver.gang_bucket_minimum: must be a power of two "
                "(backlogs pad to power-of-two buckets for jit cache stability)"
            )
    if not isinstance(sv.native_repair, bool):
        errs.append("config.solver.native_repair: must be a bool")
    if not isinstance(sv.preemption_enabled, bool):
        errs.append("config.solver.preemption_enabled: must be a bool")
    if not isinstance(sv.device_state_cache, bool):
        errs.append("config.solver.device_state_cache: must be a bool")
    if not isinstance(sv.device_state_verify, bool):
        errs.append("config.solver.device_state_verify: must be a bool")
    elif sv.device_state_verify and sv.device_state_cache is False:
        # the tripwire re-checks the cache's epoch decisions; with the
        # cache off there is nothing to verify and the flag would be
        # silently inert — reject rather than hand out false confidence
        errs.append(
            "config.solver.device_state_verify: requires "
            "device_state_cache (the verify tripwire checks the cache's "
            "epoch guard; with the cache off it never runs)"
        )
    if not isinstance(sv.fused_solve, bool):
        errs.append("config.solver.fused_solve: must be a bool")
    if not isinstance(sv.incremental_resolve, bool):
        errs.append("config.solver.incremental_resolve: must be a bool")
    if not isinstance(sv.reservation_reuse, bool):
        errs.append("config.solver.reservation_reuse: must be a bool")
    if not isinstance(sv.hierarchical_solve, bool):
        errs.append("config.solver.hierarchical_solve: must be a bool")
    if sv.hierarchical_prune_level is not None and (
        not _int(sv.hierarchical_prune_level)
        or sv.hierarchical_prune_level < 0
    ):
        errs.append(
            "config.solver.hierarchical_prune_level: must be None (auto) "
            "or a topology level index >= 0"
        )
    if not _int(sv.hierarchical_min_nodes) or sv.hierarchical_min_nodes < 0:
        errs.append(
            "config.solver.hierarchical_min_nodes: must be an int >= 0"
        )
    if sv.hier_parallel_workers is not None and (
        not _int(sv.hier_parallel_workers) or sv.hier_parallel_workers < 0
    ):
        errs.append(
            "config.solver.hier_parallel_workers: must be None (auto) or "
            "an int >= 0 (0 = serial fine solves)"
        )
    if sv.pallas_core is not None and not isinstance(sv.pallas_core, bool):
        errs.append(
            "config.solver.pallas_core: must be None (auto: on where "
            "pallas lowers natively) or a bool"
        )
    if sv.device_commit is not None and not isinstance(
        sv.device_commit, bool
    ):
        errs.append(
            "config.solver.device_commit: must be None (auto: follows "
            "the kernel tier's native capability) or a bool"
        )
    if sv.pallas_precision not in ("fp32", "bf16"):
        errs.append(
            "config.solver.pallas_precision: must be 'fp32' (bit-equal) "
            "or 'bf16' (documented tie policy; equivalence-gated)"
        )

    errs += _validate_tenancy(cfg.tenancy)
    errs += _validate_defrag(cfg.defrag)
    errs += _validate_stream(cfg.stream)
    errs += _validate_slo(cfg.slo)

    le = cfg.leader_election
    if not isinstance(le.enabled, bool):
        errs.append("config.leader_election.enabled: must be a bool")
    if not _num(le.lease_duration_seconds) or le.lease_duration_seconds <= 0:
        errs.append(
            "config.leader_election.lease_duration_seconds: must be > 0"
        )
    if le.enabled is True and _int(cc.shards) and cc.shards > 1:
        # the sharded control plane elects its own coordinator among the
        # worker replicas; gating every worker behind one whole-manager
        # lease would serialize them back to a single active replica
        errs.append(
            "config.leader_election.enabled: incompatible with "
            "config.controllers.shards > 1 (the sharded control plane "
            "runs its own coordinator election; see docs/operations.md)"
        )

    au = cfg.autoscaler
    if not _num(au.tolerance) or not (0 <= au.tolerance < 1):
        errs.append("config.autoscaler.tolerance: must be in [0, 1)")
    if not _num(au.sync_interval_seconds) or au.sync_interval_seconds <= 0:
        errs.append("config.autoscaler.sync_interval_seconds: must be > 0")
    if not _num(au.scale_down_stabilization_seconds) or (
        au.scale_down_stabilization_seconds < 0
    ):
        errs.append(
            "config.autoscaler.scale_down_stabilization_seconds: must be "
            ">= 0 (0 = scale down immediately)"
        )
    if not _num(au.metrics_max_age_seconds) or au.metrics_max_age_seconds <= 0:
        errs.append("config.autoscaler.metrics_max_age_seconds: must be > 0")
    elif (
        _num(au.sync_interval_seconds)
        and au.sync_interval_seconds > 0
        and au.metrics_max_age_seconds < au.sync_interval_seconds
    ):
        # every sample would be stale by the next sync: the HPA could
        # never see a metric and the autoscaler would be silently inert
        errs.append(
            "config.autoscaler.metrics_max_age_seconds: must be >= "
            "sync_interval_seconds (samples must survive to the next "
            "HPA sync or no metric is ever observed)"
        )

    errs += _validate_serving(cfg.serving)

    az = cfg.authorization
    if not isinstance(az.enabled, bool):
        errs.append("config.authorization.enabled: must be a bool")
    if az.enabled and not az.operator_identity:
        errs.append(
            "config.authorization.operator_identity: required when enabled"
        )
    if not isinstance(az.exempt_actors, list) or any(
        not isinstance(a, str) or not a for a in az.exempt_actors
    ):
        errs.append(
            "config.authorization.exempt_actors: must be a list of non-empty "
            "strings"
        )

    ts = cfg.topology_aware_scheduling
    if not isinstance(ts.enabled, bool):
        errs.append("config.topology_aware_scheduling.enabled: must be a bool")
    if not isinstance(ts.levels, list):
        errs.append("config.topology_aware_scheduling.levels: must be a list")
        ts = dataclasses.replace(ts, levels=[])
    seen_domains: set[str] = set()
    for i, lv in enumerate(ts.levels):
        path = f"config.topology_aware_scheduling.levels[{i}]"
        if not isinstance(lv, dict) or set(lv) != {"domain", "key"}:
            errs.append(f"{path}: must be a {{domain, key}} mapping")
            continue
        if not lv["domain"] or not lv["key"]:
            errs.append(f"{path}: domain and key must be non-empty")
        if lv["domain"] in seen_domains:
            errs.append(f"{path}.domain: duplicate domain {lv['domain']!r}")
        seen_domains.add(lv["domain"])

    if cfg.log.level not in _LOG_LEVELS:
        errs.append(f"config.log.level: must be one of {_LOG_LEVELS}")
    if cfg.log.format not in _LOG_FORMATS:
        errs.append(f"config.log.format: must be one of {_LOG_FORMATS}")

    tr = cfg.tracing
    if not isinstance(tr.enabled, bool):
        errs.append("config.tracing.enabled: must be a bool")
    if tr.mode not in ("full", "aggregate"):
        errs.append('config.tracing.mode: must be "full" or "aggregate"')
    if not _int(tr.max_spans) or tr.max_spans < 1:
        errs.append("config.tracing.max_spans: must be an int >= 1")
    if not _int(tr.flight_recorder_capacity) or tr.flight_recorder_capacity < 1:
        errs.append(
            "config.tracing.flight_recorder_capacity: must be an int >= 1"
        )
    if not _int(tr.critical_path_top_k) or tr.critical_path_top_k < 1:
        errs.append(
            "config.tracing.critical_path_top_k: must be an int >= 1"
        )

    du = cfg.durability
    if du.wal_dir is not None and (
        not isinstance(du.wal_dir, str) or not du.wal_dir
    ):
        # an empty path is a likely templating bug, not a disable switch:
        # disabling is wal_dir: null, explicitly
        errs.append(
            "config.durability.wal_dir: must be null (durability off) or "
            "a non-empty directory path"
        )
    if du.fsync not in _DURABILITY_FSYNC:
        errs.append(
            f"config.durability.fsync: must be one of {_DURABILITY_FSYNC}"
        )
    if not _num(du.snapshot_interval_seconds) or du.snapshot_interval_seconds <= 0:
        errs.append(
            "config.durability.snapshot_interval_seconds: must be > 0"
        )
    if not _int(du.wal_max_bytes) or du.wal_max_bytes < 4096:
        errs.append(
            "config.durability.wal_max_bytes: must be an int >= 4096 "
            "(a segment must hold at least a few records before forcing "
            "a snapshot per write)"
        )
    if not _int(du.keep_snapshots) or du.keep_snapshots < 2:
        errs.append(
            "config.durability.keep_snapshots: must be an int >= 2 — "
            "recovery from a corrupted newest snapshot needs at least "
            "one older generation to fall back to"
        )
    if not _int(du.partitions) or not 1 <= du.partitions <= 256:
        errs.append(
            "config.durability.partitions: must be an int in [1, 256] "
            "(1 = the classic single WAL)"
        )
    if not isinstance(du.partition_map, dict):
        errs.append(
            "config.durability.partition_map: must be a mapping of "
            '"Kind" or "namespace/Kind" to a partition index'
        )
    else:
        for mk, mv in du.partition_map.items():
            if not isinstance(mk, str) or not mk:
                errs.append(
                    "config.durability.partition_map: keys must be "
                    'non-empty "Kind" or "namespace/Kind" strings'
                )
                break
            if not _int(mv) or not (
                _int(du.partitions) and 0 <= mv < max(du.partitions, 1)
            ):
                errs.append(
                    f"config.durability.partition_map[{mk!r}]: must be "
                    "a partition index in [0, config.durability."
                    "partitions)"
                )
        if du.partition_map and _int(du.partitions) and du.partitions < 2:
            errs.append(
                "config.durability.partition_map: requires "
                "config.durability.partitions > 1 (a single-partition "
                "log has nothing to pin)"
            )

    rp = cfg.replication
    if not isinstance(rp.enabled, bool):
        errs.append("config.replication.enabled: must be a bool")
    if rp.ack_mode not in _REPLICATION_ACK_MODES:
        errs.append(
            f"config.replication.ack_mode: must be one of "
            f"{_REPLICATION_ACK_MODES}"
        )
    if not _int(rp.max_lag_records) or rp.max_lag_records < 1:
        errs.append(
            "config.replication.max_lag_records: must be an int >= 1"
        )
    if not _num(rp.max_lag_seconds) or rp.max_lag_seconds <= 0:
        errs.append("config.replication.max_lag_seconds: must be > 0")
    if rp.standby_wal_dir is not None and (
        not isinstance(rp.standby_wal_dir, str) or not rp.standby_wal_dir
    ):
        errs.append(
            "config.replication.standby_wal_dir: must be null or a "
            "non-empty directory path"
        )
    if rp.enabled is True:
        if not du.wal_dir:
            # there is no WAL stream to tail without durability — an
            # enabled-but-logless standby would be silently inert
            errs.append(
                "config.replication.enabled: requires "
                "config.durability.wal_dir (the standby tails the "
                "leader's WAL stream)"
            )
        if not rp.standby_wal_dir:
            errs.append(
                "config.replication.standby_wal_dir: required when "
                "replication is enabled (the standby journals its "
                "applied prefix durably so a promoted store serves "
                "from disk-backed state)"
            )
        elif du.wal_dir and rp.standby_wal_dir == du.wal_dir:
            errs.append(
                "config.replication.standby_wal_dir: must differ from "
                "config.durability.wal_dir — a standby journaling into "
                "the leader's directory would interleave two histories"
            )

    fe = cfg.federation
    if not isinstance(fe.enabled, bool):
        errs.append("config.federation.enabled: must be a bool")
    if not _int(fe.clusters) or fe.clusters < 2:
        errs.append(
            "config.federation.clusters: must be an int >= 2 (a "
            "one-member federation has nowhere to fail over to)"
        )
    dirs_ok = isinstance(fe.cluster_wal_dirs, (list, tuple)) and all(
        isinstance(d, str) and d for d in fe.cluster_wal_dirs
    )
    if not dirs_ok:
        errs.append(
            "config.federation.cluster_wal_dirs: must be a list of "
            "non-empty directory paths"
        )
    elif fe.cluster_wal_dirs:
        if _int(fe.clusters) and len(fe.cluster_wal_dirs) != fe.clusters:
            errs.append(
                "config.federation.cluster_wal_dirs: when given, must "
                "name exactly config.federation.clusters directories"
            )
        if len(set(fe.cluster_wal_dirs)) != len(fe.cluster_wal_dirs):
            errs.append(
                "config.federation.cluster_wal_dirs: entries must be "
                "distinct — two clusters journaling into one directory "
                "would interleave two histories"
            )
    if fe.coordinator_wal_dir is not None and (
        not isinstance(fe.coordinator_wal_dir, str)
        or not fe.coordinator_wal_dir
    ):
        errs.append(
            "config.federation.coordinator_wal_dir: must be null or a "
            "non-empty directory path"
        )
    if not _num(fe.heartbeat_interval_seconds) or (
        fe.heartbeat_interval_seconds <= 0
    ):
        errs.append(
            "config.federation.heartbeat_interval_seconds: must be > 0"
        )
    if not _num(fe.outage_detection_window_seconds) or (
        fe.outage_detection_window_seconds <= 0
    ):
        errs.append(
            "config.federation.outage_detection_window_seconds: must "
            "be > 0"
        )
    elif (
        _num(fe.heartbeat_interval_seconds)
        and fe.heartbeat_interval_seconds > 0
        and fe.outage_detection_window_seconds
        <= fe.heartbeat_interval_seconds
    ):
        errs.append(
            "config.federation.outage_detection_window_seconds: must "
            "exceed heartbeat_interval_seconds — a window shorter than "
            "one beat declares healthy members dead between beats"
        )
    if not _num(fe.drain_window_seconds) or fe.drain_window_seconds <= 0:
        errs.append("config.federation.drain_window_seconds: must be > 0")
    if not _int(fe.drain_max_gangs_per_round) or (
        fe.drain_max_gangs_per_round < 1
    ):
        errs.append(
            "config.federation.drain_max_gangs_per_round: must be an "
            "int >= 1"
        )
    if fe.enabled is True:
        # no member may run without its own durable history: failover
        # recovers the dead cluster's committed set FROM ITS DIRECTORY,
        # and the coordinator's routing state must itself survive a
        # coordinator crash — federation without durability would be a
        # failover that forgets what it was failing over
        if not du.wal_dir and not (dirs_ok and fe.cluster_wal_dirs):
            errs.append(
                "config.federation.enabled: requires "
                "config.durability.wal_dir (per-cluster directories and "
                "the coordinator journal derive under it) or explicit "
                "config.federation.cluster_wal_dirs"
            )
        if not du.wal_dir and not fe.coordinator_wal_dir:
            errs.append(
                "config.federation.coordinator_wal_dir: required when "
                "federation is enabled without config.durability.wal_dir "
                "(the coordinator journals routes and fences durably)"
            )
        if dirs_ok and fe.coordinator_wal_dir and (
            fe.coordinator_wal_dir in fe.cluster_wal_dirs
        ):
            errs.append(
                "config.federation.coordinator_wal_dir: must differ "
                "from every cluster_wal_dirs entry"
            )
    return errs


#: allowed serving.trace keys, mirroring serving/traffic.py TrafficTrace
_TRACE_KEYS = {
    "base_rps", "peak_rps", "period_seconds", "peak_at_fraction",
    "noise", "seed", "sample_seconds", "spikes",
}
_SPIKE_KEYS = {"at_seconds", "duration_seconds", "multiplier"}
_WORKLOAD_KEYS = {"clique", "shape", "rps_per_replica", "demand_fraction"}
#: the shape vocabulary (serving/traffic.py DEFAULT_SHAPES keys, inlined
#: so the config layer stays import-light)
_SHAPES = ("prefill", "decode", "router")


def _validate_serving(sv: ServingConfig) -> list[str]:
    """Aggregated semantic validation of the serving block (structural
    problems short-circuit per entry, like the tenancy validator)."""
    errs: list[str] = []
    if not isinstance(sv.enabled, bool):
        errs.append("config.serving.enabled: must be a bool")
    tr = sv.trace
    if not isinstance(tr, dict):
        errs.append("config.serving.trace: must be a mapping")
        tr = {}
    unknown = set(tr) - _TRACE_KEYS
    if unknown:
        errs.append(
            f"config.serving.trace: unknown field(s) {sorted(unknown)}"
        )
    for key, lo_ok in (
        ("base_rps", lambda v: v > 0),
        ("peak_rps", lambda v: v > 0),
        ("period_seconds", lambda v: v > 0),
        ("sample_seconds", lambda v: v > 0),
        ("noise", lambda v: v >= 0),
        ("peak_at_fraction", lambda v: 0 <= v <= 1),
    ):
        if key in tr and (not _num(tr[key]) or not lo_ok(tr[key])):
            errs.append(f"config.serving.trace.{key}: invalid value "
                        f"{tr[key]!r}")
    if "seed" in tr and not _int(tr["seed"]):
        errs.append("config.serving.trace.seed: must be an int")
    # compare the EFFECTIVE values: an omitted key falls back to the
    # TrafficTrace dataclass default, and the invariant must hold for
    # the curve the engine will actually run (function-level import so
    # the config layer stays import-light at module load)
    from ..serving.traffic import TrafficTrace as _TT

    base_eff = tr.get("base_rps", _TT.base_rps)
    peak_eff = tr.get("peak_rps", _TT.peak_rps)
    if _num(base_eff) and _num(peak_eff) and peak_eff < base_eff:
        errs.append(
            f"config.serving.trace.peak_rps: must be >= base_rps (the "
            f"diurnal curve sweeps base..peak; effective "
            f"{peak_eff} < {base_eff})"
        )
    spikes = tr.get("spikes", [])
    if not isinstance(spikes, list):
        errs.append("config.serving.trace.spikes: must be a list")
        spikes = []
    for i, sp in enumerate(spikes):
        path = f"config.serving.trace.spikes[{i}]"
        if not isinstance(sp, dict) or set(sp) - _SPIKE_KEYS:
            errs.append(
                f"{path}: must be an {{at_seconds, duration_seconds, "
                "multiplier}} mapping"
            )
            continue
        if not _num(sp.get("at_seconds", 0)) or sp.get("at_seconds", 0) < 0:
            errs.append(f"{path}.at_seconds: must be a number >= 0")
        if not _num(sp.get("duration_seconds", 1)) or (
            sp.get("duration_seconds", 1) <= 0
        ):
            errs.append(f"{path}.duration_seconds: must be a number > 0")
        if not _num(sp.get("multiplier", 1)) or sp.get("multiplier", 1) <= 0:
            errs.append(f"{path}.multiplier: must be a number > 0")

    if not isinstance(sv.workloads, list):
        errs.append("config.serving.workloads: must be a list")
        return errs
    seen_cliques: set[str] = set()
    for i, w in enumerate(sv.workloads):
        path = f"config.serving.workloads[{i}]"
        if not isinstance(w, dict):
            errs.append(f"{path}: must be a mapping")
            continue
        unknown = set(w) - _WORKLOAD_KEYS
        if unknown:
            errs.append(f"{path}: unknown field(s) {sorted(unknown)}")
        clique = w.get("clique")
        if not isinstance(clique, str) or not clique:
            errs.append(f"{path}.clique: must be a non-empty clique "
                        "template name")
        elif clique in seen_cliques:
            errs.append(f"{path}.clique: duplicate workload for clique "
                        f"{clique!r}")
        else:
            seen_cliques.add(clique)
        shape = w.get("shape", "decode")
        if shape not in _SHAPES:
            errs.append(
                f"{path}.shape: unknown shape {shape!r} "
                f"(supported: {list(_SHAPES)})"
            )
        for key in ("rps_per_replica", "demand_fraction"):
            if key in w and (not _num(w[key]) or w[key] <= 0):
                errs.append(f"{path}.{key}: must be a number > 0")
        if "demand_fraction" in w and _num(w["demand_fraction"]) and (
            w["demand_fraction"] > 1
        ):
            errs.append(f"{path}.demand_fraction: must be <= 1")
    if sv.enabled is True and not sv.workloads:
        # an enabled-but-workload-less serving block would tick the
        # reporting hook forever and report nothing — reject rather than
        # hand out a silently inert metrics pipeline
        errs.append(
            "config.serving.workloads: must not be empty when serving is "
            "enabled (the kubelet would report no samples and every HPA "
            "would hold on missing metrics)"
        )
    return errs


def _validate_defrag(df: DefragConfig) -> list[str]:
    """Aggregated semantic validation of the defrag block."""
    errs: list[str] = []
    if not isinstance(df.enabled, bool):
        errs.append("config.defrag.enabled: must be a bool")
    if not _num(df.sync_interval_seconds) or df.sync_interval_seconds <= 0:
        errs.append("config.defrag.sync_interval_seconds: must be > 0")
    if not _num(df.min_score_gain) or df.min_score_gain <= 0:
        # a zero threshold would admit churn-for-nothing moves: every
        # tie would evict a running gang for an equal-score placement
        errs.append("config.defrag.min_score_gain: must be > 0")
    if not _num(df.migration_cost_score) or df.migration_cost_score < 0:
        errs.append("config.defrag.migration_cost_score: must be >= 0")
    if not _int(df.max_moves_per_sweep) or df.max_moves_per_sweep < 1:
        errs.append("config.defrag.max_moves_per_sweep: must be an int >= 1")
    if not _num(df.max_evictions_per_hour) or df.max_evictions_per_hour <= 0:
        errs.append("config.defrag.max_evictions_per_hour: must be > 0")
    if not _int(df.candidates_per_sweep) or df.candidates_per_sweep < 1:
        errs.append(
            "config.defrag.candidates_per_sweep: must be an int >= 1"
        )
    return errs


def _validate_stream(st: StreamConfig) -> list[str]:
    """Aggregated semantic validation of the streaming-admission block."""
    errs: list[str] = []
    if not isinstance(st.enabled, bool):
        errs.append("config.stream.enabled: must be a bool")
    for f in ("slo_seconds", "window_min_seconds", "window_max_seconds"):
        v = getattr(st, f)
        if not _num(v) or v <= 0:
            errs.append(f"config.stream.{f}: must be > 0")
    if (
        _num(st.window_min_seconds)
        and _num(st.window_max_seconds)
        and st.window_min_seconds > 0
        and st.window_max_seconds < st.window_min_seconds
    ):
        errs.append(
            "config.stream.window_max_seconds: must be >= window_min_seconds"
        )
    if (
        _num(st.slo_seconds)
        and _num(st.window_min_seconds)
        and st.window_min_seconds > 0
        and st.slo_seconds < st.window_min_seconds
    ):
        # an SLO shorter than the minimum window sheds EVERY arrival:
        # no gang could ever wait out a window inside its budget
        errs.append(
            "config.stream.slo_seconds: must be >= window_min_seconds"
        )
    for f in ("max_batch_gangs", "queue_cap_gangs"):
        v = getattr(st, f)
        if not _int(v) or v < 1:
            errs.append(f"config.stream.{f}: must be an int >= 1")
    for f in ("brownout_depth_fraction", "readmit_depth_fraction"):
        v = getattr(st, f)
        if not _num(v) or not (0 < v <= 1):
            errs.append(f"config.stream.{f}: must be in (0, 1]")
    if (
        _num(st.brownout_depth_fraction)
        and _num(st.readmit_depth_fraction)
        and 0 < st.brownout_depth_fraction <= 1
        and 0 < st.readmit_depth_fraction <= 1
        and st.readmit_depth_fraction >= st.brownout_depth_fraction
    ):
        # hysteresis: re-admitting at or above the brownout threshold
        # would oscillate shed <-> re-admit every round
        errs.append(
            "config.stream.readmit_depth_fraction: must be < "
            "brownout_depth_fraction (shed/re-admit hysteresis)"
        )
    return errs


#: the objective kinds observability/slo.py can evaluate, each with its
#: required threshold parameter (validated here so a typo'd objective
#: fails at config load, not mid-sweep)
_SLO_OBJECTIVE_KINDS = {
    "bind_latency_p99": "threshold_seconds",
    "starvation": "max_starved_seconds",
    "shed_rate": "ceiling_per_second",
    "placement_drift": "band",
    "failover_wall": "max_failovers",
}


def _validate_slo(sl: SLOConfig) -> list[str]:
    """Aggregated semantic validation of the SLO-evaluation block."""
    errs: list[str] = []
    if not isinstance(sl.enabled, bool):
        errs.append("config.slo.enabled: must be a bool")
    for f in (
        "sync_interval_seconds",
        "budget_window_seconds",
        "page_short_seconds",
        "page_long_seconds",
        "page_burn_threshold",
        "ticket_short_seconds",
        "ticket_long_seconds",
        "ticket_burn_threshold",
    ):
        v = getattr(sl, f)
        if not _num(v) or v <= 0:
            errs.append(f"config.slo.{f}: must be > 0")
    for short_f, long_f in (
        ("page_short_seconds", "page_long_seconds"),
        ("ticket_short_seconds", "ticket_long_seconds"),
    ):
        short, long_ = getattr(sl, short_f), getattr(sl, long_f)
        if _num(short) and _num(long_) and 0 < long_ < short:
            # the short window exists to confirm/resolve fast; a pair
            # with long < short inverts both roles
            errs.append(f"config.slo.{long_f}: must be >= {short_f}")
    if (
        _num(sl.budget_window_seconds)
        and _num(sl.ticket_long_seconds)
        and 0 < sl.budget_window_seconds < sl.ticket_long_seconds
    ):
        errs.append(
            "config.slo.budget_window_seconds: must be >= "
            "ticket_long_seconds (budget accounting must cover the "
            "slowest alert window)"
        )
    if not _num(sl.pending_for_seconds) or sl.pending_for_seconds < 0:
        errs.append("config.slo.pending_for_seconds: must be >= 0")
    for f in ("max_samples_per_series", "history_limit"):
        v = getattr(sl, f)
        if not _int(v) or v < 1:
            errs.append(f"config.slo.{f}: must be an int >= 1")
    if not isinstance(sl.objectives, list):
        errs.append("config.slo.objectives: must be a list of mappings")
        return errs
    seen: set[str] = set()
    for i, obj in enumerate(sl.objectives):
        path = f"config.slo.objectives[{i}]"
        if not isinstance(obj, dict):
            errs.append(f"{path}: expected mapping, got {type(obj).__name__}")
            continue
        name = obj.get("name")
        if not isinstance(name, str) or not name:
            errs.append(f"{path}.name: must be a non-empty string")
        elif name in seen:
            errs.append(f"{path}.name: duplicate objective {name!r}")
        else:
            seen.add(name)
        kind = obj.get("kind")
        if kind not in _SLO_OBJECTIVE_KINDS:
            errs.append(
                f"{path}.kind: unknown kind {kind!r} (want one of "
                f"{sorted(_SLO_OBJECTIVE_KINDS)})"
            )
            continue
        target = obj.get("target", 0.99)
        if not _num(target) or not (0 < target < 1):
            errs.append(f"{path}.target: must be in (0, 1)")
        param = _SLO_OBJECTIVE_KINDS[kind]
        if param in obj:
            v = obj[param]
            if kind == "failover_wall":
                if not _int(v) or v < 0:
                    errs.append(f"{path}.{param}: must be an int >= 0")
            elif not _num(v) or v <= 0:
                errs.append(f"{path}.{param}: must be > 0")
        known = {"name", "kind", "target", "per_tenant", param}
        for key in sorted(set(obj) - known):
            errs.append(f"{path}.{key}: unknown field")
        if "per_tenant" in obj and not isinstance(obj["per_tenant"], bool):
            errs.append(f"{path}.per_tenant: must be a bool")
    return errs


def _validate_tenancy(tn: TenancyConfig) -> list[str]:
    """Aggregated semantic validation of the tenancy block. Structural
    problems (a malformed tier/tenant entry) short-circuit per entry so
    one bad mapping doesn't cascade into attribute errors."""
    errs: list[str] = []
    if not isinstance(tn.enabled, bool):
        errs.append("config.tenancy.enabled: must be a bool")
    if not isinstance(tn.tenant_label, str) or not tn.tenant_label:
        errs.append("config.tenancy.tenant_label: must be a non-empty string")
    if not _num(tn.fairness_weight) or tn.fairness_weight < 0:
        errs.append("config.tenancy.fairness_weight: must be a number >= 0")
    if (
        not _num(tn.disruption_budget_window_seconds)
        or tn.disruption_budget_window_seconds <= 0
    ):
        errs.append(
            "config.tenancy.disruption_budget_window_seconds: must be > 0"
        )

    tier_names: set[str] = set()
    if not isinstance(tn.tiers, list):
        errs.append("config.tenancy.tiers: must be a list")
    else:
        for i, tier in enumerate(tn.tiers):
            path = f"config.tenancy.tiers[{i}]"
            if not isinstance(tier, dict) or set(tier) != {"name", "value"}:
                errs.append(f"{path}: must be a {{name, value}} mapping")
                continue
            if not isinstance(tier["name"], str) or not tier["name"]:
                errs.append(f"{path}.name: must be a non-empty string")
                continue
            if tier["name"] in tier_names:
                errs.append(f"{path}.name: duplicate tier {tier['name']!r}")
            tier_names.add(tier["name"])
            if not _num(tier["value"]):
                errs.append(f"{path}.value: must be a number")
    if isinstance(tn.tiers, list) and not tn.tiers and tn.enabled is True:
        # an enabled-but-tierless config would wedge every PodGang
        # create: defaulting stamps default_tier onto empty names and
        # admission then rejects the unconfigured tier
        errs.append(
            "config.tenancy.tiers: must not be empty when tenancy is "
            "enabled (PodGang defaulting stamps default_tier, which "
            "admission validates against this set)"
        )
    if tn.tiers and tn.default_tier not in tier_names:
        errs.append(
            f"config.tenancy.default_tier: {tn.default_tier!r} is not a "
            f"configured tier (have {sorted(tier_names)})"
        )

    tenant_names: set[str] = set()
    parents: dict[str, str] = {}
    if not isinstance(tn.tenants, list):
        errs.append("config.tenancy.tenants: must be a list")
        return errs
    allowed_keys = {
        "name", "guaranteed", "burst", "weight", "tier", "parent",
        "disruption_budget",
    }
    for i, t in enumerate(tn.tenants):
        path = f"config.tenancy.tenants[{i}]"
        if not isinstance(t, dict):
            errs.append(f"{path}: must be a mapping")
            continue
        unknown = set(t) - allowed_keys
        if unknown:
            errs.append(f"{path}: unknown field(s) {sorted(unknown)}")
        name = t.get("name")
        if not isinstance(name, str) or not name:
            errs.append(f"{path}.name: must be a non-empty string")
            continue
        if name in tenant_names:
            errs.append(f"{path}.name: duplicate tenant {name!r}")
        tenant_names.add(name)
        guaranteed = t.get("guaranteed", {})
        burst = t.get("burst", {})
        for fname, quota in (("guaranteed", guaranteed), ("burst", burst)):
            if not isinstance(quota, dict):
                errs.append(f"{path}.{fname}: must be a {{resource: amount}} "
                            "mapping")
                continue
            for res, amount in quota.items():
                if not isinstance(res, str) or not res:
                    errs.append(f"{path}.{fname}: resource names must be "
                                "non-empty strings")
                elif not _num(amount) or amount < 0:
                    errs.append(
                        f"{path}.{fname}[{res!r}]: must be a number >= 0"
                    )
        if isinstance(guaranteed, dict) and isinstance(burst, dict):
            for res, cap in burst.items():
                g = guaranteed.get(res, 0.0)
                if _num(cap) and _num(g) and cap < g:
                    errs.append(
                        f"{path}.burst[{res!r}]: must be >= guaranteed "
                        f"({cap} < {g}) — burst is the ceiling over the "
                        "guarantee, not a second floor"
                    )
        weight = t.get("weight", 1.0)
        if not _num(weight) or weight <= 0:
            errs.append(f"{path}.weight: must be a number > 0")
        tier = t.get("tier", "")
        if tier and tier_names and tier not in tier_names:
            errs.append(
                f"{path}.tier: unknown tier {tier!r} "
                f"(configured: {sorted(tier_names)})"
            )
        budget = t.get("disruption_budget")
        if budget is not None and (not _int(budget) or budget < 0):
            errs.append(f"{path}.disruption_budget: must be an int >= 0")
        parent = t.get("parent", "")
        if parent:
            if not isinstance(parent, str):
                errs.append(f"{path}.parent: must be a string")
            else:
                parents[name] = parent
    for name, parent in parents.items():
        if parent not in tenant_names:
            errs.append(
                f"config.tenancy.tenants[{name!r}].parent: unknown tenant "
                f"{parent!r}"
            )
    # the parent graph must be a forest: walk each chain with a visited
    # set; revisiting a node inside one walk is a cycle
    for name in parents:
        seen = {name}
        cur = parents.get(name)
        while cur is not None:
            if cur in seen:
                errs.append(
                    f"config.tenancy.tenants: parent cycle through {cur!r}"
                )
                break
            seen.add(cur)
            cur = parents.get(cur)
    if tn.default_tenant and tn.default_tenant not in tenant_names:
        errs.append(
            f"config.tenancy.default_tenant: {tn.default_tenant!r} is not "
            "a configured tenant"
        )
    return errs


def _num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _int(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)
