"""`python -m grove_tpu_torch.scripts.chaos_sweep [flags]`: the wide-matrix
chaos sweep on the port.

The counterpart of scripts/chaos_sweep.py, function for function
(`sweep_workload`, `run_seed`, `run_aggregate_ab`, `federation_workload`,
`federation_baseline`, `run_federation_seed`, `main`), over the port's
`ChaosHarness`, `FaultPlan`, `check_invariants`, `settled_fingerprint`,
`Harness` and `FederationCoordinator`. It sweeps a seed range of
deterministic fault plans over the reference workload and checks the
convergence contract for each: once faults stop, the workload-level
fingerprint must equal a fault-free run's and the fuzz invariants must
hold. A failing seed reproduces exactly with

    python -m grove_tpu_torch.scripts.chaos_sweep --start <seed> --seeds 1

The flags are chaos_sweep.py's, with the same defaults and help texts,
plus `--device` (default "cuda"): every harness, its engines and the
federation members run there. Without CUDA the command raises unless
`--device cpu` is given; nothing drops to the CPU on its own.

Output: chaos_sweep.py's, one JSON line per seed plus a summary line, with
the same keys; exit 1 when any seed fails. No key differs. The values
that are walls: each seed line's `wall_seconds`, and `drain_seconds` of
a federation seed is virtual time, not a wall.

    python -m grove_tpu_torch.scripts.chaos_sweep --seeds 60
    python -m grove_tpu_torch.scripts.chaos_sweep --start 100 --seeds 20 --nodes 32
"""


from __future__ import annotations

import argparse
import io
import json
import time
from pathlib import Path

from ..api.types import PodCliqueScalingGroupConfig
from ..chaos import (
    ChaosHarness,
    FaultPlan,
    check_invariants,
    settled_fingerprint,
)
from ..cluster import make_nodes
from ..controller import Harness
from ..solver.engine import resolve_device


def sweep_workload(scaled: bool = False, hierarchical: bool = False):
    """The reference chaos workload: startup ordering + a scaling group —
    every orchestration flow (gang create/defer, gates, scaled gangs,
    RBAC) is on the fault path. `scaled=True` (the --serving axis) adds
    an HPA scaleConfig on the scaling group so the traffic-driven scale
    loop has a subresource to write. `hierarchical=True` (the
    --hierarchical axis) adds a rack-level pack constraint so the
    backlog is CONFINED — the two-level solve only engages on confined
    backlogs, and node faults then land between its coarse assignments
    and shard-local fine solves."""
    from ..api.meta import ObjectMeta
    from ..api.types import (
        AutoScalingConfig,
        Container,
        PodCliqueSet,
        PodCliqueSetSpec,
        PodCliqueSetTemplateSpec,
        PodCliqueSpec,
        PodCliqueTemplateSpec,
        PodSpec,
        TopologyConstraintSpec,
        TopologyPackConstraintSpec,
    )

    def _clique(name, replicas, starts_after=()):
        return PodCliqueTemplateSpec(
            name=name,
            spec=PodCliqueSpec(
                replicas=replicas,
                starts_after=list(starts_after),
                pod_spec=PodSpec(
                    containers=[
                        Container(name="main", resources={"cpu": 1.0})
                    ]
                ),
            ),
        )

    return PodCliqueSet(
        metadata=ObjectMeta(name="chaos"),
        spec=PodCliqueSetSpec(
            replicas=2,
            template=PodCliqueSetTemplateSpec(
                topology_constraint=(
                    TopologyConstraintSpec(
                        pack_constraint=TopologyPackConstraintSpec(
                            required="rack"
                        )
                    )
                    if hierarchical else None
                ),
                cliques=[
                    _clique("fe", 2),
                    _clique("be", 3, starts_after=["fe"]),
                ],
                pod_clique_scaling_group_configs=[
                    PodCliqueScalingGroupConfig(
                        name="g", clique_names=["be"],
                        replicas=2, min_available=1,
                        scale_config=(
                            AutoScalingConfig(
                                min_replicas=1, max_replicas=4,
                                target_utilization=0.7,
                            )
                            if scaled else None
                        ),
                    )
                ],
                startup_type="CliqueStartupTypeExplicit",
            ),
        ),
    )


#: tenancy config for --tenant-skew sweeps: two tenants with tight burst
#: ceilings so the injected skew bursts actually cross the admission
#: bands (some of the load sheds with QuotaExceeded and must recover to
#: the fault-free fixpoint once the skew leaves at disarm)
TENANT_SKEW_CONFIG = {
    "tenancy": {
        "enabled": True,
        "tenants": [
            {"name": "skew-a", "guaranteed": {"cpu": 2.0},
             "burst": {"cpu": 6.0}},
            {"name": "skew-b", "guaranteed": {"cpu": 2.0},
             "burst": {"cpu": 6.0}},
        ],
    }
}


#: serving config for --serving sweeps: a FLAT trace (base == peak,
#: noise 0) so the autoscaler fixpoint is time-invariant — the chaotic
#: run's injected spikes scale the fleet up mid-storm, and at disarm the
#: drain must bring it back to exactly the fault-free equilibrium
#: (PCSG replicas 3 at these numbers: 126 rps over 2 PCS replicas x
#: 3 PCSG replicas x 3 be-pods x 10 rps/pod = 0.7 utilization, on
#: target). Short stabilization window so the sweep drains fast.
SERVING_CONFIG = {
    "serving": {
        "enabled": True,
        "trace": {"base_rps": 126.0, "peak_rps": 126.0, "noise": 0.0},
        "workloads": [
            {"clique": "be", "shape": "decode", "rps_per_replica": 10.0,
             "demand_fraction": 1.0},
        ],
    },
    "autoscaler": {
        "sync_interval_seconds": 10.0,
        "scale_down_stabilization_seconds": 30.0,
    },
}


#: durability config for --durability sweeps: aggressive snapshot cadence
#: so crashes land on every recovery path (fresh WAL tail, snapshot +
#: replay, post-checkpoint generations). fsync "never" deliberately: the
#: sim never kills the interpreter, so physical-durability tears are
#: injected explicitly (wal_torn_write), and skipping fsync keeps the
#: sweep fast on CI disks.
DURABILITY_CONFIG = {
    "fsync": "never",
    "snapshot_interval_seconds": 30.0,
    "wal_max_bytes": 262144,
}


#: replication config for --replication sweeps: the log-shipping
#: standby in SEMI-SYNC (the zero-loss mode — every commit ships before
#: it returns), on top of the --durability axis. standby_wal_dir is
#: filled in per seed next to the leader's wal_dir.
REPLICATION_CONFIG = {
    "enabled": True,
    "ack_mode": "semi-sync",
}


#: solver config for --hierarchical sweeps: the min-nodes forced-flat
#: threshold dropped to 0 so the two-level solve engages on the sweep's
#: small clusters (the workload adds the rack confinement it needs)
HIERARCHICAL_CONFIG = {"solver": {"hierarchical_min_nodes": 0}}


#: defrag config for --defrag sweeps: a tight sweep cadence so the
#: chaotic maybe_defrag loop actually fires between fault steps, a
#: small per-sweep move cap (bounded disruption mid-storm), and a rate
#: ceiling generous enough that storms are bounded by budgets/gain, not
#: silently by the rate limiter
DEFRAG_CONFIG = {
    "defrag": {
        "enabled": True,
        "sync_interval_seconds": 20.0,
        "min_score_gain": 0.05,
        "max_moves_per_sweep": 2,
        "max_evictions_per_hour": 240.0,
    }
}


#: stream config for --stream sweeps: the streaming admission front with
#: a queue cap SMALLER than one injected burst storm (20 gangs) so a
#: storm actually crosses the overflow + brownout ladder and sheds with
#: structured DeadlineExceeded, a small batch size so micro-batch
#: windows are on the fault path, and a readmit floor low enough that
#: shed workload gangs re-enter only once the storm drains at disarm
STREAM_CONFIG = {
    "stream": {
        "enabled": True,
        "slo_seconds": 20.0,
        "window_min_seconds": 0.25,
        "window_max_seconds": 2.0,
        "max_batch_gangs": 4,
        "queue_cap_gangs": 12,
        "brownout_depth_fraction": 0.5,
        "readmit_depth_fraction": 0.25,
    }
}


#: SLO config for --slo sweeps: the continuous evaluator swept on a
#: cadence TIGHTER than the fault plan's 2-second steps aggregate (4s =
#: every other step), with window pairs scaled to the 80-virtual-second
#: storm so a single bad sweep trips pending and the next confirming
#: sweep fires — alerts must fire DURING the fault window, and the
#: short windows must forget the fault within a few clean sweeps so
#: resolution lands during the post-settle drain. Objectives cover the
#: burst_storm/tenant_skew shed path, the backlog starvation path, and
#: the promote_standby/process-crash failover path.
SLO_CONFIG = {
    "slo": {
        "enabled": True,
        "sync_interval_seconds": 4.0,
        "budget_window_seconds": 600.0,
        "page_short_seconds": 8.0,
        "page_long_seconds": 24.0,
        "page_burn_threshold": 5.0,
        "ticket_short_seconds": 24.0,
        "ticket_long_seconds": 80.0,
        "ticket_burn_threshold": 2.0,
        "objectives": [
            {"name": "bind-p99", "kind": "bind_latency_p99",
             "target": 0.98, "threshold_seconds": 30.0,
             "per_tenant": True},
            {"name": "shed-rate", "kind": "shed_rate",
             "target": 0.98, "ceiling_per_second": 0.25},
            {"name": "starvation", "kind": "starvation",
             "target": 0.98, "max_starved_seconds": 30.0},
            {"name": "placement-drift", "kind": "placement_drift",
             "target": 0.95, "band": 0.4},
            {"name": "failover-wall", "kind": "failover_wall",
             "target": 0.98, "max_failovers": 0},
        ],
    }
}


#: federation config for --federation sweeps: a 3-member federation with
#: a SHORT outage window (a seeded cluster_partition of a few 2-second
#: steps can outlive it, so the healed-zombie fence path is actually on
#: the sweep's fault path) and a drain window generous enough that
#: pacing — not the deadline — bounds the failover. wal_dir is filled in
#: per seed (each member + the coordinator journal get subdirectories).
FEDERATION_CONFIG = {
    "federation": {
        "enabled": True,
        "clusters": 3,
        "heartbeat_interval_seconds": 2.0,
        "outage_detection_window_seconds": 12.0,
        "drain_window_seconds": 400.0,
        "drain_max_gangs_per_round": 4,
    }
}


def run_seed(seed: int, nodes: int, baseline: dict,
             trace_dir: Path | None = None,
             explain_dir: Path | None = None,
             tenant_skew: bool = False,
             shards: int = 1,
             durability: bool = False,
             partitions: int = 1,
             replication: bool = False,
             serving: bool = False,
             hierarchical: bool = False,
             defrag: bool = False,
             stream: bool = False,
             slo: bool = False,
             device=None) -> dict:
    overrides = {"tenant_skew_rate": 0.35} if tenant_skew else {}
    if stream:
        # the streaming-admission fault axis: seeded ~10x burst storms
        # (the front must shed with structured DeadlineExceeded, never
        # wedge; the storm load leaves at disarm and shed workload gangs
        # re-admit) and arrival stalls (budgets burn through the hold —
        # the stall ends in a batched admit or a deadline shed)
        overrides.update(
            burst_storm_rate=0.3,
            arrival_stall_rate=0.15,
        )
    if replication:
        # the HA-replication fault axis: standby tailing stalls
        # (semi-sync degrades for the window, must catch up), mid-plan
        # failovers (promote + manager rebuild + re-armed standby),
        # dual-leader fence proofs (the deposed log's append must be
        # refused or the seed fails), standby crashes re-seeding from
        # the leader's snapshots
        overrides.update(
            replication_stall_rate=0.2,
            standby_promotion_rate=0.08,
            dual_leader_rate=0.06,
            standby_crash_rate=0.1,
        )
    if defrag:
        # the continuous-defragmentation fault axis: forced migration
        # storms (stage + evict waves mid-chaos), crashes right after a
        # storm (tickets are soft state; evicted gangs must still
        # re-place), and destination-node faults before the re-bind —
        # with the disruption-budget audit armed throughout
        overrides.update(
            migration_storm_rate=0.3,
            migration_crash_rate=0.25,
            migration_node_fault_rate=0.3,
        )
    if serving:
        # the elastic-serving fault axis: seeded traffic spikes onto the
        # flat trace (the HPA loop scales up mid-storm and must
        # stabilize back down after disarm) + metrics-pipeline dropouts
        # (stale samples must HOLD the fleet, never collapse it)
        overrides.update(
            traffic_spike_rate=0.3,
            metrics_dropout_rate=0.25,
        )
    wal_tmp = None
    if durability:
        # the durable-store fault axis: whole-process crashes recovering
        # from disk mid-plan, torn WAL tails, corrupted snapshots, disk
        # stalls — convergence is still checked against the same
        # fault-free fixpoint (recovery must be workload-invisible)
        overrides.update(
            process_crash_rate=0.12,
            wal_torn_write_rate=0.4,
            snapshot_corruption_rate=0.3,
            disk_stall_rate=0.1,
        )
        if partitions > 1:
            # the partitioned-WAL fault axis on top: crashes with ONE
            # partition's tail torn (divergent streams merged back at
            # recovery) and per-partition disk stalls (one partition's
            # snapshot cadence defers while the others keep theirs)
            overrides.update(
                partition_divergence_rate=0.2,
                partition_stall_rate=0.15,
            )
        import tempfile

        wal_tmp = tempfile.TemporaryDirectory(prefix=f"grove-wal-{seed}-")
    if shards > 1:
        # the shard-failover axis: worker crashes, frozen map views,
        # handoff storms — convergence is still checked against the
        # SINGLE-replica fault-free fixpoint (sharding must be
        # workload-invisible), with the ownership audit armed
        overrides.update(
            shard_crash_rate=0.1,
            shard_map_stale_rate=0.1,
            handoff_storm_rate=0.08,
        )
    plan = FaultPlan.from_seed(seed, **overrides)
    trace_path = (
        str(trace_dir / f"seed-{seed}-flight.json")
        if trace_dir is not None else None
    )
    config = dict(TENANT_SKEW_CONFIG) if tenant_skew else {}
    if serving:
        config = {**config, **SERVING_CONFIG}
    if hierarchical:
        config = {**config, **HIERARCHICAL_CONFIG}
    if defrag:
        config = {**config, **DEFRAG_CONFIG}
    if stream:
        config = {**config, **STREAM_CONFIG}
    if slo:
        # evaluation-only: the engine's Events ride the raw store (zero
        # fault-plan draws), so composing --slo changes no seed's
        # workload trajectory — the shared fault-free baseline holds
        config = {**config, **SLO_CONFIG}
    if shards > 1:
        config = {**config, "controllers": {"shards": shards}}
    if wal_tmp is not None:
        config = {
            **config,
            "durability": {
                **DURABILITY_CONFIG,
                "wal_dir": str(Path(wal_tmp.name) / "wal"),
                "partitions": max(partitions, 1),
            },
        }
        if replication:
            config = {
                **config,
                "replication": {
                    **REPLICATION_CONFIG,
                    "standby_wal_dir": str(Path(wal_tmp.name) / "standby"),
                },
            }
    try:
        return _run_seed_inner(
            seed, nodes, baseline, plan, config, trace_path,
            explain_dir, durability, serving, hierarchical, defrag,
            replication, stream, slo, tenant_skew, device,
        )
    finally:
        # exception-safe: a seed that raises out of harness construction
        # or the dump paths must not leak its per-seed WAL dir across a
        # multi-seed CI sweep
        if wal_tmp is not None:
            wal_tmp.cleanup()


def _run_seed_inner(seed, nodes, baseline, plan, config, trace_path,
                    explain_dir, durability, serving=False,
                    hierarchical=False, defrag=False,
                    replication=False, stream=False, slo=False,
                    tenant_skew=False, device=None) -> dict:
    ch = ChaosHarness(
        plan, nodes=make_nodes(nodes), trace_path=trace_path,
        config=config or None, device=device,
    )
    # silence the expected fault-storm error logs (with_name children
    # copy the stream at creation, so the manager's logger needs its own
    # reassignment; restarted managers inherit the cluster logger's)
    quiet = io.StringIO()
    ch.harness.cluster.logger.stream = quiet
    ch.harness.manager.logger.stream = quiet
    ch.harness.scheduler.log.stream = quiet
    ch.harness.defrag.log.stream = quiet
    for w in getattr(ch.harness.manager, "workers", ()):
        w.manager.logger.stream = quiet
        w.components["scheduler"].log.stream = quiet
        w.components["defrag"].log.stream = quiet
    t0 = time.perf_counter()
    error = None
    try:
        ch.apply(sweep_workload(scaled=serving, hierarchical=hierarchical))
        if serving:
            # reach the traffic-driven equilibrium BEFORE the storm, the
            # same way the baseline does — chaos then measures recovery
            # back to it, not initial convergence under fire
            ch.settle()
            for _ in range(4):
                ch.harness.advance(11.0)
                ch.harness.autoscale()
        ch.run_chaos()
        fingerprint_ok = settled_fingerprint(ch.raw_store) == baseline
        violations = check_invariants(ch.raw_store)
    except Exception as exc:  # a non-converging seed must not stop the sweep
        fingerprint_ok, violations = False, []
        error = f"{type(exc).__name__}: {exc}"
    ok = fingerprint_ok and not violations and error is None
    result = {
        "seed": seed,
        "ok": ok,
        "fingerprint_match": fingerprint_ok,
        "invariant_violations": violations,
        "error": error,
        "faults_injected": dict(sorted(plan.counts.items())),
        "manager_restarts": ch.manager_restarts,
        "wall_seconds": round(time.perf_counter() - t0, 3),
    }
    if durability:
        result["process_restarts"] = ch.process_restarts
        result["recovery_outcomes"] = [
            s["outcome"] for s in ch.recovery_stats
        ]
    if stream:
        front = getattr(ch.harness.scheduler, "stream", None)
        metrics = ch.harness.cluster.metrics
        result["stream_queue_depth_at_settle"] = (
            front.queue_depth() if front is not None else None
        )
        result["stream_shed_registry_at_settle"] = (
            front.shed_registry_size() if front is not None else None
        )
        result["stream_sheds"] = metrics.counter(
            "grove_stream_shed_total", "gangs shed by the streaming front"
        ).total()
        if error is None and (
            front is None or front.queue_depth() != 0
        ):
            # a drained settle with waiters still parked is a wedged
            # queue — exactly what the storm axis exists to catch
            result["ok"] = False
            result["error"] = (
                "stream queue not drained at settle (depth="
                f"{None if front is None else front.queue_depth()})"
            )
    if slo:
        engine = ch.harness.cluster.slo
        # capture BEFORE the resolve drain: these transitions happened
        # while the plan was armed — the fire-during-fault half of the
        # lifecycle invariant
        fired = [
            h for h in engine.history if h["to"] == "firing"
        ] if engine is not None else []
        sync = SLO_CONFIG["slo"]["sync_interval_seconds"]
        if engine is not None and error is None:
            # resolve drain: the faults are gone and the workload is
            # settled, so every firing alert's short window must forget
            # the storm within a bounded number of clean sweeps
            for _ in range(80):
                if not engine.firing():
                    break
                ch.harness.advance(sync)
                ch.harness.maybe_slo_sweep()
        still_firing = engine.firing() if engine is not None else []
        result["slo"] = {
            "alerts_fired": len(fired),
            "slos_fired": sorted({
                (h["slo"], h["tenant"] or "") for h in fired
            }),
            "firing_after_settle": len(still_firing),
            "transitions": len(engine.history) if engine is not None else 0,
        }
        # the scorecard itself is the CI artifact (--scorecard pops it
        # into one JSON per sweep); keep the per-seed result line lean
        result["slo_scorecard"] = (
            engine.scorecard() if engine is not None else {"enabled": False}
        )
        if error is None and engine is None:
            result["ok"] = False
            result["error"] = "slo: engine missing despite --slo config"
        elif error is None and (stream or tenant_skew) and not fired:
            # the storm axes shed/starve by construction — a sweep where
            # no alert ever fired means the evaluator missed the fault
            result["ok"] = False
            result["error"] = "slo: no alert fired during the fault phase"
        elif error is None and still_firing:
            result["ok"] = False
            result["error"] = (
                "slo: alerts still firing after settle: "
                + ", ".join(
                    f"{a['slo']}"
                    + (f"[{a['tenant']}]" if a["tenant"] else "")
                    + f"/{a['severity']}"
                    for a in still_firing
                )
            )
    if replication:
        result["standby_promotions"] = ch.standby_promotions
        standby = ch.harness.cluster.standby
        # the settled standby must have converged to the leader's
        # committed head — a lagging settle is a replication failure
        # even when the workload fingerprint matches
        lag = standby.lag_records() if standby is not None else None
        result["standby_lag_at_settle"] = lag
        if error is None and (standby is None or lag != 0):
            result["ok"] = False
            result["error"] = (
                f"standby not converged at settle (lag={lag})"
            )
    if not ok and trace_path is not None:
        # every failure class leaves the postmortem, not just the wedged
        # settle that settle_recovered auto-dumps (a diverged fingerprint
        # settles fine — the flight ring is how you see WHY it diverged)
        ch.dump_flight(trace_path)
        result["flight_dump"] = trace_path
    if explain_dir is not None:
        # placement-decision dump for every gang UNSCHEDULED at settle —
        # written for passing seeds too (a gang can settle unscheduled
        # legally); render with python -m grove_tpu_torch.observability.explain
        try:
            explain_path = str(explain_dir / f"seed-{seed}-explain.json")
            if ch.dump_explain(explain_path) is not None:
                result["explain_dump"] = explain_path
        except Exception as exc:  # never fail the sweep on the dump
            result["explain_error"] = f"{type(exc).__name__}: {exc}"
    return result


def run_aggregate_ab(seed: int, nodes: int, stream: bool = False,
                     device=None) -> dict:
    """One seed run TWICE — full-ring tracing vs `tracing.mode:
    aggregate` — asserting the always-on mode is bit-identical: same
    settled workload fingerprint and the exact same fault-plan draw
    counts (the causal ledger and critical-path folder do no store
    writes and consume no RNG, so enabling them may not perturb a single
    decision). The CI streaming-chaos smoke runs this on pre-existing
    seeds."""
    overrides: dict = {}
    config: dict = {}
    if stream:
        overrides.update(burst_storm_rate=0.3, arrival_stall_rate=0.15)
        config.update(STREAM_CONFIG)

    def once(mode: str):
        plan = FaultPlan.from_seed(seed, **overrides)
        cfg = {**config, "tracing": {"enabled": True, "mode": mode}}
        ch = ChaosHarness(plan, nodes=make_nodes(nodes), config=cfg,
                          device=device)
        quiet_io = io.StringIO()
        ch.harness.cluster.logger.stream = quiet_io
        ch.harness.manager.logger.stream = quiet_io
        ch.harness.scheduler.log.stream = quiet_io
        ch.harness.defrag.log.stream = quiet_io
        ch.apply(sweep_workload())
        ch.run_chaos()
        return (
            settled_fingerprint(ch.raw_store),
            dict(sorted(plan.counts.items())),
            ch.harness.cluster.tracer.mode,
        )

    t0 = time.perf_counter()
    error = None
    fp_same = draws_same = False
    counts: dict = {}
    try:
        fp_full, draws_full, mode_full = once("full")
        fp_agg, draws_agg, mode_agg = once("aggregate")
        assert mode_full == "full" and mode_agg == "aggregate"
        fp_same = fp_full == fp_agg
        draws_same = draws_full == draws_agg
        counts = draws_full
    except Exception as exc:  # a failing seed must not stop the sweep
        error = f"{type(exc).__name__}: {exc}"
    return {
        "seed": seed,
        "ok": fp_same and draws_same and error is None,
        "fingerprint_identical": fp_same,
        "fault_draws_identical": draws_same,
        "faults_injected": counts,
        "error": error,
        "wall_seconds": round(time.perf_counter() - t0, 3),
    }


def federation_workload() -> list:
    """The federation sweep's workload: a fan of independent gangs (one
    routing decision each) across two namespaces — enough of them that a
    whole member's committed set is a real drain, small enough that a
    3-member sweep stays CI-sized."""
    from ..api.meta import ObjectMeta
    from ..api.types import (
        Container,
        PodCliqueSet,
        PodCliqueSetSpec,
        PodCliqueSetTemplateSpec,
        PodCliqueSpec,
        PodCliqueTemplateSpec,
        PodSpec,
    )

    return [
        PodCliqueSet(
            metadata=ObjectMeta(
                name=f"fed-{j}",
                namespace="team-a" if j % 2 else "team-b",
            ),
            spec=PodCliqueSetSpec(
                replicas=1,
                template=PodCliqueSetTemplateSpec(
                    cliques=[
                        PodCliqueTemplateSpec(
                            name="w",
                            spec=PodCliqueSpec(
                                replicas=4,
                                pod_spec=PodSpec(
                                    containers=[
                                        Container(
                                            name="m",
                                            resources={"cpu": 1.0},
                                        )
                                    ]
                                ),
                            ),
                        )
                    ]
                ),
            ),
        )
        for j in range(9)
    ]


def _build_federation(nodes: int, wal_root: str, device=None):
    from ..cluster import make_nodes as _mk
    from ..federation import FederationCoordinator

    config = {
        **FEDERATION_CONFIG,
        "durability": {
            **DURABILITY_CONFIG,
            "wal_dir": str(Path(wal_root) / "wal"),
        },
    }
    fed = FederationCoordinator(
        config,
        [_mk(nodes, name_prefix=f"c{i}-n") for i in range(3)],
        device=device,
    )
    quiet = io.StringIO()
    for cell in fed.cells:
        cell.harness.cluster.logger.stream = quiet
        cell.harness.manager.logger.stream = quiet
        cell.harness.scheduler.log.stream = quiet
        cell.harness.defrag.log.stream = quiet
    return fed


def federation_baseline(nodes: int, device=None) -> dict:
    """The fault-free federation fixpoint the chaotic runs must converge
    back to (merged survivor-side workload fingerprint)."""
    import tempfile

    from ..chaos import federation_fingerprint

    with tempfile.TemporaryDirectory(prefix="grove-fed-base-") as td:
        fed = _build_federation(nodes, td, device)
        try:
            for pcs in federation_workload():
                fed.apply(pcs)
            fed.settle()
            for _ in range(4):
                fed.advance(2.0)
            return federation_fingerprint(fed)
        finally:
            fed.close()


def run_federation_seed(seed: int, nodes: int, baseline: dict,
                        trace_dir: Path | None = None,
                        explain_dir: Path | None = None,
                        device=None) -> dict:
    """One seeded federation chaos run: whole-cluster outage, cluster
    partitions and coordinator crashes over the 3-member harness, judged
    against the fault-free federation fixpoint. The three federation
    rates are fixed (not mix-scaled): they are the only draws this
    driver makes, so every seed exercises the failover machinery."""
    import tempfile

    from ..chaos import FederationChaos

    plan = FaultPlan(
        seed=seed,
        cluster_outage_rate=0.1,
        cluster_partition_rate=0.08,
        coordinator_crash_rate=0.05,
        chaos_steps=40,
        step_seconds=2.0,
    )
    t0 = time.perf_counter()
    error = None
    post: dict = {}
    fed = None
    with tempfile.TemporaryDirectory(prefix=f"grove-fed-{seed}-") as td:
        try:
            fed = _build_federation(nodes, td, device)
            post = FederationChaos(plan, fed).run(federation_workload())
        except Exception as exc:  # a failing seed must not stop the sweep
            error = f"{type(exc).__name__}: {exc}"
        finally:
            if fed is not None:
                fed.close()
    fingerprint_ok = bool(post) and post["fingerprint"] == baseline
    violations = post.get("invariant_violations", [])
    ok = fingerprint_ok and not violations and error is None
    result = {
        "seed": seed,
        "ok": ok,
        "fingerprint_match": fingerprint_ok,
        "invariant_violations": violations,
        "error": error,
        "faults_injected": dict(sorted(plan.counts.items())),
        "fence_proofs": post.get("fence_proofs", 0),
        "coordinator_crashes": post.get("coordinator_crashes", 0),
        "outage_cluster": post.get("outage_cluster"),
        "cluster_states": post.get("cluster_states", {}),
        "wall_seconds": round(time.perf_counter() - t0, 3),
    }
    outage = post.get("outage")
    if outage is not None and post.get("drained_at") is not None:
        result["drain_seconds"] = round(
            post["drained_at"] - outage["declared_at"], 3
        )
    if not ok and trace_dir is not None:
        # the federation postmortem: per-member lifecycle + routing
        # verdicts + the wedged set, the global-layer analog of the
        # flight-recorder dump
        trace_path = str(trace_dir / f"seed-{seed}-federation-flight.json")
        with open(trace_path, "w") as fh:
            json.dump(post, fh, indent=2, default=str)
            fh.write("\n")
        result["flight_dump"] = trace_path
    if explain_dir is not None and post.get("wedged", {}).get("wedged"):
        explain_path = str(
            explain_dir / f"seed-{seed}-federation-explain.json"
        )
        with open(explain_path, "w") as fh:
            json.dump(post["wedged"], fh, indent=2, default=str)
            fh.write("\n")
        result["explain_dump"] = explain_path
    return result


#: the sweep's fault families, each as the flags that select it (with
#: `--seeds`, `--start` and `--nodes` left to the caller): the default
#: matrix and every fault axis
FAMILIES = {
    "default": [],
    "shards": ["--shards", "4"],
    "durability": ["--durability"],
    "partitions": ["--durability", "--partitions", "4"],
    "replication": ["--durability", "--replication"],
    "serving": ["--serving"],
    "hierarchical": ["--hierarchical"],
    "defrag": ["--defrag"],
    "tenant-skew": ["--tenant-skew"],
    "stream-slo": ["--stream", "--slo"],
    "aggregate-ab": ["--aggregate-ab", "--stream"],
    "federation": ["--federation"],
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=60,
                    help="number of seeds to sweep (default 60)")
    ap.add_argument("--start", type=int, default=0,
                    help="first seed (default 0)")
    ap.add_argument("--nodes", type=int, default=24,
                    help="cluster size (default 24)")
    ap.add_argument("--json", dest="json_path", default=None,
                    metavar="PATH",
                    help="also write the full sweep matrix (per-seed "
                         "results + summary) as one JSON document — the "
                         "CI artifact format")
    ap.add_argument("--trace-dir", dest="trace_dir", default=None,
                    metavar="DIR",
                    help="write a flight-recorder postmortem "
                         "(seed-N-flight.json: recent spans + errors + "
                         "events + the wedged-object summary) for every "
                         "FAILING seed; open with python -m "
                         "grove_tpu_torch.observability.trace")
    ap.add_argument("--explain-dir", dest="explain_dir", default=None,
                    metavar="DIR",
                    help="write a placement-decision dump "
                         "(seed-N-explain.json: reason codes + "
                         "elimination funnels + preemption audits) for "
                         "every seed that settles with unscheduled "
                         "gangs; render with python -m "
                         "grove_tpu_torch.observability.explain")
    ap.add_argument("--shards", type=int, default=1,
                    help="run the control plane horizontally sharded "
                         "across N worker replicas (default 1 = classic "
                         "single manager) and add the shard-failover "
                         "fault axis: seeded worker crashes (shards must "
                         "fail over within one lease duration), frozen "
                         "shard-map views, and handoff storms; "
                         "convergence is checked against the "
                         "single-replica fault-free fixpoint with the "
                         "ownership audit armed")
    ap.add_argument("--durability", action="store_true",
                    help="arm the durable-store fault axis: the harness "
                         "runs with a write-ahead-logged store "
                         "(per-seed temp wal_dir) and the plan adds "
                         "seeded whole-process crashes that recover "
                         "from disk mid-plan (snapshot + WAL replay, "
                         "soft state re-derived), torn WAL tails, "
                         "corrupted snapshots (recovery falls back to "
                         "the previous retained generation), and disk "
                         "stalls; convergence is checked against the "
                         "same fault-free fixpoint. Composable with "
                         "--shards N (whole-fleet process crashes "
                         "recover the sharded control plane from disk "
                         "mid-plan) and --partitions K")
    ap.add_argument("--partitions", type=int, default=1,
                    help="with --durability: run the durable store "
                         "PARTITIONED into K per-(namespace, kind) WAL/"
                         "snapshot chains (cluster/durability."
                         "PartitionedLog) and add the partition-scoped "
                         "fault axis — crashes with one partition's "
                         "tail torn (divergent streams merged back at "
                         "recovery) and per-partition disk stalls; "
                         "1 = the classic single WAL")
    ap.add_argument("--replication", action="store_true",
                    help="with --durability: arm the HA-replication "
                         "fault axis — the store runs with a SEMI-SYNC "
                         "log-shipping standby (cluster/replication.py) "
                         "and the plan adds seeded tailer stalls (lag "
                         "grows, semi-sync degrades for the window, "
                         "catch-up at stall end), mid-plan standby "
                         "promotions (the control plane fails over to "
                         "the promoted store and a fresh standby "
                         "re-arms), dual-leader fence proofs (the "
                         "deposed leader's append must be refused and "
                         "its WAL directory byte-unchanged, else the "
                         "seed fails), and standby crashes re-seeding "
                         "from the leader's snapshots; convergence is "
                         "checked against the same fault-free fixpoint "
                         "and the standby must end the run caught up")
    ap.add_argument("--serving", action="store_true",
                    help="arm the elastic-serving fault axis: serving is "
                         "configured with a FLAT traffic trace feeding "
                         "the kubelet->aggregation->HPA metrics "
                         "pipeline, the scaling group gets an HPA, and "
                         "the plan adds seeded traffic spikes (the loop "
                         "must scale up and stabilize back down after "
                         "disarm) and metrics-pipeline dropouts (stale "
                         "samples must never drive scale-down); "
                         "convergence is checked against the fault-free "
                         "traffic-driven equilibrium")
    ap.add_argument("--hierarchical", action="store_true",
                    help="run the placement engine's HIERARCHICAL "
                         "two-level solve under fire: the workload gains "
                         "a rack-level pack constraint (confinement) and "
                         "the solver's forced-flat min-nodes threshold "
                         "drops to 0, so every solve takes the coarse "
                         "domain-level pruning + per-domain sub-engine "
                         "path — node faults/cordons land between dirty "
                         "ticks and must ride the shard rebind path, "
                         "never a stale re-score; convergence is checked "
                         "against the fault-free fixpoint under the SAME "
                         "config")
    ap.add_argument("--defrag", action="store_true",
                    help="arm the continuous-defragmentation fault axis: "
                         "defrag is enabled on a tight sweep cadence and "
                         "the plan adds seeded migration storms (forced "
                         "relaxed-threshold sweeps: stage + evict waves "
                         "mid-chaos), crashes right after a storm "
                         "(migration tickets are soft state; evicted "
                         "gangs must still re-place through the general "
                         "solve), and destination-node faults before the "
                         "re-bind — with the disruption-budget audit "
                         "armed; convergence is checked against the "
                         "fault-free fixpoint (migrations move gangs, "
                         "and node assignment is outside the "
                         "fingerprint by contract)")
    ap.add_argument("--tenant-skew", dest="tenant_skew",
                    action="store_true",
                    help="enable tenant-skew load faults: tenancy "
                         "(quota admission + DRF fairness) is configured "
                         "with two tight-burst tenants, and seeded skew "
                         "bursts land in one tenant's namespace per "
                         "fault (some shed with QuotaExceeded); the "
                         "skew leaves at disarm, so convergence is "
                         "checked against the same fault-free fixpoint")
    ap.add_argument("--stream", action="store_true",
                    help="arm the streaming-admission fault axis: the "
                         "scheduler runs the continuous admission front "
                         "(SLO deadline budgets, micro-batch windows, "
                         "backpressure + brownout shedding; "
                         "grove_tpu_torch/streaming) and the plan adds seeded "
                         "~10x burst storms (the front must shed with "
                         "structured DeadlineExceeded, never wedge; the "
                         "storm load leaves at disarm and shed workload "
                         "gangs re-admit once the queue drains) and "
                         "arrival stalls (deadline budgets burn through "
                         "the hold); convergence is checked against the "
                         "fault-free fixpoint under the SAME config and "
                         "the queue must end the run drained")
    ap.add_argument("--slo", action="store_true",
                    help="run the continuous SLO evaluator "
                         "(observability/slo.py) through every storm on "
                         "a tight sweep cadence and make the alert "
                         "lifecycle a per-seed invariant: with a storm "
                         "axis armed (--stream / --tenant-skew) at "
                         "least one alert must transition "
                         "pending->firing DURING the fault, and every "
                         "firing alert must resolve within a bounded "
                         "post-settle drain. Evaluation consumes zero "
                         "fault-plan draws (Events ride the raw store), "
                         "so seeds replay bit-identically with or "
                         "without it")
    ap.add_argument("--scorecard", dest="scorecard_path", default=None,
                    metavar="PATH",
                    help="with --slo: write every seed's final SLO "
                         "scorecard as one JSON document "
                         "({'seeds': {seed: card}}) — the CI artifact; "
                         "render with python -m "
                         "grove_tpu_torch.observability.slo")
    ap.add_argument("--aggregate-ab", dest="aggregate_ab",
                    action="store_true",
                    help="sweep the ALWAYS-ON TRACING bit-identity "
                         "contract instead of the convergence matrix: "
                         "each seed runs twice — full-ring tracing vs "
                         "tracing.mode aggregate — and must produce the "
                         "same settled workload fingerprint with the "
                         "exact same fault-plan draw counts (the causal "
                         "ledger and critical-path folder do no store "
                         "writes and consume no RNG). Composes with "
                         "--stream (the CI streaming-chaos smoke) but "
                         "not with the other single-cluster axes")
    ap.add_argument("--federation", action="store_true",
                    help="sweep the FEDERATION fault axis instead of the "
                         "single-cluster matrix: a 3-member federation "
                         "(grove_tpu_torch/federation, per-seed temp WAL "
                         "dirs, durability always on) under seeded "
                         "whole-cluster outages (declare + fence + "
                         "drain into survivors, the zombie append "
                         "refused and its directory byte-unchanged), "
                         "cluster partitions (short blips must NOT "
                         "fail over; ones outliving the window must), "
                         "and coordinator crashes (routing state "
                         "rebuilt from the durable journal); "
                         "convergence is checked against a fault-free "
                         "federation fixpoint. Standalone — not "
                         "composable with the single-cluster axes")
    ap.add_argument("--device", default="cuda",
                    help="the device every harness's engines run on: cuda "
                         "(the card; raises without one) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)  # no CUDA and no --device cpu: raises
    device = args.device
    if args.federation and (
        args.durability or args.replication or args.shards > 1
        or args.serving or args.hierarchical or args.defrag
        or args.tenant_skew or args.stream
    ):
        ap.error("--federation is its own sweep axis (every member "
                 "already runs durable); it does not compose with the "
                 "single-cluster axes")
    if args.partitions > 1 and not args.durability:
        ap.error("--partitions requires --durability (there is no WAL "
                 "to partition without it)")
    if args.replication and not args.durability:
        ap.error("--replication requires --durability (the standby "
                 "tails the leader's WAL stream)")
    if args.aggregate_ab and (
        args.federation or args.durability or args.replication
        or args.shards > 1 or args.serving or args.hierarchical
        or args.defrag or args.tenant_skew or args.slo
    ):
        ap.error("--aggregate-ab composes only with --stream (it is an "
                 "A/B of the SAME run, not another fault axis)")
    trace_dir = None
    if args.trace_dir:
        trace_dir = Path(args.trace_dir)
        trace_dir.mkdir(parents=True, exist_ok=True)
    explain_dir = None
    if args.explain_dir:
        explain_dir = Path(args.explain_dir)
        explain_dir.mkdir(parents=True, exist_ok=True)

    if args.aggregate_ab:
        results = []
        failed = []
        for seed in range(args.start, args.start + args.seeds):
            result = run_aggregate_ab(seed, args.nodes,
                                      stream=args.stream, device=device)
            print(json.dumps(result), flush=True)
            results.append(result)
            if not result["ok"]:
                failed.append(seed)
        summary = {
            "swept": args.seeds,
            "start": args.start,
            "nodes": args.nodes,
            "aggregate_ab": True,
            "stream": args.stream,
            "failed_seeds": failed,
            "ok": not failed,
        }
        print(json.dumps(summary), flush=True)
        if args.json_path:
            with open(args.json_path, "w") as fh:
                json.dump(
                    {"summary": summary, "results": results}, fh, indent=2
                )
                fh.write("\n")
        return 1 if failed else 0

    if args.federation:
        baseline = federation_baseline(args.nodes, device)
        results = []
        failed = []
        for seed in range(args.start, args.start + args.seeds):
            result = run_federation_seed(
                seed, args.nodes, baseline,
                trace_dir=trace_dir, explain_dir=explain_dir,
                device=device,
            )
            print(json.dumps(result), flush=True)
            results.append(result)
            if not result["ok"]:
                failed.append(seed)
        summary = {
            "swept": args.seeds,
            "start": args.start,
            "nodes": args.nodes,
            "federation": True,
            "failed_seeds": failed,
            "ok": not failed,
        }
        print(json.dumps(summary), flush=True)
        if args.json_path:
            with open(args.json_path, "w") as fh:
                json.dump(
                    {"summary": summary, "results": results}, fh, indent=2
                )
                fh.write("\n")
        return 1 if failed else 0

    # the baseline fixpoint must be computed under the SAME config the
    # chaos runs use (tenancy changes PodGang defaulting) — but always
    # SINGLE-replica: the sharded runs must converge to the same
    # workload state a lone manager reaches (sharding is
    # workload-invisible by contract)
    baseline_config = dict(TENANT_SKEW_CONFIG) if args.tenant_skew else {}
    if args.serving:
        baseline_config = {**baseline_config, **SERVING_CONFIG}
    if args.hierarchical:
        baseline_config = {**baseline_config, **HIERARCHICAL_CONFIG}
    if args.defrag:
        baseline_config = {**baseline_config, **DEFRAG_CONFIG}
    if args.stream:
        baseline_config = {**baseline_config, **STREAM_CONFIG}
    baseline_h = Harness(
        nodes=make_nodes(args.nodes),
        config=baseline_config or None,
        device=device,
    )
    baseline_h.apply(sweep_workload(scaled=args.serving,
                                    hierarchical=args.hierarchical))
    baseline_h.settle()
    if args.stream:
        # the streaming front parks sub-batch arrivals on window timers
        # and settle() never advances the clock — drain the windows the
        # way the chaotic runs' settle_recovered does, so the baseline
        # fixpoint is the fully-placed one
        for _ in range(8):
            baseline_h.advance(
                STREAM_CONFIG["stream"]["window_max_seconds"]
            )
    if args.serving:
        # drive the HPA loop to its flat-trace equilibrium: the chaotic
        # runs must converge back to exactly this fleet shape
        for _ in range(4):
            baseline_h.advance(11.0)
            baseline_h.autoscale()
    baseline = settled_fingerprint(baseline_h.store)

    results = []
    failed = []
    scorecards = {}
    for seed in range(args.start, args.start + args.seeds):
        result = run_seed(seed, args.nodes, baseline, trace_dir=trace_dir,
                          explain_dir=explain_dir,
                          tenant_skew=args.tenant_skew,
                          shards=args.shards,
                          durability=args.durability,
                          partitions=args.partitions,
                          replication=args.replication,
                          serving=args.serving,
                          hierarchical=args.hierarchical,
                          defrag=args.defrag,
                          stream=args.stream,
                          slo=args.slo,
                          device=device)
        # the full scorecard is an artifact, not a log line — pop it
        # off the printed result and collect it for --scorecard
        card = result.pop("slo_scorecard", None)
        if card is not None:
            scorecards[str(seed)] = card
        print(json.dumps(result), flush=True)
        results.append(result)
        if not result["ok"]:
            failed.append(seed)
    if args.scorecard_path and scorecards:
        with open(args.scorecard_path, "w") as fh:
            json.dump({"seeds": scorecards}, fh, indent=2)
            fh.write("\n")
    summary = {
        "swept": args.seeds,
        "start": args.start,
        "nodes": args.nodes,
        "shards": args.shards,
        "durability": args.durability,
        "partitions": args.partitions,
        "replication": args.replication,
        "serving": args.serving,
        "hierarchical": args.hierarchical,
        "defrag": args.defrag,
        "stream": args.stream,
        "slo": args.slo,
        "failed_seeds": failed,
        "ok": not failed,
    }
    print(json.dumps(summary), flush=True)
    if args.json_path:
        with open(args.json_path, "w") as fh:
            json.dump(
                {"summary": summary, "results": results}, fh, indent=2
            )
            fh.write("\n")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
