"""The durable-store regimes: the counterparts of bench.py's
`bench_store` (`--store-bench`), `bench_recovery` (`--recovery`) and
`bench_replication` (`--replication`)."""

from __future__ import annotations

import json
import sys
import time

from .controlplane import _fanned_workload
from .shapes import (
    backend_name,
    interleaved_ab,
    p50,
    regime_device,
    wall_stats,
)


def bench_store(args, device=None, repeats: int | None = None) -> int:
    """Durable-store write-path regime (`--store-bench`, ROADMAP item
    4a): committed-write throughput of the PARTITIONED write path
    (cluster/durability.PartitionedLog, `--partitions K`) vs the classic
    single WAL, both driving the same fanned workload through the full
    control plane under `--shards N`.

    Throughput is computed from each side's WAL COMMIT WALL
    (DurableLog.wall_seconds deltas: append + cadence-snapshot work),
    not the whole settle — the probe measures the durable write path,
    with the control plane as the load generator. The partitioned side
    reports two numbers:

      modeled    records / max(per-partition commit wall) — partitions
                 append and fsync to independent files, so a real
                 deployment overlaps them (one appender per partition;
                 the same parallel model as the sharded control-plane
                 bench's N-process fleet)
      in-process records / sum(per-partition walls) — what this
                 single-threaded sim actually pays (per-partition
                 snapshot cuts pickle only the partition's slice, so
                 even the same-thread number can win)

    Interleaved A/B with min/median/max per the shared bench-noise
    discipline (this host's throttling swings walls ~2x run-to-run).
    Exits nonzero when the writes never spread past one partition
    (vacuous coverage) or the modeled median fails to beat the single
    WAL. `repeats` (the port's own knob) overrides bench.py's count of
    measured cycles a side (5, or 3 with --small)."""
    device = regime_device(args, device)
    import os
    import tempfile

    from ..api.types import Pod
    from ..cluster import make_nodes
    from ..controller import Harness
    from ..tuning import tune_gc

    shards = max(args.shards, 1)
    partitions = max(args.partitions, 2)
    if repeats is None:
        repeats = 3 if args.small else 5
    num_nodes = 64 if args.small else min(args.nodes, 512)
    fan = max(8, shards * 8)
    per_pcs = 2 if args.small else 6
    namespaces = min(fan, 8)

    def durable_harness(wal_dir: str, parts: int) -> Harness:
        cfg: dict = {
            "durability": {
                "wal_dir": wal_dir,
                # fsync "never": the sim never kills the interpreter, so
                # physical durability is not what this probe measures —
                # the commit wall is serialization + append + snapshot
                # work; with fsync on, the per-partition overlap the
                # parallel model captures only widens
                "fsync": "never",
                "snapshot_interval_seconds": 120.0,
                "wal_max_bytes": 1 << 20,
                **({"partitions": parts} if parts > 1 else {}),
            }
        }
        if shards > 1:
            cfg["controllers"] = {"shards": shards}
        return Harness(
            device=device,
            nodes=make_nodes(
                num_nodes,
                allocatable={"cpu": 32.0, "memory": 128.0, "tpu": 8.0},
            ),
            config=cfg,
        )

    def measure_cycle(h: Harness, tag: str) -> dict:
        """One apply+settle cycle (the committed-write burst), deltas
        read from the durable layer; the teardown settles outside the
        measured window so the store population is constant run to
        run."""
        dur = h.cluster.durability
        walls0 = (
            dur.partition_walls() if hasattr(dur, "partition_walls")
            else None
        )
        wall0 = dur.wall_seconds
        rec0 = dur.wal_records_total
        workload = _fanned_workload(fan, per_pcs, tag, namespaces)
        t0 = time.perf_counter()
        for pcs in workload:
            h.apply(pcs)
        h.settle()
        settle_wall = time.perf_counter() - t0
        bound = sum(1 for p in h.store.scan(Pod.KIND) if p.node_name)
        if bound != fan * per_pcs * 8:
            raise RuntimeError(
                f"store bench invalid: {bound} pods bound, expected "
                f"{fan * per_pcs * 8}"
            )
        out = {
            "records": dur.wal_records_total - rec0,
            "commit_wall": dur.wall_seconds - wall0,
            "settle_wall": settle_wall,
        }
        if walls0 is not None:
            per = [b - a for a, b in zip(walls0, dur.partition_walls())]
            out["partition_walls"] = per
            out["modeled_wall"] = max(per)
        for pcs in workload:
            h.store.delete(
                "PodCliqueSet", pcs.metadata.namespace, pcs.metadata.name
            )
        h.settle()
        return out

    with tempfile.TemporaryDirectory(prefix="grove-store-bench-") as td:
        single = durable_harness(os.path.join(td, "single"), 1)
        part = durable_harness(os.path.join(td, "part"), partitions)
        # warm-up cycle per side: kernel builds, graph captures and
        # store shapes land outside the measured window
        measure_cycle(single, "warm-s")
        measure_cycle(part, "warm-p")
        tune_gc()
        s_runs, p_runs = interleaved_ab(
            lambda i: measure_cycle(single, f"sbs{i}"),
            lambda i: measure_cycle(part, f"sbp{i}"),
            repeats,
        )
        active = sum(
            1 for p in part.cluster.durability.partitions
            if p.wal_records_total > 0
        )

    s_tp = [r["records"] / r["commit_wall"] for r in s_runs]
    p_tp_model = [r["records"] / r["modeled_wall"] for r in p_runs]
    p_tp_inproc = [r["records"] / r["commit_wall"] for r in p_runs]
    speedup = p50(p_tp_model) / p50(s_tp)
    failures = []
    if active <= 1:
        failures.append(
            "coverage: committed writes never spread past one partition "
            "— the fanned workload should hash (namespace, kind) keys "
            "across the layout"
        )
    if speedup <= 1.0:
        failures.append(
            f"partitioned commit did not beat the single WAL at the "
            f"median (modeled speedup {speedup:.2f})"
        )
    out = {
        "metric": (
            f"durable committed-write throughput ({partitions} "
            f"partitions vs single WAL, {fan}x{per_pcs}-replica fanned "
            f"workload, shards={shards})"
        ),
        "value": round(p50(p_tp_model), 1),
        "unit": "committed-writes/sec",
        "vs_baseline": round(speedup, 2),
        "store_bench_shards": shards,
        "store_bench_partitions": partitions,
        "store_bench_active_partitions": active,
        "store_bench_namespaces": namespaces,
        "store_bench_records_per_cycle": s_runs[-1]["records"],
        "store_bench_repeats": repeats,
        "store_bench_interleaved": True,
        "store_bench_model": "records_over_max_partition_commit_wall",
        **wall_stats(s_tp, "store_single_",
                     suffix="writes_per_sec", round_to=1),
        **wall_stats(p_tp_model, "store_partitioned_",
                     suffix="writes_per_sec", round_to=1),
        "store_partitioned_inprocess_p50_writes_per_sec": round(
            p50(p_tp_inproc), 1
        ),
        "store_partitioned_inprocess_speedup": round(
            p50(p_tp_inproc) / p50(s_tp), 2
        ),
        **wall_stats([r["commit_wall"] for r in s_runs],
                     "store_single_commit_wall_"),
        **wall_stats([r["modeled_wall"] for r in p_runs],
                     "store_partitioned_commit_wall_"),
        **wall_stats([r["commit_wall"] for r in p_runs],
                     "store_partitioned_inprocess_wall_"),
        "store_partition_commit_walls": [
            round(w, 4) for w in p_runs[-1]["partition_walls"]
        ],
        **wall_stats([r["settle_wall"] for r in s_runs],
                     "store_single_settle_"),
        **wall_stats([r["settle_wall"] for r in p_runs],
                     "store_partitioned_settle_"),
        "backend": backend_name(device),
    }
    for f in failures:
        print(f"STORE BENCH FAILURE: {f}", file=sys.stderr)
    print(json.dumps(out))
    return 1 if failures else 0


def bench_recovery(num_nodes: int, replicas: int,
                   partitions: int = 1, device=None) -> dict:
    """Cold-restart recovery probe (`--recovery`): settle the standard
    control-plane workload on a DURABLE store (WAL + snapshots in a temp
    dir, fsync per commit — the honest production posture), then model a
    whole-process crash at steady state: Harness.cold_restart drops the
    live store, recovers it from disk (latest valid snapshot + WAL
    replay), expires coordination leases, rebuilds manager/scheduler/
    kubelet soft state, and settle() re-derives the fixpoint.

    recovery_seconds is the whole outage window the operator would see:
    disk replay + soft-state rebuild + re-settle. The split fields say
    where it went (recovery_replay_seconds is the store-rebuild part
    alone). Durable write-path overhead is visible by comparing
    recovery_durable_cold_settle_seconds (this harness's first settle,
    WAL armed, graph-cold) against controlplane_cold_settle_seconds from
    the same run.

    partitions > 1 runs the same probe a second time on the PARTITIONED
    store (per-(namespace, kind) WAL chains; recovery heap-merges the
    partition replay streams by global seq) and reports the
    recovery_partitioned_* fields alongside."""
    import os
    import tempfile

    from ..api.meta import ObjectMeta as Meta
    from ..api.types import (
        Container,
        Pod,
        PodCliqueSet,
        PodCliqueSetSpec,
        PodCliqueSetTemplateSpec,
        PodCliqueSpec,
        PodCliqueTemplateSpec,
        PodSpec,
    )
    from ..chaos.harness import settled_fingerprint
    from ..cluster import make_nodes
    from ..controller import Harness

    workload = PodCliqueSet(
        metadata=Meta(name="recovery"),
        spec=PodCliqueSetSpec(
            replicas=replicas,
            template=PodCliqueSetTemplateSpec(
                cliques=[
                    PodCliqueTemplateSpec(
                        name="w",
                        spec=PodCliqueSpec(
                            replicas=8,
                            pod_spec=PodSpec(
                                containers=[
                                    Container(
                                        name="m", resources={"cpu": 1.0}
                                    )
                                ]
                            ),
                        ),
                    )
                ]
            ),
        ),
    )
    def probe(wal_dir: str, parts: int) -> dict:
        h = Harness(
            device=device,
            nodes=make_nodes(
                num_nodes,
                allocatable={"cpu": 32.0, "memory": 128.0, "tpu": 8.0},
            ),
            config={"durability": {
                "wal_dir": wal_dir,
                **({"partitions": parts} if parts > 1 else {}),
            }},
        )
        t0 = time.perf_counter()
        h.apply(workload)  # create() clones its input; reuse is safe
        h.settle()
        durable_settle = time.perf_counter() - t0
        fixpoint = settled_fingerprint(h.store)
        wal = h.cluster.durability.debug_state()
        t0 = time.perf_counter()
        stats = h.cold_restart()
        replay = time.perf_counter() - t0
        h.settle()
        wall = time.perf_counter() - t0
        if settled_fingerprint(h.store) != fixpoint:  # survives python -O
            raise RuntimeError(
                "recovery bench invalid: post-recovery fixpoint diverged"
            )
        return {
            "seconds": round(wall, 3),
            "replay_seconds": round(replay, 3),
            "durable_cold_settle_seconds": round(durable_settle, 2),
            "wal": wal,
            "stats": stats,
        }

    with tempfile.TemporaryDirectory(prefix="grove-bench-wal-") as td:
        single = probe(os.path.join(td, "single"), 1)
        out = {
            "recovery_replicas": replicas,
            "recovery_seconds": single["seconds"],
            "recovery_replay_seconds": single["replay_seconds"],
            "recovery_durable_cold_settle_seconds": single[
                "durable_cold_settle_seconds"
            ],
            "recovery_wal_records": single["wal"]["wal_records_total"],
            "recovery_wal_bytes": single["wal"]["wal_bytes_total"],
            "recovery_outcome": single["stats"]["outcome"],
            "recovery_records_replayed": single["stats"][
                "wal_records_replayed"
            ],
        }
        if partitions > 1:
            part = probe(os.path.join(td, "part"), partitions)
            out.update({
                "recovery_partitions": partitions,
                "recovery_partitioned_seconds": part["seconds"],
                "recovery_partitioned_replay_seconds": part[
                    "replay_seconds"
                ],
                "recovery_partitioned_outcome": part["stats"]["outcome"],
                "recovery_partitioned_records_replayed": part["stats"][
                    "wal_records_replayed"
                ],
            })
    return out


def bench_replication(args, device=None) -> int:
    """HA failover regime (`--replication`, ROADMAP item 4b) — three
    probes over the fanned multi-namespace workload, every comparison
    interleaved A/B (this host's throttling swings walls ~2x run-to-run;
    the shared bench-noise discipline):

      failover vs cold restart   Both sides settle the same workload on
          a durable store and then lose the leader process at steady
          state. The recovery side replays the WAL from disk
          (Harness.cold_restart — the classic posture, outage proportional
          to history). The failover side promotes its SEMI-SYNC standby
          with catch_up=False — total leader loss, host AND disk: only
          the standby's already-applied state survives — and must come
          back with ZERO committed-write loss (promoted seq equals the
          leader's committed head; the settled fingerprint matches the
          pre-kill fixpoint). The headline gate: failover p50 strictly
          under recovery p50.

      replication lag            The async bounded-lag mode under the
          --shards N fanned control plane: lag sampled (records +
          leader-clock seconds) after every settle step BEFORE the
          driver's poll, p50/p99 reported — the alerting numbers the
          runbook quotes.

      semi-sync commit tax       The same apply/settle/delete cycle on
          two live planes — ack async vs semi-sync — interleaved; the
          tax is the ratio of settle-wall p50s (semi-sync pays one
          standby apply + durable append inside every commit)."""
    device = regime_device(args, device)
    import os
    import tempfile

    from ..chaos.harness import settled_fingerprint
    from ..cluster import make_nodes
    from ..controller import Harness

    small = args.small
    num_nodes = 64 if small else 200
    fan = 8
    per_pcs = 3 if small else 8
    namespaces = 4
    repeats = 3 if small else 5
    churn_cycles = 1 if small else 2
    partitions = max(args.partitions, 1)
    failures: list[str] = []

    def nodes():
        return make_nodes(
            num_nodes,
            allocatable={"cpu": 32.0, "memory": 128.0, "tpu": 8.0},
        )

    def durable_cfg(root: str, replication: bool = True,
                    ack: str = "semi-sync", shards: int = 1) -> dict:
        cfg: dict = {
            "durability": {
                "wal_dir": os.path.join(root, "wal"),
                **({"partitions": partitions} if partitions > 1 else {}),
            },
        }
        if replication:
            cfg["replication"] = {
                "enabled": True,
                "ack_mode": ack,
                "standby_wal_dir": os.path.join(root, "standby"),
            }
        if shards > 1:
            cfg["controllers"] = {"shards": shards}
        return cfg

    def apply_all(h, tag: str) -> None:
        for pcs in _fanned_workload(fan, per_pcs, tag, namespaces):
            h.apply(pcs)

    def delete_all(h, tag: str) -> None:
        for j in range(fan):
            h.store.delete(
                "PodCliqueSet", f"bench-ns{j % namespaces}", f"{tag}-{j}"
            )

    def settled(h, tag: str) -> None:
        """Settle the fanned workload plus churn cycles, growing the WAL
        history the cold-restart side must replay (and the failover side
        must NOT care about)."""
        apply_all(h, tag)
        h.settle()
        for k in range(churn_cycles):
            apply_all(h, f"{tag}c{k}")
            h.settle()
            delete_all(h, f"{tag}c{k}")
            h.settle()

    # -- probe A: failover vs cold restart, interleaved ---------------------
    def failover_once(i: int) -> dict:
        with tempfile.TemporaryDirectory(prefix="grove-repl-fo-") as td:
            h = Harness(device=device, nodes=nodes(), config=durable_cfg(td))
            settled(h, f"fo{i}")
            fixpoint = settled_fingerprint(h.store)
            committed = h.store.last_seq
            t0 = time.perf_counter()
            stats = h.promote_standby(catch_up=False)
            promote_wall = time.perf_counter() - t0
            if stats["lost_records"] or h.store.last_seq != committed:
                failures.append(
                    f"failover[{i}]: committed-write loss — leader head "
                    f"{committed}, promoted head {h.store.last_seq}, "
                    f"lost_records={stats['lost_records']}"
                )
            h.settle()
            wall = time.perf_counter() - t0
            if settled_fingerprint(h.store) != fixpoint:
                failures.append(
                    f"failover[{i}]: post-promotion fixpoint diverged"
                )
            return {"seconds": wall, "promote_seconds": promote_wall,
                    "term": stats["term"]}

    def recovery_once(i: int) -> dict:
        with tempfile.TemporaryDirectory(prefix="grove-repl-cr-") as td:
            h = Harness(
                device=device,
                nodes=nodes(), config=durable_cfg(td, replication=False)
            )
            settled(h, f"cr{i}")
            fixpoint = settled_fingerprint(h.store)
            t0 = time.perf_counter()
            stats = h.cold_restart()
            replay_wall = time.perf_counter() - t0
            h.settle()
            wall = time.perf_counter() - t0
            if settled_fingerprint(h.store) != fixpoint:
                failures.append(
                    f"recovery[{i}]: post-recovery fixpoint diverged"
                )
            return {"seconds": wall, "replay_seconds": replay_wall,
                    "records": stats["wal_records_replayed"]}

    fo_runs, cr_runs = interleaved_ab(failover_once, recovery_once,
                                      repeats)
    fo_walls = [r["seconds"] for r in fo_runs]
    cr_walls = [r["seconds"] for r in cr_runs]
    if p50(fo_walls) >= p50(cr_walls):
        failures.append(
            f"failover p50 {p50(fo_walls):.3f}s did not beat the "
            f"cold-restart p50 {p50(cr_walls):.3f}s"
        )

    # -- probe B: replication lag under the sharded fanned load -------------
    lag_records: list[int] = []
    lag_seconds: list[float] = []
    with tempfile.TemporaryDirectory(prefix="grove-repl-lag-") as td:
        h = Harness(
            device=device,
            nodes=nodes(),
            config=durable_cfg(td, ack="async", shards=args.shards),
        )
        standby = h.cluster.standby
        for step in range(4 if small else 6):
            apply_all(h, f"lag{step}")
            h.settle()
            lag_records.append(standby.lag_records())
            lag_seconds.append(standby.lag_seconds())
            standby.poll()
            delete_all(h, f"lag{step}")
            h.settle()
            lag_records.append(standby.lag_records())
            lag_seconds.append(standby.lag_seconds())
            standby.poll()
            h.advance(1.0)
        if standby.records_applied_total == 0:
            failures.append("lag probe vacuous: standby applied nothing")
        max_lag_bound = h.config.replication.max_lag_records

    def pctl(samples: list, q: float):
        s = sorted(samples)
        return s[min(len(s) - 1, int(q * (len(s) - 1) + 0.999))]

    # -- probe C: semi-sync commit tax, interleaved -------------------------
    with tempfile.TemporaryDirectory(prefix="grove-repl-tax-") as td:
        ha = Harness(
            device=device,
            nodes=nodes(), config=durable_cfg(
                os.path.join(td, "a"), ack="async"
            )
        )
        hs = Harness(
            device=device,
            nodes=nodes(), config=durable_cfg(
                os.path.join(td, "s"), ack="semi-sync"
            )
        )
        for h, tag in ((ha, "warma"), (hs, "warms")):
            apply_all(h, tag)
            h.settle()

        def cycle(h, tag: str) -> float:
            t0 = time.perf_counter()
            apply_all(h, tag)
            h.settle()
            delete_all(h, tag)
            h.settle()
            # async mode may still trail: drain so both sides end each
            # cycle fully shipped and the next cycle starts equal
            h.cluster.standby.poll()
            return time.perf_counter() - t0

        async_walls, semi_walls = interleaved_ab(
            lambda i: cycle(ha, f"taxa{i}"),
            lambda i: cycle(hs, f"taxs{i}"),
            repeats,
        )
    tax = p50(semi_walls) / p50(async_walls) if p50(async_walls) else 0.0

    out = {
        "metric": "store_failover",
        "unit": "seconds",
        "value": round(p50(fo_walls), 3),
        "replication_nodes": num_nodes,
        "replication_gangs": fan * per_pcs,
        "replication_partitions": partitions,
        "replication_lag_shards": args.shards,
        "replication_repeats": repeats,
        "failover_zero_loss": not any("loss" in f for f in failures),
        "failover_terms": [r["term"] for r in fo_runs],
        **wall_stats(fo_walls, "failover_", round_to=3),
        **wall_stats([r["promote_seconds"] for r in fo_runs],
                     "failover_promote_", round_to=3),
        **wall_stats(cr_walls, "recovery_", round_to=3),
        **wall_stats([r["replay_seconds"] for r in cr_runs],
                     "recovery_replay_", round_to=3),
        "recovery_records_replayed_p50": p50(
            [r["records"] for r in cr_runs]
        ),
        "failover_vs_recovery_speedup": round(
            p50(cr_walls) / p50(fo_walls), 2
        ) if p50(fo_walls) else None,
        "replication_lag_records_p50": pctl(lag_records, 0.50),
        "replication_lag_records_p99": pctl(lag_records, 0.99),
        "replication_lag_seconds_p50": round(pctl(lag_seconds, 0.50), 3),
        "replication_lag_seconds_p99": round(pctl(lag_seconds, 0.99), 3),
        "replication_max_lag_records_bound": max_lag_bound,
        "semi_sync_tax": round(tax, 3),
        **wall_stats(async_walls, "ack_async_cycle_", round_to=3),
        **wall_stats(semi_walls, "ack_semi_sync_cycle_", round_to=3),
        "backend": backend_name(device),
    }
    if pctl(lag_records, 0.99) > max_lag_bound:
        failures.append(
            f"async lag p99 {pctl(lag_records, 0.99)} exceeded the "
            f"configured bound {max_lag_bound}"
        )
    for f in failures:
        print(f"REPLICATION BENCH FAILURE: {f}", file=sys.stderr)
    print(json.dumps(out))
    return 1 if failures else 0
