"""`python -m grove_tpu_torch.bench [flags]`: bench.py's command line on
the port.

The parser is bench.py's `main`'s, flag for flag with the same defaults
and help texts, plus one flag of the port's own: `--device` (default
"cuda"), the counterpart of JAX_PLATFORMS. Without CUDA the command
raises unless `--device cpu` is given; no regime drops to the CPU on its
own. The dispatch is `main`'s: each regime prints one JSON line with
bench.py's keys and the port's values, and returns bench.py's exit code.
`--service` spawns `python -m grove_tpu_torch.service.server` and needs
the grpc package (it raises an ImportError naming grpc without it).

Keys that differ from bench.py's line, because they name a JAX concept:
  backend                "cuda" or "cpu" (JAX's default backend there).
  pallas_ab.xla_*        (`--engine pallas`) bench.py's B side is the
                         XLA engine (no Pallas kernel, no device commit).
                         On the card the value kernel always runs, so the
                         port's B side is the kernel tier with the device
                         commit off (on the CPU: the plain arithmetic, as
                         JAX's); its keys are pallas_ab.host_commit_*:
                         host_commit_device_p50_seconds and
                         host_commit_{p50,min,max}_bind_seconds.
  pallas_fine_ab.xla_fine_*  (`--scale-tier --engine pallas`) likewise:
                         pallas_fine_ab.host_commit_fine_*.
  pallas_interpret       kept: the port's counterpart of JAX's interpret
                         mode is the kernels' plain versions on the CPU
                         (true there with the kernel tier, false on the
                         card).
  device_core_tier, kernel_tier, pallas_kernel_tier
                         kept, in the JAX engine's words: "xla" is the
                         plain arithmetic (the CPU only), "pallas-fp32" /
                         "pallas-bf16" the value kernel or its twin.
"""

from __future__ import annotations

import argparse
import sys

from ..solver.engine import resolve_device


def build_parser() -> argparse.ArgumentParser:
    """bench.py's parser with `--device` added."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="CPU-friendly quick run (512 nodes, 64 gangs)")
    ap.add_argument("--nodes", type=int, default=5000)
    ap.add_argument("--gangs", type=int, default=1000)
    ap.add_argument("--iters", type=int, default=9)
    ap.add_argument("--serial-sample", type=int, default=0,
                    help="measure serial baseline on this many gangs and "
                    "extrapolate (0 = run the full backlog serially)")
    ap.add_argument("--sharded", action="store_true",
                    help="run the measured engine as ShardedPlacementEngine "
                    "over a mesh of ALL visible devices (1-device mesh on a "
                    "single chip; virtual CPU mesh under "
                    "xla_force_host_platform_device_count)")
    ap.add_argument("--engine", choices=("fused", "delta", "full", "pallas"),
                    default="fused",
                    help="solve-path regime of the measured engine: "
                    "'fused' (the default, the deployed configuration) "
                    "runs the single-dispatch fused program — staged "
                    "free-state delta + gang inputs in one buffer, one "
                    "launch, one D2H — on top of the device-resident "
                    "state; 'delta' is the split (pre-fused) dispatch "
                    "discipline with the state cache on; 'full' "
                    "additionally disables the cache so every solve "
                    "re-ships the full [N, R] matrix. The measured "
                    "engines run with the incremental re-solve OFF (a "
                    "repeated identical backlog would degenerate into "
                    "the zero-dispatch reuse tier); the incremental "
                    "dirty-tick probes below measure it explicitly; "
                    "'pallas' is the fused regime with the Pallas "
                    "scoring kernel + on-device commit forced on "
                    "(interpret-lowered off-TPU) and adds an "
                    "interleaved kernel-vs-XLA device-seconds A/B")
    ap.add_argument("--equivalence", action="store_true",
                    help="instead of benchmarking, solve every scenario "
                    "(plain, grouped, dispatch/adopt + staled dispatch, "
                    "a seeded bind/unbind churn sweep, fairness, and the "
                    "incremental suite: seeded churn dirtying 1/3/all "
                    "gangs, dispatch-adoption under a dirty tick, rebind "
                    "mid-stream) with the delta, fused and "
                    "fused+incremental engines AGAINST the full-re-encode "
                    "reference and exit nonzero on any placement "
                    "divergence — every path must be bit-identical. Also "
                    "gates the hierarchical tier (score-equal vs flat) "
                    "and the WAVE-PARALLEL fine-solve driver (bitwise "
                    "equal to the serial workers=0 path across memo "
                    "replays, dirty ticks, churn and a fail/recover "
                    "rebind)")
    ap.add_argument("--churn-rate", type=float, default=300.0,
                    help="sustained-churn bench: offered gang arrival "
                    "rate (gangs/sec) against the warm control plane; "
                    "chosen inside the plane's measured ~400/s capacity "
                    "so the p99 reflects steady-state latency, not "
                    "unbounded overload queueing")
    ap.add_argument("--churn-duration", type=float, default=60.0,
                    help="sustained-churn bench: virtual seconds of "
                    "steady arrival (0 disables)")
    ap.add_argument("--cp-replicas", type=int, default=1000,
                    help="control-plane bench: PCS replicas driven through "
                    "the FULL path (apply -> pods -> gangs -> scheduler -> "
                    "bound/ready) at the same scale as the solver stress "
                    "config; 0 disables")
    ap.add_argument("--shards", type=int, default=1,
                    help="control-plane bench: ALSO measure the "
                    "horizontally sharded control plane with N worker "
                    "replicas (controller/sharding.py). Reports the "
                    "modeled parallel throughput "
                    "(controlplane_sharded_gangs_per_sec: serial residue "
                    "+ the slowest worker's wall — what N separate "
                    "processes would see, since workers share nothing "
                    "but the store), the per-shard settle skew, and a "
                    "failover probe (kill the scheduler-owning worker "
                    "mid-settle, measure virtual seconds to "
                    "re-convergence — bounded by one shard lease "
                    "duration). 1 disables")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="profile this run: write a Chrome trace-event "
                    "JSON (Perfetto / chrome://tracing loadable) with the "
                    "engine's encode/device/repair spans and the "
                    "control-plane benches' reconcile/solve spans. "
                    "Composes with --stream (each rung's stream/round "
                    "sides land as their own Perfetto process, with the "
                    "fleet critical-path breakdown in the JSON and the "
                    "telescoping regression gate on the exit code) and "
                    "with --scale-tier (the wave and serial engines' "
                    "coarse/fine spans plus causal flow arrows). Tracing "
                    "adds a little overhead — leave unset for record "
                    "runs (see docs/observability.md)")
    ap.add_argument("--aggregate-overhead", action="store_true",
                    help="add the always-on tracing tax probe: the "
                    "controlplane settle workload with tracing OFF vs "
                    "tracing.mode=aggregate (span ring skipped, bounded "
                    "critical-path sketches only), interleaved p50; "
                    "exits nonzero above the 5%% acceptance bound or if "
                    "the aggregate side folded zero paths. A wall-ratio "
                    "gate flakes on throttling hosts, so it only arms "
                    "when this flag is passed explicitly")
    ap.add_argument("--tenants", type=int, default=0,
                    help="multi-tenant sustained-churn regime: drive a "
                    "Zipf-skewed gang arrival stream across N tenant "
                    "queues (quota + DRF fairness enabled) and assert "
                    "the north-star fairness contract — zero starved "
                    "tenants and bounded max fairness error "
                    "(|dominant share - entitlement| over burst-eligible "
                    "tenants). 0 disables; the ROADMAP regime is "
                    "--tenants 50")
    ap.add_argument("--stream", action="store_true",
                    help="streaming-admission A/B regime: max sustained "
                    "gang arrival rate (gangs/sec) whose p99 bind "
                    "latency stays under --stream-slo, under Poisson "
                    "arrivals with periodic 10x bursts — the streaming "
                    "admission front (micro-batch windows + deadline-"
                    "budget shedding, grove_tpu/streaming) vs classic "
                    "round-based draining on the identical arrival "
                    "schedule, over a 1x/2x/4x rate ladder; exits "
                    "nonzero when the stream side misses the SLO at the "
                    "base rate or sustains less than round-draining")
    ap.add_argument("--stream-slo", type=float, default=2.0,
                    help="--stream: declared p99 bind-latency SLO in "
                    "wall seconds over ADMITTED binds (sheds are "
                    "structured refusals, reported separately)")
    ap.add_argument("--fairness-bound", type=float, default=0.1,
                    help="--tenants: max tolerated fairness error as a "
                    "fraction of cluster dominant capacity (exit 1 "
                    "above it)")
    ap.add_argument("--diurnal", action="store_true",
                    help="elastic-serving bench regime (ROADMAP item 4): "
                    "drive a multi-hour virtual diurnal traffic trace "
                    "(10x load swing + spikes, prefill/decode/router "
                    "disaggregated tiers) through the FULL control plane "
                    "— kubelet metrics reporting -> HPA sync -> scale "
                    "subresource -> scaled-PodGang create/delete -> "
                    "reservation-reuse placement — reporting end-to-end "
                    "scale-up latency (demand step -> capacity restored, "
                    "p50/p99 virtual seconds), placement-score drift "
                    "across the day, reservation-reuse hit rate and "
                    "starved-interval count, with an interleaved "
                    "reuse-on/reuse-off A/B. Exits nonzero on any "
                    "starved interval or a zero reuse hit rate")
    ap.add_argument("--diurnal-hours", type=float, default=3.0,
                    help="--diurnal: virtual hours of trace (two full "
                    "diurnal cycles span the run, so troughs scale the "
                    "fleet down and the second ramp re-places onto "
                    "remembered reservations); --small clamps to 2.0")
    ap.add_argument("--scale-tier", choices=("20k", "100k"), default=None,
                    help="hierarchical scale-tier regime (ROADMAP item 1): "
                    "solve a block-confined backlog over a synthetic "
                    "4-level topology (zone/block/rack/host; 20k nodes / "
                    "4k gangs or 100k nodes / 20k gangs) with the "
                    "HIERARCHICAL two-level engine — coarse block-level "
                    "pruning + per-domain sub-solves with shard-local "
                    "incrementality — reporting p50/min/max backlog-bind "
                    "over dirty-tick repeats plus the dispatch-kind "
                    "counters proving the incremental tier ran. "
                    "Interleaved A/B against the flat engine where the "
                    "flat cost tensor is still materializable (20k); at "
                    "100k the flat side is reported as skipped — its "
                    "[G, D] tensor alone is tens of GB, which is the "
                    "ceiling this regime exists to break. Combine with "
                    "--sharded for the mesh path; exits nonzero if the "
                    "incremental tier never ran shard-locally")
    ap.add_argument("--wave-workers", type=int, default=None,
                    help="--scale-tier: hier_parallel_workers of the "
                    "measured hierarchical engine (wave-parallel fine "
                    "solves: dispatch-all then collect-in-order across "
                    "domains). Default None = the engine's auto "
                    "resolution (host cores, widened to the mesh's "
                    "local device fan-out under --sharded); 0 pins the "
                    "serial one-domain-at-a-time fine phase. The A/B "
                    "side at workers=0 is always measured alongside")
    ap.add_argument("--tier-repeats", type=int, default=5,
                    help="--scale-tier: dirty-tick repeats per side "
                    "(min/median/max reported; this host's throttling "
                    "swings walls ~2x run-to-run, so single numbers "
                    "mislead)")
    ap.add_argument("--recovery", action="store_true",
                    help="add the cold-restart recovery probe: run the "
                    "control-plane workload with the durable store "
                    "(WAL + snapshots in a temp dir), kill the process "
                    "state at steady state, and report recovery_seconds "
                    "(disk replay + soft-state rebuild + re-settle to "
                    "the same fixpoint), plus the same probe on the "
                    "PARTITIONED store (--partitions K) reporting "
                    "recovery_partitioned_seconds — the merged "
                    "per-partition replay path")
    ap.add_argument("--store-bench", action="store_true",
                    help="durable-store write-path regime (ROADMAP item "
                    "4a): committed-write throughput of the PARTITIONED "
                    "write path (per-(namespace, kind) WAL chains, "
                    "--partitions K) vs the classic single WAL, both "
                    "under the --shards N fanned control-plane "
                    "workload, interleaved A/B with min/median/max "
                    "(this host's throttling swings walls ~2x "
                    "run-to-run). The partitioned side reports the "
                    "modeled parallel commit wall (max per-partition "
                    "wall — partitions commit to independent files, so "
                    "a real deployment overlaps them) next to the "
                    "in-process sum; exits nonzero if the writes never "
                    "actually spread past one partition")
    ap.add_argument("--partitions", type=int, default=4,
                    help="--store-bench / --recovery: durable write-path "
                    "partition count for the partitioned side "
                    "(DurabilityConfig.partitions; default 4)")
    ap.add_argument("--replication", action="store_true",
                    help="HA object-store failover regime (ROADMAP item "
                    "4b): run the fanned control-plane workload on the "
                    "durable store with a SEMI-SYNC log-shipping "
                    "standby, model total leader loss (host AND disk: "
                    "no final catch-up) and measure "
                    "failover-to-standby seconds (promote + settle) "
                    "against the cold-restart recovery seconds of the "
                    "SAME workload, interleaved A/B with min/median/"
                    "max; asserts ZERO committed-write loss (promoted "
                    "store seq + fingerprint against the leader's "
                    "committed history). Also reports replication lag "
                    "p50/p99 under --shards N fanned load (async "
                    "bounded-lag mode) and the semi-sync "
                    "commit-throughput tax vs async. Exits nonzero on "
                    "any lost write, a failover median not beating the "
                    "cold-restart median, or a vacuous run")
    ap.add_argument("--federation", action="store_true",
                    help="Multi-cluster federation regime "
                    "(grove_tpu/federation): the same fanned workload "
                    "settled on one 3N-node cluster vs routed across a "
                    "3-member federation of N-node clusters, "
                    "interleaved A/B with min/median/max. Members "
                    "share nothing, so the modeled federation wall is "
                    "the routing wall plus the SLOWEST member's settle "
                    "wall — the near-linear-throughput claim under "
                    "test. Exits nonzero on a vacuous spread (the "
                    "workload never lands on >= 2 members) or a "
                    "modeled speedup <= 1.0")
    ap.add_argument("--defrag", action="store_true",
                    help="continuous-defragmentation bench regime (ROADMAP "
                    "item 3): drive a LONG-CHURN gang arrival/departure "
                    "stream that fragments free capacity across racks, "
                    "with the defragmenter ON vs OFF interleaved step by "
                    "step, and gate the contract — placement-score drift "
                    "held within --defrag-band with defrag on while the "
                    "off side monotonically degrades, migration cost "
                    "(evictions/hour) under the configured bound, "
                    "make-before-break hit rate reported, and ZERO full "
                    "re-encodes attributable to defrag sweeps in the "
                    "steady-state window (what-if dispatch attribution). "
                    "Exits nonzero on any violated bound or a vacuous A/B")
    ap.add_argument("--defrag-hours", type=float, default=2.0,
                    help="--defrag: virtual hours of churn (default 2)")
    ap.add_argument("--defrag-band", type=float, default=0.05,
                    help="--defrag: max tolerated on-side placement-score "
                    "drift (initial window mean - final window mean)")
    ap.add_argument("--service", action="store_true",
                    help="benchmark the solve THROUGH the placement-service "
                    "gRPC boundary (server spawned as a subprocess on this "
                    "machine's accelerator; measures whether the RPC hop + "
                    "codec amortize at full-backlog batches)")
    ap.add_argument("--device", default="cuda",
                    help="the device the regimes run on: cuda (the card; "
                    "raises without one) or cpu (the kernels' plain "
                    "versions); the counterpart of bench.py's "
                    "JAX_PLATFORMS")
    return ap


def main(argv=None) -> int:
    """Parse `argv` (sys.argv[1:] by default), run the regime it names and
    return its exit code, as bench.py's `main` does."""
    ap = build_parser()
    args = ap.parse_args(argv)
    resolve_device(args.device)  # no CUDA and no --device cpu: raises
    # the build cache: repeat bench runs (and any other process of this
    # package on this machine) reuse the kernels and native libraries an
    # earlier one compiled (see tuning.py)
    from ..tuning import enable_compilation_cache

    enable_compilation_cache()
    if args.stream:
        from .stream import bench_stream

        return bench_stream(args)
    if args.store_bench:
        from .store import bench_store

        return bench_store(args)
    if args.replication:
        from .store import bench_replication

        return bench_replication(args)
    if args.federation:
        from .federation import bench_federation

        return bench_federation(args)
    if args.scale_tier:
        from .tiers import bench_scale_tier

        return bench_scale_tier(args)
    if args.diurnal:
        from .serving import bench_diurnal

        return bench_diurnal(args)
    if args.defrag:
        from .defrag import bench_defrag

        return bench_defrag(args)
    if args.service:
        if args.trace:
            ap.error("--trace is not supported with --service: the span "
                     "tracer is in-process and the service bench drives "
                     "the solver behind gRPC (trace the in-process paths "
                     "without --service)")
        from .service import bench_service

        return bench_service(args)
    if args.small:
        args.nodes, args.gangs, args.iters = 512, 64, 3
        args.cp_replicas = min(args.cp_replicas, 20)
        # clamps are LOUD: a capped churn run must not read as a full one
        # (the JSON reports the clamped rate with no other trace)
        if args.churn_rate > 20.0:
            print(
                f"bench --small: clamping --churn-rate "
                f"{args.churn_rate:g} -> 20.0 gangs/s",
                file=sys.stderr,
            )
        args.churn_rate = min(args.churn_rate, 20.0)
        if args.churn_duration > 3.0:
            print(
                f"bench --small: clamping --churn-duration "
                f"{args.churn_duration:g} -> 3.0 virtual seconds",
                file=sys.stderr,
            )
        args.churn_duration = min(args.churn_duration, 3.0)
        if args.serial_sample == 0:
            args.serial_sample = 32

    if args.tenants > 0:
        from .tenants import bench_tenants

        return bench_tenants(args)
    from .solve import bench_solve

    return bench_solve(args)
