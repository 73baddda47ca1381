"""grove_tpu_torch.bench's control-plane regimes against bench.py's, on the CPU.

Sustained churn (`churn_workload`, with its scale events and container
crashes), the cold-restart recovery probe and the aggregate tracing tax
(`--recovery --aggregate-overhead`), and the streaming-admission A/B
(`--stream`), each run by both packages with the same arguments at
bench.py's small shapes and held equal, exactly, less the walls listed
here by name (each must exist on both sides). The tracing tax and the
stream ladder gate on ratios of walls, which flake on a loaded CPU: their
cases hold the fields and not the exit code.
"""

from __future__ import annotations

import bench
from grove_tpu.chaos import settled_fingerprint as jax_fingerprint
from grove_tpu.cluster import make_nodes as jax_nodes
from grove_tpu.controller import Harness as JaxHarness
from grove_tpu_torch.bench import controlplane
from grove_tpu_torch.chaos import settled_fingerprint as torch_fingerprint
from grove_tpu_torch.cluster import make_nodes as torch_nodes
from grove_tpu_torch.controller import Harness as TorchHarness

from test_torch_bench_solve import (
    CHURN_WALLS,
    CONTROLPLANE_WALLS,
    FUSED_WALLS,
    SOLVE_WALLS,
)
from torch_bench import hold_equal, run_pair

#: churn_workload's walls: its latencies are wall seconds from creation
#: to Scheduled, its rate created over the measured wall
CHURN_STATS_WALLS = ("sustained_gangs_per_sec", "p50_bind_seconds",
                     "p99_bind_seconds")
#: --recovery's walls, and the journal's bytes: its records are pickles
#: naming each package's own modules, so their sizes differ (as
#: tests/test_torch_harness.py's `_WALLS` leaves out wal_bytes_total)
RECOVERY_WALLS = (
    "recovery_seconds", "recovery_replay_seconds",
    "recovery_durable_cold_settle_seconds", "recovery_wal_bytes",
    "recovery_partitioned_seconds", "recovery_partitioned_replay_seconds",
)
#: --aggregate-overhead's walls: the two sides' settle walls, their ratio
#: and its verdict, and the dominant segment (the critical path's interior
#: split follows the solve's encode/device/repair walls)
AGGREGATE_WALLS = (
    "aggregate_overhead_fraction", "aggregate_settle_p50_seconds",
    "baseline_settle_p50_seconds", "aggregate_overhead_ok",
    "aggregate_dominant_segment",
)
#: --stream: each rung's latencies and walls, and what the SLO verdicts
#: read from them: a side's sustained rate is its binds over its measured
#: wall, the ladder's max rate at SLO the highest rung whose wall p99
#: meets it, and the scorecard holds those
STREAM_WALLS = (
    "value", "vs_baseline", "round_max_gangs_per_sec",
    "top_rung_stream_p99", "top_rung_round_p99", "scorecard",
    *(f"rungs[].{side}.{k}" for side in ("stream", "round")
      for k in ("measured_wall", "p50_bind_seconds", "p99_bind_seconds",
                "sustained_gangs_per_sec")),
)


def test_churn_workload_matches_bench():
    """churn_workload on both packages' Harnesses at 128 nodes, 20
    gangs/s for 12 virtual seconds (a scale event at 10 s, a container
    crash at 7 s): the same arrivals, deletes, events and binds, and the
    same settled plane after; every arrival bound."""
    kw = dict(rate=20.0, duration=12.0, population=60)
    alloc = {"cpu": 32.0, "memory": 128.0, "tpu": 8.0}
    hj = JaxHarness(nodes=jax_nodes(128, allocatable=dict(alloc)))
    ht = TorchHarness(nodes=torch_nodes(128, allocatable=dict(alloc)),
                      device="cpu")
    for h, pcs in ((hj, bench._churn_pcs), (ht, controlplane._churn_pcs)):
        h.apply(pcs("standing", 10))
        h.settle()
    want = bench.churn_workload(hj, **kw)
    got = controlplane.churn_workload(ht, **kw)
    hold_equal(want, got, CHURN_STATS_WALLS)
    assert got["scale_events"] >= 1 and got["crashes"] >= 1
    assert (got["bound"] + got["unbound_final"] + got["deleted_before_bind"]
            == got["created"])
    assert got["unbound_final"] == 0
    assert torch_fingerprint(ht.store) == jax_fingerprint(hj.store)


def test_bench_churn_without_duration_is_empty():
    assert controlplane.bench_churn(64, rate=1.0, duration=0.0,
                                    device="cpu") == {}


def test_recovery_and_aggregate_overhead_match_bench():
    """`--small --recovery --aggregate-overhead`: the default run plus the
    journaled settle, cold restart and replay (single and 4-partition
    journal) and the tracing tax's fields; the tax's 5% gate is a wall
    ratio, so the exit code is not held."""
    _, jax, _, port = run_pair(["--small", "--recovery",
                                "--aggregate-overhead"])
    hold_equal(jax, port, SOLVE_WALLS + FUSED_WALLS + CONTROLPLANE_WALLS
               + CHURN_WALLS + RECOVERY_WALLS + AGGREGATE_WALLS)
    assert port["recovery_outcome"] == "clean"
    assert port["aggregate_paths_folded"] > 0


def test_stream_matches_bench():
    """`--small --stream`: the rate ladder's arrivals, sheds and
    re-admissions equal; its latencies, rates and the verdicts on them
    left out."""
    _, jax, _, port = run_pair(["--small", "--stream"])
    hold_equal(jax, port, STREAM_WALLS)
    assert port["rungs"][-1]["stream"]["front_sheds"] > 0


def test_profile_settle_splits_the_warm_settle_by_layer(capsys):
    """`python -m grove_tpu_torch.scripts.profile_settle` at a small
    shape on the CPU: every pod bound, the reference's table on stderr,
    and a split whose layers add up to the profiled own time, with the
    control plane's own layers in it."""
    import json

    from grove_tpu_torch.scripts import profile_settle

    assert profile_settle.main(["40", "128", "--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert line["pods_bound"] == 2 * 40 * 8
    assert "function calls" in err and "warm settle by layer" in err
    layers = line["layers_seconds"]
    assert {"controllers", "store", "scheduler encode", "kubelet"} <= set(
        layers)
    assert abs(sum(layers.values()) - line["profiled_seconds"]) < 1e-3
