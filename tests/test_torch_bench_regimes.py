"""grove_tpu_torch.bench's other regimes against bench.py's, on the CPU.

The multi-tenant churn (`--tenants 50`, the ROADMAP regime), elastic
serving (`--diurnal`), the partitioned durable store (`--store-bench`),
federation (`--federation`) and continuous defragmentation (`--defrag`),
each run by both
packages with the same arguments at bench.py's `--small` shape, both at
once (tests/torch_bench.py), and held equal, exactly, less the walls
listed here by name (each must exist on both sides). The store and
federation regimes gate on ratios of walls, which flake on a loaded CPU:
their cases hold the fields and not the exit code.
"""

from __future__ import annotations

from torch_bench import hold_equal, run_pair


def _sides(prefix: str, suffix: str = "seconds") -> tuple:
    """wall_stats' three fields of one side."""
    return tuple(f"{prefix}{s}_{suffix}" for s in ("p50", "min", "max"))


#: --tenants: binds over the wall, and the wall
TENANT_WALLS = ("value", "wall_seconds")
#: --diurnal: the steps' settle walls (every other field is virtual time)
DIURNAL_WALLS = ("settle_wall_p50_seconds",
                 "reuse_off.settle_wall_p50_seconds")
#: --store-bench: the commit and settle walls and the write rates and
#: speedups computed from them
STORE_WALLS = (
    "value", "vs_baseline",
    *_sides("store_single_", "writes_per_sec"),
    *_sides("store_partitioned_", "writes_per_sec"),
    "store_partitioned_inprocess_p50_writes_per_sec",
    "store_partitioned_inprocess_speedup",
    *_sides("store_single_commit_wall_"),
    *_sides("store_partitioned_commit_wall_"),
    *_sides("store_partitioned_inprocess_wall_"),
    "store_partition_commit_walls",
    *_sides("store_single_settle_"),
    *_sides("store_partitioned_settle_"),
)
#: --federation: the routing, member and single-cluster walls and the
#: modeled speedup over them
FEDERATION_WALLS = (
    "modeled_speedup", *_sides("federation_modeled_"),
    *_sides("single_cluster_"), *_sides("routing_"),
    *_sides("slowest_member_"),
)
#: --defrag: the two sides' step walls
DEFRAG_WALLS = (*_sides("defrag_on_step_"), *_sides("defrag_off_step_"))


def test_tenants_matches_bench():
    """`--small --tenants 50`: 150 arrivals over 50 Zipf-skewed tenants;
    no tenant starved, the fairness error under its bound."""
    rj, jax, rt, port = run_pair(["--small", "--tenants", "50"])
    assert rj == rt == 0
    hold_equal(jax, port, TENANT_WALLS)
    assert port["created"] == 150 and port["tenants_starved"] == 0


def test_diurnal_matches_bench():
    """`--small --diurnal`: 2 virtual hours of the trace, both reuse
    sides; the scale-ups, reuse hits and placement scores equal."""
    rj, jax, rt, port = run_pair(["--small", "--diurnal"])
    assert rj == rt == 0
    hold_equal(jax, port, DIURNAL_WALLS)
    assert port["reservation_reuse_hits"] > 0
    assert port["starved_intervals"] == 0


def test_store_bench_matches_bench():
    """`--small --store-bench`: the same records per cycle over 4
    partitions, spread past one."""
    _, jax, _, port = run_pair(["--small", "--store-bench"])
    hold_equal(jax, port, STORE_WALLS)
    assert port["store_bench_active_partitions"] > 1


def test_federation_matches_bench():
    """`--small --federation`: the routed workload's spread over the
    members equal."""
    _, jax, _, port = run_pair(["--small", "--federation"])
    hold_equal(jax, port, FEDERATION_WALLS)
    assert len(port["spread"]) >= 2


def test_defrag_matches_bench():
    """`--small --defrag`: drift, moves, evictions and the what-if
    attribution equal."""
    rj, jax, rt, port = run_pair(["--small", "--defrag"])
    assert rj == rt == 0
    hold_equal(jax, port, DEFRAG_WALLS)
