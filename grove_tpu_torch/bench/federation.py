"""The federation regime (`--federation`): the counterpart of bench.py's
`bench_federation`."""

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


def bench_federation(args, device=None) -> int:
    """Federation throughput regime (`--federation`,
    grove_tpu/federation): the same fanned workload settled on one
    3N-node cluster vs routed across a 3-member federation of N-node
    clusters, interleaved A/B (the shared bench-noise discipline).

    Throughput model: member control planes share NOTHING — not even a
    store — so a real deployment runs them as independent processes
    whose settle walls overlap (the bench_controlplane_sharded modeling
    argument, one level up, with zero cross-plane serial residue). The
    deterministic simulation settles members sequentially, so the
    modeled federation wall is

        routing wall (the coordinator's aggregate cuts + least-loaded
        pick, genuinely serial) + the SLOWEST member's settle wall

    and near-linear scaling is the claim under test: each member
    solves a third of the gangs over a third of the nodes.

    Gates (nonzero exit): the routed workload must actually land on >=
    2 members — a vacuous spread (everything on one member) would make
    the comparison meaningless, not just slow — and the modeled
    federation p50 must beat the single-cluster p50."""
    device = regime_device(args, device)
    import os
    import tempfile
    from collections import Counter

    from ..cluster import make_nodes
    from ..controller import Harness
    from ..federation import FederationCoordinator

    small = args.small
    clusters = 3
    per_cluster_nodes = 24 if small else 64
    fan = 6 if small else 12
    per_pcs = 2 if small else 4
    repeats = 3 if small else 5
    total_gangs = fan * per_pcs
    alloc = {"cpu": 32.0, "memory": 128.0, "tpu": 8.0}
    failures: list[str] = []

    with tempfile.TemporaryDirectory() as td:
        fed = FederationCoordinator(
            {
                "durability": {"wal_dir": os.path.join(td, "fed")},
                "federation": {"enabled": True, "clusters": clusters},
            },
            [
                make_nodes(
                    per_cluster_nodes, allocatable=dict(alloc),
                    name_prefix=f"c{i}-n",
                )
                for i in range(clusters)
            ],
            device=device,
        )
        single = Harness(
            device=device,
            nodes=make_nodes(
                clusters * per_cluster_nodes, allocatable=dict(alloc)
            ),
            config={"durability": {"wal_dir": os.path.join(td, "single")}},
        )
        spread: Counter = Counter()
        routing_walls: list[float] = []
        member_walls: list[float] = []

        def measure_fed(i: int) -> float:
            tag = f"ff{i}"
            workload = _fanned_workload(fan, per_pcs, tag)
            t0 = time.perf_counter()
            homes = [fed.apply(pcs) for pcs in workload]
            routing = time.perf_counter() - t0
            walls = []
            for cell in fed.cells:
                t1 = time.perf_counter()
                cell.harness.settle()
                walls.append(time.perf_counter() - t1)
            spread.update(h for h in homes if h)
            routing_walls.append(routing)
            member_walls.append(max(walls))
            # constant store population run to run (the
            # bench_controlplane delete discipline)
            for j, home in enumerate(homes):
                if home is None:
                    continue
                cell = fed.by_name[home]
                cell.cluster.store.delete(
                    "PodCliqueSet", "default", f"{tag}-{j}"
                )
                fed._routes.pop(("default", f"{tag}-{j}"), None)
            for cell in fed.cells:
                cell.harness.settle()
            return routing + max(walls)

        def measure_single(i: int) -> float:
            tag = f"fs{i}"
            t0 = time.perf_counter()
            for pcs in _fanned_workload(fan, per_pcs, tag):
                single.apply(pcs)
            single.settle()
            wall = time.perf_counter() - t0
            for j in range(fan):
                single.store.delete("PodCliqueSet", "default", f"{tag}-{j}")
            single.settle()
            return wall

        # warm both sides once (JIT compilation + store genesis land
        # outside the timed repeats on both sides equally)
        measure_fed(-1)
        measure_single(-1)
        spread.clear()
        routing_walls.clear()
        member_walls.clear()
        fed_walls, single_walls = interleaved_ab(
            measure_fed, measure_single, repeats
        )
        fed.close()

    speedup = p50(single_walls) / max(p50(fed_walls), 1e-9)
    out = {
        "bench": "federation",
        "clusters": clusters,
        "nodes_per_cluster": per_cluster_nodes,
        "total_gangs": total_gangs,
        "repeats": repeats,
        "modeled_speedup": round(speedup, 3),
        "spread": {name: spread[name] for name in sorted(spread)},
        **wall_stats(fed_walls, "federation_modeled_", round_to=3),
        **wall_stats(single_walls, "single_cluster_", round_to=3),
        **wall_stats(routing_walls, "routing_", round_to=4),
        **wall_stats(member_walls, "slowest_member_", round_to=3),
        "backend": backend_name(device),
    }
    if len([c for c in spread if spread[c] > 0]) < 2:
        failures.append(
            f"vacuous spread: the routed workload landed on "
            f"{sorted(spread)} — a federation comparison needs >= 2 "
            "members doing work"
        )
    if speedup <= 1.0:
        failures.append(
            f"modeled federation throughput gained nothing: speedup "
            f"{round(speedup, 3)} <= 1.0 over the single cluster"
        )
    for f in failures:
        print(f"FEDERATION BENCH FAILURE: {f}", file=sys.stderr)
    print(json.dumps(out))
    return 1 if failures else 0
