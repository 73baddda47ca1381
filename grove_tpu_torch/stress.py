"""The stress configuration of the placement solve, built from this package.

A backlog of 8-pod gangs (1000 at full size) over a kwok-style simulated
cluster (5000 nodes) with a 3-tier block/rack/host topology: the same
cluster and backlog as the JAX package's bench.py (`make_cluster`,
`make_gangs`, and the scale tiers' 4-tier `make_tier_cluster` with its
block-confined `make_tier_gangs`), copied here so chip_smoke.py needs
nothing of grove_tpu.
"""

from __future__ import annotations

import numpy as np

from .api.meta import ObjectMeta
from .api.types import Node, TopologyLevel
from .solver.problem import SolverGang
from .topology.encoding import default_cluster_topology, encode_topology


def make_cluster(num_nodes: int):
    """3-tier topology: ~16 racks/block, 16 hosts/rack."""
    nodes = []
    for i in range(num_nodes):
        b, rem = divmod(i, 256)
        r = rem // 16
        nodes.append(
            Node(
                metadata=ObjectMeta(
                    name=f"n{i}",
                    labels={"t/block": f"b{b}", "t/rack": f"b{b}r{r}"},
                ),
                allocatable={"cpu": 32.0, "memory": 128.0, "tpu": 8.0},
            )
        )
    ct = default_cluster_topology(
        [
            TopologyLevel(domain="block", key="t/block"),
            TopologyLevel(domain="rack", key="t/rack"),
        ]
    )
    return encode_topology(ct, nodes)


def make_tier_cluster(num_nodes: int):
    """4-tier topology: zone (4096 nodes) > block (256) > rack (16) >
    host, as the JAX package's bench.py `make_tier_cluster` builds it."""
    nodes = []
    for i in range(num_nodes):
        z, zr = divmod(i, 4096)
        b = zr // 256
        r = (zr % 256) // 16
        nodes.append(
            Node(
                metadata=ObjectMeta(
                    name=f"n{i}",
                    labels={
                        "t/zone": f"z{z}",
                        "t/block": f"z{z}b{b}",
                        "t/rack": f"z{z}b{b}r{r}",
                    },
                ),
                allocatable={"cpu": 32.0, "memory": 128.0, "tpu": 8.0},
            )
        )
    ct = default_cluster_topology(
        [
            TopologyLevel(domain="zone", key="t/zone"),
            TopologyLevel(domain="block", key="t/block"),
            TopologyLevel(domain="rack", key="t/rack"),
        ]
    )
    return encode_topology(ct, nodes)


def make_tier_gangs(num_gangs: int) -> list[SolverGang]:
    """Block-confined 8-pod gangs (required block, preferred rack) for the
    scale tiers (bench.py --scale-tier: 4000 gangs on 20k nodes, 20000 on
    100k): what confines the backlog so the hierarchy prunes at the block
    level."""
    gangs = []
    demand = np.tile(np.array([4.0, 16.0, 1.0], np.float32), (8, 1))
    for i in range(num_gangs):
        gangs.append(
            SolverGang(
                name=f"tier{i:06d}",
                namespace="bench",
                demand=demand,
                pod_names=[f"tier{i:06d}-p{j}" for j in range(8)],
                group_ids=np.zeros(8, np.int32),
                group_names=["workers"],
                group_required_level=np.array([-1], np.int32),
                group_preferred_level=np.array([-1], np.int32),
                required_level=1,
                preferred_level=2,
            )
        )
    return gangs


def make_gangs(num_gangs: int, grouped: bool = False) -> list[SolverGang]:
    """Mixed backlog: plain 8-pod gangs (block-required, rack-preferred) and
    leader/worker gangs whose two groups each pack a rack.

    grouped=True additionally ties each leader/worker pair into a
    CONSTRAINT GROUP (block-required, like a PCSG inside a base gang) and
    gives the plain gangs a group-preferred rack level."""
    gangs = []
    for i in range(num_gangs):
        demand = np.tile(np.array([4.0, 16.0, 1.0], np.float32), (8, 1))
        if i % 4 == 3:
            # leader/worker: 2 groups x 4 pods, each group rack-packed
            gangs.append(
                SolverGang(
                    name=f"gang{i:05d}",
                    namespace="bench",
                    demand=demand,
                    pod_names=[f"gang{i:05d}-p{j}" for j in range(8)],
                    group_ids=np.repeat(np.arange(2, dtype=np.int32), 4),
                    group_names=["leader", "worker"],
                    group_required_level=np.array([1, 1], np.int32),
                    group_preferred_level=np.array([-1, -1], np.int32),
                    required_level=0,
                    constraint_groups=(
                        [([0, 1], 0, 1)] if grouped else []
                    ),
                )
            )
        else:
            gangs.append(
                SolverGang(
                    name=f"gang{i:05d}",
                    namespace="bench",
                    demand=demand,
                    pod_names=[f"gang{i:05d}-p{j}" for j in range(8)],
                    group_ids=np.zeros(8, np.int32),
                    group_names=["workers"],
                    group_required_level=np.array([-1], np.int32),
                    group_preferred_level=np.array(
                        [1 if grouped else -1], np.int32
                    ),
                    required_level=0,
                    preferred_level=1,
                )
            )
    return gangs
