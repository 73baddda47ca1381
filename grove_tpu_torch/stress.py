"""The stress configuration of the placement solve, built from this package.

A backlog of 8-pod gangs (1000 at full size) over a kwok-style simulated
cluster (5000 nodes, `stress_inventory` as Node objects and a
ClusterTopology, `make_cluster` as its snapshot) with a 3-tier
block/rack/host topology: the same
cluster and backlog as the JAX package's bench.py (`make_cluster`,
`make_gangs`, and the scale tiers' 4-tier `make_tier_cluster` with its
block-confined `make_tier_gangs`), copied here so chip_smoke.py needs
nothing of grove_tpu. `make_podgangs` writes the stress backlog the way the
control plane hands it over, as PodGangs with their Pods, optionally with
node selectors and tolerations against a cluster whose nodes carry taints
(`make_cluster(..., taint_every=...)`), and `encode_stress_podgangs`
encodes it with `solver.problem.encode_podgangs`.
"""

from __future__ import annotations

import numpy as np

from .api.meta import NamespacedName, ObjectMeta
from .api.podgang import (
    PodGang,
    PodGangSpec,
    PodGroup,
    TopologyConstraint,
    TopologyPackConstraint,
)
from .api.types import Container, Node, Pod, PodSpec, TopologyLevel
from .solver.problem import SolverGang, encode_podgangs
from .topology.encoding import default_cluster_topology, encode_topology


#: the taint `make_cluster(taint_every=...)` puts on nodes, and the key a
#: constrained PodGang backlog tolerates
TAINT = "maintenance"


def stress_inventory(num_nodes: int, taint_every: int = 0):
    """The stress cluster as the control plane holds it: (Node list,
    ClusterTopology). 3-tier topology: ~16 racks/block, 16 hosts/rack.
    `taint_every` > 0 taints every taint_every-th node with TAINT (20: 5%
    of the nodes)."""
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
                taints=[TAINT] if taint_every and i % taint_every == 0 else [],
            )
        )
    ct = default_cluster_topology(
        [
            TopologyLevel(domain="block", key="t/block"),
            TopologyLevel(domain="rack", key="t/rack"),
        ]
    )
    return nodes, ct


def make_cluster(num_nodes: int, taint_every: int = 0):
    """The stress cluster's topology snapshot (`stress_inventory`
    encoded)."""
    nodes, ct = stress_inventory(num_nodes, taint_every)
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


def make_podgangs(num_gangs: int, constrained: bool = False,
                  num_blocks: int = 1, start: int = 0):
    """`make_gangs(num_gangs)` written as the control plane hands it over:
    (PodGangs, {(namespace, pod name): Pod}). A plain gang packs a block
    (required) and prefers a rack, one group of 8 pods; a leader/worker
    gang packs a block with two groups of 4 pods, each packing a rack.
    Encoded by `encode_stress_podgangs`, the gangs equal make_gangs' field
    by field. `constrained` puts a node selector (the gang's block among
    `num_blocks`, by gang index) on one pod in four, pods 0 and 4 of each
    gang, and a toleration of TAINT on pod 0 of them, half the selected."""
    block = TopologyConstraint(TopologyPackConstraint(required="t/block",
                                                      preferred="t/rack"))
    lw_block = TopologyConstraint(TopologyPackConstraint(required="t/block"))
    rack = TopologyConstraint(TopologyPackConstraint(required="t/rack"))
    podgangs, pods = [], {}
    for i in range(start, start + num_gangs):
        name = f"gang{i:05d}"
        refs = []
        for j in range(8):
            spec = PodSpec(containers=[Container(
                name="main",
                resources={"cpu": 4.0, "memory": 16.0, "tpu": 1.0})])
            if constrained and j % 4 == 0:
                spec.node_selector = {"t/block": f"b{i % num_blocks}"}
                if j == 0:
                    spec.tolerations = [TAINT]
            pod = Pod(metadata=ObjectMeta(name=f"{name}-p{j}",
                                          namespace="bench"), spec=spec)
            pods[("bench", pod.metadata.name)] = pod
            refs.append(NamespacedName("bench", pod.metadata.name))
        if i % 4 == 3:
            groups = [PodGroup("leader", refs[:4], 4, rack),
                      PodGroup("worker", refs[4:], 4, rack)]
            gang_tc = lw_block
        else:
            groups = [PodGroup("workers", refs, 8)]
            gang_tc = block
        podgangs.append(PodGang(
            metadata=ObjectMeta(name=name, namespace="bench"),
            spec=PodGangSpec(pod_groups=groups, topology_constraint=gang_tc)))
    return podgangs, pods


def encode_stress_podgangs(snapshot, podgangs, pods) -> list[SolverGang]:
    """`encode_podgangs` over `make_podgangs`' output: each pod's demand
    is its containers' requests in the snapshot's resource order, and its
    node filter its selector and tolerations."""
    names = snapshot.resource_names

    def pod_demand(namespace, name):
        pod = pods.get((namespace, name))
        if pod is None:
            return None
        req = pod.spec.total_requests()
        return np.asarray([req.get(r, 0.0) for r in names], np.float32)

    def pod_scheduling(namespace, name):
        spec = pods[(namespace, name)].spec
        return spec.node_selector, spec.tolerations

    return encode_podgangs(podgangs, snapshot, pod_demand,
                           pod_scheduling=pod_scheduling)
