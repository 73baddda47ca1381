"""The port's topology encoding (grove_tpu_torch.topology).

The cases of tests/test_topology.py on the port, then the eligibility
masks (`TopologySnapshot.eligibility`: node selectors, taints and
tolerations) of both packages on seeded clusters and pod filters: equal
element for element, cached per content, and `has_taints` equal.
"""

import numpy as np
import pytest

import grove_tpu.api.meta as jax_meta
import grove_tpu.api.types as jax_types
import grove_tpu.topology as jax_topology

from grove_tpu_torch.api.meta import ObjectMeta
from grove_tpu_torch.api.types import Node, TopologyLevel
from grove_tpu_torch.topology import (
    HOST_LABEL_KEY,
    default_cluster_topology,
    encode_topology,
)


def make_node(name, labels, cpu=8.0, mem=32e9, tpu=4.0, unschedulable=False):
    return Node(
        metadata=ObjectMeta(name=name, labels=dict(labels)),
        allocatable={"cpu": cpu, "memory": mem, "tpu": tpu},
        unschedulable=unschedulable,
    )


def two_rack_nodes():
    nodes = []
    for b in range(2):
        for r in range(2):
            for h in range(2):
                # rack label value repeats across blocks on purpose: the
                # path-prefix encoding must still keep them distinct domains.
                nodes.append(
                    make_node(
                        f"n-{b}-{r}-{h}",
                        {"topo/block": f"block-{b}", "topo/rack": f"rack-{r}"},
                    )
                )
    return nodes


def topo():
    return default_cluster_topology(
        [
            TopologyLevel(domain="block", key="topo/block"),
            TopologyLevel(domain="rack", key="topo/rack"),
        ]
    )


class TestDefaultClusterTopology:
    def test_host_level_auto_added_and_sorted(self):
        ct = default_cluster_topology(
            [
                TopologyLevel(domain="rack", key="topo/rack"),
                TopologyLevel(domain="block", key="topo/block"),
            ]
        )
        assert [lv.domain for lv in ct.spec.levels] == ["block", "rack", "host"]
        assert ct.spec.levels[-1].key == HOST_LABEL_KEY
        assert ct.metadata.name == "grove-topology"

    def test_host_not_duplicated(self):
        ct = default_cluster_topology(
            [TopologyLevel(domain="host", key="custom/host")]
        )
        assert [lv.domain for lv in ct.spec.levels] == ["host"]


class TestEncodeTopology:
    def test_shapes_and_hierarchical_ids(self):
        snap = encode_topology(topo(), two_rack_nodes())
        assert snap.num_levels == 3  # block, rack, host
        assert snap.num_nodes == 8
        # 2 blocks, 4 racks (2 per block despite repeated label), 8 hosts
        assert list(snap.num_domains) == [2, 4, 8]
        # rack ids differ across blocks even though the label value repeats
        rack_ids = snap.domain_ids[1]
        assert rack_ids[0] == rack_ids[1]          # same block, same rack
        assert rack_ids[0] != rack_ids[2]          # same block, other rack
        assert rack_ids[0] != rack_ids[4]          # other block, same label

    def test_membership_matrix(self):
        snap = encode_topology(topo(), two_rack_nodes())
        m = snap.membership(1)  # racks
        assert m.shape == (8, 4)
        np.testing.assert_allclose(m.sum(axis=1), np.ones(8))
        np.testing.assert_allclose(m.sum(axis=0), np.full(4, 2.0))

    def test_capacity_free_usage(self):
        nodes = two_rack_nodes()
        snap = encode_topology(
            topo(), nodes, usage={"n-0-0-0": {"cpu": 3.0, "tpu": 2.0}}
        )
        ci = snap.resource_names.index("cpu")
        ti = snap.resource_names.index("tpu")
        ni = snap.node_index["n-0-0-0"]
        assert snap.capacity[ni, ci] == 8.0
        assert snap.free[ni, ci] == 5.0
        assert snap.free[ni, ti] == 2.0
        other = snap.node_index["n-1-1-1"]
        assert snap.free[other, ci] == 8.0

    def test_unschedulable_and_missing_labels(self):
        nodes = two_rack_nodes()
        nodes[3].unschedulable = True
        nodes.append(make_node("n-orphan", {}))  # no topology labels at all
        snap = encode_topology(topo(), nodes)
        assert not snap.schedulable[3]
        assert snap.schedulable[0]
        # Orphan gets singleton domains — never packs with labelled nodes.
        orphan = snap.node_index["n-orphan"]
        for level in range(snap.num_levels):
            same = (snap.domain_ids[level] == snap.domain_ids[level, orphan]).sum()
            assert same == 1

    def test_level_index_lookup(self):
        snap = encode_topology(topo(), two_rack_nodes())
        assert snap.level_index("topo/rack") == 1
        assert snap.level_index(HOST_LABEL_KEY) == 2


def test_host_level_inserted_above_numa():
    """Auto-added host level must sort above numa (review finding r1-2)."""
    from grove_tpu_torch.api.types import TopologyLevel

    ct = default_cluster_topology(
        [
            TopologyLevel(domain="rack", key="topo/rack"),
            TopologyLevel(domain="numa", key="topo/numa"),
        ]
    )
    # default path appends host before sorting
    assert [lv.domain for lv in ct.spec.levels] == ["rack", "host", "numa"]

    # encode path: two hosts in one rack, each with numa-0 — numa domains
    # must stay distinct per host.
    from grove_tpu_torch.api.types import ClusterTopology, ClusterTopologySpec

    raw = ClusterTopology(
        spec=ClusterTopologySpec(
            levels=[
                TopologyLevel(domain="rack", key="topo/rack"),
                TopologyLevel(domain="numa", key="topo/numa"),
            ]
        )
    )
    nodes = [
        make_node("hostA", {"topo/rack": "r0", "topo/numa": "numa-0"}),
        make_node("hostB", {"topo/rack": "r0", "topo/numa": "numa-0"}),
    ]
    snap = encode_topology(raw, nodes)
    assert snap.level_keys == ["topo/rack", HOST_LABEL_KEY, "topo/numa"]
    numa_level = snap.level_index("topo/numa")
    assert snap.domain_ids[numa_level, 0] != snap.domain_ids[numa_level, 1]


# -- eligibility against the JAX package --------------------------------------


def seeded_cluster(meta, types, topology, seed: int):
    """48 nodes over 3 blocks x 4 racks with a seeded `accel` label on
    some and seeded taints (from two keys) on some, in the given
    package."""
    rng = np.random.default_rng(seed)
    nodes = []
    for i in range(48):
        labels = {"topo/block": f"b{i // 16}", "topo/rack": f"r{i // 4}"}
        if rng.random() < 0.5:
            labels["accel"] = str(rng.choice(["a100", "h100", "tpu"]))
        taints = [t for t in ("maint", "spot") if rng.random() < 0.2]
        nodes.append(types.Node(
            metadata=meta.ObjectMeta(name=f"n{i}", labels=labels),
            allocatable={"cpu": 8.0, "tpu": 4.0}, taints=taints))
    ct = topology.default_cluster_topology([
        types.TopologyLevel(domain="block", key="topo/block"),
        types.TopologyLevel(domain="rack", key="topo/rack"),
    ])
    return topology.encode_topology(ct, nodes)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_eligibility_matches_the_jax_package(seed):
    from grove_tpu_torch.api import meta, types
    from grove_tpu_torch import topology

    ours = seeded_cluster(meta, types, topology, seed)
    ref = seeded_cluster(jax_meta, jax_types, jax_topology, seed)
    assert ours.has_taints == ref.has_taints
    rng = np.random.default_rng(100 + seed)
    for _ in range(12):
        selector = {}
        if rng.random() < 0.6:
            selector["accel"] = str(rng.choice(["a100", "h100", "tpu", "x"]))
        if rng.random() < 0.3:
            selector["topo/block"] = f"b{rng.integers(0, 3)}"
        tolerations = [t for t in ("maint", "spot") if rng.random() < 0.5]
        got = ours.eligibility(selector, tolerations)
        want = ref.eligibility(selector, tolerations)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        # cached per content: the same filter gives the same object back
        assert ours.eligibility(dict(selector), list(tolerations)) is got
        assert not got.flags.writeable
