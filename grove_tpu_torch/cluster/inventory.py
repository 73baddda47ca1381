"""kwok-style node inventory generation.

The reference's E2E harness simulates scale with k3d workers and memory
starvation (e2e/setup/k8s_clusters.go:93-107); the stress baseline demands
5000 simulated nodes (BASELINE.json), which is kwok territory. Here nodes
are plain store objects with topology labels, generated in a regular
(block x rack x host) grid.
"""

from __future__ import annotations

from ..api.meta import ObjectMeta
from ..api.types import Node

BLOCK_KEY = "topology.grove/block"
RACK_KEY = "topology.grove/rack"


def make_nodes(
    count: int,
    racks_per_block: int = 16,
    hosts_per_rack: int = 16,
    allocatable: dict[str, float] | None = None,
    name_prefix: str = "node",
) -> list[Node]:
    allocatable = allocatable or {"cpu": 32.0, "memory": 128.0, "tpu": 8.0}
    nodes = []
    per_block = racks_per_block * hosts_per_rack
    for i in range(count):
        block = i // per_block
        rack = (i % per_block) // hosts_per_rack
        nodes.append(
            Node(
                metadata=ObjectMeta(
                    name=f"{name_prefix}-{i}",
                    labels={
                        BLOCK_KEY: f"block-{block}",
                        RACK_KEY: f"block-{block}-rack-{rack}",
                    },
                ),
                allocatable=dict(allocatable),
            )
        )
    return nodes
