"""The control-plane operation fuzz through both packages, in lockstep.

tests/test_fuzz_controlplane.py's operation alphabet (apply, cascade
delete, replica scale, container crash, pod eviction and recovery,
virtual-time advance, node add and remove) as seeded numpy sequences,
each operation run against the JAX package's `Harness` and the port's
(`LockstepHarness`, test_torch_harness.py). After every settle both
packages hold the reference's global invariants (no active pod on a lost
node, no node over capacity) and equal planes: settled fingerprint, pods,
PodGangs, events, metrics (less the engine's io bytes), decision records
and object counts. The reference's own seeds run too, and
tests/test_controlplane_scale.py's cases at its sizes.
"""

from __future__ import annotations

import numpy as np
import pytest

import bench as bench_mod
import test_controlplane_scale as ref_scale
import test_fuzz_controlplane as ref_fuzz
from grove_tpu.api.meta import ObjectMeta
from grove_tpu.api.types import Node, Pod
from grove_tpu.chaos.harness import check_invariants
from grove_tpu.cluster import make_nodes
from test_torch_harness import (  # noqa: F401 - fixtures used by name
    LockstepHarness,
    _compare_at_teardown,
    inherit,
    lockstep,
)


@pytest.fixture(autouse=True, scope="module")
def _reference_in_lockstep():
    with lockstep(ref_fuzz, ref_scale):
        yield


# the reference's seeds, in lockstep
test_reference_sequences_in_lockstep = \
    ref_fuzz.test_random_operation_sequences_hold_invariants

globals().update(inherit(
    ref_scale, "Scale",
    # it swaps the scheduler's pre_round for a closure over one package's
    # bound method, which a lockstep harness cannot carry to the other
    leave_out={"TestIncrementality": (
        "test_stale_pre_round_dispatch_falls_back_to_fresh_solve",)}))

OPS = ("apply", "delete", "scale", "crash", "evict", "recover", "advance",
       "node_add", "node_del")


def _invariants(h, seed, step):
    for side in (h._j, h._t):
        assert check_invariants(side.store) == [], (seed, step)


@pytest.mark.parametrize("seed", range(1, 13))
def test_operation_sequences_in_lockstep(seed):
    rng = np.random.default_rng(1000 + seed)
    h = LockstepHarness(nodes=make_nodes(
        24, allocatable={"cpu": 16.0, "memory": 64.0, "tpu": 8.0}))
    alive: list[str] = []
    for step in range(30):
        op = str(rng.choice(OPS))
        if op == "apply" and len(alive) < 6:
            name = f"f{seed}-{step}"
            h.apply(bench_mod._churn_pcs(name, int(rng.integers(1, 4))))
            alive.append(name)
        elif op == "delete" and alive:
            victim = alive.pop(int(rng.integers(0, len(alive))))
            h.store.delete("PodCliqueSet", "default", victim)
        elif op == "scale" and alive:
            target = alive[int(rng.integers(0, len(alive)))]
            pcs = h.store.get("PodCliqueSet", "default", target)
            if pcs is not None and pcs.metadata.deletion_timestamp is None:
                pcs.spec.replicas = int(rng.integers(1, 5))
                h.store.update(pcs)
        elif op in ("crash", "evict", "recover"):
            bound = sorted((p.metadata.namespace, p.metadata.name)
                           for p in h.store.scan(Pod.KIND) if p.node_name)
            if bound:
                ns, name = bound[int(rng.integers(0, len(bound)))]
                getattr(h.kubelet, f"{op}_pod")(ns, name)
        elif op == "advance":
            h.advance(float(rng.integers(1, 30)))
            _invariants(h, seed, step)
            continue
        elif op == "node_add":
            h.store.create(Node(
                metadata=ObjectMeta(name=f"xn{seed}-{step}"),
                allocatable={"cpu": 16.0, "memory": 64.0, "tpu": 8.0}))
        elif op == "node_del":
            extras = sorted(n.metadata.name for n in h.store.scan(Node.KIND)
                            if n.metadata.name.startswith("xn"))
            if extras:
                h.store.delete(Node.KIND, "default", extras[0])
        h.settle()
        _invariants(h, seed, step)
    h.advance(120.0)
    _invariants(h, seed, "final")
    assert h.steps >= 30
