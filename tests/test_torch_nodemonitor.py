"""The port's node lifecycle and leader election against the JAX
package's, in lockstep.

The reference's tests of tests/test_nodehealth.py (heartbeat loss and
NotReady, flap damping, gang-aware drains, domain outages, the
scheduler's stale state on node loss, cordon hardening, the knobs) and of
tests/test_leaderelection.py (the handover between a leader and a
standby over one store) run here against `LockstepHarness`
(test_torch_harness.py): both packages equal after every step in settled
fingerprint, pods, PodGangs, events, metrics (less the engine's io
bytes), decision records and object counts. The node-fault chaos cases
are later lockstep work (ROADMAP item 8h); the sharded plane's
lease cases run in tests/test_torch_sharding.py.

Beside them, seeded lifecycles with the short windows of the verify
skill: heartbeat loss, a drain, a rack outage (`fail_domain`), each
recovered by stepped advances (one `advance(1.0)` at a time: a single
jump past the lease is a renewal gap), in lockstep after every step.
"""

from __future__ import annotations

import numpy as np
import pytest

import test_leaderelection as ref_le
import test_nodehealth as ref_nodehealth
from test_torch_harness import (  # noqa: F401 - fixtures used by name
    _compare_at_teardown,
    inherit,
    lockstep,
)


@pytest.fixture(autouse=True, scope="module")
def _reference_in_lockstep():
    with lockstep(ref_nodehealth, ref_le):
        yield


globals().update(inherit(
    ref_nodehealth, "NodeHealth",
    classes=("TestHeartbeatNotReady", "TestFlapStability",
             "TestGangAwareDrain", "TestDomainOutage",
             "TestSchedulerStaleStateOnNodeLoss", "TestCordonHardening",
             "TestConfigKnobs"),
    # it swaps the store's update for a closure over one package's bound
    # method, which a lockstep store cannot carry to the other package
    leave_out={"TestCordonHardening": (
        "test_cordon_survives_transient_conflict_storm",)}))

# test_leaderelection's handover cases (its two shard-lease cases run in
# tests/test_torch_sharding.py)
for _name in ("test_standby_runs_nothing_while_leader_holds_lease",
              "test_standby_takes_over_after_lease_expiry",
              "test_clean_release_hands_off_immediately",
              "test_no_split_brain_under_alternating_steps",
              "test_standby_autoscale_is_a_noop",
              "test_failover_with_in_flight_solve_dispatch",
              "test_randomized_ha_interleavings_never_split_brain"):
    globals()[_name.replace("test_", "test_lockstep_", 1)] = getattr(
        ref_le, _name)
del _name

RACK_KEY = ref_nodehealth.RACK_KEY


def _gangs(h, n):
    for i in range(n):
        h.apply(ref_nodehealth.workload(name=f"w{i}", replicas=3,
                                        min_available=2))


def _recover(h, steps):
    for _ in range(steps):
        h.advance(1.0)


@pytest.mark.parametrize("seed", (0, 1, 2, 3))
def test_lifecycle_sequence_in_lockstep(seed):
    """A settled gang workload through heartbeat loss, a drain and a rack
    outage, each followed by a stepped recovery; the node chosen by the
    seed."""
    rng = np.random.default_rng(seed)
    with lockstep(ref_nodehealth):
        h = ref_nodehealth.fast_harness(nodes=16)
        _gangs(h, 4)
        h.settle()
        bound = sorted({p.node_name for p in h.store.list("Pod")
                        if p.node_name})
        assert bound
        # heartbeat loss past the lease and the eviction grace
        victim = str(rng.choice(bound))
        h.kubelet.fail_heartbeat(victim)
        _recover(h, 20)
        h.kubelet.restore_heartbeat(victim)
        _recover(h, 12)
        # a drain of another busy node
        bound = sorted({p.node_name for p in h.store.list("Pod")
                        if p.node_name and p.node_name != victim})
        h.cluster.drain(str(rng.choice(bound)))
        _recover(h, 6)
        # a rack outage, then its heartbeats back
        node = h.store.get("Node", "default", str(rng.choice(bound)))
        rack = node.metadata.labels[RACK_KEY]
        h.cluster.fail_domain(RACK_KEY, rack)
        _recover(h, 20)
        h.cluster.recover_domain(RACK_KEY, rack)
        _recover(h, 12)
        assert h.steps >= 70
        dump = h._t.debug_dump()["node_lifecycle"]
        assert dump == h._j.debug_dump()["node_lifecycle"]
