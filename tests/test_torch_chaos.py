"""The port's chaos harness against the JAX package's, in lockstep.

tests/test_chaos.py's tests run here against both packages, less the
cases the reference's own tier leaves out (`slow`). The module's
`ChaosHarness` is `LockstepChaosHarness` (tests/torch_lockstep.py): one
ChaosHarness a package from the same seeded `FaultPlan` (the port's
rebuilt from the plan's fields, so its generator starts alike), the
port's engines on the CPU. The two runs draw the same faults at the same
steps: every step (`run_chaos` whole, a manager restart, `settle`,
`advance`) ends with the two plans' fault counts equal and the raw
stores' planes equal (tests/test_torch_harness.py). `Harness` is
`LockstepHarness`, and `ChaosStore` and the classes the unit cases build
in their bodies (`Cluster`, `ObjectStore`, `ControllerManager`) build
one object a package. `settled_fingerprint` and `check_invariants` run
in both and must agree.

Beside them, the port's own cases: `ManagerCrash` passes through the
port's reconcile error path as a `BaseException` (neither the manager nor
the scheduler catches it, nor does the check that the card is present),
a `TransientFault` is a retried reconcile error and not a card failure,
a dispatched solve that a crash abandons is cancelled with its engine
released, and a standby-armed plan (promotions, standby crashes, dual
leaders, replication stalls) runs in lockstep on a replicated plane.
"""

from __future__ import annotations

import pytest

import test_chaos as ref_chaos
import torch_lockstep as ls
from grove_tpu.chaos import ChaosStore as JaxChaosStore
from grove_tpu.cluster.cluster import Cluster as JaxCluster
from grove_tpu.cluster.store import ObjectStore as JaxStore
from grove_tpu.controller.runtime import ControllerManager as JaxManager
from grove_tpu_torch.chaos import ChaosHarness as TorchChaosHarness
from grove_tpu_torch.chaos import ChaosStore as TorchChaosStore
from grove_tpu_torch.chaos import FaultPlan as TorchPlan
from grove_tpu_torch.chaos import ManagerCrash as TorchCrash
from grove_tpu_torch.chaos import TransientFault as TorchFault
from grove_tpu_torch.cluster.cluster import Cluster as TorchCluster
from grove_tpu_torch.cluster.store import ObjectStore as TorchStore
from grove_tpu_torch.controller.runtime import (
    ControllerManager as TorchManager,
)

from test_torch_harness import (  # noqa: F401  (_compare_at_teardown: autouse)
    _PAIRS,
    PATH_ROOTS,
    LockstepHarness,
    _compare_at_teardown,
    inherit,
    to_port,
)


@pytest.fixture(autouse=True, scope="module")
def _chaos_in_lockstep():
    names = {
        "Harness": LockstepHarness,
        "ChaosHarness": ls.LockstepChaosHarness,
        "ChaosStore": ls.LockstepClass(JaxChaosStore, TorchChaosStore),
        "settled_fingerprint": ls.settled_fingerprint,
        "check_invariants": ls.check_invariants,
    }
    with pytest.MonkeyPatch.context() as mp:
        for name, value in names.items():
            mp.setattr(ref_chaos, name, value)
        # the classes the unit cases import in their bodies
        mp.setattr("grove_tpu.cluster.cluster.Cluster",
                   ls.LockstepClass(JaxCluster, TorchCluster))
        mp.setattr("grove_tpu.cluster.store.ObjectStore",
                   ls.LockstepClass(JaxStore, TorchStore))
        mp.setattr("grove_tpu.controller.runtime.ControllerManager",
                   ls.LockstepClass(JaxManager, TorchManager))
        yield


#: the fault-free fixpoint, built with the lockstep harness (module scope,
#: after the swap above)
baseline = ref_chaos.baseline

globals().update(inherit(ref_chaos, "Chaos"))


# -- the lockstep itself --------------------------------------------------------
def test_chaos_lockstep_sees_a_divergence():
    """The chaos comparison is not vacuous: one extra fault counted on
    the port's plan alone fails the next step."""
    ch = ls.LockstepChaosHarness(
        ref_chaos.FaultPlan.from_seed(0), nodes=ref_chaos.make_nodes(8))
    ch.apply(ref_chaos.simple_pcs())
    ch._t.plan.record("write_fault")
    with pytest.raises(AssertionError):
        ch.settle()
    _PAIRS.remove(ch)


def test_a_drawn_plan_is_not_carried():
    """A plan that has drawn cannot start the port's run alike."""
    plan = ref_chaos.FaultPlan.from_seed(3)
    plan.flip(0.5)
    with pytest.raises(AssertionError, match="before its first draw"):
        ls.port_plan(plan)


# -- ManagerCrash, TransientFault, the abandoned dispatch ----------------------
def _port_chaos(plan, nodes=8):
    ch = TorchChaosHarness(plan, nodes=to_port(ref_chaos.make_nodes(nodes)),
                           device="cpu")
    return ref_chaos.quiet(ch)


def test_manager_crash_passes_through_the_reconcile_error_path():
    """A mid-flight ManagerCrash raised from a committed write inside a
    reconcile escapes the port's manager (it is a BaseException, not an
    Exception), records no reconcile error, and the chaos driver then
    restarts the manager."""
    assert issubclass(TorchCrash, BaseException)
    assert not issubclass(TorchCrash, Exception)
    plan = TorchPlan(seed=0, write_fault_rate=0.0, conflict_burst_rate=0.0,
                     midflight_crash_rate=1.0)
    ch = _port_chaos(plan)
    ch.apply(to_port(ref_chaos.chaos_workload()))
    ch.chaos_store.armed = True
    with pytest.raises(TorchCrash):
        ch.harness.manager.settle(5)
    ch.chaos_store.armed = False
    assert ch.manager.errors == []
    assert ch.harness.cluster.metrics.counter(
        "grove_manager_reconcile_errors_total").total() == 0
    ch.restart_manager()
    ch.settle()
    assert all(p.node_name for p in ch.raw_store.scan("Pod"))


def test_transient_fault_is_a_retried_reconcile_error():
    """A TransientFault is a store error the manager records and retries
    (ERR_STORE_CONFLICT), never taken for a card failure: the port's
    scheduler keeps its device and its engine, and the plane converges
    once the faults stop."""
    from grove_tpu_torch.controller.errors import to_grove_error

    assert issubclass(TorchFault, Exception)
    assert to_grove_error(TorchFault("x"), "op").code == "ERR_STORE_CONFLICT"
    plan = TorchPlan(seed=0, write_fault_rate=1.0)
    ch = _port_chaos(plan)
    ch.apply(to_port(ref_chaos.chaos_workload()))
    ch.chaos_store.armed = True
    ch.harness.manager.settle(5)
    ch.chaos_store.armed = False
    assert ch.manager.errors, "the armed plan must fault a write"
    assert all("ERR_STORE_CONFLICT" in msg for _c, _r, msg in
               ch.manager.errors)
    scheduler = ch.harness.scheduler
    assert scheduler._engine_kwargs["device"] == "cpu"
    ch.settle()
    assert ch.harness.scheduler is scheduler
    assert all(p.node_name for p in ch.raw_store.scan("Pod"))


def test_crash_cancels_the_abandoned_dispatch_and_releases_the_engine():
    """A solve dispatched in `pre_round` that the crash abandons is
    cancelled (its token dropped, as `GangScheduler.pre_round` drops an
    unconsumed one) and the dead scheduler's engine released; the
    restarted manager's scheduler solves on the same device."""
    ch = _port_chaos(TorchPlan(seed=0))
    ch.apply(to_port(ref_chaos.chaos_workload()))
    ch.settle()
    pcs = ch.raw_store.get("PodCliqueSet", "default", "simple1")
    pcs.spec.replicas = 3
    ch.raw_store.update(pcs)
    old = ch.harness.scheduler
    for _ in range(20):
        ch.harness.manager.run_once()
        old.pre_round()
        if old._pending is not None:
            break
    pending = old._pending
    assert pending is not None, "a backlog must be dispatched"
    engine = old._engine
    ch.restart_manager()
    assert pending[4].token is None
    assert old._pending is None and old._engine is None
    assert engine._statics is None and engine._free_buf is None
    ch.settle()
    assert ch.harness.scheduler is not old
    assert ch.harness.scheduler._engine_kwargs["device"] == "cpu"
    assert all(p.node_name for p in ch.raw_store.scan("Pod"))


def test_chaos_harness_without_device_solves_on_the_card():
    """No device means the CUDA card: without one the port's ChaosHarness
    raises where its Harness builds the scheduler."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the engine would run there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchChaosHarness(TorchPlan(seed=0),
                          nodes=to_port(ref_chaos.make_nodes(4)))


def test_standby_fault_waits_for_replication(tmp_path):
    """The HA-replication faults (ROADMAP item 8e raised until it was
    ported; the test keeps its name from then): a plan armed with standby
    promotions, standby crashes, dual leaders and replication stalls runs
    in lockstep on a journaled, replicated plane, every step's plane and
    fault counts equal, converging to the fault-free fixpoint with the
    standby caught up; the port's promotions rebuild its engines on the
    CPU."""
    path, pair = ls.twin_tmp_path(tmp_path)
    try:
        plan = ref_chaos.FaultPlan.from_seed(
            0, standby_promotion_rate=0.3, standby_crash_rate=0.2,
            dual_leader_rate=0.2, replication_stall_rate=0.2)
        ch = ls.LockstepChaosHarness(
            plan, nodes=ref_chaos.make_nodes(8), config={
                "durability": {"wal_dir": str(path / "wal"),
                               "fsync": "never"},
                "replication": {"enabled": True, "ack_mode": "semi-sync",
                                "standby_wal_dir": str(path / "standby")}})
        ref_chaos.quiet(ch._j)
        ref_chaos.quiet(ch._t)
        ch.apply(ref_chaos.chaos_workload())
        ch.run_chaos()
        assert ch._t.standby_promotions == ch._j.standby_promotions > 0
        standby = ch._t.harness.cluster.standby
        assert standby is not None and standby.lag_records() == 0
        assert ls.check_invariants(ch.raw_store) == []
        assert all(s._engine_kwargs["device"] == "cpu"
                   for s in ch._t.harness.schedulers())
        ch.compare("end")
    finally:
        PATH_ROOTS.remove(pair)
