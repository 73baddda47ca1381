"""The port's defragmenter, what-if program and HPA sweep against the JAX
package's, in lockstep.

The reference's own tests of tests/test_defrag.py (the what-if, the
migration machinery, the sweep, the shared disruption budget) and of
tests/test_autoscaler.py run here against `LockstepHarness` and
`LockstepEngine` (test_torch_harness.py): both packages after every step
equal in settled fingerprint, pods, PodGangs, events, metrics (less the
engine's io bytes), decision and migration audit records and object
counts, and every sweep's stats dict (what-if path, candidates, admitted,
rejections) equal.

Beside them, the what-if itself:
- `whatif_scores` is bit-equal to the JAX engine's (`top_val`, `top_dom`,
  the order) on the same engine state, with and without `free_rows`, and
  with rows staged and not yet shipped;
- it leaves the resident tensor, the mirror, the epoch, the staged rows
  and the incremental cache as they were, and the next real solve still
  ships the staged rows (the cases of test_defrag.py:174-262);
- through the graph cache (`EagerGraphs`, FusedGraphs' logic on the CPU):
  the same bits as the eager path, one capture then replays counted under
  "whatif", and evicting the what-if graph drops nothing else.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from grove_tpu.solver import PlacementEngine as JaxEngine
from grove_tpu_torch.solver import PlacementEngine as TorchEngine
from grove_tpu_torch.solver import programs

import test_autoscaler as ref_autoscaler
import test_defrag as ref_defrag
from test_solver import cluster, gang
from test_torch_graph_cache import eager_graph_engine
from test_torch_harness import (  # noqa: F401 - fixtures used by name
    _compare_at_teardown,
    inherit,
    lockstep,
    to_port,
)


@pytest.fixture(autouse=True, scope="module")
def _reference_in_lockstep():
    with lockstep(ref_defrag, ref_autoscaler):
        yield


# the reference's defrag cases (its config and ledger cases build no
# harness; the migration-storm chaos is later lockstep work, ROADMAP
# item 8h)
globals().update(inherit(
    ref_defrag, "Defrag",
    classes=("TestWhatIf", "TestMigrationMachinery", "TestDefragSweep",
             "TestBudgetSharing")))
# the reference's HPA cases (its config validation builds no harness)
globals().update(inherit(
    ref_autoscaler, "Autoscaler",
    classes=("TestToleranceAndClamping", "TestMissingMetrics",
             "TestPodSelection", "TestStabilizationWindow", "TestMetricsGC",
             "TestHPAAdmission")))


# -- the what-if, engine by engine ---------------------------------------------------
def engines(snap, **knobs):
    """The JAX engine and the port's (CPU) on one snapshot."""
    return JaxEngine(snap, **knobs), TorchEngine(to_port(snap), device="cpu",
                                                 **knobs)


def both(ej, et, method, *args, **kwargs):
    """Call `method` on both engines with the same (carried) arguments."""
    targs, tkwargs = to_port(args), to_port(kwargs)
    return (getattr(ej, method)(*args, **kwargs),
            getattr(et, method)(*targs, **tkwargs))


def assert_whatif_equal(rj, rt):
    assert (rj is None) == (rt is None)
    if rj is None:
        return
    np.testing.assert_array_equal(rt[0], rj[0])
    np.testing.assert_array_equal(rt[1], rj[1])
    assert rt[0].dtype == rj[0].dtype and rt[1].dtype == rj[1].dtype
    assert [(g.namespace, g.name) for g in rt[2]] == \
        [(g.namespace, g.name) for g in rj[2]]


def backlog(rng, n, prefix="g"):
    """`n` gangs of 1-4 pods of 1-4 CPUs, some block-packed."""
    out = []
    for i in range(n):
        pods = int(rng.integers(1, 5))
        out.append(gang(f"{prefix}{i}", pods=pods,
                        cpu=float(rng.integers(1, 5)),
                        required=int(rng.choice([-1, 0])),
                        priority=float(rng.integers(0, 3))))
    return out


def resident(et) -> dict:
    """The port engine's state a what-if must leave alone."""
    st = et._state
    return {
        "free": None if st.dev is None else st.dev.clone(),
        "mirror": None if st.mirror is None else st.mirror.copy(),
        "epoch": st.epoch,
        "staged": None if et._staged is None else {
            k: v.copy() for k, v in et._staged.items()},
        "inc": et._inc,
        "inc_value": (None if et._inc is None or et._inc.value_dev is None
                      else et._inc.value_dev.clone()),
        "uploads": (st.full_uploads, st.delta_uploads),
    }


def assert_untouched(before: dict, et) -> None:
    after = resident(et)
    assert after["epoch"] == before["epoch"]
    assert after["uploads"] == before["uploads"]
    assert torch.equal(after["free"], before["free"])
    np.testing.assert_array_equal(after["mirror"], before["mirror"])
    assert (after["staged"] is None) == (before["staged"] is None)
    if before["staged"] is not None:
        assert after["staged"].keys() == before["staged"].keys()
        for k in before["staged"]:
            np.testing.assert_array_equal(after["staged"][k],
                                          before["staged"][k])
    assert after["inc"] is before["inc"]
    if before["inc_value"] is not None:
        assert torch.equal(after["inc_value"], before["inc_value"])


KNOBS = {
    "default": {},
    "kernel tier": {"pallas_core": True, "device_commit": True},
}


@pytest.mark.parametrize("knobs", sorted(KNOBS))
@pytest.mark.parametrize("seed", (0, 1, 2, 3))
def test_whatif_bit_equal_and_untouching(seed, knobs):
    """After a real solve: a what-if with the free matrix synced, then
    with hypothetical rows, then with rows staged (committed capacity the
    resident tensor has not received yet) and the caller's rows on top;
    bit-equal to the JAX engine each time, and the port's resident state
    untouched by each."""
    rng = np.random.default_rng(seed)
    snap = cluster(blocks=2, racks=2, hosts=4, cpu=8.0)
    ej, et = engines(snap, **KNOBS[knobs])
    free = snap.free.copy()
    rj, rt = both(ej, et, "solve", backlog(rng, 6), free=free)
    assert rt.num_placed == rj.num_placed > 0
    # the repair's commits moved `free` in place: the first what-if
    # stages them through its sync, like the reference's
    probe = backlog(rng, 3, prefix="w")
    assert_whatif_equal(*both(ej, et, "whatif_scores", probe, free=free))
    before = resident(et)
    assert_whatif_equal(*both(ej, et, "whatif_scores", probe, free=free))
    assert_untouched(before, et)
    # hypothetical rows: two nodes emptied, one cordoned-to-zero
    rows = {1: snap.capacity[1], 5: snap.capacity[5],
            9: np.zeros_like(snap.capacity[9])}
    assert_whatif_equal(*both(ej, et, "whatif_scores", probe, free=free,
                              free_rows=rows))
    assert_untouched(before, et)
    # rows staged and not shipped: the busiest node emptied and another
    # halved, the sync deferred
    free2 = free.copy()
    busy = np.argsort((snap.capacity - free).sum(axis=1))[::-1]
    free2[busy[0]] = snap.capacity[busy[0]]
    free2[busy[1]] = snap.capacity[busy[1]] * 0.5
    changed = set(np.flatnonzero((free2 != free).any(axis=1)).tolist())
    assert changed
    assert_whatif_equal(*both(ej, et, "whatif_scores", probe, free=free2))
    assert et._staged is not None and changed <= set(et._staged)
    assert ej._staged is not None and set(et._staged) == set(ej._staged)
    before = resident(et)
    assert_whatif_equal(*both(ej, et, "whatif_scores", probe, free=free2,
                              free_rows={7: snap.capacity[7]}))
    assert_untouched(before, et)
    assert et.dispatch_counts() == ej.dispatch_counts()
    # the next real solve still ships the staged rows
    delta = et.dispatch_counts()["state_delta_uploads"]
    rj, rt = both(ej, et, "solve", backlog(rng, 4, prefix="h"), free=free2)
    assert rt.num_placed == rj.num_placed
    assert et._staged is None and ej._staged is None
    assert et.dispatch_counts() == ej.dispatch_counts()
    assert et.dispatch_counts()["state_delta_uploads"] >= delta
    np.testing.assert_array_equal(et._state.dev[:-1].numpy(),
                                  et._state.mirror)


def test_whatif_refusals_match():
    """None where the reference returns None: nothing synced, the state
    cache off, every gang unschedulable."""
    snap = cluster(blocks=1, racks=2, hosts=2, cpu=4.0)
    ej, et = engines(snap)
    assert_whatif_equal(*both(ej, et, "whatif_scores", [gang("w", 1)]))
    ej, et = engines(snap, state_cache=False)
    both(ej, et, "solve", [gang("g", 1)], free=snap.free.copy())
    assert_whatif_equal(*both(ej, et, "whatif_scores", [gang("w", 1)],
                              free=snap.free.copy()))


def test_whatif_through_the_graph_cache(monkeypatch):
    """The what-if as a graph of the engine's cache (FusedGraphs' logic,
    run eagerly on the CPU): bit-equal to the eager engine and the JAX
    engine, captured once per key and replayed after, counted under
    "whatif", never writing the resident tensor; evicting it leaves the
    incremental cache in place."""
    rng = np.random.default_rng(5)
    snap = cluster(blocks=2, racks=2, hosts=4, cpu=8.0)
    eg = eager_graph_engine(to_port(snap), monkeypatch)
    ej = JaxEngine(snap, pallas_core=True, device_commit=True)
    free = snap.free.copy()
    gangs = backlog(rng, 6)
    ej.solve(gangs, free=free.copy())
    eg.solve(to_port(gangs), free=free.copy())
    free2 = free.copy()
    free2[2] = 0.0
    programs.reset_replays()
    probe = backlog(rng, 3, prefix="w")
    for rows in (None, {4: snap.capacity[4]}, None, {4: snap.capacity[4]}):
        before = resident(eg)
        rt = eg.whatif_scores(to_port(probe), free=free2,
                              free_rows=to_port(rows))
        rj = ej.whatif_scores(probe, free=free2, free_rows=rows)
        assert_whatif_equal(rj, rt)
        if before["free"] is not None and rows is not None:
            assert torch.equal(eg._state.dev, before["free"])
    graphs = eg._graphs
    whatif_keys = [k for k in graphs._lru.keys() if k[0] == "whatif"]
    assert len(whatif_keys) == 2           # without and with an overlay
    assert graphs.whatif_replays == 4
    assert programs.replay_counts()["whatif"] == 4
    assert eg.debug_summary()["fused_graphs"]["whatif_replays"] == 4
    assert eg.dispatch_counts()["whatif"] == 4
    # evicting the what-if graphs drops only their own entries
    inc = eg._inc
    assert inc is not None and inc.value_dev is not None
    for key in whatif_keys:
        eg._graph_evicted(key, graphs._lru.get(key))
    assert eg._inc is inc and inc.value_dev is not None


@pytest.mark.parametrize("seed", (0, 1))
def test_defrag_sweeps_equal_on_a_fragmented_fleet(seed):
    """A fragmented fleet swept repeatedly (cadenced and storm sweeps):
    stats, migrations, audit records and the planes equal after every
    sweep, the what-if on the device path, no full re-encode attributed
    to the defragmenter."""
    rng = np.random.default_rng(seed)
    with lockstep(ref_defrag):
        h, node_of = ref_defrag.frag_harness()
        ref_defrag.spanning_target(h, node_of)
        names = sorted(node_of)
        for name in rng.choice(names, size=3, replace=False):
            h.store.delete("PodCliqueSet", "default", str(name))
        h.settle()
        kinds = []
        for i in range(5):
            h.advance(61.0)
            stats = h.defrag_sweep(storm=(i == 3))
            h.settle()
            kinds.append(stats["whatif"])
            attributed = h._t.defrag.dispatch_kinds
            for kind in ("fused", "split", "state_full_uploads"):
                assert attributed.get(kind, 0) == 0, kind
        assert set(kinds) <= {"device", None} and "device" in kinds
        assert h._t.defrag.dispatch_kinds == h._j.defrag.dispatch_kinds
        assert h._t.defrag.moves_total == h._j.defrag.moves_total
        assert h._t.defrag.debug_state() == h._j.defrag.debug_state()


def test_whatif_on_a_hierarchical_parent_in_lockstep():
    """A block-confined workload on a hierarchical scheduler engine (the
    5000-node stress case's path, here with hierarchical_min_nodes 0):
    the defragmenter's what-ifs run on the hierarchical parent over the
    full domain set, as the JAX package's do; sweep stats, migrations and
    the planes equal after every sweep."""
    from grove_tpu.api.types import (TopologyConstraintSpec,
                                     TopologyPackConstraintSpec)
    from test_torch_harness import LockstepHarness

    api = ref_defrag
    h = LockstepHarness(
        nodes=api.make_nodes(32, racks_per_block=2, hosts_per_rack=4,
                             allocatable={"cpu": 4.0, "memory": 16.0,
                                          "tpu": 0.0}),
        config={"defrag": dict(api.DEFRAG),
                "solver": {"hierarchical_solve": True,
                           "hierarchical_min_nodes": 0}})
    for i in range(12):
        pcs = api.pcs(f"g{i}", 3, 2.0)
        pcs.spec.template.topology_constraint = TopologyConstraintSpec(
            pack_constraint=TopologyPackConstraintSpec(required="block",
                                                       preferred="rack"))
        h.apply(pcs)
        h.settle()
    for name in ("g1", "g4", "g7", "g10"):
        h.store.delete("PodCliqueSet", "default", name)
    h.settle()
    assert h._t.scheduler._engine._hier is not None
    paths = []
    for storm in (False, False, True):
        h.advance(61.0)
        paths.append(h.defrag_sweep(storm=storm)["whatif"])
        h.settle()
    assert paths == ["device"] * 3
    for kind in ("fused", "split", "state_full_uploads"):
        assert h._t.defrag.dispatch_kinds.get(kind, 0) == \
            h._j.defrag.dispatch_kinds.get(kind, 0)
