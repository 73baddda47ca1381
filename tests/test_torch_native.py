"""grove_tpu_torch's native C++ serial solve and exact repair vs the JAX
package's, on the CPU (g++ builds both libraries here).

The same cluster and backlog, carried across with grove_tpu_torch.convert,
go through the JAX package's `solve_serial_native` / `repair_native` and
the port's; the port's serial solve is also held against its own Python
`solve_serial`. Shapes are those of tests/test_native.py: the mixed
backlog, contention, cordoned nodes, the grouped parity cases (constraint
groups, group and gang preferred levels, two constraint groups in one
gang), the 25-trial seed-42 grouped fuzz and the held-unschedulable gang,
plus every case of tests/test_torch_engine.py (eligibility masks,
starvation, priorities). Required, exactly: the same placed set, the same
node per pod, equal placement scores, the same unplaced gangs (with the
same UnsatCode and funnel where the JAX side diagnoses), and for the
repair the same fallback count and the same residual free matrix.

The port's build differs from the reference on purpose: a failed g++
build or an ABI mismatch raises instead of returning None.
"""

import dataclasses

import numpy as np
import pytest

from grove_tpu.native.serial_native import repair_native as jax_repair_native
from grove_tpu.native.serial_native import (
    solve_serial_native as jax_solve_serial_native,
)
from grove_tpu.solver.engine import DomainSpace as JaxDomainSpace
from grove_tpu.solver.problem import UNRESOLVED_LEVEL
from grove_tpu.solver.serial import gang_sort_key as jax_gang_sort_key

import bench
from grove_tpu_torch import build
from grove_tpu_torch.native import build as native_build
from grove_tpu_torch.native import repair_native, solve_serial_native
from grove_tpu_torch.native.serial_native import domain_node_index
from grove_tpu_torch.solver import PlacementEngine, solve_serial

from test_native import backlog, grouped_gang
from test_solver import cluster, gang
from test_torch_engine import CASES, _convert, assert_same_result


def _assert_serial_parity(snap, gangs):
    """Port native == JAX native, exactly; port native == port Python
    serial in placements and unplaced names (the native path diagnoses an
    unplaced gang against the final residual, the Python serial path at
    the moment the gang fails, so their messages may differ, as in the
    JAX package)."""
    tsnap, tgangs = _convert(snap, gangs)
    ref = jax_solve_serial_native(snap, gangs)
    assert ref is not None  # the JAX package found its toolchain
    out = solve_serial_native(tsnap, tgangs)
    assert_same_result(ref, out)
    tsnap, tgangs = _convert(snap, gangs)
    py = solve_serial(tsnap, tgangs)
    assert sorted(py.placed) == sorted(out.placed)
    assert sorted(py.unplaced) == sorted(out.unplaced)
    for name, p in py.placed.items():
        np.testing.assert_array_equal(out.placed[name].node_indices,
                                      p.node_indices)
        assert out.placed[name].placement_score == p.placement_score
    return out


def _grouped_cases():
    return {
        "constraint_group": (
            cluster(blocks=2, racks=2, hosts=4, cpu=8.0),
            [grouped_gang("lw0", [3, 3], cg=[([0, 1], 0, -1)], group_req=[1, 1]),
             grouped_gang("lw1", [2, 2], cg=[([0, 1], 0, 1)], group_req=[1, 1]),
             grouped_gang("plain", [4])],
        ),
        "group_preferred": (
            cluster(blocks=2, racks=2, hosts=4, cpu=8.0),
            [grouped_gang("p0", [4, 2], group_pref=[1, -1]),
             grouped_gang("p1", [2, 2], group_req=[0, -1], group_pref=[1, 1])],
        ),
        "gang_preferred": (
            cluster(blocks=2, racks=2, hosts=4, cpu=8.0),
            [grouped_gang("gp0", [6], required=0, preferred=1),
             grouped_gang("gp1", [4], preferred=0)],
        ),
        "two_constraint_groups": (
            cluster(blocks=2, racks=3, hosts=4, cpu=10.0),
            [grouped_gang("multi", [2, 2, 2, 2],
                          cg=[([0, 1], 0, 1), ([2, 3], 0, -1)],
                          group_req=[1, 1, 1, 1], cpu=2.0),
             grouped_gang("bg", [3], cpu=1.0)],
        ),
        "engine_grouped": (
            cluster(blocks=2, racks=4, hosts=4, cpu=8.0),
            [grouped_gang(f"lw{i}", [2, 2], cg=[([0, 1], 0, -1)],
                          group_req=[1, 1], cpu=3.0) for i in range(6)]
            + [grouped_gang(f"pref{i}", [4], required=0, preferred=1, cpu=2.0)
               for i in range(4)],
        ),
    }


def _fuzz_trials():
    """The 25 randomized grouped backlogs of tests/test_native.py, drawn
    from one seed-42 generator in the same order."""
    rng = np.random.default_rng(42)
    trials = []
    for trial in range(25):
        snap = cluster(
            blocks=int(rng.integers(1, 3)),
            racks=int(rng.integers(1, 4)),
            hosts=int(rng.integers(2, 5)),
            cpu=float(rng.integers(4, 10)),
        )
        gangs = []
        for i in range(int(rng.integers(2, 7))):
            n_groups = int(rng.integers(1, 4))
            sizes = [int(rng.integers(1, 4)) for _ in range(n_groups)]
            group_req = [int(rng.integers(-1, 3)) for _ in range(n_groups)]
            group_pref = [int(rng.integers(-1, 3)) for _ in range(n_groups)]
            cg = []
            if n_groups >= 2 and rng.random() < 0.5:
                members = list(range(int(rng.integers(2, n_groups + 1))))
                cg = [(members, int(rng.integers(-1, 2)),
                       int(rng.integers(-1, 3)))]
            gangs.append(grouped_gang(
                f"t{trial}g{i}", sizes, cg=cg,
                cpu=float(rng.integers(1, 5)),
                required=int(rng.integers(-1, 2)),
                preferred=int(rng.integers(-1, 3)),
                group_req=group_req, group_pref=group_pref,
                priority=float(rng.integers(0, 3)),
            ))
        trials.append((snap, gangs))
    return trials


def test_backlog_parity():
    out = _assert_serial_parity(cluster(blocks=2, racks=2, hosts=4, cpu=8.0),
                                backlog())
    assert "infeasible" in out.unplaced and "prio" in out.placed


def test_capacity_respected_under_contention():
    snap = cluster(blocks=1, racks=2, hosts=2, cpu=8.0)
    gangs = [gang(f"g{i}", pods=2, cpu=8.0, required=1) for i in range(3)]
    out = _assert_serial_parity(snap, gangs)
    used = np.zeros_like(snap.free)
    for p in out.placed.values():
        for j, n in enumerate(p.node_indices):
            used[n] += p.gang.demand[j]
    assert (used <= snap.free + 1e-6).all()


def test_cordoned_nodes_skipped():
    snap = cluster(blocks=1, racks=1, hosts=2, cpu=8.0)
    snap.schedulable[0] = False
    out = _assert_serial_parity(snap, [gang("a", pods=1, cpu=2.0)])
    assert list(out.placed["a"].node_indices) == [1]


@pytest.mark.parametrize("case", list(_grouped_cases()))
def test_grouped_parity(case):
    snap, gangs = _grouped_cases()[case]
    _assert_serial_parity(snap, gangs)


@pytest.mark.parametrize("trial", range(25))
def test_fuzz_grouped_parity(trial):
    snap, gangs = _fuzz_trials()[trial]
    _assert_serial_parity(snap, gangs)


@pytest.mark.parametrize("case", CASES)
def test_engine_cases_parity(case):
    """Eligibility masks, cordoned nodes, starvation and priorities."""
    _assert_serial_parity(*CASES[case]())


def test_holds_predeclared_unschedulable_gangs():
    """A gang whose required pack level is unresolved is held with its
    reason, never weakened to best-effort."""
    snap = cluster()
    held = gang("held", pods=2, cpu=1.0)
    held.required_level = UNRESOLVED_LEVEL
    held.unschedulable_reason = "required topology level(s) unavailable: zone"
    ok = gang("ok", pods=2, cpu=1.0)
    tsnap, tgangs = _convert(snap, [held, ok])
    ref = jax_solve_serial_native(snap, [held, ok])
    out = solve_serial_native(tsnap, tgangs)
    assert out.unplaced == ref.unplaced == {
        "held": "required topology level(s) unavailable: zone"
    }
    assert set(out.placed) == set(ref.placed) == {"ok"}


@pytest.mark.parametrize("case", ["stress512", "stress512_grouped",
                                  "masked_cordoned", "starved"])
@pytest.mark.parametrize("k", [1, 8])
def test_repair_native_bit_equal_to_jax(case, k):
    """The same scored candidates (random domains, some invalid rows that
    force the serial net) through both repairs: node per pod, placement
    scores, fallbacks and the residual free matrix, exactly."""
    snap, gangs = CASES[case]()
    order = sorted((g for g in gangs if not g.unschedulable_reason),
                   key=jax_gang_sort_key)
    space = JaxDomainSpace(snap)
    rng = np.random.default_rng(len(order) * 10 + k)
    top_dom = rng.integers(0, space.num_domains, (len(order), k)).astype(np.int32)
    top_val = rng.uniform(1.0, 9.0, (len(order), k)).astype(np.float32)
    top_val[rng.random((len(order), k)) < 0.2] = -1e9
    offsets = np.asarray(space.offsets[:-1], np.int32)
    ref_free = snap.free.copy()
    ref_placed, ref_fallbacks = jax_repair_native(
        snap, order, top_val, top_dom, space.dom_level, offsets, ref_free)
    tsnap, torder = _convert(snap, order)
    out_free = tsnap.free.copy()
    placed, fallbacks = repair_native(
        tsnap, torder, top_val, top_dom, space.dom_level, offsets, out_free)
    assert fallbacks == ref_fallbacks
    assert sorted(placed) == sorted(ref_placed)
    for name, p in ref_placed.items():
        np.testing.assert_array_equal(placed[name].node_indices, p.node_indices)
        assert placed[name].placement_score == p.placement_score
        assert placed[name].pod_to_node == p.pod_to_node
    np.testing.assert_array_equal(out_free, ref_free)


REPAIR_CASES = {
    "stress_reduced": lambda: (bench.make_cluster(512), bench.make_gangs(96)),
    "fractional": CASES["fractional"],
    "masked": CASES["masked_cordoned"],
    "constraint_groups": lambda: (
        bench.make_cluster(512), bench.make_gangs(64, grouped=True)),
    "grouped_small": lambda: _grouped_cases()["engine_grouped"],
}


def _repair_inputs(snap, gangs, k, first_level=False):
    """The solvable gangs in commit order and random scored candidates
    (a fifth invalid, which sends gangs to the serial net). With
    `first_level`, candidates are drawn from the topology levels only,
    never the root."""
    order = sorted((g for g in gangs if not g.unschedulable_reason),
                   key=jax_gang_sort_key)
    space = JaxDomainSpace(snap)
    rng = np.random.default_rng(len(order) * 10 + k)
    low = 1 if first_level else 0
    top_dom = rng.integers(low, space.num_domains,
                           (len(order), k)).astype(np.int32)
    top_val = rng.uniform(1.0, 9.0, (len(order), k)).astype(np.float32)
    top_val[rng.random((len(order), k)) < 0.2] = -1e9
    return order, space, top_val, top_dom


def _pod_order_commit(free, order, placed):
    """`free` less every placed pod's demand, pod by pod in commit order
    (np.subtract.at's order: what the C++ repair commits)."""
    free = free.copy()
    pods = [(placed[g.name].node_indices, g.demand) for g in order
            if g.name in placed]
    if pods:
        np.subtract.at(free, np.concatenate([n for n, _d in pods]),
                       np.concatenate([d for _n, d in pods]))
    return free


def _assert_same_repair(ref, out):
    """(placements, fallbacks, free) equal, placements field by field."""
    (ref_placed, ref_fallbacks, ref_free), (placed, fallbacks, free) = ref, out
    assert fallbacks == ref_fallbacks
    assert sorted(placed) == sorted(ref_placed)
    for name, p in ref_placed.items():
        q = placed[name]
        assert q.node_indices.dtype == np.int64
        np.testing.assert_array_equal(q.node_indices, p.node_indices)
        assert q.placement_score == p.placement_score
        assert q.pod_to_node == p.pod_to_node
    assert free.dtype == ref_free.dtype
    assert free.tobytes() == ref_free.tobytes()


def _engine_repair(tsnap, torder, top_val, top_dom, native, engine=None):
    """One repair through a port engine's _repair: (placements,
    fallbacks, free) and the candidates it counted."""
    if engine is None:
        engine = PlacementEngine(tsnap, device="cpu", native_repair=native)
    free = tsnap.free.copy()
    placed, fallbacks = engine._repair(torder, top_val, top_dom, free)
    return (placed, fallbacks, free), engine._repair_stats["repair_candidates"]


def _jax_repair(snap, order, space, top_val, top_dom):
    free = snap.free.copy()
    placed, fallbacks = jax_repair_native(
        snap, order, top_val, top_dom, space.dom_level,
        np.asarray(space.offsets[:-1], np.int32), free)
    return placed, fallbacks, free


@pytest.mark.parametrize("case", list(REPAIR_CASES))
@pytest.mark.parametrize("k", [1, 8])
def test_repair_matches_python_and_jax(case, k):
    """The C++ repair over the engine's domain index, the fit.py repair
    (native_repair=False) and the JAX package's repair_native: placements,
    scores, fallbacks and the free matrix bit for bit; the two port
    repairs count the same candidates. fit.py commits each pod as it
    places it, in best-fit order: with fractional demands its free
    matrix differs in the last bits, and there its placements committed
    in pod order give the C++ repair's free matrix bit for bit."""
    snap, gangs = REPAIR_CASES[case]()
    order, space, top_val, top_dom = _repair_inputs(snap, gangs, k)
    ref = _jax_repair(snap, order, space, top_val, top_dom)
    tsnap, torder = _convert(snap, order)
    native, tried = _engine_repair(tsnap, torder, top_val, top_dom, True)
    fitpy, tried_py = _engine_repair(tsnap, torder, top_val, top_dom, False)
    _assert_same_repair(ref, native)
    if case == "fractional":
        assert fitpy[2].tobytes() != ref[2].tobytes()  # the case bites
        fitpy = (*fitpy[:2], _pod_order_commit(tsnap.free, torder, fitpy[0]))
    _assert_same_repair(ref, fitpy)
    assert tried == tried_py >= len(ref[0]) - ref[1]


def test_repair_skips_a_node_cordoned_without_a_rebind():
    """A node cordoned by writing snapshot.schedulable after the engine
    built its index is skipped: the result is the JAX repair's and a
    fresh engine's on the cordoned snapshot."""
    snap, gangs = bench.make_cluster(512), bench.make_gangs(96)
    order, space, top_val, top_dom = _repair_inputs(snap, gangs, 4,
                                                    first_level=True)
    top_val[:, 0] = 9.5  # every gang's first candidate is read
    tsnap, torder = _convert(snap, order)
    engine = PlacementEngine(tsnap, device="cpu")
    # half the nodes of the first gang's first candidate, and of the
    # domains of the first ten gangs' first candidates
    victims = set()
    for d in top_dom[:10, 0]:
        level = int(space.dom_level[d])
        local = int(d) - space.offsets[level]
        nodes = np.flatnonzero(snap.domain_ids[level] == local)
        victims.update(nodes[::2].tolist())
    victims = np.asarray(sorted(victims))
    before = _engine_repair(tsnap, torder, top_val, top_dom, True, engine)[0]
    hit = {int(n) for p in before[0].values() for n in p.node_indices}
    assert hit & set(victims.tolist())  # the cordon changes the result
    for s in {id(snap.schedulable): snap.schedulable,
              id(tsnap.schedulable): tsnap.schedulable}.values():
        s[victims] = False
    ref = _jax_repair(snap, order, space, top_val, top_dom)
    out, tried = _engine_repair(tsnap, torder, top_val, top_dom, True, engine)
    fitpy, tried_py = _engine_repair(tsnap, torder, top_val, top_dom, False)
    _assert_same_repair(ref, out)
    _assert_same_repair(ref, fitpy)
    assert tried == tried_py
    assert not {int(n) for p in out[0].values()
                for n in p.node_indices} & set(victims.tolist())


def test_domain_node_index_lists_each_domains_nodes_ascending():
    """The CSR holds, for every domain below the root, exactly the nodes
    a scan of domain_ids finds, in ascending order; the root owns none."""
    snap = bench.make_cluster(300)  # ragged: the last block is partial
    space = JaxDomainSpace(snap)
    offsets, nodes = domain_node_index(
        snap.domain_ids, np.asarray(space.offsets[:-1]), space.num_domains)
    assert offsets.dtype == nodes.dtype == np.int32
    assert offsets.shape == (space.num_domains + 1,) and offsets[1] == 0
    for d in range(1, space.num_domains):
        level = int(space.dom_level[d])
        want = np.flatnonzero(
            snap.domain_ids[level] == d - space.offsets[level])
        np.testing.assert_array_equal(nodes[offsets[d]:offsets[d + 1]], want)


@pytest.mark.parametrize("case", ["stress_reduced", "masked"])
def test_repair_native_without_an_index_builds_its_own(case):
    """repair_native called without the engine's index gives what it
    gives with it."""
    snap, gangs = REPAIR_CASES[case]()
    order, space, top_val, top_dom = _repair_inputs(snap, gangs, 8)
    tsnap, torder = _convert(snap, order)
    engine = PlacementEngine(tsnap, device="cpu")
    offsets = np.asarray(space.offsets[:-1], np.int32)
    runs = []
    for dom_index in (None, engine._dom_index):
        free, stats = tsnap.free.copy(), {}
        placed, fallbacks = repair_native(
            tsnap, torder, top_val, top_dom, space.dom_level, offsets, free,
            dom_index=dom_index, stats=stats)
        runs.append(((placed, fallbacks, free), stats["repair_candidates"]))
    _assert_same_repair(runs[0][0], runs[1][0])
    assert runs[0][1] == runs[1][1]
    offsets_, nodes = engine._dom_index
    for bad in ((offsets_[:-1], nodes), (offsets_, nodes[:-1]),
                (offsets_, nodes + tsnap.num_nodes)):
        with pytest.raises(ValueError, match="domain->node index"):
            repair_native(tsnap, torder, top_val, top_dom, space.dom_level,
                          offsets, tsnap.free.copy(), dom_index=bad)


def test_repair_candidates_counts_the_domains_tried():
    """Every gang held by its first candidate: one candidate a gang. A
    first candidate with no room (a block emptied) before the root: two
    for each gang that tried it."""
    snap, gangs = bench.make_cluster(512), bench.make_gangs(24)
    order, space, _val, _dom = _repair_inputs(snap, gangs, 2)
    tsnap, torder = _convert(snap, order)
    g = len(torder)
    top_val = np.full((g, 2), 5.0, np.float32)
    top_dom = np.zeros((g, 2), np.int32)  # the root, twice
    (placed, fallbacks, _free), tried = _engine_repair(
        tsnap, torder, top_val, top_dom, True)
    assert len(placed) == g and fallbacks == 0 and tried == g
    block0 = space.offsets[0]
    tsnap.free[snap.domain_ids[0] == 0] = 0.0
    top_dom[:, 0] = block0
    (placed, fallbacks, free), tried = _engine_repair(
        tsnap, torder, top_val, top_dom, True)
    assert len(placed) == g and fallbacks == 0 and tried == 2 * g
    assert not free[snap.domain_ids[0] == 0].any()


def _pile_up():
    """A block of 256 hosts (16 racks of 16) left in fragments no pod
    fits ({3, 12, 0}), five whole hosts and two that hold seven pods
    between them though they sum to 8 accelerators; 256 gangs of the
    stress mix, every fourth from the second twice as large. The first
    gangs take the whole hosts; after them a stress gang passes the free
    aggregate and fails the scan, a large one is short of it."""
    snap = bench.make_cluster(256)
    free = np.tile(np.float32([3.0, 12.0, 0.0]), (256, 1))
    free[[7, 40, 99, 170, 250]] = snap.capacity[0]
    free[20] = [12.0, 64.0, 4.0]
    free[200] = [20.0, 64.0, 4.0]
    snap.free[...] = free
    gangs = bench.make_gangs(256)
    for i in range(1, 256, 4):
        gangs[i] = dataclasses.replace(gangs[i], demand=gangs[i].demand * 2)
    return snap, gangs


def _net_only(g):
    """Candidates for `g` gangs, all invalid: every gang reaches the net."""
    return np.full((g, 1), -1e9, np.float32), np.zeros((g, 1), np.int32)


def _below_zero():
    """One block of three racks of four hosts (cpu 8). Four one-pod gangs
    of 1.0000005 cpu through the C++ repair take rack 0's hosts with 1.0
    free (fits() admits the 1e-6 tolerance) and leave each a hair below
    0. Then `f` (0.5) fits host 5, alone in rack 1, though the free summed
    unclamped over every host is short of it; `t` (1.005e-7 cpu and an
    accelerator) fits host 9, alone in rack 2 with 1e-7 cpu, the clamped
    aggregate short of it by less than 1e-6; `s` (4e-6) fits nowhere,
    short by more. fit.py's tolerance is 1e-9: it places the last three
    as the C++ does, not the first four."""
    snap = cluster(blocks=1, racks=3, hosts=4, cpu=8.0)
    snap.free[:, [0, 2]] = 0.0
    snap.free[:4, 0] = 1.0
    snap.free[5, 0] = 0.5
    snap.free[9] = [1e-7, 32.0, 1.0]
    first = [gang(f"h{i}", pods=1, cpu=1.0000005) for i in range(4)]
    placed, _fallbacks, free = _jax_repair(
        snap, first, JaxDomainSpace(snap), *_net_only(len(first)))
    assert len(placed) == 4 and (free[:4, 0] < 0).all()
    snap.free[...] = free
    return snap, [gang("f", pods=1, cpu=0.5),
                  gang("t", pods=1, cpu=1.005e-7, tpu=1.0),
                  gang("s", pods=1, cpu=4e-6)]


NET_CASES = {"pile_up": _pile_up, "below_zero": _below_zero}


def _net_short_count(snap, order, placed) -> int:
    """Of the gangs in `order`, every one of which reaches the net, those
    whose free aggregate is short at their turn: the schedulable hosts'
    free, each entry clamped at 0, added host by host in float32, plus
    1e-6 below the gang's pods added in order, in some resource. Each
    placed gang's pods are then taken off in order, which is the walk's
    own where a gang has one pod or whole-number demands."""
    free = snap.free.copy()
    sched = np.flatnonzero(snap.schedulable)
    short = 0
    for g in order:
        bound = np.zeros(free.shape[1], np.float32)
        for n in sched:
            bound = bound + np.maximum(free[n], np.float32(0.0))
        total = np.zeros(free.shape[1], np.float32)
        for d in g.demand:
            total = total + d
        short += bool((bound + np.float32(1e-6) < total).any())
        if g.name in placed:
            for n, d in zip(placed[g.name].node_indices, g.demand):
                free[n] -= d
    return short


@pytest.mark.parametrize("case", list(NET_CASES))
def test_the_nets_bound_turns_away_only_what_the_scan_cannot_place(case):
    """Every gang's candidates invalid, so every gang reaches the net. The
    port's C++ repair, which skips the scan for a gang its clamped free
    aggregate is short of, the JAX package's, which scans every one, and
    the fit.py repair give the same placements, fallbacks and free bit
    for bit; the count of gangs the bound turned away is a NumPy count of
    the same test, from both port repairs."""
    snap, order = NET_CASES[case]()
    g = len(order)
    top_val, top_dom = _net_only(g)
    space = JaxDomainSpace(snap)
    ref = _jax_repair(snap, order, space, top_val, top_dom)
    tsnap, torder = _convert(snap, order)
    free, stats = tsnap.free.copy(), {}
    placed, fallbacks = repair_native(
        tsnap, torder, top_val, top_dom, space.dom_level,
        np.asarray(space.offsets[:-1], np.int32), free, stats=stats)
    _assert_same_repair(ref, (placed, fallbacks, free))
    engine = PlacementEngine(tsnap, device="cpu", native_repair=False)
    free_py = tsnap.free.copy()
    fitpy = (*engine._repair(torder, top_val, top_dom, free_py), free_py)
    _assert_same_repair(ref, fitpy)
    want = _net_short_count(snap, order, ref[0])
    assert stats["repair_net_short"] == want
    assert engine._repair_stats["repair_net_short"] == want
    assert fallbacks == g
    if case == "pile_up":
        # a handful placed; both kinds of failure in the net
        assert 0 < len(placed) <= 8
        assert 0 < want < g - len(placed)
    else:
        assert sorted(placed) == ["f", "t"] and want == 1


@pytest.fixture
def fresh_native(monkeypatch, tmp_path):
    """The native build with no cached library: a private build directory
    and no loaded handle."""
    monkeypatch.setattr(build, "_cache_dir", tmp_path)
    monkeypatch.setattr(native_build, "_LIB", None)
    return native_build


def test_failed_build_raises(fresh_native, monkeypatch):
    monkeypatch.setattr(fresh_native, "CXX", "no-such-compiler-g++")
    with pytest.raises(RuntimeError, match="native repair build failed"):
        fresh_native.load_library()
    snap = cluster()
    tsnap, tgangs = _convert(snap, [gang("a", pods=1)])
    with pytest.raises(RuntimeError, match="native repair build failed"):
        solve_serial_native(tsnap, tgangs)


def test_compile_error_raises(fresh_native, monkeypatch, tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int grove_native_abi(void) { return }\n")
    monkeypatch.setattr(fresh_native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="broken.cpp"):
        fresh_native.build()
    assert not list(tmp_path.glob("*.so"))


def test_abi_mismatch_raises(fresh_native, monkeypatch):
    monkeypatch.setattr(fresh_native, "EXPECTED_ABI", fresh_native.EXPECTED_ABI + 1)
    with pytest.raises(RuntimeError, match="ABI 5"):
        fresh_native.load_library()
    assert fresh_native._LIB is None


def test_build_is_cached_by_content(fresh_native, tmp_path):
    path = fresh_native.build()
    assert path.parent == build.build_dir() == tmp_path and path.exists()
    assert fresh_native.build() == path == fresh_native.library_path()
    lib = fresh_native.load_library()
    assert fresh_native.load_library() is lib
    assert lib.grove_native_abi() == fresh_native.EXPECTED_ABI
