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

import numpy as np
import pytest

from grove_tpu.native.serial_native import repair_native as jax_repair_native
from grove_tpu.native.serial_native import (
    solve_serial_native as jax_solve_serial_native,
)
from grove_tpu.solver.engine import DomainSpace as JaxDomainSpace
from grove_tpu.solver.problem import UNRESOLVED_LEVEL
from grove_tpu.solver.serial import gang_sort_key as jax_gang_sort_key

from grove_tpu_torch.native import build as native_build
from grove_tpu_torch.native import repair_native, solve_serial_native
from grove_tpu_torch.solver import solve_serial

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


@pytest.fixture
def fresh_native(monkeypatch, tmp_path):
    """The native build with no cached library: a private build directory
    and no loaded handle."""
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path)
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
    with pytest.raises(RuntimeError, match="ABI 3"):
        fresh_native.load_library()
    assert fresh_native._LIB is None


def test_build_is_cached_by_content(fresh_native):
    path = fresh_native.build()
    assert path.parent == fresh_native.BUILD_DIR and path.exists()
    assert fresh_native.build() == path == fresh_native.library_path()
    lib = fresh_native.load_library()
    assert fresh_native.load_library() is lib
    assert lib.grove_native_abi() == fresh_native.EXPECTED_ABI
