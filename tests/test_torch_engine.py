"""The whole slice: grove_tpu_torch's PlacementEngine vs the JAX package's.

The same cluster and backlog, carried across with grove_tpu_torch.convert,
go through JAX `PlacementEngine(snap, incremental=False, ...)` and the
port's `PlacementEngine(snap, device="cpu", ...)` with the same knobs on
both sides: default knobs, and the kernel tier (`pallas_core=True,
device_commit=True`: JAX runs its Pallas kernel interpreted, the port the
kernels' plain versions), each with the exact repair in C++
(`native_repair=True`, the default) and with fit.py
(`native_repair=False`). Required, exactly: the same placed set, the same
node per pod, equal placement scores, the same unplaced gangs with the
same message, UnsatCode and funnel, and the same repair fallbacks.

The bf16 tier (`pallas_precision="bf16"` on the kernel tier) is held to
the documented tie policy instead (docs/scheduling.md, bench.py's
equivalence gate): against JAX's bf16 engine and against the port's own
fp32 engine, the same placed set, the same unplaced reason codes and the
same committed per-resource totals (np.allclose, rtol 1e-5, atol 1e-3);
nodes may differ.
"""

import numpy as np
import pytest

import __graft_entry__
import bench
from grove_tpu.observability.explain import UnsatCode as JaxUnsatCode
from grove_tpu.observability.explain import UnsatDiagnosis as JaxUnsatDiagnosis
from grove_tpu.solver import PlacementEngine as JaxEngine
from grove_tpu.solver import solve_serial as jax_solve_serial

from grove_tpu_torch import stress
from grove_tpu_torch.convert import (
    GANG_FIELDS,
    SNAPSHOT_FIELDS,
    gang_from_arrays,
    snapshot_from_arrays,
)
from grove_tpu_torch.observability.explain import UnsatCode
from grove_tpu_torch.solver import PlacementEngine, solve_serial


def _masked_cordoned():
    """Cordoned nodes, shared per-pod eligibility masks (one that no node
    satisfies) and a pre-declared unschedulable gang."""
    snap, gangs = __graft_entry__._tiny_problem(num_nodes=16, num_gangs=12)
    snap.schedulable[[1, 5, 9]] = False
    left = np.zeros(snap.num_nodes, bool)
    left[:8] = True
    left.setflags(write=False)
    nowhere = np.zeros(snap.num_nodes, bool)
    nowhere.setflags(write=False)
    for i, g in enumerate(gangs):
        if i % 3 == 0:
            g.pod_elig = [left, None]
    gangs[4].pod_elig = [nowhere, nowhere]
    gangs[7].unschedulable_reason = JaxUnsatDiagnosis(
        "required topology level(s) unavailable: zone",
        code=JaxUnsatCode.UNRESOLVED_LEVEL,
    )
    gangs[10].demand = gangs[10].demand * 3.0  # 3 cpu pods: host-level fits only
    return snap, gangs


def _fair_priority():
    """Priorities and tenant fairness weights: they reorder the commit
    and offset each gang's value row."""
    snap, gangs = bench.make_cluster(128), bench.make_gangs(32)
    rng = np.random.default_rng(4)
    for g in gangs:
        g.priority = float(rng.integers(0, 3))
        g.fairness = float(rng.uniform(-1.0, 1.0))
    return snap, gangs


def _fractional():
    """Non-dyadic demands that differ pod by pod and pack several pods a
    node: float32 subtraction in any order but pod index gives other bits
    in the free matrix."""
    snap, gangs = bench.make_cluster(64), bench.make_gangs(48)
    rng = np.random.default_rng(7)
    for g in gangs:
        scale = rng.uniform(0.05, 0.95, (g.num_pods, 1))
        g.demand = (g.demand * scale).astype(np.float32)
    return snap, gangs


CASES = {
    "tiny": lambda: __graft_entry__._tiny_problem(),
    "stress512": lambda: (bench.make_cluster(512), bench.make_gangs(64)),
    "stress512_grouped": lambda: (
        bench.make_cluster(512), bench.make_gangs(64, grouped=True)
    ),
    # 32 nodes hold 32 block-packed gangs: half the backlog stays unplaced
    "starved": lambda: (bench.make_cluster(32), bench.make_gangs(64)),
    "masked_cordoned": _masked_cordoned,
    "fair_priority": _fair_priority,
    "fractional": _fractional,
}

KNOBS = {
    "defaults": {},
    "kernel_tier": {"pallas_core": True, "device_commit": True},
}

BF16 = {"pallas_core": True, "device_commit": True, "pallas_precision": "bf16"}


def _convert(snap, gangs):
    tsnap = snapshot_from_arrays(**{f: getattr(snap, f) for f in SNAPSHOT_FIELDS})
    tgangs = [gang_from_arrays(**{f: getattr(g, f) for f in GANG_FIELDS})
              for g in gangs]
    return tsnap, tgangs


def assert_same_result(ref, out):
    assert sorted(out.placed) == sorted(ref.placed)
    for name, p in ref.placed.items():
        q = out.placed[name]
        np.testing.assert_array_equal(q.node_indices, p.node_indices)
        assert q.placement_score == p.placement_score
        assert q.pod_to_node == p.pod_to_node
    assert sorted(out.unplaced) == sorted(ref.unplaced)
    for name, reason in ref.unplaced.items():
        mine = out.unplaced[name]
        assert str(mine) == str(reason)
        assert mine.code.value == reason.code.value
        assert getattr(mine, "funnel", None) == getattr(reason, "funnel", None)
    assert out.stats.get("fallbacks") == ref.stats.get("fallbacks")


@pytest.mark.parametrize("native_repair", [True, False],
                         ids=["native", "fitpy"])
@pytest.mark.parametrize("knobs", KNOBS)
@pytest.mark.parametrize("case", CASES)
def test_engine_matches_jax(case, knobs, native_repair):
    snap, gangs = CASES[case]()
    tsnap, tgangs = _convert(snap, gangs)
    ref = JaxEngine(
        snap, native_repair=native_repair, incremental=False, **KNOBS[knobs]
    ).solve(gangs)
    eng = PlacementEngine(tsnap, device="cpu", native_repair=native_repair,
                          **KNOBS[knobs])
    assert (eng.pallas_core, eng.device_commit) == (bool(KNOBS[knobs]),) * 2
    out = eng.solve(tgangs)
    assert_same_result(ref, out)
    for key in ("encode_seconds", "device_seconds", "repair_seconds"):
        assert out.stats[key] >= 0.0
    if case == "starved":
        assert out.unplaced and out.placed
    if case == "masked_cordoned":
        codes = {r.code for r in out.unplaced.values()}
        assert {UnsatCode.UNRESOLVED_LEVEL, UnsatCode.ELIGIBILITY} <= codes


def _unsat_codes(result):
    return {name: reason.code.value for name, reason in result.unplaced.items()}


def assert_tie_policy(ref, ref_free, out, out_free):
    """bf16's contract: placed set, unplaced reason codes and committed
    per-resource totals (bench.py's bf16 tie-policy gate)."""
    assert sorted(out.placed) == sorted(ref.placed)
    assert _unsat_codes(out) == _unsat_codes(ref)
    assert np.allclose(out_free.sum(axis=0), ref_free.sum(axis=0),
                       rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("case", CASES)
def test_repair_candidates_native_equals_fitpy(case):
    """Every flat solve reports the candidate domains its repair tried:
    the same count from the C++ repair and from fit.py, and at least one
    for every gang placed without the serial net."""
    snap, gangs = CASES[case]()
    tsnap, tgangs = _convert(snap, gangs)
    out = {native: PlacementEngine(tsnap, device="cpu",
                                   native_repair=native).solve(tgangs)
           for native in (True, False)}
    assert_same_result(out[False], out[True])
    tried = out[True].stats["repair_candidates"]
    assert tried == out[False].stats["repair_candidates"]
    assert tried >= len(out[True].placed) - out[True].stats["fallbacks"]


@pytest.mark.parametrize("case", CASES)
def test_engine_bf16_keeps_jax_tie_policy(case):
    snap, gangs = CASES[case]()
    tsnap, tgangs = _convert(snap, gangs)
    ref_free = snap.free.copy()
    ref = JaxEngine(snap, incremental=False, **BF16).solve(gangs, free=ref_free)
    eng = PlacementEngine(tsnap, device="cpu", **BF16)
    assert (eng.pallas_core, eng.device_commit, eng.pallas_precision) == (
        True, True, "bf16")
    out_free = tsnap.free.copy()
    out = eng.solve(tgangs, free=out_free)
    assert_tie_policy(ref, ref_free, out, out_free)
    # and against the port's own fp32 tier
    fp32_free = tsnap.free.copy()
    fp32 = PlacementEngine(tsnap, device="cpu", **KNOBS["kernel_tier"]).solve(
        tgangs, free=fp32_free)
    assert_tie_policy(fp32, fp32_free, out, out_free)


@pytest.mark.parametrize("case", CASES)
def test_serial_matches_jax(case):
    """The serial scorer (the engine's exactness net) on its own."""
    snap, gangs = CASES[case]()
    tsnap, tgangs = _convert(snap, gangs)
    assert_same_result(jax_solve_serial(snap, gangs), solve_serial(tsnap, tgangs))


@pytest.mark.parametrize("grouped", [False, True])
def test_stress_config_matches_bench(grouped):
    """stress.make_cluster/make_gangs build the arrays bench.py builds
    (ragged node count: the last block and rack are partial)."""
    ref = bench.make_cluster(300)
    out = stress.make_cluster(300)
    for f in SNAPSHOT_FIELDS:
        a, b = getattr(out, f), getattr(ref, f)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b
    assert out.node_index == ref.node_index
    for tg, jg in zip(stress.make_gangs(12, grouped),
                      bench.make_gangs(12, grouped), strict=True):
        for f in GANG_FIELDS:
            a, b = getattr(tg, f), getattr(jg, f)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b
