"""The engine cases of tests/test_solver.py (TestEngineParity,
TestRequiredLevelGating, TestNodeEligibility, TestValueNarrownessDominance)
on the port, each written once as PodGangs with their Pods and built in
both packages (tests/test_torch_problem.py's `Twin`), encoded by each
package's `encode_podgangs` and solved by each package's engine: the
JAX engine and the port's on the CPU (the kernels' plain versions), at
default knobs and on the kernel tier (`pallas_core=True,
device_commit=True`: JAX's Pallas kernel interpreted). Required of every
solve: bit-equal placed sets, node per pod, scores and unplaced reasons
(message and UnsatCode), then each case's own assertions on the port's
result. The serial baselines (`solve_serial`, the native
`solve_serial_native`) are held the same way.
"""

import numpy as np
import pytest

from test_torch_problem import (
    HOST,
    JAX,
    TORCH,
    Backlog,
    engine,
    make_cluster,
    seeded_problem,
)
from test_torch_solver_fuzz import same_result

TIERS = {"default": {}, "kernel": {"pallas_core": True, "device_commit": True}}


def solve_both(scenario, **knobs):
    """Build `scenario(p) -> (snap, gangs)` in both packages, solve each
    with its engine and require bit-equal results. Returns the port's
    (snap, gangs, result)."""
    snap, gangs = scenario(TORCH)
    jsnap, jgangs = scenario(JAX)
    ours = engine(TORCH, snap, **knobs).solve(gangs)
    ref = engine(JAX, jsnap, **knobs).solve(jgangs)
    assert same_result(ours, ref)
    assert ours.stats["fallbacks"] == ref.stats["fallbacks"]
    return snap, gangs, ours


def serial_both(scenario):
    """solve_serial of both packages on the scenario, bit-equal; the
    port's result."""
    snap, gangs = scenario(TORCH)
    jsnap, jgangs = scenario(JAX)
    ours = TORCH.solver.solve_serial(snap, gangs)
    assert same_result(ours, JAX.solver.solve_serial(jsnap, jgangs))
    return ours


def uniform(pods, cpu=1.0, tpu=0.0, required=None, **kw):
    """One group of `pods` uniform pods (memory 1)."""
    return dict(pods=pods, cpu=cpu, tpu=tpu, mem=1.0, required=required, **kw)


@pytest.fixture(params=list(TIERS))
def knobs(request):
    return TIERS[request.param]


class TestEngineParity:
    """The engine matches the serial hard-feasibility outcomes, in both
    packages alike."""

    def test_engine_places_like_serial(self, knobs):
        def scenario(p):
            snap = make_cluster(p, blocks=2, racks=2, hosts=4, cpu=8.0)
            b = (Backlog(p).add("a", [uniform(2, cpu=2.0)])
                 .add("b", [uniform(4, cpu=6.0)], required="t/rack")
                 .add("c", [uniform(3, cpu=3.0)], preferred=HOST))
            return snap, b.encode(snap)

        _, _, res = solve_both(scenario, **knobs)
        serial = serial_both(scenario)
        assert set(res.placed) == set(serial.placed)
        for name in res.placed:
            assert res.placed[name].placement_score == pytest.approx(
                serial.placed[name].placement_score)

    def test_engine_respects_capacity_all_or_nothing(self, knobs):
        def scenario(p):
            snap = make_cluster(p, blocks=1, racks=1, hosts=2, cpu=8.0)
            return snap, Backlog(p).add("a", [uniform(3, cpu=6.0)]).encode(snap)

        _, _, res = solve_both(scenario, **knobs)
        assert res.num_placed == 0

    def test_engine_contention_many_gangs(self, knobs):
        def scenario(p):
            snap = make_cluster(p, blocks=2, racks=4, hosts=2, cpu=8.0,
                                tpu=4.0)
            b = Backlog(p)
            for i in range(8):
                b.add(f"g{i}", [uniform(2, cpu=4.0, tpu=2.0)],
                      required="t/rack")
            return snap, b.encode(snap)

        snap, gangs, res = solve_both(scenario, **knobs)
        assert res.num_placed == serial_both(scenario).num_placed
        used = np.zeros_like(snap.free)
        for p in res.placed.values():
            for pod_i, n in enumerate(p.node_indices):
                used[n] += p.gang.demand[pod_i]
        assert (used <= snap.free + 1e-6).all()

    def test_engine_group_constraints(self, knobs):
        def scenario(p):
            snap = make_cluster(p, blocks=2, racks=2, hosts=2, cpu=8.0)
            b = Backlog(p).add("g", [uniform(2, cpu=6.0, required="t/rack"),
                                     uniform(2, cpu=6.0, required="t/rack")],
                               required="t/block")
            return snap, b.encode(snap)

        snap, _, res = solve_both(scenario, **knobs)
        assert res.num_placed == 1
        rack_ids = snap.domain_ids[1, res.placed["g"].node_indices]
        assert rack_ids[0] == rack_ids[1]
        assert rack_ids[2] == rack_ids[3]


class TestRequiredLevelGating:
    """A REQUIRED pack level missing from the topology holds the gang
    (UNRESOLVED_LEVEL), never weakens it to unconstrained."""

    def test_unresolved_required_level_held_by_both_paths(self, knobs):
        def scenario(p):
            snap = make_cluster(p)
            b = (Backlog(p).add("held", [uniform(2)], required="t/zone")
                 .add("ok", [uniform(2)]))
            return snap, b.encode(snap)

        _, gangs, res = solve_both(scenario, **knobs)
        held = next(g for g in gangs if g.name == "held")
        assert held.unschedulable_reason is not None
        assert res.unplaced["held"] == held.unschedulable_reason
        assert "ok" in res.placed
        ser = serial_both(scenario)
        assert ser.unplaced["held"] == held.unschedulable_reason
        assert "ok" in ser.placed

    def test_encode_marks_unknown_required_key(self, knobs):
        def scenario(p):
            snap = make_cluster(p)
            b = (Backlog(p).add("bad", [uniform(1)], required="unresolved:zone")
                 .add("good", [uniform(1)], required="t/rack")
                 .add("pref", [uniform(1)], preferred="nope"))
            return snap, b.encode(snap)

        snap, gangs, res = solve_both(scenario, **knobs)
        by_name = {g.name: g for g in gangs}
        assert "unavailable: zone" in by_name["bad"].unschedulable_reason
        assert by_name["good"].unschedulable_reason is None
        assert by_name["good"].required_level == snap.level_index("t/rack")
        # an unknown PREFERRED level stays best-effort (-1)
        assert by_name["pref"].unschedulable_reason is None
        assert by_name["pref"].preferred_level == -1
        assert set(res.placed) == {"good", "pref"}


class TestValueNarrownessDominance:
    def test_narrowness_beats_extreme_slack_at_any_depth(self):
        """A broader domain never outranks a feasible narrower one, even
        overcommitted against a maximally slack narrower one: the port's
        value arithmetic (and its kernels' plain twin) bit-equal to the JAX
        package's."""
        import jax.numpy as jnp

        import torch
        from grove_tpu.solver.engine import value_from_aggregates as jax_value
        from grove_tpu_torch.solver import kernel_core as kc
        from grove_tpu_torch.solver.engine import value_from_aggregates

        arrays = (np.array([[300.0], [-100.0], [100.0]], np.float32),
                  np.ones((1, 3), np.float32), np.array([-1, 0, 1], np.int32),
                  np.array([[2.0]], np.float32), np.array([-1], np.int32),
                  np.array([-1], np.int32), np.array([True]),
                  np.array([100.0], np.float32))
        want = np.asarray(jax_value(*[jnp.asarray(a) for a in arrays]))
        t = [torch.from_numpy(a) for a in arrays]
        got = value_from_aggregates(*t).numpy()
        plain = kc.value_plain(*t, fairness=None).numpy()
        assert want[0].argmax() == 2
        assert np.array_equal(got, want) and np.array_equal(plain, want)


def accel_cluster(p, cpu=8.0):
    """2 blocks x 2 hosts; block b1's nodes carry accel=v5."""
    return make_cluster(p, blocks=2, racks=1, hosts=2, cpu=cpu,
                        labels=lambda i: {"accel": "v5"} if i >= 2 else {})


V5 = {"accel": "v5"}


class TestNodeEligibility:
    """Node selectors and taints/tolerations from the pods' specs, as hard
    filters: a constrained gang is HELD, never misplaced."""

    def test_eligibility_mask(self):
        for p in (TORCH, JAX):
            snap = accel_cluster(p)
            mask = snap.eligibility(V5, [])
            np.testing.assert_array_equal(mask, [False, False, True, True])
            assert snap.eligibility(dict(V5), []) is mask
            assert not mask.flags.writeable

    def test_serial_places_only_on_selected_nodes(self):
        def scenario(p):
            snap = accel_cluster(p)
            return snap, Backlog(p).add(
                "g", [uniform(2, cpu=6.0, selector=V5)]).encode(snap)

        res = serial_both(scenario)
        assert set(res.placed["g"].node_indices.tolist()) <= {2, 3}

    def test_serial_holds_gang_rather_than_misplace(self):
        def scenario(p):
            snap = accel_cluster(p)
            return snap, Backlog(p).add(
                "g", [uniform(3, cpu=6.0, selector=V5)]).encode(snap)

        res = serial_both(scenario)
        assert res.placed == {} and "g" in res.unplaced

    def test_engine_matches_serial_on_selectors(self, knobs):
        def scenario(p):
            snap = accel_cluster(p)
            b = (Backlog(p).add("sel", [uniform(2, cpu=6.0, selector=V5)])
                 .add("held", [uniform(3, cpu=6.0, selector=V5)])
                 .add("zz-free", [uniform(2, cpu=2.0)]))
            return snap, b.encode(snap)

        _, _, res = solve_both(scenario, **knobs)
        ser = serial_both(scenario)
        assert set(res.placed) == set(ser.placed) == {"sel", "zz-free"}
        assert set(res.placed["sel"].node_indices.tolist()) <= {2, 3}
        assert "held" in res.unplaced

    def test_taints_repel_untolerated_pods(self, knobs):
        def scenario(p, tolerate):
            snap = make_cluster(p, blocks=1, racks=1, hosts=2,
                                taints=lambda i: ["maintenance"] if i == 0 else [])
            b = Backlog(p).add("tol" if tolerate else "plain", [uniform(
                2, cpu=6.0, tolerations=["maintenance"] if tolerate else [])])
            return snap, b.encode(snap)

        for tolerate, name in ((False, "plain"), (True, "tol")):
            snap, _, res = solve_both(lambda p: scenario(p, tolerate), **knobs)
            assert snap.has_taints
            ser = serial_both(lambda p: scenario(p, tolerate))
            for r in (res, ser):
                assert (name in r.placed) == tolerate

    def test_mixed_eligibility_within_one_gang(self, knobs):
        def scenario(p):
            snap = accel_cluster(p)
            b = Backlog(p).add("mix", [uniform(
                3, cpu=5.0, selector=lambda j: V5 if j == 0 else {})])
            return snap, b.encode(snap)

        _, gangs, res = solve_both(scenario, **knobs)
        assert gangs[0].pod_elig[0] is not None and gangs[0].pod_elig[1] is None
        assert res.placed["mix"].node_indices[0] in (2, 3)

    def test_native_paths_enforce_eligibility(self):
        """The port's C++ serial solve enforces the masks exactly: the
        placements of the port's Python serial solve, and bit-equal to
        the JAX package's C++ one."""
        from grove_tpu.native import native_available
        from grove_tpu.native import solve_serial_native as jax_native
        from grove_tpu_torch.native import solve_serial_native

        def scenario(p):
            snap = accel_cluster(p)
            b = (Backlog(p).add("sel", [uniform(2, cpu=6.0, selector=V5)])
                 .add("held", [uniform(3, cpu=6.0, selector=V5)])
                 .add("zz-free", [uniform(2, cpu=2.0)]))
            return snap, b.encode(snap)

        snap, gangs = scenario(TORCH)
        nat = solve_serial_native(snap, gangs)
        ser = TORCH.solver.solve_serial(snap, gangs)
        assert set(nat.placed) == set(ser.placed) == {"sel", "zz-free"}
        for name in nat.placed:
            np.testing.assert_array_equal(nat.placed[name].node_indices,
                                          ser.placed[name].node_indices)
        assert "held" in nat.unplaced
        if native_available():
            jsnap, jgangs = scenario(JAX)
            assert same_result(nat, jax_native(jsnap, jgangs))

    def test_all_true_mask_treated_as_unconstrained(self, knobs):
        """A pod that tolerates every taint, in a tainted cluster, encodes
        with no mask, so the backlog keeps the single-signature path."""
        def scenario(p):
            snap = make_cluster(p, blocks=1, racks=1, hosts=2,
                                taints=lambda i: ["maintenance"] if i == 0 else [])
            b = (Backlog(p).add("tol", [uniform(2, tolerations=["maintenance"])])
                 .add("plain", [uniform(1)]))
            return snap, b.encode(snap)

        _, gangs, res = solve_both(scenario, **knobs)
        by_name = {g.name: g for g in gangs}
        assert by_name["tol"].pod_elig is None
        np.testing.assert_array_equal(by_name["plain"].pod_elig[0],
                                      [False, True])
        assert set(res.placed) == {"tol", "plain"}


@pytest.mark.parametrize("seed", range(4))
def test_seeded_podgang_backlogs_match_the_jax_package(seed, knobs):
    """The seeded PodGang backlogs of tests/test_torch_problem.py (masks,
    unresolved levels, min_replicas cuts, constraint groups, priorities)
    solved by both engines: bit-equal."""
    def scenario(p):
        snap, backlog = seeded_problem(p, seed)
        return snap, backlog.encode(snap)

    solve_both(scenario, **knobs)
