"""The port's mesh-sharded engine against the JAX package's.

tests/test_parallel.py's cases, the stress shape at free x 1.0, 0.3 and
0.7, and warm solves with staged rows, on two meshes of gloo ranks on the
CPU: 4 ranks (2 x 2) and 8 (4 x 2, the reference's mesh). The ranks run
the port only (tests/torch_mesh.py): each spawn runs every case and
returns every rank's results, and the JAX side runs here, on the
conftest's 8 virtual devices (its first 4 for the 2 x 2 mesh). Every step
of every case must be bit-equal (placements with their scores, unplaced
reasons, repair fallbacks, the free matrix after the solve):

- across the ranks of one spawn (every rank reaches the same result with
  no coordination, the multihost promise);
- to the JAX ShardedPlacementEngine on a mesh of the same shape;
- to the port's flat engine (and so, as the reference promises, to the
  single-device engine).

The kernels' plain versions run on the CPU. The capacity in the x 0.3 and
x 0.7 cases is non-dyadic: the partial sums over the node blocks are then
not exact, and the results are still the same on every rank, because
every rank adds the partials in one rank order.
"""

from __future__ import annotations

from functools import partial

import jax
import numpy as np
import pytest

import bench
from grove_tpu.parallel import ShardedPlacementEngine as JaxSharded
from grove_tpu.parallel import make_solver_mesh as jax_mesh
from grove_tpu.solver import SolverGang as JaxGang

from grove_tpu_torch.api import types as port_types
from grove_tpu_torch.convert import api_object
from grove_tpu_torch.observability.explain import UnsatCode
from grove_tpu_torch.parallel import mesh_shape
from grove_tpu_torch.solver import PlacementEngine

from test_solver import cluster, constrained_gang, gang, snap_with_accel_labels
from test_torch_hierarchy import port_gangs, port_snapshot
from torch_mesh import run_ranks, solve_step

MESHES = {"2x2": (4, 2), "4x2": (8, 4)}


def backlog():
    """tests/test_parallel.py's backlog."""
    return [
        gang("a", pods=2, cpu=2.0),
        gang("b", pods=4, cpu=6.0, required=1),
        gang("c", pods=3, cpu=3.0, preferred=2),
        gang("d", pods=4, cpu=6.0,
             group_levels=[(2, 1, -1), (2, 1, -1)], required=0),
    ] + [gang(f"w{i}", pods=2, cpu=4.0, tpu=2.0, required=1)
         for i in range(6)]


def zero_demand_gangs():
    zg = JaxGang(
        name="z", namespace="default",
        demand=np.zeros((2, 3), np.float32), pod_names=["z-p0", "z-p1"],
        group_ids=np.zeros(2, np.int32), group_names=["g0"],
        group_required_level=np.array([-1], np.int32),
        group_preferred_level=np.array([-1], np.int32),
    )
    return [zg, gang("a", pods=2, cpu=2.0),
            gang("b", pods=2, cpu=2.0, required=1)]


def selector_gangs(snap):
    return [
        constrained_gang("sel", pods=2, cpu=6.0, snap=snap,
                         selector={"accel": "v5"}),
        constrained_gang("held", pods=3, cpu=6.0, snap=snap,
                         selector={"accel": "v5"}),
        gang("zz-free", pods=2, cpu=2.0),
    ]


def scaled(snap, factor):
    return (snap.free * np.float32(factor)).astype(np.float32)


def spread_rows(snap, count, seed):
    """`count` rows spread over the node range (the first and last rows
    included), each set to its full capacity: every node block of a
    2-wide nodes dim gets some."""
    n = snap.num_nodes
    rows = np.unique(np.concatenate([
        [0, n - 1], np.linspace(0, n - 1, count).astype(int),
        np.random.default_rng(seed).integers(0, n, count)]))
    return {int(i): snap.capacity[i].copy() for i in rows}


def warm_steps(snap, first, later):
    """A cold solve, two ticks with rows set in every node block (staged
    into the next launch, or scattered on a split engine), then a
    dispatch adopted, a dispatch cancelled and a stale dispatch."""
    return [
        {"gangs": first},
        {"gangs": later, "set": spread_rows(snap, 8, 1)},
        {"gangs": later, "set": spread_rows(snap, 3, 2)},
        {"gangs": later, "set": spread_rows(snap, 5, 3), "dispatch": "adopt"},
        {"gangs": later, "set": spread_rows(snap, 4, 4), "dispatch": "cancel"},
        {"gangs": later, "set": spread_rows(snap, 2, 5), "dispatch": "stale"},
    ]


def build_cases() -> dict:
    """name -> (JAX snapshot, free or None, knobs, JAX steps)."""
    stress_snap = bench.make_cluster(512)
    stress_gangs = bench.make_gangs(256)
    accel = snap_with_accel_labels()
    ragged = cluster(blocks=3, racks=3, hosts=3, cpu=8.0)  # 27 nodes
    cases = {
        "matches_single": (cluster(blocks=2, racks=2, hosts=4, cpu=8.0),
                           None, {}, [{"gangs": backlog()}]),
        "ragged_node_count": (cluster(blocks=2, racks=2, hosts=3, cpu=8.0),
                              None, {}, [{"gangs": backlog()[:5]}]),
        "gang_axis_not_dividing_backlog": (
            cluster(blocks=1, racks=2, hosts=2, cpu=8.0), None, {},
            [{"gangs": backlog()[:3]}]),
        "zero_demand_ragged": (cluster(blocks=1, racks=3, hosts=3, cpu=8.0),
                               None, {}, [{"gangs": zero_demand_gangs()}]),
        "selectors": (accel, None, {}, [{"gangs": selector_gangs(accel)}]),
        "stress_x1.0": (stress_snap, None, {}, [{"gangs": stress_gangs}]),
        "stress_x0.3": (stress_snap, scaled(stress_snap, 0.3), {},
                        [{"gangs": stress_gangs}]),
        "stress_x0.7": (stress_snap, scaled(stress_snap, 0.7), {},
                        [{"gangs": stress_gangs}]),
        "warm_staged_stress": (
            stress_snap, scaled(stress_snap, 0.7), {"state_verify": True},
            warm_steps(stress_snap, stress_gangs, bench.make_gangs(4))),
        "warm_staged_ragged": (
            ragged, None, {"state_verify": True},
            warm_steps(ragged, backlog(), backlog()[4:])),
        "warm_split_ragged": (
            ragged, None, {"fused": False, "state_verify": True},
            warm_steps(ragged, backlog(), backlog()[4:])),
    }
    return cases


CASES = build_cases()


def port_steps(steps):
    """The port's twins of a case's steps (each backlog carried once, so
    a backlog repeated across steps is the same objects)."""
    carried = {}
    out = []
    for step in steps:
        key = id(step["gangs"])
        if key not in carried:
            carried[key] = port_gangs(step["gangs"])
        out.append({**step, "gangs": carried[key]})
    return out


def run_steps(engine, steps, free) -> list[dict]:
    free = free.copy()
    out = []
    for step in steps:
        res = solve_step(engine, step, free)
        res["free"] = free.copy()
        out.append(res)
    return out


def jobs() -> list:
    out = []
    for name, (snap, free, knobs, steps) in CASES.items():
        out.append((name, "solve", {
            "snap": port_snapshot(snap), "free": free, "knobs": knobs,
            "steps": port_steps(steps)}))
    out.append(("control_plane", "harness", control_plane_payload()))
    return out


@pytest.fixture(scope="module", params=sorted(MESHES))
def mesh_run(request):
    """One spawn per mesh shape: every rank's results of every job, and
    the JAX sharded engine's of every case on a mesh of the same shape."""
    world, jax_devices = MESHES[request.param]
    ranks = run_ranks(world, jobs())
    mesh = jax_mesh(jax.devices()[:jax_devices])
    jax_results = {}
    for name, (snap, free, knobs, steps) in CASES.items():
        free = snap.free if free is None else free
        jax_results[name] = run_steps(JaxSharded(snap, mesh, **knobs),
                                      steps, free)
    return request.param, ranks, jax_results


@pytest.fixture(scope="module")
def flat_runs():
    """The port's flat engine on every case."""
    out = {}
    for name, (snap, free, knobs, steps) in CASES.items():
        free = snap.free if free is None else free
        out[name] = run_steps(
            PlacementEngine(port_snapshot(snap), device="cpu", **knobs),
            port_steps(steps), free)
    return out


def outcome(step: dict) -> dict:
    return {k: step[k] for k in ("placed", "unplaced", "codes", "fallbacks",
                                 "adopted")}


def assert_steps_equal(got: list, want: list, what: str) -> None:
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        assert outcome(a) == outcome(b), f"{what}: step {i}"
        assert np.array_equal(a["free"], b["free"]), f"{what}: step {i} free"


# -- the mesh itself -------------------------------------------------------------
@pytest.mark.parametrize("n, shape", [(1, (1, 1)), (2, (2, 1)), (4, (2, 2)),
                                      (8, (4, 2))])
def test_mesh_factorisation(n, shape):
    """The reference's rule (grove_tpu/parallel/sharded.py:62-67), the
    gangs dim the larger."""
    assert mesh_shape(n) == shape
    assert jax_mesh(jax.devices()[:n]).devices.shape == shape


@pytest.mark.parametrize("n, gang_axis", [(8, 3), (4, 3), (2, 4)])
def test_gang_axis_must_divide(n, gang_axis):
    with pytest.raises(ValueError, match="does not divide"):
        mesh_shape(n, gang_axis)
    with pytest.raises(ValueError, match="does not divide"):
        jax_mesh(jax.devices()[:n], gang_axis=gang_axis)


@pytest.mark.parametrize("n, gang_axis, shape", [(8, 8, (8, 1)),
                                                 (8, 1, (1, 8)),
                                                 (4, 4, (4, 1))])
def test_explicit_gang_axis(n, gang_axis, shape):
    assert mesh_shape(n, gang_axis) == shape
    assert jax_mesh(jax.devices()[:n], gang_axis=gang_axis).devices.shape \
        == shape


def test_ranks_built_the_mesh(mesh_run):
    label, ranks, _ = mesh_run
    want = {"2x2": (2, 2), "4x2": (4, 2)}[label]
    assert [r["mesh"] for r in ranks] == [want] * len(ranks)


# -- every case, three ways ------------------------------------------------------
@pytest.mark.parametrize("case", sorted(CASES))
def test_every_rank_identical(mesh_run, case):
    _, ranks, _ = mesh_run
    first = ranks[0][case]["steps"]
    for r, res in enumerate(ranks[1:], 1):
        assert_steps_equal(res[case]["steps"], first, f"rank {r}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_bit_equal_to_jax_sharded(mesh_run, case):
    label, ranks, jax_results = mesh_run
    assert_steps_equal(ranks[0][case]["steps"], jax_results[case],
                       f"{label} {case}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_bit_equal_to_flat_engine(mesh_run, flat_runs, case):
    _, ranks, _ = mesh_run
    assert_steps_equal(ranks[0][case]["steps"], flat_runs[case], case)


# -- what the reference's cases assert besides parity ------------------------------
def first_step(mesh_run, case):
    return mesh_run[1][0][case]["steps"][0]


def test_ragged_never_places_on_dummy_nodes(mesh_run):
    snap = CASES["ragged_node_count"][0]
    for nodes, _score in first_step(mesh_run, "ragged_node_count")[
            "placed"].values():
        assert max(nodes) < snap.num_nodes


def test_gang_axis_not_dividing_has_capacity_verdict(mesh_run):
    step = first_step(mesh_run, "gang_axis_not_dividing_backlog")
    assert set(step["placed"]) == {"a", "c"}
    assert set(step["unplaced"]) == {"b"}
    assert step["codes"]["b"] == UnsatCode.CAPACITY.value
    assert "cpu" in step["unplaced"]["b"]


def test_selectors_enforced(mesh_run):
    step = first_step(mesh_run, "selectors")
    assert set(step["placed"]) == {"sel", "zz-free"}
    assert "held" in step["unplaced"]
    assert set(step["placed"]["sel"][0]) <= {2, 3}


def test_stress_places_every_gang(mesh_run):
    step = first_step(mesh_run, "stress_x1.0")
    assert len(step["placed"]) == 256
    assert step["fallbacks"] == 0.0


def test_non_dyadic_capacity_places_as_flat(mesh_run, flat_runs):
    """x 0.3 and x 0.7: the partial sums are inexact, and the placements
    are still the flat engine's (checked bit for bit above); the backlog
    is contended at x 0.3."""
    placed = {c: len(first_step(mesh_run, c)["placed"])
              for c in ("stress_x0.3", "stress_x0.7")}
    assert placed["stress_x0.3"] < 256
    assert placed == {c: len(flat_runs[c][0]["placed"]) for c in placed}


@pytest.mark.parametrize("case", ["warm_staged_stress", "warm_staged_ragged",
                                  "warm_split_ragged"])
def test_warm_solves_ship_deltas(mesh_run, case):
    """The warm ticks ride the delta path (staged into the launch, or the
    split engine's own scatter); a full upload only at the first solve
    and, on the stress cluster, after the cold solve's 2048 bound rows
    (more than a delta carries); the adopted dispatch is adopted, the
    cancelled and the stale ones are not; the flat mesh path keeps the
    incremental tier, the kernel tier and the device commit off."""
    steps = mesh_run[1][0][case]["steps"]
    assert [s["adopted"] for s in steps] == [False, False, False, True,
                                             False, False]
    last = steps[-1]["engine"]
    assert last["full_uploads"] == (2 if case.endswith("stress") else 1)
    assert last["delta_uploads"] >= 4
    assert (last["incremental"], last["pallas_core"],
            last["device_commit"]) == (False, False, False)
    kind = "split" if case.startswith("warm_split") else "fused"
    assert last["dispatches"][kind] >= len(steps)


def test_node_blocks_cover_the_nodes(mesh_run):
    """The ranks' node blocks are contiguous, in rank order along the
    nodes dim, and cover every real node once (the ragged cluster's last
    block ends in a dummy node)."""
    label, ranks, _ = mesh_run
    nodes_dim = 2
    n = CASES["warm_staged_ragged"][0].num_nodes
    blocks = [r["warm_staged_ragged"]["steps"][0]["engine"]["block"]
              for r in ranks]
    for start in range(0, len(ranks), nodes_dim):
        row = blocks[start: start + nodes_dim]
        assert row[0][0] == 0 and row[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(row, row[1:]))


# -- the control plane on the mesh engine ----------------------------------------
def control_plane_nodes(pkg_make_nodes):
    nodes = pkg_make_nodes(8, racks_per_block=2, hosts_per_rack=4)
    for n in nodes[:4]:
        n.metadata.labels["accel"] = "v5"
    return nodes


def control_plane_pcs():
    from grove_tpu.api.types import PodCliqueScalingGroupConfig
    from test_e2e_basic import clique, simple_pcs

    pcs = simple_pcs(
        cliques=[clique("fe", replicas=2), clique("be", replicas=2)],
        sgs=[PodCliqueScalingGroupConfig(
            name="grp", clique_names=["be"], replicas=2, min_available=1)],
    )
    pcs.spec.template.cliques[0].spec.pod_spec.node_selector = {
        "accel": "v5"}
    return pcs


def control_plane_payload() -> dict:
    from grove_tpu.cluster import make_nodes

    return {"nodes": [api_object(n) for n in control_plane_nodes(make_nodes)],
            "pcs": api_object(control_plane_pcs())}


class TestShardedControlPlane:
    def test_full_control_plane_on_mesh_engine(self, mesh_run):
        """tests/test_parallel.py's control-plane case: the whole control
        plane with the gang scheduler's engine on the mesh, selectors and
        a scaling group included. Every rank's Harness binds every pod
        where the JAX Harness on the JAX mesh engine does, and where the
        flat engines of both packages do."""
        from grove_tpu.api.types import Pod
        from grove_tpu.cluster import make_nodes
        from grove_tpu.controller import Harness as JaxHarness
        from grove_tpu_torch.controller import Harness

        label, ranks, _ = mesh_run
        mesh = jax_mesh(jax.devices()[:MESHES[label][1]])
        outcomes = []
        for engine_cls in (None, partial(JaxSharded, mesh=mesh)):
            h = JaxHarness(nodes=control_plane_nodes(make_nodes),
                           **({"engine_cls": engine_cls} if engine_cls
                              else {}))
            h.apply(control_plane_pcs())
            h.settle()
            outcomes.append({p.metadata.name: p.node_name
                             for p in h.store.list(Pod.KIND)})
        payload = control_plane_payload()
        h = Harness(nodes=payload["nodes"], device="cpu")
        h.apply(payload["pcs"])
        h.settle()
        pods = h.store.list(port_types.Pod.KIND)
        outcomes.append({p.metadata.name: p.node_name for p in pods})
        assert outcomes[0] == outcomes[1] == outcomes[2]
        accel = {f"node-{i}" for i in range(4)}
        selected = [p for p in pods if p.spec.node_selector]
        assert selected and all(p.node_name in accel for p in selected)
        for r in ranks:
            res = r["control_plane"]
            assert res["engine"] == "ShardedPlacementEngine"
            assert res["ready"]
            assert res["nodes"] == outcomes[0]
