"""The flat cases of tests/test_solver_fuzz.py on the port: on RANDOM
problems, every placement the port's engine (on the CPU, the kernels'
plain versions) and its serial baseline return must satisfy the
hard-feasibility contract exactly —
  - cumulative node capacity is never exceeded,
  - a gang's required pack level puts all its pods in ONE domain there,
  - per-group and constraint-group required levels hold,
  - node eligibility (selectors/taints) is never violated,
  - results are deterministic for a seed.
The scenario suites check specific shapes; this sweeps the space. Then
the same random problems, built in each package from the same seed, go
through both packages' engines (default knobs, and the kernel tier):
bit-equal placements, scores and unplaced reasons. The sharded case runs
the port's mesh engine in 4 gloo ranks (2 x 2, tests/torch_mesh.py)
against the JAX mesh engine of the same shape.
"""

import numpy as np
import pytest

import grove_tpu.api.meta as jax_meta
import grove_tpu.api.types as jax_types
import grove_tpu.solver as jax_solver
import grove_tpu.topology as jax_topology

import grove_tpu_torch.api.meta as meta
import grove_tpu_torch.api.types as types
import grove_tpu_torch.solver as solver
import grove_tpu_torch.topology as topology
from grove_tpu_torch.solver import SolverGang, solve_serial

SEEDS = range(8)


def PlacementEngine(snap, **knobs):
    return solver.PlacementEngine(snap, device="cpu", **knobs)


def random_problem(seed: int, pkg=(meta, types, solver, topology)):
    """A seeded random cluster and backlog, built from one package's
    modules (default: the port's)."""
    meta_m, types_m, solver_m, topology_m = pkg
    ObjectMeta, Node, TopologyLevel = (
        meta_m.ObjectMeta, types_m.Node, types_m.TopologyLevel)
    SolverGang = solver_m.SolverGang
    default_cluster_topology = topology_m.default_cluster_topology
    encode_topology = topology_m.encode_topology
    rng = np.random.default_rng(seed)
    blocks = int(rng.integers(2, 4))
    racks = int(rng.integers(1, 4))
    hosts = int(rng.integers(2, 5))
    nodes = []
    i = 0
    for b in range(blocks):
        for r in range(racks):
            for h in range(hosts):
                labels = {"t/block": f"b{b}", "t/rack": f"b{b}r{r}"}
                if rng.random() < 0.3:
                    labels["accel"] = "v5"
                node = Node(
                    metadata=ObjectMeta(name=f"n{i}", labels=labels),
                    allocatable={
                        "cpu": float(rng.integers(4, 17)),
                        "memory": float(rng.integers(16, 65)),
                        "tpu": float(rng.integers(0, 9)),
                    },
                )
                if rng.random() < 0.15:
                    node.taints = ["reserved"]
                if rng.random() < 0.1:
                    node.unschedulable = True
                nodes.append(node)
                i += 1
    ct = default_cluster_topology([
        TopologyLevel(domain="block", key="t/block"),
        TopologyLevel(domain="rack", key="t/rack"),
    ])
    snap = encode_topology(ct, nodes)

    gangs = []
    for gi in range(int(rng.integers(6, 20))):
        num_groups = int(rng.integers(1, 3))
        demand, gids, greq, gpref = [], [], [], []
        pod_elig = []
        any_elig = False
        for grp in range(num_groups):
            pods = int(rng.integers(1, 5))
            sel = rng.random() < 0.25
            tol = rng.random() < 0.5
            for _ in range(pods):
                demand.append([
                    float(rng.integers(1, 5)),
                    float(rng.integers(1, 9)),
                    float(rng.integers(0, 3)),
                ])
                gids.append(grp)
                if sel or snap.has_taints:
                    mask = snap.eligibility(
                        {"accel": "v5"} if sel else {},
                        ["reserved"] if tol else [],
                    )
                    if mask.all():
                        pod_elig.append(None)
                    else:
                        pod_elig.append(mask)
                        any_elig = True
                else:
                    pod_elig.append(None)
            greq.append(int(rng.integers(-1, 2)))
            gpref.append(-1)
        required = int(rng.integers(-1, 2))
        gangs.append(SolverGang(
            name=f"g{gi:03d}",
            namespace="fuzz",
            demand=np.asarray(demand, np.float32),
            pod_names=[f"g{gi:03d}-p{j}" for j in range(len(demand))],
            group_ids=np.asarray(gids, np.int32),
            group_names=[f"grp{j}" for j in range(num_groups)],
            group_required_level=np.asarray(greq, np.int32),
            group_preferred_level=np.asarray(gpref, np.int32),
            required_level=required,
            preferred_level=int(rng.integers(-1, 3)),
            priority=float(rng.integers(0, 3)),
            pod_elig=pod_elig if any_elig else None,
        ))
    return snap, gangs


def assert_result_valid(snap, gangs, result):
    by_name = {g.name: g for g in gangs}
    free = snap.free.copy()
    for name, placement in result.placed.items():
        gang = by_name[name]
        assign = placement.node_indices
        assert len(assign) == gang.num_pods
        for p in range(gang.num_pods):
            ni = int(assign[p])
            assert snap.schedulable[ni], f"{name} pod {p} on cordoned node"
            if gang.pod_elig is not None and gang.pod_elig[p] is not None:
                assert gang.pod_elig[p][ni], f"{name} pod {p} ineligible node"
            free[ni] -= gang.demand[p]
        # gang-level required pack
        if gang.required_level >= 0:
            ids = snap.domain_ids[gang.required_level, assign]
            assert (ids == ids[0]).all(), f"{name} breaks gang pack level"
        # per-group required pack
        for grp in range(len(gang.group_names)):
            lvl = int(gang.group_required_level[grp])
            if lvl >= 0:
                sel = gang.group_ids == grp
                ids = snap.domain_ids[lvl, assign[sel]]
                assert (ids == ids[0]).all(), f"{name}/{grp} breaks group pack"
        for members, req, _pref in gang.constraint_groups:
            if req >= 0:
                sel = np.isin(gang.group_ids, members)
                ids = snap.domain_ids[req, assign[sel]]
                assert (ids == ids[0]).all(), f"{name} breaks constraint group"
    assert (free >= -1e-4).all(), "cumulative capacity exceeded"


@pytest.mark.parametrize("seed", SEEDS)
def test_engine_placements_satisfy_hard_contract(seed):
    snap, gangs = random_problem(seed)
    result = PlacementEngine(snap).solve(gangs)
    assert_result_valid(snap, gangs, result)
    assert len(result.placed) + len(result.unplaced) == len(gangs)


@pytest.mark.parametrize("seed", SEEDS)
def test_serial_placements_satisfy_hard_contract(seed):
    snap, gangs = random_problem(seed)
    result = solve_serial(snap, gangs)
    assert_result_valid(snap, gangs, result)


@pytest.mark.parametrize("seed", (0, 3, 6))
def test_engine_deterministic_per_seed(seed):
    snap, gangs = random_problem(seed)
    r1 = PlacementEngine(snap).solve(gangs)
    r2 = PlacementEngine(snap).solve(gangs)
    assert set(r1.placed) == set(r2.placed)
    for name in r1.placed:
        np.testing.assert_array_equal(
            r1.placed[name].node_indices, r2.placed[name].node_indices
        )


@pytest.mark.parametrize("seed", (0, 2, 5, 7))
def test_native_serial_matches_python_on_random_problems(seed):
    from grove_tpu_torch.native import solve_serial_native

    snap, gangs = random_problem(seed)
    for g in gangs:
        # the C++ baseline does not implement gang-level PREFERRED packing
        # (a soft node-choice policy); strip it so both paths make
        # identical choices and knock-on feasibility stays comparable
        g.preferred_level = -1
    nat = solve_serial_native(snap, gangs)
    ser = solve_serial(snap, gangs)
    assert nat is not None
    assert_result_valid(snap, gangs, nat)
    assert set(nat.placed) == set(ser.placed)
    for name in nat.placed:
        np.testing.assert_array_equal(
            nat.placed[name].node_indices, ser.placed[name].node_indices
        )


JAX_PKG = (jax_meta, jax_types, jax_solver, jax_topology)


def same_result(a, b) -> bool:
    """Bit-equal placed sets, nodes and scores, and unplaced reasons
    (message and code) between the two packages' results."""
    if sorted(a.placed) != sorted(b.placed) or sorted(a.unplaced) != sorted(b.unplaced):
        return False
    for n in a.placed:
        if not (np.array_equal(a.placed[n].node_indices, b.placed[n].node_indices)
                and a.placed[n].placement_score == b.placed[n].placement_score):
            return False
    code = lambda r: getattr(getattr(r, "code", None), "value", None)  # noqa: E731
    return all(str(a.unplaced[n]) == str(b.unplaced[n])
               and code(a.unplaced[n]) == code(b.unplaced[n]) for n in a.unplaced)


@pytest.mark.parametrize("tier", ["default", "kernel"])
@pytest.mark.parametrize("seed", SEEDS)
def test_engine_matches_the_jax_package(seed, tier):
    """Bit-equal to the JAX engine on the same random problem (the kernel
    tier: JAX's Pallas kernel interpreted, the port's plain versions)."""
    knobs = ({"pallas_core": True, "device_commit": True}
             if tier == "kernel" else {})
    snap, gangs = random_problem(seed)
    jsnap, jgangs = random_problem(seed, JAX_PKG)
    ours = PlacementEngine(snap, **knobs).solve(gangs)
    ref = jax_solver.PlacementEngine(jsnap, **knobs).solve(jgangs)
    assert same_result(ours, ref)
    assert ours.stats["fallbacks"] == ref.stats["fallbacks"]


#: tests/test_solver_fuzz.py's sharded seeds
SHARDED_SEEDS = (1, 4)


@pytest.fixture(scope="module")
def sharded_runs():
    """Every rank's sharded solve of each seed's problem."""
    from torch_mesh import run_ranks

    jobs = []
    for seed in SHARDED_SEEDS:
        snap, gangs = random_problem(seed)
        jobs.append((f"seed{seed}", "solve",
                     {"snap": snap, "steps": [{"gangs": gangs}]}))
    return run_ranks(4, jobs)


@pytest.mark.parametrize("seed", SHARDED_SEEDS)
def test_sharded_engine_satisfies_hard_contract(sharded_runs, seed):
    """Every rank's placements satisfy the hard contract and equal, bit
    for bit, the JAX mesh engine's and the port's single-device engine's
    (placements, scores, unplaced reasons and codes)."""
    from types import SimpleNamespace

    import jax
    from grove_tpu.parallel import ShardedPlacementEngine, make_solver_mesh

    from torch_mesh import placements

    snap, gangs = random_problem(seed)
    jsnap, jgangs = random_problem(seed, JAX_PKG)
    ref = placements(ShardedPlacementEngine(
        jsnap, make_solver_mesh(jax.devices()[:4])).solve(jgangs))
    single = placements(PlacementEngine(snap).solve(gangs))
    assert ref == single
    for rank in sharded_runs:
        res = rank[f"seed{seed}"]["steps"][0]
        assert_result_valid(snap, gangs, SimpleNamespace(placed={
            name: SimpleNamespace(node_indices=np.asarray(nodes, np.int64))
            for name, (nodes, _score) in res["placed"].items()}))
        assert len(res["placed"]) + len(res["unplaced"]) == len(gangs)
        assert {k: res[k] for k in ref} == ref
