"""The plain reference against the port, at a size the CPU holds: the
domain index, the tie jitter, the value tensor, the committed choices and
the placements of real solves."""

import ast
from pathlib import Path

import numpy as np
import torch

from benchmark import reference, system
from benchmark.deployment import deployment, load_json

BENCH = Path(__file__).resolve().parents[1]


def small(nodes=600):
    config = load_json("benchmark/configs/stress-5k.json")
    config["nodes"]["count"] = nodes
    return config, deployment(config)


def test_domain_index_matches_the_port():
    from grove_tpu_torch.solver.engine import DomainSpace

    _config, dep = small()
    snap = system.snapshot(dep)
    topo = reference.Topology(dep.labels, dep.node_names, dep.capacity)
    space = DomainSpace(snap)
    np.testing.assert_array_equal(topo.domain_ids, snap.domain_ids)
    np.testing.assert_array_equal(topo.dom_level, space.dom_level)
    np.testing.assert_array_equal(topo.anc, space.anc_ids)


def test_tie_jitter_matches_the_port():
    from grove_tpu_torch.solver.kernel_core import tie_jitter

    np.testing.assert_array_equal(reference._tie_jitter(70, 333),
                                  tie_jitter(70, 333, "cpu").numpy())


def test_a_port_solve_equals_the_reference():
    from grove_tpu_torch.solver import PlacementEngine

    config, dep = small()
    snap = system.snapshot(dep)
    eng = PlacementEngine(snap, **system.engine_kwargs(config, "cpu"))
    rng = np.random.default_rng(2**31 + 3)
    free = snap.free.copy()
    topo = reference.Topology(dep.labels, dep.node_names, dep.capacity)
    for k in range(3):
        specs = dep.backlog(f"s{k}", dep.draw_kinds(rng, 120))
        before = free.copy()
        res = eng.solve([system.solver_gang(s) for s in specs], free)
        value = eng._inc.value_dev[: len(specs)].numpy()
        ref_value, _ = reference.value_tensor(topo, before,
                                              reference.sort_gangs(specs))
        np.testing.assert_array_equal(value, ref_value)
        val, dom, _tv, _td = reference.device_phase(
            topo, before, reference.sort_gangs(specs))
        assigns = reference.repair(topo, before.copy(),
                                   reference.sort_gangs(specs), val, dom)
        for g, a in zip(reference.sort_gangs(specs), assigns):
            np.testing.assert_array_equal(res.placed[g.name].node_indices, a)
        assert reference.guarantee_violations(
            topo, before.copy(), specs,
            {n: p.node_indices for n, p in res.placed.items()}) == 0


def test_guarantees_catch_a_double_booked_node():
    _config, dep = small(64)
    topo = reference.Topology(dep.labels, dep.node_names, dep.capacity)
    rng = np.random.default_rng(1)
    specs = dep.backlog("v", dep.draw_kinds(rng, 2))
    free = dep.capacity.copy()
    place = {specs[0].name: np.zeros(8, np.int64),
             specs[1].name: np.zeros(8, np.int64)}
    assert reference.guarantee_violations(topo, free, specs, place) == 1
    split = np.array([0] * 4 + [256] * 4)       # across two blocks
    assert reference.guarantee_violations(
        topo, dep.capacity.copy(), specs[:1], {specs[0].name: split % 64 + 
        (split >= 256) * 0}) == 0


def test_the_yardstick_imports_nothing_of_the_program():
    for name in ("reference.py", "deployment.py", "stats.py", "roofline.py",
                 "readers.py"):
        tree = ast.parse((BENCH / name).read_text())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module or ""] if isinstance(node, ast.ImportFrom)
                    else [])
            for mod in mods:
                assert mod.split(".")[0] not in ("grove_tpu_torch", "grove_tpu",
                                                  "jax", "torch"), (name, mod)
    assert torch is not None
