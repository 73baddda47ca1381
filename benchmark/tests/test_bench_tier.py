"""The tier deployment and its cell: the inventory at 20000 nodes, the
domain index of a block against the port's sub-snapshot, the new metrics'
arithmetic, and runs of the cell on the CPU at a size a test holds: as it
is (correct), with a sub-engine's commit or placements broken underneath
and with the bf16 control (each not correct)."""

import numpy as np
import pytest

from benchmark import readers, reference_hier, run, system
from benchmark.deployment import deployment, load_json
from benchmark.drivers.tier_backlog import TierRun

CONFIG = "benchmark/configs/tier-20k.json"
SMALL = dict(nodes=1024, engine={"hier_min_nodes": 0},
             traffic={"warm_iterations": 1, "check_gangs": 10**6})


def test_the_tier_inventory():
    dep = deployment(load_json(CONFIG))
    hier = reference_hier.Hierarchy(dep.labels, dep.node_names, dep.capacity)
    topo = hier.topo
    assert dep.num_nodes == 20000 and dep.slots() == 160000
    assert list(np.diff(topo.offsets)) == [5, 79, 1250, 20000]
    assert topo.num_domains == 21335
    specs = dep.backlog("t", dep.draw_kinds(np.random.default_rng(1), 4000))
    assert reference_hier.prune_level(topo, specs, 4096) == 1
    assert reference_hier.prune_level(topo, specs, 20001) is None
    rows, sub = hier.domain(1, 0)
    assert len(rows) == 256 and sub.num_domains == 1 + 16 + 256
    rows, sub = hier.domain(1, 78)
    assert len(rows) == 32 and sub.num_domains == 1 + 2 + 32


def test_a_block_indexes_as_the_port_sub_snapshot():
    from grove_tpu_torch.solver.engine import DomainSpace
    from grove_tpu_torch.solver.hierarchy import subset_snapshot

    config = load_json(CONFIG)
    config["nodes"]["count"] = 2048
    config["levels"][0]["nodes"] = 1024
    dep = deployment(config)
    snap = system.snapshot(dep)
    hier = reference_hier.Hierarchy(dep.labels, dep.node_names, dep.capacity)
    np.testing.assert_array_equal(hier.topo.domain_ids, snap.domain_ids)
    for dom in (0, 5):
        rows, sub = hier.domain(1, dom)
        np.testing.assert_array_equal(rows,
                                      np.flatnonzero(snap.domain_ids[1] == dom))
        port = subset_snapshot(snap, rows, 1)
        space = DomainSpace(port)
        np.testing.assert_array_equal(sub.domain_ids, port.domain_ids)
        np.testing.assert_array_equal(sub.dom_level, space.dom_level)
        np.testing.assert_array_equal(sub.anc, space.anc_ids)


def test_the_hierarchy_metrics_read_the_solves_and_the_window():
    solves = [{"hier_coarse_seconds": 0.1, "hier_fine_seconds": 10.0,
               "hier_net_seconds": 0.0, "encode_seconds": 4.0,
               "device_seconds": 0.5, "repair_seconds": 3.0,
               "finish_seconds": 2.0},
              {"hier_coarse_seconds": 0.3, "hier_fine_seconds": 14.0,
               "hier_net_seconds": 0.002, "encode_seconds": 6.0,
               "device_seconds": 0.7, "repair_seconds": 5.0,
               "finish_seconds": 4.0}]
    traced = TierRun(solves=solves, captures=3)
    want = {"hier_coarse_ms": 200.0, "hier_fine_ms": 12000.0,
            "hier_net_ms": 1.0, "encode_ms": 5000.0,
            "device_phase_ms": 600.0, "repair_ms": 4000.0,
            "finish_ms": 3000.0, "graph_captures.tier": 3}
    for name, value in want.items():
        assert run._reader(name)(traced) == pytest.approx(value), name
    assert run._reader("graph_captures.tier")(TierRun(captures=0)) == 0
    # a program without the sums, and a run that counts no captures
    older = TierRun(solves=[{"hier_fine_seconds": 1.0}])
    for name in want:
        if name != "hier_fine_ms":
            assert run._reader(name)(older) is None, name
    assert run._reader("graph_captures.tier")(readers.TracedRun()) is None


def test_the_rooflines_count_a_launch_a_fine_solve_that_launched():
    from benchmark import roofline
    from benchmark.drivers import tier_backlog

    config = load_json(CONFIG)
    dep = deployment(config)
    drawer = tier_backlog._Draw(dep)
    kinds = dep.draw_kinds(np.random.default_rng(3), 8)
    gangs = drawer.draw(np.random.default_rng(3), 0, 8)[1]
    log = [(0, kinds, None, None, False), (1, kinds, None, None, True)]
    runs = [(0, gangs, {}, 0),
            (78, gangs[:3], {"incremental": 1.0, "incremental_rows": 2.0}, 1),
            (5, gangs, {"reused": 1.0}, 0)]
    shapes = tier_backlog._shapes(dep, config, drawer, log, runs)
    # the capture's eager run and its replay are two launches
    assert [len(shapes[r]) for r in roofline.ROLES] == [3, 3, 3]
    full, inc, inc2 = shapes["k2"]
    assert (full.g, full.d, full.l1, full.r, full.k) == (8, 273, 3, 3, 8)
    assert (inc.g, inc.d) == (3, 35) and inc2 == inc
    assert full.u == full.t == len({g.demand.sum(axis=0).tobytes()
                                    for g in gangs})
    assert [s.g for s in shapes["k1"]] == [8, 2, 2]
    assert shapes["k3"] == shapes["k2"]


def tier_cell(small_cell, engine=None, seconds=2.0):
    small_cell(SMALL["nodes"], engine=dict(SMALL["engine"], **(engine or {})),
               traffic=SMALL["traffic"])
    rc, line, notes = run.run_cell("tier-20k.backlog", 2**31 + 29, seconds,
                                   False, device="cpu", check_device=False)
    assert rc == 0, notes
    return line


def test_the_unbroken_tier_run_is_correct(small_cell):
    line = tier_cell(small_cell)
    assert line["correct"], line["checks"]
    assert line["paths"]["hierarchical"] > 0 and not line["paths"]["flat"]
    assert line["failed"] == 0


def test_the_tier_bf16_control_is_not_correct(small_cell):
    line = tier_cell(small_cell, engine={"pallas_precision": "bf16"})
    assert not line["correct"]
    assert line["checks"]["value_gap"]["value"] > \
        line["checks"]["value_gap"]["limit"]


class CommitAltered:
    """The device commit's value altered where it is produced."""

    def _device_end(self, token):
        val, dom = super()._device_end(token)
        return val + np.float32(1e-3), dom


class PlacementAltered:
    """One pod of the first placed gang moved to the next node."""

    def _repair(self, order, top_val, top_dom, free):
        placed, fallbacks = super()._repair(order, top_val, top_dom, free)
        for p in placed.values():
            p.node_indices = np.array(p.node_indices, copy=True)
            p.node_indices[0] = (p.node_indices[0] + 1) % len(free)
            break
        return placed, fallbacks


@pytest.mark.parametrize("fault,check", [(CommitAltered, "domain_mismatch"),
                                         (PlacementAltered,
                                          "placement_mismatch")])
def test_a_broken_sub_engine_is_not_correct(small_cell, monkeypatch, fault,
                                            check):
    from grove_tpu_torch.solver import engine

    # sub-engines are built from the engine module's PlacementEngine
    monkeypatch.setattr(engine, "PlacementEngine",
                        type(fault.__name__, (fault, engine.PlacementEngine),
                             {}))
    line = tier_cell(small_cell)
    assert not line["correct"]
    assert line["checks"][check]["value"] > 0, line["checks"]
