"""The port's hierarchical solve against the benchmark's plain reference of
the two levels (benchmark/reference_hier.py).

A small cluster of the tier deployment's four-level shape (2048 nodes:
zones of 1024, blocks of 256, racks of 16), most of its slots taken at
random from the seed, and three 256-gang backlogs solved one after
another on the same free state, on the kernels' plain versions: the
chunks overcommit their tightest blocks, so gangs fail there and walk
their alternates, and the last backlog leaves gangs to the serial net. Of every
solve: each gang's first fine domain equals the reference's first coarse
choice, and each fine solve's value tensor, committed (value, domain)
rows and placements, and the net's placements, equal the reference's
exactly.
"""

import copy

import numpy as np
import pytest

from benchmark import reference, reference_hier, system, system_hier
from benchmark.deployment import deployment, load_json

SEEDS = (2**31 + 5, 2**31 + 1117, 2**31 + 90001)


def tier(mix: str):
    config = copy.deepcopy(load_json("benchmark/configs/tier-20k.json"))
    config["nodes"]["count"] = 2048
    config["levels"][0]["nodes"] = 1024
    config["engine"]["hier_min_nodes"] = 0
    if mix == "plain":
        config["gangs"] = [g for g in config["gangs"] if g["kind"] == "plain"]
    return config, deployment(config)


@pytest.mark.parametrize("mix", ["plain", "mixed"])
@pytest.mark.parametrize("seed", SEEDS)
def test_the_port_solves_the_two_levels_as_the_reference(seed, mix):
    config, dep = tier(mix)
    snap = system.snapshot(dep)
    recorder = system_hier.HierRecorder(10**6, seed)
    engine = system_hier.engine_class(recorder)(
        snap, **system_hier.engine_kwargs(config, "cpu"))
    hier = reference_hier.Hierarchy(dep.labels, dep.node_names, dep.capacity)
    rng = np.random.default_rng(seed)
    used = rng.choice([1, 3, 5, 6, 7, 7, 8], size=dep.num_nodes)
    free = snap.free - used[:, None] * dep.pod[None, :]
    recorder.on = True
    fines = failed = net = 0
    for k in range(3):
        specs = dep.backlog(f"t{k}", dep.draw_kinds(rng, 256))
        before = free.copy()
        res = engine.solve([system.solver_gang(s) for s in specs], free)
        recorder.take_value()
        rec = recorder.records[-1]
        assert res.stats["hierarchical"] == 1.0
        assert all(f.value is not None for f in rec.fines)
        placed = {n: p.node_indices for n, p in res.placed.items()}
        c = reference_hier.compare_solve(
            hier, before, specs, rec.fines, placed,
            config["engine"]["top_k"], config["engine"]["commit_chunk"])
        assert c["coarse_mismatch"] == 0, c
        assert c["value_gap"] == 0.0, c
        assert c["domain_mismatch"] == 0, c
        assert c["placement_mismatch"] == 0, c
        assert c["fine_solves"] == len(rec.fines) == res.stats[
            "hier_fine_solves"]
        assert reference.guarantee_violations(hier.topo, before, specs,
                                              placed) == 0
        fines += c["fine_solves"]
        failed += sum(len(f.placed) < len(f.names) for f in rec.fines)
        net += c["net"]
    # the fill leaves gangs to fail in a block, and some to the net
    assert failed > 0 and fines > 3 * 2 and net > 0, (failed, fines, net)
    engine.release()
