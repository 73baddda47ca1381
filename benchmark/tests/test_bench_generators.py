"""The inputs are made from the seed alone, the same seed giving the same
inputs, and every seed the same set of sizes."""

import numpy as np

from benchmark.deployment import deployment, load_json
from benchmark.drivers.churn import arrival_times


def stress():
    return deployment(load_json("benchmark/configs/stress-5k.json"))


def test_inventory_matches_the_stress_layout():
    dep = stress()
    assert dep.num_nodes == 5000 and dep.resources == ["cpu", "memory", "tpu"]
    assert dep.labels[0][255] == "block-0" and dep.labels[0][256] == "block-1"
    assert dep.labels[1][17] == "block-0-rack-1"
    assert dep.labels[1][4999] == "block-19-rack-8"
    assert dep.slots() == 40000 and dep.pods_per_gang() == 8


def test_backlog_draw_is_deterministic_and_keeps_the_mix():
    dep = stress()
    def draw(seed):
        return dep.backlog("b", dep.draw_kinds(np.random.default_rng(seed), 1000))

    a, b, c = draw(2**31 + 5), draw(2**31 + 5), draw(7)
    assert [g.kind for g in a] == [g.kind for g in b]
    assert [g.kind for g in a] != [g.kind for g in c]
    for gangs in (a, c):
        kinds = [g.kind for g in gangs]
        assert kinds.count("plain") == 750 and kinds.count("leader_worker") == 250
    lw = next(g for g in a if g.kind == "leader_worker")
    assert lw.required == 0 and list(lw.group_required) == [1, 1]
    plain = next(g for g in a if g.kind == "plain")
    assert (plain.required, plain.preferred) == (0, 1)


def test_arrivals_are_deterministic_with_one_set_of_gaps():
    a = arrival_times(np.random.default_rng(11), 200.0, 30.0)
    b = arrival_times(np.random.default_rng(11), 200.0, 30.0)
    c = arrival_times(np.random.default_rng(2**31 + 99), 200.0, 30.0)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a[:50], c[:50])
    assert len(a) == len(c) == 6000
    assert np.all(np.diff(a) > 0) and a[-1] < 30.0
    # the same gaps, in another order
    ga = np.sort(np.diff(np.concatenate([[0.0], a])))
    gc = np.sort(np.diff(np.concatenate([[0.0], c])))
    np.testing.assert_allclose(ga, gc, rtol=0, atol=1e-9)
