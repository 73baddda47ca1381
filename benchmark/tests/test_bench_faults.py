"""A run with the timed path broken underneath comes out not correct, and
so does the control: the program's own bf16 value tier where the
configuration states fp32. Each drives the rest of a run (set-up, window,
reference, the result line) on the CPU at a size a test holds, the look
for a card skipped; the same cells pass unbroken. A free state short of
what the store holds is a fault of the overload cell's encode, which its
own ledger catches. An overload cell has no
half-batch fault of its own: the gang scheduler solves again, next round,
every gang a solve left out, so such a gang binds late (its latency), not
wrong. Neither cell has an exchange between chips."""

import numpy as np
import pytest

from benchmark import run

BACKLOG = dict(nodes=600)
CHURN = dict(nodes=1024, traffic={
    "rate_gangs_per_s": 60, "population": 200, "standing_replicas": 40,
    "warm_seconds": 1.5, "warm_max_gangs": 32, "grace_s": 20})


def engine_base():
    from grove_tpu_torch.solver import PlacementEngine

    return PlacementEngine


def cell(small_cell, name, size, seconds, engine=None, base=None):
    small_cell(size["nodes"], engine=engine, traffic=size.get("traffic"))
    rc, line, notes = run.run_cell(name, 2**31 + 17, seconds, False,
                                   device="cpu", check_device=False,
                                   base_engine=base)
    assert rc == 0, notes
    return line


def failing(line):
    return sorted(n for n, c in line["checks"].items()
                  if c["value"] > c["limit"])


class StateUnchanged:
    """A solve that leaves the free state as it found it."""

    def solve(self, gangs, free=None, *a, **k):
        keep = None if free is None else free.copy()
        res = super().solve(gangs, free, *a, **k)
        if keep is not None:
            free[:] = keep
        return res


class FreeUnderstated:
    """The free state handed to the solve short of what the cluster holds:
    the first node with room shown full, so its capacity goes unused."""

    def solve(self, gangs, free=None, *a, **k):
        if free is not None:
            free[int(np.argmax(free[:, 0]))] = 0.0
        return super().solve(gangs, free, *a, **k)


class HalfBatch:
    """Half of the backlog left out of the solve."""

    def solve(self, gangs, *a, **k):
        return super().solve(gangs[: max(1, len(gangs) // 2)], *a, **k)


class PlacementAltered:
    """One pod of the first placed gang moved to the next node."""

    def _repair(self, order, top_val, top_dom, free):
        placed, fallbacks = super()._repair(order, top_val, top_dom, free)
        for p in placed.values():
            p.node_indices = np.array(p.node_indices, copy=True)
            p.node_indices[0] = (p.node_indices[0] + 1) % len(free)
            break
        return placed, fallbacks


class CommitAltered:
    """The device commit's value altered where it is produced."""

    def _device_end(self, token):
        val, dom = super()._device_end(token)
        return val + np.float32(1e-3), dom


def subclass(fault):
    return type(fault.__name__, (fault, engine_base()), {})


@pytest.mark.parametrize("name,size,seconds", [
    ("stress-5k.backlog", BACKLOG, 2.0), ("stress-5k.overload", CHURN, 3.0)])
def test_the_unbroken_run_is_correct(small_cell, name, size, seconds):
    line = cell(small_cell, name, size, seconds)
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("name,size,seconds", [
    ("stress-5k.backlog", BACKLOG, 2.0), ("stress-5k.overload", CHURN, 3.0)])
def test_the_bf16_control_is_not_correct(small_cell, name, size, seconds):
    line = cell(small_cell, name, size, seconds,
                engine={"pallas_precision": "bf16"})
    assert not line["correct"]
    assert "value_gap" in failing(line)


@pytest.mark.parametrize("fault,name,size,seconds", [
    (StateUnchanged, "stress-5k.backlog", BACKLOG, 2.0),
    (HalfBatch, "stress-5k.backlog", BACKLOG, 2.0),
    (PlacementAltered, "stress-5k.backlog", BACKLOG, 2.0),
    (CommitAltered, "stress-5k.backlog", BACKLOG, 2.0),
    (PlacementAltered, "stress-5k.overload", CHURN, 3.0),
    (FreeUnderstated, "stress-5k.overload", CHURN, 3.0),
    (CommitAltered, "stress-5k.overload", CHURN, 3.0),
])
def test_a_broken_timed_path_is_not_correct(small_cell, fault, name, size,
                                            seconds):
    line = cell(small_cell, name, size, seconds, base=subclass(fault))
    assert not line["correct"], line["checks"]


def test_a_value_tensor_altered_where_produced_is_not_correct(small_cell,
                                                             monkeypatch):
    from grove_tpu_torch.solver import programs

    value_tensor = programs.value_tensor

    def altered(ops, p, tier):
        return value_tensor(ops, p, tier) + 1e-3

    monkeypatch.setattr(programs, "value_tensor", altered)
    line = cell(small_cell, "stress-5k.backlog", BACKLOG, 2.0)
    # +1e-3 is below the value tensor's limit; the committed values the
    # device commit ships carry it too, and those are compared exactly
    assert not line["correct"]
    assert "domain_mismatch" in failing(line)


@pytest.mark.parametrize("precision,correct", [("fp32", True), ("bf16", False)])
def test_without_the_value_cache_the_value_tensor_comes_from_score_values(
        small_cell, monkeypatch, precision, correct):
    from benchmark import system

    monkeypatch.setattr(system, "_value_rows", lambda engine, g: None)
    small_cell(BACKLOG["nodes"], engine={"pallas_precision": precision})
    rc, line, notes = run.run_cell("stress-5k.backlog", 2**31 + 17, 2.0,
                                   False, device="cpu", check_device=False)
    assert rc == 0, notes
    assert any("taken from score_values" in n for n in notes)
    assert line["correct"] is correct, line["checks"]


def test_a_gang_deleted_before_its_bind_is_withdrawn_not_failed(small_cell):
    # a population of 2 deletes most arrivals before the next settle
    size = dict(CHURN, traffic=dict(CHURN["traffic"], population=2))
    small_cell(size["nodes"], traffic=size["traffic"])
    rc, line, notes = run.run_cell("stress-5k.overload", 2**31 + 17, 3.0,
                                   False, device="cpu", check_device=False)
    assert rc == 0, notes
    (note,) = [n for n in notes if "deleted before their bind" in n]
    cut = int(note.split("; ")[1].split()[0])
    assert cut > 0, note
    assert line["failed"] == 0 and line["attempted"] > cut, line
    assert line["correct"], line["checks"]
