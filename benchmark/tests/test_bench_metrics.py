"""The metric arithmetic: tails over every request, rates over the whole
window, open-loop latency from the due time, self time and shares."""

import math
from types import SimpleNamespace

import pytest

from benchmark import readers, stats


def test_quantile_is_nearest_rank():
    xs = list(range(1, 101))
    assert stats.quantile(xs, 0.99) == 99
    assert stats.quantile(xs, 0.95) == 95
    assert stats.quantile([3.0], 0.99) == 3.0


def test_tail_counts_missing_requests_above_the_limit():
    answered = [0.1] * 990
    # ten requests never answered, counted with the wait they had
    assert stats.tail(answered, [61.0] * 10, 0.99) == 0.1
    assert stats.tail(answered, [61.0] * 11, 0.99) == 61.0


def test_rate_is_over_the_whole_window():
    assert stats.rate(3000, 30.0) == 100.0


def test_open_loop_latency_runs_from_the_due_time(monkeypatch):
    from benchmark.drivers import churn

    class Gang:
        def __init__(self, ok):
            self.status = SimpleNamespace(conditions=[SimpleNamespace(
                type="Scheduled", status="True" if ok else "False")])

    store = SimpleNamespace(kind_bucket=lambda kind: {
        ("default", "a-0"): Gang(True), ("default", "b-0"): Gang(False)})
    plane = churn._Plane.__new__(churn._Plane)
    plane.h = SimpleNamespace(store=store)
    plane.pending = {"a-0": 100.0, "b-0": 100.5}
    plane.latency, plane.bound_at = {}, {}
    monkeypatch.setattr(churn.time, "perf_counter", lambda: 102.0)
    import grove_tpu_torch.api.meta as meta

    monkeypatch.setattr(meta, "get_condition", lambda conds, t: next(
        (c for c in conds if c.type == t), None))
    assert plane.observe() == 1
    # due at 100.0, seen at 102.0: a stall before the create counts
    assert plane.latency == {"a-0": 2.0}
    assert plane.pending == {"b-0": 100.5}


def span(sid, parent, t0, t1, name="x"):
    return SimpleNamespace(span_id=sid, parent_id=parent, t0=t0, t1=t1,
                           name=name)


def test_self_time_leaves_out_child_spans():
    spans = [span(1, None, 0.0, 1.0, "manager.reconcile"),
             span(2, 1, 0.2, 0.5, "scheduler.solve"),
             span(3, None, 2.0, 2.5, "manager.reconcile")]
    assert readers.self_seconds(spans, "manager.reconcile") == pytest.approx(1.2)
    run = readers.TracedRun(spans=spans, bound=4)
    assert readers.reconcile_ms_per_gang(run) == pytest.approx(300.0)


def test_shares_read_nothing_where_nothing_ran():
    run = readers.TracedRun(kernels={"k1": {"seconds": 0.002, "launches": 2}},
                            least={"k1": (0.001, 2), "k2": (0.001, 2)},
                            busy_s=0.25, window_s=1.0)
    assert readers.roofline_pct(run, "k1") == pytest.approx(50.0)
    assert readers.roofline_pct(run, "k2") is None
    run.least["k1"] = (0.001, 3)      # a launch the shapes do not explain
    assert readers.roofline_pct(run, "k1") is None
    assert readers.idle_pct(run) == pytest.approx(75.0)
    assert readers.mean_stat_ms(run, "encode_seconds") is None
    assert not math.isnan(readers.idle_pct(run))


def test_idle_time_is_split_by_the_innermost_range_open_over_it():
    from benchmark.profile import _idle_by_label

    host = [(0, 100, "bench.solve", 1), (10, 60, "engine.fused", 2),
            (100, 110, "bench.draw", 1), (110, 200, "bench.solve", 1),
            (120, 190, "engine.fused", 2)]
    gaps = [(5, 40), (50, 130), (195, 250)]
    assert _idle_by_label(gaps, host) == {
        "bench.solve": 60.0, "engine.fused": 50.0, "bench.draw": 10.0,
        "no span": 50.0}
