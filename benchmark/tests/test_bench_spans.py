"""The span arithmetic of the overload cell's layer metrics (spans.py):
the window from bench.anchor on, disjoint families with the store's
charges taken out, and the lost-span guard."""

from types import SimpleNamespace

import pytest

from benchmark import readers, spans as S


def sp(sid, parent, t0, t1, name, **attrs):
    return SimpleNamespace(span_id=sid, parent_id=parent, t0=t0, t1=t1,
                           name=name, attrs=attrs)


def turn(first: int, t: float) -> list:
    """One settle of 10 s from `t`, ids from `first`: a round with its
    drain, a reconcile over a solve and its flush, then a tick with its
    heartbeat; store charges on five of them."""
    i = first
    return [
        sp(i + 2, i + 1, t + 0.0, t + 1.0, "manager.drain_events",
           store_seconds=0.25),
        sp(i + 4, i + 3, t + 2.0, t + 3.0, "scheduler.solve",
           store_seconds=0.125),
        sp(i + 3, i + 1, t + 1.0, t + 5.0, "manager.reconcile",
           store_seconds=1.0),
        sp(i + 5, i + 1, t + 5.0, t + 6.0, "manager.flush_writes"),
        sp(i + 1, i, t + 0.0, t + 6.5, "manager.round", store_seconds=0.25),
        sp(i + 7, i + 6, t + 6.5, t + 9.0, "kubelet.heartbeat",
           store_seconds=2.0),
        sp(i + 8, i + 6, t + 9.0, t + 9.0, "kubelet.pod_start"),
        sp(i + 6, i, t + 6.5, t + 9.5, "kubelet.tick"),
        sp(i, None, t, t + 10.0, "harness.settle"),
    ]


def window_run(bound=4, before=True, extra=()):
    """Set-up spans (ids 1-9), the anchor (10), two settles (11-28) and a
    store call with no span open (29)."""
    spans = (turn(1, 0.0) if before else [])
    spans += [sp(10, None, 100.0, 100.0, "bench.anchor")]
    spans += turn(11, 100.0) + turn(20, 110.0)
    spans += [sp(29, None, 120.0, 120.5, "store.call", op="create")]
    spans += list(extra)
    return readers.TracedRun(spans=spans, bound=bound)


def test_the_window_starts_at_the_anchor():
    run = window_run()
    inside = S.window(run.spans)
    assert min(s.span_id for s in inside) == 10
    assert len(inside) == 20


@pytest.mark.parametrize("family,marker,per_turn", [
    # tick 3 - 2.5, heartbeat 2.5 - 2 (store), the point 0
    (S.KUBELET, "kubelet.tick", 0.5 + 0.5),
    # settle 10 - 9.5, round 6.5 - 6 - 0.25, drain 1 - 0.25, flush 1
    (S.MANAGER, "manager.round", 0.5 + 0.25 + 0.75 + 1.0),
    # reconcile 4 - 1 (the solve) - 1 (store)
    (S.CONTROLLER, "manager.reconcile", 2.0),
])
def test_a_family_is_self_time_less_its_store_charges(family, marker,
                                                      per_turn):
    run = window_run()
    assert S.family_ms_per_gang(run, family, marker) == pytest.approx(
        1e3 * 2 * per_turn / 4)


def test_the_store_is_every_charge_plus_the_store_call_spans():
    run = window_run()
    assert S.store_ms_per_gang(run) == pytest.approx(
        1e3 * (2 * 3.625 + 0.5) / 4)


def test_the_families_and_the_solve_cover_each_settle():
    inside = S.window(window_run().spans)
    settles = [s for s in inside if s.name == "harness.settle"]
    parts = (S.self_seconds(inside, S.KUBELET + S.MANAGER + S.CONTROLLER)
             + S.self_seconds(inside, ("scheduler.solve",))
             + S.store_seconds([s for s in inside if s.name != "store.call"]))
    assert parts == pytest.approx(sum(s.t1 - s.t0 for s in settles))


def test_a_lost_span_reads_none():
    run = window_run()
    run.spans = [s for s in run.spans if s.span_id != 15]   # a leaf
    assert S.window(run.spans) is None
    for family, marker in ((S.KUBELET, "kubelet.tick"),
                           (S.MANAGER, "manager.round"),
                           (S.CONTROLLER, "manager.reconcile")):
        assert S.family_ms_per_gang(run, family, marker) is None
    assert S.store_ms_per_gang(run) is None


def test_a_span_open_at_the_last_drain_is_not_lost():
    # the second settle (id 20) still open: its children were drained
    run = window_run()
    run.spans = [s for s in run.spans if s.span_id != 20]
    assert S.window(run.spans) is not None


def test_nothing_to_read_reads_none():
    assert S.store_ms_per_gang(readers.TracedRun()) is None
    run = window_run(bound=0)
    assert S.family_ms_per_gang(run, S.MANAGER, "manager.round") is None
    # a program without the span: no anchor, or no marker in the window
    run = window_run(before=False)
    run.spans = [s for s in run.spans if s.name != "bench.anchor"]
    assert S.store_ms_per_gang(run) is None
    run = window_run()
    for s in run.spans:
        if s.name == "kubelet.tick" and s.span_id > 10:
            s.name = "other.tick"
    assert S.window(run.spans) is not None
    assert S.family_ms_per_gang(run, S.KUBELET, "kubelet.tick") is None
    run = window_run()
    for s in run.spans:
        s.attrs.pop("store_seconds", None)
    run.spans = [s for s in run.spans if s.name != "store.call"]
    assert S.store_ms_per_gang(run) is None


def test_finish_ms_is_the_mean_of_the_solves_stat():
    run = readers.TracedRun(solves=[{"finish_seconds": 0.004},
                                    {"finish_seconds": 0.006}, {}])
    assert readers.mean_stat_ms(run, "finish_seconds") == pytest.approx(5.0)
